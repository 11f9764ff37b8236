from repro_torch.gateway.gateway import Gateway, GatewayResponse, QuantumRequest

__all__ = ["Gateway", "GatewayResponse", "QuantumRequest"]
