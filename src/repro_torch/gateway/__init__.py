from repro_torch.gateway.gateway import Gateway, GatewayResponse

__all__ = ["Gateway", "GatewayResponse"]
