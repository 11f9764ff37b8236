from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.kv_manager import KVBlockManager, OutOfPages
from repro_torch.serving.request import Request, RequestState, latency_summary

__all__ = ["InferenceEngine", "KVBlockManager", "OutOfPages", "Request",
           "RequestState", "latency_summary"]
