from repro_torch.serving.engine import InferenceEngine
from repro_torch.serving.kv_manager import KVBlockManager, OutOfPages
from repro_torch.serving.request import Request, RequestState, latency_summary
from repro_torch.serving.simulation import (
    MultiPoolSimulator,
    PoolSite,
    ReplicaSim,
    ServingSimulator,
    Workload,
)

__all__ = ["InferenceEngine", "KVBlockManager", "MultiPoolSimulator",
           "OutOfPages", "PoolSite", "ReplicaSim", "Request",
           "RequestState", "ServingSimulator", "Workload",
           "latency_summary"]
