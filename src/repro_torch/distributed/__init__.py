"""Model sharding of the port (counterpart of ``repro.distributed``):
the sharding rules, and the collectives that carry them over
``torch.distributed``."""
from repro_torch.distributed.sharding import (
    KVLayout,
    ShardingPlan,
    cache_pspecs,
    dense_cache_shapes,
    kv_layout,
    make_plan,
    param_pspecs,
)

__all__ = ["KVLayout", "ShardingPlan", "cache_pspecs", "dense_cache_shapes",
           "kv_layout", "make_plan", "param_pspecs"]
