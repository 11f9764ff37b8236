"""Runtime: the static distribution context threaded through model code.

Counterpart of ``repro/models/runtime.py``.  It separates *what* the
model computes (ArchConfig) from *where* it runs: the mesh and its axis
roles, the KV cache's storage type and the training remat policy
(``"none"``, or ``"full"``: each period of layers recomputed in
backward; the reference's ``"dots"`` names a policy its code never
reads).  ``Runtime()`` with no mesh (:data:`LOCAL`) is the one-device
path.  A mesh-ful runtime (``ShardingPlan.runtime``) makes the model's
entry points run this rank's part of the sharded program, with the
collectives of ``distributed.collectives`` where GSPMD would insert them
(:meth:`Runtime.reduce_tp`, :meth:`Runtime.replicate_tp` and
:meth:`Runtime.gather_tp` for the tp axis).  A MoE layer then runs
expert-parallel, its experts over the data axes as the sharding rules
put them, and the KV layout (head- or sequence-sharded) comes from
``cache_pspecs``: the reference's ``moe``, ``attn_shard`` and
``ep_axes`` (always its data axes) have no counterpart.

The reference's XLA-only knobs (``scan_unroll``, ``blocked_attn``,
``attn_block_k``, ``onehot_cache_update``, ``grouped_gqa_decode``, the
int8 cache) have no counterpart: the kernels already run a blocked
softmax and read K/V once a group, and the port has no scan to unroll.
Nor has ``constrain``: GSPMD's layout hint has nothing to place where
every tensor already is this rank's block.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
REMAT = ("none", "full")


def check_remat(remat: str) -> None:
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: the port keeps {REMAT}")


@dataclasses.dataclass(frozen=True)
class Runtime:
    mesh: Optional[object] = None        # a launch.mesh.ModelMesh
    dp_axes: tuple[str, ...] = ()        # batch/data axes (("pod","data"))
    tp_axis: Optional[str] = None        # tensor-parallel axis ("model")
    kv_cache_dtype: str = "bfloat16"
    remat: str = "none"

    def __post_init__(self) -> None:
        check_remat(self.remat)

    def cache_dtype(self) -> torch.dtype:
        try:
            return _CACHE_DTYPES[self.kv_cache_dtype]
        except KeyError:
            raise ValueError(
                f"kv_cache_dtype {self.kv_cache_dtype!r}: the port keeps "
                f"{sorted(_CACHE_DTYPES)}") from None

    @property
    def sharded(self) -> bool:
        return self.mesh is not None

    @property
    def tp_size(self) -> int:
        return self.mesh.axis_size(self.tp_axis) if self.sharded else 1

    @property
    def tp_index(self) -> int:
        return self.mesh.axis_index(self.tp_axis) if self.sharded else 0

    def tp_splits(self, n: int) -> bool:
        """Whether the sharding rules split a dim of ``n`` over tp (they
        split a dim where tp divides it), so that the model code runs
        this rank's block of it; no mesh: False."""
        return self.sharded and n % self.tp_size == 0

    def reduce_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of the tp ranks' partial ``x`` (no mesh: ``x``)."""
        if not self.sharded:
            return x
        # deferred: distributed/__init__ → sharding → this module
        from repro_torch.distributed.collectives import all_reduce
        return all_reduce(x, self.mesh, self.tp_axis)

    def replicate_tp(self, x: torch.Tensor) -> torch.Tensor:
        """``x``, replicated over tp, entering work split over tp."""
        if not self.sharded:
            return x
        from repro_torch.distributed.collectives import replicate
        return replicate(x, self.mesh, self.tp_axis)

    def gather_tp(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The tp ranks' blocks of ``x`` concatenated along ``dim``, for
        work split over tp that reads the whole (its gradient is
        reduce-scattered back to the blocks); no mesh: ``x``."""
        if not self.sharded:
            return x
        from repro_torch.distributed.collectives import all_gather
        return all_gather(x, self.mesh, self.tp_axis, dim)


LOCAL = Runtime()
