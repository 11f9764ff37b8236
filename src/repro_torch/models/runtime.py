"""Runtime: what one device needs to know beyond the ArchConfig.

Counterpart of ``repro/models/runtime.py`` without the mesh fields —
the port runs on one device, so the KV cache's storage type and the
training remat policy remain: ``"none"``, or ``"full"`` (each period of
layers recomputed in backward).  The reference's ``"dots"`` names a
policy its code never reads.
"""
from __future__ import annotations

import dataclasses

import torch

_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
REMAT = ("none", "full")


def check_remat(remat: str) -> None:
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}: the port keeps {REMAT}")


@dataclasses.dataclass(frozen=True)
class Runtime:
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


LOCAL = Runtime()
