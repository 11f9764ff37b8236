"""Runtime: what one device needs to know beyond the ArchConfig.

Counterpart of ``repro/models/runtime.py`` without the mesh fields —
the port runs on one device, so only the KV cache's storage type
remains.
"""
from __future__ import annotations

import dataclasses

import torch

_CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class Runtime:
    kv_cache_dtype: str = "bfloat16"

    def cache_dtype(self) -> torch.dtype:
        try:
            return _CACHE_DTYPES[self.kv_cache_dtype]
        except KeyError:
            raise ValueError(
                f"kv_cache_dtype {self.kv_cache_dtype!r}: the port keeps "
                f"{sorted(_CACHE_DTYPES)}") from None


LOCAL = Runtime()
