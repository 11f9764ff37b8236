"""Model-layout entry point: (B, S, H, dh) in and out.  The kernel reads
the (B, H, S, dh) views of the model's tensors in place (strided), so
no transpose is copied."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, *, causal: bool = True,
                         window: Optional[int] = None,
                         softcap: Optional[float] = None) -> torch.Tensor:
    """q (B,S,H,dh), k/v (B,Sk,H_kv,dh) → (B,S,H,dh)."""
    out = torch.empty_like(q) if q.is_cuda else None
    res = flash_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, softcap=softcap,
        out=None if out is None else out.transpose(1, 2))
    return out if out is not None else res.transpose(1, 2)
