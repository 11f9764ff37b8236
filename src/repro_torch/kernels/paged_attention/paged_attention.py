"""Paged attention (single-token decode): CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the Pallas TPU kernel
``repro/kernels/paged_attention/paged_attention.py::paged_attention``.
The kernel (``csrc/paged_attention.cu``, whose header says what bounds
it on the H100 and how the design answers) takes one CTA per
(sequence, kv head), serving the G = H / H_kv query heads of the group
from one read of each page, and walks the block table up to
``ceil(ctx / T)`` pages, skipping −1 entries.

:func:`paged_attention` dispatches on the device of its inputs: CPU
tensors take :func:`reference_paged_attention`, CUDA tensors launch the
kernel or raise.  ``paged_attention.launches`` counts kernel launches.

Inputs:
  q            (B, H, dh)           one decode token per sequence
  k_pages      (P, T, H_kv, dh)     the physical page pool
  v_pages      (P, T, H_kv, dh)
  block_tables (B, max_pages) int32 page ids, -1 padded
  context_lens (B,) int32           valid tokens per sequence
Output: (B, H, dh) in q's dtype; q may be float32 over bfloat16 pages,
as the TPU kernel allows.  A sequence with ``context_lens == 0`` gets
zeros, as the TPU kernel gives (its ``ref.py`` would average V
instead).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -2.38e38
#: (q dtype, page dtype) → C entry point
_ENTRY = {(torch.float32, torch.float32): "paged_decode_f32",
          (torch.bfloat16, torch.bfloat16): "paged_decode_bf16",
          (torch.float32, torch.bfloat16): "paged_decode_f32_bf16"}


def reference_paged_attention(q, k_pages, v_pages, block_tables,
                              context_lens, *, softcap=None):
    """Plain version (transcribes ``ref.py``, with the kernel's zero
    output where no slot is valid): gathers pages into a dense KV per
    sequence and runs masked softmax attention in f32."""
    B, H, dh = q.shape
    P, T, H_kv, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    group = H // H_kv

    safe = block_tables.long().clamp_min(0)                # (B, max_pages)
    k = k_pages[safe].reshape(B, max_pages * T, H_kv, dh)
    v = v_pages[safe].reshape(B, max_pages * T, H_kv, dh)
    k = k.repeat_interleave(group, dim=2)
    v = v.repeat_interleave(group, dim=2)

    scale = 1.0 / (dh ** 0.5)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(max_pages * T, device=q.device)[None, :]
    page_ok = (block_tables >= 0)[:, :, None].expand(B, max_pages, T)
    mask = (pos < context_lens[:, None].long()) \
        & page_ok.reshape(B, max_pages * T)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v.float())
    out = torch.where(mask.any(dim=-1)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def _launch(q, k_pages, v_pages, block_tables, context_lens, out,
            softcap) -> None:
    B, H, dh = q.shape
    P, T, H_kv, _ = k_pages.shape
    kv_dtype = k_pages.dtype
    for name, t, dtype in (("q", q, q.dtype), ("k_pages", k_pages, kv_dtype),
                           ("v_pages", v_pages, kv_dtype),
                           ("block_tables", block_tables, torch.int32),
                           ("context_lens", context_lens, torch.int32),
                           ("out", out, q.dtype)):
        if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"paged_attention: {name} must be a "
                             f"contiguous CUDA {dtype} tensor, got "
                             f"{t.dtype} on {t.device}")
    entry = _ENTRY.get((q.dtype, kv_dtype))
    if entry is None:
        raise ValueError(f"paged_attention: no kernel for {q.dtype} "
                         f"queries over {kv_dtype} pages")
    if (H % H_kv or v_pages.shape != k_pages.shape or k_pages.shape[3] != dh
            or block_tables.shape[0] != B or context_lens.shape != (B,)):
        raise ValueError("paged_attention: shapes q "
                         f"{tuple(q.shape)} pages {tuple(k_pages.shape)} "
                         f"tables {tuple(block_tables.shape)}")
    fn = getattr(build.library("paged_attention"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), context_lens.data_ptr(),
             out.data_ptr(), B, H, H_kv, T, dh, block_tables.shape[1],
             float(softcap or 0.0), 1.0 / math.sqrt(dh),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention")
    paged_attention.launches += 1


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """(B,H,dh) decode attention over the paged pool, in q's dtype."""
    if not q.is_cuda:
        return reference_paged_attention(q, k_pages, v_pages, block_tables,
                                         context_lens, softcap=softcap)
    out = torch.empty_like(q)
    _launch(q, k_pages, v_pages, block_tables, context_lens, out, softcap)
    return out


paged_attention.launches = 0
