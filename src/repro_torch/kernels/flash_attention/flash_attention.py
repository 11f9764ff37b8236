"""Flash attention (prefill): CUDA kernel for Hopper and its plain
PyTorch version.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention``.
The kernel (``csrc/flash_attention.cu``, whose header says what bounds
it on the H100 and how the design answers) takes one CTA per
(batch, head, 64-row query tile), walks K/V tiles through shared memory
with (m, l, acc) in registers, and masks a ragged sequence length
itself — the TPU kernel needs ``S % block == 0``.

:func:`flash_attention` dispatches on the device of its inputs: CPU
tensors take :func:`reference_attention`, CUDA tensors launch the
kernel or raise.  ``flash_attention.launches`` counts kernel launches.

Layouts: q (B, H, S, dh) · k/v (B, H_kv, Sk, dh) → out (B, H, S, dh);
any strides, with dh contiguous.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -2.38e38
_ENTRY = {torch.float32: "flash_prefill_f32",
          torch.bfloat16: "flash_prefill_bf16"}


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain version (transcribes ``ref.py``): q (B,H,S,dh) · k,v
    (B,H_kv,Sk,dh) → (B,H,S,dh), f32 softmax; fully-masked rows → 0."""
    B, H, S, dh = q.shape
    H_kv, Sk = k.shape[1], k.shape[2]
    group = H // H_kv
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    scale = 1.0 / (dh ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    any_valid = mask.any(dim=-1)[None, None, :, None]
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = torch.where(any_valid, out, 0.0)
    return out.to(q.dtype)


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, seq, head) element strides of a (B, H, S, dh) view."""
    return t.stride(0), t.stride(2), t.stride(1)


def _launch(q, k, v, out, causal, window, softcap) -> None:
    B, H, S, dh = q.shape
    _, H_kv, Sk, _ = k.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if not t.is_cuda or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be a CUDA "
                             f"tensor of q's dtype, got {t.dtype} on "
                             f"{t.device}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a "
                             "contiguous head dimension")
    if q.dtype not in _ENTRY:
        raise ValueError(f"flash_attention: no kernel for {q.dtype}")
    if H % H_kv or dh > 256 or v.shape != k.shape or out.shape != q.shape:
        raise ValueError("flash_attention: shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} out {tuple(out.shape)}")
    fn = getattr(build.library("flash_attention"), _ENTRY[q.dtype])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                      ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 12)(
        *_strides(q), *_strides(k), *_strides(v), *_strides(out))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, H_kv, S, Sk, dh, strides, int(causal),
             int(window or 0), float(softcap or 0.0),
             1.0 / math.sqrt(dh),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_attention")
    flash_attention.launches += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,H,S,dh) · k,v (B,H_kv,Sk,dh) → (B,H,S,dh) in q's dtype.
    ``out`` (a (B,H,S,dh) view, dh contiguous) receives the result on
    the CUDA path."""
    if not q.is_cuda:
        return reference_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if out is None:
        out = torch.empty_like(q)
    _launch(q, k, v, out, causal, window, softcap)
    return out


flash_attention.launches = 0
