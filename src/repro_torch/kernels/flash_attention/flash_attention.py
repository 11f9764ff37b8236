"""Flash attention (prefill): CUDA kernels for Hopper and their plain
PyTorch versions.

Replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py::flash_attention``.
``csrc/flash_attention.cu`` (whose header says what bounds it on the
H100 and how the design answers) has two routes, both one CTA per
(batch, head, 64-row query tile) walking K/V tiles with (m, l, acc) in
registers and masking a ragged sequence length itself (the TPU kernel
needs ``S % block == 0``):

* ``"wgmma"`` — bfloat16 with a head width of 64, 128 or 256: both
  products on the tensor cores (wgmma), P rounded to bf16 before P·V,
  64-key K/V tiles in a two-stage cp.async ring.  Every pointer and
  every (batch, seq, head) stride must be 16-byte aligned.  At dh 256
  (gemma2, recurrentgemma) the 64 x 256 f32 output tile takes 128
  registers a thread, each P·V step is two 64 x 128 products into its
  two halves, and P enters them as two bf16 parts (hi + lo:
  :data:`SPLIT_P_HEAD_DIMS`), since one rounding of P misses the
  families' tolerance over 4,096-key rows.  Q and the two K and V
  stages take 161 KB of shared memory: one CTA, one warpgroup, an SM.
* ``"scalar"`` — float32 (the tensor cores would mean TF32, beyond the
  float32 tolerance) and bfloat16 at other head widths: both products
  as f32 FMAs out of shared memory.

:func:`flash_attention` dispatches on the device of its inputs: CPU
tensors take :func:`reference_attention`, CUDA tensors launch a kernel
or raise.  :func:`route` is the explicit choice between the two kernels
(dtype and head width).  ``flash_attention.launches`` counts kernel
launches, ``flash_attention.route_launches`` the launches of each route.
:func:`reference_attention_bf16_p` is a plain mirror of the tensor-core
route's arithmetic (64-key tiles, online softmax, P in bf16).

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
#: (route, dtype) → C entry point
_ENTRY = {("scalar", torch.float32): "flash_prefill_f32",
          ("scalar", torch.bfloat16): "flash_prefill_bf16",
          ("wgmma", torch.bfloat16): "flash_prefill_bf16_wgmma"}
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float,
                ctypes.c_float, ctypes.c_void_p])
_STRIDES = ctypes.c_longlong * 12
#: head widths of the tensor-core route
WGMMA_HEAD_DIMS = (64, 128, 256)
#: keys per tile of the tensor-core route
BLOCK_K = 64
#: head widths at which the tensor-core route feeds P to P·V as two
#: bf16 parts (hi + lo) instead of one rounding
SPLIT_P_HEAD_DIMS = (256,)


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
    mask = _mask(S, Sk, causal, window, q.device)
    s = torch.where(mask[None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    any_valid = mask.any(dim=-1)[None, None, :, None]
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    out = torch.where(any_valid, out, 0.0)
    return out.to(q.dtype)


def _mask(S: int, Sk: int, causal: bool, window: Optional[int],
          device) -> torch.Tensor:
    """(S, Sk) bool: which keys each query row sees."""
    q_pos = torch.arange(S, device=device)[:, None]
    k_pos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (k_pos <= q_pos)
    if window is not None:
        mask = mask & (q_pos - k_pos < window)
    return mask


def reference_attention_bf16_p(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, *, causal: bool = True,
                               window: Optional[int] = None,
                               softcap: Optional[float] = None
                               ) -> torch.Tensor:
    """Plain mirror of the tensor-core route's arithmetic: an online
    softmax over 64-key tiles in f32, with each tile's P rounded to
    bfloat16 before P·V (the row sum l keeps the unrounded P) — at the
    widths of :data:`SPLIT_P_HEAD_DIMS` as the sum of two bf16 parts,
    hi = bf16(P) and lo = bf16(P − hi), each through its own product;
    rows that see no key → 0.  Same layouts as
    :func:`reference_attention`."""
    B, H, S, dh = q.shape
    H_kv, Sk = k.shape[1], k.shape[2]
    group = H // H_kv
    k = k.repeat_interleave(group, dim=1).float()
    v = v.repeat_interleave(group, dim=1).float()
    scale = 1.0 / (dh ** 0.5)
    s_all = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    if softcap is not None:
        s_all = softcap * torch.tanh(s_all / softcap)
    mask = _mask(S, Sk, causal, window, q.device)
    m = torch.full((B, H, S, 1), -math.inf, device=q.device)
    l = torch.zeros((B, H, S, 1), device=q.device)
    acc = torch.zeros((B, H, S, dh), device=q.device)
    for k0 in range(0, Sk, BLOCK_K):
        s = s_all[..., k0:k0 + BLOCK_K]
        ok = mask[None, None, :, k0:k0 + BLOCK_K]
        s = torch.where(ok, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp(m - base)
        p = torch.exp(s - base)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        vt = v[:, :, k0:k0 + BLOCK_K]
        hi = p.to(torch.bfloat16).float()
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", hi, vt)
        if dh in SPLIT_P_HEAD_DIMS:
            lo = (p - hi).to(torch.bfloat16).float()
            acc = acc + torch.einsum("bhqk,bhkd->bhqd", lo, vt)
        m = m_new
    out = torch.where(l > 0, acc / l.clamp_min(1e-30), 0.0)
    return out.to(q.dtype)


def route(dtype: torch.dtype, dh: int) -> str:
    """The kernel a CUDA call takes: ``"wgmma"`` for bfloat16 at a head
    width of 64, 128 or 256, ``"scalar"`` otherwise."""
    if dtype == torch.bfloat16 and dh in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "scalar"


def _strides(t: torch.Tensor) -> tuple[int, int, int]:
    """(batch, seq, head) element strides of a (B, H, S, dh) view."""
    return t.stride(0), t.stride(2), t.stride(1)


def _launch(q, k, v, out, causal, window, softcap, which) -> None:
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
    if H % H_kv or dh > 256 or v.shape != k.shape or out.shape != q.shape:
        raise ValueError("flash_attention: shapes q "
                         f"{tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} out {tuple(out.shape)}")
    entry = _ENTRY.get((which, q.dtype))
    if entry is None or (which == "wgmma" and dh not in WGMMA_HEAD_DIMS):
        raise ValueError(f"flash_attention: no {which} kernel for "
                         f"{q.dtype} at head width {dh}")
    if which == "wgmma":
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
            if t.data_ptr() % 16 or any(x % 8 for x in _strides(t)):
                raise ValueError(
                    f"flash_attention: {name} is not 16-byte aligned "
                    f"(pointer {t.data_ptr():#x}, strides {t.stride()}); "
                    "the tensor-core route copies 16-byte chunks")
    fn = build.function("flash_attention", entry, _ARGTYPES)
    strides = _STRIDES(*_strides(q), *_strides(k), *_strides(v),
                       *_strides(out))
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             B, H, H_kv, S, Sk, dh, strides, int(causal),
             int(window or 0), float(softcap or 0.0),
             1.0 / math.sqrt(dh),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, f"flash_attention ({which})")
    flash_attention.launches += 1
    flash_attention.route_launches[which] += 1


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    out: Optional[torch.Tensor] = None,
                    kernel: Optional[str] = None) -> torch.Tensor:
    """q (B,H,S,dh) · k,v (B,H_kv,Sk,dh) → (B,H,S,dh) in q's dtype.
    ``out`` (a (B,H,S,dh) view, dh contiguous) receives the result on
    the CUDA path.  ``kernel`` names the route on CUDA tensors (default
    :func:`route`); the scalar route takes every dtype and width."""
    if not q.is_cuda:
        return reference_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
    if out is None:
        out = torch.empty_like(q)
    _launch(q, k, v, out, causal, window, softcap,
            kernel or route(q.dtype, q.shape[-1]))
    return out


flash_attention.launches = 0
flash_attention.route_launches = {"wgmma": 0, "scalar": 0}
