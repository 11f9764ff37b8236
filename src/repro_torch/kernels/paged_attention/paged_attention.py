"""Paged attention (single-token decode): CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the Pallas TPU kernel
``repro/kernels/paged_attention/paged_attention.py::paged_attention``.
The kernel (``csrc/paged_attention.cu``, whose header says what bounds
it on the H100 and how the design answers) is flash-decoding in two
passes launched by one C entry: pass 1 gives each (kv head, sequence,
chunk of 64 tokens, tile of up to 8 of the G = H / H_kv query heads
of the group) a CTA that serves the tile's heads from one read of the
chunk's pages, skipping −1 entries, tokens past the context and tokens
behind the window, and writes a partial (m, l, acc); pass 2 merges a
sequence's partials.  The number of chunks comes from the
block table's width, so no context length is read to the host.

:func:`paged_attention` dispatches on the device of its inputs: CPU
tensors take :func:`reference_paged_attention`, CUDA tensors launch the
kernel or raise.  ``paged_attention.launches`` counts kernel launches
(one per call, both passes), ``paged_attention.route_launches`` those of
the split kernel and of :func:`paged_attention_serial`, the first,
serial kernel kept as the split kernel's timing baseline (any dh and G,
no window), and ``paged_attention.windowed_launches`` the split
launches that had a window.  :func:`reference_paged_attention_split`
is a plain mirror of the split kernel's arithmetic (per-chunk partials,
then the merge).

Sliding window (gemma2's ``local`` layers): with ``window=w`` a token at
position ``k_pos`` of a sequence of context ``ctx`` is live when
``ctx − w ≤ k_pos < ctx``, the reference's decode mask ``cur − k_pos <
w`` with ``cur = ctx − 1`` (``repro/models/attention.py``).  The pages
behind the window stay allocated: every layer of a model shares one
block table per sequence (``models/transformer.py``), so a local layer
skips those pages (pass 1's CTAs behind the window exit at once and
pass 2 starts at the window's first chunk) but cannot free them.  That
matches what the token pool charges, ``kv_bytes_per_token`` over all
attention layers for the whole context.  The TPU kernel has no window;
the reference windows its dense decode.

Partial route (:func:`paged_attention_partial`): one rank's block of a
sequence-sharded cache, whose pages hold global positions
``[key_offset[b], key_offset[b] + max_pages·T)`` of sequence b, with
``context_lens`` and the window in global positions.  It returns the
block's partial softmax in float32 — o over its live tokens and their
``lse = ln Σ e^s`` (o = 0, lse = −inf for a block with none) — and
:func:`merge_partials` combines the ranks' partials into the attention
over the whole sequence.  ``paged_attention.route_launches["partial"]``
counts its launches.

Inputs:
  q            (B, H, dh)           one decode token per sequence
  k_pages      (P, T, H_kv, dh)     the physical page pool
  v_pages      (P, T, H_kv, dh)
  block_tables (B, max_pages) int32 page ids, -1 padded
  context_lens (B,) int32           valid tokens per sequence
Output: (B, H, dh) in q's dtype; q may be float32 over bfloat16 pages,
as the TPU kernel allows.  A sequence with ``context_lens == 0`` gets
zeros, as the TPU kernel gives (its ``ref.py`` would average V
instead).  The kernel takes dh in {16, 32, 64, 128, 256} and every G
from 1 to 16 (in tiles of up to 8 query heads); other shapes raise.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

NEG_INF = -2.38e38
#: tokens of one split of the page list (one page when pages are longer)
CHUNK_TOKENS = 64
HEAD_DIMS = (16, 32, 64, 128, 256)
#: G = H / H_kv from 1 to this
MAX_GROUP = 16
#: (q dtype, page dtype) → C entry point
_ENTRY = {(torch.float32, torch.float32): "paged_decode_f32",
          (torch.bfloat16, torch.bfloat16): "paged_decode_bf16",
          (torch.float32, torch.bfloat16): "paged_decode_f32_bf16"}
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
#: (q dtype, page dtype) → C entry point of the partial route
_PARTIAL_ENTRY = {(torch.float32, torch.float32): "paged_partial_f32",
                  (torch.bfloat16, torch.bfloat16): "paged_partial_bf16",
                  (torch.float32, torch.bfloat16): "paged_partial_f32_bf16"}
_PARTIAL_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                     + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])
_SERIAL_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                    + [ctypes.c_float, ctypes.c_float, ctypes.c_void_p])


def pages_per_split(page_tokens: int) -> int:
    """Pages of one split: 64 tokens' worth, or one longer page."""
    return max(1, CHUNK_TOKENS // page_tokens)


def _dense(q, k_pages, v_pages, block_tables, context_lens, window=None,
           lo=None):
    """Pages gathered per sequence: k, v (B, max_pages·T, H, dh) in f32
    with the kv heads repeated over each group, and the (B, max_pages·T)
    mask of live tokens (before the context, inside the window — or at
    or after ``lo`` (B,) where given —, on a page that is not −1)."""
    B, H, dh = q.shape
    P, T, H_kv, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    group = H // H_kv
    safe = block_tables.long().clamp_min(0)                # (B, max_pages)
    k = k_pages[safe].reshape(B, max_pages * T, H_kv, dh)
    v = v_pages[safe].reshape(B, max_pages * T, H_kv, dh)
    k = k.repeat_interleave(group, dim=2).float()
    v = v.repeat_interleave(group, dim=2).float()
    pos = torch.arange(max_pages * T, device=q.device)[None, :]
    page_ok = (block_tables >= 0)[:, :, None].expand(B, max_pages, T)
    ctx = context_lens[:, None].long()
    mask = (pos < ctx) & page_ok.reshape(B, max_pages * T)
    if lo is not None:
        mask = mask & (pos >= lo[:, None])
    elif window is not None:
        mask = mask & (pos >= ctx - window)
    return k, v, mask


def _scores(q, k, softcap):
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    return s


def reference_paged_attention(q, k_pages, v_pages, block_tables,
                              context_lens, *, softcap=None, window=None):
    """Plain version (transcribes ``ref.py``, with the kernel's zero
    output where no slot is valid, and the window): gathers pages into a
    dense KV per sequence and runs masked softmax attention in f32."""
    k, v, mask = _dense(q, k_pages, v_pages, block_tables, context_lens,
                        window)
    s = _scores(q, k, softcap)
    s = torch.where(mask[:, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", p, v)
    out = torch.where(mask.any(dim=-1)[:, None, None], out, 0.0)
    return out.to(q.dtype)


def reference_paged_attention_split(q, k_pages, v_pages, block_tables,
                                    context_lens, *, softcap=None,
                                    window=None):
    """Plain mirror of the split kernel: each chunk of
    ``pages_per_split(T)`` pages gives a partial (m, l, acc) over its
    live tokens (m = −inf, l = 0, acc = 0 where it has none: past the
    context, behind the window, or on −1 pages; the kernel writes no
    partial for the first two and its merge skips them), and the
    partials merge as ``Σ e^(m_c − M) acc_c / Σ e^(m_c − M) l_c`` with
    M the largest m; no live token → 0."""
    B, H, dh = q.shape
    T = k_pages.shape[1]
    k, v, mask = _dense(q, k_pages, v_pages, block_tables, context_lens,
                        window)
    s = torch.where(mask[:, None, :], _scores(q, k, softcap), -math.inf)
    chunk = pages_per_split(T) * T
    n = -(-s.shape[-1] // chunk)
    pad = n * chunk - s.shape[-1]
    s = torch.nn.functional.pad(s, (0, pad), value=-math.inf) \
        .reshape(B, H, n, chunk)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) \
        .reshape(B, n, chunk, H, dh)
    m = s.amax(dim=-1, keepdim=True)                       # (B, H, n, 1)
    p = torch.exp(s - torch.where(m == -math.inf, 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhnk,bnkhd->bhnd", p, v)
    big = m.amax(dim=2, keepdim=True)
    w = torch.exp(m - torch.where(big == -math.inf, 0.0, big))
    num = (w * acc).sum(dim=2)
    den = (w * l).sum(dim=2)
    out = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    return out.to(q.dtype)


def _local_span(context_lens, key_offset, span: int, window):
    """A block's local context (B,) and its first live local position
    (B,) or None, from global contexts and the block's offsets."""
    ctx = context_lens.long()
    off = key_offset.long()
    local = (ctx - off).clamp(0, span)
    lo = None if window is None else ctx - window - off
    return local, lo


def reference_paged_attention_partial(q, k_pages, v_pages, block_tables,
                                      context_lens, key_offset, *,
                                      softcap=None, window=None):
    """Plain version of the partial route: (o (B, H, dh), lse (B, H)),
    both float32, over the live tokens of this block (global positions
    ``key_offset[b]`` + local position, live when before
    ``context_lens[b]`` and inside the window); o = 0, lse = −inf where
    the block has none."""
    span = block_tables.shape[1] * k_pages.shape[1]
    local, lo = _local_span(context_lens, key_offset, span, window)
    k, v, mask = _dense(q, k_pages, v_pages, block_tables, local, lo=lo)
    s = torch.where(mask[:, None, :], _scores(q, k, softcap), -math.inf)
    lse = torch.logsumexp(s, dim=-1)                        # (B, H)
    p = torch.exp(s - torch.where(lse == -math.inf, 0.0, lse)[..., None])
    o = torch.einsum("bhk,bkhd->bhd", p, v)
    return o, lse


def merge_partials(o: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """The ranks' partials, o (n, B, H, dh) and lse (n, B, H), merged:
    ``Σ_r e^(lse_r − M) o_r / Σ_r e^(lse_r − M)`` with M the largest
    lse; 0 where every rank's block was empty.  Float32."""
    big = lse.amax(dim=0)
    w = torch.exp(lse - torch.where(big == -math.inf, 0.0, big))
    den = w.sum(dim=0)
    num = (w[..., None] * o).sum(dim=0)
    return torch.where(den[..., None] > 0,
                       num / den.clamp_min(1e-30)[..., None], 0.0)


def _check(q, k_pages, v_pages, block_tables, context_lens, out) -> None:
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
    if (H % H_kv or v_pages.shape != k_pages.shape or k_pages.shape[3] != dh
            or block_tables.shape[0] != B or context_lens.shape != (B,)):
        raise ValueError("paged_attention: shapes q "
                         f"{tuple(q.shape)} pages {tuple(k_pages.shape)} "
                         f"tables {tuple(block_tables.shape)}")


def _launch(q, k_pages, v_pages, block_tables, context_lens, out,
            softcap, window, key_offset=None, lse=None) -> None:
    """One launch of the split kernel, or of its partial route when
    ``key_offset`` is given (``out`` and ``lse`` then float32)."""
    partial = key_offset is not None
    _check(q, k_pages, v_pages, block_tables, context_lens,
           q if partial else out)
    B, H, dh = q.shape
    P, T, H_kv, _ = k_pages.shape
    entry = (_PARTIAL_ENTRY if partial else _ENTRY).get(
        (q.dtype, k_pages.dtype))
    if entry is None:
        raise ValueError(f"paged_attention: no kernel for {q.dtype} "
                         f"queries over {k_pages.dtype} pages")
    if dh not in HEAD_DIMS or not 1 <= H // H_kv <= MAX_GROUP:
        raise ValueError(f"paged_attention: no kernel for head width {dh} "
                         f"and group {H // H_kv} (widths {HEAD_DIMS}, "
                         f"groups 1-{MAX_GROUP})")
    if window is not None and window < 1:
        raise ValueError(f"paged_attention: window {window} must be >= 1")
    max_pages = block_tables.shape[1]
    if max_pages < 1:
        raise ValueError("paged_attention: block tables have no column")
    n_split = -(-max_pages // pages_per_split(T))
    part = torch.empty(B * H_kv * n_split * (H // H_kv) * (dh + 2),
                       dtype=torch.float32, device=q.device)
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), context_lens.data_ptr()]
    if partial:
        for name, t, dtype in (("key_offset", key_offset, torch.int32),
                               ("out", out, torch.float32),
                               ("lse", lse, torch.float32)):
            if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
                raise ValueError(f"paged_attention_partial: {name} must be "
                                 f"a contiguous CUDA {dtype} tensor")
        ptrs += [key_offset.data_ptr(), out.data_ptr(), lse.data_ptr()]
        fn = build.function("paged_attention", entry, _PARTIAL_ARGTYPES)
    else:
        ptrs += [out.data_ptr()]
        fn = build.function("paged_attention", entry, _ARGTYPES)
    err = fn(*ptrs, part.data_ptr(), B, H, H_kv, T, dh, max_pages,
             int(window or 0), float(softcap or 0.0), 1.0 / math.sqrt(dh),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention")
    paged_attention.launches += 1
    paged_attention.route_launches["partial" if partial else "split"] += 1
    paged_attention.windowed_launches += int(window is not None)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """(B,H,dh) decode attention over the paged pool, in q's dtype;
    ``window`` keeps the last ``window`` tokens of each context."""
    if not q.is_cuda:
        return reference_paged_attention(q, k_pages, v_pages, block_tables,
                                         context_lens, softcap=softcap,
                                         window=window)
    out = torch.empty_like(q)
    _launch(q, k_pages, v_pages, block_tables, context_lens, out, softcap,
            window)
    return out


def paged_attention_partial(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            context_lens: torch.Tensor,
                            key_offset: torch.Tensor, *,
                            softcap: Optional[float] = None,
                            window: Optional[int] = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """This block's partial attention (o (B,H,dh), lse (B,H), float32)
    over a sequence-sharded cache (see the module docstring)."""
    if not q.is_cuda:
        return reference_paged_attention_partial(
            q, k_pages, v_pages, block_tables, context_lens, key_offset,
            softcap=softcap, window=window)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(q, k_pages, v_pages, block_tables, context_lens, out, softcap,
            window, key_offset.to(torch.int32).contiguous(), lse)
    return out, lse


def paged_attention_serial(q, k_pages, v_pages, block_tables, context_lens,
                           *, softcap=None) -> torch.Tensor:
    """The first kernel of the port (one CTA per (sequence, kv head),
    pages in series), bfloat16 on CUDA only: the baseline that
    ``chip_smoke.py`` times beside the split kernel.  It takes dh and G
    at run time and has no window.  No path calls it."""
    out = torch.empty_like(q)
    _check(q, k_pages, v_pages, block_tables, context_lens, out)
    if q.dtype != torch.bfloat16 or k_pages.dtype != torch.bfloat16:
        raise ValueError("paged_attention_serial: bfloat16 only")
    B, H, dh = q.shape
    P, T, H_kv, _ = k_pages.shape
    fn = build.function("paged_attention", "paged_decode_serial_bf16",
                        _SERIAL_ARGTYPES)
    err = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
             block_tables.data_ptr(), context_lens.data_ptr(),
             out.data_ptr(), B, H, H_kv, T, dh, block_tables.shape[1],
             float(softcap or 0.0), 1.0 / math.sqrt(dh),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "paged_attention_serial")
    paged_attention.launches += 1
    paged_attention.route_launches["serial"] += 1
    return out


paged_attention.launches = 0
paged_attention.route_launches = {"split": 0, "partial": 0, "serial": 0}
#: split launches with a window (local layers)
paged_attention.windowed_launches = 0
