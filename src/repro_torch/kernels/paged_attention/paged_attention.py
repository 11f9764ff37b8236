"""Paged attention (single-token decode): CUDA kernel for Hopper and
its plain PyTorch version.

Replaces the Pallas TPU kernel
``repro/kernels/paged_attention/paged_attention.py::paged_attention``.
The kernel (``csrc/paged_attention.cu``, whose header says what bounds
it on the H100 and how the design answers) is flash-decoding in two
passes launched by one C entry, on one of two routes that
:func:`route` picks from the dtype, the head width and the group G =
H / H_kv:

* ``"split"`` (any dtype, dh 16-256, any G): pass 1 gives each (kv
  head, sequence, chunk of 64 tokens, tile of up to 8 of the group's
  query heads) a CTA that serves the tile's heads on the CUDA cores;
* ``"group"`` (bfloat16 queries and pages, dh 64/128/256, G from
  :data:`GROUP_MIN` to 16): pass 1 gives each (kv head, sequence, chunk
  of 64 tokens) a CTA that serves all G heads on the tensor cores, so
  the chunk's K/V is read once, with P entering P·V as two bfloat16
  parts (hi + lo) to keep the reference's float32 P·V.

Either pass 1 skips −1 entries, tokens past the context and tokens
behind the window and writes a partial (m, l, acc) per chunk; pass 2,
shared, merges a sequence's partials with one CTA per query head.  The
number of chunks comes from the block table's width, so no context
length is read to the host.

:func:`paged_attention` dispatches on the device of its inputs: CPU
tensors take :func:`reference_paged_attention`, CUDA tensors launch the
kernel or raise; ``kernel="split"`` or ``"group"`` forces a route (to
time one beside the other).  ``paged_attention.launches`` counts kernel
launches (one per call, both passes), ``paged_attention.route_launches``
those of each route (``"split"``, ``"group"``, and their partial forms
``"partial"`` and ``"group_partial"``), and
``paged_attention.windowed_launches`` the launches that had a window.
:func:`reference_paged_attention_split` and
:func:`reference_paged_attention_group` are plain mirrors of the two
routes' arithmetic (per-chunk partials, then the merge).

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
over the whole sequence.  It takes the route :func:`route` names, as
the plain call does.

Inputs:
  q            (B, H, dh)           one decode token per sequence
  k_pages      (P, T, H_kv, dh)     the physical page pool
  v_pages      (P, T, H_kv, dh)
  block_tables (B, max_pages) int32 page ids, -1 padded
  context_lens (B,) int32           valid tokens per sequence
Output: (B, H, dh) in q's dtype; q may be float32 over bfloat16 pages,
as the TPU kernel allows.  A sequence with ``context_lens == 0`` gets
zeros, as the TPU kernel gives (its ``ref.py`` would average V
instead).  The split route takes dh in {16, 32, 64, 128, 256} and
every G from 1 to 16 (in tiles of up to 8 query heads), the group route
bfloat16 at dh 64, 128 and 256 with 16-byte-aligned q and pages; other
shapes raise.
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
#: head widths of the group route (bfloat16 on the tensor cores)
GROUP_HEAD_DIMS = (64, 128, 256)
#: the smallest group G that takes the group route: timed beside the
#: split route at G 1-16 on the card (``chip_smoke.py --paged-probe``),
#: it wins from G 2 up at dh 64, 128 and 256; at G 1 the two are level
GROUP_MIN = 2
#: keys of one CTA of the group route, whatever the page length
GROUP_CHUNK = 64
#: (route, partial form) → its ``paged_attention.route_launches`` key
_LAUNCH_KEY = {("split", False): "split", ("split", True): "partial",
               ("group", False): "group", ("group", True): "group_partial"}
#: bf16 parts in which the group route feeds P to P·V: 2, hi = bf16(p)
#: and lo = bf16(p − hi), each through its own product (one rounding
#: misses the families' tolerance); its mirror reads this, the kernel
#: has the split built in
GROUP_P_PARTS = 2


def pages_per_split(page_tokens: int) -> int:
    """Pages of one split: 64 tokens' worth, or one longer page."""
    return max(1, CHUNK_TOKENS // page_tokens)


def route(dtype: torch.dtype, dh: int, group: int) -> str:
    """The kernel a CUDA call takes: ``"group"`` for bfloat16 queries and
    pages at a head width of 64, 128 or 256 and a group G = H / H_kv
    from :data:`GROUP_MIN` to :data:`MAX_GROUP`, ``"split"`` otherwise
    (float32 queries or pages, other widths, small groups)."""
    if (dtype == torch.bfloat16 and dh in GROUP_HEAD_DIMS
            and GROUP_MIN <= group <= MAX_GROUP):
        return "group"
    return "split"


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


def _chunk_partials(s, v, chunk: int, p_parts: int = 0):
    """Per-chunk partials of masked scores s (B, H, N) (−inf where not
    live) over v (B, N, H, dh): m, l (B, H, n, 1) and acc (B, H, n, dh)
    over chunks of ``chunk`` keys (m = −inf, l = 0, acc = 0 where a
    chunk has no live key).  P enters P·V in float32 (``p_parts`` 0), as
    one bfloat16 rounding (1), or as two bfloat16 parts, hi = bf16(p)
    and lo = bf16(p − hi), each through its own product (2); l keeps the
    unrounded p."""
    B, H, N = s.shape
    n = -(-N // chunk)
    pad = n * chunk - N
    s = torch.nn.functional.pad(s, (0, pad), value=-math.inf) \
        .reshape(B, H, n, chunk)
    v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)) \
        .reshape(B, n, chunk, H, v.shape[-1])
    m = s.amax(dim=-1, keepdim=True)                       # (B, H, n, 1)
    p = torch.exp(s - torch.where(m == -math.inf, 0.0, m))
    l = p.sum(dim=-1, keepdim=True)
    if not p_parts:
        return m, l, torch.einsum("bhnk,bnkhd->bhnd", p, v)
    hi = p.to(torch.bfloat16).float()
    acc = torch.einsum("bhnk,bnkhd->bhnd", hi, v)
    if p_parts > 1:
        lo = (p - hi).to(torch.bfloat16).float()
        acc = acc + torch.einsum("bhnk,bnkhd->bhnd", lo, v)
    return m, l, acc


def _merge_chunks(m, l, acc):
    """The partials of :func:`_chunk_partials` merged as
    ``Σ e^(m_c − M) acc_c / Σ e^(m_c − M) l_c`` with M the largest m:
    (out (B, H, dh), lse (B, H)) in float32; out = 0 and lse = −inf
    where no chunk has a live key."""
    big = m.amax(dim=2, keepdim=True)
    base = torch.where(big == -math.inf, 0.0, big)
    w = torch.exp(m - base)
    num = (w * acc).sum(dim=2)
    den = (w * l).sum(dim=2)
    out = torch.where(den > 0, num / den.clamp_min(1e-30), 0.0)
    lse = torch.where(den[..., 0] > 0,
                      base[:, :, 0, 0] + torch.log(den[..., 0]), -math.inf)
    return out, lse


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
    T = k_pages.shape[1]
    k, v, mask = _dense(q, k_pages, v_pages, block_tables, context_lens,
                        window)
    s = torch.where(mask[:, None, :], _scores(q, k, softcap), -math.inf)
    out, _ = _merge_chunks(*_chunk_partials(s, v, pages_per_split(T) * T))
    return out.to(q.dtype)


def reference_paged_attention_group(q, k_pages, v_pages, block_tables,
                                    context_lens, *, softcap=None,
                                    window=None, key_offset=None):
    """Plain mirror of the group route's arithmetic: each chunk of
    :data:`GROUP_CHUNK` tokens (whatever the page length) gives a
    partial (m, l, acc) for the whole group, with P entering P·V in
    :data:`GROUP_P_PARTS` bfloat16 parts, hi = bf16(p) and lo = bf16(p −
    hi), each through its own product (l keeps the unrounded p); the
    partials merge as in
    :func:`reference_paged_attention_split`.  Returns the output in q's
    dtype, or with ``key_offset`` the partial route's (o, lse) in
    float32 (see :func:`reference_paged_attention_partial`)."""
    if key_offset is None:
        k, v, mask = _dense(q, k_pages, v_pages, block_tables, context_lens,
                            window)
    else:
        span = block_tables.shape[1] * k_pages.shape[1]
        local, lo = _local_span(context_lens, key_offset, span, window)
        k, v, mask = _dense(q, k_pages, v_pages, block_tables, local, lo=lo)
    s = torch.where(mask[:, None, :], _scores(q, k, softcap), -math.inf)
    out, lse = _merge_chunks(*_chunk_partials(s, v, GROUP_CHUNK,
                                              GROUP_P_PARTS))
    if key_offset is not None:
        return out, lse
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
            softcap, window, key_offset=None, lse=None,
            kernel: Optional[str] = None) -> None:
    """One launch of the route :func:`route` names (or ``kernel``, which
    forces ``"split"`` or ``"group"``), on its partial form when
    ``key_offset`` is given (``out`` and ``lse`` then float32)."""
    partial = key_offset is not None
    _check(q, k_pages, v_pages, block_tables, context_lens,
           q if partial else out)
    B, H, dh = q.shape
    P, T, H_kv, _ = k_pages.shape
    G = H // H_kv
    entry = (_PARTIAL_ENTRY if partial else _ENTRY).get(
        (q.dtype, k_pages.dtype))
    if entry is None:
        raise ValueError(f"paged_attention: no kernel for {q.dtype} "
                         f"queries over {k_pages.dtype} pages")
    if dh not in HEAD_DIMS or not 1 <= G <= MAX_GROUP:
        raise ValueError(f"paged_attention: no kernel for head width {dh} "
                         f"and group {G} (widths {HEAD_DIMS}, "
                         f"groups 1-{MAX_GROUP})")
    which = kernel or route(q.dtype, dh, G)
    if which == "group":
        if (q.dtype, k_pages.dtype) != (torch.bfloat16, torch.bfloat16) \
                or dh not in GROUP_HEAD_DIMS:
            raise ValueError(f"paged_attention: no group kernel for "
                             f"{q.dtype} queries over {k_pages.dtype} "
                             f"pages at head width {dh}")
        for name, t in (("q", q), ("k_pages", k_pages),
                        ("v_pages", v_pages)):
            if t.data_ptr() % 16:
                raise ValueError(
                    f"paged_attention: {name} is not 16-byte aligned "
                    f"(pointer {t.data_ptr():#x}); the group route copies "
                    "16-byte chunks")
        entry = "paged_group_bf16"
    elif which != "split":
        raise ValueError(f"paged_attention: no route {which!r}")
    if window is not None and window < 1:
        raise ValueError(f"paged_attention: window {window} must be >= 1")
    max_pages = block_tables.shape[1]
    if max_pages < 1:
        raise ValueError("paged_attention: block tables have no column")
    if which == "group":
        n_split = -(-max_pages * T // GROUP_CHUNK)
    else:
        n_split = -(-max_pages // pages_per_split(T))
    part = torch.empty(B * H_kv * n_split * G * (dh + 2),
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
    elif which == "group":
        ptrs += [None, out.data_ptr(), None]
    else:
        ptrs += [out.data_ptr()]
    fn = build.function("paged_attention", entry,
                        _PARTIAL_ARGTYPES if partial or which == "group"
                        else _ARGTYPES)
    err = fn(*ptrs, part.data_ptr(), B, H, H_kv, T, dh, max_pages,
             int(window or 0), float(softcap or 0.0), 1.0 / math.sqrt(dh),
             torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, f"paged_attention ({which})")
    paged_attention.launches += 1
    paged_attention.route_launches[_LAUNCH_KEY[which, partial]] += 1
    paged_attention.windowed_launches += int(window is not None)


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_tables: torch.Tensor,
                    context_lens: torch.Tensor, *,
                    softcap: Optional[float] = None,
                    window: Optional[int] = None,
                    kernel: Optional[str] = None) -> torch.Tensor:
    """(B,H,dh) decode attention over the paged pool, in q's dtype;
    ``window`` keeps the last ``window`` tokens of each context.
    ``kernel`` forces a route on CUDA (``"split"`` or ``"group"``;
    default :func:`route`'s)."""
    if not q.is_cuda:
        return reference_paged_attention(q, k_pages, v_pages, block_tables,
                                         context_lens, softcap=softcap,
                                         window=window)
    out = torch.empty_like(q)
    _launch(q, k_pages, v_pages, block_tables, context_lens, out, softcap,
            window, kernel=kernel)
    return out


def paged_attention_partial(q: torch.Tensor, k_pages: torch.Tensor,
                            v_pages: torch.Tensor, block_tables: torch.Tensor,
                            context_lens: torch.Tensor,
                            key_offset: torch.Tensor, *,
                            softcap: Optional[float] = None,
                            window: Optional[int] = None,
                            kernel: Optional[str] = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """This block's partial attention (o (B,H,dh), lse (B,H), float32)
    over a sequence-sharded cache (see the module docstring); ``kernel``
    as in :func:`paged_attention`."""
    if not q.is_cuda:
        return reference_paged_attention_partial(
            q, k_pages, v_pages, block_tables, context_lens, key_offset,
            softcap=softcap, window=window)
    out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    _launch(q, k_pages, v_pages, block_tables, context_lens, out, softcap,
            window, key_offset.to(torch.int32).contiguous(), lse,
            kernel=kernel)
    return out, lse


paged_attention.launches = 0
paged_attention.route_launches = {"split": 0, "group": 0, "partial": 0,
                                  "group_partial": 0}
#: split and group launches with a window (local layers)
paged_attention.windowed_launches = 0
