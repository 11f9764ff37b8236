"""Attention over a paged KV cache: GQA with RoPE, full or
sliding-window causal masks and logit soft-capping; prefill writes the
sequence's pages and attends through the flash-prefill kernel, decode
writes one slot per sequence and attends through the paged-decode
kernel.  The whisper encoder's bidirectional attention and the
decoder's cross-attention over the encoder's K/V take the flash kernel
with ``causal=False``.

Counterpart of ``repro/models/attention.py``.  The reference engine
decodes on a dense per-lane cache; here the KV of every layer lives in
``(P, T, H_kv, dh)`` K and V page pools indexed by the
``KVBlockManager``'s block tables, which is the layout the paged kernel
walks.  Both kernels dispatch on the tensors' device: CUDA tensors go
through the hand-written kernels, CPU tensors through their plain
versions.

Training takes neither kernel (they have no backward, as the Pallas
kernels have none): :func:`attention_block` and the ``train=True``
encoder and cross blocks are the reference's dense ``attend`` — f32
logits and softmax, the weights rounded to ``v``'s dtype before the
PV product, GQA by repeating each K/V head — in plain torch ops under
autograd.

``local`` layers (gemma2, recurrentgemma) pass ``cfg.window_size`` to
both kernels.  The reference keeps a ring buffer of ``window`` slots
for them; here they write the same pages as global layers (one block
table serves every layer) and the paged kernel skips the pages behind
the window.

Under a mesh-ful runtime (``Runtime.mesh``) each function computes
this rank's part, following ``distributed.sharding``'s specs: wq/wk/wv
column-parallel (their heads split over tp) or, where the rules split
their input dim d instead, a partial product summed over tp; wo
row-parallel, its partial output summed over tp.  The KV pages follow
the cache's :class:`~repro_torch.distributed.sharding.KVLayout`:

* head-sharded (H_kv % tp == 0): each rank's pages hold its H_kv/tp
  heads, and both kernels run unchanged on the local heads;
* sequence-sharded: rank i of the layout's sequence axes holds global
  positions [i·S/n, (i+1)·S/n) of each sequence.  Prefill runs flash on
  the local query heads against the whole (summed) K/V and writes only
  the rank's positions; decode gathers the query heads over tp, runs
  the paged kernel's partial route over the rank's pages (positions and
  window global), gathers the ranks' (o, lse), merges them and keeps
  the rank's heads for wo.  Each rank's block table must name a page
  for every position of its block.

Shapes: activations (B, S, d); q/k/v (B, S, H, dh).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.kernels.paged_attention import (
    merge_partials,
    paged_attention_partial,
    paged_decode_attention,
)
from repro_torch.models.layers import apply_rope, dense_init, \
    partial_product, softcap
from repro_torch.models.runtime import LOCAL

#: the additive bias of a masked logit (the reference's ``_mask_bias``)
MASKED = -2.38e38


def init_attention(gen: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    return {
        "wq": dense_init(gen, (d, cfg.num_heads, cfg.head_dim), dtype,
                         device),
        "wk": dense_init(gen, (d, cfg.num_kv_heads, cfg.head_dim), dtype,
                         device),
        "wv": dense_init(gen, (d, cfg.num_kv_heads, cfg.head_dim), dtype,
                         device),
        "wo": dense_init(gen, (cfg.num_heads, cfg.head_dim, d), dtype,
                         device),
    }


def _window(cfg, kind: str):
    return cfg.window_size if kind == "local" else None


def _heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) · w (d, n, dh) → (B,S,n,dh)."""
    B, S, d = x.shape
    return (x @ w.reshape(d, -1)).view(B, S, *w.shape[1:])


def _qkv(params, x: torch.Tensor, rt=LOCAL,
         names=("wq", "wk", "wv")) -> dict:
    """x (B,S,d) through the projections ``names`` → {name: (B,S,n,dh)}
    — under a mesh, the heads this tp rank holds: its block where a
    projection's heads split over tp, all of them where its input dim d
    does (the partial products summed over tp)."""
    out = {}
    if rt.sharded:
        x = rt.replicate_tp(x)
        split = [n for n in names if params[n].shape[0] != x.shape[-1]]
        if split:                                    # d split over tp
            m, i = params[split[0]].shape[0], rt.tp_index
            B, S = x.shape[:2]
            xs = x[..., i * m:(i + 1) * m]
            parts = [partial_product(xs, params[n].reshape(m, -1))
                     for n in split]
            # one sum over tp for every d-split projection
            whole = rt.reduce_tp(torch.cat(parts, dim=-1)).to(x.dtype)
            for n, p in zip(split, whole.split(
                    [p.shape[-1] for p in parts], dim=-1)):
                out[n] = rt.replicate_tp(
                    p.reshape(B, S, *params[n].shape[1:]))
    for n in names:
        if n not in out:
            out[n] = _heads(x, params[n])
    return out


def _project(params, x: torch.Tensor, positions: torch.Tensor, cfg,
             rt=LOCAL):
    """q (B,S,H,dh), k/v (B,S,H_kv,dh) with RoPE at ``positions`` (this
    tp rank's heads, as :func:`_qkv`)."""
    out = _qkv(params, x, rt)
    q = apply_rope(out["wq"], positions, cfg.rope_theta)
    k = apply_rope(out["wk"], positions, cfg.rope_theta)
    return q, k, out["wv"]


def _kv_for(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg, rt):
    """K/V for the query heads ``q`` holds: as they are, unless q holds
    this tp rank's block of the heads and k/v all H_kv — then the kv
    heads of those query heads (one head with the group of the block,
    or one kv head per query head)."""
    h = q.shape[2]
    if h == cfg.num_heads or k.shape[2] < cfg.num_kv_heads:
        return k, v
    G = cfg.num_heads // cfg.num_kv_heads
    first = rt.tp_index * h
    if G % h == 0:
        j = first // G
        return k[:, :, j:j + 1], v[:, :, j:j + 1]
    idx = torch.arange(first, first + h, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx)


def _out(params, o: torch.Tensor, cfg=None, rt=LOCAL) -> torch.Tensor:
    """o · wo; under a mesh whose tp splits wo's heads, the ranks'
    float32 partials summed over tp."""
    B, S = o.shape[:2]
    wo = params["wo"]
    o, w = o.reshape(B, S, -1), wo.reshape(-1, wo.shape[-1])
    if rt.sharded and wo.shape[0] < cfg.num_heads:
        return rt.reduce_tp(partial_product(o, w)).to(o.dtype)
    return o @ w


# -- training: the reference's dense attention -------------------------------
def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,S,H_kv,dh) → (B,S,H,dh), each K/V head repeated ``groups``
    times in place (``jnp.repeat``)."""
    return x if groups == 1 else x.repeat_interleave(groups, dim=2)


def _mask_bias(pos: torch.Tensor, causal: bool, window) -> torch.Tensor:
    """(S, S) f32 additive bias over positions ``pos``: 0 where a query
    sees a key, :data:`MASKED` elsewhere."""
    ok = torch.ones((pos.shape[0], pos.shape[0]), dtype=torch.bool,
                    device=pos.device)
    if causal:
        ok = ok & (pos[None, :] <= pos[:, None])
    if window is not None:
        ok = ok & (pos[:, None] - pos[None, :] < window)
    return torch.where(ok, 0.0, MASKED)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           bias: torch.Tensor | None, cap) -> torch.Tensor:
    """q (B,Sq,H,dh), k/v (B,Sk,H,dh), bias (Sq,Sk) or None → (B,Sq,H,dh)
    in v's dtype.  Logits and softmax in f32 (the products of q·k are
    exact in f32, as with the reference's ``preferred_element_type``),
    the weights rounded to v's dtype before the PV product."""
    scale = 1.0 / torch.sqrt(torch.tensor(float(q.shape[-1]),
                                          device=q.device))
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = softcap(logits, cap)
    if bias is not None:
        logits = logits + bias
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def attention_block(params, x: torch.Tensor, cfg, kind: str,
                    positions: torch.Tensor, rt=LOCAL) -> torch.Tensor:
    """Train-mode causal self-attention over whole sequences (x (B,S,d)
    at ``positions`` (S,)): RoPE, the window of a ``local`` layer, the
    softcap, GQA."""
    q, k, v = _project(params, x, positions, cfg, rt)
    k, v = _kv_for(q, k, v, cfg, rt)
    groups = q.shape[2] // k.shape[2]
    o = attend(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
               _mask_bias(positions, True, _window(cfg, kind)),
               cfg.attn_logit_softcap)
    return _out(params, o, cfg, rt)


def prefill_attention(params, x: torch.Tensor, cfg, kind: str,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      block_tables: torch.Tensor, rt=LOCAL,
                      layout=None) -> torch.Tensor:
    """Full-prompt causal attention that also writes the KV pages.

    x (B, S, d) holds B prompts of S tokens at positions 0..S-1; token
    j of sequence b lands in slot ``(block_tables[b, j // T], j % T)``
    of the page pools (updated in place) — under a sharded ``layout``,
    only the tokens of this rank's block, at their positions in it.
    Attention runs on the fresh (un-rounded) k/v, as the reference
    does."""
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)
    q, k, v = _project(params, x, positions, cfg, rt)
    lo, hi = 0, S
    if layout is not None:
        lo = layout.offset(rt.mesh)
        hi = min(S, lo + layout.block_len(rt.mesh))
    if hi > lo:
        _write_prompt(k_pages, v_pages, block_tables, k[:, lo:hi],
                      v[:, lo:hi])
    k, v = _kv_for(q, k, v, cfg, rt)
    o = flash_attention_bshd(q, k, v, causal=True, window=_window(cfg, kind),
                             softcap=cfg.attn_logit_softcap)
    return _out(params, o, cfg, rt)


def _write_prompt(k_pages, v_pages, block_tables, k, v) -> None:
    """k/v (B, n, H_kv, dh) of local positions 0..n-1 into the pages."""
    B, n = k.shape[:2]
    T = k_pages.shape[1]
    positions = torch.arange(n, device=k.device)
    pages = block_tables[:, positions // T].long()              # (B, n)
    slots = (positions % T).expand(B, n)
    k_pages[pages, slots] = k.to(k_pages.dtype)
    v_pages[pages, slots] = v.to(v_pages.dtype)


def decode_attention(params, x: torch.Tensor, cfg, kind: str,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     block_tables: torch.Tensor,
                     positions: torch.Tensor, rt=LOCAL,
                     layout=None) -> torch.Tensor:
    """One-token decode: x (B, 1, d), sequence b's new token at
    ``positions[b]``.  Writes its K/V into slot
    ``(block_tables[b, pos // T], pos % T)`` and attends over the
    ``pos + 1`` tokens of the sequence's pages (the last ``window`` of
    them on a local layer).  Under a sharded ``layout`` see the module
    docstring."""
    T = k_pages.shape[1]
    pos = positions.long()
    q, k, v = _project(params, x, pos[:, None], cfg, rt)
    if layout is not None:
        o = _decode_sharded(q[:, 0], k[:, 0], v[:, 0], cfg, kind, k_pages,
                            v_pages, block_tables, pos, rt, layout)
        return _out(params, o[:, None], cfg, rt)
    pages = block_tables.gather(1, (pos // T)[:, None])[:, 0].long()
    k_pages[pages, pos % T] = k[:, 0].to(k_pages.dtype)
    v_pages[pages, pos % T] = v[:, 0].to(v_pages.dtype)
    o = paged_decode_attention(
        q[:, 0].contiguous(), k_pages, v_pages,
        block_tables, (pos + 1).to(torch.int32),
        softcap=cfg.attn_logit_softcap, window=_window(cfg, kind))
    return _out(params, o[:, None])


def _decode_sharded(q, k, v, cfg, kind, k_pages, v_pages, block_tables,
                    pos, rt, layout) -> torch.Tensor:
    """This rank's (B, h, dh) attention output of a decode step over a
    sharded cache.  The new token's K/V goes into the rank that holds
    its position (a select, so no rank reads a count to the host)."""
    # deferred: distributed/__init__ → sharding → models (this package)
    from repro_torch.distributed.collectives import all_gather
    mesh = rt.mesh
    T = k_pages.shape[1]
    off, L = layout.offset(mesh), layout.block_len(mesh)
    local = pos - off
    mine = ((local >= 0) & (local < L))[:, None, None]
    idx = local.clamp(0, L - 1)
    pages = block_tables.gather(1, (idx // T)[:, None])[:, 0].long()
    for pool, new in ((k_pages, k), (v_pages, v)):
        pool[pages, idx % T] = torch.where(mine, new.to(pool.dtype),
                                           pool[pages, idx % T])
    h = q.shape[1]
    gather = not layout.heads and h < cfg.num_heads
    qa = all_gather(q, mesh, rt.tp_axis, 1).contiguous() if gather else q
    ctx = (pos + 1).to(torch.int32)
    kw = dict(softcap=cfg.attn_logit_softcap, window=_window(cfg, kind))
    if layout.seq:
        o, lse = paged_attention_partial(qa.contiguous(), k_pages, v_pages,
                                         block_tables, ctx,
                                         torch.full_like(ctx, off), **kw)
        # the ranks' (o, lse) in one gather
        both = all_gather(torch.cat([o, lse[..., None]], dim=-1)[None],
                          mesh, layout.seq, 0)
        o = merge_partials(both[..., :-1], both[..., -1]).to(q.dtype)
    else:
        o = paged_decode_attention(qa.contiguous(), k_pages, v_pages,
                                   block_tables, ctx, **kw)
    if gather:
        i = rt.tp_index
        o = o[:, i * h:(i + 1) * h]
    return o


def encoder_attention_block(params, x: torch.Tensor, cfg,
                            train: bool = False, rt=LOCAL) -> torch.Tensor:
    """Bidirectional self-attention over a whole sequence (the whisper
    encoder): no RoPE, no mask; the flash kernel, or :func:`attend`
    with ``train``."""
    p = _qkv(params, x, rt)
    q = p["wq"]
    k, v = _kv_for(q, p["wk"], p["wv"], cfg, rt)
    return _out(params, _unmasked(q, k, v, cfg, train), cfg, rt)


def _unmasked(q, k, v, cfg, train: bool) -> torch.Tensor:
    """Attention of q over every key of k/v: :func:`attend` with
    ``train``, else the flash kernel with ``causal=False``."""
    if train:
        groups = q.shape[2] // k.shape[2]
        return attend(q, _repeat_kv(k, groups), _repeat_kv(v, groups), None,
                      cfg.attn_logit_softcap)
    return flash_attention_bshd(q, k, v, causal=False,
                                softcap=cfg.attn_logit_softcap)


def encoder_kv(params, enc_out: torch.Tensor,
               rt=LOCAL) -> dict[str, torch.Tensor]:
    """A decoder layer's cross-attention K and V over the encoder's
    output: (B, S_enc, H_kv, dh) each (this tp rank's heads where they
    split, all of them where the projections' d does)."""
    p = _qkv(params, enc_out, rt, ("wk", "wv"))
    return {"k": p["wk"], "v": p["wv"]}


def cross_attention_block(params, x: torch.Tensor, enc_kv: dict, cfg,
                          train: bool = False, rt=LOCAL) -> torch.Tensor:
    """Decoder cross-attention: x (B, Sq, d) — the prompt at prefill,
    one token at decode, the whole sequence in training — over the
    encoder's K/V, every key visible; the flash kernel, or
    :func:`attend` with ``train``."""
    q = _qkv(params, x, rt, ("wq",))["wq"]
    k, v = _kv_for(q, enc_kv["k"], enc_kv["v"], cfg, rt)
    return _out(params, _unmasked(q, k, v, cfg, train), cfg, rt)
