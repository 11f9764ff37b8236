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

Shapes: activations (B, S, d); q/k/v (B, S, H, dh).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention_bshd
from repro_torch.kernels.paged_attention import paged_decode_attention
from repro_torch.models.layers import apply_rope, dense_init, softcap

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


def _project(params, x: torch.Tensor, positions: torch.Tensor, cfg):
    """q (B,S,H,dh), k/v (B,S,H_kv,dh) with RoPE at ``positions``."""
    q = apply_rope(_heads(x, params["wq"]), positions, cfg.rope_theta)
    k = apply_rope(_heads(x, params["wk"]), positions, cfg.rope_theta)
    return q, k, _heads(x, params["wv"])


def _out(params, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    wo = params["wo"]
    return o.reshape(B, S, -1) @ wo.reshape(-1, wo.shape[-1])


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
                    positions: torch.Tensor) -> torch.Tensor:
    """Train-mode causal self-attention over whole sequences (x (B,S,d)
    at ``positions`` (S,)): RoPE, the window of a ``local`` layer, the
    softcap, GQA."""
    q, k, v = _project(params, x, positions, cfg)
    groups = cfg.num_heads // cfg.num_kv_heads
    o = attend(q, _repeat_kv(k, groups), _repeat_kv(v, groups),
               _mask_bias(positions, True, _window(cfg, kind)),
               cfg.attn_logit_softcap)
    return _out(params, o)


def prefill_attention(params, x: torch.Tensor, cfg, kind: str,
                      k_pages: torch.Tensor, v_pages: torch.Tensor,
                      block_tables: torch.Tensor) -> torch.Tensor:
    """Full-prompt causal attention that also writes the KV pages.

    x (B, S, d) holds B prompts of S tokens at positions 0..S-1; token
    j of sequence b lands in slot ``(block_tables[b, j // T], j % T)``
    of the page pools (updated in place).  Attention runs on the fresh
    (un-rounded) k/v, as the reference does."""
    B, S, _ = x.shape
    T = k_pages.shape[1]
    positions = torch.arange(S, device=x.device)
    q, k, v = _project(params, x, positions, cfg)
    pages = block_tables[:, positions // T].long()              # (B, S)
    slots = (positions % T).expand(B, S)
    k_pages[pages, slots] = k.to(k_pages.dtype)
    v_pages[pages, slots] = v.to(v_pages.dtype)
    o = flash_attention_bshd(q, k, v, causal=True, window=_window(cfg, kind),
                             softcap=cfg.attn_logit_softcap)
    return _out(params, o)


def decode_attention(params, x: torch.Tensor, cfg, kind: str,
                     k_pages: torch.Tensor, v_pages: torch.Tensor,
                     block_tables: torch.Tensor,
                     positions: torch.Tensor) -> torch.Tensor:
    """One-token decode: x (B, 1, d), sequence b's new token at
    ``positions[b]``.  Writes its K/V into slot
    ``(block_tables[b, pos // T], pos % T)`` and attends over the
    ``pos + 1`` tokens of the sequence's pages (the last ``window`` of
    them on a local layer)."""
    T = k_pages.shape[1]
    pos = positions.long()
    q, k, v = _project(params, x, pos[:, None], cfg)
    pages = block_tables.gather(1, (pos // T)[:, None])[:, 0].long()
    k_pages[pages, pos % T] = k[:, 0].to(k_pages.dtype)
    v_pages[pages, pos % T] = v[:, 0].to(v_pages.dtype)
    o = paged_decode_attention(
        q[:, 0].contiguous(), k_pages, v_pages,
        block_tables, (pos + 1).to(torch.int32),
        softcap=cfg.attn_logit_softcap, window=_window(cfg, kind))
    return _out(params, o[:, None])


def encoder_attention_block(params, x: torch.Tensor, cfg,
                            train: bool = False) -> torch.Tensor:
    """Bidirectional self-attention over a whole sequence (the whisper
    encoder): no RoPE, no mask; the flash kernel, or :func:`attend`
    with ``train``."""
    q, k, v = (_heads(x, params[w]) for w in ("wq", "wk", "wv"))
    if train:
        groups = cfg.num_heads // cfg.num_kv_heads
        o = attend(q, _repeat_kv(k, groups), _repeat_kv(v, groups), None,
                   cfg.attn_logit_softcap)
    else:
        o = flash_attention_bshd(q, k, v, causal=False,
                                 softcap=cfg.attn_logit_softcap)
    return _out(params, o)


def encoder_kv(params, enc_out: torch.Tensor) -> dict[str, torch.Tensor]:
    """A decoder layer's cross-attention K and V over the encoder's
    output: (B, S_enc, H_kv, dh) each."""
    return {"k": _heads(enc_out, params["wk"]),
            "v": _heads(enc_out, params["wv"])}


def cross_attention_block(params, x: torch.Tensor, enc_kv: dict, cfg,
                          train: bool = False) -> torch.Tensor:
    """Decoder cross-attention: x (B, Sq, d) — the prompt at prefill,
    one token at decode, the whole sequence in training — over the
    encoder's K/V, every key visible; the flash kernel, or
    :func:`attend` with ``train``."""
    q = _heads(x, params["wq"])
    if train:
        groups = cfg.num_heads // cfg.num_kv_heads
        o = attend(q, _repeat_kv(enc_kv["k"], groups),
                   _repeat_kv(enc_kv["v"], groups), None,
                   cfg.attn_logit_softcap)
    else:
        o = flash_attention_bshd(q, enc_kv["k"], enc_kv["v"], causal=False,
                                 softcap=cfg.attn_logit_softcap)
    return _out(params, o)
