"""Decoder-only transformer trunk (the attention families: dense, with
global and sliding-window layers, and MoE) as ``nn.Module``s, serving
over a paged KV cache.

Counterpart of ``repro/models/transformer.py``.  The reference stacks
each pattern position's parameters across periods and scans them with
``jax.lax.scan``; here :class:`Transformer` holds the layers in an
``nn.ModuleList`` (depth order) and the entry points loop over it.
:func:`params_from_jax` unstacks a reference pytree into that list.

Entry points, matching the serving split:
  ``prefill``      — prompts in, last-position logits out, KV pages written
  ``decode_step``  — one token per sequence in, logits out, one KV slot
                     per sequence written

The KV cache (:class:`PagedKVCache`) is one ``(P, T, H_kv, dh)`` K page
pool and one V page pool per layer; sequences address them through
``KVBlockManager`` block tables; every layer, global or local, uses the
same table (a local layer's kernel skips the pages behind its window).

Families that run: dense global-only stacks (qwen3-8b, deepseek-7b,
tinyllama-1.1b), gemma2's alternating local/global layers with post
norms and both softcaps (gemma2-2b, gemma2-9b), and MoE MLPs
(qwen3-moe-30b-a3b, qwen3-moe-235b-a22b), whose MLP runs on the
(B·S, d) tokens as the reference's ``_apply_mlp`` flattens them.
Recurrent kinds (rglru, mlstm, slstm), encoder-decoder and VLM stacks
are not ported yet (ROADMAP queue A, 'other model families').
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    dtype_of,
    embed,
    embed_init,
    init_mlp,
    mlp,
    rmsnorm,
    unembed,
)
from repro_torch.models.runtime import LOCAL, Runtime

ATTN_KINDS = ("global", "local")


def check_supported(cfg: ArchConfig) -> None:
    """Raise for the families the port's model stack does not run yet."""
    todo = "ROADMAP queue A, 'other model families'"
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encdec ({cfg.name}): {todo}")
    if cfg.num_vision_tokens:
        raise NotImplementedError(f"VLM frontend ({cfg.name}): {todo}")
    for kind in layer_kinds(cfg):
        if kind not in ATTN_KINDS:
            raise NotImplementedError(f"{kind} layers ({cfg.name}): {todo}")


def layer_kinds(cfg: ArchConfig) -> list[str]:
    """Kind of every layer in depth order (periods, then the tail)."""
    return list(cfg.pattern) * cfg.n_periods + list(cfg.tail_kinds)


# ============================ modules ===========================================
def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _params(weights: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v) for k, v in weights.items()})


class Block(nn.Module):
    """One residual attention + MLP layer.  ``ln*`` are the gemma-style
    rmsnorm scales; ``attn`` holds wq/wk/wv/wo, and ``mlp`` the dense
    MLP's matrices or ``moe`` the router (f32) and the stacked experts,
    in the reference's shapes."""

    def __init__(self, kind: str, weights: dict) -> None:
        super().__init__()
        self.kind = kind
        self.ln1 = _param(weights["ln1"])
        self.attn = _params(weights["attn"])
        self.ln2 = _param(weights["ln2"])
        self.is_moe = "moe" in weights
        if self.is_moe:
            self.moe = _params(weights["moe"])
        else:
            self.mlp = _params(weights["mlp"])
        self.post_norm = "post_ln1" in weights
        if self.post_norm:
            self.post_ln1 = _param(weights["post_ln1"])
            self.post_ln2 = _param(weights["post_ln2"])

    def forward(self, x: torch.Tensor, cfg: ArchConfig, attend
                ) -> torch.Tensor:
        """``attend(attn_params, y)`` is the prefill or decode attention
        bound to this layer's KV pages."""
        y = attend(self.attn, rmsnorm(self.ln1, x))
        if self.post_norm:
            y = rmsnorm(self.post_ln1, y)
        x = x + y
        y = rmsnorm(self.ln2, x)
        if self.is_moe:
            B, S, d = y.shape
            y = moe_lib.moe_mlp(self.moe, y.reshape(B * S, d), cfg) \
                .reshape(B, S, d)
        else:
            y = mlp(self.mlp, y, cfg.mlp_kind)
        if self.post_norm:
            y = rmsnorm(self.post_ln2, y)
        return x + y


class Transformer(nn.Module):
    """Embedding (tied unembedding), the layers in depth order, and the
    final norm.  ``weights`` is ``{"embed", "final_norm", "layers": [per
    layer dict]}`` as :func:`init_params` / :func:`params_from_jax`
    build it."""

    def __init__(self, cfg: ArchConfig, weights: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = _param(weights["embed"])
        self.final_norm = _param(weights["final_norm"])
        self.layers = nn.ModuleList(
            Block(kind, w)
            for kind, w in zip(layer_kinds(cfg), weights["layers"]))

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ============================ params ============================================
def init_params(gen: torch.Generator, cfg: ArchConfig,
                device) -> Transformer:
    """Random init from ``gen`` (a generator on ``device``)."""
    dtype = dtype_of(cfg.dtype)
    d = cfg.d_model
    layers = []
    for _ in layer_kinds(cfg):
        layer = {
            "ln1": torch.zeros(d, device=device),
            "attn": attn.init_attention(gen, cfg, dtype, device),
            "ln2": torch.zeros(d, device=device),
        }
        if cfg.is_moe:
            layer["moe"] = moe_lib.init_moe(gen, cfg, dtype, device)
        else:
            layer["mlp"] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype,
                                    device)
        if cfg.use_post_norm:
            layer["post_ln1"] = torch.zeros(d, device=device)
            layer["post_ln2"] = torch.zeros(d, device=device)
        layers.append(layer)
    return Transformer(cfg, {
        "embed": embed_init(gen, (cfg.padded_vocab, d), dtype, device),
        "final_norm": torch.zeros(d, device=device),
        "layers": layers})


def params_from_jax(cfg: ArchConfig, np_params: dict,
                    device) -> Transformer:
    """The reference's param pytree (leaves as numpy arrays) → the
    port's :class:`Transformer`.  Stacked ``periods["k{j}"]`` leaves
    unstack along their leading axis into layers ``p·|pattern| + j``;
    ``tail{j}`` follows; rmsnorm ``{"scale": s}`` dicts become the
    tensor ``s``.  A ``moe`` subtree comes across as it is, its router
    in float32."""
    check_supported(cfg)

    def conv(tree, idx=None):
        if isinstance(tree, dict):
            if set(tree) == {"scale"}:
                return conv(tree["scale"], idx)
            return {k: conv(v, idx) for k, v in tree.items()}
        arr = np.asarray(tree)
        if idx is not None:
            arr = arr[idx]
        # numpy has no bfloat16: ml_dtypes arrays go through float32;
        # every leaf is copied, never shared with the caller's buffers
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(arr)).to(device)

    layers = []
    P = len(cfg.pattern)
    for p in range(cfg.n_periods):
        for j in range(P):
            layers.append(conv(np_params["periods"][f"k{j}"], p))
    for j in range(len(cfg.tail_kinds)):
        layers.append(conv(np_params[f"tail{j}"]))
    return Transformer(cfg, {"embed": conv(np_params["embed"]["table"]),
                             "final_norm": conv(np_params["final_norm"]),
                             "layers": layers})


# ============================ cache ============================================
@dataclasses.dataclass
class PagedKVCache:
    """Per-layer K and V page pools, each (P, T, H_kv, dh)."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]


def init_cache(cfg: ArchConfig, total_pages: int, page_tokens: int,
               rt: Runtime = LOCAL, device="cuda") -> PagedKVCache:
    shape = (total_pages, page_tokens, cfg.num_kv_heads, cfg.head_dim)
    n = len(layer_kinds(cfg))
    dt = rt.cache_dtype()
    return PagedKVCache(
        k=[torch.zeros(shape, dtype=dt, device=device) for _ in range(n)],
        v=[torch.zeros(shape, dtype=dt, device=device) for _ in range(n)])


# ============================ trunk ============================================
def _logits(model: Transformer, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    x = rmsnorm(model.final_norm, x)
    return unembed(model.embed, x, cfg.vocab_size,
                   cap=cfg.final_logit_softcap)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: PagedKVCache,
            block_tables: torch.Tensor) -> torch.Tensor:
    """(B,S) prompt tokens → (B,1,V_padded) last-position logits; every
    layer's K/V for positions 0..S-1 is written into the pages that
    ``block_tables`` (B, max_pages) names."""
    cfg = model.cfg
    x = embed(model.embed, tokens, scale_by_sqrt_dim=cfg.embed_scale)
    for i, layer in enumerate(model.layers):
        x = layer(x, cfg, lambda p, y, i=i, kind=layer.kind:
                  attn.prefill_attention(p, y, cfg, kind, cache.k[i],
                                         cache.v[i], block_tables))
    return _logits(model, x[:, -1:, :])


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor,
                cache: PagedKVCache, block_tables: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """tokens (B,1), sequence b's token at ``positions[b]`` → (B,1,V)
    logits; one KV slot per sequence and layer written."""
    cfg = model.cfg
    x = embed(model.embed, tokens, scale_by_sqrt_dim=cfg.embed_scale)
    for i, layer in enumerate(model.layers):
        x = layer(x, cfg, lambda p, y, i=i, kind=layer.kind:
                  attn.decode_attention(p, y, cfg, kind, cache.k[i],
                                        cache.v[i], block_tables,
                                        positions))
    return _logits(model, x)
