"""Encoder-decoder transformer (the whisper-small backbone) over a paged
KV cache.

Counterpart of ``repro/models/encdec.py``.  The audio frontend (log-mel
conv stem) is a stub, as in the reference: the caller supplies
precomputed frame embeddings (B, S_enc, d).  Encoder: sinusoidal
positions, then bidirectional attention (flash with ``causal=False``).
Decoder: the sinusoidal embedding of each position added to the token
embedding, then per layer causal self-attention, which applies RoPE as
well (the reference's ``prefill_attention``/``decode_attention``), over
paged K/V; cross-attention over the encoder's K/V (flash with
``causal=False``, Sq = the prompt at prefill and 1 at decode); MLP.

The cross K/V is kept per sequence, (L, lanes, S_enc, H_kv, dh), in the
cache beside the decoder's pages: it is not paged and not charged per
token, as the reference's ``kv_bytes_per_token`` counts the decoder's
self-attention layers only.  A call names the rows of its sequences
with ``lanes`` (default: row b for sequence b).

``forward_train`` runs the same stacks in train mode: the decoder's
causal self-attention (RoPE) and the encoder's and cross attention as
the reference's dense ``attend`` under autograd, never the kernels.
It needs the frames; the synthetic data pipeline gives none, so
neither package's ``TrainLoop`` can train this model (fault C11).

The serving engine takes no encoder-decoder model: the reference's
engine passes no frames to prefill (ROADMAP fault C10), so whisper runs
through these entry points only.

Every entry point takes ``rt``.  Under a mesh-ful runtime the module
holds this rank's compute view (``distributed.sharding.shard_module``)
and each stack runs as the decoder-only trunk does: the vocab-sharded
table and logits, the encoder's, self- and cross-attention's
projections column- and row-parallel by the attention rules, the MLPs
over d_ff, the decoder's pages as the cache's ``KVLayout`` says.  The
cross K/V holds this rank's H_kv/tp heads where the heads split over
tp; where they do not, it is whole on every rank (the reference's
``cache_pspecs`` would split its positions over tp, but the flash
kernel returns no log-sum-exp to merge per-rank blocks of encoder keys
with).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    dtype_of,
    embed_init,
    init_mlp,
    rmsnorm,
    sinusoidal_positions,
)
from repro_torch.models.runtime import LOCAL, Runtime, check_remat
from repro_torch.models.transformer import _check_layout, _logits, _param, \
    _params, _rows, dense_mlp, embed_inputs, layer_of, layer_tree, \
    stack_layers, tensors_from_numpy


class EncoderLayer(nn.Module):
    def __init__(self, weights: dict) -> None:
        super().__init__()
        self.ln1 = _param(weights["ln1"])
        self.attn = _params(weights["attn"])
        self.ln2 = _param(weights["ln2"])
        self.mlp = _params(weights["mlp"])

    def forward(self, x: torch.Tensor, cfg: ArchConfig,
                train: bool = False, rt: Runtime = LOCAL) -> torch.Tensor:
        x = x + attn.encoder_attention_block(
            self.attn, rmsnorm(self.ln1, x), cfg, train, rt)
        return x + dense_mlp(self.mlp, rmsnorm(self.ln2, x), cfg, rt)


class DecoderLayer(nn.Module):
    def __init__(self, weights: dict) -> None:
        super().__init__()
        self.ln1 = _param(weights["ln1"])
        self.self_attn = _params(weights["self_attn"])
        self.ln_x = _param(weights["ln_x"])
        self.cross_attn = _params(weights["cross_attn"])
        self.ln2 = _param(weights["ln2"])
        self.mlp = _params(weights["mlp"])

    def forward(self, x: torch.Tensor, cfg: ArchConfig, attend,
                enc_kv: dict, train: bool = False,
                rt: Runtime = LOCAL) -> torch.Tensor:
        """``attend(attn_params, y)`` is the prefill, decode or train
        self-attention (bound to this layer's KV pages where it has
        them); ``enc_kv`` the layer's cross K/V of the batch's
        sequences."""
        x = x + attend(self.self_attn, rmsnorm(self.ln1, x))
        x = x + attn.cross_attention_block(self.cross_attn,
                                           rmsnorm(self.ln_x, x), enc_kv,
                                           cfg, train, rt)
        return x + dense_mlp(self.mlp, rmsnorm(self.ln2, x), cfg, rt)


class EncoderDecoder(nn.Module):
    """Embedding (tied unembedding), encoder layers and norm, decoder
    layers and the final norm."""

    def __init__(self, cfg: ArchConfig, weights: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = _param(weights["embed"])
        self.enc_layers = nn.ModuleList(EncoderLayer(w)
                                        for w in weights["enc_layers"])
        self.enc_norm = _param(weights["enc_norm"])
        self.dec_layers = nn.ModuleList(DecoderLayer(w)
                                        for w in weights["dec_layers"])
        self.final_norm = _param(weights["final_norm"])

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ============================ params ============================================
def init_params(gen: torch.Generator, cfg: ArchConfig,
                device) -> EncoderDecoder:
    """Random init from ``gen`` (a generator on ``device``)."""
    dtype = dtype_of(cfg.dtype)
    d = cfg.d_model

    def block(*names):
        layer = {}
        for name in names:
            if name.startswith("ln"):
                layer[name] = torch.zeros(d, device=device)
            elif name == "mlp":
                layer[name] = init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype,
                                       device)
            else:
                layer[name] = attn.init_attention(gen, cfg, dtype, device)
        return layer

    return EncoderDecoder(cfg, {
        "embed": embed_init(gen, (cfg.padded_vocab, d), dtype, device),
        "enc_layers": [block("ln1", "attn", "ln2", "mlp")
                       for _ in range(cfg.encoder_layers)],
        "enc_norm": torch.zeros(d, device=device),
        "dec_layers": [block("ln1", "self_attn", "ln_x", "cross_attn", "ln2",
                             "mlp") for _ in range(cfg.num_layers)],
        "final_norm": torch.zeros(d, device=device)})


def params_from_jax(cfg: ArchConfig, np_params: dict,
                    device) -> EncoderDecoder:
    """The reference's param pytree (numpy leaves; encoder and decoder
    layers stacked on a leading axis) → :class:`EncoderDecoder`."""
    return EncoderDecoder(cfg, {
        "embed": tensors_from_numpy(np_params["embed"]["table"], device),
        "enc_layers": [tensors_from_numpy(np_params["enc_layers"], device, i)
                       for i in range(cfg.encoder_layers)],
        "enc_norm": tensors_from_numpy(np_params["enc_norm"], device),
        "dec_layers": [tensors_from_numpy(np_params["dec_layers"], device, i)
                       for i in range(cfg.num_layers)],
        "final_norm": tensors_from_numpy(np_params["final_norm"], device)})


def module_from_tree(cfg: ArchConfig, tree: dict) -> EncoderDecoder:
    """The inverse of :func:`param_tree`: an :class:`EncoderDecoder`
    whose parameters are the tree's tensors (shared, not copied)."""
    return EncoderDecoder(cfg, {
        "embed": tree["embed"]["table"],
        "enc_layers": [layer_of(tree["enc_layers"], i)
                       for i in range(cfg.encoder_layers)],
        "enc_norm": tree["enc_norm"]["scale"],
        "dec_layers": [layer_of(tree["dec_layers"], i)
                       for i in range(cfg.num_layers)],
        "final_norm": tree["final_norm"]["scale"]})


def param_tree(model: EncoderDecoder) -> dict:
    """The model's parameters as the reference's pytree (encoder and
    decoder layers as groups: the reference stacks them), a view of the
    model's own tensors."""
    return {"embed": {"table": model.embed},
            "enc_layers": stack_layers([layer_tree(layer)
                                        for layer in model.enc_layers]),
            "enc_norm": {"scale": model.enc_norm},
            "dec_layers": stack_layers([layer_tree(layer)
                                        for layer in model.dec_layers]),
            "final_norm": {"scale": model.final_norm}}


# ============================ cache ============================================
@dataclasses.dataclass
class EncDecCache:
    """K and V page pools of each decoder layer's self-attention,
    (P, T, H_kv, dh), and the cross K/V of ``lanes`` sequences,
    ``{"k", "v"}: (L, lanes, S_enc, H_kv, dh)``, allocated by the first
    prefill (which knows S_enc)."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    lanes: int
    cross: Optional[dict[str, torch.Tensor]] = None
    #: how this rank's pages hold a sharded cache (None: unsharded)
    layout: Optional[object] = None

    def alloc_cross(self, like: torch.Tensor) -> None:
        """The cross K/V rows of ``lanes`` sequences, shaped as the
        (L, B, S_enc, H_kv, dh) ``like`` (a rank's heads under a
        head-split layout)."""
        self.cross = {n: like.new_zeros((like.shape[0], self.lanes)
                                        + like.shape[2:]) for n in ("k", "v")}


def init_cache(cfg: ArchConfig, total_pages: int, page_tokens: int,
               rt: Runtime = LOCAL, device="cuda",
               lanes: int = 1, layout=None) -> EncDecCache:
    """The decoder's page pools (this rank's H_kv/tp heads under a
    layout that splits heads); the cross K/V comes with the first
    prefill."""
    heads = cfg.num_kv_heads
    if layout is not None and layout.heads:
        heads //= rt.tp_size
    shape = (total_pages, page_tokens, heads, cfg.head_dim)
    dt = rt.cache_dtype()
    return EncDecCache(
        k=[torch.zeros(shape, dtype=dt, device=device)
           for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dt, device=device)
           for _ in range(cfg.num_layers)],
        lanes=lanes, layout=layout)


# ============================ entry points =======================================
def encode(model: EncoderDecoder, frames: torch.Tensor,
           train: bool = False, rt: Runtime = LOCAL) -> torch.Tensor:
    """frames: precomputed (B, S_enc, d) stub-frontend embeddings →
    the encoder's output (B, S_enc, d); dense attention with
    ``train``."""
    cfg = model.cfg
    S = frames.shape[1]
    x = frames.to(dtype_of(cfg.dtype))
    x = x + sinusoidal_positions(torch.arange(S, device=x.device),
                                 cfg.d_model).to(x.dtype)[None]
    for layer in model.enc_layers:
        x = layer(x, cfg, train, rt)
    return rmsnorm(model.enc_norm, x)


def cross_kv(model: EncoderDecoder, enc_out: torch.Tensor,
             rt: Runtime = LOCAL) -> dict[str, torch.Tensor]:
    """Every decoder layer's cross K/V: ``{"k", "v"}: (L, B, S_enc,
    H_kv, dh)`` (a rank's heads where they split over tp)."""
    per_layer = [attn.encoder_kv(layer.cross_attn, enc_out, rt)
                 for layer in model.dec_layers]
    return {n: torch.stack([kv[n] for kv in per_layer]) for n in ("k", "v")}


def _decoder(model: EncoderDecoder, x: torch.Tensor, attend,
             enc_kv: dict, train: bool = False,
             rt: Runtime = LOCAL) -> torch.Tensor:
    """The decoder stack; ``attend(l, p, y)`` is layer l's
    self-attention, ``enc_kv`` the (L, B, ...) cross K/V."""
    for l, layer in enumerate(model.dec_layers):
        x = layer(x, model.cfg, lambda p, y, l=l: attend(l, p, y),
                  {n: t[l] for n, t in enc_kv.items()}, train, rt)
    return x


def forward_train(model: EncoderDecoder, tokens: torch.Tensor,
                  extra_embed: Optional[torch.Tensor] = None,
                  remat: str = "none", rt: Runtime = LOCAL) -> torch.Tensor:
    """Teacher-forced training: the frames ``extra_embed`` (B, S_enc, d)
    encoded, then the decoder tokens (B, S) → (B, S, V_padded) logits
    (this rank's vocabulary block under a mesh), under autograd.
    ``remat`` is checked and, as in the reference (whose
    encoder-decoder ignores ``Runtime.remat``), not applied."""
    check_remat(remat)
    cfg = model.cfg
    if extra_embed is None:
        raise ValueError(f"{cfg.name}: forward_train needs the encoder's "
                         "frames, extra_embed (B, S_enc, d) (fault C11: the "
                         "synthetic data pipeline gives none)")
    xkv = cross_kv(model, encode(model, extra_embed, True, rt), rt)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_inputs(model, tokens, rt=rt)
    x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)[None]
    x = _decoder(model, x, lambda l, p, y: attn.attention_block(
        p, y, cfg, "global", positions, rt), xkv, True, rt)
    return _logits(model, x, rt)


@torch.no_grad()
def prefill(model: EncoderDecoder, tokens: torch.Tensor, cache: EncDecCache,
            block_tables: torch.Tensor, lanes: Optional[torch.Tensor] = None,
            extra_embed: Optional[torch.Tensor] = None,
            rt: Runtime = LOCAL) -> torch.Tensor:
    """Encode the frames ``extra_embed`` (B, S_enc, d), keep their cross
    K/V in rows ``lanes`` of the cache, and consume the decoder prompts
    (B, S), writing their self-attention K/V into the pages of
    ``block_tables`` → (B, 1, V_padded) last-position logits (this
    rank's vocabulary block under a mesh)."""
    cfg = model.cfg
    _check_layout(cache, rt)
    if extra_embed is None:
        raise ValueError(f"{cfg.name}: prefill needs the encoder's frames, "
                         "extra_embed (B, S_enc, d)")
    xkv = cross_kv(model, encode(model, extra_embed, rt=rt), rt)
    if cache.cross is None:
        cache.alloc_cross(xkv["k"])
    if cache.cross["k"].shape[2:] != xkv["k"].shape[2:]:
        raise ValueError(f"{cfg.name}: cross K/V of {xkv['k'].shape[2:]} "
                         f"(frames, heads, dh); this cache holds "
                         f"{cache.cross['k'].shape[2:]}")
    rows = _rows(lanes, tokens)
    for n, t in xkv.items():
        cache.cross[n][:, rows] = t
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = embed_inputs(model, tokens, rt=rt)
    x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)[None]
    x = _decoder(model, x, lambda l, p, y: attn.prefill_attention(
        p, y, cfg, "global", cache.k[l], cache.v[l], block_tables, rt,
        cache.layout), xkv, rt=rt)
    return _logits(model, x[:, -1:, :], rt)


@torch.no_grad()
def decode_step(model: EncoderDecoder, tokens: torch.Tensor,
                cache: EncDecCache, block_tables: torch.Tensor,
                positions: torch.Tensor,
                lanes: Optional[torch.Tensor] = None,
                rt: Runtime = LOCAL) -> torch.Tensor:
    """tokens (B,1), sequence b's token at ``positions[b]`` with its
    cross K/V in row ``lanes[b]`` (default b) → (B,1,V) logits (this
    rank's vocabulary block under a mesh); one KV slot per sequence and
    decoder layer written."""
    cfg = model.cfg
    _check_layout(cache, rt)
    B = tokens.shape[0]
    x = embed_inputs(model, tokens, rt=rt)
    x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)[:, None]
    rows = slice(B) if lanes is None else _rows(lanes, tokens)
    enc_kv = {n: t[:, rows] for n, t in cache.cross.items()}
    x = _decoder(model, x, lambda l, p, y: attn.decode_attention(
        p, y, cfg, "global", cache.k[l], cache.v[l], block_tables,
        positions, rt, cache.layout), enc_kv, rt=rt)
    return _logits(model, x, rt)
