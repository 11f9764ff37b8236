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
    embed,
    embed_init,
    init_mlp,
    mlp,
    rmsnorm,
    sinusoidal_positions,
    unembed,
)
from repro_torch.models.runtime import LOCAL, Runtime, check_remat
from repro_torch.models.transformer import _param, _params, _rows, \
    layer_tree, stack_layers, tensors_from_numpy


class EncoderLayer(nn.Module):
    def __init__(self, weights: dict) -> None:
        super().__init__()
        self.ln1 = _param(weights["ln1"])
        self.attn = _params(weights["attn"])
        self.ln2 = _param(weights["ln2"])
        self.mlp = _params(weights["mlp"])

    def forward(self, x: torch.Tensor, cfg: ArchConfig,
                train: bool = False) -> torch.Tensor:
        x = x + attn.encoder_attention_block(self.attn,
                                             rmsnorm(self.ln1, x), cfg, train)
        return x + mlp(self.mlp, rmsnorm(self.ln2, x), cfg.mlp_kind)


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
                enc_kv: dict, train: bool = False) -> torch.Tensor:
        """``attend(attn_params, y)`` is the prefill, decode or train
        self-attention (bound to this layer's KV pages where it has
        them); ``enc_kv`` the layer's cross K/V of the batch's
        sequences."""
        x = x + attend(self.self_attn, rmsnorm(self.ln1, x))
        x = x + attn.cross_attention_block(self.cross_attn,
                                           rmsnorm(self.ln_x, x), enc_kv,
                                           cfg, train)
        return x + mlp(self.mlp, rmsnorm(self.ln2, x), cfg.mlp_kind)


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


def init_cache(cfg: ArchConfig, total_pages: int, page_tokens: int,
               rt: Runtime = LOCAL, device="cuda",
               lanes: int = 1, layout=None) -> EncDecCache:
    if layout is not None:
        _unsharded(cfg)
    shape = (total_pages, page_tokens, cfg.num_kv_heads, cfg.head_dim)
    dt = rt.cache_dtype()
    return EncDecCache(
        k=[torch.zeros(shape, dtype=dt, device=device)
           for _ in range(cfg.num_layers)],
        v=[torch.zeros(shape, dtype=dt, device=device)
           for _ in range(cfg.num_layers)],
        lanes=lanes)


def _unsharded(cfg: ArchConfig) -> None:
    raise NotImplementedError(
        f"{cfg.name}: sharded execution of the encoder-decoder is ROADMAP "
        "slice 11 (the sharding rules cover it)")


# ============================ entry points =======================================
def encode(model: EncoderDecoder, frames: torch.Tensor,
           train: bool = False) -> torch.Tensor:
    """frames: precomputed (B, S_enc, d) stub-frontend embeddings →
    the encoder's output (B, S_enc, d); dense attention with
    ``train``."""
    cfg = model.cfg
    S = frames.shape[1]
    x = frames.to(dtype_of(cfg.dtype))
    x = x + sinusoidal_positions(torch.arange(S, device=x.device),
                                 cfg.d_model).to(x.dtype)[None]
    for layer in model.enc_layers:
        x = layer(x, cfg, train)
    return rmsnorm(model.enc_norm, x)


def cross_kv(model: EncoderDecoder,
             enc_out: torch.Tensor) -> dict[str, torch.Tensor]:
    """Every decoder layer's cross K/V: ``{"k", "v"}: (L, B, S_enc,
    H_kv, dh)``."""
    per_layer = [attn.encoder_kv(layer.cross_attn, enc_out)
                 for layer in model.dec_layers]
    return {n: torch.stack([kv[n] for kv in per_layer]) for n in ("k", "v")}


def _decoder(model: EncoderDecoder, x: torch.Tensor, attend,
             enc_kv: dict, train: bool = False) -> torch.Tensor:
    """The decoder stack; ``attend(l, p, y)`` is layer l's
    self-attention, ``enc_kv`` the (L, B, ...) cross K/V."""
    for l, layer in enumerate(model.dec_layers):
        x = layer(x, model.cfg, lambda p, y, l=l: attend(l, p, y),
                  {n: t[l] for n, t in enc_kv.items()}, train)
    return x


def _logits(model: EncoderDecoder, x: torch.Tensor) -> torch.Tensor:
    cfg = model.cfg
    return unembed(model.embed, rmsnorm(model.final_norm, x),
                   cfg.vocab_size, cap=cfg.final_logit_softcap)


def forward_train(model: EncoderDecoder, tokens: torch.Tensor,
                  extra_embed: Optional[torch.Tensor] = None,
                  remat: str = "none", rt: Runtime = LOCAL) -> torch.Tensor:
    """Teacher-forced training: the frames ``extra_embed`` (B, S_enc, d)
    encoded, then the decoder tokens (B, S) → (B, S, V_padded) logits,
    under autograd.  ``remat`` is checked and, as in the reference
    (whose encoder-decoder ignores ``Runtime.remat``), not applied.
    There is no sharded form yet (``rt`` must be unsharded)."""
    check_remat(remat)
    cfg = model.cfg
    if rt.sharded:
        _unsharded(cfg)
    if extra_embed is None:
        raise ValueError(f"{cfg.name}: forward_train needs the encoder's "
                         "frames, extra_embed (B, S_enc, d) (fault C11: the "
                         "synthetic data pipeline gives none)")
    xkv = cross_kv(model, encode(model, extra_embed, train=True))
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = embed(model.embed, tokens)
    x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)[None]
    x = _decoder(model, x, lambda l, p, y: attn.attention_block(
        p, y, cfg, "global", positions), xkv, train=True)
    return _logits(model, x)


@torch.no_grad()
def prefill(model: EncoderDecoder, tokens: torch.Tensor, cache: EncDecCache,
            block_tables: torch.Tensor, lanes: Optional[torch.Tensor] = None,
            extra_embed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Encode the frames ``extra_embed`` (B, S_enc, d), keep their cross
    K/V in rows ``lanes`` of the cache, and consume the decoder prompts
    (B, S), writing their self-attention K/V into the pages of
    ``block_tables`` → (B, 1, V_padded) last-position logits."""
    cfg = model.cfg
    if extra_embed is None:
        raise ValueError(f"{cfg.name}: prefill needs the encoder's frames, "
                         "extra_embed (B, S_enc, d)")
    xkv = cross_kv(model, encode(model, extra_embed))
    L, B, S_enc = xkv["k"].shape[:3]
    if cache.cross is None:
        cache.cross = {n: t.new_zeros((L, cache.lanes) + t.shape[2:])
                       for n, t in xkv.items()}
    if cache.cross["k"].shape[2] != S_enc:
        raise ValueError(f"{cfg.name}: {S_enc} frames; this cache holds the "
                         f"cross K/V of {cache.cross['k'].shape[2]}")
    rows = _rows(lanes, tokens)
    for n, t in xkv.items():
        cache.cross[n][:, rows] = t
    S = tokens.shape[1]
    positions = torch.arange(S, device=tokens.device)
    x = embed(model.embed, tokens)
    x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)[None]
    x = _decoder(model, x, lambda l, p, y: attn.prefill_attention(
        p, y, cfg, "global", cache.k[l], cache.v[l], block_tables), xkv)
    return _logits(model, x[:, -1:, :])


@torch.no_grad()
def decode_step(model: EncoderDecoder, tokens: torch.Tensor,
                cache: EncDecCache, block_tables: torch.Tensor,
                positions: torch.Tensor,
                lanes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens (B,1), sequence b's token at ``positions[b]`` with its
    cross K/V in row ``lanes[b]`` (default b) → (B,1,V) logits; one KV
    slot per sequence and decoder layer written."""
    cfg = model.cfg
    B = tokens.shape[0]
    x = embed(model.embed, tokens)
    x = x + sinusoidal_positions(positions, cfg.d_model).to(x.dtype)[:, None]
    rows = slice(B) if lanes is None else _rows(lanes, tokens)
    enc_kv = {n: t[:, rows] for n, t in cache.cross.items()}
    x = _decoder(model, x, lambda l, p, y: attn.decode_attention(
        p, y, cfg, "global", cache.k[l], cache.v[l], block_tables,
        positions), enc_kv)
    return _logits(model, x)
