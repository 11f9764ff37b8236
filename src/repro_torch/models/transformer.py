"""Decoder-only trunk of every decoder-only family — dense, with global
and sliding-window layers, MoE, the RG-LRU hybrid, xLSTM and the VLM
backbone — as ``nn.Module``s, serving over a paged KV cache.

Counterpart of ``repro/models/transformer.py``.  The reference stacks
each pattern position's parameters across periods and scans them with
``jax.lax.scan``; here :class:`Transformer` holds the layers in an
``nn.ModuleList`` (depth order) and the entry points loop over it.
:func:`params_from_jax` unstacks a reference pytree into that list.

Entry points, matching the serving/training split:
  ``forward_train`` — full-sequence logits under autograd, no cache
                      (dense attention: the kernels have no backward)
  ``prefill``       — prompts in, last-position logits out, KV pages and
                      recurrent state written
  ``decode_step``   — one token per sequence in, logits out, one KV slot
                      per sequence and attention layer written, each
                      recurrent layer's state advanced one step

A model's parameters are created frozen (``requires_grad=False``); the
train step turns gradients on for the model it trains, and the serve
entry points run under ``torch.no_grad``.  :func:`param_tree` views
them as the reference's pytree — the same key paths, each stacked leaf
as the group (list) of its per-period tensors — which is what the
optimizer's decay mask, the gradient compressor and the checkpoint key
on.

The cache (:class:`PagedKVCache`) holds one ``(P, T, H_kv, dh)`` K page
pool and one V page pool per *attention* layer, which sequences address
through ``KVBlockManager`` block tables (every attention layer, global
or local, uses the same table; a local layer's kernel skips the pages
behind its window), and the state of every recurrent layer (rglru,
mlstm, slstm) as ``(lanes, ...)`` tensors, one row per sequence slot.
A call names the rows of its sequences with ``lanes`` (default: row b
for sequence b).  Recurrent layers treat each row on its own, so a
batch may hold any subset of the rows.

MoE MLPs run on the (B·S, d) tokens, as the reference's ``_apply_mlp``
flattens them.  A VLM prompt may carry ``extra_embed`` patch
embeddings, projected by ``vision_proj`` and put in front of the text.

Sharded execution: every entry point takes ``rt``.  With a mesh-ful
runtime the module holds this rank's *compute view* of the weights
(``distributed.sharding.shard_module``) and each entry point runs the
rank's part of the reference's sharded program.  The embedding table is
vocab-sharded over tp (a masked lookup, then a sum over tp) and the
logits stay vocab-sharded (:func:`greedy` picks a token from them); the
attention and dense-MLP projections are column- and row-parallel; the
MoE MLP is expert-parallel (``moe.moe_mlp_ep``); the KV cache follows
its :class:`~repro_torch.distributed.sharding.KVLayout`.  Norms are
replicated.  A recurrent layer runs as ``models.rglru`` and
``models.ssm`` describe (RG-LRU over blocks of its channels, the xLSTM
cells with their products split and their recurrences whole on every tp
rank), from the state the layout gives it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.config import ArchConfig
from repro_torch.models.layers import (
    dense_init,
    dtype_of,
    embed,
    embed_init,
    init_mlp,
    mlp,
    rmsnorm,
    unembed,
)
from repro_torch.models.runtime import LOCAL, Runtime, check_remat

ATTN_KINDS = ("global", "local")
#: recurrent kind → its per-sequence state, ``fn(batch, cfg, device)``
_STATE = {"rglru": rglru_lib.rglru_state, "mlstm": ssm_lib.mlstm_state,
          "slstm": ssm_lib.slstm_state}


def check_supported(cfg: ArchConfig) -> None:
    """Raise for a layer kind neither package knows."""
    for kind in layer_kinds(cfg):
        if kind not in ATTN_KINDS and kind not in _STATE:
            raise ValueError(f"unknown layer kind {kind!r} ({cfg.name})")


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

    def forward(self, x: torch.Tensor, cfg: ArchConfig, attend,
                rt: Runtime = LOCAL) -> torch.Tensor:
        """``attend(attn_params, y)`` is the prefill or decode attention
        bound to this layer's KV pages."""
        y = attend(self.attn, rmsnorm(self.ln1, x))
        if self.post_norm:
            y = rmsnorm(self.post_ln1, y)
        x = x + y
        y = self.feed_forward(rmsnorm(self.ln2, x), cfg, rt)
        if self.post_norm:
            y = rmsnorm(self.post_ln2, y)
        return x + y

    def feed_forward(self, y: torch.Tensor, cfg: ArchConfig,
                     rt: Runtime = LOCAL) -> torch.Tensor:
        """The dense MLP or the MoE on the normed y (B, S, d): under a
        mesh, expert-parallel, or with d_ff split over tp (w_gate/w_up
        column-, w_down row-parallel)."""
        if self.is_moe:
            B, S, d = y.shape
            if rt.sharded:
                out = moe_lib.moe_mlp_ep(self.moe, y.reshape(B * S, d), cfg,
                                         rt)
            else:
                out = moe_lib.moe_mlp(self.moe, y.reshape(B * S, d), cfg)
            return out.reshape(B, S, d)
        return dense_mlp(self.mlp, y, cfg, rt)


def dense_mlp(params, y: torch.Tensor, cfg: ArchConfig,
              rt: Runtime = LOCAL) -> torch.Tensor:
    """The dense MLP on the normed y; under a mesh whose tp splits d_ff,
    w_gate/w_up column- and w_down row-parallel, the float32 partials
    summed over tp."""
    if rt.tp_splits(cfg.d_ff):
        return rt.reduce_tp(mlp(params, rt.replicate_tp(y), cfg.mlp_kind,
                                partial=True)).to(y.dtype)
    return mlp(params, y, cfg.mlp_kind)


class RecurrentBlock(nn.Module):
    """One recurrent layer: ``rglru`` (the ``rec`` block, then ``ln2``
    and the dense ``mlp``) or an xLSTM cell, ``mlstm`` or ``slstm``
    (``cell``, which carries its own projections)."""

    def __init__(self, kind: str, weights: dict) -> None:
        super().__init__()
        self.kind = kind
        if kind == "rglru":
            self.rec = _params(weights["rec"])
            self.ln2 = _param(weights["ln2"])
            self.mlp = _params(weights["mlp"])
        else:
            self.cell = _params(weights["cell"])

    def forward(self, x: torch.Tensor, cfg: ArchConfig, state: dict,
                decode: bool, rt: Runtime = LOCAL
                ) -> tuple[torch.Tensor, dict]:
        """x (B, S, d) from ``state`` (B rows) → (x, the new state)."""
        if self.kind == "rglru":
            step = (rglru_lib.rglru_decode_step if decode
                    else rglru_lib.rglru_block)
            x, state = step(self.rec, x, state, rt)
            return x + dense_mlp(self.mlp, rmsnorm(self.ln2, x), cfg, rt), \
                state
        block = (ssm_lib.mlstm_block if self.kind == "mlstm"
                 else ssm_lib.slstm_block)
        return block(self.cell, x, state, rt)

    def fresh_state(self, batch: int, cfg: ArchConfig, device,
                    rt: Runtime = LOCAL) -> dict[str, torch.Tensor]:
        """A new sequence's state: under ``rt``, for its block of the
        RG-LRU channels."""
        if self.kind == "rglru":
            dr = cfg.rnn_width or cfg.d_model
            return rglru_lib.rglru_state(
                batch, cfg, device,
                width=dr // rt.tp_size if rt.tp_splits(dr) else dr)
        return _STATE[self.kind](batch, cfg, device)


class Transformer(nn.Module):
    """Embedding (tied unembedding), the VLM's ``vision_proj`` where the
    config has vision tokens, the layers in depth order, and the final
    norm.  ``weights`` is ``{"embed", "final_norm", "layers": [per layer
    dict]}`` (and ``"vision_proj"``) as :func:`init_params` /
    :func:`params_from_jax` build it.  ``slots[i]`` is layer i's index
    among the cache's attention layers or among its recurrent ones."""

    def __init__(self, cfg: ArchConfig, weights: dict) -> None:
        super().__init__()
        self.cfg = cfg
        self.embed = _param(weights["embed"])
        self.final_norm = _param(weights["final_norm"])
        if "vision_proj" in weights:
            self.vision_proj = _param(weights["vision_proj"])
        kinds = layer_kinds(cfg)
        self.layers = nn.ModuleList(
            (Block if kind in ATTN_KINDS else RecurrentBlock)(kind, w)
            for kind, w in zip(kinds, weights["layers"]))
        self.slots = []
        count = {True: 0, False: 0}             # attention layer or not
        for kind in kinds:
            self.slots.append(count[kind in ATTN_KINDS])
            count[kind in ATTN_KINDS] += 1

    @property
    def device(self) -> torch.device:
        return self.embed.device


# ============================ params ============================================
def init_layer(gen: torch.Generator, cfg: ArchConfig, kind: str, dtype,
               device) -> dict:
    d = cfg.d_model
    if kind == "rglru":
        return {"rec": rglru_lib.init_rglru_block(gen, cfg, dtype, device),
                "ln2": torch.zeros(d, device=device),
                "mlp": init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dtype,
                                device)}
    if kind == "mlstm":
        return {"cell": ssm_lib.init_mlstm_block(gen, cfg, dtype, device)}
    if kind == "slstm":
        return {"cell": ssm_lib.init_slstm_block(gen, cfg, dtype, device)}
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
    return layer


def init_params(gen: torch.Generator, cfg: ArchConfig,
                device) -> Transformer:
    """Random init from ``gen`` (a generator on ``device``), with the
    reference's initialisers (RG-LRU's Λ from U(0.9, 0.999), the xLSTM
    forget biases at 3, the recurrent gates' weights in float32)."""
    dtype = dtype_of(cfg.dtype)
    d = cfg.d_model
    weights = {
        "embed": embed_init(gen, (cfg.padded_vocab, d), dtype, device),
        "final_norm": torch.zeros(d, device=device),
        "layers": [init_layer(gen, cfg, kind, dtype, device)
                   for kind in layer_kinds(cfg)]}
    if cfg.num_vision_tokens:
        weights["vision_proj"] = dense_init(gen, (d, d), dtype, device)
    return Transformer(cfg, weights)


def tensors_from_numpy(tree, device, idx: Optional[int] = None):
    """A reference param pytree (numpy leaves) → the same tree of
    tensors on ``device``; ``idx`` takes entry ``idx`` of every leaf's
    leading (stacked) axis; rmsnorm ``{"scale": s}`` dicts become the
    tensor ``s``.  Every leaf is copied, never shared with the caller's
    buffers; numpy has no bfloat16, so ml_dtypes arrays go through
    float32."""
    if isinstance(tree, dict):
        if set(tree) == {"scale"}:
            return tensors_from_numpy(tree["scale"], device, idx)
        return {k: tensors_from_numpy(v, device, idx)
                for k, v in tree.items()}
    arr = np.asarray(tree)
    if idx is not None:
        arr = arr[idx]
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)


def params_from_jax(cfg: ArchConfig, np_params: dict,
                    device) -> Transformer:
    """The reference's param pytree (leaves as numpy arrays) → the
    port's :class:`Transformer`.  Stacked ``periods["k{j}"]`` leaves
    unstack along their leading axis into layers ``p·|pattern| + j``;
    ``tail{j}`` follows.  ``moe``, ``rec`` and ``cell`` subtrees and
    ``vision_proj`` come across as they are, in their own dtypes."""
    check_supported(cfg)
    layers = []
    for p in range(cfg.n_periods):
        for j in range(len(cfg.pattern)):
            layers.append(tensors_from_numpy(np_params["periods"][f"k{j}"],
                                             device, p))
    for j in range(len(cfg.tail_kinds)):
        layers.append(tensors_from_numpy(np_params[f"tail{j}"], device))
    weights = {"embed": tensors_from_numpy(np_params["embed"]["table"],
                                           device),
               "final_norm": tensors_from_numpy(np_params["final_norm"],
                                                device),
               "layers": layers}
    if "vision_proj" in np_params:
        weights["vision_proj"] = tensors_from_numpy(np_params["vision_proj"],
                                                    device)
    return Transformer(cfg, weights)


#: names of the rmsnorm scales, which the reference keeps as
#: ``{"scale": s}`` (``tensors_from_numpy`` drops that level)
NORMS = frozenset({"ln", "ln1", "ln2", "ln_x", "out_ln", "post_ln1",
                   "post_ln2", "final_norm", "enc_norm"})


def _as_reference(name: str, t: torch.Tensor):
    return {"scale": t} if name in NORMS else t


def layer_of(sub, p: Optional[int]):
    """Layer ``p``'s weights dict from a param tree's layer subtree (its
    groups' member p; ``None``: a tail layer's own tensors), the
    rmsnorm ``{"scale": s}`` dicts unwrapped."""
    if isinstance(sub, dict):
        if set(sub) == {"scale"}:
            return layer_of(sub["scale"], p)
        return {k: layer_of(v, p) for k, v in sub.items()}
    return sub[p] if isinstance(sub, list) else sub


def module_from_tree(cfg: ArchConfig, tree: dict) -> Transformer:
    """The inverse of :func:`param_tree`: a :class:`Transformer` whose
    parameters are the tree's tensors (shared, not copied)."""
    P = len(cfg.pattern)
    layers = [layer_of(tree["periods"][f"k{j}"], p)
              for p in range(cfg.n_periods) for j in range(P)]
    layers += [layer_of(tree[f"tail{j}"], None)
               for j in range(len(cfg.tail_kinds))]
    weights = {"embed": tree["embed"]["table"],
               "final_norm": tree["final_norm"]["scale"], "layers": layers}
    if "vision_proj" in tree:
        weights["vision_proj"] = tree["vision_proj"]
    return Transformer(cfg, weights)


def layer_tree(layer: nn.Module) -> dict:
    """One layer's parameters as the reference's layer dict (the same
    tensors, not copies)."""
    tree = {name: _as_reference(name, p)
            for name, p in layer.named_parameters(recurse=False)}
    for name, child in layer.named_children():
        tree[name] = {k: _as_reference(k, p) for k, p in child.items()}
    return tree


def stack_layers(trees: list) -> dict:
    """Congruent layer dicts → one dict whose leaves are the groups of
    their tensors (the reference's stacked leaves, unstacked)."""
    if isinstance(trees[0], dict):
        return {k: stack_layers([t[k] for t in trees]) for k in trees[0]}
    return list(trees)


def param_tree(model: Transformer) -> dict:
    """The model's parameters as the reference's param pytree:
    ``embed/table``, ``final_norm/scale``, ``vision_proj``,
    ``periods/k{j}/...`` (each leaf the group of the n_periods layers at
    pattern position j) and ``tail{j}/...``.  A view: the leaves are
    the model's own parameters."""
    cfg = model.cfg
    P = len(cfg.pattern)
    layers = list(model.layers)
    tree = {"embed": {"table": model.embed},
            "final_norm": {"scale": model.final_norm},
            "periods": {f"k{j}": stack_layers([
                layer_tree(layers[p * P + j]) for p in range(cfg.n_periods)])
                for j in range(P)}}
    if hasattr(model, "vision_proj"):
        tree["vision_proj"] = model.vision_proj
    for j in range(len(cfg.tail_kinds)):
        tree[f"tail{j}"] = layer_tree(layers[cfg.n_periods * P + j])
    return tree


# ============================ cache ============================================
@dataclasses.dataclass
class PagedKVCache:
    """K and V page pools of each attention layer, (P, T, H_kv, dh), and
    the state of each recurrent layer, ``{name: (lanes, ...)}`` in
    float32; ``fresh`` holds one row of each state as a new sequence
    starts it (zeros, and the xLSTM stabiliser m at −1e30)."""

    k: list[torch.Tensor]
    v: list[torch.Tensor]
    state: list[dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    fresh: list[dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=list)
    #: how this rank's pages hold a sharded cache (None: unsharded)
    layout: Optional[object] = None

    def reset(self, lane: int) -> None:
        """Row ``lane`` of every recurrent state back to its start."""
        for state, fresh in zip(self.state, self.fresh):
            for name, t in state.items():
                t[lane] = fresh[name][0]


def init_cache(cfg: ArchConfig, total_pages: int, page_tokens: int,
               rt: Runtime = LOCAL, device="cuda",
               lanes: int = 1, layout=None) -> PagedKVCache:
    """Page pools for the attention layers and ``lanes`` rows of state
    for the recurrent ones; under a sharded ``layout`` (a
    ``distributed.sharding.KVLayout``), this rank's pools, which hold
    its H_kv/tp heads when the layout splits heads, and its block of the
    RG-LRU channels when the layout splits them."""
    kinds = layer_kinds(cfg)
    heads, tp = cfg.num_kv_heads, 1
    if layout is not None:
        heads //= rt.tp_size if layout.heads else 1
        tp = rt.tp_size if layout.state_tp else 1
    shape = (total_pages, page_tokens, heads, cfg.head_dim)
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    dt = rt.cache_dtype()
    recurrent = [k for k in kinds if k not in ATTN_KINDS]
    width = (cfg.rnn_width or cfg.d_model) // tp

    def state(kind, rows):
        if kind == "rglru":
            return rglru_lib.rglru_state(rows, cfg, device, width=width)
        return _STATE[kind](rows, cfg, device)

    return PagedKVCache(
        k=[torch.zeros(shape, dtype=dt, device=device)
           for _ in range(n_attn)],
        v=[torch.zeros(shape, dtype=dt, device=device)
           for _ in range(n_attn)],
        state=[state(k, lanes) for k in recurrent],
        fresh=[state(k, 1) for k in recurrent],
        layout=layout)


# ============================ trunk ============================================
def _check_layout(cache: PagedKVCache, rt: Runtime) -> None:
    if rt.sharded and cache.layout is None:
        raise ValueError("a mesh-ful runtime serves from a cache made with "
                         "a KVLayout (init_cache(..., layout=))")


def _vocab_block(model: Transformer, rt: Runtime) -> Optional[int]:
    """The first token id of this rank's block of a vocab-sharded table
    (None: the table is whole)."""
    n = model.embed.shape[0]
    return rt.tp_index * n if n < model.cfg.padded_vocab else None


def embed_inputs(model: Transformer, tokens: torch.Tensor,
                 extra_embed: Optional[torch.Tensor] = None,
                 rt: Runtime = LOCAL) -> torch.Tensor:
    """Token embeddings, with ``extra_embed`` (B, N, d) patch embeddings
    projected by ``vision_proj`` in front when given.  A vocab-sharded
    table looks up the ids of its block (zeros elsewhere) and the ranks'
    rows are summed over tp."""
    lo = _vocab_block(model, rt)
    if lo is None:
        x = embed(model.embed, tokens,
                  scale_by_sqrt_dim=model.cfg.embed_scale)
    else:
        n = model.embed.shape[0]
        ids = tokens - lo
        hit = ((ids >= 0) & (ids < n))[..., None]
        x = embed(model.embed, ids.clamp(0, n - 1),
                  scale_by_sqrt_dim=model.cfg.embed_scale)
        x = rt.reduce_tp(torch.where(hit, x, torch.zeros_like(x)))
    if extra_embed is not None:
        v = extra_embed.to(x.dtype) @ model.vision_proj
        x = torch.cat([v, x], dim=1)
    return x


def _rows(lanes: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The state rows of x's B sequences: ``lanes``, or 0..B-1."""
    if lanes is None:
        return torch.arange(x.shape[0], device=x.device)
    return lanes.to(device=x.device, dtype=torch.long)


def _recurrent(layer: RecurrentBlock, x: torch.Tensor, cfg: ArchConfig,
               state: dict, rows: torch.Tensor, decode: bool,
               rt: Runtime = LOCAL) -> torch.Tensor:
    """Run a recurrent layer on the sequences of ``rows`` and write their
    new state back into those rows."""
    x, new = layer(x, cfg, {k: t[rows] for k, t in state.items()}, decode,
                   rt)
    for k, t in state.items():
        t[rows] = new[k]
    return x


def _logits(model: Transformer, x: torch.Tensor,
            rt: Runtime = LOCAL) -> torch.Tensor:
    """Logits against the tied table: under a vocab-sharded table, this
    rank's block of the vocabulary (the reference constrains its logits
    to ``(dp, None, tp)``), padded ids masked by their global id."""
    cfg = model.cfg
    x = rmsnorm(model.final_norm, x)
    lo = _vocab_block(model, rt)
    if lo is None:
        return unembed(model.embed, x, cfg.vocab_size,
                       cap=cfg.final_logit_softcap)
    n = model.embed.shape[0]
    return unembed(model.embed, rt.replicate_tp(x),
                   min(max(cfg.vocab_size - lo, 0), n),
                   cap=cfg.final_logit_softcap)


# repro: allow[oracle-parity] -- model-parallel decode; held to one device in tests/test_torch_model_shard.py
def greedy(model: Transformer, logits: torch.Tensor,
           rt: Runtime = LOCAL) -> torch.Tensor:
    """The greedy token (int64, logits' shape without the vocab dim): the
    first of equal maxima, as ``argmax``; over vocab-sharded logits each
    rank's (max, id) pair is gathered over tp and the first rank with
    the largest max wins."""
    val, idx = logits.float().max(dim=-1)
    lo = _vocab_block(model, rt)
    if lo is None:
        return idx
    # deferred: distributed/__init__ → sharding → models (this package)
    from repro_torch.distributed.collectives import all_gather
    vals = all_gather(val[None], rt.mesh, rt.tp_axis, 0)
    ids = all_gather((idx + lo)[None], rt.mesh, rt.tp_axis, 0)
    return ids.gather(0, vals.argmax(dim=0, keepdim=True))[0]


def _train_layer(layer: nn.Module, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, rt: Runtime) -> torch.Tensor:
    if layer.kind in ATTN_KINDS:
        return layer(x, cfg, lambda p, y: attn.attention_block(
            p, y, cfg, layer.kind, positions, rt), rt)
    return layer(x, cfg, layer.fresh_state(x.shape[0], cfg, x.device, rt),
                 False, rt)[0]


def _train_layers(layers, x: torch.Tensor, cfg: ArchConfig,
                  positions: torch.Tensor, rt: Runtime) -> torch.Tensor:
    for layer in layers:
        x = _train_layer(layer, x, cfg, positions, rt)
    return x


def forward_train(model: Transformer, tokens: torch.Tensor,
                  extra_embed: Optional[torch.Tensor] = None,
                  remat: str = "none", rt: Runtime = LOCAL) -> torch.Tensor:
    """(B,S) tokens → (B,S',V_padded) logits at every position (S'
    counts a VLM prefix of ``extra_embed`` (B, N, d) patch embeddings),
    as the reference's ``forward_train``: dense attention (never the
    kernels), each recurrent layer from a fresh state, no cache.  With
    ``remat="full"`` each period of layers runs under
    ``torch.utils.checkpoint`` (the reference wraps its period body in
    ``jax.checkpoint``), so backward recomputes it; the tail layers run
    as they are, as in the reference."""
    check_remat(remat)
    cfg = model.cfg
    x = embed_inputs(model, tokens, extra_embed, rt)
    positions = torch.arange(x.shape[1], device=x.device)
    P = len(cfg.pattern)
    layers = list(model.layers)
    for p in range(cfg.n_periods):
        period = layers[p * P:(p + 1) * P]
        if remat == "full":
            x = torch.utils.checkpoint.checkpoint(
                _train_layers, period, x, cfg, positions, rt,
                use_reentrant=False)
        else:
            x = _train_layers(period, x, cfg, positions, rt)
    x = _train_layers(layers[cfg.n_periods * P:], x, cfg, positions, rt)
    return _logits(model, x, rt)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor, cache: PagedKVCache,
            block_tables: torch.Tensor, lanes: Optional[torch.Tensor] = None,
            extra_embed: Optional[torch.Tensor] = None,
            rt: Runtime = LOCAL) -> torch.Tensor:
    """(B,S) prompt tokens → (B,1,V_padded) last-position logits.

    Every attention layer's K/V for positions 0..S-1 is written into the
    pages that ``block_tables`` (B, max_pages) names.  Each recurrent
    layer runs from the state in rows ``lanes`` (B,) (default 0..B-1;
    the engine resets a row before a new prompt, as the reference starts
    from a fresh cache) and leaves its final state there.  With
    ``extra_embed`` (B, N, d) the sequence is the N projected patch
    embeddings and then the S tokens, at positions 0..N+S-1, and its
    pages must hold N+S tokens; decode continues at N+S.  Under a mesh
    the logits are this rank's block of the vocabulary."""
    cfg = model.cfg
    _check_layout(cache, rt)
    x = embed_inputs(model, tokens, extra_embed, rt)
    rows = _rows(lanes, x)
    for layer, j in zip(model.layers, model.slots):
        if layer.kind in ATTN_KINDS:
            x = layer(x, cfg, lambda p, y, j=j, kind=layer.kind:
                      attn.prefill_attention(p, y, cfg, kind, cache.k[j],
                                             cache.v[j], block_tables, rt,
                                             cache.layout), rt)
        else:
            x = _recurrent(layer, x, cfg, cache.state[j], rows, False, rt)
    return _logits(model, x[:, -1:, :], rt)


@torch.no_grad()
def decode_step(model: Transformer, tokens: torch.Tensor,
                cache: PagedKVCache, block_tables: torch.Tensor,
                positions: torch.Tensor,
                lanes: Optional[torch.Tensor] = None,
                rt: Runtime = LOCAL) -> torch.Tensor:
    """tokens (B,1), sequence b's token at ``positions[b]`` with its
    recurrent state in row ``lanes[b]`` (default b) → (B,1,V) logits;
    one KV slot per sequence and attention layer written, each
    recurrent state advanced one step."""
    cfg = model.cfg
    _check_layout(cache, rt)
    x = embed_inputs(model, tokens, rt=rt)
    rows = _rows(lanes, x)
    for layer, j in zip(model.layers, model.slots):
        if layer.kind in ATTN_KINDS:
            x = layer(x, cfg, lambda p, y, j=j, kind=layer.kind:
                      attn.decode_attention(p, y, cfg, kind, cache.k[j],
                                            cache.v[j], block_tables,
                                            positions, rt, cache.layout),
                      rt)
        else:
            x = _recurrent(layer, x, cfg, cache.state[j], rows, True, rt)
    return _logits(model, x, rt)
