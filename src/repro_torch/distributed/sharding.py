"""Sharding rules: param-tree path → spec, per architecture family.

Counterpart of ``repro/distributed/sharding.py``, rule for rule.  A
*spec* is a tuple with one entry per dim: an axis name, a tuple of axis
names, or ``None`` (the reference's ``PartitionSpec``).

Axis roles:
  dp  = data axes ("pod","data") — batch / FSDP / EP
  tp  = "model"                  — tensor parallel

Train mode adds FSDP: the non-TP weight dim is sharded over dp
(optimizer state inherits → ZeRO).  Serve mode replicates weights over
dp and shards only over tp.

GQA head counts smaller than the TP degree make head-sharded KV
impossible; those archs get **sequence-sharded KV**: rank r of the
sequence axes holds positions [r·S/n, (r+1)·S/n) and decode merges the
ranks' partial softmaxes (flash-decoding).  GSPMD derives that schedule
from the reference's einsums; the port writes it out
(``models.attention``).

All rules are *name-based* on the param tree's paths, so they apply
uniformly to stacked (grouped) and tail layers.  :func:`param_pspecs`
walks the port's ``param_tree`` view, whose stacked leaves are lists of
per-layer tensors: their specs carry the leading ``None`` of the
reference's scan dim.  :func:`cache_pspecs` takes a tree of the
reference's dense-cache leaf shapes (:func:`dense_cache_shapes`), so
its specs compare with the reference's one for one; the port maps the
attention layers' spec onto its paged cache (:class:`KVLayout`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.launch.mesh import ModelMesh, axes_of
from repro_torch.models.config import ArchConfig
from repro_torch.models.runtime import Runtime
from repro_torch.tree import is_group, leaves_with_paths, map_leaves, \
    tensors

Spec = tuple


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    mesh: ModelMesh
    dp_axes: tuple[str, ...]
    tp_axis: str
    mode: str                       # "train" | "serve"
    cfg: ArchConfig

    @property
    def dp(self):
        return self.dp_axes if len(self.dp_axes) > 1 else self.dp_axes[0]

    @property
    def tp_size(self) -> int:
        return self.mesh.axis_size(self.tp_axis)

    @property
    def dp_size(self) -> int:
        return self.mesh.axis_size(tuple(self.dp_axes))

    def runtime(self, **kw) -> Runtime:
        return Runtime(mesh=self.mesh, dp_axes=self.dp_axes,
                       tp_axis=self.tp_axis, **kw)

    # -- helpers -------------------------------------------------------------
    def _div(self, n: int, axis) -> bool:
        return n % self.mesh.axis_size(axis) == 0

    def head_sharded_kv(self) -> bool:
        return self._div(self.cfg.num_kv_heads, self.tp_axis)


def make_plan(cfg: ArchConfig, mesh: ModelMesh, mode: str) -> ShardingPlan:
    axes = list(mesh.axis_names)
    tp = "model" if "model" in axes else axes[-1]
    dp = tuple(a for a in axes if a != tp)
    return ShardingPlan(mesh=mesh, dp_axes=dp, tp_axis=tp, mode=mode,
                        cfg=cfg)


# ============================ parameter specs ================================
def _param_rule(plan: ShardingPlan, name: str, parent: str,
                shape: tuple[int, ...]) -> Spec:
    cfg = plan.cfg
    tp = plan.tp_axis
    dp = plan.dp
    train = plan.mode == "train"

    def fsdp(dim_size: int):
        """dp entry for a train-mode FSDP dim (None when not divisible
        or serving)."""
        return dp if train and dim_size % plan.dp_size == 0 else None

    # ---- embeddings / head ------------------------------------------------
    if name == "table":                      # (V, d)
        return (tp if self_div(plan, shape[0], tp) else None,
                fsdp(shape[1]))
    if name == "vision_proj":                # (d, d)
        return (None, tp if self_div(plan, shape[1], tp) else None)

    # ---- MoE (parent == "moe") ---------------------------------------------
    if parent == "moe":
        ep = dp                              # experts over the data axes
        if name == "router":                 # (d, E)
            return (None, None)
        if name in ("w_gate", "w_up"):       # (E, d, f)
            return (ep, None, tp if self_div(plan, shape[2], tp) else None)
        if name == "w_down":                 # (E, f, d)
            return (ep, tp if self_div(plan, shape[1], tp) else None, None)

    # ---- attention ----------------------------------------------------------
    if parent in ("attn", "self_attn", "cross_attn"):
        if name in ("wq", "wk", "wv"):       # (d, H or H_kv, dh)
            if self_div(plan, shape[1], tp):
                return (fsdp(shape[0]), tp, None)
            return (tp if self_div(plan, shape[0], tp) else None, None, None)
        if name == "wo":                     # (H, dh, d)
            if self_div(plan, shape[0], tp):
                return (tp, None, fsdp(shape[2]))
            return (None, None, tp if self_div(plan, shape[2], tp) else None)

    # ---- dense MLP ----------------------------------------------------------
    if parent == "mlp":
        if name in ("w_gate", "w_up"):       # (d, f)
            return (fsdp(shape[0]),
                    tp if self_div(plan, shape[1], tp) else None)
        if name == "w_down":                 # (f, d)
            return (tp if self_div(plan, shape[0], tp) else None,
                    fsdp(shape[1]))

    # ---- RG-LRU -------------------------------------------------------------
    if parent == "rec":
        def dr_tp(n):
            return tp if self_div(plan, n, tp) else None
        if name in ("w_a", "w_b"):           # (d, dr)
            return (fsdp(shape[0]), dr_tp(shape[1]))
        if name in ("w_r", "w_i"):           # (dr, dr)
            return (None, dr_tp(shape[1]))
        if name == "conv_w":                 # (W, dr)
            return (None, dr_tp(shape[1]))
        if name in ("lambda", "conv_b", "b_r", "b_i"):   # (dr,)
            return (dr_tp(shape[0]),)
        if name == "w_down":                 # (dr, d)
            return (dr_tp(shape[0]), fsdp(shape[1]))

    # ---- xLSTM cells --------------------------------------------------------
    if parent == "cell":
        def inner_tp(n):
            return tp if self_div(plan, n, tp) else None
        if name in ("w_up", "w_gate_branch", "w_ff_up"):   # (d, inner)
            return (fsdp(shape[0]), inner_tp(shape[1]))
        if name in ("wq", "wk", "wv"):       # (inner, H, dh)
            return (inner_tp(shape[0]), None, None)
        if name in ("w_i", "w_f") and len(shape) == 2:     # (inner, H)
            return (inner_tp(shape[0]), None)
        if name in ("w_z", "w_o"):           # (d, H, dh)
            return (inner_tp(shape[0]), None, None)
        if name in ("w_down", "w_ff_down"):  # (inner, d)
            return (inner_tp(shape[0]), fsdp(shape[1]))
        # recurrent mats / biases / norms: replicate
        return (None,) * len(shape)

    # default: replicate (norms, biases, small tensors)
    return (None,) * len(shape)


def self_div(plan: ShardingPlan, n: int, axis) -> bool:
    return n % plan.mesh.axis_size(axis) == 0


_STACKED = ("periods", "enc_layers", "dec_layers")


def param_pspecs(plan: ShardingPlan, params: Any) -> Any:
    """Map the param tree (``models.param_tree``: tensors, and groups for
    stacked leaves) to specs.  A group's spec has the leading ``None``
    of the reference's scan dim; its rule sees one layer's shape."""

    def leaf_spec(path, leaf) -> Spec:
        name = path[-1]
        parent = path[-2] if len(path) >= 2 else ""
        if any(k in _STACKED for k in path):
            shape = tuple(leaf[0].shape if is_group(leaf) else leaf.shape[1:])
            return (None,) + _param_rule(plan, name, parent, shape)
        return _param_rule(plan, name, parent, tuple(leaf.shape))

    return map_leaves(leaf_spec, params, with_path=True)


# ============================ cache specs ====================================
def cache_pspecs(plan: ShardingPlan, cache: Any) -> Any:
    """KV caches: batch over dp; heads over tp when divisible, else the
    *sequence* axis over tp (flash-decoding layout).  When the batch
    itself cannot shard (long_500k's global_batch=1), the sequence axis
    takes the dp axes too — context-parallel decode across the whole
    mesh.  Recurrent states: batch over dp when divisible, channel dims
    over tp.  ``cache`` is a tree of shape tuples (or tensors)."""
    tp = plan.tp_axis
    head_kv = plan.head_sharded_kv()

    def dp_for(n: int):
        return plan.dp if n % plan.dp_size == 0 else None

    def tp_for(n: int):
        return tp if n % plan.tp_size == 0 else None

    def leaf_spec(path, leaf) -> Spec:
        name = path[-1]
        shape = tuple(leaf) if isinstance(leaf, tuple) else tuple(leaf.shape)
        stacked = any(k in ("periods", "dec", "xkv") for k in path)
        core = shape[1:] if stacked else shape

        if name in ("k", "v") and len(core) == 4:   # (B,S,H_kv,dh)
            B, S = core[0], core[1]
            bdp = dp_for(B)
            if bdp is not None:
                if head_kv:
                    spec = (bdp, None, tp, None)
                elif S % plan.tp_size == 0:
                    spec = (bdp, tp, None, None)    # seq over tp
                else:
                    spec = (bdp, None, None, None)
            else:
                # batch unshardable → context parallelism on S
                all_axes = tuple(plan.dp_axes) + (tp,)
                total = plan.dp_size * plan.tp_size
                if not head_kv and S % total == 0:
                    spec = (None, all_axes, None, None)
                elif S % plan.dp_size == 0:
                    spec = (None, plan.dp, tp if head_kv else None, None)
                else:
                    spec = (None, None, tp_for(core[2]), None)
        elif name == "C":                            # (B,H,dh,dh)
            spec = (dp_for(core[0]), None, None, None)
        elif name == "conv":                         # (B,W-1,dr)
            spec = (dp_for(core[0]), None, tp_for(core[2]))
        elif name == "h" and len(core) == 2:         # rglru (B,dr)
            spec = (dp_for(core[0]), tp_for(core[1]))
        elif len(core) >= 1:
            spec = (dp_for(core[0]),) + (None,) * (len(core) - 1)
        else:
            spec = ()
        if stacked:
            return (None,) + spec
        return spec

    return map_leaves(leaf_spec, cache, with_path=True)


def dense_cache_shapes(cfg: ArchConfig, batch: int, max_seq: int) -> dict:
    """The leaf shapes of the reference's dense ``init_cache(cfg, batch,
    max_seq)``: per attention layer (B, S_kind, H_kv, dh) K and V, S_kind
    the window for a ``local`` layer; the recurrent states; stacked over
    periods (the encoder-decoder: over its decoder layers, with the
    cross K/V)."""
    kv = (cfg.num_kv_heads, cfg.head_dim)
    if cfg.is_encoder_decoder:
        L = cfg.num_layers
        full = (L, batch, max_seq) + kv
        return {"dec": {"k": full, "v": full}, "xkv": {"k": full, "v": full}}

    def layer(kind: str) -> dict:
        if kind in ("global", "local"):
            S = min(cfg.window_size, max_seq) if kind == "local" else max_seq
            return {"k": (batch, S) + kv, "v": (batch, S) + kv}
        if kind == "rglru":
            dr = cfg.rnn_width or cfg.d_model
            return {"h": (batch, dr), "conv": (batch, cfg.conv_width - 1, dr)}
        H = cfg.num_heads
        if kind == "mlstm":
            dh = int(cfg.mlstm_proj_factor * cfg.d_model) // H
            return {"C": (batch, H, dh, dh), "n": (batch, H, dh),
                    "m": (batch, H)}
        dh = cfg.d_model // H                        # slstm
        return {k: (batch, H, dh) for k in ("c", "n", "h", "m")}

    n = cfg.n_periods
    cache: dict = {"periods": {
        f"k{i}": {k: (n,) + s for k, s in layer(kind).items()}
        for i, kind in enumerate(cfg.pattern)}}
    for j, kind in enumerate(cfg.tail_kinds):
        cache[f"tail{j}"] = layer(kind)
    return cache


# ============================ shards =========================================
def shard_shape(mesh: ModelMesh, spec: Spec, shape) -> tuple[int, ...]:
    """One rank's block of a ``shape`` leaf under ``spec`` (the
    reference's ``NamedSharding.shard_shape``)."""
    return tuple(n // mesh.axis_size(e) for n, e in zip(shape, spec))


def block(mesh: ModelMesh, spec: Spec, t: torch.Tensor) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a
    view)."""
    for dim, e in enumerate(spec):
        n = mesh.axis_size(e)
        if n > 1:
            b = t.shape[dim] // n
            t = t.narrow(dim, mesh.axis_index(e) * b, b)
    return t


def spec_bytes(mesh: ModelMesh, specs: Any, shapes: Any,
               itemsize: Any) -> int:
    """Bytes a device holds of a tree of leaves: the sum of
    :func:`shard_shape` sizes times each leaf's item size."""
    total = 0
    for (_, spec), (_, shape), (_, size) in zip(
            leaves_with_paths(specs), leaves_with_paths(shapes),
            leaves_with_paths(itemsize)):
        total += math.prod(shard_shape(mesh, spec, shape)) * size
    return total


# ============================ the port's paged KV layout =====================
@dataclasses.dataclass(frozen=True)
class KVLayout:
    """How one rank's paged cache holds the attention layers' K/V, from
    the spec :func:`cache_pspecs` gives the reference's dense (B, S,
    H_kv, dh) cache: ``batch`` the axes over which sequences split,
    ``seq`` those over which positions split (rank i of them holds
    positions [i·S/n, (i+1)·S/n) of each of its sequences), ``heads``
    whether K/V heads split over tp.  ``seq_len`` is the global S.

    The per-sequence state splits its rows over ``batch`` too.
    ``state_tp``: the RG-LRU state's channels (h (B, dr), conv (B, W−1,
    dr)) split over tp, as ``cache_pspecs`` puts them; the xLSTM states
    are whole on every tp rank.  The encoder-decoder's cross K/V splits
    its heads over tp with ``heads``, and is otherwise whole on every tp
    rank (where the reference's spec splits its positions: the flash
    kernel returns no log-sum-exp to merge such blocks with)."""

    batch: tuple[str, ...]
    seq: tuple[str, ...]
    heads: bool
    seq_len: int
    state_tp: bool = False

    @classmethod
    def from_spec(cls, spec: Spec, seq_len: int,
                  state_tp: bool = False) -> "KVLayout":
        return cls(batch=axes_of(spec[0]), seq=axes_of(spec[1]),
                   heads=spec[2] is not None, seq_len=seq_len,
                   state_tp=state_tp)

    def block_len(self, mesh: ModelMesh) -> int:
        """Positions a rank holds of each sequence."""
        return self.seq_len // mesh.axis_size(self.seq)

    def offset(self, mesh: ModelMesh) -> int:
        """Global position of this rank's first cached token."""
        return mesh.axis_index(self.seq) * self.block_len(mesh)


def kv_layout(plan: ShardingPlan, batch: int, max_seq: int) -> KVLayout:
    """The layout of a (batch, max_seq) cache under ``plan``: the spec of
    a global attention layer's K (local layers share its pages) and of
    an RG-LRU state's h."""
    cfg = plan.cfg
    shape = (batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    specs = cache_pspecs(plan, {"k": shape,
                                "h": (batch, cfg.rnn_width or cfg.d_model)})
    return KVLayout.from_spec(specs["k"], max_seq,
                              state_tp="rglru" in cfg.pattern
                              and specs["h"][1] is not None)


# ============================ a rank's weights ===============================
def compute_spec(plan: ShardingPlan, path: tuple, spec: Spec) -> Spec:
    """The block of a leaf this rank computes with, from its stored spec:
    the dp entries dropped (FSDP dims are gathered before use) except on
    the experts (expert parallelism keeps them), and the tp entries the
    model code does not split — ``vision_proj``'s columns, ``wo``'s
    output dim and the sLSTM FFN's ``w_ff_up`` columns (its two halves
    would straddle the ranks' blocks; all gathered)."""
    name = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    dp = set(plan.dp_axes)
    out = []
    for dim, e in enumerate(spec):
        axes = set(axes_of(e))
        if axes & dp and parent != "moe":
            e = None
        elif axes and (name in ("vision_proj", "w_ff_up")
                       or (name == "wo" and dim == len(spec) - 1)):
            e = None
        out.append(e)
    return tuple(out)


def compute_specs(plan: ShardingPlan, params: Any) -> Any:
    """:func:`compute_spec` of every leaf of a param tree."""
    return map_leaves(lambda path, s: compute_spec(plan, path, s),
                      param_pspecs(plan, params), with_path=True)


def shard_module(model, plan: ShardingPlan):
    """This rank's module: each parameter of the whole ``model`` cut to
    its :func:`compute_spec` block (copies; ``model`` is left as it
    is)."""
    from repro_torch.models.registry import module_from_tree, param_tree
    tree = param_tree(model)

    def one(leaf, spec):
        if is_group(leaf):
            return [block(plan.mesh, spec[1:], t).clone() for t in leaf]
        return block(plan.mesh, spec, leaf).clone()

    return module_from_tree(model.cfg, map_leaves(
        one, tree, compute_specs(plan, tree)))


# ============================ sharded training state =========================
@dataclasses.dataclass
class ShardedParams:
    """One rank's training state of a model under a train-mode plan:
    ``shards`` the stored blocks (:func:`param_pspecs`; a param tree,
    each group a list of per-layer blocks) that AdamW updates — the
    moments are made like them (ZeRO) —, and ``module`` the compute view
    (:func:`compute_spec`) that the step runs, its parameters rewritten
    from the shards before each forward (FSDP)."""

    plan: ShardingPlan
    shards: Any
    module: Any
    specs: Any
    cspecs: Any


def _pairs(leaf, spec):
    """(tensor, its spec) of each member of a leaf (a group's members
    without the scan dim)."""
    if is_group(leaf):
        return [(t, spec[1:]) for t in leaf]
    return [(leaf, spec)]


def shard_params(model, plan: ShardingPlan) -> ShardedParams:
    """The :class:`ShardedParams` of this rank from the whole ``model``
    (which is left as it is)."""
    from repro_torch.models.registry import param_tree
    tree = param_tree(model)
    specs = param_pspecs(plan, tree)

    def one(leaf, spec):
        out = [block(plan.mesh, s, t).clone() for t, s in _pairs(leaf, spec)]
        return out if is_group(leaf) else out[0]

    return ShardedParams(plan=plan, shards=map_leaves(one, tree, specs),
                         module=shard_module(model, plan), specs=specs,
                         cspecs=compute_specs(plan, tree))


def _gather_dims(mesh: ModelMesh, t: torch.Tensor, spec: Spec,
                 keep: Spec) -> torch.Tensor:
    """``t``, a block under ``spec``, gathered along each dim whose entry
    ``keep`` drops."""
    from repro_torch.distributed.collectives import all_gather
    for dim, (e, k) in enumerate(zip(spec, keep)):
        if e is not None and k is None:
            t = all_gather(t, mesh, e, dim)
    return t


@torch.no_grad()
def gather_params(sp: ShardedParams) -> None:
    """Rewrite the compute module's parameters from the shards."""
    from repro_torch.models.registry import param_tree
    mesh = sp.plan.mesh
    for (_, leaf), (_, dst), (_, spec), (_, keep) in zip(
            *(leaves_with_paths(x) for x in (
                sp.shards, param_tree(sp.module), sp.specs, sp.cspecs))):
        for (t, s), (d, k) in zip(_pairs(leaf, spec), _pairs(dst, keep)):
            d.copy_(_gather_dims(mesh, t, s, k))


def reduce_grads(sp: ShardedParams, grads: Any) -> Any:
    """Each rank's gradients of the compute view (its share of the loss)
    → the whole loss's gradients of its stored blocks: reduce-scattered
    over the data axes of a gathered (FSDP) dim, summed over the data
    axes the leaf is replicated on, and cut to the block along a tp dim
    that the compute view gathered (whose gradient every tp rank holds
    whole)."""
    from repro_torch.distributed.collectives import all_reduce, \
        reduce_scatter
    mesh, dp = sp.plan.mesh, set(sp.plan.dp_axes)

    def one(g, spec, keep):
        for dim, (e, k) in enumerate(zip(spec, keep)):
            if e is not None and k is None:
                if set(axes_of(e)) <= dp:
                    g = reduce_scatter(g, mesh, e, dim)
                else:
                    g = block(mesh, (None,) * dim + (e,), g)
        used = {a for e in spec for a in axes_of(e)}
        rest = tuple(a for a in sp.plan.dp_axes if a not in used)
        return all_reduce(g, mesh, rest) if rest else g

    def leaf(g, spec, keep):
        out = [one(t, s, k) for (t, s), (_, k) in zip(_pairs(g, spec),
                                                      _pairs(g, keep))]
        return out if is_group(g) else out[0]

    with torch.no_grad():
        return map_leaves(leaf, grads, sp.specs, sp.cspecs)


def grad_norm(sp: ShardedParams, grads: Any) -> torch.Tensor:
    """The global f32 norm of gradients held as the stored blocks: each
    element counted once (a block replicated over some axes only on the
    rank at coordinate 0 of them), summed over the mesh."""
    from repro_torch.distributed.collectives import all_reduce
    mesh = sp.plan.mesh
    sums = []
    for (_, g), (_, spec) in zip(leaves_with_paths(grads),
                                 leaves_with_paths(sp.specs)):
        used = {a for e in spec for a in axes_of(e)}
        if all(mesh.coords[a] == 0 for a in mesh.axis_names
               if a not in used):
            sums += [t.float().square().sum() for t, _ in _pairs(g, spec)]
    local = torch.stack(sums).sum() if sums else torch.zeros(
        (), device=next(iter(tensors(grads))).device)
    with torch.no_grad():
        return all_reduce(local, mesh, mesh.axis_names).sqrt()


def full_params(sp: ShardedParams, tree: Any = None) -> Any:
    """The whole leaves of a tree of stored blocks (default: the
    shards), gathered on every rank."""
    return map_leaves(lambda x, spec: gather_block(
        x, NamedSharding(sp.plan.mesh, spec)),
        sp.shards if tree is None else tree, sp.specs)


class NamedSharding(NamedTuple):
    """A leaf's placement: its ``spec`` over ``mesh`` (the reference's
    ``jax.sharding.NamedSharding``)."""

    mesh: ModelMesh
    spec: Spec


def gather_block(leaf: Any, sharding: NamedSharding) -> Any:
    """The whole leaf from this rank's block of it (a group: its
    members' blocks, the spec's first entry the scan dim), gathered over
    the mesh; every rank of the mesh must call it."""
    with torch.no_grad():
        out = [_gather_dims(sharding.mesh, t, s, (None,) * len(s))
               for t, s in _pairs(leaf, sharding.spec)]
    return out if is_group(leaf) else out[0]
