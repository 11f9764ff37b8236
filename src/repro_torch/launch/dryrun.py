"""Multi-pod dry-run: every (architecture × shape × mesh) cell built and
run as one rank of the production sharding — without hardware.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A]
        [--shape S] [--multi-pod | --both-meshes] [--out DIR]

Counterpart of ``repro/launch/dryrun.py``.  "Lower and compile" becomes:
build rank 0's shards from the plan (``distributed.sharding``) on the
``meta`` device — shapes and dtypes, no storage — and run its step
there.  Attention takes the kernels' plain versions (``meta`` tensors
are not CUDA tensors), the collectives run on the abstract mesh
(nothing communicated, every one tallied), and
``torch.utils.flop_counter.FlopCounterMode`` counts the flops.  An
artifact holds the reference's fields, measured so:

* ``flops`` — one device's step, every layer counted (the port has no
  scan, so the reference's scan-probe correction has no counterpart);
* ``argument_size_in_bytes`` — what one device holds as the step's
  arguments: params, optimizer state (train), the cache in the port's
  paged layout (serve), the batch; each part also on its own, and the
  cache's bytes in the reference's dense layout beside the paged ones
  (they differ where the reference keeps a ``local`` layer's window as
  a ring and the port keeps every page, and for the encoder-decoder
  where H_kv does not split over tp: the reference's spec splits the
  cross K/V's positions over tp, the port keeps it whole on every rank,
  ``cross_bytes`` of ``cache_bytes``);
* ``collectives`` — the tally's bytes and counts by kind: the result
  bytes of each collective on one device, the quantity the reference
  reads from the post-SPMD HLO (``collective_bytes_from_hlo``, an XLA
  artefact with no counterpart here).

Every family runs sharded, so every applicable cell reports ``status:
"ok"``.  ``--opt`` takes the reference's bundle names and refuses each:
they set XLA-only knobs (see ``models.runtime``).  The whole grid (10
archs × 4 shapes × 2 meshes) takes a few minutes on one CPU core.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.distributed.sharding import (
    cache_pspecs,
    dense_cache_shapes,
    gather_params,
    grad_norm,
    kv_layout,
    make_plan,
    param_pspecs,
    reduce_grads,
    shard_module,
    shard_params,
    shard_shape,
    spec_bytes,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model, param_tree
from repro_torch.models.config import SHAPES, ArchConfig, ShapeSpec
from repro_torch.training.loss import lm_loss_sharded
from repro_torch.training.optimizer import OptimizerConfig, adamw_init, \
    adamw_update
from repro_torch.tree import map_leaves, tensors, unflatten_tensors

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "build", "dryrun")

#: long_500k applicability: bounded-state archs only
LONG_OK = {"gemma2-9b", "gemma2-2b", "xlstm-350m", "recurrentgemma-2b"}
#: tokens a KV page holds (the engine's page size), fewer where a rank's
#: block of a sequence is shorter
PAGE_TOKENS = 16

#: the reference's --opt bundles: each sets knobs the port does not have
OPTIMIZATIONS = ("blocked_attn", "blocked_attn_2k", "blocked_attn_4k",
                 "blocked_attn_512", "int8_kv", "onehot_update", "pin_out",
                 "gqa_decode", "serve_opt", "serve_opt_int8")
REFUSED = ("sets XLA-only knobs with no counterpart in the port: the "
           "kernels already run a blocked softmax and read K/V once a "
           "group, the cache is bfloat16 or float32, and every tensor is "
           "already each rank's block")


def cell_applicable(arch: str, shape: ShapeSpec) -> tuple[bool, str]:
    if shape.name == "long_500k" and arch not in LONG_OK:
        return False, ("SKIP: pure full-attention KV at 524288 ctx "
                       "(see DESIGN.md §Arch-applicability)")
    return True, ""


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``meta`` stand-ins for every model input: shapes and dtypes, no
    storage."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shp, dtype=torch.int32):
        return torch.empty(shp, dtype=dtype, device="meta")

    if shape.kind in ("train", "prefill"):
        specs = {"tokens": meta((B, S))}
        if shape.kind == "train":
            specs["targets"] = meta((B, S))
        if cfg.is_encoder_decoder:
            specs["extra_embed"] = meta((B, S, cfg.d_model), torch.float32)
        elif cfg.num_vision_tokens:
            specs["extra_embed"] = meta((B, cfg.num_vision_tokens,
                                         cfg.d_model), torch.float32)
        return specs
    # decode: one new token against an S-token KV cache
    return {"token": meta((B, 1)), "cur_index": meta(())}


def batch_pspec(plan, specs: dict) -> dict:
    out = {}
    for k, v in specs.items():
        if v.ndim == 0 or v.shape[0] % plan.dp_size != 0:
            out[k] = (None,) * v.ndim
        else:
            out[k] = (plan.dp,) + (None,) * (v.ndim - 1)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _dtype_sizes(tree):
    return map_leaves(lambda leaf: tensors(leaf)[0].element_size(), tree)


def _shapes(tree):
    return map_leaves(lambda leaf: (len(leaf),) + tuple(leaf[0].shape)
                      if isinstance(leaf, list) else tuple(leaf.shape), tree)


def _batch_blocks(plan, specs: dict) -> dict:
    b_spec = batch_pspec(plan, specs)
    return {k: torch.empty(shard_shape(plan.mesh, b_spec[k], v.shape),
                           dtype=v.dtype, device="meta")
            for k, v in specs.items()}


def spec_sizes(full, plan, shape: ShapeSpec, specs: dict) -> dict:
    """One device's bytes of the cell's arguments by the specs: params;
    train: the AdamW state (an int32 step, f32 moments sharded as the
    params); serve: the reference's dense cache (bf16 K/V, f32
    recurrent states); the batch."""
    mesh = plan.mesh
    tree = param_tree(full)
    p_spec = param_pspecs(plan, tree)
    sizes = {"params": spec_bytes(mesh, p_spec, _shapes(tree),
                                  _dtype_sizes(tree)),
             "batch": sum(_nbytes(v) for v in
                          _batch_blocks(plan, specs).values())}
    if shape.kind == "train":
        sizes["opt"] = 4 + 2 * spec_bytes(
            mesh, p_spec, _shapes(tree), map_leaves(lambda _: 4, tree))
    else:
        dense = dense_cache_shapes(full.cfg, shape.global_batch,
                                   shape.seq_len)
        sizes["cache_dense"] = spec_bytes(
            mesh, cache_pspecs(plan, dense), dense, map_leaves(
                lambda path, _: 2 if path[-1] in ("k", "v") else 4, dense,
                with_path=True))
    return sizes


def build_step(model, plan, shape: ShapeSpec, specs: dict):
    """(step, sizes): ``step()`` runs rank 0's part of the cell's step on
    ``meta``; ``sizes`` its argument bytes by part (:func:`spec_sizes`,
    and the paged cache's).  Train is the reference dry-run's step
    (loss, gradients, AdamW; activations recomputed per period as the
    reference's ``remat="full"``)."""
    cfg = model.cfg
    mesh = plan.mesh
    train = shape.kind == "train"
    rt = plan.runtime(remat="full" if train else "none")
    full = model.init(torch.Generator().manual_seed(0), "meta")
    sizes = spec_sizes(full, plan, shape, specs)
    batch = _batch_blocks(plan, specs)

    if train:
        sp = shard_params(full, plan)
        opt = adamw_init(sp.shards)
        ocfg = OptimizerConfig()

        def train_step():
            gather_params(sp)
            t = param_tree(sp.module)
            flat = tensors(t)
            for x in flat:
                x.requires_grad_(True)
            logits = model.forward_train(sp.module, batch["tokens"],
                                         extra_embed=batch.get("extra_embed"),
                                         remat=rt.remat, rt=rt)
            tgt = batch["targets"]
            share, _ = lm_loss_sharded(logits[:, -tgt.shape[1]:, :], tgt,
                                       None, rt, 0)
            grads = torch.autograd.grad(share, flat, allow_unused=True,
                                        materialize_grads=True)
            grads = reduce_grads(sp, unflatten_tensors(t, list(grads)))
            with torch.no_grad():
                adamw_update(sp.shards, grads, opt, ocfg,
                             grad_norm=grad_norm(sp, grads))

        return train_step, sizes

    local = shard_module(full, plan)
    B, S = batch["tokens" if "tokens" in batch else "token"].shape[0], \
        shape.seq_len
    n_prefix = batch["extra_embed"].shape[1] if "extra_embed" in batch else 0
    layout = kv_layout(plan, shape.global_batch, S + n_prefix)
    L = layout.block_len(mesh)
    T = math.gcd(PAGE_TOKENS, L)
    mp = L // T
    cache = model.init_cache(B * mp, T, rt, "meta", lanes=B, layout=layout)
    if cfg.is_encoder_decoder:
        # the cross K/V over S_enc frames (decode: max_seq, as the
        # reference sizes it), whole where H_kv does not split over tp
        heads = cfg.num_kv_heads // (plan.tp_size if layout.heads else 1)
        cache.alloc_cross(torch.empty(
            (cfg.num_layers, B, S, heads, cfg.head_dim),
            dtype=full.embed.dtype, device="meta"))
        sizes["cross"] = sum(_nbytes(t) for t in cache.cross.values())
    sizes["cache"] = sum(_nbytes(t) for t in cache.k + cache.v) + sum(
        _nbytes(t) for st in getattr(cache, "state", []) for t in st.values()
    ) + sizes.get("cross", 0)
    tables = torch.arange(B * mp, dtype=torch.int32,
                          device="meta").reshape(B, mp)
    if shape.kind == "prefill":
        def prefill_step():
            model.prefill(local, batch["tokens"], cache, tables,
                          extra_embed=batch.get("extra_embed"), rt=rt)
        return prefill_step, sizes

    positions = torch.full((B,), S - 1, dtype=torch.int32, device="meta")

    def serve_step():
        model.decode_step(local, batch["token"], cache, tables, positions,
                          rt=rt)
    return serve_step, sizes


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str = None, verbose: bool = True, mesh=None,
             cfg: ArchConfig = None, shape: ShapeSpec = None) -> dict:
    """One cell's artifact (``mesh``, ``cfg`` and ``shape`` default to
    the production mesh, the arch's config and ``SHAPES[shape_name]``)."""
    shape = shape or SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    mesh_name = "x".join(str(n) for n in mesh.shape.values())
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
              "chips": mesh.size, "kind": shape.kind}
    ok, why = cell_applicable(arch, shape)
    cfg = cfg or get_config(arch)
    if ok:
        mode = "train" if shape.kind == "train" else "serve"
        plan = make_plan(cfg, mesh, mode)
        mesh.reset_tally()
        t0 = time.perf_counter()
        model = build_model(cfg)
        step, sizes = build_step(model, plan, shape, input_specs(cfg, shape))
        with FlopCounterMode(display=False) as counter:
            step()
        tally = mesh.tally
        result.update({
            "status": "ok",
            "run_s": round(time.perf_counter() - t0, 2),
            "flops": float(counter.get_total_flops()),
            "param_bytes": sizes["params"],
            "opt_bytes": sizes.get("opt", 0),
            "batch_bytes": sizes["batch"],
            "cache_bytes": sizes.get("cache", 0),
            "cache_bytes_dense": sizes.get("cache_dense", 0),
            "cross_bytes": sizes.get("cross", 0),
            "argument_size_in_bytes": (
                sizes["params"] + sizes.get("opt", 0)
                + sizes.get("cache", 0) + sizes["batch"]),
            "collectives": {
                "total_bytes": sum(tally["bytes_by_kind"].values()),
                "bytes_by_kind": dict(tally["bytes_by_kind"]),
                "counts": dict(tally["counts"])},
        })
    else:
        result.update({"status": "skip", "reason": why})
    if verbose and result["status"] == "ok":
        print(f"[{arch} × {shape_name} × {mesh_name}] {result['run_s']} s  "
              f"flops/dev {result['flops']:.3e}  args/dev "
              f"{result['argument_size_in_bytes']:.3e} B  coll "
              f"{result['collectives']['total_bytes']:.3e} B")
    elif verbose:
        print(f"[{arch} × {shape_name} × {mesh_name}] {result['reason']}")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        name = f"{arch}__{shape_name}__{mesh_name}.json"
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="architecture id (default: all assigned)")
    ap.add_argument("--shape", default=None,
                    help="shape cell (default: all four)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--opt", action="append", default=[],
                    choices=OPTIMIZATIONS,
                    help="the reference's optimization bundles: refused")
    ap.add_argument("--out", default=os.path.normpath(ARTIFACT_DIR))
    args = ap.parse_args(argv)
    if args.opt:
        ap.error(f"--opt {' '.join(args.opt)}: {REFUSED}")

    archs = [args.arch] if args.arch else list(ASSIGNED)
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                try:
                    run_cell(arch, shape, mp, out_dir=args.out)
                except Exception as e:  # noqa: BLE001 — report every cell
                    failures.append((arch, shape, mp, repr(e)[:200]))
                    print(f"FAIL [{arch} × {shape} × mp={mp}]: {e}",
                          file=sys.stderr)
    if failures:
        print(f"{len(failures)} cell(s) failed", file=sys.stderr)
        sys.exit(1)
    print("all cells passed")


if __name__ == "__main__":
    main()
