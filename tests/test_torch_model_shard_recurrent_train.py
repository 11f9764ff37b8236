"""The sharded train step of the RG-LRU, xLSTM and encoder-decoder
families (``training.train_loop.make_train_step`` with a mesh-ful
runtime over ``distributed.sharding.ShardedParams``) against the port's
one-device step and the JAX package's sharded step, on CPU gloo ranks;
and elastic checkpoints of their stacked trees.

The reduced configs of ``tests/test_distributed.py`` in float32 with
every attention layer's wq and wk at the fan-in d (C14), on 1×2 and 2×4
meshes: FSDP over ``data``, tensor parallelism over ``model`` (the
RG-LRU over blocks of its channels, the xLSTM cells' products as tp
partials, whisper's encoder, self- and cross-attention by the attention
rules), a vocab-parallel loss, AdamW on the blocks (ZeRO).  One step on
8 × 32 tokens (whisper: over 16 frames a sequence).  Held as
``tests/test_torch_model_shard_train.py`` holds its float32 steps: the
loss to 1e-5, the global grad norm to 1e-4 (one device only), the new
params, each leaf's update and first moment (``assert_update_matches``)
against the one-device step and against the reference's sharded step on
an Auto-axis mesh of 8 host devices (C4).

Elastic: each family's stored blocks after the 1×2 step, saved from its
2 ranks (``checkpointing.save(..., shardings=)``), restored on the 8
ranks of 2×4 under that mesh's train plan and gathered whole, equal the
1×2 step's params bit for bit.
"""
import math
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpointing import latest_step, restore, save
from repro_torch.core.shard_plane import launch_ranks
from repro_torch.distributed.sharding import NamedSharding, full_params, \
    make_plan, shard_params
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model, param_tree, params_from_jax
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.tree import is_group, map_leaves
from torch_shard_support import MU_SHARE, NORM_RTOL, assert_update_matches, \
    leaf_keys, leaves, reduced, run_reference
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

FAMILIES = ("recurrentgemma-2b", "xlstm-350m", "whisper-small")
MESHES = ((1, 2), (2, 4))
F32 = {"dtype": "float32"}
B, S, FRAMES = 8, 32, 16


def batch(arch: str) -> tuple:
    r = np.random.default_rng(len(arch) + 3)
    tokens = r.integers(0, 512, (B, S)).astype(np.int32)
    targets = r.integers(0, 512, (B, S)).astype(np.int32)
    frames = (r.standard_normal((B, FRAMES, 128)).astype(np.float32)
              if arch == "whisper-small" else None)
    return tokens, targets, frames


def one_step(model, params, opt, rt, arch, rows=slice(None)):
    tokens, targets, frames = batch(arch)
    b = {"tokens": torch.from_numpy(tokens[rows].copy()).long(),
         "targets": torch.from_numpy(targets[rows].copy()).long()}
    if frames is not None:
        b["extra_embed"] = torch.from_numpy(frames[rows].copy())
    step = make_train_step(model, TrainConfig(), *([rt] if rt else []))
    return step(params, opt, None, b)


# -- the ranks (no JAX) -------------------------------------------------------

def _meta(leaf):
    if is_group(leaf):
        return [torch.empty_like(t, device="meta") for t in leaf]
    return torch.empty_like(leaf, device="meta")


def train_rank(shape, weights: dict, directory: str) -> dict:
    """Each family's float32 step on this mesh; on 1×2 the stored blocks
    are then saved, on 2×4 the 1×2 save is first restored."""
    mesh = make_test_mesh(*shape).bind()
    out = {}
    for arch in FAMILIES:
        cfg = reduced(arch, **F32)
        model = build_model(cfg)
        plan = make_plan(cfg, mesh, "train")
        rt = plan.runtime()
        full = params_from_jax(cfg, weights[arch], "cpu")
        sp = shard_params(full, plan)
        ckpt = os.path.join(directory, arch)
        shardings = map_leaves(lambda s: NamedSharding(mesh, s), sp.specs)
        if shape == (2, 4):
            got = restore(ckpt, latest_step(ckpt),
                          map_leaves(_meta, param_tree(full)), shardings)
            out[(arch, "restored")] = leaves(full_params(sp, got))
        n = B // mesh.axis_size(rt.dp_axes)
        i = mesh.axis_index(rt.dp_axes)
        sp, opt, _, m = one_step(model, sp, adamw_init(sp.shards), rt, arch,
                                 slice(i * n, (i + 1) * n))
        if shape == (1, 2):
            save(ckpt, 1, sp.shards, shardings)
        out[arch] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "leaves": leaves(full_params(sp)),
                     "mu": leaves(full_params(sp, opt.mu))}
    return out


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    jobs = {("params", arch): ("params", (arch, F32, True))
            for arch in FAMILIES}
    for arch in FAMILIES:
        for mesh in MESHES:
            jobs[(arch, mesh)] = ("train", (arch, F32, mesh, *batch(arch),
                                            True))
    return run_reference(jobs)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    weights = {arch: reference[("params", arch)] for arch in FAMILIES}
    directory = str(tmp_path_factory.mktemp("elastic"))
    out = {}
    for mesh in MESHES:            # 1×2 saves, then 2×4 restores
        res = launch_ranks(train_rank, math.prod(mesh), mesh, weights,
                           directory, timeout=300.0)[0]
        out.update({(k, mesh) if isinstance(k, str) else k: v
                    for k, v in res.items()})
    return out


def initial(reference, arch) -> list:
    """The float32 params' leaves before the step."""
    return leaves(param_tree(params_from_jax(
        reduced(arch, **F32), reference[("params", arch)], "cpu")))


def keys(reference, arch) -> list:
    """The keys of :func:`initial`'s leaves."""
    return leaf_keys(param_tree(params_from_jax(
        reduced(arch, **F32), reference[("params", arch)], "cpu")))


_ONE_DEVICE: dict = {}


def one_device(reference, arch, reverse: bool = False) -> dict:
    """The one-device step (once an arch and row order: the reference's
    params are the module's); ``reverse``: the batch's rows in reverse
    order."""
    if (arch, reverse) not in _ONE_DEVICE:
        cfg = reduced(arch, **F32)
        params = params_from_jax(cfg, reference[("params", arch)], "cpu")
        params, opt, _, m = one_step(
            build_model(cfg), params, adamw_init(param_tree(params)), None,
            arch, slice(None, None, -1 if reverse else 1))
        _ONE_DEVICE[(arch, reverse)] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "leaves": leaves(param_tree(params)), "mu": leaves(opt.mu)}
    return _ONE_DEVICE[(arch, reverse)]


def frozen(reference, arch) -> frozenset:
    """The leaves whose float32 update rounds away: the RG-LRU's Λ (its
    gradients ~1e-9 against params ~1, under half an ulp)."""
    return frozenset(k for k in keys(reference, arch)
                     if k.endswith("/rec/lambda"))


#: the leaves whose gradient is rounding noise: the sLSTM's input-gate
#: bias (its gradient ~1e-8 where the mLSTM's is ~1e-3; the stabilised
#: gate cancels between the cell state and its normaliser)
NOISE = {"xlstm-350m": frozenset({"periods/k1/cell/b_i"})}


def noise(reference, arch, want) -> frozenset:
    """The leaves whose first moment the one-device step does not hold
    within ``MU_SHARE`` of itself when the batch's rows come in reverse
    order (the same tokens, the same mean loss, other sums): exactly
    ``NOISE``'s."""
    other = one_device(reference, arch, reverse=True)
    out = frozenset(k for k, a, b in zip(keys(reference, arch),
                                         other["mu"], want["mu"])
                    if np.abs(a - b).max() > MU_SHARE * np.abs(b).max())
    assert out == NOISE.get(arch, frozenset()), (arch, sorted(out))
    return out


def assert_step(reference, arch, got, want) -> None:
    assert_update_matches(got, want, initial(reference, arch),
                          keys=keys(reference, arch),
                          frozen=frozen(reference, arch),
                          noise=noise(reference, arch,
                                      one_device(reference, arch)))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_train_step_matches_one_device(reference, port, arch, mesh):
    got, want = port[(arch, mesh)], one_device(reference, arch)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=NORM_RTOL)
    assert_step(reference, arch, got, want)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_train_step_matches_reference(reference, port, arch, mesh):
    loss, new, mu = reference[(arch, mesh)]
    got = port[(arch, mesh)]
    np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
    assert_step(reference, arch, got, {"leaves": new, "mu": mu})


@pytest.mark.parametrize("arch", FAMILIES)
def test_elastic_restore_of_stacked_trees(port, arch):
    """Saved from the 2 ranks of 1×2, restored on the 8 of 2×4."""
    want = port[(arch, (1, 2))]["leaves"]
    got = port[(arch, "restored")]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
