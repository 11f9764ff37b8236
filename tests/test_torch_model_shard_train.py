"""The sharded train step (``training.train_loop.make_train_step`` with a
mesh-ful runtime over ``distributed.sharding.ShardedParams``) against
the JAX package's sharded step and the port's one-device step, on CPU
gloo ranks.

The reduced configs of ``tests/test_distributed.py`` on 1×2, 2×2 and 2×4
meshes (2×4's cases in ``tests/test_torch_model_shard_train_2x4.py``, so
that ``--dist loadfile`` runs its launch on another worker): FSDP over
``data`` (the stored blocks gathered before use, the gradients
reduce-scattered), tensor parallelism over ``model``, the MoE's experts
over ``data``, a vocab-parallel loss, AdamW on the blocks (ZeRO).  One
step on 8 × 32 tokens (internvl2-2b: behind 8 patch embeddings), in the
configs' bfloat16 as the reference's own test
(``test_sharded_train_matches_single_device``) with its bounds: loss
rtol 2e-3, params rtol 5e-2 and atol 5e-3.  In float32 the step is held
tighter to the port's one-device step: the loss and the params to 1e-5,
the global grad norm (each element counted once) to 1e-4, each leaf's
update p_new − p_old and first moment at a bound set by that leaf's own
change (a step that loses its update or puts a gradient block on another
rank keeps the loss and the norm; two such planted faults must fail),
with int8 compression (each leaf's scale from its max over the mesh) as
well.  Top-k compression under a mesh is refused (fault C12).  The
reference runs in a subprocess on an Auto-axis mesh of 8 host devices
(C4).
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from repro_torch.core.shard_plane import launch_ranks
from repro_torch.distributed import sharding
from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.sharding import full_params, make_plan, \
    shard_params
from repro_torch.launch.mesh import axes_of, make_test_mesh
from repro_torch.models import build_model, param_tree, params_from_jax
from repro_torch.training.grad_compress import CompressorConfig, \
    init_error_state
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import TrainConfig, make_train_step
from repro_torch.tree import is_group, map_leaves, tensors
from torch_shard_support import ARCHS, INT8_MU_SHARE, MESHES, NORM_RTOL, \
    assert_update_matches, leaves, reduced, run_reference
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

F32 = {"dtype": "float32"}
#: the planted faults that the update check must catch, on 2×2
FAULTS = ("lost_update", "swapped_blocks")


def batch(arch: str) -> tuple:
    r = np.random.default_rng(len(arch))
    tokens = r.integers(0, 512, (8, 32)).astype(np.int32)
    targets = r.integers(0, 512, (8, 32)).astype(np.int32)
    extra = (r.standard_normal((8, 8, 128)).astype(np.float32)
             if arch == "internvl2-2b" else None)
    return tokens, targets, extra


def cases():
    """key → (arch, mesh, overrides, compressor, planted fault)."""
    out = {}
    for arch in ARCHS:
        for mesh in MESHES:
            out[(arch, mesh)] = (arch, mesh, {}, "none", None)
            out[(arch, mesh, "f32")] = (arch, mesh, F32, "none", None)
        out[(arch, (2, 2), "int8")] = (arch, (2, 2), F32, "int8", None)
    out[("tinyllama-1.1b", (1, 2), "topk")] = ("tinyllama-1.1b", (1, 2),
                                               F32, "topk", None)
    for fault in FAULTS:
        out[("tinyllama-1.1b", (2, 2), fault)] = ("tinyllama-1.1b", (2, 2),
                                                  F32, "none", fault)
    return out


def one_step(model, params, opt, err, tcfg, rt, arch, rows=slice(None)):
    tokens, targets, extra = batch(arch)
    b = {"tokens": torch.from_numpy(tokens[rows]).long(),
         "targets": torch.from_numpy(targets[rows]).long()}
    if extra is not None:
        b["extra_embed"] = torch.from_numpy(extra[rows])
    step = make_train_step(model, tcfg, *([rt] if rt else []))
    return step(params, opt, err, b)


# -- the ranks (no JAX) -------------------------------------------------------

def _swapped_blocks(reduce_grads):
    """A planted fault: ``reduce_grads`` whose every FSDP block is the
    next data rank's (the global norm unchanged)."""
    def wrapped(sp, grads):
        mesh, dp = sp.plan.mesh, set(sp.plan.dp_axes)

        def one(g, spec):
            for dim, e in enumerate(spec):
                if e is not None and set(axes_of(e)) <= dp:
                    n, i = mesh.axis_size(e), mesh.axis_index(e)
                    whole = all_gather(g, mesh, e, dim)
                    return whole.chunk(n, dim)[(i + 1) % n].contiguous()
            return g

        def leaf(g, spec):
            out = [one(t, spec[1:] if is_group(g) else spec)
                   for t in (g if is_group(g) else [g])]
            return out if is_group(g) else out[0]

        with torch.no_grad():
            return map_leaves(leaf, reduce_grads(sp, grads), sp.specs)
    return wrapped


@contextlib.contextmanager
def planted(fault):
    if fault != "swapped_blocks":
        yield
        return
    good = sharding.reduce_grads
    sharding.reduce_grads = _swapped_blocks(good)
    try:
        yield
    finally:
        sharding.reduce_grads = good


def train_rank(shape, todo: dict, weights: dict) -> dict:
    mesh = make_test_mesh(*shape).bind()
    out = {}
    for key, (arch, _, over, comp, fault) in todo.items():
        cfg = reduced(arch, **over)
        model = build_model(cfg)
        plan = make_plan(cfg, mesh, "train")
        rt = plan.runtime()
        sp = shard_params(params_from_jax(cfg, weights[(arch, bool(over))],
                                          "cpu"), plan)
        before = [t.clone() for t in tensors(sp.shards)]
        err = init_error_state(sp.shards) if comp != "none" else None
        n = 8 // mesh.axis_size(rt.dp_axes)
        i = mesh.axis_index(rt.dp_axes)
        tcfg = TrainConfig(compressor=CompressorConfig(kind=comp))
        try:
            with planted(fault):
                sp, opt, _, m = one_step(model, sp, adamw_init(sp.shards),
                                         err, tcfg, rt, arch,
                                         slice(i * n, (i + 1) * n))
        except NotImplementedError as e:
            out[key] = str(e)
            continue
        if fault == "lost_update":       # the state left as it was
            for t, old in zip(tensors(sp.shards), before):
                t.copy_(old)
            opt = adamw_init(sp.shards)
        out[key] = {"loss": float(m["loss"]),
                    "grad_norm": float(m["grad_norm"]),
                    "leaves": leaves(full_params(sp)),
                    "mu": leaves(full_params(sp, opt.mu))}
    return out


# -- fixtures -----------------------------------------------------------------

#: the MoE's float32 steps on two data ranks are held to the reference's
#: sharded step: there its capacity comes from the rank's tokens
MOE_DP = [("qwen3-moe-30b-a3b", m) for m in MESHES if m[0] > 1]
#: the meshes this file runs; 2×4's cases run in
#: tests/test_torch_model_shard_train_2x4.py (its own worker)
HERE = ((1, 2), (2, 2))


def reference_for(meshes) -> dict:
    """The reference's params and sharded steps on ``meshes``."""
    jobs = {("params", arch, f32): ("params", (arch, F32 if f32 else {}))
            for arch in ARCHS for f32 in (False, True)}
    for arch in ARCHS:
        for mesh in meshes:
            tokens, targets, extra = batch(arch)
            jobs[(arch, mesh)] = ("train", (arch, {}, mesh, tokens, targets,
                                            extra))
    for arch, mesh in MOE_DP:
        if mesh in meshes:
            tokens, targets, extra = batch(arch)
            jobs[(arch, mesh, "f32")] = ("train", (arch, F32, mesh, tokens,
                                                   targets, extra))
    return run_reference(jobs)


def port_for(reference, meshes) -> dict:
    """One launch of ranks a mesh of ``meshes``, each computing every
    case of its mesh."""
    weights = {(arch, f32): reference[("params", arch, f32)]
               for arch in ARCHS for f32 in (False, True)}
    out = {}
    for mesh in meshes:
        todo = {k: v for k, v in cases().items() if v[1] == mesh}
        out.update(launch_ranks(train_rank, math.prod(mesh), mesh, todo,
                                weights, timeout=300.0)[0])
    return out


@pytest.fixture(scope="module")
def reference():
    return reference_for(HERE)


@pytest.fixture(scope="module")
def port(reference):
    return port_for(reference, HERE)


def initial(reference, arch) -> list:
    """The float32 params' leaves before the step."""
    cfg = reduced(arch, **F32)
    return leaves(param_tree(params_from_jax(
        cfg, reference[("params", arch, True)], "cpu")))


def one_device(reference, arch, comp="none") -> dict:
    cfg = reduced(arch, **F32)
    model = build_model(cfg)
    params = params_from_jax(cfg, reference[("params", arch, True)], "cpu")
    tree = param_tree(params)
    err = init_error_state(tree) if comp != "none" else None
    tcfg = TrainConfig(compressor=CompressorConfig(kind=comp))
    params, opt, _, m = one_step(model, params, adamw_init(tree), err, tcfg,
                                 None, arch)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "leaves": leaves(param_tree(params)), "mu": leaves(opt.mu)}


@pytest.mark.parametrize("mesh", HERE, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_reference(reference, port, arch, mesh):
    """bfloat16, the reference's own bounds on the loss and the params.
    The update and the first moments are held in float32 (below): in
    bfloat16 the update rounds away and the gradients are rounding noise
    (the reference's own first moments on 2×4 and on 1×2 differ by up to
    0.9 of their norm)."""
    check_against_reference(reference, port, arch, mesh)


def check_against_reference(reference, port, arch, mesh) -> None:
    loss, ref_leaves, _ = reference[(arch, mesh)]
    got = port[(arch, mesh)]
    np.testing.assert_allclose(got["loss"], loss, rtol=2e-3)
    assert len(got["leaves"]) == len(ref_leaves)
    for a, b in zip(got["leaves"], ref_leaves):
        np.testing.assert_allclose(a, b, rtol=5e-2, atol=5e-3)


@pytest.mark.parametrize("mesh", HERE, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_one_device(reference, port, arch, mesh):
    """Float32: the loss of the sharded step equals the one-device
    step's to 1e-5 and its global grad norm to ``NORM_RTOL``; the new
    params, the update and the first moments as
    :func:`assert_update_matches` holds them.  The MoE on two data ranks
    is held to the reference's float32 sharded step instead, as its
    capacity there comes from the rank's tokens."""
    check_against_one_device(reference, port, arch, mesh)


def check_against_one_device(reference, port, arch, mesh) -> None:
    got = port[(arch, mesh, "f32")]
    if (arch, mesh) in MOE_DP:
        loss, new, mu = reference[(arch, mesh, "f32")]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        want = {"leaves": new, "mu": mu}
    else:
        want = one_device(reference, arch)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=NORM_RTOL)
    assert_update_matches(got, want, initial(reference, arch))


@pytest.mark.parametrize("arch", ("tinyllama-1.1b", "gemma2-2b",
                                  "internvl2-2b"))
def test_sharded_int8_compression_matches_one_device(reference, port, arch):
    """int8 with error feedback on 2×2: each leaf's scale is its max over
    the mesh, so the round trip is the one-device step's."""
    want = one_device(reference, arch, "int8")
    got = port[(arch, (2, 2), "int8")]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=NORM_RTOL)
    assert_update_matches(got, want, initial(reference, arch), INT8_MU_SHARE)


@pytest.mark.parametrize("fault", FAULTS)
def test_planted_fault_fails_the_update_check(reference, port, fault):
    """A step that loses its update, or whose gradient blocks land on
    another data rank, keeps the loss and the global norm — and fails
    :func:`assert_update_matches`."""
    want = one_device(reference, "tinyllama-1.1b")
    got = port[("tinyllama-1.1b", (2, 2), fault)]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=NORM_RTOL)
    with pytest.raises(AssertionError):
        assert_update_matches(got, want, initial(reference, "tinyllama-1.1b"))


def test_topk_under_a_mesh_is_refused(port):
    assert "C12" in port[("tinyllama-1.1b", (1, 2), "topk")]
