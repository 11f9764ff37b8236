"""Sharded serving of the RG-LRU, xLSTM and encoder-decoder families
against the port on one device and the JAX package's sharded programs,
on CPU gloo ranks.

The reduced configs of ``tests/test_distributed.py`` in float32
(recurrentgemma-2b: d 128, 4/2 heads, dh 32, dr 64, window 32;
xlstm-350m: d 128, 4 heads, mLSTM inner 256, sLSTM FFN 170; whisper-small:
2 + 2 layers, 4/2 heads) with every attention layer's wq and wk at the
fan-in d (C14), on 1×2 and 2×4 meshes: 4 prompts of 40 tokens
(whisper: over 24 frames), then 8 decode steps fed fixed tokens, over a
64-token cache.  At tp 2 the KV heads split; at tp 4 the positions do
(the paged kernel's partial route), and recurrentgemma's window of 32
straddles the ranks' blocks of 16.  The RG-LRU runs on blocks of its
channels (its state dr/tp a rank), the xLSTM cells on tp partials of
their products with the recurrences whole on every rank, whisper's
cross K/V on the rank's heads at tp 2 and whole at tp 4.

One launch of ranks per mesh computes every case.  Bounds: against the
one-device port 1e-5 · max |logit| (fault C15: with wq/wk at the fan-in
d only the order of the sums differs; at the init's own fan-in the
attention families' sharded logits part from the one-device ones by up
to 4.7e-5, which the attention families' cases here, also at the
fan-in d, put down to that init); against the reference's sharded run
on an Auto-axis mesh (C4) 1e-4, the bound of
``tests/test_torch_model_shard.py``.  A planted fault, the RG-LRU's
gathered conv output with the ranks' channel blocks rotated by one
rank, must fail the one-device check.
"""
import contextlib
import math

import numpy as np
import pytest
import torch

from repro_torch.core.shard_plane import launch_ranks
from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.sharding import kv_layout, make_plan, \
    shard_module
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import Runtime, build_model, params_from_jax
from repro_torch.models import rglru as rglru_lib
from repro_torch.models.layers import dense_init
from torch_shard_support import ARCHS, reduced, run_reference, run_serve, \
    serve_one_device
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

#: the families of this slice; their weights come from the reference
FAMILIES = ("recurrentgemma-2b", "xlstm-350m", "whisper-small")
MESHES = ((1, 2), (2, 4))
#: against the one-device port (C15) and against the reference
TOL_PORT, TOL_REF = 1e-5, 1e-4
MAX_SEQ = 64
S, STEPS, B, FRAMES = 40, 8, 4, 24
F32 = {"dtype": "float32"}


def inputs(arch: str) -> tuple:
    r = np.random.default_rng(len(arch) * 11)
    tokens = r.integers(0, 512, (B, S)).astype(np.int32)
    fed = r.integers(0, 512, (B, STEPS)).astype(np.int32)
    frames = (r.standard_normal((B, FRAMES, 128)).astype(np.float32)
              if arch == "whisper-small" else None)
    return tokens, fed, frames


def cases():
    """key → (arch, mesh, planted fault, weights from the reference)."""
    out = {(arch, mesh): (arch, mesh, None, True)
           for arch in FAMILIES for mesh in MESHES}
    # C15: the attention families at the fan-in d, port against port
    out.update({(arch, mesh, "c15"): (arch, mesh, None, False)
                for arch in ARCHS if arch != "qwen3-moe-30b-a3b"
                for mesh in MESHES})
    out[("recurrentgemma-2b", (1, 2), "rotated")] = (
        "recurrentgemma-2b", (1, 2), "rotated", True)
    return out


def port_weights(arch: str):
    """A model of the port's own init (seed 0) with every wq and wk
    redrawn at the fan-in d (seed 1): the C15 cases' weights."""
    cfg = reduced(arch, **F32)
    params = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    for layer in params.layers:
        for n in ("wq", "wk"):
            w = layer.attn[n]
            w.data = dense_init(g, tuple(w.shape), w.dtype, "cpu",
                                scale=1 / math.sqrt(cfg.d_model))
    return params


# -- the ranks (no JAX) -------------------------------------------------------

@contextlib.contextmanager
def planted(fault):
    """``rotated``: the gathered conv output's channel blocks each one
    rank along (the shapes still fit)."""
    if fault is None:
        yield
        return
    good = rglru_lib.gather_dr

    def rotated(rt, x):
        return torch.roll(good(rt, x), x.shape[-1], dims=-1)

    rglru_lib.gather_dr = rotated
    try:
        yield
    finally:
        rglru_lib.gather_dr = good


def serve_rank(shape, todo: dict, weights: dict) -> dict:
    mesh = make_test_mesh(*shape).bind()
    out = {}
    for key, (arch, _, fault, ref_weights) in todo.items():
        cfg = reduced(arch, **F32)
        model = build_model(cfg)
        plan = make_plan(cfg, mesh, "serve")
        rt = plan.runtime(kv_cache_dtype="float32")
        full = (params_from_jax(cfg, weights[arch], "cpu") if ref_weights
                else port_weights(arch))
        local = shard_module(full, plan)
        tokens, fed, extra = inputs(arch)
        layout = kv_layout(plan, B, MAX_SEQ)
        b = B // mesh.axis_size(layout.batch)
        lo = mesh.axis_index(layout.batch) * b
        L = layout.block_len(mesh)
        T = math.gcd(16, L)
        cache = model.init_cache(b * (L // T), T, rt, "cpu", lanes=b,
                                 layout=layout)
        tables = torch.arange(b * (L // T), dtype=torch.int32).reshape(b, -1)
        with planted(fault):
            logits = run_serve(model, local, tokens[lo:lo + b],
                               fed[lo:lo + b],
                               None if extra is None else extra[lo:lo + b],
                               cache, tables, rt)
        whole = [all_gather(all_gather(x, mesh, rt.tp_axis, -1), mesh,
                            layout.batch, 0).numpy() for x in logits]
        out[key] = {"logits": whole, "layout": layout,
                    "state": [{k: tuple(t.shape) for k, t in st.items()}
                              for st in getattr(cache, "state", [])],
                    "cross": (None if getattr(cache, "cross", None) is None
                              else tuple(cache.cross["k"].shape))}
    return out


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    jobs = {("params", arch): ("params", (arch, F32, True))
            for arch in FAMILIES}
    for arch in FAMILIES:
        for mesh in MESHES:
            tokens, fed, extra = inputs(arch)
            jobs[(arch, mesh)] = ("serve", (arch, F32, mesh, tokens, fed,
                                            extra, MAX_SEQ, True))
    return run_reference(jobs)


@pytest.fixture(scope="module")
def port(reference):
    weights = {arch: reference[("params", arch)] for arch in FAMILIES}
    out = {}
    for mesh in MESHES:
        todo = {k: v for k, v in cases().items() if v[1] == mesh}
        out.update(launch_ranks(serve_rank, math.prod(mesh), mesh, todo,
                                weights, timeout=300.0)[0])
    return out


_ONE_DEVICE: dict = {}


def one_device(reference, arch):
    """The one-device port's logits (once an arch: the reference's
    params are the module's)."""
    if arch not in _ONE_DEVICE:
        tokens, fed, extra = inputs(arch)
        _ONE_DEVICE[arch] = serve_one_device(
            reduced(arch, **F32), reference[("params", arch)], tokens, fed,
            extra, MAX_SEQ)
    return _ONE_DEVICE[arch]


def gap(got, want) -> float:
    """The largest max |diff| / max |want| over the steps."""
    out = 0.0
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape
        out = max(out, float(np.abs(a - b).max() / np.abs(b).max()))
    return out


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_serve_matches_one_device(reference, port, arch, mesh):
    g = gap(port[(arch, mesh)]["logits"], one_device(reference, arch))
    print(f"{arch} on {mesh}: {g:.3g} of max |logit| from one device")
    assert g <= TOL_PORT, f"{arch} on {mesh}: {g} > {TOL_PORT}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_serve_matches_reference(reference, port, arch, mesh):
    g = gap(port[(arch, mesh)]["logits"], reference[(arch, mesh)])
    assert g <= TOL_REF, f"{arch} on {mesh} vs the reference: {g}"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_layouts_split_state_and_cross_kv(port, mesh):
    """tp 2 splits the KV heads (H_kv 2), tp 4 the positions; the RG-LRU
    state holds dr/tp channels a rank, the xLSTM states are whole, and
    whisper's cross K/V holds H_kv/tp heads at tp 2 and all of them at
    tp 4 (24 frames, L 2 layers, the rank's 4 / dp lanes)."""
    tp, lanes = mesh[1], B // mesh[0]
    for arch in FAMILIES:
        lay = port[(arch, mesh)]["layout"]
        assert lay.heads == (tp == 2) and lay.seq == (
            () if tp == 2 else ("model",))
        assert lay.state_tp == (arch == "recurrentgemma-2b")
    rg = port[("recurrentgemma-2b", mesh)]["state"]
    assert rg and all(st["h"] == (lanes, 64 // tp) for st in rg)
    xl = port[("xlstm-350m", mesh)]["state"]
    assert [st["C"] for st in xl if "C" in st] == [(lanes, 4, 64, 64)] * 2
    assert port[("whisper-small", mesh)]["cross"] == (
        2, lanes, FRAMES, 1 if tp == 2 else 2, 32)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "qwen3-moe-30b-a3b"])
def test_c15_attention_families_at_fan_in_d(port, arch, mesh):
    """C15: with wq/wk at the fan-in d the attention families' sharded
    logits sit within 1e-5 of the one-device port's (at the init's own
    fan-in, up to 4.7e-5).  The MoE is left out: its one-device run
    computes another capacity on two data ranks."""
    tokens, fed, extra = inputs(arch)
    model = build_model(reduced(arch, **F32))
    params = port_weights(arch)
    T, mp = 16, MAX_SEQ // 16
    rt = Runtime(kv_cache_dtype="float32")
    cache = model.init_cache(B * mp, T, rt, "cpu", lanes=B)
    tables = torch.arange(B * mp, dtype=torch.int32).reshape(B, mp)
    want = [x.numpy() for x in run_serve(model, params, tokens, fed, extra,
                                         cache, tables, rt)]
    g = gap(port[(arch, mesh, "c15")]["logits"], want)
    print(f"C15 {arch} on {mesh}: {g:.3g}")
    assert g <= TOL_PORT, f"C15 {arch} on {mesh}: {g} > {TOL_PORT}"


def test_planted_rotation_fails(reference, port):
    """The gathered conv output's channel blocks one rank along: the
    logits stay finite and of the right shape, and miss both bounds
    (the gates' weights are drawn at 0.01, so the gates lean on the
    conv output only weakly: 7.4e-4 of max |logit| seen)."""
    got = port[("recurrentgemma-2b", (1, 2), "rotated")]["logits"]
    assert all(np.isfinite(x).all() for x in got)
    assert gap(got, one_device(reference, "recurrentgemma-2b")) > TOL_REF
