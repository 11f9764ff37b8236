"""Sharded serving (``repro_torch.distributed`` + the models' mesh-ful
paths) against the port on one device and the JAX package's sharded
programs, on CPU gloo ranks.

The reduced configs of ``tests/test_distributed.py`` in float32 (d 128,
4/2 heads, dh 32, vocab 512, d_ff 256; the MoE's capacity factor 4, so
no expert drops tokens and the one-device run is the same function —
drops are ``tests/test_torch_moe_ep.py``'s) on 1×2, 2×2 and 2×4 meshes:
4 prompts of 40 tokens (internvl2-2b: behind 8 patch embeddings), then
8 decode steps fed fixed tokens, over a 64-token cache.  At tp 2 the
KV heads split (head-sharded); at tp 4 (H_kv 2) the positions do
(sequence-sharded: the paged kernel's partial route, merged across
ranks), and gemma2's window of 32 over contexts 41-48 straddles three
ranks' blocks of 16.  A B = 1 decode on 2×4 spreads the sequence over
all 8 ranks (context parallelism).

One launch of ranks per mesh computes every case; each returns its
logits gathered whole.  The reference (``tests/torch_shard_reference.py``)
runs in a subprocess on 8 host devices on an Auto-axis mesh (C4).
Bounds: the family tests' float32 bound, max |diff| ≤ 1e-4 · max |logit|,
against both.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.shard_plane import launch_ranks
from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.sharding import kv_layout, make_plan, \
    shard_module
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import build_model, params_from_jax
from torch_shard_support import ARCHS, MESHES, reduced, run_reference, \
    run_serve, serve_one_device
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

TOL = 1e-4
MAX_SEQ = 64
S, STEPS, B = 40, 8, 4
#: context-parallel cases (B = 1) on the 2×4 mesh: the dense archs (the
#: reference's expert-parallel shard_map needs the tokens split)
CP_ARCHS = ("tinyllama-1.1b", "gemma2-2b")


def overrides(arch: str) -> dict:
    return {"dtype": "float32",
            **({"moe_capacity_factor": 4.0} if "moe" in arch else {})}


def inputs(arch: str, b: int = B) -> tuple:
    r = np.random.default_rng(len(arch) * 7 + b)
    tokens = r.integers(0, 512, (b, S)).astype(np.int32)
    fed = r.integers(0, 512, (b, STEPS)).astype(np.int32)
    extra = (r.standard_normal((b, 8, 128)).astype(np.float32)
             if arch == "internvl2-2b" else None)
    return tokens, fed, extra


def cases():
    """key → (arch, mesh, tokens, fed, extra)."""
    out = {}
    for arch in ARCHS:
        for mesh in MESHES:
            out[(arch, mesh)] = (arch, mesh) + inputs(arch)
    for arch in CP_ARCHS:
        out[(arch, "cp")] = (arch, (2, 4)) + inputs(arch, 1)
    return out


# -- the ranks (no JAX) -------------------------------------------------------

def serve_rank(shape, todo: dict, weights: dict) -> dict:
    mesh = make_test_mesh(*shape).bind()
    out = {}
    for key, (arch, _, tokens, fed, extra) in todo.items():
        cfg = reduced(arch, **overrides(arch))
        model = build_model(cfg)
        plan = make_plan(cfg, mesh, "serve")
        rt = plan.runtime(kv_cache_dtype="float32")
        local = shard_module(params_from_jax(cfg, weights[arch], "cpu"), plan)
        layout = kv_layout(plan, tokens.shape[0], MAX_SEQ)
        nb = mesh.axis_size(layout.batch)
        b = tokens.shape[0] // nb
        lo = mesh.axis_index(layout.batch) * b
        L = layout.block_len(mesh)
        T = math.gcd(16, L)
        cache = model.init_cache(b * (L // T), T, rt, "cpu", layout=layout)
        tables = torch.arange(b * (L // T), dtype=torch.int32).reshape(b, -1)
        logits = run_serve(model, local, tokens[lo:lo + b], fed[lo:lo + b],
                           None if extra is None else extra[lo:lo + b],
                           cache, tables, rt)
        whole = [all_gather(all_gather(x, mesh, rt.tp_axis, -1), mesh,
                            layout.batch, 0).numpy() for x in logits]
        out[key] = {"logits": whole, "layout": layout,
                    "offset": layout.offset(mesh), "block": L}
    return out


# -- fixtures -----------------------------------------------------------------

@pytest.fixture(scope="module")
def reference():
    jobs = {("params", arch): ("params", (arch, overrides(arch)))
            for arch in ARCHS}
    for key, (arch, mesh, tokens, fed, extra) in cases().items():
        jobs[key] = ("serve", (arch, overrides(arch), mesh, tokens, fed,
                               extra, MAX_SEQ))
    return run_reference(jobs)


@pytest.fixture(scope="module")
def port(reference):
    weights = {arch: reference[("params", arch)] for arch in ARCHS}
    out = {}
    for mesh in MESHES:
        todo = {k: v for k, v in cases().items() if v[1] == mesh}
        out.update(launch_ranks(serve_rank, math.prod(mesh), mesh, todo,
                                weights, timeout=300.0)[0])
    return out


def one_device(reference, arch, tokens, fed, extra):
    """The port on one device (its own paged cache, LOCAL)."""
    return serve_one_device(reduced(arch, **overrides(arch)),
                            reference[("params", arch)], tokens, fed, extra,
                            MAX_SEQ)


def close(got, want, what):
    for step, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, what
        err, scale = np.abs(a - b).max(), np.abs(b).max()
        assert err <= TOL * scale, (f"{what} step {step} (0 = prefill): "
                                    f"max |diff| {err} > {TOL} x {scale}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_matches_one_device(reference, port, arch, mesh):
    _, _, tokens, fed, extra = cases()[(arch, mesh)]
    close(port[(arch, mesh)]["logits"],
          one_device(reference, arch, tokens, fed, extra),
          f"{arch} on {mesh} vs one device")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_matches_reference(reference, port, arch, mesh):
    got = port[(arch, mesh)]
    close(got["logits"], reference[(arch, mesh)],
          f"{arch} on {mesh} vs the reference")
    # tp 2 splits the KV heads (H_kv 2); tp 4 the positions
    assert got["layout"].heads == (mesh[1] == 2)
    assert got["layout"].seq == (() if mesh[1] == 2 else ("model",))


@pytest.mark.parametrize("arch", CP_ARCHS)
def test_context_parallel_decode_b1(reference, port, arch):
    got = port[(arch, "cp")]
    assert got["layout"].seq == ("data", "model") and got["block"] == 8
    _, _, tokens, fed, extra = cases()[(arch, "cp")]
    close(got["logits"], reference[(arch, "cp")], f"{arch} B=1 on 2x4")
    close(got["logits"], one_device(reference, arch, tokens, fed, extra),
          f"{arch} B=1 on 2x4 vs one device")


def test_gemma2_local_window_straddles_ranks(port):
    """On 2×4 each rank holds 16 positions; gemma2's local layers (window
    32) at contexts 41-48 read positions 9-47: the window's first token
    lies inside rank 0's block (contexts 41-47), and each window covers
    the blocks of two or three ranks (the logits are held above)."""
    got = port[("gemma2-2b", (2, 4))]
    cfg = reduced("gemma2-2b")
    L = got["block"]
    assert L == 16 and got["layout"].seq == ("model",)
    spans = []
    for ctx in range(S + 1, S + STEPS + 1):
        first = ctx - cfg.window_size
        spans.append(len({p // L for p in range(first, ctx)}))
        assert (0 < first < L) == (ctx < 48)
    assert spans == [3] * 7 + [2]
