"""``repro_torch.models.moe.moe_mlp_ep`` — the expert-parallel MoE MLP of
a mesh-ful runtime — against the JAX package's ``moe_mlp_ep`` under
``shard_map``, on CPU gloo ranks.

The reduced qwen3-moe-30b-a3b of ``tests/test_distributed.py`` in
float32 (8 experts, top 2, d 128, expert ffn 256, the capacity factor
1.25, so experts drop tokens), its first layer's MoE, 16 tokens a data
rank, on 1×2, 2×2 and 2×4 meshes: experts over ``data`` (all_to_all
there and back), the expert ffn over ``model`` (the partial
down-projection summed).  Each data rank's dispatch (which assignments
are kept, and their slots) must equal the reference's shard's, and the
outputs agree within 1e-5.  The reference runs in a subprocess on an
Auto-axis mesh of 8 host devices (fault C4).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core.shard_plane import launch_ranks
from repro_torch.distributed.collectives import all_gather
from repro_torch.distributed.sharding import make_plan, shard_module
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import moe, params_from_jax
from torch_shard_support import MESHES, reduced, run_reference

ARCH = "qwen3-moe-30b-a3b"
OVER = {"dtype": "float32"}
T_LOCAL = 16


def tokens(mesh) -> np.ndarray:
    r = np.random.default_rng(mesh[0] * 10 + mesh[1])
    return r.standard_normal((T_LOCAL * mesh[0], 128)).astype(np.float32)


def ep_rank(shape, weights) -> dict:
    mesh = make_test_mesh(*shape).bind()
    cfg = reduced(ARCH, **OVER)
    plan = make_plan(cfg, mesh, "serve")
    rt = plan.runtime()
    layer = shard_module(params_from_jax(cfg, weights, "cpu"),
                         plan).layers[0]
    i = mesh.axis_index(rt.dp_axes)
    x = torch.from_numpy(tokens(shape)[i * T_LOCAL:(i + 1) * T_LOCAL])
    mesh.reset_tally()
    out = moe.moe_mlp_ep(layer.moe, x, cfg, rt)
    a2a = mesh.tally["counts"].get("all-to-all", 0)
    _, idx = moe.route(layer.moe["router"], x, cfg)
    _, dst, keep = moe._dispatch_indices(
        idx.reshape(-1), cfg.num_experts, moe.expert_capacity(T_LOCAL, cfg))
    return {"out": all_gather(out, mesh, rt.dp_axes, 0).numpy(),
            "keep": keep.numpy(), "dst": dst.numpy(), "data": i,
            "experts": layer.moe["w_gate"].shape[0], "all_to_all": a2a}


@pytest.fixture(scope="module")
def runs():
    jobs = {"params": ("params", (ARCH, OVER))}
    for mesh in MESHES:
        jobs[mesh] = ("moe_ep", (ARCH, OVER, mesh, tokens(mesh)))
    ref = run_reference(jobs)
    port = {mesh: launch_ranks(ep_rank, math.prod(mesh), mesh,
                               ref["params"], timeout=180.0)
            for mesh in MESHES}
    return ref, port


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_moe_mlp_ep_matches_reference(runs, mesh):
    ref, port = runs
    out, keep, dst = ref[mesh]
    for r in port[mesh]:
        assert r["experts"] == 8 // mesh[0]
        assert r["all_to_all"] == (2 if mesh[0] > 1 else 0)
        np.testing.assert_array_equal(r["keep"], keep[r["data"]])
        np.testing.assert_array_equal(r["dst"], dst[r["data"]])
        np.testing.assert_allclose(r["out"], out, rtol=1e-5, atol=1e-5)
    # the capacity drops assignments (the case is not trivially dense)
    assert not keep.all()
