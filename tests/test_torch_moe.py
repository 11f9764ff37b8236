"""The port's MoE MLP (``repro_torch.models.moe``) against the JAX
package's (``repro.models.moe``), on the CPU.

The JAX parameters (router in float32, experts in the model's dtype) go
to the port as numpy arrays; the tokens are made from numpy with a
seed.  Routing decisions are held exactly: the top-k expert ids (lower
id first among equal probabilities, as ``jax.lax.top_k`` gives), the
dispatch permutation, slots and kept assignments.  Outputs are held at
1e-4 of their largest magnitude in float32 and 2e-2 in bfloat16 (the
tolerances of ``tests/test_torch_models.py``), with partial capacity
drops (as in ``tests/test_models_smoke.py``) and, where nothing drops,
against the reference's dense oracle ``moe_dense_reference``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro_torch.configs import get_config
from repro_torch.models import moe

TOL = {"float32": 1e-4, "bfloat16": 2e-2}


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def setup(arch: str, dtype: str, T: int, seed: int, **over):
    """Both configs, the JAX params and their torch copies, and (T, d)
    tokens in ``dtype``."""
    jcfg = jax_get_config(arch).reduced(dtype=dtype, **over)
    cfg = get_config(arch).reduced(dtype=dtype, **over)
    jp = jax_moe.init_moe(jax.random.PRNGKey(seed), jcfg,
                          getattr(jnp, dtype))
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.float32 if k == "router" else getattr(torch, dtype))
        for k, v in jp.items()}
    x = np.random.default_rng(seed).standard_normal(
        (T, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return jcfg, cfg, jp, tp, jx, tx


def assert_close(out, want, dtype: str, what: str = "") -> None:
    a, b = as_np(out), as_np(want)
    assert a.shape == b.shape, what
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= TOL[dtype] * scale, f"{what}: {err} > {TOL[dtype]} x {scale}"


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"])
@pytest.mark.parametrize("T", [1, 7, 64])
def test_route_matches(arch, T):
    jcfg, cfg, jp, tp, jx, tx = setup(arch, "float32", T, T)
    jg, ji = jax_moe.route(jp["router"], jx, jcfg)
    g, i = moe.route(tp["router"], tx, cfg)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-7)
    assert g.dtype == torch.float32


def test_route_ties_take_the_lower_expert_first():
    """Equal probabilities (a zero router): top-k is experts 0..k-1 in
    order on both sides, with equal gates."""
    jcfg = jax_get_config("qwen3-moe-30b-a3b").reduced(num_experts=8,
                                                       experts_per_token=3)
    cfg = get_config("qwen3-moe-30b-a3b").reduced(num_experts=8,
                                                  experts_per_token=3)
    x = np.ones((5, cfg.d_model), np.float32)
    jg, ji = jax_moe.route(jnp.zeros((cfg.d_model, 8)), jnp.asarray(x), jcfg)
    g, i = moe.route(torch.zeros(cfg.d_model, 8), torch.from_numpy(x), cfg)
    assert np.asarray(ji).tolist() == [[0, 1, 2]] * 5
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-7)


@pytest.mark.parametrize("N,E,C", [(16, 4, 2), (40, 8, 5), (64, 8, 100),
                                   (9, 3, 1)])
def test_dispatch_indices_match(N, E, C):
    """Permutation, slots and kept assignments, with drops (a dropped
    assignment points at its expert's last slot) and without."""
    ids = np.random.default_rng(N).integers(0, E, N).astype(np.int32)
    jperm, jdst, jkeep = jax_moe._dispatch_indices(jnp.asarray(ids), E, C)
    perm, dst, keep = moe._dispatch_indices(torch.from_numpy(ids).long(),
                                            E, C)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(dst.numpy(), np.asarray(jdst))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    if C < N // E:
        assert not keep.all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 8.0])
@pytest.mark.parametrize("T", [8, 64])
def test_moe_mlp_matches(T, cf, dtype):
    """``moe_mlp`` at capacity factors that drop most, some, or none of
    the assignments; the expert capacity is the reference's."""
    jcfg, cfg, jp, tp, jx, tx = setup("qwen3-moe-30b-a3b", dtype, T, 3,
                                      moe_capacity_factor=cf)
    C = moe.expert_capacity(T, cfg)
    assert C == max(1, int(T * jcfg.experts_per_token / jcfg.num_experts
                           * cf))
    want = jax_moe.moe_mlp(jp, jx, jcfg)
    out = moe.moe_mlp(tp, tx, cfg)
    assert out.dtype == getattr(torch, dtype)
    assert bool(torch.isfinite(out).all())
    assert_close(out, want, dtype, f"T={T} cf={cf}")


def test_partial_drops_are_the_references():
    """At capacity factor 0.25 some but not all assignments drop; the
    port drops the same ones (its output with every expert zeroed
    except the kept slots equals the reference's)."""
    jcfg, cfg, jp, tp, jx, tx = setup("qwen3-moe-30b-a3b", "float32", 64, 5,
                                      moe_capacity_factor=0.25)
    T, k, E = 64, cfg.experts_per_token, cfg.num_experts
    C = moe.expert_capacity(T, cfg)
    _, ji = jax_moe.route(jp["router"], jx, jcfg)
    _, _, jkeep = jax_moe._dispatch_indices(ji.reshape(T * k), E, C)
    _, i = moe.route(tp["router"], tx, cfg)
    _, _, keep = moe._dispatch_indices(i.reshape(T * k), E, C)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert 0 < int((~keep).sum()) < T * k
    assert_close(moe.moe_mlp(tp, tx, cfg), jax_moe.moe_mlp(jp, jx, jcfg),
                 "float32")


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b"])
def test_no_drops_equals_dense_oracle(arch):
    """With ample capacity the sort-based dispatch equals the dense
    oracle, on each side and across them."""
    jcfg, cfg, jp, tp, jx, tx = setup(arch, "float32", 64, 1,
                                      moe_capacity_factor=8.0)
    out = moe.moe_mlp(tp, tx, cfg)
    dense = moe.moe_dense_reference(tp, tx, cfg)
    np.testing.assert_allclose(out.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert_close(dense, jax_moe.moe_dense_reference(jp, jx, jcfg), "float32")
    assert_close(out, jax_moe.moe_mlp(jp, jx, jcfg), "float32")


def test_init_moe_shapes_and_router_dtype():
    cfg = get_config("qwen3-moe-30b-a3b").reduced()
    p = moe.init_moe(torch.Generator().manual_seed(0), cfg, torch.bfloat16,
                     "cpu")
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert p["router"].shape == (d, E) and p["router"].dtype == torch.float32
    assert p["w_gate"].shape == p["w_up"].shape == (E, d, f)
    assert p["w_down"].shape == (E, f, d)
    assert p["w_gate"].dtype == torch.bfloat16
