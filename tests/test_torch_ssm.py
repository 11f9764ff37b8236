"""The port's xLSTM cells (``repro_torch.models.ssm``) against the JAX
package's (``repro.models.ssm``), on the CPU, on ``xlstm-350m.reduced()``
(d 64, 4 heads: mLSTM inner 128 with dh 32, sLSTM dh 16).

The JAX cells' random-init parameters go to the port as numpy arrays;
inputs and states are made from numpy with a seed.  Tolerances, each
relative to the largest magnitude of the reference's output: 1e-5 for
one f32 recurrence step, 1e-4 for whole blocks in float32 (sequences,
and 32 decode steps after them), and 2e-2 for the blocks in bfloat16,
where both sides round the same products to bfloat16 (the tolerance
``tests/test_torch_models.py`` gives a bfloat16 cache).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jax_ssm
from repro_torch.configs import get_config
from repro_torch.models import ssm
from repro_torch.models.transformer import tensors_from_numpy

STEP_TOL = 1e-5
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
CELLS = {"mlstm": (jax_ssm.init_mlstm_block, jax_ssm.mlstm_state,
                   jax_ssm.mlstm_block, ssm.mlstm_block),
         "slstm": (jax_ssm.init_slstm_block, jax_ssm.slstm_state,
                   jax_ssm.slstm_block, ssm.slstm_block)}


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(out, want, tol: float, what: str = "") -> None:
    a, b = as_np(out), as_np(want)
    assert a.shape == b.shape, what
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def draw(seed: int, *shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape) \
        .astype(np.float32)


def setup(cell: str, dtype: str = "float32", seed: int = 0):
    """Both configs, the JAX cell params and their torch copies."""
    jcfg = jax_get_config("xlstm-350m").reduced(dtype=dtype)
    cfg = get_config("xlstm-350m").reduced(dtype=dtype)
    jp = CELLS[cell][0](jax.random.PRNGKey(seed), jcfg, getattr(jnp, dtype))
    return jcfg, cfg, jp, tensors_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


def torch_state(st) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in st.items()}


def test_fresh_states_match():
    for cell, port_state in (("mlstm", ssm.mlstm_state),
                             ("slstm", ssm.slstm_state)):
        jcfg, cfg, _, _ = setup(cell)
        want = CELLS[cell][1](3, jcfg)
        got = port_state(3, cfg, "cpu")
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(as_np(got[k]), as_np(want[k]))


def test_mlstm_step():
    """Three steps from zeros (m at −1e30: the first step's forget gate
    is exp(−inf) = 0), each on the state the step before left."""
    _, cfg, _, _ = setup("mlstm")
    B, H, dh = 2, 4, 32
    jst = jax_ssm.mlstm_state(B, cfg)
    st = torch_state(jst)
    for t in range(3):
        q, k, v = (draw(10 * t + i, B, H, dh) for i in range(3))
        i_pre, f_pre = draw(10 * t + 3, B, H), draw(10 * t + 4, B, H)
        jst, jh = jax.jit(jax_ssm._mlstm_step)(
            jst, tuple(map(jnp.asarray, (q, k, v, i_pre, f_pre))))
        f = torch.from_numpy(f_pre)
        st, h = ssm._mlstm_step(
            st, *map(torch.from_numpy, (q, k, v, i_pre)),
            -ssm.softplus(-f))
        assert_close(h, jh, STEP_TOL, f"step {t} h")
        for name in ("C", "n", "m"):
            assert_close(st[name], jst[name], STEP_TOL, f"step {t} {name}")


def test_slstm_step():
    jcfg, cfg, jp, tp = setup("slstm")
    B, d = 2, cfg.d_model
    jst = jax_ssm.slstm_state(B, jcfg)
    st = torch_state(jst)
    for t in range(3):
        x = draw(t, B, d)
        jst, jh = jax.jit(jax_ssm._slstm_step)(jp, jst, jnp.asarray(x))
        inp = {g: torch.einsum("bd,dhk->bhk", torch.from_numpy(x),
                               tp[f"w_{g}"]) for g in "zifo"}
        st, h = ssm._slstm_step(tp, st, inp)
        assert_close(h, jh, STEP_TOL, f"step {t} h")
        for name in ("c", "n", "h", "m"):
            assert_close(st[name], jst[name], STEP_TOL, f"step {t} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_block_then_decode(cell, dtype):
    """A 12-token block from a non-zero state (one 5-token block from
    zeros before it), then 32 one-token blocks (the decode path), all on
    the same seeded inputs: every output in the input dtype, every
    state."""
    jcfg, cfg, jp, tp = setup(cell, dtype, seed=1)
    jblock = jax.jit(CELLS[cell][2])
    port_block = CELLS[cell][3]
    tol = TOL[dtype]
    jst = CELLS[cell][1](2, jcfg)
    st = torch_state(jst)
    for S in (5, 12):
        x = draw(S, 2, S, cfg.d_model)
        jy, jst = jblock(jp, jnp.asarray(x).astype(dtype), jst)
        y, st = port_block(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                           st)
        assert y.dtype == getattr(torch, dtype)
        assert_close(y, jy, tol, f"block of {S}")
    for t in range(32):
        x = draw(100 + t, 2, 1, cfg.d_model)
        jy, jst = jblock(jp, jnp.asarray(x).astype(dtype), jst)
        y, st = port_block(tp, torch.from_numpy(x).to(getattr(torch, dtype)),
                           st)
        assert_close(y, jy, tol, f"step {t}")
        for name in jst:
            assert st[name].dtype == torch.float32
            assert_close(st[name], jst[name], tol, f"step {t} {name}")


def test_mlstm_sequence_returns_the_input_dtype():
    _, cfg, jp, tp = setup("mlstm", "bfloat16")
    x = draw(0, 2, 6, 128)
    jst = jax_ssm.mlstm_state(2, cfg)
    jh, _ = jax.jit(jax_ssm.mlstm_sequence)(
        jp, jnp.asarray(x).astype(jnp.bfloat16), jst)
    h, _ = ssm.mlstm_sequence(tp, torch.from_numpy(x).bfloat16(),
                              torch_state(jst))
    assert h.dtype == torch.bfloat16 and jh.dtype == jnp.bfloat16
    assert_close(h, jh, TOL["bfloat16"])
