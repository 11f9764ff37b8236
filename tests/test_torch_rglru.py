"""The port's RG-LRU block (``repro_torch.models.rglru``) against the JAX
package's (``repro.models.rglru``), on the CPU, on
``recurrentgemma-2b.reduced()`` (d = d_rnn = 64, conv width 4).

The JAX block's random-init parameters go to the port as numpy arrays;
inputs and states are made from numpy with a seed.  Tolerances, each
relative to the largest magnitude of the reference's output:

* 1e-5 for the f32 recurrence (``rglru_sequence``, the doubling scan
  against ``lax.associative_scan``: the two combine in different trees,
  so they agree to rounding, not bit for bit), the gates and the conv;
* 1e-4 for the whole block and its decode steps, in float32 (as
  ``tests/test_torch_models.py`` holds logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import rglru as jax_rglru
from repro_torch.configs import get_config
from repro_torch.models import layers, rglru
from repro_torch.models.transformer import tensors_from_numpy

SCAN_TOL, BLOCK_TOL = 1e-5, 1e-4


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(out, want, tol: float, what: str = "") -> None:
    a, b = as_np(out), as_np(want)
    assert a.shape == b.shape, what
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def setup(seed: int = 0):
    """Both configs, the JAX block params and their torch copies."""
    jcfg = jax_get_config("recurrentgemma-2b").reduced(dtype="float32")
    cfg = get_config("recurrentgemma-2b").reduced(dtype="float32")
    jp = jax_rglru.init_rglru_block(jax.random.PRNGKey(seed), jcfg,
                                    jnp.float32)
    return cfg, jp, tensors_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def draw(seed: int, *shape, scale: float = 1.0) -> np.ndarray:
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def state(cfg, seed: int, B: int):
    """A non-zero state (h, conv), as numpy."""
    dr = cfg.rnn_width
    return {"h": draw(seed, B, dr), "conv": draw(seed + 1, B, 3, dr)}


def test_softplus_and_sinusoids_match_jax():
    x = np.linspace(-40, 40, 801, dtype=np.float32)
    assert_close(layers.softplus(torch.from_numpy(x)),
                 jax.nn.softplus(jnp.asarray(x)), 1e-6, "softplus")
    pos = np.arange(300)
    assert_close(layers.sinusoidal_positions(torch.from_numpy(pos), 64),
                 jax_layers.sinusoidal_positions(300, 64), 1e-5,
                 "sinusoidal_positions")


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_scan_matches_associative_scan(S):
    """``rglru_sequence`` from a non-zero h0, at lengths below, at and
    past powers of two."""
    cfg, jp, tp = setup()
    x = draw(S, 2, S, cfg.rnn_width)
    h0 = draw(S + 1, 2, cfg.rnn_width)
    jh, jlast = jax.jit(jax_rglru.rglru_sequence)(jp, jnp.asarray(x),
                                                  jnp.asarray(h0))
    h, last = rglru.rglru_sequence(tp, torch.from_numpy(x),
                                   torch.from_numpy(h0))
    assert_close(h, jh, SCAN_TOL, "h")
    assert_close(last, jlast, SCAN_TOL, "h_last")
    ja, jb = jax.jit(jax_rglru._gates)(jp, jnp.asarray(x))
    a, b = rglru._gates(tp, torch.from_numpy(x))
    assert_close(a, ja, SCAN_TOL, "a")
    assert_close(b, jb, SCAN_TOL, "b")


@pytest.mark.parametrize("carry", [False, True])
def test_causal_conv(carry):
    cfg, jp, tp = setup()
    x = draw(3, 2, 9, cfg.rnn_width)
    c = draw(4, 2, 3, cfg.rnn_width) if carry else None
    want = jax_rglru._causal_conv(jp, jnp.asarray(x),
                                  None if c is None else jnp.asarray(c))
    got = rglru._causal_conv(tp, torch.from_numpy(x),
                             None if c is None else torch.from_numpy(c))
    assert_close(got, want, SCAN_TOL)


@pytest.mark.parametrize("S", [1, 2, 3, 17])
def test_block_and_its_conv_state(S):
    """Prompts shorter than W−1 = 3 tokens put the old conv state in
    front of the new rows; longer ones keep their own last 3."""
    cfg, jp, tp = setup()
    x = draw(S, 2, S, cfg.d_model)
    st = state(cfg, 7, 2)
    jy, jst = jax.jit(jax_rglru.rglru_block)(jp, jnp.asarray(x),
                                             jax.tree.map(jnp.asarray, st))
    y, new = rglru.rglru_block(tp, torch.from_numpy(x),
                               {k: torch.from_numpy(v)
                                for k, v in st.items()})
    assert_close(y, jy, BLOCK_TOL, "block output")
    assert_close(new["h"], jst["h"], BLOCK_TOL, "h")
    np.testing.assert_array_equal(as_np(new["conv"])[:, :max(0, 3 - S)],
                                  st["conv"][:, S:])
    assert_close(new["conv"], jst["conv"], BLOCK_TOL, "conv")


def test_decode_steps_after_prefill():
    """A 20-token block from zeros, then 32 decode steps each fed the
    previous output: every output and state."""
    cfg, jp, tp = setup(1)
    x = draw(5, 2, 20, cfg.d_model)
    zero = {k: np.zeros_like(v) for k, v in state(cfg, 0, 2).items()}
    jy, jst = jax.jit(jax_rglru.rglru_block)(
        jp, jnp.asarray(x), jax.tree.map(jnp.asarray, zero))
    y, st = rglru.rglru_block(tp, torch.from_numpy(x),
                              {k: torch.from_numpy(v)
                               for k, v in zero.items()})
    step = jax.jit(jax_rglru.rglru_decode_step)
    jx, tx = jy[:, -1:], y[:, -1:]
    for t in range(32):
        jx, jst = step(jp, jx, jst)
        tx, st = rglru.rglru_decode_step(tp, tx, st)
        assert_close(tx, jx, BLOCK_TOL, f"step {t}")
        for k in ("h", "conv"):
            assert_close(st[k], jst[k], BLOCK_TOL, f"step {t} {k}")
