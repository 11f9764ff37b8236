"""The port's control tick against the JAX one, compared live.

``repro_torch.core.control_plane.control_tick`` must be bit-for-bit
equal to ``repro.core.control_plane.control_tick`` on the CPU: the same
seeded states go through both and every output word is compared as
raw bits.  The comparison is never against frozen constants, because
whether XLA fuses the tick's multiply-adds is the compiler's choice and
can change with the JAX version.  The scalar oracle ``reference_tick``
is imported from the reference package.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import control_plane as J
from repro.core.types import PriorityCoefficients, ServiceClass
from repro_torch.core import control_plane as T

FIELDS = [f.name for f in dataclasses.fields(J.ControlState)]


def seeded(seed: int, n: int):
    """Columns of a mixed-class state, the tick's measurement inputs,
    capacity and ℓ̄*, as numpy arrays (the shared input of both sides)."""
    r = np.random.default_rng(seed)
    cols = dict(
        class_code=r.integers(0, 5, n).astype(np.int32),
        bound=r.random(n) < 0.85,
        baseline_tps=(r.random(n) * 400
                      * (r.random(n) < 0.8)).astype(np.float32),
        baseline_kv=(r.random(n) * 1e9
                     * (r.random(n) < 0.5)).astype(np.float32),
        baseline_conc=r.integers(0, 16, n).astype(np.float32),
        slo_ms=(50 + r.random(n) * 30000).astype(np.float32),
        burst=(r.random(n) * 3 * (r.random(n) < 0.5)).astype(np.float32),
        debt=((r.random(n) - 0.3) * 2
              * (r.random(n) < 0.6)).astype(np.float32))
    ins = [(r.random(n) * 500 * (r.random(n) < 0.7)).astype(np.float32),
           (r.random(n) * 2e9 * (r.random(n) < 0.5)).astype(np.float32),
           r.integers(0, 20, n).astype(np.float32),
           (r.random(n) * 800 * (r.random(n) < 0.8)).astype(np.float32)]
    # capacity from scarce (emergency scaling) to ample (backfill)
    cap = np.float32(r.choice([0.05, 0.5, 2.0]) * r.random() * 400 * n)
    slo = np.float32(100 + r.random() * 5000)
    return cols, ins, cap, slo


def jax_tick(cols, ins, cap, slo, coeff=PriorityCoefficients()):
    st = J.ControlState(**{k: jnp.asarray(v) for k, v in cols.items()})
    new, alloc, w = J.control_tick(
        st, jnp.float32(cap), *(jnp.asarray(x) for x in ins),
        jnp.float32(slo), coeff=coeff)
    return ({k: np.asarray(getattr(new, k)) for k in FIELDS},
            np.asarray(alloc), np.asarray(w))


def torch_tick(cols, ins, cap, slo, coeff=PriorityCoefficients()):
    st = T.ControlState(**{k: torch.from_numpy(v.copy())
                           for k, v in cols.items()})
    new, alloc, w = T.control_tick(
        st, torch.tensor(cap), *(torch.from_numpy(x) for x in ins),
        torch.tensor(slo), coeff=coeff)
    return ({k: getattr(new, k).numpy() for k in FIELDS},
            alloc.numpy(), w.numpy())


def assert_bitwise(a: np.ndarray, b: np.ndarray, what: str) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        bad = np.flatnonzero(a.view(np.uint32) != b.view(np.uint32))
    else:
        bad = np.flatnonzero(a != b)
    assert bad.size == 0, (f"{what}: {bad.size} words differ, first at "
                           f"row {bad[0]}: jax {a[bad[0]]!r} vs torch "
                           f"{b[bad[0]]!r}")


def assert_tick_equal(jo, to) -> None:
    for k in FIELDS:
        assert_bitwise(jo[0][k], to[0][k], k)
    assert_bitwise(jo[1], to[1], "allocations")
    assert_bitwise(jo[2], to[2], "priority weights")


# tolerance: none — every f32 word of state, allocation and weight must
# carry the same bits
@pytest.mark.parametrize("n", [8, 64, 100, 512, 3000, 4096])
@pytest.mark.parametrize("seed", range(4))
def test_control_tick_bitwise(n, seed):
    cols, ins, cap, slo = seeded(seed, n)
    assert_tick_equal(jax_tick(cols, ins, cap, slo),
                      torch_tick(cols, ins, cap, slo))


def test_multi_tick_chain_bitwise():
    """Eight ticks in a row, each side fed its own previous output: the
    EWMA state never drifts by a bit."""
    cols, ins, cap, slo = seeded(11, 1024)
    jcols, tcols = dict(cols), dict(cols)
    r = np.random.default_rng(5)
    for _ in range(8):
        jo = jax_tick(jcols, ins, cap, slo)
        to = torch_tick(tcols, ins, cap, slo)
        assert_tick_equal(jo, to)
        jcols, tcols = jo[0], to[0]
        ins = [x * np.float32(0.5 + r.random()) for x in ins]


def test_nondefault_coefficients_bitwise():
    coeff = PriorityCoefficients(alpha_slo=0.7, alpha_burst=2.5,
                                 alpha_debt=3.0, gamma_burst=0.6,
                                 gamma_debt=0.95)
    cols, ins, cap, slo = seeded(3, 777)
    assert_tick_equal(jax_tick(cols, ins, cap, slo, coeff),
                      torch_tick(cols, ins, cap, slo, coeff))


@pytest.mark.parametrize("seed", range(3))
def test_matches_scalar_oracle(seed):
    """Against the reference's pure-Python ``reference_tick``, at the
    tolerance ``tests/test_control_plane.py`` holds the JAX tick to
    (rel 2e-3, abs 1e-2: the oracle sums in f64 and in another order)."""
    cols, ins, cap, slo = seeded(seed, 48)
    classes = {v: k for k, v in J.CLASS_CODES.items()}
    rows = [J.OracleRow(
        service_class=classes[int(cols["class_code"][i])],
        bound=bool(cols["bound"][i]),
        baseline_tps=float(cols["baseline_tps"][i]),
        baseline_kv=float(cols["baseline_kv"][i]),
        baseline_conc=float(cols["baseline_conc"][i]),
        slo_ms=float(cols["slo_ms"][i]), burst=float(cols["burst"][i]),
        debt=float(cols["debt"][i]), measured_tps=float(ins[0][i]),
        used_kv=float(ins[1][i]), used_conc=float(ins[2][i]),
        demand_tps=float(ins[3][i])) for i in range(48)]
    o_rows, o_alloc, o_w = J.reference_tick(rows, float(cap), float(slo))
    new, alloc, w = torch_tick(cols, ins, cap, slo)
    np.testing.assert_allclose(alloc, o_alloc, rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(w, o_w, rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(new["debt"], [r.debt for r in o_rows],
                               rtol=2e-3, atol=1e-2)
    np.testing.assert_allclose(new["burst"], [r.burst for r in o_rows],
                               rtol=2e-3, atol=1e-2)


def test_class_tables_match_reference():
    assert T.CLASS_CODES == {ServiceClass(k.value): v
                             for k, v in J.CLASS_CODES.items()}
    np.testing.assert_array_equal(np.float32(T.CLASS_W), J.CLASS_W)
    for name in ("PROTECTED_MASK", "BURSTOK_MASK", "DEBTOK_MASK",
                 "ELASTIC_MASK"):
        assert list(getattr(T, name)) == \
            np.asarray(getattr(J, name)).tolist(), name


@pytest.mark.parametrize("n", [1, 3, 8, 9, 1000, 4097])
def test_padding_helpers_match_reference(n):
    assert T.bucket_width(n) == J.bucket_width(n)
    assert T.quantum_width(n * 3) == J.quantum_width(n * 3)
    x = np.arange(n, dtype=np.float32)
    w = T.bucket_width(n)
    np.testing.assert_array_equal(
        T.pad_rows(torch.from_numpy(x), w, 7).numpy(),
        np.asarray(J.pad_rows(jnp.asarray(x), w, 7)))
    r = np.random.default_rng(n)
    v = r.random(n).astype(np.float32)
    assert_bitwise(np.asarray(J.tree_sum(jnp.asarray(v))),
                   T.tree_sum(torch.from_numpy(v)).numpy(), "tree_sum")
    assert bool(J.tree_any(jnp.asarray(v > 0.5))) == \
        bool(T.tree_any(torch.from_numpy(v > 0.5)))
