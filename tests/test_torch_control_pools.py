"""The port's batched multi-pool tick against the reference's, on the CPU.

``repro_torch.core.control_plane.control_tick_pools`` writes the pool
axis out where the reference ``vmap``s the tick body; its water-fill
runs while any pool is active and freezes the pools that are done.
Seeded fleets of P ∈ {1, 3, 8} pools with ragged row counts are
padded and stacked by both packages (``pad_state``, ``stack_states``)
and ticked by both; every word of state, allocation and weight must
carry the same bits.  The scalar oracle ``reference_tick`` and the
compact ``TokenPool.begin_tick``/``apply_tick`` halves are held
against the reference too.  Compared live, never against frozen
constants (XLA's fusion choices can change with the JAX version).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import control_plane as JC
from repro.core.types import PriorityCoefficients
from repro_torch.core import control_plane as TC

FIELDS = [f.name for f in dataclasses.fields(JC.ControlState)]


def seeded_pool(r, n: int):
    """Columns of a mixed-class state and the tick's inputs for one pool
    of ``n`` rows, capacity from scarce (emergency scaling) to ample."""
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
    cap = np.float32(r.choice([0.05, 0.5, 2.0]) * r.random() * 400 * n)
    slo = np.float32(100 + r.random() * 5000)
    return cols, ins, cap, slo


def fleet(seed: int, p: int):
    """P pools of ragged widths (1 to 300 rows) and the fleet's padded
    tick inputs as numpy, padded to the widest pool's pow2 bucket."""
    r = np.random.default_rng(seed)
    widths = [int(r.integers(1, 300)) for _ in range(p)]
    pools = [seeded_pool(r, n) for n in widths]
    width = JC.bucket_width(max(widths))
    ins = []
    for k in range(4):
        a = np.zeros((p, width), np.float32)
        for i, (_, pi, _, _) in enumerate(pools):
            a[i, :widths[i]] = pi[k]
        ins.append(a)
    caps = np.array([c for _, _, c, _ in pools], np.float32)
    slos = np.array([s for _, _, _, s in pools], np.float32)
    return [c for c, _, _, _ in pools], width, ins, caps, slos


def jax_states(cols_list, width):
    return JC.stack_states(
        [JC.ControlState(**{k: jnp.asarray(v) for k, v in c.items()})
         for c in cols_list], width=width)


def torch_states(cols_list, width):
    return TC.stack_states(
        [TC.ControlState(**{k: torch.from_numpy(v.copy())
                            for k, v in c.items()}) for c in cols_list],
        width=width)


def assert_bitwise(a: np.ndarray, b: np.ndarray, what: str) -> None:
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype == np.float32:
        bad = np.flatnonzero(a.view(np.uint32).ravel()
                             != b.view(np.uint32).ravel())
    else:
        bad = np.flatnonzero(a.ravel() != b.ravel())
    assert bad.size == 0, f"{what}: {bad.size} words differ"


def assert_states_equal(js, ts, what=""):
    for k in FIELDS:
        assert_bitwise(np.asarray(getattr(js, k)),
                       getattr(ts, k).numpy(), f"{what}{k}")


# tolerance: none — every word must carry the same bits
@pytest.mark.parametrize("p", [1, 3, 8])
@pytest.mark.parametrize("seed", range(3))
def test_control_tick_pools_bitwise(p, seed):
    cols_list, width, ins, caps, slos = fleet(seed, p)
    js, ts = jax_states(cols_list, width), torch_states(cols_list, width)
    assert_states_equal(js, ts, "stacked ")
    jn, ja, jw = JC.control_tick_pools(
        js, jnp.asarray(caps), *(jnp.asarray(x) for x in ins),
        jnp.asarray(slos))
    tn, ta, tw = TC.control_tick_pools(
        ts, torch.from_numpy(caps), *(torch.from_numpy(x) for x in ins),
        torch.from_numpy(slos))
    assert_states_equal(jn, tn)
    assert_bitwise(np.asarray(ja), ta.numpy(), "allocations")
    assert_bitwise(np.asarray(jw), tw.numpy(), "priority weights")


def test_control_tick_pools_chain_nondefault_coefficients():
    """Six fleet ticks in a row with the paper's Experiment-2
    coefficients, each side fed its own output."""
    coeff = PriorityCoefficients(alpha_slo=2.0, alpha_burst=1.0,
                                 alpha_debt=4.0, gamma_debt=0.7)
    cols_list, width, ins, caps, slos = fleet(11, 5)
    js, ts = jax_states(cols_list, width), torch_states(cols_list, width)
    for step in range(6):
        js, ja, jw = JC.control_tick_pools(
            js, jnp.asarray(caps), *(jnp.asarray(x) for x in ins),
            jnp.asarray(slos), coeff=coeff)
        ts, ta, tw = TC.control_tick_pools(
            ts, torch.from_numpy(caps), *(torch.from_numpy(x) for x in ins),
            torch.from_numpy(slos), coeff=coeff)
        assert_states_equal(js, ts, f"step {step} ")
        assert_bitwise(np.asarray(ja), ta.numpy(), f"step {step} alloc")
        assert_bitwise(np.asarray(jw), tw.numpy(), f"step {step} weights")


@pytest.mark.parametrize("seed", range(2))
def test_pools_tick_equals_single_pool_ticks(seed):
    """Padding is inert: each pool's rows of the batched tick equal the
    port's single-pool tick of that pool alone."""
    cols_list, width, ins, caps, slos = fleet(20 + seed, 4)
    tn, ta, tw = TC.control_tick_pools(
        torch_states(cols_list, width), torch.from_numpy(caps),
        *(torch.from_numpy(x) for x in ins), torch.from_numpy(slos))
    for i, cols in enumerate(cols_list):
        n = cols["class_code"].shape[0]
        w = JC.bucket_width(n)
        st = TC.pad_state(TC.ControlState(
            **{k: torch.from_numpy(v.copy()) for k, v in cols.items()}), w)
        sn, sa, sw = TC.control_tick(
            st, torch.tensor(caps[i]),
            *(torch.from_numpy(x[i, :w].copy()) for x in ins),
            torch.tensor(slos[i]))
        for k in FIELDS:
            assert_bitwise(getattr(tn, k)[i, :n].numpy(),
                           getattr(sn, k)[:n].numpy(), k)
        assert_bitwise(ta[i, :n].numpy(), sa[:n].numpy(), "alloc")
        assert_bitwise(tw[i, :n].numpy(), sw[:n].numpy(), "weights")


@pytest.mark.parametrize("n,width", [(3, 3), (3, 8), (100, 128), (1, 1)])
def test_pad_state_matches_reference(n, width):
    r = np.random.default_rng(n)
    cols = seeded_pool(r, n)[0]
    js = JC.pad_state(
        JC.ControlState(**{k: jnp.asarray(v) for k, v in cols.items()}),
        width)
    ts = TC.pad_state(
        TC.ControlState(**{k: torch.from_numpy(v.copy())
                           for k, v in cols.items()}), width)
    assert_states_equal(js, ts)


def test_stack_states_default_width_is_widest():
    r = np.random.default_rng(5)
    cols_list = [seeded_pool(r, n)[0] for n in (7, 19, 2)]
    js, ts = jax_states(cols_list, 0), torch_states(cols_list, 0)
    assert ts.class_code.shape == (3, 19)
    assert_states_equal(js, ts)


def oracle_rows(core, seed: int, n: int):
    r = np.random.default_rng(seed)
    classes = list(core.ServiceClass)
    return [core.OracleRow(
        service_class=classes[int(r.integers(0, 5))],
        bound=bool(r.random() < 0.9),
        baseline_tps=float(r.integers(0, 400)),
        baseline_kv=float(r.choice([0.0, 1e6])),
        baseline_conc=float(r.integers(0, 8)),
        slo_ms=float(r.integers(50, 30000)),
        burst=float(r.random() * 2), debt=float(r.random() - 0.3),
        measured_tps=float(r.integers(0, 500)),
        used_kv=float(r.choice([0.0, 5e5, 2e6])),
        used_conc=float(r.integers(0, 10)),
        demand_tps=float(r.integers(0, 800))) for _ in range(n)]


@pytest.mark.parametrize("seed", range(3))
def test_reference_tick_matches_reference(seed):
    """The port's scalar oracle replays the reference's exactly (both
    are float64 Python over the same scalar functions)."""
    jr, ja, jw = J.reference_tick(oracle_rows(J, seed, 40), 3000.0, 2000.0)
    tr, ta, tw = T.reference_tick(oracle_rows(T, seed, 40), 3000.0, 2000.0)
    assert ja == ta and jw == tw
    for a, b in zip(jr, tr):
        assert dataclasses.asdict(a) | {"service_class": None} == \
            dataclasses.asdict(b) | {"service_class": None}
        assert a.service_class.value == b.service_class.value


def test_state_from_rows_matches_reference():
    js = JC.state_from_rows(oracle_rows(J, 4, 17))
    ts = TC.state_from_rows(oracle_rows(T, 4, 17), device="cpu")
    assert_states_equal(js, ts)


def populated_pool(core, seed: int):
    r = np.random.default_rng(seed)
    kw = {"device": "cpu"} if core is T else {}
    pool = core.TokenPool(core.PoolSpec(
        name="p", model="m", scaling=core.ScalingBounds(1, 2),
        per_replica=core.Resources(900.0, 1e12, 8.0)), **kw)
    pool.set_replicas(2)
    classes = list(core.ServiceClass)
    for i in range(13):
        sc = classes[i % 5]
        tps = 0.0 if sc.value in ("spot", "preemptible") else float(
            r.integers(50, 400))
        pool.add_entitlement(core.EntitlementSpec(
            name=f"e{i}", tenant_id=f"e{i}", pool="p",
            qos=core.QoS(sc, float(r.choice([200.0, 2000.0, 30000.0]))),
            baseline=core.Resources(tps, 0.0, float(r.integers(1, 4)))))
        for k in range(int(r.integers(0, 3))):
            rid = f"r{i}-{k}"
            pool.register_admit(core.InFlight(rid, f"e{i}", 0.0, 0.0, 64,
                                              0.0), float(r.integers(50, 300)))
            pool.on_start(rid)
    pool.remove_entitlement("e4")
    return pool


def test_begin_apply_tick_match_reference():
    """The compact gather/scatter halves: begin_tick's inputs, then
    apply_tick of the tick's outputs, give the reference's record."""
    recs = {}
    for core, cp, to_np in ((J, JC, np.asarray),
                            (T, TC, lambda x: x.numpy())):
        pool = populated_pool(core, 3)
        ti = pool.begin_tick(2.0)
        f32 = (jnp.float32 if core is J
               else lambda x: torch.tensor(x, dtype=torch.float32))
        new, alloc, w = cp.control_tick(
            ti.state, f32(ti.capacity_tps), ti.measured_tps, ti.used_kv,
            ti.used_conc, ti.demand_tps, f32(ti.avg_slo_ms))
        rec = pool.apply_tick(2.0, ti.names, to_np(new.burst),
                              to_np(new.debt), to_np(alloc), to_np(w))
        recs[core] = (ti.names, rec.allocations, rec.priorities, rec.debts,
                      rec.bursts, pool.ledger.bucket("e0").rate_tps)
    assert recs[J] == recs[T]
