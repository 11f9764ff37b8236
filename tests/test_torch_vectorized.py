"""The port's batched admission (``repro_torch.core.vectorized``)
against the reference's (``repro.core.vectorized``) on the CPU.

``admit_quantum`` on CPU tensors runs the plain version of the CUDA
kernel; it must give the reference's decisions bit for bit — every
admit bit, every reason code, every priority word — over seeded draws
that reach all five reason codes, padded quanta and non-zero slack.
Each decision-parity regression of ``tests/test_admit_quantum.py`` has
a twin here that builds the same pool in both packages and holds the
port's quantum replay against the port's scalar controller and the
reference's quantum replay.  No tolerance anywhere: decisions are
exact, and the float words are compared as raw bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import control_plane as JC
from repro.core import vectorized as JV
from repro_torch.core import control_plane as TC
from repro_torch.core import vectorized as TV

FIELDS = ("class_code", "bound", "baseline_tps", "baseline_kv",
          "baseline_conc", "slo_ms", "burst", "debt")

#: scalar DenyReason → admit_quantum reason code (0 = admitted)
REASON_TO_CODE = {None: 0, "entitlement_not_bound": 1,
                  "concurrency_limit": 2, "token_budget": 3,
                  "low_priority": 4}


def draw(seed: int, n: int, m: int):
    """A mixed-class pool state, its live columns and a quantum of
    requests (the last few rows padding), tight enough that every
    reason code occurs: a shared numpy input for both packages."""
    r = np.random.default_rng(seed)
    cols = dict(
        class_code=r.integers(0, 5, n).astype(np.int32),
        bound=r.random(n) < 0.9,
        baseline_tps=(r.random(n) * 400).astype(np.float32),
        baseline_kv=(r.random(n) * 1e6 * (r.random(n) < 0.5))
        .astype(np.float32),
        baseline_conc=r.integers(0, 4, n).astype(np.float32),
        slo_ms=(50 + r.random(n) * 30000).astype(np.float32),
        burst=(r.random(n) * 2 * (r.random(n) < 0.5)).astype(np.float32),
        debt=((r.random(n) - 0.3) * (r.random(n) < 0.6)).astype(np.float32))
    live_cols = dict(
        bucket_level=(r.random(n) * 300).astype(np.float32),
        in_flight=r.integers(0, 4, n).astype(np.int32),
        kv_in_use=(r.random(n) * 5e5).astype(np.float32))
    tokens = r.integers(10, 200, m).astype(np.float32)
    reqs = dict(
        req_ent=r.integers(0, n, m).astype(np.int32),
        req_tokens=tokens,
        req_kv=(tokens * r.choice([0.0, 1000.0], m)).astype(np.float32),
        req_live=np.arange(m) < m - int(r.integers(0, 5)))
    cap = float(r.integers(8, 64))
    scalars = dict(
        # contended from the start, or two admits short of it
        pool_in_flight=int(cap + r.integers(1, cap) if seed % 4
                           else cap - 2),
        pool_conc_cap=cap,
        running_min_priority=float(np.float32(5 + r.random() * 55)),
        pool_avg_slo=float(np.float32(100 + r.random() * 5000)),
        pool_resident=int(r.integers(0, 2 * cap)))
    return cols, live_cols, reqs, scalars


def jax_admit(cols, live_cols, reqs, scalars, slack=0.0, weights=True):
    st = JC.ControlState(**{k: jnp.asarray(v) for k, v in cols.items()})
    w = None
    if weights:
        w = JC.priority_rows(st, jnp.float32(scalars["pool_avg_slo"]),
                             J.PriorityCoefficients())
    out = JV.admit_quantum(
        st, *(jnp.asarray(v) for v in live_cols.values()),
        pool_in_flight=jnp.int32(scalars["pool_in_flight"]),
        pool_conc_cap=jnp.float32(scalars["pool_conc_cap"]),
        running_min_priority=jnp.float32(scalars["running_min_priority"]),
        pool_avg_slo=jnp.float32(scalars["pool_avg_slo"]),
        **{k: jnp.asarray(v) for k, v in reqs.items()},
        pool_resident=jnp.int32(scalars["pool_resident"]),
        weights=w, slack=slack)
    return [np.asarray(x) for x in out]


def torch_admit(cols, live_cols, reqs, scalars, slack=0.0, weights=True):
    st = TC.ControlState(**{k: torch.from_numpy(v.copy())
                            for k, v in cols.items()})
    w = None
    if weights:
        w = TC.priority_rows(
            st, torch.tensor(scalars["pool_avg_slo"], dtype=torch.float32),
            T.PriorityCoefficients())
    out = TV.admit_quantum(
        st, *(torch.from_numpy(v.copy()) for v in live_cols.values()),
        **scalars, **{k: torch.from_numpy(v.copy()) for k, v in reqs.items()},
        weights=w, slack=slack)
    return [x.numpy() for x in out]


def assert_same_decisions(ref, port):
    for name, a, b in zip(("admitted", "reason", "priority"), ref, port):
        assert a.shape == b.shape, name
        if a.dtype == np.float32:
            assert b.dtype == np.float32, name
            bad = np.flatnonzero(a.view(np.uint32) != b.view(np.uint32))
        else:
            bad = np.flatnonzero(a != b)
        assert bad.size == 0, (f"{name}: {bad.size} of {a.size} differ, "
                               f"first at {bad[0]}: {a[bad[0]]} vs "
                               f"{b[bad[0]]}")


# 24 seeds over two row widths, two quantum widths and two slacks
@pytest.mark.parametrize("seed", range(24))
def test_admit_quantum_bitwise(seed):
    n = (64, 512)[seed % 2]
    m = (256, 640)[(seed // 2) % 2]
    slack = (0.0, 0.15)[(seed // 4) % 2]
    inputs = draw(seed, n, m)
    ref = jax_admit(*inputs, slack=slack)
    port = torch_admit(*inputs, slack=slack)
    assert_same_decisions(ref, port)
    # the draw reaches every reason code (low priority needs contention
    # before the quantum's first low-weight admit lowers the threshold)
    codes = set(np.unique(ref[1]).tolist())
    assert codes == ({0, 1, 2, 3, 4} if seed % 4 else {0, 1, 2, 3} | codes)


@pytest.mark.parametrize("seed", range(3))
def test_admit_quantum_recomputed_weights_bitwise(seed):
    """Without ``weights`` both sides recompute Eq. 1 themselves."""
    inputs = draw(100 + seed, 64, 256)
    assert_same_decisions(jax_admit(*inputs, weights=False),
                          torch_admit(*inputs, weights=False))


def test_admit_quantum_does_not_write_inputs():
    cols, live_cols, reqs, scalars = draw(7, 64, 256)
    held = {k: v.copy() for k, v in live_cols.items()}
    torch_admit(cols, live_cols, reqs, scalars)
    for k, v in held.items():
        assert np.array_equal(live_cols[k], v), k


# -- twins of the decision-parity regressions (tests/test_admit_quantum.py)

def mkpool(core, pool_conc=3.0, slack=0.0, pool_tps=1000.0):
    kw = {"device": "cpu"} if core is T else {}
    spec = core.PoolSpec(name="p", model="m",
                         scaling=core.ScalingBounds(1, 1),
                         per_replica=core.Resources(pool_tps,
                                                    float(1 << 40),
                                                    pool_conc),
                         default_max_tokens=64, admission_slack=slack,
                         bucket_window_s=1.0)
    return core.TokenPool(spec, **kw)


def qent(core, name, klass, tps, conc, slo, kv=0.0):
    return core.EntitlementSpec(
        name=name, tenant_id=name, pool="p",
        qos=core.QoS(service_class=getattr(core.ServiceClass, klass),
                     slo_target_ms=slo),
        baseline=core.Resources(tps, kv, conc))


def seed_inflight(core, pool, name, queued, resident):
    """Pre-existing requests with junk (0.0) record priorities: the
    threshold must come from LIVE priorities."""
    for k in range(queued + resident):
        rid = f"bg-{name}-{k}"
        pool.register_admit(core.InFlight(rid, name, 0.0, 0.0, 64, 0.0),
                            64.0)
        if k < resident:
            pool.on_start(rid)


def quantum_vs_scalar(core, pool, reqs, slack=0.0):
    """(quantum replay on a snapshot, sequential scalar decides on the
    live pool) as lists of (admitted, reason code)."""
    if core is T:
        snap = TV.quantum_snapshot(pool, 0.0)
        vec = torch.from_numpy
        kernel = TV.admit_quantum
    else:
        snap = JV.quantum_snapshot(pool, 0.0)
        vec = jnp.asarray
        kernel = JV.admit_quantum
    rows, toks, kvs = [], [], []
    for name, n_in, n_out, kv_bpt in reqs:
        rows.append(snap.row_of[name])
        toks.append(float(n_in + n_out))
        kvs.append(float(n_in + n_out) * kv_bpt)
    scal = (dict(pool_in_flight=jnp.int32(snap.pool_in_flight),
                 pool_conc_cap=jnp.float32(snap.pool_conc_cap),
                 running_min_priority=jnp.float32(snap.running_min_priority),
                 pool_avg_slo=jnp.float32(snap.pool_avg_slo),
                 pool_resident=jnp.int32(snap.pool_resident))
            if core is J else
            dict(pool_in_flight=snap.pool_in_flight,
                 pool_conc_cap=snap.pool_conc_cap,
                 running_min_priority=snap.running_min_priority,
                 pool_avg_slo=snap.pool_avg_slo,
                 pool_resident=snap.pool_resident))
    admitted, reason, _ = kernel(
        snap.state, snap.bucket_level, snap.in_flight, snap.kv_in_use,
        req_ent=vec(np.asarray(rows, np.int32)),
        req_tokens=vec(np.asarray(toks, np.float32)),
        req_kv=vec(np.asarray(kvs, np.float32)),
        weights=snap.weights, coeff=pool.spec.coefficients, slack=slack,
        **scal)
    quantum = list(zip((bool(a) for a in np.asarray(admitted)),
                       (int(r) for r in np.asarray(reason))))
    ac = core.AdmissionController(pool)
    scalar = []
    for i, (name, n_in, n_out, kv_bpt) in enumerate(reqs):
        d = ac.decide(core.AdmissionRequest(
            entitlement=name, input_tokens=n_in, max_tokens=n_out,
            arrival_s=0.0, request_id=f"r{i}", kv_bytes_per_token=kv_bpt))
        scalar.append((d.admitted, REASON_TO_CODE[
            d.reason.value if d.reason else None]))
    return quantum, scalar


def both(setup, reqs, slack=0.0, **pool_kw):
    """Run ``setup(core, pool)`` and the quantum in both packages;
    returns (port quantum, port scalar, reference quantum)."""
    out = {}
    for core in (J, T):
        pool = mkpool(core, slack=slack, **pool_kw)
        setup(core, pool)
        out[core] = quantum_vs_scalar(core, pool, reqs, slack)
    return out[T][0], out[T][1], out[J][0]


def test_matches_scalar_controller():
    def setup(core, pool):
        pool.add_entitlement(qent(core, "a", "GUARANTEED", 500.0, 2, 200.0))
        pool.add_entitlement(qent(core, "b", "ELASTIC", 300.0, 2, 1000.0))
        pool.add_entitlement(qent(core, "c", "SPOT", 0.0, 2, 30000.0))
        pool.ledger.set_rate("c", 100.0, 0.0)
        pool.ledger.bucket("c").level = 400.0
    reqs = [("abc"[i % 3], 64, 64, 0.0) for i in range(8)]
    port, scalar, ref = both(setup, reqs, pool_conc=3.0)
    assert port == scalar == ref


def test_burst_class_over_re_admitted_with_free_slots():
    def setup(core, pool):
        pool.add_entitlement(qent(core, "el", "ELASTIC", 400.0, 2, 1000.0))
        seed_inflight(core, pool, "el", queued=0, resident=2)
        assert pool.has_free_slots() and not pool.contended()
    port, scalar, ref = both(setup, [("el", 32, 32, 0.0)], pool_conc=8.0)
    assert scalar == [(True, 0)]
    assert port == scalar == ref


def test_guaranteed_over_re_still_denied():
    def setup(core, pool):
        pool.add_entitlement(qent(core, "g", "GUARANTEED", 400.0, 2, 200.0))
        seed_inflight(core, pool, "g", queued=0, resident=2)
    port, scalar, ref = both(setup, [("g", 32, 32, 0.0)], pool_conc=8.0)
    assert scalar == [(False, 2)]
    assert port == scalar == ref


def test_burst_escape_closed_when_contended():
    def setup(core, pool):
        pool.add_entitlement(qent(core, "el", "ELASTIC", 400.0, 1, 1000.0))
        pool.add_entitlement(qent(core, "sp", "SPOT", 0.0, 0.0, 30000.0))
        pool.ledger.set_rate("sp", 400.0, 0.0)
        seed_inflight(core, pool, "el", queued=0, resident=1)
        seed_inflight(core, pool, "sp", queued=3, resident=2)
        assert pool.has_free_slots() and pool.contended()
    port, scalar, ref = both(setup, [("el", 32, 32, 0.0)], pool_conc=4.0)
    assert scalar == [(False, 2)]
    assert port == scalar == ref


def test_running_min_seeded_from_live_priorities():
    def setup(core, pool):
        pool.add_entitlement(qent(core, "el", "ELASTIC", 0.0, 0.0, 1000.0))
        pool.add_entitlement(qent(core, "sp", "SPOT", 0.0, 0.0, 30000.0))
        for name in ("el", "sp"):
            pool.ledger.set_rate(name, 400.0, 0.0)
            pool.ledger.bucket(name).level = 400.0
        seed_inflight(core, pool, "sp", queued=3, resident=0)
        assert pool.contended()
    pool = mkpool(T, pool_conc=2.0)
    setup(T, pool)
    snap = TV.quantum_snapshot(pool, 0.0)
    assert snap.running_min_priority == pytest.approx(pool.priority("sp"))
    port, scalar, ref = both(setup, [("el", 32, 32, 0.0),
                                     ("sp", 32, 32, 0.0)], pool_conc=2.0)
    assert scalar == [(True, 0), (False, 4)]
    assert port == scalar == ref


def test_snapshot_does_not_mutate_pool():
    pool = mkpool(T)
    pool.add_entitlement(qent(T, "a", "ELASTIC", 100.0, 2, 1000.0), now=5.0)
    bucket = pool.ledger.bucket("a")
    bucket.level = 20.0
    _, levels, _, _ = TV.arrays_from_pool(pool, now=5.5)
    assert float(levels[0]) == pytest.approx(70.0)
    assert (bucket.level, bucket.last_refill_s) == (20.0, 5.0)
    pool.ledger.drop("a")
    _, levels2, _, _ = TV.arrays_from_pool(pool, now=5.5)
    assert float(levels2[0]) == pytest.approx(100.0)
    with pytest.raises(KeyError):
        pool.ledger.bucket("a")


def test_admission_slack_threading():
    def setup(core, pool):
        for name in ("s1", "s2"):
            pool.add_entitlement(qent(core, name, "SPOT", 0.0, 0.0, 30000.0))
            pool.ledger.set_rate(name, 400.0, 0.0)
            pool.ledger.bucket(name).level = 400.0
        seed_inflight(core, pool, "s1", queued=3, resident=0)
        assert pool.contended()
    port, scalar, ref = both(setup, [("s2", 32, 32, 0.0)], slack=0.5,
                             pool_conc=2.0)
    assert scalar == [(True, 0)]
    assert port == scalar == ref


def test_padding_rows_are_inert():
    """req_live=False rows charge nothing, count nothing and leave the
    threshold alone — and their reasons equal the reference's."""
    outs = []
    for core, mod, vec in ((J, JV, jnp.asarray), (T, TV, torch.from_numpy)):
        pool = mkpool(core, pool_conc=4.0)
        pool.add_entitlement(qent(core, "a", "ELASTIC", 100.0, 4, 1000.0))
        snap = mod.quantum_snapshot(pool, 0.0)
        live = np.array([True, False, False, False])
        for level_shift, tok, infl in ((0.0, 60.0, 0), (60.0, 30.0, 1)):
            admitted, reason, prio = mod.admit_quantum(
                snap.state, snap.bucket_level - level_shift,
                snap.in_flight, snap.kv_in_use,
                pool_in_flight=infl, pool_conc_cap=4.0,
                running_min_priority=np.float32(np.inf),
                pool_avg_slo=np.float32(snap.pool_avg_slo),
                req_ent=vec(np.zeros(4, np.int32)),
                req_tokens=vec(np.full(4, tok, np.float32)),
                req_kv=vec(np.zeros(4, np.float32)),
                pool_resident=0, req_live=vec(live))
            outs.append([np.asarray(x) for x in (admitted, reason, prio)])
    ref, port = outs[:2], outs[2:]
    assert list(port[0][0]) == [True, False, False, False]
    assert bool(port[1][0][0])
    for a, b in zip(ref, port):
        assert_same_decisions(a, b)


def populated(core, seed: int):
    """A pool with mixed classes, live buckets, resident and queued
    requests, ticked once so burst/debt/effective rates are live."""
    r = np.random.default_rng(seed)
    pool = mkpool(core, pool_conc=6.0)
    classes = ("DEDICATED", "GUARANTEED", "ELASTIC", "SPOT", "PREEMPTIBLE")
    for i in range(11):
        klass = classes[i % 5]
        tps = 0.0 if klass in ("SPOT", "PREEMPTIBLE") else float(
            r.integers(50, 400))
        pool.add_entitlement(qent(core, f"e{i}", klass, tps,
                                  float(r.integers(0, 3)),
                                  float(r.choice([200.0, 2000.0, 30000.0])),
                                  kv=float(r.choice([0.0, 1e6]))))
        if tps == 0.0:
            pool.ledger.set_rate(f"e{i}", float(r.integers(50, 500)), 0.0)
    for i in range(9):
        seed_inflight(core, pool, f"e{int(r.integers(0, 11))}",
                      queued=int(r.integers(0, 2)),
                      resident=int(r.integers(0, 2)))
    pool.tick(1.0)
    return pool


@pytest.mark.parametrize("seed", range(3))
def test_quantum_snapshot_parity(seed):
    js = JV.quantum_snapshot(populated(J, seed), 1.5)
    ts = TV.quantum_snapshot(populated(T, seed), 1.5)
    assert js.names == ts.names and js.row_of == ts.row_of
    for f in FIELDS:
        a = np.asarray(getattr(js.state, f))
        b = getattr(ts.state, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8), b.view(np.uint8)), f
    for f in ("bucket_level", "in_flight", "kv_in_use", "weights"):
        a, b = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(
            a.view(np.uint8), b.view(np.uint8)), f
    for f in ("pool_in_flight", "pool_resident", "pool_conc_cap",
              "running_min_priority", "pool_avg_slo"):
        assert getattr(js, f) == getattr(ts, f), f
    assert T.running_min_live(populated(T, seed)) == \
        J.running_min_live(populated(J, seed))
