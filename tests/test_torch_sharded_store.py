"""The port's ``ShardedResidentStore`` and sharded pools against the
reference's, on the CPU.

- The store: the same churn sequence on the port's store and the
  reference's gives the same slots, per-shard free lists,
  ``row_accounting`` and upload counters after every step (pow2 shard
  counts enforced, balanced allocation, growth that keeps slots, one
  block re-uploaded per attach, detach or view write), and a mirror
  that matches the host columns.
- ``PoolSpec(shards=4)`` builds the sharded store; a sharded pool ticks
  and admits like a flat pool, name for name, over three ticks and a
  100-request gateway quantum, and like the reference's sharded pool.
- A pool on a mesh of two gloo ranks (``shard_plane.pool_mesh``
  non-None: the sharded tick and admission quantum, each rank
  mirroring its half of the rows) equals the flat pool.
- The ``churn_migration`` chaos scenario with ``shards: 4`` on every
  site holds every invariant, and its decision trace equals the
  reference's.
"""
import dataclasses
import sys

import numpy as np
import pytest

import repro_torch.core as T
from repro_torch.core import shard_plane as SP
from repro_torch.core.resident import ShardedResidentStore as TStore

# The reference package is imported inside the tests that use it: the
# two-rank test's ranks import this module and must not pull in JAX.

FIELDS = ("class_code", "bound", "baseline_tps", "baseline_kv",
          "baseline_conc", "slo_ms", "burst", "debt")
POOL_COLS = ("burst", "debt", "eff_tps", "eff_kv", "eff_conc",
             "bucket_level", "in_flight", "admitted_total", "denied_total")


def churn(store, mutate):
    """A churn sequence through the store's public surface; ``mutate``
    is called after each step with a label (the caller compares)."""
    for i in range(40):
        store.allocate(f"e{i}")
    mutate("fill")
    store.device_state()
    mutate("mirror")
    for name in ("e3", "e17", "e30"):
        store.release(name)
        store.device_state()
        mutate(f"release {name}")
    store.allocate("e3b")
    store.device_state()
    mutate("allocate e3b")
    store.view("e10").burst = 3.0
    store.view("e11").debt = 1.25
    store.view("e12").state = store.view("e12").state
    store.device_state()
    mutate("view writes")
    for i in range(30):                     # past capacity 64: growth
        store.allocate(f"g{i}")
    mutate("grow")
    store.device_state()
    mutate("grow mirror")
    store.release("g5")
    store.device_state()
    mutate("release g5")


def store_view(store) -> dict:
    state = store.device_state() if store._device is not None else None
    return dict(
        slot_of=dict(store.slot_of),
        shard_free=[list(fl) for fl in store._shard_free],
        accounting=store.row_accounting(),
        counters=(store.block_uploads, store.full_uploads,
                  store.uploaded_rows),
        mirror=None if state is None else {
            k: np.asarray(getattr(state, k)).tolist() for k in FIELDS})


@pytest.mark.parametrize("capacity,n_shards",
                         [(64, 4), (16, 4), (8, 8), (64, 2), (4, 1)])
def test_churn_sequence_matches_the_reference(capacity, n_shards):
    from repro.core.resident import ShardedResidentStore as JStore
    ours = TStore(capacity=capacity, n_shards=n_shards, device="cpu")
    ref = JStore(capacity=capacity, n_shards=n_shards)
    steps_ours, steps_ref = [], []
    churn(ours, lambda label: steps_ours.append((label, store_view(ours))))
    churn(ref, lambda label: steps_ref.append((label, store_view(ref))))
    for (label, a), (_, b) in zip(steps_ours, steps_ref):
        assert a == b, label
    assert len(steps_ours) == len(steps_ref)


@pytest.mark.parametrize("n_shards", [0, 3, 6])
def test_pow2_shards_enforced(n_shards):
    from repro.core.resident import ShardedResidentStore as JStore
    with pytest.raises(ValueError):
        TStore(n_shards=n_shards, device="cpu")
    with pytest.raises(ValueError):
        JStore(n_shards=n_shards)


def mkstore(capacity=64, n_shards=4, live=40):
    st = TStore(capacity=capacity, n_shards=n_shards, device="cpu")
    for i in range(live):
        st.allocate(f"e{i}")
    return st


def test_allocation_balances_shards():
    st = mkstore(capacity=64, n_shards=4, live=40)
    per_shard = [st.shard_rows - f
                 for f in st.row_accounting()["shard_free"]]
    assert max(per_shard) - min(per_shard) <= 1
    acct = st.row_accounting()
    assert acct["live"] + acct["free"] == acct["capacity"]
    assert acct["alive_rows"] == acct["live"]
    for name, slot in st.slot_of.items():
        assert st.shard_of_name(name) == slot // st.shard_rows


@pytest.mark.parametrize("what", ["release", "allocate", "view write"])
def test_churn_reuploads_one_block(what):
    """Each attach, detach or view write re-uploads exactly one shard's
    rows, never the pool — and the mirror agrees with the host."""
    st = mkstore()
    st.device_state()
    mutate = {"release": lambda: st.release("e3"),
              "allocate": lambda: st.allocate("e3b"),
              "view write": lambda: setattr(st.view("e10"), "burst", 3.0)}
    b0, f0, r0 = st.block_uploads, st.full_uploads, st.uploaded_rows
    mutate[what]()
    st.device_state()
    assert st.block_uploads - b0 == 1
    assert st.full_uploads == f0
    assert st.uploaded_rows - r0 == st.shard_rows
    drift = st.mirror_drift()
    assert drift and max(drift.values()) == 0.0


def test_growth_keeps_slots_stable():
    st = mkstore(capacity=16, n_shards=4, live=16)
    before = dict(st.slot_of)
    views = {n: st.view(n) for n in list(before)[:5]}
    for i in range(20):
        st.allocate(f"g{i}")
    assert st.capacity == 64
    assert all(st.slot_of[n] == s for n, s in before.items())
    for n, v in views.items():
        assert v.slot == before[n]
    acct = st.row_accounting()
    assert acct["live"] + acct["free"] == 64


def test_adopt_device_resyncs():
    st = mkstore()
    state = st.device_state()
    bumped = dataclasses.replace(state, burst=state.burst + 1.0,
                                 debt=state.debt + 0.5)
    st.adopt_device(bumped)
    assert st.device_state() is bumped
    assert np.array_equal(st.col["burst"], bumped.burst.numpy())
    assert max(st.mirror_drift().values()) == 0.0


# -- pools ------------------------------------------------------------------------

def mkpool(pkg, shards, n_ents=37, name="p", **kw):
    spec = pkg.PoolSpec(
        name=name, model="m", shards=shards,
        scaling=pkg.ScalingBounds(1, 1),
        per_replica=pkg.Resources(2000.0, float(1 << 40), 64.0))
    pool = pkg.TokenPool(spec, **kw)
    classes = [pkg.ServiceClass.GUARANTEED, pkg.ServiceClass.DEDICATED,
               pkg.ServiceClass.ELASTIC, pkg.ServiceClass.SPOT]
    for i in range(n_ents):
        pool.add_entitlement(pkg.EntitlementSpec(
            name=f"e{i}", tenant_id=f"t{i}", pool=name,
            qos=pkg.QoS(service_class=classes[i % 4],
                        slo_target_ms=100.0 + 10 * i),
            baseline=pkg.Resources(20.0 + i, float(1 << 20), 4.0)))
    return pool


def drive(pool, gateway_cls, request_cls) -> tuple:
    """Three ticks, then one 100-request gateway quantum: the pool's
    columns name for name and the responses."""
    for t in (1.0, 2.0, 3.0):
        pool.tick(t)
    gw = gateway_cls(pool)
    for i in range(37):
        gw.register_route(f"k{i}", [("p", f"e{i}")])
    reqs = [request_cls(api_key=f"k{i % 37}", request_id=f"r{i}",
                        input_tokens=50, max_tokens=64 + 8 * (i % 5))
            for i in range(100)]
    out = gw.handle_quantum(reqs, now=3.5)
    c = pool.store.col
    cols = {name: tuple(c[k][slot].item() for k in POOL_COLS)
            for name, slot in sorted(pool.store.slot_of.items())}
    return cols, [(r.request_id, r.status, r.reason, r.priority)
                  for r in out]


def drive_port(shards) -> tuple:
    from repro_torch.gateway import Gateway, QuantumRequest
    return drive(mkpool(T, shards, device="cpu"), Gateway, QuantumRequest)


def test_spec_selects_store():
    assert type(mkpool(T, None, device="cpu").store) is T.ResidentStore
    assert type(mkpool(T, 1, device="cpu").store) is T.ResidentStore
    store = mkpool(T, 4, device="cpu").store
    assert isinstance(store, T.ShardedResidentStore)
    assert store.n_shards == 4


def test_sharded_pool_ticks_and_admits_like_flat():
    flat, sharded = drive_port(None), drive_port(4)
    assert flat[0] == sharded[0]
    assert flat[1] == sharded[1]
    assert sum(s == 200 for _, s, _, _ in flat[1]) > 0


def test_sharded_pool_matches_the_reference():
    import repro.core as J
    from repro.gateway.gateway import Gateway, QuantumRequest
    ours = drive_port(4)
    ref = drive(mkpool(J, 4), Gateway, QuantumRequest)
    assert ours == ref


def fleet_ticks(shards) -> dict:
    """A PoolManager of a pool with ``shards`` and a flat one, ticked
    three times: every pool's columns name for name."""
    mgr = T.PoolManager()
    for pname, n_ents, pool_shards in (("a", 29, shards), ("b", 11, None)):
        pool = mgr.add_pool(T.PoolSpec(
            name=pname, model="m", shards=pool_shards,
            scaling=T.ScalingBounds(1, 1),
            per_replica=T.Resources(700.0, float(1 << 40), 32.0)),
            device="cpu")
        for i in range(n_ents):
            pool.add_entitlement(T.EntitlementSpec(
                name=f"{pname}{i}", tenant_id=f"t{i}", pool=pname,
                qos=T.QoS(service_class=T.ServiceClass.ELASTIC
                          if i % 3 else T.ServiceClass.GUARANTEED,
                          slo_target_ms=200.0 + 7 * i),
                baseline=T.Resources(15.0 + i, float(1 << 18), 2.0)))
    for t in (1.0, 2.0, 3.0):
        mgr.tick(t)
    return {pname: {name: tuple(pool.store.col[k][slot].item()
                                for k in POOL_COLS)
                    for name, slot in sorted(pool.store.slot_of.items())}
            for pname, pool in mgr.pools.items()}


def _two_rank_pool() -> tuple:
    pool = mkpool(T, 4, device="cpu")
    mesh = SP.pool_mesh(pool)
    from repro_torch.gateway import Gateway, QuantumRequest
    out = drive(pool, Gateway, QuantumRequest)
    return (out, fleet_ticks(4), (mesh.size, mesh.rank),
            pool.store.mirror_rows(), pool.store.device_state().n_rows,
            any(m == "jax" or m.startswith("jax.") for m in sys.modules))


def test_two_rank_pool_equals_flat():
    """Each rank mirrors half the rows and ticks/admits through the
    sharded kernels; every rank's host truth and responses equal the
    flat pool's, alone and inside a PoolManager beside a flat pool."""
    flat, flat_fleet = drive_port(None), fleet_ticks(None)
    results = SP.launch_ranks(_two_rank_pool, 2, timeout=120.0)
    cap = mkpool(T, 4, device="cpu").store.capacity
    for rank, (out, fleet, mesh, rows, n_rows, jax_imported) in enumerate(
            results):
        assert not jax_imported
        assert mesh == (2, rank)
        assert rows == (rank * cap // 2, (rank + 1) * cap // 2)
        assert n_rows == cap // 2
        assert out == flat, rank
        assert fleet == flat_fleet, rank


# -- chaos --------------------------------------------------------------------------

def sharded(scenario):
    return dataclasses.replace(
        scenario, sites=tuple({**dict(s), "shards": 4}
                              for s in scenario.sites))


def test_sharded_churn_migration_holds_every_invariant():
    import repro_torch.chaos as TC
    sc = sharded(TC.by_name("churn_migration"))
    sim = TC.build_sim(sc, device="cpu")
    assert all(isinstance(p.store, T.ShardedResidentStore)
               for p in sim.manager.pools.values())
    rep = TC.run_scenario(sc, device="cpu")
    assert rep["passed"], rep["violations"]
    assert len(rep["checkers"]) >= 6


def test_sharded_churn_migration_trace_equals_the_reference():
    import repro.chaos as JC
    import repro.core as J
    import repro_torch.chaos as TC
    from repro.chaos.replay import capture_trace as j_capture
    from repro_torch.chaos.replay import capture_trace

    def to_reference(sc):
        def conv(d):
            return {k: (J.ServiceClass(v.value)
                        if isinstance(v, T.ServiceClass) else v)
                    for k, v in d.items()}
        return JC.Scenario(**{
            **{f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)},
            "workloads": tuple(conv(w) for w in sc.workloads),
            "sites": tuple(dict(s) for s in sc.sites),
            "events": tuple(JC.ScenarioEvent(e.t, e.kind, conv(e.payload))
                            for e in sc.events)})

    def key(trace):
        return ({rid: dataclasses.astuple(o)
                 for rid, o in trace.outcomes.items()},
                trace.flight_legs, trace.flight_priority)

    sc = sharded(TC.by_name("churn_migration"))
    sim = TC.build_sim(sc, "quantum", True, device="cpu")
    sim.run(sc.duration_s)
    ref = JC.build_sim(to_reference(sc), "quantum", True)
    ref.run(sc.duration_s)
    ours = capture_trace(sim, "quantum_fast")
    assert ours.outcomes
    assert key(ours) == key(j_capture(ref, "quantum_fast"))


def test_migration_across_shard_boundaries():
    mgr = T.PoolManager()
    for pname in ("src", "dst"):
        spec = T.PoolSpec(name=pname, model="m", shards=4,
                          scaling=T.ScalingBounds(1, 2),
                          per_replica=T.Resources(900.0, float(1 << 40),
                                                  32.0))
        pool = mgr.add_pool(spec, device="cpu")
        for i in range(11):
            pool.add_entitlement(T.EntitlementSpec(
                name=f"{pname}{i}", tenant_id=f"t{i}", pool=pname,
                qos=T.QoS(service_class=T.ServiceClass.ELASTIC,
                          slo_target_ms=500.0),
                baseline=T.Resources(15.0, float(1 << 18), 2.0)))
    mgr.tick(1.0)
    src, dst = mgr.pool("src"), mgr.pool("dst")
    src.ledger.set_rate("src3", 50.0, 1.0)
    src.ledger.bucket("src3").level = 33.0
    src.status["src3"].debt = 0.75
    mgr.migrate_entitlement("src3", "src", "dst", now=1.5)
    assert "src3" not in src.store and "src3" in dst.store
    assert dst.status["src3"].debt == pytest.approx(0.75)
    # carried bucket is refilled to `now`: 33 + 50 tps * 0.5 s
    assert dst.ledger.bucket("src3").level == pytest.approx(58.0)
    for pool in (src, dst):
        acct = pool.store.row_accounting()
        assert acct["live"] + acct["free"] == acct["capacity"]
        assert acct["alive_rows"] == acct["live"]
    mgr.tick(2.0)
    drift = dst.store.mirror_drift()
    assert not drift or max(drift.values()) == 0.0
