"""The port's batched gateway path (``Gateway.handle_quantum``) against
the reference's, on the CPU.

Every case of ``tests/test_gateway_quantum.py`` is built in both
packages from one seed and run through both ``handle_quantum``s (the
port's ``admit_quantum`` runs its kernel's plain version on CPU pools):
responses (status, reason, Retry-After, priority, admitting pool and
spill hops), the StateStore counters, bucket levels, in-flight sets and
demand windows must be identical — on the single-leg fast path, on the
generic leg-round path, and across the fast path's bail-out.  A
seeded multi-pool stream then interleaves quanta with batched
completions (``Gateway.on_complete_batch``) and fleet ticks
(``PoolManager.tick``, one ``control_tick_pools`` call for the fleet);
every tick record must be identical too.
"""
import random

import numpy as np
import pytest

import repro.core as J
import repro.gateway as JG
import repro_torch.core as T
import repro_torch.gateway as TG

PACKAGES = ((J, JG), (T, TG))


def mkpool(core, name, tps=1000.0, slots=4.0, default_max_tokens=64,
           window=1.0):
    kw = {"device": "cpu"} if core is T else {}
    return core.TokenPool(core.PoolSpec(
        name=name, model="m", scaling=core.ScalingBounds(1, 1),
        per_replica=core.Resources(tps, float(1 << 30), slots),
        default_max_tokens=default_max_tokens, bucket_window_s=window),
        **kw)


def ent(core, name, pool, klass="GUARANTEED", tps=500.0, conc=4.0,
        slo=500.0):
    return core.EntitlementSpec(
        name=name, tenant_id="t", pool=pool,
        qos=core.QoS(service_class=getattr(core.ServiceClass, klass),
                     slo_target_ms=slo),
        baseline=core.Resources(tps, 0.0, conc))


def state_of(gw) -> dict:
    """Everything the quantum path writes: counters, in-flight sets,
    bucket levels and demand windows per pool."""
    out = {"store": {k: gw.store.get(k) for k in sorted(gw.store.keys())}}
    for name, pool in gw.manager.pools.items():
        out[name] = (
            sorted(pool.in_flight),
            {e: pool.ledger.bucket(e).level
             for e in sorted(pool.ledger._buckets)},
            pool.store.col["demand_window"][pool.store.live_slots()]
            .tolist())
    return out


def both(build, run):
    """``build(core, gw_mod) -> gateway`` and ``run(gw, gw_mod) ->
    result`` in each package; returns (reference, port) pairs of
    (result, state)."""
    out = []
    for core, gw_mod in PACKAGES:
        gw = build(core, gw_mod)
        out.append((run(gw, gw_mod), state_of(gw)))
    return out


def quantum(reqs):
    def run(gw, gw_mod):
        return [tuple(r) for r in gw.handle_quantum(
            [gw_mod.QuantumRequest(*q) for q in reqs], now=0.0)]
    return run


def randomized(seed: int):
    """``TestQuantumScalarParity._build``: routes are prefixes of one
    pool order over three pools, mixed classes, an unknown key."""
    def build(core, gw_mod):
        rng = random.Random(seed)
        mgr = core.PoolManager([
            mkpool(core, "a", tps=rng.choice([300.0, 600.0]),
                   slots=rng.choice([2.0, 4.0])),
            mkpool(core, "b", tps=600.0, slots=4.0),
            mkpool(core, "c", tps=1000.0, slots=8.0)])
        gw = gw_mod.Gateway(mgr)
        for k in range(4):
            klass = ("GUARANTEED", "ELASTIC", "SPOT")[k % 3]
            depth = rng.randint(1, 3)
            route = []
            for pname in ["a", "b", "c"][:depth]:
                ename = f"t{k}@{pname}"
                mgr.pool(pname).add_entitlement(ent(
                    core, ename, pname, klass=klass,
                    tps=rng.choice([80.0, 200.0]),
                    conc=rng.choice([1.0, 2.0]),
                    slo=rng.choice([250.0, 1000.0, 30000.0])))
                if klass == "SPOT":
                    mgr.pool(pname).ledger.set_rate(ename, 200.0, 0.0)
                    mgr.pool(pname).ledger.bucket(ename).level = 200.0
                route.append((pname, ename))
            gw.register_route(f"k{k}", route)
        return gw

    rng = random.Random(seed)
    rng.random()                      # the build's draws are its own
    reqs = [(f"k{rng.randint(0, 4)}" if rng.random() < 0.9 else "nokey",
             f"r{i}", rng.choice([16, 48]), rng.choice([None, 32, 96]))
            for i in range(24)]
    return build, reqs


@pytest.mark.parametrize("seed", range(5))
def test_decisions_and_counters_identical(seed):
    build, reqs = randomized(seed)
    ref, port = both(build, quantum(reqs))
    assert ref == port
    assert {r[0] for r in ref[0]} >= {200, 429}


@pytest.mark.parametrize("seed", range(3))
def test_port_quantum_matches_port_scalar(seed):
    """Within the port, the batched path decides as the scalar loop."""
    build, reqs = randomized(seed)
    gw_q, gw_s = build(T, TG), build(T, TG)
    quant = gw_q.handle_quantum([TG.QuantumRequest(*q) for q in reqs], 0.0)
    scal = [gw_s.handle(*q, now=0.0) for q in reqs]
    key = lambda r: (r.status, r.pool, r.entitlement,  # noqa: E731
                     r.spill_hops, r.reason)
    assert [key(r) for r in quant] == [key(r) for r in scal]
    for p in "abc":
        assert sorted(gw_q.manager.pool(p).in_flight) == \
            sorted(gw_s.manager.pool(p).in_flight)


def test_empty_quantum_and_unknown_key():
    for core, gw_mod in PACKAGES:
        gw = gw_mod.Gateway(core.PoolManager([mkpool(core, "a")]))
        assert gw.handle_quantum([], now=0.0) == []
        [r] = gw.handle_quantum([gw_mod.QuantumRequest("nope", "r1", 16, 16)],
                                now=0.0)
        assert r.status == 401 and r.reason == "unknown_key"


def test_per_leg_default_max_tokens():
    def build(core, gw_mod):
        mgr = core.PoolManager([
            mkpool(core, "a", default_max_tokens=512, tps=100.0),
            mkpool(core, "b", default_max_tokens=32, tps=100.0)])
        mgr.pool("a").add_entitlement(ent(core, "e@a", "a", tps=100.0))
        mgr.pool("b").add_entitlement(ent(core, "e@b", "b", tps=100.0))
        gw = gw_mod.Gateway(mgr)
        gw.register_route("k", [("a", "e@a"), ("b", "e@b")])
        return gw
    ref, port = both(build, quantum([("k", "r1", 16, None),
                                     ("k", "r2", 16, None)]))
    assert ref == port
    assert port[0][0][5:] == ("b", "e@b", 1)


def test_spill_reenters_next_leg_in_order():
    def build(core, gw_mod):
        mgr = core.PoolManager([mkpool(core, "a", tps=100.0),
                                mkpool(core, "b", tps=150.0)])
        mgr.pool("a").add_entitlement(ent(core, "e@a", "a", tps=100.0))
        mgr.pool("b").add_entitlement(ent(core, "e@b", "b", tps=150.0))
        gw = gw_mod.Gateway(mgr)
        gw.register_route("k", [("a", "e@a"), ("b", "e@b")])
        return gw
    ref, port = both(build, quantum([("k", f"r{i}", 32, 64)
                                     for i in range(3)]))
    assert ref == port
    assert [(r[0], r[5]) for r in port[0]] == \
        [(200, "a"), (200, "b"), (429, None)]


def test_mixed_skip_and_deny_spills_keep_arrival_order():
    def build(core, gw_mod):
        mgr = core.PoolManager([mkpool(core, "a", tps=1000.0),
                                mkpool(core, "b", tps=150.0)])
        mgr.pool("a").add_entitlement(ent(core, "e1@a", "a", tps=30.0))
        mgr.pool("b").add_entitlement(ent(core, "e@b", "b", tps=150.0))
        gw = gw_mod.Gateway(mgr)
        gw.register_route("k1", [("a", "e1@a"), ("b", "e@b")])
        gw.register_route("k2", [("a", "e2@a"), ("b", "e@b")])
        return gw
    ref, port = both(build, quantum([("k1", "r1", 32, 64),
                                     ("k2", "r2", 32, 64)]))
    assert ref == port
    assert [(r[0], r[5]) for r in port[0]] == [(200, "b"), (429, None)]


def test_headroom_reorder_reports_declared_position():
    def build(core, gw_mod):
        mgr = core.PoolManager([mkpool(core, "a", tps=50.0),
                                mkpool(core, "b", tps=1000.0)])
        mgr.pool("a").add_entitlement(ent(core, "e@a", "a", tps=50.0))
        mgr.pool("b").add_entitlement(ent(core, "e@b", "b", tps=500.0))
        gw = gw_mod.Gateway(mgr, spill_policy="headroom")
        gw.register_route("k", [("a", "e@a"), ("b", "e@b")])
        return gw
    ref, port = both(build, quantum([("k", "r1", 32, 64),
                                     ("k", "r2", 32, 64)]))
    assert ref == port
    assert port[0][0][5:] == ("b", "e@b", 1)


def attribution(a_up=True, b_up=True, repeat_leg=False):
    def build(core, gw_mod):
        mgr = core.PoolManager([mkpool(core, "a", tps=100.0 if not repeat_leg
                                       else 10.0),
                                mkpool(core, "b", tps=10.0 if not repeat_leg
                                       else 150.0)])
        mgr.pool("a").add_entitlement(ent(core, "e@a", "a",
                                          tps=mgr.pool("a").spec
                                          .per_replica.tokens_per_second))
        mgr.pool("b").add_entitlement(ent(core, "e@b", "b",
                                          tps=mgr.pool("b").spec
                                          .per_replica.tokens_per_second))
        if not a_up:
            mgr.pool("a").set_replicas(0)
        if not b_up:
            mgr.pool("b").set_replicas(0)
        gw = gw_mod.Gateway(mgr)
        legs = [("a", "e@a"), ("b", "e@b")]
        gw.register_route("k", [legs[0]] + legs if repeat_leg else legs)
        return gw
    return build


@pytest.mark.parametrize("case", ["first_tried", "unroutable",
                                  "declared_hops"])
def test_denial_attribution(case):
    build = {"first_tried": attribution(a_up=False),
             "unroutable": attribution(a_up=False, b_up=False),
             "declared_hops": attribution(repeat_leg=True)}[case]
    ref, port = both(build, quantum([("k", "r1", 32, 64),
                                     ("k", "r2", 32, 64)]))
    assert ref == port
    first, state = port
    if case == "first_tried":
        assert first[0][3] == "token_budget"
        assert state["store"].get("denials:e@b") == 2.0
        assert "denials:e@a" not in state["store"]
    elif case == "unroutable":
        assert first[0][3] == "pool_unavailable"
        assert state["store"]["unroutable:k"] == 2.0
    else:
        assert first[0][0] == 200 and first[0][5] == "b"
        assert first[0][7] == 2


def fast_build(seed: int, fast: bool):
    """``TestFastPathParity._build``: single-leg keys over two pools, an
    espec-miss leg and a route to a pool that does not exist."""
    def build(core, gw_mod):
        rng = random.Random(seed)
        mgr = core.PoolManager([
            mkpool(core, "a", tps=rng.choice([300.0, 600.0]),
                   slots=rng.choice([2.0, 4.0])),
            mkpool(core, "b", tps=600.0, slots=4.0)])
        gw = gw_mod.Gateway(mgr)
        gw.quantum_fast_enabled = fast
        for k in range(5):
            klass = ("GUARANTEED", "ELASTIC", "SPOT")[k % 3]
            pname = rng.choice(["a", "b"])
            ename = f"t{k}@{pname}"
            mgr.pool(pname).add_entitlement(ent(
                core, ename, pname, klass=klass,
                tps=rng.choice([80.0, 200.0]), conc=rng.choice([1.0, 2.0]),
                slo=rng.choice([250.0, 1000.0, 30000.0])))
            if klass == "SPOT":
                mgr.pool(pname).ledger.set_rate(ename, 200.0, 0.0)
                mgr.pool(pname).ledger.bucket(ename).level = 200.0
            gw.register_route(f"k{k}", [(pname, ename)])
        gw.register_route("kmiss", [("a", "ghost")])
        gw.register_route("kdead", [("zpool", "ez")])
        return gw
    rng = random.Random(1000 + seed)
    keys = [f"k{i}" for i in range(5)] + ["kmiss", "kdead", "nokey"]
    reqs = [(rng.choice(keys), f"r{i}", rng.choice([16, 48]),
             rng.choice([None, 32, 96])) for i in range(32)]
    return build, reqs


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("seed", range(4))
def test_fast_and_generic_paths_identical(seed, fast):
    build, reqs = fast_build(seed, fast)
    ref, port = both(build, quantum(reqs))
    assert ref == port
    # and within the port, the fast path equals the generic one
    other = both(fast_build(seed, not fast)[0], quantum(reqs))[1]
    assert other == port


def test_multi_leg_routes_bail_to_generic():
    def build(core, gw_mod):
        mgr = core.PoolManager([mkpool(core, "a", tps=10.0),
                                mkpool(core, "b")])
        mgr.pool("a").add_entitlement(ent(core, "e@a", "a", tps=10.0))
        mgr.pool("b").add_entitlement(ent(core, "e@b", "b"))
        gw = gw_mod.Gateway(mgr)
        gw.register_route("k", [("a", "e@a"), ("b", "e@b")])
        return gw
    reqs = [("k", "r1", 32, 64), ("k", "r2", 32, 64)]

    def run(gw, gw_mod):
        qs = [gw_mod.QuantumRequest(*q) for q in reqs]
        bailed = gw._quantum_fast(qs, 0.0) is None
        untouched = (gw.store.keys("admits:") == []
                     and not gw.manager.pool("a").in_flight
                     and not gw.manager.pool("b").in_flight)
        return bailed, untouched, [tuple(r) for r in
                                   gw.handle_quantum(qs, now=0.0)]
    ref, port = both(build, run)
    assert ref == port
    assert port[0][:2] == (True, True)
    assert [r[0] for r in port[0][2]] == [200, 200]


def fleet_stream(core, gw_mod, seed: int) -> list:
    """Quanta through a three-pool gateway (two of the pools share
    coefficients and tick as one batched group), interleaved with
    starts, batched completions with spill-debt transfers, outages and
    fleet ticks."""
    r = np.random.default_rng(seed)
    kw = {"device": "cpu"} if core is T else {}
    mgr = core.PoolManager()
    for name, coeff in (("east", core.PriorityCoefficients()),
                        ("west", core.PriorityCoefficients()),
                        ("south", core.PriorityCoefficients(alpha_slo=2.0))):
        mgr.add_pool(core.PoolSpec(
            name=name, model="m", scaling=core.ScalingBounds(1, 3),
            per_replica=core.Resources(float(r.choice([300.0, 900.0])),
                                       float(1 << 30), 6.0),
            default_max_tokens=64, coefficients=coeff), **kw)
    gw = gw_mod.Gateway(mgr)
    classes = ("GUARANTEED", "ELASTIC", "SPOT", "ELASTIC", "PREEMPTIBLE")
    for i, klass in enumerate(classes):
        legs = []
        for pname in ("east", "west", "south")[i % 2:]:
            ename = f"t{i}@{pname}"
            base = 0.0 if klass in ("SPOT", "PREEMPTIBLE") else 150.0
            mgr.pool(pname).add_entitlement(core.EntitlementSpec(
                name=ename, tenant_id=f"t{i}", pool=pname,
                qos=core.QoS(getattr(core.ServiceClass, klass),
                             float(r.choice([250.0, 2000.0, 30000.0]))),
                baseline=core.Resources(base, 0.0, 3.0)))
            if base == 0.0:
                mgr.pool(pname).ledger.set_rate(ename, 300.0, 0.0)
            legs.append((pname, ename))
        gw.register_route(f"k{i}", legs)
    out, started = [], []
    now = 0.0
    for step in range(40):
        now += 0.25
        n = int(r.integers(2, 9))
        qs = [gw_mod.QuantumRequest(
            f"k{int(r.integers(0, 5))}", f"s{step}-{j}",
            int(r.integers(8, 120)), int(r.integers(8, 120)))
            for j in range(n)]
        resps = gw.handle_quantum(qs, now)
        out.append(("quantum", [tuple(x) for x in resps]))
        for x in resps:
            if x.status == 200:
                mgr.pool(x.pool).on_start(x.request_id)
                started.append(x.request_id)
        if step % 3 == 2 and started:
            k = int(r.integers(1, len(started) + 1))
            done, started = started[:k], started[k:]
            gw.on_complete_batch([(rid, int(r.integers(1, 100)), 0.5)
                                  for rid in done + ["unknown"]], now)
            out.append(("complete", done))
        if step == 17:
            mgr.pool("east").set_replicas(0)
        if step == 29:
            mgr.pool("east").set_replicas(1)
        if step % 4 == 3:
            recs = mgr.tick(now)
            out.append(("tick", {name: (rec.t, rec.allocations,
                                        rec.priorities, rec.debts,
                                        rec.bursts)
                                 for name, rec in recs.items()}))
    out.append(("state", state_of(gw)))
    return out


@pytest.mark.parametrize("seed", range(3))
def test_fleet_stream_identical(seed):
    ref = fleet_stream(J, JG, seed)
    port = fleet_stream(T, TG, seed)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"event {i}: {a[0]}"
    assert any(e[0] == "tick" for e in port)


def test_stack_cache_reuses_in_steady_state():
    """Steady-state fleet ticks re-stack nothing: the tick's own
    output is the next tick's input."""
    mgr = T.PoolManager()
    for name in ("a", "b"):
        mgr.add_pool(T.PoolSpec(name=name, model="m",
                                scaling=T.ScalingBounds(1, 1),
                                per_replica=T.Resources(500.0, 0.0, 4.0)),
                     device="cpu")
        mgr.pool(name).add_entitlement(ent(T, f"e@{name}", name))
    mgr.tick(1.0)
    assert (mgr.stack_reuses, mgr.stack_restacks) == (0, 2)
    mgr.tick(2.0)
    mgr.tick(3.0)
    assert (mgr.stack_reuses, mgr.stack_restacks) == (2, 2)
    mgr.pool("b").add_entitlement(ent(T, "f@b", "b"))
    mgr.tick(4.0)
    assert mgr.stack_restacks == 3


def test_planner_entry_points_raise_until_ported():
    """The fleet planner is ported now: its entry points plan and
    migrate (their parity with the reference is in
    ``tests/test_torch_fleet.py``); an unknown entitlement is a
    ``KeyError``, as in the reference."""
    mgr = T.PoolManager([mkpool(T, "a"), mkpool(T, "b")])
    gw = TG.Gateway(mgr)
    assert set(mgr.plan_quantum(0.0).decisions) == {"a", "b"}
    assert set(gw.plan_quantum(1.0).decisions) == {"a", "b"}
    assert gw.store.get("replicas:a") == 1.0
    with pytest.raises(KeyError):
        mgr.migrate_entitlement("x", "a", "b")
