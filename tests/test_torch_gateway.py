"""The port's gateway (``repro_torch.gateway``) against the reference's
scalar path (``repro.gateway.Gateway.handle``) on the CPU.

Seeded request streams go through both packages: unknown keys (401),
admissions (200) and denials (429) on single-pool keys and on two-leg
spill routes over a ``PoolManager``, with completions, failures, pool
outages and control ticks interleaved.  Responses (status, reason,
Retry-After, priority, admitting pool and spill hops), the gateway's
StateStore counters and every bucket level must be identical.
"""
import numpy as np
import pytest

import repro.core as J
import repro.gateway as JG
import repro_torch.core as T
import repro_torch.gateway as TG

POOLS = ("east", "west")


def build(core, gw_mod, seed: int, spill_policy: str):
    r = np.random.default_rng(seed)
    kw = {"device": "cpu"} if core is T else {}
    mgr = core.PoolManager()
    for name in POOLS:
        mgr.add_pool(core.PoolSpec(
            name=name, model="m", scaling=core.ScalingBounds(1, 3),
            per_replica=core.Resources(float(r.choice([300.0, 1500.0])),
                                       float(1 << 30), 8.0),
            default_max_tokens=64), **kw)
    tenants = []
    for i, klass in enumerate(("GUARANTEED", "ELASTIC", "SPOT",
                               "PREEMPTIBLE", "GUARANTEED", "SPOT")):
        pool = POOLS[i % 2]
        sc = getattr(core.ServiceClass, klass)
        base = 0.0 if klass in ("SPOT", "PREEMPTIBLE") else 100.0
        name = f"t{i}"
        mgr.add_entitlement(core.EntitlementSpec(
            name=name, tenant_id=name, pool=pool,
            qos=core.QoS(sc, float(r.choice([200.0, 2000.0, 30000.0]))),
            baseline=core.Resources(base, 0.0, 4.0)))
        p = mgr.pool(pool)
        p.ledger.set_rate(name, float(r.integers(100, 3000)), 0.0)
        p.ledger.bucket(name).level = float(r.integers(0, 4000))
        tenants.append((name, pool))
    gw = gw_mod.Gateway(mgr, spill_policy=spill_policy)
    for name, pool in tenants:
        gw.register_key(f"k-{name}", name)
    # two-leg spill routes: preferred pool first, then the other
    gw.register_route("k-spill-a", [("east", "t0"), ("west", "t1")])
    gw.register_route("k-spill-b", [("west", "t3"), ("east", "t2")])
    return mgr, gw


def stream(core, gw_mod, seed: int, spill_policy: str) -> list:
    r = np.random.default_rng(1000 + seed)
    mgr, gw = build(core, gw_mod, seed, spill_policy)
    keys = [f"k-t{i}" for i in range(6)] + ["k-spill-a", "k-spill-b",
                                            "k-unknown"]
    out, flying = [], []
    now = 0.0
    for i in range(300):
        now += float(r.random() * 0.2)
        op = r.random()
        if op < 0.6:
            rid = f"r{i}"
            resp = gw.handle(keys[int(r.integers(0, len(keys)))], rid,
                             int(r.integers(1, 500)),
                             int(r.integers(1, 200)) if r.random() < 0.8
                             else None, now,
                             kv_bytes_per_token=float(r.choice([0, 2048])))
            out.append(("handle", tuple(resp)))
            if resp.status == 200:
                flying.append(rid)
                mgr.pool(resp.pool).on_start(rid)
        elif op < 0.8 and flying:
            rid = flying.pop(int(r.integers(0, len(flying))))
            gw.on_complete(rid, int(r.integers(0, 200)), 0.5, now)
            out.append(("complete", rid))
        elif op < 0.85 and flying:
            rid = flying.pop(int(r.integers(0, len(flying))))
            gw.on_failure(rid, now)
            out.append(("failure", rid))
        elif op < 0.88:
            # an outage or recovery of one pool (0 replicas = unavailable)
            pool = mgr.pool(POOLS[int(r.integers(0, 2))])
            n = int(r.integers(0, 3))
            pool.set_replicas(n)
            out.append(("replicas", pool.spec.name, n))
        else:
            for name in POOLS:
                rec = mgr.pool(name).tick(now)
                out.append(("tick", name, rec.allocations, rec.priorities,
                            rec.debts))
        if i % 50 == 49:
            out.append(("store", {k: gw.store.get(k, now)
                                  for k in gw.store.keys("", now)}))
            out.append(("levels", {
                (p, n): mgr.pool(p).ledger.bucket(n).level
                for p in POOLS for n in mgr.pool(p).entitlements}))
    return out


@pytest.mark.parametrize("spill_policy", ["static", "headroom"])
@pytest.mark.parametrize("seed", range(4))
def test_handle_stream_identical(seed, spill_policy):
    ref = stream(J, JG, seed, spill_policy)
    port = stream(T, TG, seed, spill_policy)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"event {i}: {a[0]}"
    statuses = {e[1][0] for e in ref if e[0] == "handle"}
    assert statuses == {200, 401, 429}


def test_resolve_and_route_identical():
    _, jgw = build(J, JG, 0, "static")
    _, tgw = build(T, TG, 0, "static")
    for key in ("k-t0", "k-spill-a", "k-spill-b", "k-nope"):
        assert jgw.resolve(key) == tgw.resolve(key)
        jr, tr = jgw.route(key), tgw.route(key)
        assert (jr is None) == (tr is None)
        if jr is not None:
            assert [(e.pool, e.entitlement) for e in jr] == \
                [(e.pool, e.entitlement) for e in tr]


def test_register_key_errors_match():
    _, jgw = build(J, JG, 0, "static")
    _, tgw = build(T, TG, 0, "static")
    for gw in (jgw, tgw):
        with pytest.raises(ValueError, match="exists in no pool"):
            gw.register_key("k-x", "nobody")
        with pytest.raises(ValueError, match="at least one leg"):
            gw.register_route("k-x", [])


def test_telemetry_is_refused_until_ported():
    """The telemetry plane is ported now: ``telemetry=True`` is accepted
    and wires every pool of the manager into one plane (its parity with
    the reference is in ``tests/test_torch_telemetry.py``)."""
    from repro_torch.telemetry import Telemetry
    mgr, _ = build(T, TG, 0, "static")
    gw = TG.Gateway(mgr, telemetry=True)
    assert isinstance(gw.telemetry, Telemetry)
    assert all(p.telemetry is gw.telemetry for p in mgr.pools.values())
