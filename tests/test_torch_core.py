"""The port's token pool (``repro_torch.core``) against the reference
(``repro.core``) on the CPU.

The same scripted and seeded sequences run through both packages:
``examples/quickstart.py`` and randomized entitlement lifecycles
(membership churn, admissions, completions, evictions, scaling, ticks).
Allocations, priorities, admission decisions, deny reasons, Retry-After
hints, bucket levels, the resident columns and the tick's device mirror
must be identical: no tolerance, because the control tick is bit-for-bit
equal on the CPU and everything else is the same numpy code.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T


def make_pool(core, tps=240.0, slots=16.0, max_replicas=4):
    kw = {"device": "cpu"} if core is T else {}
    return core.TokenPool(core.PoolSpec(
        name="qwen3-8b", model="Qwen/Qwen3-8B",
        scaling=core.ScalingBounds(min_replicas=1,
                                   max_replicas=max_replicas),
        per_replica=core.Resources(tokens_per_second=tps,
                                   kv_bytes=16 * (1 << 30),
                                   concurrency=slots)), **kw)


def decision(d) -> tuple:
    return (d.admitted, d.reason.value if d.reason else None,
            d.retry_after_s, d.priority, d.charged_tokens,
            d.effective_max_tokens)


def pool_view(pool) -> dict:
    """Everything observable about a pool that must agree exactly."""
    return {
        "levels": {n: pool.ledger.bucket(n).level
                   for n in pool.entitlements},
        "priorities": {n: pool.priority(n) for n in pool.entitlements},
        "stats": pool.stats(),
        "replicas": pool.replicas,
        "status": {n: (s.tokens_total, s.state.value)
                   for n, s in pool.status.items()},
    }


def record_view(rec) -> dict:
    return {"t": rec.t, "capacity": rec.capacity_tps,
            "allocations": rec.allocations, "priorities": rec.priorities,
            "debts": rec.debts, "bursts": rec.bursts,
            "in_flight": rec.in_flight, "demand": rec.demand_tps}


def quickstart(core) -> list:
    """``examples/quickstart.py``, step for step, returning what it
    prints (unrounded) plus the pool's state after each phase."""
    out = []
    pool = make_pool(core)
    pool.add_entitlement(core.EntitlementSpec(
        name="prod-api", tenant_id="3ed0feec", pool="qwen3-8b",
        qos=core.QoS(core.ServiceClass.GUARANTEED, slo_target_ms=200),
        baseline=core.Resources(100.0, 2 * (1 << 30), 4.0)))
    pool.add_entitlement(core.EntitlementSpec(
        name="ml-team", tenant_id="a11ce", pool="qwen3-8b",
        qos=core.QoS(core.ServiceClass.ELASTIC, slo_target_ms=1000),
        baseline=core.Resources(80.0, 0.0, 6.0)))
    pool.add_entitlement(core.EntitlementSpec(
        name="crawler", tenant_id="b0b", pool="qwen3-8b",
        qos=core.QoS(core.ServiceClass.SPOT, slo_target_ms=30000),
        baseline=core.Resources(0.0, 0.0, 0.0)))
    ctrl = core.AdmissionController(pool)

    pool.register_deny("crawler", 500.0, low_priority=False)
    out.append(record_view(pool.tick(1.0)))
    out.append(pool_view(pool))
    for t in range(2, 6):
        pool.register_deny("prod-api", 100.0, low_priority=False)
        pool.register_deny("crawler", 500.0, low_priority=False)
        out.append(record_view(pool.tick(float(t))))
    out.append(pool_view(pool))
    for name in ("prod-api", "ml-team", "crawler"):
        pool.ledger.set_rate(name, 2e4, 6.0)
        pool.ledger.bucket(name).level = 8e4
    for i in range(4):
        out.append(decision(ctrl.decide(core.AdmissionRequest(
            "prod-api", 64, 64, 6.0, f"p{i}"))))
        pool.on_start(f"p{i}")
    for i in range(14):
        d = ctrl.decide(core.AdmissionRequest("ml-team", 64, 64, 6.0,
                                              f"e{i}"))
        out.append(decision(d))
        if d.admitted and i < 10:
            pool.on_start(f"e{i}")
    out.append(decision(ctrl.decide(core.AdmissionRequest(
        "crawler", 64, 64, 6.0, "s0"))))
    out.append(pool_view(pool))
    out.append(record_view(pool.tick(7.0)))
    out.append(pool_view(pool))
    return out


def test_quickstart_sequence_identical():
    ref, port = quickstart(J), quickstart(T)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, f"step {i}"
    # the example's point: the spot request is denied with a hint
    assert ref[-4][0] is False and ref[-4][2] is not None


CLASSES = ["GUARANTEED", "ELASTIC", "SPOT", "PREEMPTIBLE", "DEDICATED"]


def lifecycle(core, seed: int) -> list:
    """A seeded random walk over the pool's public surface: entitlement
    add/remove, admissions (decide + start), completions, evictions,
    replica changes and ticks.  Returns the observed trace."""
    r = np.random.default_rng(seed)
    pool = make_pool(core, tps=float(r.choice([200.0, 2000.0])),
                     slots=float(r.choice([4.0, 16.0])))
    ctrl = core.AdmissionController(pool)
    trace, live, flying = [], [], []
    next_ent = next_rid = 0
    now = 0.0
    for step in range(160):
        now += float(r.random())
        op = r.random()
        if op < 0.12 or not live:
            klass = getattr(core.ServiceClass,
                            CLASSES[int(r.integers(0, 5))])
            base = (0.0 if klass in (core.ServiceClass.SPOT,
                                     core.ServiceClass.PREEMPTIBLE)
                    else float(r.integers(5, 120)))
            name = f"e{next_ent}"
            next_ent += 1
            pool.add_entitlement(core.EntitlementSpec(
                name=name, tenant_id=name, pool="qwen3-8b",
                qos=core.QoS(klass, float(r.choice([200, 1000, 30000]))),
                baseline=core.Resources(base, 0.0,
                                        float(r.integers(0, 6)))), now)
            if r.random() < 0.5:
                pool.ledger.set_rate(name, float(r.integers(50, 2000)), now)
                pool.ledger.bucket(name).level = float(r.integers(0, 5000))
            live.append(name)
            trace.append(("add", name))
        elif op < 0.55:
            name = live[int(r.integers(0, len(live)))]
            rid = f"r{next_rid}"
            next_rid += 1
            d = ctrl.decide(core.AdmissionRequest(
                name, int(r.integers(1, 400)),
                int(r.integers(1, 200)) if r.random() < 0.8 else None,
                now, rid, kv_bytes_per_token=float(r.choice([0, 4096]))))
            trace.append(("decide", rid, decision(d)))
            if d.admitted:
                flying.append(rid)
                if r.random() < 0.7:
                    pool.on_start(rid)
        elif op < 0.72 and flying:
            rid = flying.pop(int(r.integers(0, len(flying))))
            pool.on_complete(rid, int(r.integers(0, 200)), now)
            trace.append(("complete", rid))
        elif op < 0.76 and flying:
            rid = flying.pop(int(r.integers(0, len(flying))))
            rec = pool.on_evict(rid, now)
            trace.append(("evict", rid, rec is not None))
        elif op < 0.80 and len(live) > 1:
            name = live.pop(int(r.integers(0, len(live))))
            pool.remove_entitlement(name, now)
            flying = [f for f in flying if f in pool.in_flight]
            trace.append(("remove", name))
        elif op < 0.83:
            n = int(r.integers(1, 5))
            trace.append(("replicas", n, pool.set_replicas(n)))
        else:
            trace.append(("tick", record_view(pool.tick(now))))
        if step % 20 == 19:
            trace.append(("view", pool_view(pool)))
            trace.append(("columns", {k: v.copy() for k, v in
                                      pool.store.col.items()}))
            dev = pool.store.device_state()
            # copies: a JAX CPU array may share memory with the numpy
            # column it was built from
            trace.append(("mirror", {
                f.name: np.array(getattr(dev, f.name)) if core is J
                else getattr(dev, f.name).numpy().copy()
                for f in dataclasses.fields(dev)}))
    return trace


def equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("seed", range(6))
def test_seeded_pool_lifecycle_identical(seed):
    ref, port = lifecycle(J, seed), lifecycle(T, seed)
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        assert equal(a, b), f"event {i}: {a[0]}"
    kinds = {e[0] for e in ref}
    assert {"add", "decide", "tick", "mirror"} <= kinds


@pytest.mark.parametrize("seed", range(4))
def test_scalar_waterfill_identical(seed):
    r = np.random.default_rng(seed)
    n = int(r.integers(1, 12))
    want = {i: float(r.random() * 100) for i in range(n)}
    weight = {i: float(r.choice([0.0, 0.1, 1.0, 100.0, 1000.0]))
              for i in range(n)}
    cap = float(r.random() * 100 * n)
    assert J.waterfill(cap, want, weight) == T.waterfill(cap, want, weight)


def test_sharded_pool_spec_is_refused():
    """Only a shard count the sharded store cannot split evenly is
    refused, as in the reference; ``shards=4`` builds the sharded store
    (its parity is in ``tests/test_torch_sharded_store.py``)."""
    spec = dataclasses.replace(make_pool(T).spec, shards=3)
    with pytest.raises(ValueError, match="power of two"):
        T.TokenPool(spec, device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        J.TokenPool(dataclasses.replace(make_pool(J).spec, shards=3))
    pool = T.TokenPool(dataclasses.replace(spec, shards=4), device="cpu")
    assert isinstance(pool.store, T.ShardedResidentStore)
