"""The port's fleet planner, entitlement migration and closed planning
loop against the reference's, on the CPU.

- ``FleetPlanner`` over fleets driven for several rounds, at
  ``demand_ewma`` 0.5 and 0.7: the same decisions, unmet replicas and
  rebalance proposals, bit for bit.  At the default EWMA both packages'
  fleet plans also equal their scalar ``Autoscaler``, pool by pool.
- ``PoolManager.migrate_entitlement``: bucket level, debt, burst,
  in-flight records and the demand EWMA travel with the entitlement,
  and the stored route follows it; a failed attach rolls back to the
  source; detaching frees a reserve that re-binds a preempted lease.
- ``PoolManager.plan_quantum`` and ``Gateway.plan_quantum``: decisions
  authorize and provision (or go to the provision hook), a starved
  elastic tenant migrates with its debt, a proposal into a pool that
  failed in the same quantum is skipped, and the stats store counts
  scale transitions.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.gateway import Gateway as JGateway
from repro_torch.gateway import Gateway as TGateway

GATEWAYS = {J: JGateway, T: TGateway}


# -- FleetPlanner over driven fleets ---------------------------------------

def mkpool(core, name, lo=1, hi=4, per_tps=240.0, per_conc=8.0,
           bucket_window_s=4.0):
    kw = {"device": "cpu"} if core is T else {}
    return core.TokenPool(core.PoolSpec(
        name=name, model="m", scaling=core.ScalingBounds(lo, hi),
        per_replica=core.Resources(per_tps, 0.0, per_conc),
        default_max_tokens=64, bucket_window_s=bucket_window_s), **kw)


def ent(core, name, pool, klass="elastic", tps=240.0, conc=2.0):
    return core.EntitlementSpec(
        name=name, tenant_id="t", pool=pool,
        qos=core.QoS(service_class=core.ServiceClass(klass),
                     slo_target_ms=1000.0),
        baseline=core.Resources(tps, 0.0, conc))


def mkrecord(core, t, demand: dict):
    return core.TickRecord(t=t, capacity_tps=0.0, allocations={},
                           priorities={}, debts={}, bursts={},
                           in_flight={}, demand_tps=dict(demand))


def decision(d) -> tuple:
    return (d.pool, d.current, d.desired, d.reason,
            np.float64(d.reserved_tps).tobytes(),
            np.float64(d.demand_tps).tobytes())


def plan_record(plan) -> tuple:
    return ({k: decision(d) for k, d in plan.decisions.items()},
            [dataclasses.astuple(m) for m in plan.migrations],
            {k: np.float64(v).tobytes()
             for k, v in plan.unmet_replicas.items()})


CLASSES = ("guaranteed", "elastic", "spot", "dedicated")


def fleet_params(n_pools: int, seed: int):
    r = np.random.RandomState(seed)
    params = []
    for i in range(n_pools):
        name = f"p{i:02d}"
        params.append((name, dict(hi=int(r.randint(1, 9)),
                                  per_tps=float(r.choice([120.0, 240.0])),
                                  per_conc=float(r.choice([2.0, 8.0]))),
                       [(f"e{i}", CLASSES[i % 4],
                         float(r.choice([0.0, 60.0, 240.0, 333.0])),
                         float(r.choice([0.0, 1.0, 3.0])))]))
    rounds = [{f"p{i:02d}": float(np.where(r.rand() < 0.3, 0.0,
                                           r.uniform(0, 3000)))
               for i in range(n_pools)} for _ in range(8)]
    return params, rounds


def drive_planner(core, params, rounds, cfg, with_scalar=False):
    """Plan ``rounds`` of demand over a fleet with each package's
    ``FleetPlanner``, applying every decision; with ``with_scalar``,
    also check each plan against a scalar ``Autoscaler`` per pool."""
    pools, scalars = {}, {}
    for name, kw, ents in params:
        pool = mkpool(core, name, **kw)
        for ename, klass, tps, conc in ents:
            pool.add_entitlement(ent(core, ename, name, klass, tps, conc))
        pools[name] = pool
        scalars[name] = core.Autoscaler(pool, core.AutoscalerConfig(
            headroom=cfg["headroom"], demand_ewma=cfg["demand_ewma"],
            cooldown_ticks=cfg["cooldown_ticks"]))
    planner = core.FleetPlanner(core.FleetPlannerConfig(**cfg))
    out = []
    for t, demands in enumerate(rounds, start=1):
        records = {n: mkrecord(core, float(t), {"d": demands[n]})
                   for n in pools}
        plan = planner.plan(pools, records, float(t))
        out.append(plan_record(plan))
        for n, pool in pools.items():
            if with_scalar:
                a = scalars[n]
                a.observe_demand(demands[n])
                sd, fd = a.plan(), plan.decisions[n]
                assert (fd.desired, fd.reason, fd.current) == \
                    (sd.desired, sd.reason, sd.current), (n, t)
            pool.set_replicas(plan.decisions[n].desired)
    return out


@pytest.mark.parametrize("ewma", [0.5, 0.7])
@pytest.mark.parametrize("n_pools,seed", [(1, 0), (5, 1), (64, 2)])
def test_fleet_planner_identical(n_pools, seed, ewma):
    params, rounds = fleet_params(n_pools, seed)
    cfg = dict(headroom=1.2, demand_ewma=ewma, cooldown_ticks=3)
    assert drive_planner(T, params, rounds, cfg) == \
        drive_planner(J, params, rounds, cfg)


@pytest.mark.parametrize("core", [J, T], ids=["jax", "port"])
def test_fleet_plan_equals_autoscaler_oracle(core):
    """The fleet plan and the scalar ``Autoscaler`` make the same
    decisions, pool by pool, at the default EWMA, in both packages."""
    params, rounds = fleet_params(16, 7)
    drive_planner(core, params, rounds,
                  dict(headroom=1.2, demand_ewma=0.5, cooldown_ticks=3),
                  with_scalar=True)


def test_planner_plans_on_the_pools_device():
    pools = {"a": mkpool(T, "a")}
    planner = T.FleetPlanner()
    assert planner._device_of(pools) == torch.device("cpu")
    assert T.FleetPlanner(device="cpu").device == torch.device("cpu")
    assert planner.plan({}, {}).decisions == {}


# -- migration and the closed loop ----------------------------------------------

def two_pool_gateway(core, window=1.0):
    mgr = core.PoolManager([mkpool(core, "a", bucket_window_s=window),
                            mkpool(core, "b", bucket_window_s=window)])
    mgr.pool("a").add_entitlement(ent(core, "e", "a", "elastic", 500.0,
                                      conc=4.0))
    gw = GATEWAYS[core](mgr)
    gw.register_route("key", [("a", "e")])
    return mgr, gw


def f64(x) -> bytes:
    return np.float64(x).tobytes()


def migration_record(core) -> list:
    mgr, gw = two_pool_gateway(core)
    r = gw.handle("key", "r1", 32, 32, now=0.0)
    a, b = mgr.pool("a"), mgr.pool("b")
    a.register_deny("e", 480.0, low_priority=False)
    a.tick(1.0)
    st = a.status["e"]
    st.debt, st.burst = 0.6, 0.3
    before = (f64(a.ledger.bucket("e").level), st.admitted_total,
              f64(a.demand_snapshot()["e"]))
    state = mgr.migrate_entitlement("e", "a", "b", now=1.0)
    after = (f64(b.ledger.bucket("e").level),
             b.status["e"].admitted_total, f64(b.demand_snapshot()["e"]))
    moved = ("e" in a.entitlements, "e" in b.entitlements,
             "r1" in a.in_flight, "r1" in b.in_flight,
             f64(b.status["e"].debt), f64(b.status["e"].burst),
             a.provider.is_bound("lease-e"))
    gw.on_complete("r1", 8, latency_s=0.1, now=1.5)
    settled = (b.status["e"].completed_total,
               f64(b.ledger.bucket("e").level))
    r2 = gw.handle("key", "r2", 32, 32, now=2.0)
    return [r._asdict(), state.value, before, after, moved, settled,
            r2._asdict()]


def test_migration_carries_state_identically():
    ref, port = migration_record(J), migration_record(T)
    assert port == ref
    _, _, before, after, moved, _, r2 = port
    assert after == before                   # level, counters, demand
    assert moved == (False, True, False, True, f64(np.float32(0.6)),
                     f64(np.float32(0.3)), False)
    assert r2["pool"] == "b"                 # the route follows


def detach_resync(core) -> list:
    mgr = core.PoolManager([mkpool(core, "a"), mkpool(core, "b")])
    a = mgr.pool("a")
    a.add_entitlement(ent(core, "x", "a", "elastic", 240.0))
    a.add_entitlement(ent(core, "y", "a", "elastic", 240.0))
    a.authorize_replicas(1)
    states = [a.status[n].state.value for n in ("x", "y")]
    bound = "x" if states[1] == "Degraded" else "y"
    mgr.migrate_entitlement(bound, "a", "b")
    return states + [a.status[n].state.value
                     for n in ("x", "y") if n in a.status]


def test_detach_resyncs_rebound_leases():
    assert detach_resync(T) == detach_resync(J)
    assert detach_resync(T)[-1] == "Bound"


def migration_pools(core):
    manager = core.PoolManager()
    kw = {"device": "cpu"} if core is T else {}
    for name in ("src", "dst"):
        pool = manager.add_pool(core.PoolSpec(
            name=name, model="m", scaling=core.ScalingBounds(1, 2),
            per_replica=core.Resources(1000.0, 0.0, 8.0)), **kw)
        pool.set_replicas(1)
    manager.pool("src").add_entitlement(core.EntitlementSpec(
        name="ent", tenant_id="t", pool="src",
        qos=core.QoS(service_class=core.ServiceClass.ELASTIC,
                     slo_target_ms=1000),
        baseline=core.Resources(200.0, 0.0, 4.0)))
    return manager


def rollback_record(core) -> list:
    manager = migration_pools(core)
    src = manager.pool("src")
    dec = core.AdmissionController(src).decide(core.AdmissionRequest(
        entitlement="ent", input_tokens=10, max_tokens=10, arrival_s=0.0,
        request_id="r1"))
    src.status["ent"].debt = 0.25
    level = f64(src.ledger.bucket("ent").level)
    manager.pool("dst").add_entitlement(core.EntitlementSpec(
        name="ent", tenant_id="other", pool="dst",
        qos=core.QoS(service_class=core.ServiceClass.ELASTIC,
                     slo_target_ms=1000),
        baseline=core.Resources(100.0, 0.0, 2.0)))
    with pytest.raises(ValueError):
        manager.migrate_entitlement("ent", "src", "dst", now=0.0)
    out = [dec.admitted, level, "ent" in src.entitlements,
           f64(src.ledger.bucket("ent").level), f64(src.status["ent"].debt),
           src.pool_in_flight()]
    out.append(src.on_complete("r1", 10, now=1.0) is not None)
    out += [src.pool_in_flight(), src.ledger.unknown_settles]
    return out


def test_attach_failure_rolls_back_to_source():
    ref, port = rollback_record(J), rollback_record(T)
    assert port == ref
    assert port[1] == port[3] and port[2] and port[5] == 1
    assert port[6:] == [True, 0, 0]


def skip_record(core) -> list:
    manager = migration_pools(core)
    prop = core.RebalanceProposal(entitlement="ent", src="src", dst="dst",
                                  debt=0.5, baseline_tps=200.0,
                                  reason="debt")

    class StubPlanner:
        def plan(self, pools, records, now):
            return core.FleetPlan(decisions={}, migrations=[prop],
                                  unmet_replicas={})

    manager.planner = StubPlanner()
    manager.pool("dst").set_replicas(0)
    plan = manager.plan_quantum(now=1.0)
    out = [len(plan.skipped), len(plan.applied),
           "ent" in manager.pool("src").entitlements,
           "ent" in manager.pool("dst").entitlements]
    manager.pool("dst").set_replicas(1)
    plan2 = manager.plan_quantum(now=2.0)
    return out + [[p.entitlement for p in plan2.applied],
                  "ent" in manager.pool("dst").entitlements]


def test_plan_quantum_skips_migration_into_failed_pool():
    assert skip_record(T) == skip_record(J) == \
        [1, 0, True, False, ["ent"], True]


def plan_quantum_record(core, hook: bool) -> list:
    mgr = core.PoolManager([mkpool(core, "p", hi=4)])
    mgr.pool("p").add_entitlement(ent(core, "g", "p", "guaranteed", 480.0))
    seen = []
    if hook:
        mgr.provision_hook = lambda pool, d, now: seen.append(
            (pool.spec.name, d.desired))
    plan = mgr.plan_quantum(1.0)
    node = mgr.pool("p").provider.node("p")
    return [plan_record(plan), dict(plan.scale_events), seen,
            mgr.pool("p").replicas, mgr.pool("p")._authorized,
            f64(node.capacity.tokens_per_second)]


@pytest.mark.parametrize("hook", [False, True])
def test_plan_quantum_applies_and_authorizes(hook):
    port = plan_quantum_record(T, hook)
    assert port == plan_quantum_record(J, hook)
    assert port[4] == 2 and port[3] == (1 if hook else 2)


def rebalance_record(core) -> list:
    mgr = core.PoolManager([mkpool(core, "a", hi=2), mkpool(core, "b")])
    a = mgr.pool("a")
    a.add_entitlement(ent(core, "g", "a", "guaranteed", 240.0))
    a.add_entitlement(ent(core, "el", "a", "elastic", 240.0))
    mgr.planner = core.FleetPlanner(core.FleetPlannerConfig(
        debt_migrate_threshold=0.2, starve_persistence_ticks=2,
        migrate_cooldown_ticks=3))
    mgr.provision_hook = lambda *args: None
    a.set_replicas(1)
    out = []
    for t in range(1, 8):
        a.register_deny("g", 240.0, low_priority=False)
        if "el" in a.entitlements:
            a.register_deny("el", 480.0, low_priority=True)
        plan = mgr.plan_quantum(float(t))
        out.append((plan_record(plan),
                    [dataclasses.astuple(p) for p in plan.applied],
                    dict(plan.scale_events)))
    b = mgr.pool("b")
    out.append((f64(b.status["el"].debt), b.status["el"].state.value))
    return out


def test_rebalance_migrates_starved_elastic_with_debt():
    port = rebalance_record(T)
    assert port == rebalance_record(J)
    applied = [p for _, props, _ in port[:-1] for p in props]
    assert len(applied) == 1
    ent_name, src, dst, debt, _, reason = applied[0]
    assert (ent_name, src, dst, reason) == ("el", "a", "b", "debt")
    assert debt > 0.2 and port[-1][1] == "Bound"


def gateway_stats(core) -> list:
    mgr = core.PoolManager([mkpool(core, "p", hi=4)])
    mgr.pool("p").add_entitlement(ent(core, "g", "p", "guaranteed", 480.0))
    gw = GATEWAYS[core](mgr)
    out = []
    for t, rate in ((1.0, 0.0), (2.0, 4000.0), (3.0, 0.0)):
        mgr.pool("p").register_deny("g", rate, low_priority=False)
        gw.plan_quantum(t)
        out.append([gw.store.get(k) for k in
                    ("replicas:p", "scale_ups:p", "scale_downs:p")])
    return out


def test_gateway_plan_quantum_surfaces_stats():
    port = gateway_stats(T)
    assert port == gateway_stats(J)
    assert float(port[0][0]) == 2.0 and float(port[0][1]) == 1.0
