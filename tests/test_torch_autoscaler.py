"""The port's scalar ``Autoscaler`` against the reference's, on the CPU.

Each case drives one pool of each package through the same entitlements,
replica changes and demand observations, and every ``ScaleDecision``
(desired, current, reason, reserved and demand tok/s, bit for bit) must
be identical.  The cases cross every branch of the policy: the reserved
floor in all three dimensions, spot and degraded and expired
entitlements, the first-observation seeding, the EWMA, the exact
replica boundary 400 · 1.2 / 240 (which f64 arithmetic would round the
other way), an unsatisfiable dimension, the cooldown hold, scale-down,
flapping and the clamps; plus seeded random demand streams.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro_torch.core as T

PACKAGES = {"jax": J, "port": T}


def mkpool(core, lo=1, hi=10, per_tps=240.0, per_conc=16.0, per_kv=0.0):
    kw = {"device": "cpu"} if core is T else {}
    return core.TokenPool(core.PoolSpec(
        name="p", model="m", scaling=core.ScalingBounds(lo, hi),
        per_replica=core.Resources(per_tps, per_kv, per_conc)), **kw)


def ent(core, name, klass="guaranteed", tps=240.0, conc=2.0, kv=0.0):
    return core.EntitlementSpec(
        name=name, tenant_id="t", pool="p",
        qos=core.QoS(service_class=core.ServiceClass(klass),
                     slo_target_ms=500.0),
        baseline=core.Resources(tps, kv, conc))


def decision(d) -> tuple:
    return (d.current, d.desired, d.reason, d.pool,
            np.float64(d.reserved_tps).tobytes(),
            np.float64(d.demand_tps).tobytes())


# Each scenario takes a package and returns the decisions it made.

def reserved_floor(core):
    pool = mkpool(core)
    pool.add_entitlement(ent(core, "a", "guaranteed", 480.0))
    pool.add_entitlement(ent(core, "b", "elastic", 240.0))
    a = core.Autoscaler(pool)
    a.observe_demand(0.0)
    return [a.plan()]


def spot_reserves_nothing(core):
    pool = mkpool(core)
    pool.add_entitlement(ent(core, "s", "spot", 0.0, conc=8.0))
    pool.add_entitlement(ent(core, "pre", "preemptible", 0.0))
    a = core.Autoscaler(pool)
    a.observe_demand(0.0)
    return [a.plan()]


def degraded_counts(core):
    pool = mkpool(core)
    pool.add_entitlement(ent(core, "a", "guaranteed", 480.0))
    pool.status["a"].state = core.EntitlementState.DEGRADED
    a = core.Autoscaler(pool)
    a.observe_demand(0.0)
    return [a.plan()]


def expired_does_not_count(core):
    pool = mkpool(core)
    pool.add_entitlement(ent(core, "a", "guaranteed", 480.0))
    pool.status["a"].state = core.EntitlementState.EXPIRED
    a = core.Autoscaler(pool)
    a.observe_demand(0.0)
    return [a.plan()]


def concurrency_floor(core):
    pool = mkpool(core, per_conc=4.0)
    pool.add_entitlement(ent(core, "a", "guaranteed", 240.0, conc=12.0))
    a = core.Autoscaler(pool)
    a.observe_demand(0.0)
    return [a.plan()]


def demand_scale_up(core):
    pool = mkpool(core)
    pool.add_entitlement(ent(core, "a", "guaranteed", 240.0))
    a = core.Autoscaler(pool)
    a.observe_demand(790.0)
    return [a.plan()]


def first_observation_seeds(core):
    a = core.Autoscaler(mkpool(core))
    a.observe_demand(960.0)
    return [a.plan()]


def ewma_after_seed(core):
    a = core.Autoscaler(mkpool(core))
    out = []
    for d in (1000.0, 0.0, 333.3, 1e-3, 77.7):
        a.observe_demand(d)
        out.append(a.plan())
    return out


def replica_boundary(core):
    """400 · 1.2 / 240 = 2 exactly in f64 but 2.0000002 in f32: the f32
    policy scales to 3."""
    a = core.Autoscaler(mkpool(core))
    a.observe_demand(400.0)
    return [a.plan()]


def step_reads_tick_record(core):
    pool = mkpool(core)
    pool.add_entitlement(ent(core, "a", "guaranteed", 240.0))
    pool.register_deny("a", 960.0, low_priority=False)
    rec = pool.tick(1.0)
    d = core.Autoscaler(pool).step(rec)
    return [d, pool.replicas]


def step_reads_snapshot(core):
    pool = mkpool(core)
    pool.add_entitlement(ent(core, "a", "guaranteed", 240.0))
    pool.register_deny("a", 960.0, low_priority=False)
    pool.tick(1.0)
    return [core.Autoscaler(pool).step()]


def scaled(core, cooldown):
    pool = mkpool(core)
    pool.add_entitlement(ent(core, "a", "guaranteed", 240.0))
    pool.set_replicas(6)
    return pool, core.Autoscaler(
        pool, core.AutoscalerConfig(cooldown_ticks=cooldown))


def cooldown_then_scale_down(core):
    pool, a = scaled(core, 3)
    out = []
    for _ in range(3):
        a.observe_demand(0.0)
        out.append(a.plan())
    return out


def flap_resets_cooldown(core):
    pool, a = scaled(core, 3)
    out = []
    for d in (0.0, 8000.0, 0.0, 0.0):
        a.observe_demand(d)
        out.append(a.plan())
    return out


def scale_up_immediate(core):
    pool, a = scaled(core, 5)
    pool.set_replicas(1)
    a.observe_demand(2000.0)
    return [a.plan()]


def steady_resets_counter(core):
    pool, a = scaled(core, 2)
    out = []
    for n in (None, 1, 6):
        if n is not None:
            pool.set_replicas(n)
        a.observe_demand(0.0)
        out.append(a.plan())
    return out


def max_clamp(core):
    a = core.Autoscaler(mkpool(core, hi=3))
    a.observe_demand(1e6)
    return [a.plan()]


def min_clamp(core):
    pool = mkpool(core, lo=2)
    pool.set_replicas(2)
    a = core.Autoscaler(pool)
    a.observe_demand(0.0)
    return [a.plan()]


def unsatisfiable_dimension(core):
    """Per-replica KV 0 with a KV baseline: the need is infinite and
    clamps to maxReplicas instead of overflowing the ceil."""
    pool = mkpool(core, hi=4)
    pool.add_entitlement(ent(core, "kv", "guaranteed", 10.0, conc=1.0,
                             kv=float(1 << 30)))
    a = core.Autoscaler(pool)
    a.observe_demand(0.0)
    return [a.plan()]


def degraded_floor_heals(core):
    pool = mkpool(core, hi=4)
    a = core.Autoscaler(pool)
    pool.authorize_replicas(1)
    st = pool.add_entitlement(ent(core, "big", "guaranteed", 480.0,
                                  conc=0.0))
    a.observe_demand(0.0)
    d = a.plan()
    pool.set_replicas(d.desired, planned=True)
    return [st.value, d, pool.status["big"].state.value]


SCENARIOS = [reserved_floor, spot_reserves_nothing, degraded_counts,
             expired_does_not_count, concurrency_floor, demand_scale_up,
             first_observation_seeds, ewma_after_seed, replica_boundary,
             step_reads_tick_record, step_reads_snapshot,
             cooldown_then_scale_down, flap_resets_cooldown,
             scale_up_immediate, steady_resets_counter, max_clamp,
             min_clamp, unsatisfiable_dimension, degraded_floor_heals]


def normalized(out: list) -> list:
    return [decision(x) if hasattr(x, "desired") else x for x in out]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[s.__name__ for s in SCENARIOS])
def test_decisions_identical(scenario):
    ref, port = scenario(J), scenario(T)
    assert normalized(port) == normalized(ref)
    assert all(type(x).__module__.startswith("repro_torch")
               for x in port if hasattr(x, "desired"))


def test_scenarios_reach_every_reason():
    reasons = {x.reason for s in SCENARIOS for x in s(T)
               if hasattr(x, "desired")}
    assert reasons == {"steady", "scale_up:reserved", "scale_up:demand",
                       "hold:cooldown", "scale_down"}


def test_replica_boundary_is_f32():
    (d,) = replica_boundary(T)
    assert d.desired == 3                  # f64 would give 2


@pytest.mark.parametrize("seed", range(6))
def test_seeded_demand_streams(seed):
    """Random demand streams (bursts, silences, values at replica
    boundaries) over pools of random bounds and reserves, with each
    decision applied as a planner would."""
    rng = np.random.RandomState(seed)
    hi = int(rng.randint(1, 9))
    per_tps = float(rng.choice([120.0, 240.0, 250.0]))
    tps = float(rng.choice([0.0, 60.0, 240.0, 333.0]))
    klass = str(rng.choice(["guaranteed", "elastic", "spot"]))
    cfg = dict(demand_ewma=float(rng.choice([0.5, 0.7, 0.9])),
               cooldown_ticks=int(rng.randint(1, 5)),
               headroom=float(rng.choice([1.0, 1.2, 1.5])))
    stream = np.where(rng.rand(40) < 0.3, 0.0,
                      rng.choice([per_tps / 1.2, per_tps * 2 / 1.2,
                                  rng.uniform(0, 3000)], 40))

    def run(core):
        pool = mkpool(core, hi=hi, per_tps=per_tps)
        pool.add_entitlement(ent(core, "e", klass, tps))
        a = core.Autoscaler(pool, core.AutoscalerConfig(**cfg))
        out = []
        for d in stream:
            a.observe_demand(float(d))
            dec = a.plan()
            pool.set_replicas(dec.desired)
            out.append(dec)
        return out

    assert normalized(run(T)) == normalized(run(J))


def test_config_not_shared_between_instances():
    a1, a2 = T.Autoscaler(mkpool(T)), T.Autoscaler(mkpool(T))
    assert a1.config is not a2.config
    with pytest.raises(dataclasses.FrozenInstanceError):
        a1.config.headroom = 9.9
