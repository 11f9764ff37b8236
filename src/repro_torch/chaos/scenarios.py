"""Library of scripted incident scenarios (the paper's Experiments
1–3 failure modes, condensed to seconds-long seeded timelines).

Every scenario keeps the replay-parity contract of
``Gateway.handle_quantum``: workload routes are single-leg or share
one common pool order, so the scalar, quantum and fast-path pipelines
must be decision-identical — :mod:`repro_torch.chaos.replay` asserts it.

All five run with every invariant checker enabled and a bounded
guaranteed-tier P99 (``p99_bound_s``); sizes are deliberately small
(seconds of simulated time, single-digit replica fleets) so the whole
suite stays test-runnable while still driving failure, retry-storm,
surge, drain and churn paths through the real control plane.

Counterpart of ``repro/chaos/scenarios.py``.
"""
from __future__ import annotations

from repro_torch.core import ServiceClass
from repro_torch.chaos.scenario import Scenario, ScenarioEvent


def _wl(name: str, sc: ServiceClass, slots: float, slo_ms: float,
        rate: float, pools: tuple, retries: int = 1, **kw) -> dict:
    kw.update(name=name, service_class=sc, slots=slots, slo_ms=slo_ms,
              rate_rps=rate, pools=pools, max_retries=retries,
              in_tokens=32, out_tokens=32)
    return kw


CORRELATED_FAILURE = Scenario(
    name="correlated_failure",
    description=("both replicas of the preferred pool die 0.4s apart "
                 "mid-traffic; guaranteed traffic must ride out the "
                 "outage on the spill pool until staggered recovery"),
    seed=11, duration_s=10.0, p99_bound_s=6.0,
    sites=(
        dict(name="east", n_replicas=2, replica_slots=8,
             replica_tps=160.0),
        dict(name="west", n_replicas=1, replica_slots=8,
             replica_tps=160.0),
    ),
    workloads=(
        _wl("gold", ServiceClass.GUARANTEED, 4, 800.0, 2.0,
            ("east", "west"), retries=2),
        _wl("flex", ServiceClass.ELASTIC, 4, 2000.0, 5.0,
            ("east", "west")),
    ),
    events=(
        ScenarioEvent(3.0, "fail_replica", dict(pool="east", idx=0)),
        ScenarioEvent(3.4, "fail_replica", dict(pool="east", idx=1)),
        ScenarioEvent(6.0, "recover_replica", dict(pool="east", idx=0)),
        ScenarioEvent(6.6, "recover_replica", dict(pool="east", idx=1)),
    ),
)


RETRY_STORM = Scenario(
    name="retry_storm",
    description=("an elastic tenant floods a single pool at several "
                 "times its entitlement with aggressive client "
                 "retries; denied keys re-submit on jittered backoff "
                 "(thundering herd) while the guaranteed tenant must "
                 "stay inside its latency budget"),
    seed=23, duration_s=10.0, p99_bound_s=6.0,
    retry_base_s=0.2, retry_jitter_s=0.6,
    sites=(
        dict(name="core", n_replicas=1, replica_slots=8,
             replica_tps=160.0),
    ),
    workloads=(
        _wl("gold", ServiceClass.GUARANTEED, 4, 800.0, 1.5, ("core",),
            retries=2),
        _wl("burst", ServiceClass.ELASTIC, 3, 2000.0, 12.0, ("core",),
            retries=4),
    ),
    events=(),
)


SURGE_FLAP = Scenario(
    name="surge_flap",
    description=("elastic demand flaps between idle and several times "
                 "pool capacity every two seconds; admission must "
                 "track the square wave without leaking rows or debt"),
    seed=37, duration_s=12.0, p99_bound_s=6.0,
    sites=(
        dict(name="east", n_replicas=1, replica_slots=8,
             replica_tps=160.0),
        dict(name="west", n_replicas=1, replica_slots=8,
             replica_tps=160.0),
    ),
    workloads=(
        _wl("gold", ServiceClass.GUARANTEED, 4, 800.0, 2.0,
            ("east", "west"), retries=2),
        _wl("surge", ServiceClass.ELASTIC, 3, 2000.0, 2.0,
            ("east", "west")),
    ),
    events=(
        ScenarioEvent(2.0, "set_rate", dict(workload="surge", rate=18.0)),
        ScenarioEvent(4.0, "set_rate", dict(workload="surge", rate=1.0)),
        ScenarioEvent(6.0, "set_rate", dict(workload="surge", rate=20.0)),
        ScenarioEvent(8.0, "set_rate", dict(workload="surge", rate=2.0)),
    ),
)


SLOW_DRAIN = Scenario(
    name="slow_drain",
    description=("demand collapses under an autoscaled fleet — the "
                 "planner drains surplus replicas (no new dispatch, "
                 "residuals finish) — then surges back through the "
                 "provisioning lag"),
    seed=41, duration_s=16.0, p99_bound_s=6.0,
    autoscale=True, provision_lag_s=1.0, drain_s=1.5,
    sites=(
        dict(name="core", n_replicas=3, replica_slots=8,
             replica_tps=160.0, max_replicas=3),
    ),
    workloads=(
        _wl("gold", ServiceClass.GUARANTEED, 4, 800.0, 2.0, ("core",),
            retries=2),
        _wl("batch", ServiceClass.ELASTIC, 6, 2000.0, 8.0, ("core",)),
    ),
    events=(
        ScenarioEvent(4.0, "set_rate", dict(workload="batch", rate=1.0)),
        ScenarioEvent(10.0, "set_rate", dict(workload="batch", rate=8.0)),
    ),
)


CHURN_MIGRATION = Scenario(
    name="churn_migration",
    description=("standby entitlements join, migrate across pools and "
                 "leave while live traffic runs and a replica fails — "
                 "store rows, bucket levels and debt must survive the "
                 "churn without leaks"),
    seed=53, duration_s=12.0, p99_bound_s=6.0,
    sites=(
        dict(name="east", n_replicas=2, replica_slots=8,
             replica_tps=160.0),
        dict(name="west", n_replicas=1, replica_slots=8,
             replica_tps=160.0),
    ),
    workloads=(
        _wl("gold", ServiceClass.GUARANTEED, 4, 800.0, 2.0,
            ("east", "west"), retries=2),
        _wl("flex", ServiceClass.ELASTIC, 4, 2000.0, 5.0,
            ("east", "west")),
    ),
    events=(
        ScenarioEvent(2.0, "add_entitlement", dict(
            pool="east", name="standby-a",
            service_class=ServiceClass.GUARANTEED,
            slo_ms=1000.0, tokens_per_second=40.0, slots=1.0)),
        ScenarioEvent(2.5, "add_entitlement", dict(
            pool="east", name="standby-b",
            service_class=ServiceClass.ELASTIC,
            slo_ms=2000.0, tokens_per_second=30.0, slots=1.0)),
        ScenarioEvent(4.0, "migrate", dict(
            entitlement="standby-a", src="east", dst="west")),
        ScenarioEvent(5.0, "fail_replica", dict(pool="west", idx=0)),
        ScenarioEvent(6.0, "remove_entitlement", dict(
            pool="east", name="standby-b")),
        ScenarioEvent(7.0, "recover_replica", dict(pool="west", idx=0)),
        ScenarioEvent(8.0, "remove_entitlement", dict(
            pool="west", name="standby-a")),
    ),
)


#: the library, in documentation order
SCENARIOS: tuple = (
    CORRELATED_FAILURE,
    RETRY_STORM,
    SURGE_FLAP,
    SLOW_DRAIN,
    CHURN_MIGRATION,
)


def by_name(name: str) -> Scenario:
    for s in SCENARIOS:
        if s.name == name:
            return s
    raise KeyError(name)
