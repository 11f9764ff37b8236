"""Experiment 3 (entitlement-driven autoscaling and rebalancing) through
the port's simulator against the reference's, on the CPU.

The reference run is ``benchmarks/experiment3_autoscale.py::build()``
for the full 90 s; the port's simulator is rebuilt from that object
before it runs (workloads, sites, coefficients, planner settings,
provisioning lag, drain time, the random stream and the scheduled
surge, outage and recovery), on ``device="cpu"``.  Both run in quantum
admission (each step's arrivals through ``Gateway.handle_quantum`` and
``admit_quantum``) and in scalar admission.  Compared live:

- every request's outcome, deny reason and timestamps;
- the replica timeline and every tick record;
- every ``ScaleDecision`` of every planning round, the scale events,
  the applied and skipped migrations with their carried debt;
- the gateway's ``replicas:``, ``scale_ups:``, ``scale_downs:`` and
  ``migrations:`` counters;
- the claim rows (C1–C4) that ``experiment3_autoscale.run`` reports.

``examples/fleet_autoscaling.py``'s fleet is compared the same way.
"""
import dataclasses

import numpy as np
import pytest

import repro.core as J
import repro.serving as JS
import repro_torch.core as T
import repro_torch.serving as TS
from benchmarks import experiment3_autoscale as exp3


def port_workload(w) -> TS.Workload:
    fields = dataclasses.asdict(w)
    fields["service_class"] = T.ServiceClass(w.service_class.value)
    return TS.Workload(**fields)


def port_multi_sim(ref) -> TS.MultiPoolSimulator:
    """The reference ``MultiPoolSimulator`` ``ref``, rebuilt in the port
    on the CPU before it runs."""
    spec = next(iter(ref.manager.pools.values())).spec
    planner = ref.manager.planner
    sim = TS.MultiPoolSimulator(
        [port_workload(w) for w in ref.workloads.values()],
        [TS.PoolSite(**dataclasses.asdict(s)) for s in ref.sites.values()],
        coeff=T.PriorityCoefficients(
            **dataclasses.asdict(spec.coefficients)),
        dt=ref.dt, accounting_interval_s=spec.accounting_interval_s,
        bucket_window_s=spec.bucket_window_s,
        spill_policy=ref.gateway.spill_policy,
        admission_mode=ref.admission_mode, autoscale=ref.autoscale,
        planner_config=T.FleetPlannerConfig(
            **dataclasses.asdict(planner.config)),
        provision_lag_s=ref.provision_lag_s, drain_s=ref.drain_s,
        device="cpu")
    sim.rng.set_state(ref.rng.get_state())
    for t, _, kind, payload in sorted(ref._events, key=lambda e: e[:2]):
        sim.at(t, kind, **payload)
    return sim


def outcomes(sim) -> list:
    return [(r.request_id, r.entitlement, r.state.value, r.arrival_s,
             r.admitted_s, r.first_token_s, r.finished_s, r.priority,
             r.deny_reason, r.retry_after_s, r.pool, r.spill_hops,
             len(r.output_tokens)) for r in sim.requests.values()]


def decision(d) -> tuple:
    return (d.pool, d.current, d.desired, d.reason,
            np.float64(d.reserved_tps).tobytes(),
            np.float64(d.demand_tps).tobytes())


def plans(sim) -> list:
    return [(t, {k: decision(d) for k, d in p.decisions.items()},
             dict(p.scale_events), dict(p.preempted),
             {k: np.float64(v).tobytes()
              for k, v in p.unmet_replicas.items()},
             [dataclasses.astuple(m) for m in p.migrations],
             [dataclasses.astuple(m) for m in p.applied],
             [dataclasses.astuple(m) for m in p.skipped])
            for t, p in sim.plans]


def ticks(sim) -> dict:
    return {name: [(h.t, h.capacity_tps, h.allocations, h.priorities,
                    h.debts, h.bursts, h.in_flight, h.demand_tps)
                   for h in recs]
            for name, recs in sim.tick_records.items()}


def counters(sim) -> dict:
    keys = [f"{kind}:{pool}" for kind in ("replicas", "scale_ups",
                                          "scale_downs")
            for pool in sim.sites]
    keys += [f"{kind}:{w}@{p}" for kind in ("migrations", "migrated_to")
             for w in sim.workloads for p in sim.sites]
    return {k: sim.gateway.store.get(k) for k in keys}


def claims(sim, summary) -> dict:
    """The claim rows of ``experiment3_autoscale.run``, from a finished
    simulation of either package."""
    east = sim.replica_timeline["east"]
    west = sim.replica_timeline["west"]
    reasons: dict = {}
    for _, plan in sim.plans:
        for d in plan.decisions.values():
            reasons[d.reason] = reasons.get(d.reason, 0) + 1
    p99 = exp3.windowed_p99(sim, "assist", [
        ("before", 5.0, 20.0), ("surge", 20.0, 30.0),
        ("outage", 30.0, 55.0), ("after", 70.0, 90.0)])
    return {
        "p99_assist": {k: repr(v) for k, v in p99.items()},
        "peak_east_before_outage": max(
            (n for t, n in east if t < 30.0), default=0),
        "surge_scaled_east": any(n >= 3 for t, n in east
                                 if 20.0 <= t < 30.0),
        "west_peak": max((n for _, n in west), default=0),
        "final_east": east[-1][1],
        "migrations": [(m.entitlement, m.src, m.dst, m.debt, m.reason)
                       for m in summary["migrations"]],
        "scale_reasons": reasons,
    }


@pytest.fixture(scope="module", params=["quantum", "scalar"])
def exp3_runs(request):
    """Both packages' runs of one admission mode, and the number of
    ``admit_quantum`` calls the port made (its plain version, on the
    CPU)."""
    import repro_torch.kernels.admit_quantum.admit_quantum as aq
    ref = exp3.build()
    ref.admission_mode = request.param
    port = port_multi_sim(ref)
    assert port.admission_mode == request.param
    calls = []
    plain = aq.reference_admit_scan

    def counted(*a, **kw):
        calls.append(a[8].shape[0])
        return plain(*a, **kw)

    aq.reference_admit_scan = counted
    try:
        rport = port.run(90.0)
    finally:
        aq.reference_admit_scan = plain
    return ref, ref.run(90.0), port, rport, len(calls)


def test_quantum_mode_admits_through_admit_quantum(exp3_runs):
    ref, *_, calls = exp3_runs
    assert bool(calls) == (ref.admission_mode == "quantum")


def test_requests_identical(exp3_runs):
    ref, _, port, _, _ = exp3_runs
    a, b = outcomes(ref), outcomes(port)
    assert len(a) == len(b) > 300
    for x, y in zip(a, b):
        assert x == y, x[0]


def test_replica_timeline_and_ticks_identical(exp3_runs):
    ref, rref, port, rport, _ = exp3_runs
    assert rport["replica_timeline"] == rref["replica_timeline"]
    assert ticks(port) == ticks(ref)


def test_every_plan_identical(exp3_runs):
    ref, _, port, _, _ = exp3_runs
    assert len(port.plans) == len(ref.plans) == 89      # one per tick
    assert plans(port) == plans(ref)


def test_migrations_carry_the_same_debt(exp3_runs):
    _, rref, _, rport, _ = exp3_runs
    got = [dataclasses.astuple(m) for m in rport["migrations"]]
    assert got == [dataclasses.astuple(m) for m in rref["migrations"]]
    assert [m[:3] for m in got] == [("analytics@east", "east", "west")]
    assert got[0][3] > 0.0                       # debt carried


def test_gateway_counters_identical(exp3_runs):
    ref, _, port, _, _ = exp3_runs
    assert counters(port) == counters(ref)
    assert float(port.gateway.store.get("scale_ups:east")) >= 1.0


def test_claim_rows_identical(exp3_runs):
    ref, rref, port, rport, _ = exp3_runs
    got = claims(port, rport)
    assert got == claims(ref, rref)
    assert got["surge_scaled_east"]                      # C1
    assert got["scale_reasons"]["scale_up:demand"] > 0
    assert got["migrations"][0][4] == "starved_demand"   # C2
    assert got["scale_reasons"]["scale_down"] > 0        # C4
    assert got["final_east"] < 3


def test_summary_identical(exp3_runs):
    _, rref, _, rport, _ = exp3_runs
    assert repr(rport["per_workload"]) == repr(rref["per_workload"])


def test_chip_smoke_builds_the_same_experiment():
    """``chip_smoke.py`` keeps its own copy of Experiment 3's parameters
    (it imports nothing of ``benchmarks/``): its run equals the
    benchmark's, rebuilt in the port."""
    import chip_smoke
    ours = chip_smoke.exp3_sim(TS, T, "quantum", "cpu")
    theirs = port_multi_sim(exp3.build())
    ours.run(40.0)
    theirs.run(40.0)
    assert outcomes(ours) == outcomes(theirs)
    assert plans(ours) == plans(theirs)


def fleet_example(core, serving, **kw):
    """``examples/fleet_autoscaling.py``'s fleet and incident script."""
    sc, wl = core.ServiceClass, serving.Workload
    sim = serving.MultiPoolSimulator(
        workloads=[
            wl(name="assist", service_class=sc.GUARANTEED, slots=4,
               slo_ms=500.0, rate_rps=1.0, pools=("east", "west"),
               max_retries=2),
            wl(name="analytics", service_class=sc.ELASTIC, slots=8,
               slo_ms=2000.0, rate_rps=0.8, pools=("east",),
               max_retries=2)],
        sites=[serving.PoolSite("east", n_replicas=2, replica_slots=8,
                                replica_tps=120.0, max_replicas=3),
               serving.PoolSite("west", n_replicas=1, replica_slots=8,
                                replica_tps=120.0, max_replicas=3)],
        autoscale=True, provision_lag_s=3.0, drain_s=2.0,
        planner_config=core.FleetPlannerConfig(starve_persistence_ticks=5),
        **kw)
    sim.at(15.0, "set_rate", workload="analytics", rate=3.2)
    sim.at(25.0, "fail_replica", pool="east", idx=1)
    sim.at(25.0, "fail_replica", pool="east", idx=2)
    sim.at(45.0, "recover_replica", pool="east", idx=1)
    sim.at(50.0, "set_rate", workload="analytics", rate=0.8)
    return sim


def test_fleet_example_identical():
    ref = fleet_example(J, JS)
    port = fleet_example(T, TS, device="cpu")
    rref, rport = ref.run(70.0), port.run(70.0)
    assert outcomes(port) == outcomes(ref)
    assert plans(port) == plans(ref)
    assert rport["replica_timeline"] == rref["replica_timeline"]
    assert rport["migrations"] and rport["migrations"][0].debt > 0
