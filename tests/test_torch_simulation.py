"""The paper's experiments through the port's simulators, against the
reference's, on the CPU.

Experiment 1 (cross-class protection, both arms) and Experiment 2
(debt-based fair share, with its replica outage) run at their full
durations through ``repro_torch.serving.ServingSimulator``, built from
the reference simulators that the benchmarks' own ``build()`` returns:
workloads, replicas, pool coefficients and scheduled events are read
off those objects field by field.  The multi-pool routing scenario of
``examples/multi_pool_routing.py`` runs through both
``MultiPoolSimulator``s in both admission modes (quantum mode drives
``Gateway.handle_quantum`` and ``admit_quantum``; the fleet ticks are
``PoolManager.tick``).  Every request's outcome and timestamps, the
timeline and every tick record must be identical, and so must the
claim rows the benchmarks compute from them.
"""
import dataclasses

import pytest

import repro.core as J
import repro.serving as JS
import repro_torch.core as T
import repro_torch.serving as TS
from benchmarks import experiment1_protection as exp1
from benchmarks import experiment2_fairshare as exp2


def port_workload(w) -> TS.Workload:
    fields = dataclasses.asdict(w)
    fields["service_class"] = T.ServiceClass(w.service_class.value)
    return TS.Workload(**fields)


def port_serving_sim(ref) -> TS.ServingSimulator:
    """The reference ``ServingSimulator`` ``ref``, rebuilt in the port
    on the CPU before it runs: same workloads, fleet, coefficients,
    pool settings and scheduled events."""
    spec = ref.pool.spec
    r0 = ref.replicas[0]
    sim = TS.ServingSimulator(
        [port_workload(w) for w in ref.workloads.values()],
        replica_slots=r0.slots, replica_tps=r0.rate_tps,
        n_replicas=len(ref.replicas), admission=ref.admission,
        coeff=T.PriorityCoefficients(
            **dataclasses.asdict(spec.coefficients)),
        dt=ref.dt, hedge_after_s=ref.hedge_after_s,
        accounting_interval_s=spec.accounting_interval_s,
        fixed_avg_slo_ms=spec.fixed_avg_slo_ms,
        bucket_window_s=spec.bucket_window_s, device="cpu")
    for t, _, kind, payload in sorted(ref._events, key=lambda e: e[:2]):
        sim.at(t, kind, **payload)
    return sim


def outcomes(sim) -> list:
    return [(r.request_id, r.entitlement, r.state.value, r.arrival_s,
             r.admitted_s, r.first_token_s, r.finished_s, r.priority,
             r.deny_reason, r.retry_after_s, r.pool, r.spill_hops,
             len(r.output_tokens)) for r in sim.requests.values()]


def history(records) -> list:
    return [(h.t, h.capacity_tps, h.allocations, h.priorities, h.debts,
             h.bursts, h.in_flight, h.demand_tps) for h in records]


def timeline(sim) -> list:
    return [dataclasses.astuple(p) for p in sim.timeline]


def assert_same_run(ref, port) -> None:
    a, b = outcomes(ref), outcomes(port)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y, x[0]
    assert timeline(ref) == timeline(port)
    assert history(ref.pool.history) == history(port.pool.history)


@pytest.mark.parametrize("admission", [True, False])
def test_experiment1_identical(admission):
    ref = exp1.build(admission=admission)
    port = port_serving_sim(ref)
    ref.run(90.0)
    port.run(90.0)
    assert_same_run(ref, port)
    # repr: exact for floats, and equal for two NaNs (a phase with no
    # samples)
    for ent in ("guaranteed-a", "spot-b", "guaranteed-c"):
        for t0, t1 in ((0, 30), (30, 60), (60, 90)):
            assert repr(exp1.phase_ttft_p99(ref, ent, t0, t1)) == \
                repr(exp1.phase_ttft_p99(port, ent, t0, t1))
    summary = port.summary()
    assert repr(summary["per_entitlement"]) == \
        repr(ref.summary()["per_entitlement"])
    assert summary["max_waiting"] == ref.summary()["max_waiting"]
    if admission:
        # overload: the port's gateway denies spot traffic
        assert any(r.state.value == "denied" and r.entitlement == "spot-b"
                   for r in port.requests.values())


def test_experiment2_identical():
    ref = exp2.build()
    port = port_serving_sim(ref)
    ref.run(300.0)
    port.run(300.0)
    assert_same_run(ref, port)
    for name in ref.workloads:
        assert ref.pool.status[name].denied_low_priority == \
            port.pool.status[name].denied_low_priority
        assert ref.pool.priority(name) == port.pool.priority(name)


def routing_sim(core, serving, mode: str, **kw):
    """``examples/multi_pool_routing.py``: a guaranteed tenant that
    prefers east, a spot tenant that prefers west, east's only replica
    lost from 20 s to 40 s."""
    sim = serving.MultiPoolSimulator(
        workloads=[
            serving.Workload(name="prod-chat",
                             service_class=core.ServiceClass.GUARANTEED,
                             slots=6, slo_ms=500.0, rate_rps=1.4,
                             pools=("east", "west")),
            serving.Workload(name="batch-eval",
                             service_class=core.ServiceClass.SPOT,
                             slots=8, slo_ms=30000.0, rate_rps=3.0,
                             pools=("west", "east"), max_retries=1)],
        sites=[serving.PoolSite("east", n_replicas=1, replica_slots=8,
                                replica_tps=120.0),
               serving.PoolSite("west", n_replicas=2, replica_slots=8,
                                replica_tps=120.0)],
        admission_mode=mode, **kw)
    sim.at(20.0, "fail_replica", pool="east", idx=0)
    sim.at(40.0, "recover_replica", pool="east", idx=0)
    return sim


@pytest.mark.parametrize("mode", ["quantum", "scalar"])
def test_multi_pool_routing_identical(mode):
    import repro_torch.kernels.admit_quantum.admit_quantum as aq
    ref = routing_sim(J, JS, mode)
    port = routing_sim(T, TS, mode, device="cpu")
    calls = []
    plain = aq.reference_admit_scan

    def counted(*a, **kw):
        calls.append(a[8].shape[0])
        return plain(*a, **kw)

    aq.reference_admit_scan = counted
    try:
        rref = ref.run(60.0)
        rport = port.run(60.0)
    finally:
        aq.reference_admit_scan = plain
    a, b = outcomes(ref), outcomes(port)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x == y, x[0]
    for pname in ("east", "west"):
        assert history(ref.tick_records[pname]) == \
            history(port.tick_records[pname])
    assert repr(rport["per_workload"]) == repr(rref["per_workload"])
    assert rport["replica_timeline"] == rref["replica_timeline"]
    prod = rport["per_workload"]["prod-chat"]
    assert prod["spilled"] > 0 and prod["admitted_by_pool"]["west"] > 0
    # quantum mode batches arrivals through admit_quantum
    assert bool(calls) == (mode == "quantum")


def test_unported_options_raise():
    """No option waits for a slice any more: the planner
    (``autoscale=True``), telemetry and sharded pools are ported (their
    parity is in ``tests/test_torch_experiment3.py``,
    ``test_torch_telemetry.py`` and ``test_torch_sharded_store.py``).
    What raises is what the reference refuses too: a shard count that
    is not a power of two."""
    sim = routing_sim(T, TS, "quantum", device="cpu", autoscale=True,
                      telemetry=True)
    assert sim.manager.planner is not None and sim.telemetry is not None
    assert TS.ServingSimulator(list(sim.workloads.values()), telemetry=True,
                               device="cpu").telemetry is not None
    def sites(shards):
        return [dataclasses.replace(s, shards=shards)
                for s in sim.sites.values()]

    sharded = TS.MultiPoolSimulator(sim.workloads.values(), sites(2),
                                    device="cpu")
    assert all(isinstance(p.store, T.ShardedResidentStore)
               for p in sharded.manager.pools.values())
    with pytest.raises(ValueError, match="power of two"):
        TS.MultiPoolSimulator(sim.workloads.values(), sites(3),
                              device="cpu")
