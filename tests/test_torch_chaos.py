"""The port's chaos harness against the reference's, on the CPU.

``repro_torch.chaos`` builds the port's ``MultiPoolSimulator`` on a
``device`` (``"cpu"`` here) and runs the same scenario library, the
same invariant checkers and the same three-mode differential replay
(scalar ``handle``, the generic quantum leg-round path and the quantum
fast path) as ``repro.chaos``.  Here:

- the scenario DSL behaves as the reference's (fresh workloads per
  build, the seeded backoff draws the same delays, churn through public
  entry points);
- every checker fires on the same deliberate pokes as in the
  reference's tests (the pokes reach into private columns on purpose);
- every library scenario passes every checker, with the same report
  as the reference (outcomes, SLO snapshot, incident windows);
- the mini scenario replays identically across the three modes, and
  each library scenario's decision trace in the fast-path mode equals
  the reference's request for request and leg for leg;
- ``test_torch_chaos_public_api``: the harness touches no private
  attribute of anything but ``self``/``cls`` (the rule of the
  reference's ``chaos-public-api`` pass, which does not scan the
  port's path).

The full three-mode replay of the library against the reference and
the random-scenario sweeps carry ``@pytest.mark.chaos``, as in the
reference.
"""
import ast
import dataclasses
import json
import random
from pathlib import Path

import pytest

import repro.chaos as JC
import repro.core as J
import repro_torch.chaos as TC
import repro_torch.core as T
from repro.chaos.replay import capture_trace as j_capture
from repro_torch.chaos.invariants import (
    Capacity,
    DebtBounds,
    GuaranteedP99,
    MirrorCoherence,
    RowLeaks,
    TokenConservation,
)
from repro_torch.chaos.replay import capture_trace, diff_traces
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.simulation import Workload

ROOT = Path(__file__).resolve().parents[1]
CHAOS_SRC = ROOT / "src" / "repro_torch" / "chaos"
SC = T.ServiceClass

MINI = TC.Scenario(
    name="mini", seed=5, duration_s=3.0, p99_bound_s=6.0,
    sites=(dict(name="east", n_replicas=1, replica_slots=8,
                replica_tps=160.0),
           dict(name="west", n_replicas=1, replica_slots=8,
                replica_tps=160.0)),
    workloads=(
        dict(name="gold", service_class=SC.GUARANTEED, slots=4,
             slo_ms=800.0, rate_rps=2.0, in_tokens=32, out_tokens=32,
             max_retries=1, pools=("east", "west")),
        dict(name="flex", service_class=SC.ELASTIC, slots=3,
             slo_ms=2000.0, rate_rps=6.0, in_tokens=32, out_tokens=32,
             max_retries=1, pools=("east", "west"))))

MINI_SINGLE = dataclasses.replace(
    MINI, name="mini_single",
    sites=(dict(name="core", n_replicas=1, replica_slots=8,
                replica_tps=160.0),),
    workloads=tuple(dict(w, pools=("core",)) for w in MINI.workloads))

LIBRARY = TC.SCENARIOS
IDS = [s.name for s in LIBRARY]


def to_reference(sc):
    """The same scenario for ``repro.chaos``: service classes become the
    reference's enum, everything else is shared."""
    def conv(d):
        return {k: (J.ServiceClass(v.value) if isinstance(v, SC) else v)
                for k, v in d.items()}
    return JC.Scenario(**{
        **{f.name: getattr(sc, f.name) for f in dataclasses.fields(sc)},
        "workloads": tuple(conv(w) for w in sc.workloads),
        "sites": tuple(dict(s) for s in sc.sites),
        "events": tuple(JC.ScenarioEvent(e.t, e.kind, conv(e.payload))
                        for e in sc.events)})


def trace_key(trace) -> tuple:
    return ({rid: dataclasses.astuple(o) for rid, o in trace.outcomes.items()},
            trace.flight_legs, trace.flight_priority)


def run_with_sabotage(checker, sabotage, scenario=MINI):
    """Run ``scenario`` under one checker, corrupting state through
    ``sabotage(sim)`` three steps before the end."""
    sim = TC.build_sim(scenario, device="cpu")
    for pool in sim.manager.pools.values():
        pool.ledger.enable_level_audit()
    t_sab = scenario.duration_s - 3 * scenario.dt
    done = []

    def sab(sim, now):
        if now >= t_sab and not done:
            sabotage(sim)
            done.append(now)

    violations = []
    sim.step_hooks.append(sab)
    TC.install_checkers(sim, [checker], violations, scenario)
    sim.run(scenario.duration_s)
    assert done, "sabotage never fired"
    return violations


# -- scenario DSL ------------------------------------------------------------------

def test_build_sim_isolates_workload_state():
    sc = dataclasses.replace(MINI_SINGLE, events=(TC.ScenarioEvent(
        0.5, "set_rate", dict(workload="flex", rate=50.0)),))
    sim1 = TC.build_sim(sc, device="cpu")
    sim1.run(1.0)
    assert sim1.workloads["flex"].rate_rps == 50.0
    assert TC.build_sim(sc, device="cpu").workloads["flex"].rate_rps == 6.0
    assert sim1.manager.pool("core").store.device.type == "cpu"


def test_unknown_event_kind_rejected():
    sc = dataclasses.replace(MINI_SINGLE,
                             events=(TC.ScenarioEvent(0.1, "meteor", {}),))
    with pytest.raises(ValueError, match="meteor"):
        TC.build_sim(sc, device="cpu")


def test_library_matches_the_reference():
    assert [s.name for s in TC.SCENARIOS] == [s.name for s in JC.SCENARIOS]
    for ours, ref in zip(TC.SCENARIOS, JC.SCENARIOS):
        assert to_reference(ours) == ref
    assert TC.by_name("retry_storm").name == "retry_storm"
    with pytest.raises(KeyError):
        TC.by_name("nope")


def test_seeded_backoff_matches_the_reference():
    ours, ref = TC.seeded_backoff(MINI), JC.seeded_backoff(to_reference(MINI))
    w = Workload(name="gold", service_class=SC.GUARANTEED, slots=4,
                 slo_ms=800.0, rate_rps=1.0)
    vals = [ours(w, None, a, None) for a in range(6)]
    assert vals == [ref(w, None, a, None) for a in range(6)]
    assert len(set(vals)) > 1


def test_churn_events_use_public_entry_points():
    sc = dataclasses.replace(MINI, name="churn", events=(
        TC.ScenarioEvent(0.5, "add_entitlement", dict(
            pool="east", name="standby", service_class=SC.GUARANTEED,
            slo_ms=1000.0, tokens_per_second=20.0, slots=1.0)),
        TC.ScenarioEvent(1.0, "migrate", dict(
            entitlement="standby", src="east", dst="west")),
        TC.ScenarioEvent(1.5, "remove_entitlement", dict(
            pool="west", name="standby"))))
    sim = TC.build_sim(sc, device="cpu")
    seen = []
    sim.at(1.2, "call", fn=lambda sim, now: seen.append(
        "standby" in sim.manager.pool("west").entitlements))
    sim.run(2.0)
    assert seen == [True]
    assert "standby" not in sim.manager.pool("east").entitlements
    assert "standby" not in sim.manager.pool("west").entitlements


# -- every checker fires on a deliberately broken fixture --------------------------

def test_registry_matches_the_reference():
    assert TC.checker_catalog() == JC.checker_catalog()
    assert {c.name for c in TC.default_checkers()} >= {
        "token-conservation", "row-leaks", "debt-bounds", "capacity",
        "mirror-coherence", "guaranteed-p99"}


def test_clean_run_is_quiet():
    rep = TC.run_scenario(MINI, device="cpu")
    assert rep["passed"], rep["violations"]
    assert rep["device"] == "cpu"


def poke_level(sim):
    pool = sim.manager.pool("east")
    pool.store.col["bucket_level"][pool.store.slot_of["gold@east"]] += 123.0


def poke_free_list(sim):
    store = sim.manager.pool("east").store
    store._free.append(store.slot_of["gold@east"])


def poke_unknown_settle(sim):
    sim.manager.pool("east").ledger.settle("never-admitted", 1, 1.0)


def poke_debt_range(sim):
    pool = sim.manager.pool("east")
    pool.status["flex@east"].debt = pool.spec.coefficients.debt_max + 1.0


def poke_guaranteed_debt(sim):
    sim.manager.pool("east").status["gold@east"].debt = 0.5


def poke_in_flight(sim):
    pool = sim.manager.pool("east")
    pool.store.col["in_flight"][pool.store.slot_of["gold@east"]] += 3


def poke_backend_lane(sim):
    replica = sim.replicas["east"][0]
    for i in range(replica.slots + 2):
        rid = f"ghost-{i}"
        sim.requests[rid] = Request(request_id=rid, entitlement="gold",
                                    prompt_tokens=[1], max_tokens=1,
                                    arrival_s=0.0)
        replica.active.setdefault(rid, [1e9, 0.0])


def poke_mirror(sim):
    pool = sim.manager.pool("east")
    pool.store.device_state()             # build and cache the mirror
    # a host write WITHOUT mark_dirty: the cached mirror goes stale
    pool.store.col["burst"][pool.store.slot_of["gold@east"]] += 1.0


POKES = [
    (TokenConservation, poke_level, "unsanctioned bucket_level"),
    (RowLeaks, poke_free_list, "row leak"),
    (RowLeaks, poke_unknown_settle, "no outstanding charge"),
    (DebtBounds, poke_debt_range, "outside"),
    (DebtBounds, poke_guaranteed_debt, "debt-free class"),
    (Capacity, poke_in_flight, "table recount"),
    (Capacity, poke_backend_lane, "over its"),
    (MirrorCoherence, poke_mirror, "mark_dirty"),
]


@pytest.mark.parametrize("checker,poke,message", POKES,
                         ids=[p.__name__ for _, p, _ in POKES])
def test_checker_fires(checker, poke, message):
    vs = run_with_sabotage(checker(), poke)
    assert any(message in v.message for v in vs), vs
    assert all(v.checker == checker.name for v in vs)


def test_guaranteed_p99_fires_on_absurd_bound():
    sc = dataclasses.replace(MINI, p99_bound_s=1e-6)
    rep = TC.run_scenario(sc, checkers=[GuaranteedP99()], device="cpu")
    assert any(v["checker"] == "guaranteed-p99" for v in rep["violations"])


# -- the scenario library ------------------------------------------------------------

def comparable(report) -> dict:
    return {k: v for k, v in report.items() if k != "device"}


@pytest.mark.parametrize("scenario", LIBRARY, ids=IDS)
def test_scenario_passes_every_checker(scenario):
    rep = TC.run_scenario(scenario, device="cpu")
    assert rep["passed"], rep["violations"]
    tier = rep["slo"].get("guaranteed") or {}
    assert tier.get("completions", 0) > 0
    assert tier["p99_s"] <= scenario.p99_bound_s
    assert comparable(rep) == JC.run_scenario(to_reference(scenario))


def test_failure_scenarios_record_incident_windows():
    rep = TC.run_scenario(TC.by_name("correlated_failure"), device="cpu")
    windows = rep["incident_windows"]
    assert len(windows) >= 2
    for key, start, end in windows:
        assert key.startswith("east/") and end is not None and end > start


def test_report_is_json_serializable():
    back = json.loads(json.dumps(TC.run_scenario(MINI, device="cpu"),
                                 default=str))
    assert back["scenario"] == "mini" and len(back["checkers"]) >= 6
    assert back["requests_total"] > 0


# -- differential replay ----------------------------------------------------------

def test_mini_replay_identical():
    res = TC.run_replay(MINI, device="cpu")
    assert res.identical, res.mismatches[:10]
    assert set(res.traces) == {"scalar", "quantum", "quantum_fast"}
    assert len(res.traces["scalar"].outcomes) > 10
    assert res.traces["scalar"].flight_legs
    ref = JC.run_replay(to_reference(MINI))
    for label in res.traces:
        assert trace_key(res.traces[label]) == trace_key(ref.traces[label])


def test_replay_detects_divergence():
    sim_a = TC.build_sim(MINI_SINGLE, device="cpu")
    sim_a.run(2.0)
    sim_b = TC.build_sim(dataclasses.replace(MINI_SINGLE, seed=99),
                         device="cpu")
    sim_b.run(2.0)
    assert diff_traces(capture_trace(sim_a, "a"), capture_trace(sim_b, "b"))


@pytest.mark.parametrize("scenario", LIBRARY, ids=IDS)
def test_fast_path_trace_equals_the_reference(scenario):
    """The mode the card runs by default: each request's outcome,
    flight legs and admit priorities equal the reference's."""
    sim = TC.build_sim(scenario, "quantum", True, device="cpu")
    sim.run(scenario.duration_s)
    ref = JC.build_sim(to_reference(scenario), "quantum", True)
    ref.run(scenario.duration_s)
    ours = capture_trace(sim, "quantum_fast")
    assert trace_key(ours) == trace_key(j_capture(ref, "quantum_fast"))
    assert ours.outcomes


@pytest.mark.chaos
@pytest.mark.parametrize("scenario", LIBRARY, ids=IDS)
def test_library_replay_identical_to_the_reference(scenario):
    res = TC.run_replay(scenario, device="cpu")
    assert res.identical, res.mismatches[:10]
    ref = JC.run_replay(to_reference(scenario))
    for label in res.traces:
        assert trace_key(res.traces[label]) == trace_key(ref.traces[label])


# -- settle order and migration rollback under a scenario --------------------------

@pytest.mark.parametrize("order", [["gold-3", "gold-1", "gold-2"],
                                   ["gold-2", "gold-3", "gold-1"]])
def test_same_step_completions_settle_in_rid_order(order):
    sim = TC.build_sim(MINI_SINGLE, telemetry=False, device="cpu")
    captured = []
    sim.gateway.on_complete_batch = lambda completions, now: \
        captured.extend(rid for rid, _, _ in completions)
    replica = sim.replicas["core"][0]
    for rid in order:
        req = Request(request_id=rid, entitlement="gold",
                      prompt_tokens=[1], max_tokens=1, arrival_s=0.0)
        req.state = RequestState.DECODING
        sim.requests[rid] = req
        replica.active[rid] = [1e-6, 0.0]
    sim._advance_replicas(0.0)
    assert captured == sorted(order)


def test_rollback_under_seeded_chaos_scenario():
    sc = dataclasses.replace(MINI, name="clash", events=tuple(
        TC.ScenarioEvent(t, "add_entitlement", dict(
            pool=pool, name="clash", service_class=SC.GUARANTEED,
            slo_ms=1000.0, tokens_per_second=20.0, slots=1.0))
        for t, pool in ((0.5, "east"), (0.6, "west"))))
    sim = TC.build_sim(sc, device="cpu")
    for pool in sim.manager.pools.values():
        pool.ledger.enable_level_audit()
    errors = []

    def attempt(sim, now):
        try:
            sim.manager.migrate_entitlement("clash", "east", "west", now)
        except ValueError as e:
            errors.append(e)

    sim.at(1.5, "call", fn=attempt)
    violations = []
    TC.install_checkers(sim, TC.default_checkers(), violations, sc)
    sim.run(sc.duration_s)
    assert errors and "clash" in sim.manager.pool("east").entitlements
    assert not violations, violations[:5]


# -- random scenarios -------------------------------------------------------------

def random_scenario(seed: int):
    """A seeded random scenario; every workload shares one pool order,
    so the replay-parity contract holds by construction."""
    rng = random.Random(seed)
    pools = tuple(f"p{i}" for i in range(rng.randint(1, 2)))
    sites = tuple(dict(name=p, n_replicas=rng.randint(1, 2),
                       replica_slots=8, replica_tps=160.0) for p in pools)
    workloads = [dict(name="gold", service_class=SC.GUARANTEED, slots=4,
                      slo_ms=800.0, rate_rps=rng.uniform(1.0, 3.0),
                      in_tokens=32, out_tokens=32,
                      max_retries=rng.randint(0, 2), pools=pools)]
    for i in range(rng.randint(1, 2)):
        workloads.append(dict(
            name=f"fl{i}",
            service_class=rng.choice([SC.ELASTIC, SC.DEDICATED]),
            slots=rng.randint(2, 4), slo_ms=2000.0,
            rate_rps=rng.uniform(2.0, 10.0), in_tokens=32, out_tokens=32,
            max_retries=rng.randint(0, 3), pools=pools))
    duration = rng.uniform(4.0, 6.0)
    events = []
    if rng.random() < 0.8:
        p = rng.choice(pools)
        idx = rng.randrange(next(s["n_replicas"] for s in sites
                                 if s["name"] == p))
        t = rng.uniform(1.0, duration / 2)
        events += [TC.ScenarioEvent(t, "fail_replica", dict(pool=p, idx=idx)),
                   TC.ScenarioEvent(t + rng.uniform(0.5, 2.0),
                                    "recover_replica", dict(pool=p, idx=idx))]
    if rng.random() < 0.6:
        events.append(TC.ScenarioEvent(
            rng.uniform(1.0, duration - 1.0), "set_rate",
            dict(workload=rng.choice(workloads[1:])["name"],
                 rate=rng.uniform(0.5, 20.0))))
    return TC.Scenario(name=f"random_{seed}", seed=seed, duration_s=duration,
                       sites=sites, workloads=tuple(workloads),
                       events=tuple(sorted(events, key=lambda e: e.t)))


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [101, 202, 303, 404, 505, 606])
def test_random_scenario_holds_all_invariants(seed):
    rep = TC.run_scenario(random_scenario(seed), device="cpu")
    assert rep["passed"], rep["violations"][:5]


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [101, 404])
def test_random_scenario_replays_like_the_reference(seed):
    sc = random_scenario(seed)
    res = TC.run_replay(sc, device="cpu")
    assert res.identical, res.mismatches[:10]
    ref = JC.run_replay(to_reference(sc))
    for label in res.traces:
        assert trace_key(res.traces[label]) == trace_key(ref.traces[label])


# -- the harness reads only public surfaces -------------------------------------

WAIVER = "repro: allow[chaos-public-api]"


def private_accesses(source: str, path: str = "<src>") -> list:
    """``(line, attribute)`` of every ``_``-prefixed, non-dunder
    attribute read or written on a value other than ``self``/``cls``,
    skipping lines that carry the reference's waiver comment."""
    lines = source.splitlines()
    found = []
    for node in ast.walk(ast.parse(source, path)):
        if not isinstance(node, ast.Attribute):
            continue
        attr = node.attr
        if not attr.startswith("_") or attr.startswith("__"):
            continue
        if isinstance(node.value, ast.Name) and \
                node.value.id in ("self", "cls"):
            continue
        if WAIVER in lines[node.lineno - 1]:
            continue
        found.append((node.lineno, attr))
    return found


def test_private_access_scan_fires():
    src = ("def f(pool, self):\n"
           "    a = pool._authorized\n"
           "    pool.store._free.append(1)\n"
           "    self._ok = pool.__class__\n"
           "    b = pool._x  # repro: allow[chaos-public-api] -- test\n")
    assert private_accesses(src) == [(2, "_authorized"), (3, "_free")]


def test_torch_chaos_public_api():
    files = sorted(CHAOS_SRC.glob("*.py"))
    assert len(files) == 6
    bad = {str(p.relative_to(ROOT)): private_accesses(p.read_text(), str(p))
           for p in files}
    assert not any(bad.values()), bad
