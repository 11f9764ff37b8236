"""Declarative, seeded chaos scenarios for the control plane.

A :class:`Scenario` is a frozen description of one incident timeline:
workload mix, pool fleet, and a schedule of scripted events (replica
failures, rate surges, entitlement churn, migrations).  It stores
*constructor kwargs* — not live ``Workload`` / ``PoolSite`` objects —
because the simulator mutates workloads in place (``set_rate``) and a
scenario must build an arbitrary number of fresh, identical simulators
(the differential-replay engine runs three per scenario).

Everything a scenario injects goes through PUBLIC control-plane entry
points: ``sim.at`` for the simulator-native event kinds, and ``call``
closures wrapping ``TokenPool.add_entitlement`` /
``TokenPool.remove_entitlement`` / ``PoolManager.migrate_entitlement``
for churn.  The module never reaches into private state (the reference's
``chaos-public-api`` analysis pass holds its twin to that; for this
package ``tests/test_torch_chaos.py`` holds it).

Counterpart of ``repro/chaos/scenario.py``; ``build_sim`` builds the
port's ``MultiPoolSimulator`` on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

from repro_torch.core import EntitlementSpec, QoS, Resources
from repro_torch.serving.simulation import MultiPoolSimulator, PoolSite, Workload

#: event kinds the simulator handles natively (payload forwarded as-is)
SIM_EVENTS = frozenset({"fail_replica", "recover_replica", "set_rate"})
#: event kinds the harness lowers to ``call`` closures
HARNESS_EVENTS = frozenset(
    {"add_entitlement", "remove_entitlement", "migrate"})


@dataclasses.dataclass(frozen=True)
class ScenarioEvent:
    """One scripted incident at simulated time ``t``.

    Kinds and payloads:

    - ``fail_replica`` / ``recover_replica`` — ``pool``, ``idx``
    - ``set_rate`` — ``workload``, ``rate`` (rps, effective next arrival)
    - ``add_entitlement`` — ``pool``, ``name``, ``service_class``,
      ``slo_ms``, ``tokens_per_second``, ``slots``
    - ``remove_entitlement`` — ``pool``, ``name``
    - ``migrate`` — ``entitlement``, ``src``, ``dst``
    """

    t: float
    kind: str
    payload: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A seeded, fully reproducible incident timeline.

    ``workloads`` / ``sites`` are tuples of constructor-kwargs dicts
    for :class:`Workload` / :class:`PoolSite`; :func:`build_sim`
    instantiates fresh objects per simulator so replays never share
    mutable state.
    """

    name: str
    seed: int
    duration_s: float
    workloads: tuple = ()          # tuple[dict] — Workload kwargs
    sites: tuple = ()              # tuple[dict] — PoolSite kwargs
    events: tuple = ()             # tuple[ScenarioEvent]
    dt: float = 0.02
    accounting_interval_s: float = 1.0
    bucket_window_s: float = 4.0
    spill_policy: str = "static"
    autoscale: bool = False
    provision_lag_s: float = 2.0
    drain_s: float = 2.0
    #: Experiment-1 bound asserted by the guaranteed-p99 final checker
    #: (None → checker skips this scenario)
    p99_bound_s: Optional[float] = None
    #: deterministic client backoff: base + jitter drawn from a crc32
    #: hash of (seed, workload, attempt) — NOT ``hash()``, which varies
    #: under PYTHONHASHSEED and would unpin the retry timeline
    retry_base_s: float = 0.25
    retry_jitter_s: float = 0.5
    description: str = ""


def seeded_backoff(scenario: Scenario):
    """Deterministic retry backoff for differential replay.

    Retry-After *hints* legitimately differ between the scalar and
    quantum admission paths (documented in ``Gateway.handle_quantum``),
    so a replayable scenario must not let the hint drive the retry
    timeline.  This substitutes a pure function of
    (scenario seed, workload, attempt): identical across the scalar,
    quantum and fast-path runs by construction.
    """

    def backoff(w, req, attempt, resp) -> float:
        h = zlib.crc32(f"{scenario.seed}:{w.name}:{attempt}".encode())
        return scenario.retry_base_s \
            + scenario.retry_jitter_s * ((h % 997) / 997.0)

    return backoff


def _add_entitlement_fn(p: dict):
    def fn(sim, now):
        sim.manager.pool(p["pool"]).add_entitlement(EntitlementSpec(
            name=p["name"], tenant_id=p.get("tenant_id", p["name"]),
            pool=p["pool"],
            qos=QoS(service_class=p["service_class"],
                    slo_target_ms=p.get("slo_ms", 1000.0)),
            baseline=Resources(p.get("tokens_per_second", 0.0), 0.0,
                               p.get("slots", 1.0))), now=now)
    return fn


def _remove_entitlement_fn(p: dict):
    def fn(sim, now):
        sim.manager.pool(p["pool"]).remove_entitlement(p["name"], now)
    return fn


def _migrate_fn(p: dict):
    def fn(sim, now):
        sim.manager.migrate_entitlement(
            p["entitlement"], p["src"], p["dst"], now)
    return fn


def schedule_event(sim: MultiPoolSimulator, ev: ScenarioEvent) -> None:
    """Lower one :class:`ScenarioEvent` onto the simulator's event
    queue — native kinds pass through, harness kinds become ``call``
    closures over public control-plane entry points."""
    if ev.kind in SIM_EVENTS:
        sim.at(ev.t, ev.kind, **dict(ev.payload))
    elif ev.kind == "add_entitlement":
        sim.at(ev.t, "call", fn=_add_entitlement_fn(dict(ev.payload)))
    elif ev.kind == "remove_entitlement":
        sim.at(ev.t, "call", fn=_remove_entitlement_fn(dict(ev.payload)))
    elif ev.kind == "migrate":
        sim.at(ev.t, "call", fn=_migrate_fn(dict(ev.payload)))
    else:
        raise ValueError(f"unknown scenario event kind {ev.kind!r}")


def build_sim(scenario: Scenario, admission_mode: str = "quantum",
              quantum_fast: bool = True,
              telemetry=True, device="cuda") -> MultiPoolSimulator:
    """Materialize one simulator for ``scenario``.

    Fresh ``Workload`` / ``PoolSite`` objects are built per call
    (``set_rate`` events mutate workloads in place), the deterministic
    retry backoff is installed, and every scripted event is scheduled.
    ``admission_mode`` / ``quantum_fast`` select the admission pipeline
    under test — the replay engine calls this three times with the
    same scenario and diffs the resulting decision traces.  The
    control plane runs on ``device``.
    """
    workloads = [Workload(**dict(kw)) for kw in scenario.workloads]
    sites = [PoolSite(**dict(kw)) for kw in scenario.sites]
    sim = MultiPoolSimulator(
        workloads, sites, dt=scenario.dt, seed=scenario.seed,
        accounting_interval_s=scenario.accounting_interval_s,
        bucket_window_s=scenario.bucket_window_s,
        spill_policy=scenario.spill_policy,
        admission_mode=admission_mode,
        autoscale=scenario.autoscale,
        provision_lag_s=scenario.provision_lag_s,
        drain_s=scenario.drain_s,
        telemetry=telemetry, device=device)
    sim.gateway.quantum_fast_enabled = quantum_fast
    sim.retry_backoff = seeded_backoff(scenario)
    for ev in scenario.events:
        schedule_event(sim, ev)
    return sim
