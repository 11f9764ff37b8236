"""Differential replay: one scenario, three admission pipelines.

The same seeded :class:`~repro_torch.chaos.scenario.Scenario` is executed
under (a) scalar per-request admission (``Gateway.handle`` — the
parity oracle), (b) the generic quantum path
(``Gateway.handle_quantum`` with the fast path disabled), and (c) the
fused fast path.  The three runs must be **decision-identical**: every
request gets the same terminal state, deny reason, admitting pool and
spill-hop count, and the flight recorder (the admission black box)
must hold structurally identical per-request decision traces — same
legs, same verdicts, same reason codes.  Numeric trace fields
(priority) are compared under an f32 tolerance because the kernel path
computes in float32 while the scalar oracle uses float64.

Retry-After *hints* are the one sanctioned divergence between modes,
so :func:`~repro_torch.chaos.scenario.build_sim` pins the client retry
timeline with a deterministic seeded backoff — hint differences can
then never desynchronize the arrival sequences.

Counterpart of ``repro/chaos/replay.py``; ``run_replay`` runs every mode
on ``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.chaos.scenario import Scenario, build_sim

#: (label, admission_mode, quantum_fast)
REPLAY_MODES = (
    ("scalar", "scalar", False),
    ("quantum", "quantum", False),
    ("quantum_fast", "quantum", True),
)

#: f32-vs-f64 slack for priorities recorded along the two pipelines
PRIORITY_RTOL = 1e-4
PRIORITY_ATOL = 1e-3


@dataclasses.dataclass(frozen=True)
class RequestOutcome:
    """Decision-relevant terminal facts for one request."""

    request_id: str
    entitlement: str
    state: str
    deny_reason: Optional[str]
    pool: Optional[str]
    spill_hops: int
    priority: float


@dataclasses.dataclass
class ModeTrace:
    """One mode's full decision record for a scenario run."""

    label: str
    outcomes: dict            # request_id -> RequestOutcome
    flight_legs: dict         # request_id -> tuple[(pool, verdict, reason)]
    flight_priority: dict     # request_id -> tuple[float]


@dataclasses.dataclass
class ReplayResult:
    scenario: str
    traces: dict              # label -> ModeTrace
    mismatches: list          # human-readable diff lines
    @property
    def identical(self) -> bool:
        return not self.mismatches


def _close(a: float, b: float) -> bool:
    if a is None or b is None:
        return a is b
    return math.isclose(a, b, rel_tol=PRIORITY_RTOL,
                        abs_tol=PRIORITY_ATOL)


def capture_trace(sim, label: str) -> ModeTrace:
    """Extract the decision trace of a finished run: per-request
    terminal outcomes from the simulator plus the flight recorder's
    per-leg admission record."""
    outcomes = {}
    legs: dict = {}
    prios: dict = {}
    flight = sim.telemetry.flight if sim.telemetry is not None else None
    for rid, req in sim.requests.items():
        outcomes[rid] = RequestOutcome(
            request_id=rid, entitlement=req.entitlement,
            state=req.state.value,
            deny_reason=req.deny_reason, pool=req.pool,
            spill_hops=req.spill_hops,
            priority=float(req.priority or 0.0))
        if flight is not None:
            trace = flight.explain(rid)
            if trace is not None:
                legs[rid] = tuple(
                    (leg.pool, leg.verdict_name, leg.reason)
                    for leg in trace.legs)
                # priority is attributed only on ADMIT legs: the
                # scalar pipeline denies before computing one (records
                # 0.0) while the kernel always carries the row value —
                # a recorder representation difference, not a decision
                # difference
                prios[rid] = tuple(
                    float(leg.priority) if leg.verdict_name == "admit"
                    else None
                    for leg in trace.legs)
    return ModeTrace(label=label, outcomes=outcomes, flight_legs=legs,
                     flight_priority=prios)


def diff_traces(base: ModeTrace, other: ModeTrace,
                max_report: int = 20) -> list:
    """Human-readable decision diffs between two mode traces (empty
    list == decision-identical)."""
    out: list = []
    base_ids = set(base.outcomes)
    other_ids = set(other.outcomes)
    for rid in sorted(base_ids ^ other_ids):
        side = base.label if rid in base_ids else other.label
        out.append(f"{rid}: only present under {side}")
    for rid in sorted(base_ids & other_ids):
        a, b = base.outcomes[rid], other.outcomes[rid]
        for field in ("state", "deny_reason", "pool", "spill_hops"):
            va, vb = getattr(a, field), getattr(b, field)
            if va != vb:
                out.append(f"{rid}.{field}: {base.label}={va!r} "
                           f"{other.label}={vb!r}")
        if not _close(a.priority, b.priority):
            out.append(f"{rid}.priority: {base.label}={a.priority!r} "
                       f"{other.label}={b.priority!r}")
        la = base.flight_legs.get(rid)
        lb = other.flight_legs.get(rid)
        if la != lb:
            out.append(f"{rid}.flight: {base.label}={la!r} "
                       f"{other.label}={lb!r}")
        elif la is not None:
            pa = base.flight_priority[rid]
            pb = other.flight_priority[rid]
            if len(pa) != len(pb) or not all(
                    _close(x, y) for x, y in zip(pa, pb)):
                out.append(f"{rid}.flight_priority: "
                           f"{base.label}={pa!r} {other.label}={pb!r}")
        if len(out) >= max_report:
            out.append("... (diff truncated)")
            break
    return out


def run_replay(scenario: Scenario, duration_s: Optional[float] = None,
               modes=REPLAY_MODES, device="cuda") -> ReplayResult:
    """Execute ``scenario`` once per mode on ``device`` and diff every
    mode against the scalar baseline (the first entry of ``modes``)."""
    traces: dict = {}
    for label, admission_mode, fast in modes:
        sim = build_sim(scenario, admission_mode=admission_mode,
                        quantum_fast=fast, telemetry=True, device=device)
        sim.run(duration_s or scenario.duration_s)
        traces[label] = capture_trace(sim, label)
    labels = [m[0] for m in modes]
    base = traces[labels[0]]
    mismatches: list = []
    for label in labels[1:]:
        for line in diff_traces(base, traces[label]):
            mismatches.append(f"[{labels[0]} vs {label}] {line}")
    return ReplayResult(scenario=scenario.name, traces=traces,
                        mismatches=mismatches)
