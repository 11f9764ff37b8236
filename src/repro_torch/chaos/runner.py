"""Scenario runner: build → instrument → run → report.

``run_scenario`` wires the invariant registry into the simulator's
``step_hooks`` (every checker sees the control plane after EVERY
completed quantum — post-settle, post-tick), enables the ledger's
conservation audit on every pool, executes the scripted timeline and
returns a JSON-serializable report: violations, SLO snapshot, incident
windows and per-workload outcome counts.

Counterpart of ``repro/chaos/runner.py``; ``run_scenario`` runs on
``device`` (default ``"cuda"``).
"""
from __future__ import annotations

import itertools
from typing import Optional

from repro_torch.chaos.invariants import (
    Checker,
    default_checkers,
    make_context,
)
from repro_torch.chaos.scenario import Scenario, build_sim


def install_checkers(sim, checkers: list, violations: list,
                     scenario: Optional[Scenario] = None,
                     check_interval_steps: int = 1) -> None:
    """Register the step-scope checkers on ``sim.step_hooks``.

    One shared ``audit_snapshot()`` per pool per checked step; the
    interval lets long soak runs trade cadence for wall-clock (1 =
    every quantum)."""
    step_checkers = [c for c in checkers if c.scope == "step"]
    if not step_checkers:
        return
    counter = itertools.count()

    def hook(sim, now: float) -> None:
        if next(counter) % check_interval_steps:
            return
        ctx = make_context(sim, now, scenario)
        for checker in step_checkers:
            violations.extend(checker.check(ctx))

    sim.step_hooks.append(hook)


def run_scenario(scenario: Scenario, admission_mode: str = "quantum",
                 quantum_fast: bool = True,
                 checkers: Optional[list] = None,
                 check_interval_steps: int = 1, device="cuda") -> dict:
    """Execute one scenario on ``device`` under the full invariant
    registry."""
    sim = build_sim(scenario, admission_mode=admission_mode,
                    quantum_fast=quantum_fast, telemetry=True,
                    device=device)
    for pool in sim.manager.pools.values():
        pool.ledger.enable_level_audit()
    if checkers is None:
        checkers = default_checkers()
    violations: list = []
    install_checkers(sim, checkers, violations, scenario,
                     check_interval_steps)
    summary = sim.run(scenario.duration_s)

    final_ctx = make_context(sim, scenario.duration_s, scenario)
    for checker in checkers:
        if checker.scope == "final":
            violations.extend(checker.check(final_ctx))

    tel = sim.telemetry
    per_workload = {
        name: {k: v for k, v in stats.items()
               if isinstance(v, (int, float, dict))}
        for name, stats in summary["per_workload"].items()}
    return {
        "scenario": scenario.name,
        "description": scenario.description,
        "seed": scenario.seed,
        "duration_s": scenario.duration_s,
        "admission_mode": admission_mode,
        "device": str(device),
        "quantum_fast": quantum_fast,
        "p99_bound_s": scenario.p99_bound_s,
        "checkers": [{"name": c.name, "scope": c.scope,
                      "description": c.description} for c in checkers],
        "violations": [v.asdict() for v in violations],
        "passed": not violations,
        "per_workload": per_workload,
        "slo": tel.slo.snapshot() if tel is not None else {},
        "incident_windows": (tel.incident_windows()
                             if tel is not None else []),
        "requests_total": len(sim.requests),
    }


def checker_catalog(checkers: Optional[list] = None) -> list:
    """Name/scope/description rows for docs and reports."""
    if checkers is None:
        checkers = default_checkers()
    return [{"name": c.name, "scope": c.scope,
             "description": c.description} for c in checkers]
