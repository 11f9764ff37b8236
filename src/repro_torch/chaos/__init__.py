"""Chaos scenario harness for the multi-tenant control plane.

Three layers:

- :mod:`repro_torch.chaos.scenario` — the declarative, seeded scenario DSL
  (:class:`Scenario` / :class:`ScenarioEvent`) and ``build_sim``.
- :mod:`repro_torch.chaos.invariants` — the global invariant-checker
  registry run after every simulated quantum (token conservation, row
  leaks, debt bounds, capacity closure, mirror coherence, guaranteed
  P99).
- :mod:`repro_torch.chaos.replay` — differential replay: the same seeded
  scenario under scalar / quantum / fast-path admission must be
  decision-identical.

``repro_torch.chaos.scenarios`` ships the library of scripted incidents and
``repro_torch.chaos.runner`` executes a scenario under the full registry.

Counterpart of ``repro.chaos``.  Every entry point that builds a
simulator (``build_sim``, ``run_scenario``, ``run_replay``) takes the
``device=`` the port's control plane runs on (default ``"cuda"``); on
the card the quantum modes admit through the ``admit_quantum`` kernel
and the ``mirror-coherence`` checker compares the device mirror with
the host columns.  Like the reference, the harness reads only public
surfaces (``tests/test_torch_chaos.py`` scans it for private access).
"""
from repro_torch.chaos.invariants import (
    CheckContext,
    Checker,
    Violation,
    default_checkers,
    make_context,
    register_checker,
)
from repro_torch.chaos.replay import (
    REPLAY_MODES,
    ModeTrace,
    ReplayResult,
    RequestOutcome,
    capture_trace,
    diff_traces,
    run_replay,
)
from repro_torch.chaos.runner import (
    checker_catalog,
    install_checkers,
    run_scenario,
)
from repro_torch.chaos.scenario import (
    Scenario,
    ScenarioEvent,
    build_sim,
    schedule_event,
    seeded_backoff,
)
from repro_torch.chaos.scenarios import SCENARIOS, by_name

__all__ = [
    "CheckContext", "Checker", "Violation", "default_checkers",
    "make_context", "register_checker",
    "REPLAY_MODES", "ModeTrace", "ReplayResult", "RequestOutcome",
    "capture_trace", "diff_traces", "run_replay",
    "checker_catalog", "install_checkers", "run_scenario",
    "Scenario", "ScenarioEvent", "build_sim", "schedule_event",
    "seeded_backoff",
    "SCENARIOS", "by_name",
]
