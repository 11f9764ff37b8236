"""Global invariant checkers over the live control plane.

Each checker inspects the WHOLE simulator after a completed quantum
(``scope == "step"``) or once at scenario end (``scope == "final"``)
and returns :class:`Violation` records.  Checkers read only public
surfaces — ``TokenPool.audit_snapshot()``, ``Ledger.level_audit``,
``Telemetry.slo`` — never private columns (for this package
``tests/test_torch_chaos.py`` enforces it).

The registry is class-based: :func:`default_checkers` instantiates a
fresh set per run so stateful checkers (drain-monotonicity keeps the
previous debt per entitlement) never leak state across scenarios.

Invariant catalog (the paper's conservation/§3.1 claims, made
executable):

==================== =====================================================
token-conservation   refills − charges + refunds == bucket level deltas,
                     per entitlement slot (``LevelAudit.drift`` == 0) and
                     in aggregate (``conservation_gap`` ≈ 0)
row-leaks            store/table free-list + live-row accounting closed
                     under churn; no unattributed settles
debt-bounds          debt ∈ [debt_min, debt_max] for debt-bearing
                     classes; |debt| non-increasing for debt-free classes
capacity             table-vs-store in-flight/resident recounts agree,
                     counters non-negative, resident ⊆ in-flight,
                     replicas ≤ max_replicas, backend lanes ≤ slots
mirror-coherence     cached device mirror byte-identical to host columns
                     (``mark_dirty`` discipline observable at runtime)
guaranteed-p99       guaranteed-tier P99 latency within the scenario's
                     Experiment-1 bound (final scope)
==================== =====================================================

Counterpart of ``repro/chaos/invariants.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from repro_torch.core.control_plane import CLASS_CODES
from repro_torch.core.types import DEBT_CLASSES

#: absolute tolerance for float64 flow accounting
CONSERVATION_TOL = 1e-6
#: f32 column comparisons (debt EWMA et al.)
F32_EPS = 1e-5

#: class codes that may carry non-zero debt (Eq. 2 applies)
DEBT_CODES = frozenset(CLASS_CODES[sc] for sc in DEBT_CLASSES)


@dataclasses.dataclass(frozen=True)
class Violation:
    """One invariant breach at simulated time ``t``."""

    checker: str
    t: float
    pool: Optional[str]
    message: str

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CheckContext:
    """Everything a checker may read: the simulator, the instant, one
    ``audit_snapshot()`` per pool (computed once and shared across
    checkers), and the scenario for per-scenario bounds."""

    sim: Any
    now: float
    snaps: dict
    scenario: Any = None


class Checker:
    """Base invariant checker.  Subclasses set ``name`` /
    ``description``, pick a ``scope`` ("step" runs after every quantum
    via ``sim.step_hooks``; "final" runs once at scenario end), and
    implement :meth:`check`."""

    name = "base"
    scope = "step"
    description = ""

    def check(self, ctx: CheckContext) -> list[Violation]:
        raise NotImplementedError


CHECKER_CLASSES: list[type] = []


def register_checker(cls: type) -> type:
    CHECKER_CLASSES.append(cls)
    return cls


def default_checkers() -> list[Checker]:
    """Fresh instances of every registered checker (stateful checkers
    must not share state across runs)."""
    return [cls() for cls in CHECKER_CLASSES]


def make_context(sim, now: float, scenario=None) -> CheckContext:
    """Snapshot every pool once and wrap it for the checker set."""
    snaps = {name: pool.audit_snapshot()
             for name, pool in sim.manager.pools.items()}
    return CheckContext(sim=sim, now=now, snaps=snaps, scenario=scenario)


@register_checker
class TokenConservation(Checker):
    name = "token-conservation"
    description = ("bucket refills − charges + settle refunds fully "
                   "explain level deltas, per entitlement and in "
                   "aggregate")

    def check(self, ctx: CheckContext) -> list[Violation]:
        out: list[Violation] = []
        for pname, pool in ctx.sim.manager.pools.items():
            audit = pool.ledger.level_audit
            if audit is None:
                continue
            drift = audit.drift()
            bad = np.flatnonzero(np.abs(drift) > CONSERVATION_TOL)
            if bad.size:
                name_of = pool.store.name_of
                names = {int(s): (name_of[int(s)]
                                  if int(s) < len(name_of) else "?")
                         for s in bad[:4]}
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"unsanctioned bucket_level movement at slots "
                    f"{names} (max |drift| "
                    f"{float(np.abs(drift).max()):.3e})"))
            scale = abs(audit.baseline_total) \
                + sum(abs(v) for v in audit.flows.values())
            gap = audit.conservation_gap()
            if gap > CONSERVATION_TOL * max(1.0, scale):
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"flow ledger does not explain Σ bucket_level: "
                    f"gap {gap:.3e} over flows {audit.flows}"))
        return out


@register_checker
class RowLeaks(Checker):
    name = "row-leaks"
    description = ("ResidentStore/RequestTable free-list + live-row "
                   "accounting closed under churn; no unattributed "
                   "settles")

    def check(self, ctx: CheckContext) -> list[Violation]:
        out: list[Violation] = []
        for pname, snap in ctx.snaps.items():
            s, t = snap["store"], snap["table"]
            if s["live"] + s["free"] != s["capacity"]:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"store row leak: live {s['live']} + free "
                    f"{s['free']} != capacity {s['capacity']}"))
            if s["alive_rows"] != s["live"]:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"store alive column ({s['alive_rows']}) disagrees "
                    f"with slot map ({s['live']})"))
            if t["rows"] + t["free"] != t["capacity"]:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"table row leak: rows {t['rows']} + free "
                    f"{t['free']} != capacity {t['capacity']}"))
            if t["record_rows"] != t["records"]:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"table has_record column ({t['record_rows']}) "
                    f"disagrees with live records ({t['records']})"))
            if snap["unknown_settles"]:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"{snap['unknown_settles']} settles arrived for "
                    f"requests with no outstanding charge"))
        return out


@register_checker
class DebtBounds(Checker):
    name = "debt-bounds"
    description = ("debt within [debt_min, debt_max] for debt-bearing "
                   "classes; |debt| drain-monotone for debt-free "
                   "classes")

    def __init__(self) -> None:
        #: entitlement → |debt| at the previous check (debt-free
        #: classes only); survives migration because it is keyed by
        #: name, not (pool, slot)
        self._prev: dict[str, float] = {}

    def check(self, ctx: CheckContext) -> list[Violation]:
        out: list[Violation] = []
        for pname, snap in ctx.snaps.items():
            coeff = ctx.sim.manager.pool(pname).spec.coefficients
            debts = snap["debt_col"]
            codes = snap["class_code_col"]
            names = snap["alive_names"]
            low = debts < coeff.debt_min - F32_EPS
            high = debts > coeff.debt_max + F32_EPS
            for i in np.flatnonzero(low | high):
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"debt {debts[i]:.4f} of {names[i]!r} outside "
                    f"[{coeff.debt_min}, {coeff.debt_max}]"))
            for i, name in enumerate(names):
                if int(codes[i]) in DEBT_CODES:
                    continue
                mag = abs(float(debts[i]))
                prev = self._prev.get(name)
                if prev is not None and mag > prev + F32_EPS:
                    out.append(Violation(
                        self.name, ctx.now, pname,
                        f"debt-free class {names[i]!r} accrued debt: "
                        f"|debt| {mag:.4f} > previous {prev:.4f}"))
                self._prev[name] = mag
        return out


@register_checker
class Capacity(Checker):
    name = "capacity"
    description = ("in-flight/resident/KV accounting closed against "
                   "the request table; backend lanes never exceed "
                   "replica slots; fleet never exceeds max_replicas")

    def check(self, ctx: CheckContext) -> list[Violation]:
        out: list[Violation] = []
        for pname, snap in ctx.snaps.items():
            names = snap["alive_names"]
            for col in ("in_flight_col", "resident_col",
                        "kv_in_use_col"):
                neg = np.flatnonzero(snap[col] < 0)
                for i in neg:
                    out.append(Violation(
                        self.name, ctx.now, pname,
                        f"negative {col[:-4]} {snap[col][i]} for "
                        f"{names[i]!r}"))
            mism = np.flatnonzero(
                snap["in_flight_col"] != snap["per_slot_in_flight"])
            for i in mism:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"in_flight counter {snap['in_flight_col'][i]} for "
                    f"{names[i]!r} != table recount "
                    f"{snap['per_slot_in_flight'][i]}"))
            mism = np.flatnonzero(
                snap["resident_col"] != snap["per_slot_resident"])
            for i in mism:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"resident counter {snap['resident_col'][i]} for "
                    f"{names[i]!r} != table recount "
                    f"{snap['per_slot_resident'][i]}"))
            over = np.flatnonzero(
                snap["resident_col"] > snap["in_flight_col"])
            for i in over:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"resident {snap['resident_col'][i]} exceeds "
                    f"in-flight {snap['in_flight_col'][i]} for "
                    f"{names[i]!r}"))
            if snap["replicas"] > snap["max_replicas"]:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"{snap['replicas']} live replicas exceed ceiling "
                    f"{snap['max_replicas']}"))
            for r in ctx.sim.replicas.get(pname, ()):
                if r.load() > r.slots:
                    out.append(Violation(
                        self.name, ctx.now, pname,
                        f"replica {r.name} holds {r.load()} sequences "
                        f"over its {r.slots} slots"))
        return out


@register_checker
class MirrorCoherence(Checker):
    name = "mirror-coherence"
    description = ("cached device mirror matches host columns — any "
                   "host write without mark_dirty() shows as drift")

    def check(self, ctx: CheckContext) -> list[Violation]:
        out: list[Violation] = []
        for pname, snap in ctx.snaps.items():
            stale = {col: d for col, d in snap["mirror_drift"].items()
                     if d > 0.0}
            if stale:
                out.append(Violation(
                    self.name, ctx.now, pname,
                    f"device mirror stale for columns {stale} — host "
                    f"write bypassed mark_dirty()"))
        return out


@register_checker
class GuaranteedP99(Checker):
    name = "guaranteed-p99"
    scope = "final"
    description = ("guaranteed-tier P99 latency bounded per the "
                   "scenario's Experiment-1 budget")

    def check(self, ctx: CheckContext) -> list[Violation]:
        scenario = ctx.scenario
        if scenario is None or scenario.p99_bound_s is None:
            return []
        tel = ctx.sim.telemetry
        if tel is None:
            return []
        tier = tel.slo.snapshot().get("guaranteed")
        if not tier or not tier["completions"]:
            return []
        if tier["p99_s"] > scenario.p99_bound_s:
            return [Violation(
                self.name, ctx.now, None,
                f"guaranteed P99 {tier['p99_s']:.3f}s exceeds the "
                f"scenario bound {scenario.p99_bound_s:.3f}s "
                f"({tier['completions']} completions)")]
        return []
