"""The ``Telemetry`` facade — one object wiring the registry, the
admission flight recorder, the SLO tracker and the trace buffer into
the gateway / pool / simulator instrumentation points.

Recording discipline matches the rest of the control plane:

* per-REQUEST surfaces (``record_decisions``, ``record_completions``,
  ``record_terminal``) are ``@hot_path`` and batch-only — one flight
  scatter + a handful of registry row-ops per quantum, with series ids
  pre-resolved per pool at attach time;
* per-EVENT surfaces (``on_tick``, ``on_quantum``, ``on_plan``,
  incidents) fire once per tick/quantum/plan — O(pools) per tick, not
  O(requests) — so they may use the scalar recorders;
* the scalar ``record_decision`` twin serves the sequential
  ``Gateway.handle`` path and doubles as the flight-recorder parity
  oracle.

``attach_pool`` BINDS (not copies) the pool's legacy ``gauges()``
callables into registry gauge series, so ``pool.stats()`` and the
Prometheus exposition read the same underlying values — the legacy
dict is a thin view, per the migration contract.

Counterpart of ``repro/telemetry/facade.py`` (numpy only; the port
keeps its own copy).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.control_plane import CLASS_CODES
from repro_torch.core.markers import hot_path
from repro_torch.telemetry import flight as fl
from repro_torch.telemetry.export import (TraceBuffer, chrome_trace_json,
                                          json_snapshot, prometheus_text)
from repro_torch.telemetry.flight import FlightRecorder
from repro_torch.telemetry.registry import MetricsRegistry
from repro_torch.telemetry.slo import TIER_NAMES, SloTracker

__all__ = ["Telemetry"]

_N_TIERS = len(TIER_NAMES)


class Telemetry:
    """Registry + flight recorder + SLO tracker + trace timeline."""

    def __init__(self, flight_capacity: int = 65536,
                 trace_max_events: int = 200_000) -> None:
        self.registry = MetricsRegistry()
        self.flight = FlightRecorder(flight_capacity)
        self.slo = SloTracker(self.registry)
        self.trace = TraceBuffer(trace_max_events)

        r = self.registry
        self.decisions = r.counter(
            "repro_admission_decisions_total",
            help="Admission decisions by pool, tier and verdict.",
            labels=("pool", "tier", "verdict"))
        self.terminal = r.counter(
            "repro_gateway_terminal_total",
            help="Requests that never reached a pool decision.",
            labels=("verdict",))
        self.tick_duration = r.histogram(
            "repro_pool_tick_duration_seconds",
            help="Wall-clock duration of one control tick.",
            labels=("pool",), lo=1e-6, hi=10.0, buckets=40)
        self.quantum_duration = r.histogram(
            "repro_gateway_quantum_duration_seconds",
            help="Wall-clock duration of one admission quantum.",
            lo=1e-6, hi=10.0, buckets=40)
        self.quantum_requests = r.counter(
            "repro_gateway_quantum_requests_total",
            help="Requests processed through handle_quantum.")
        self.waterfill = r.gauge(
            "repro_pool_waterfill_tokens",
            help="Water-filling allocation total at the last tick.",
            labels=("pool",))
        self.debt_total = r.gauge(
            "repro_pool_debt_total",
            help="Summed entitlement debt at the last tick.",
            labels=("pool",))
        self.replicas = r.gauge(
            "repro_pool_replicas_desired",
            help="Fleet planner's desired replica count.",
            labels=("pool",))
        self.scale_events = r.counter(
            "repro_fleet_scale_events_total",
            help="Authorized scale transitions by direction.",
            labels=("pool", "direction"))
        self.migrations = r.counter(
            "repro_fleet_migrations_total",
            help="Entitlement migrations applied by the planner.")
        self.incidents = r.counter(
            "repro_incidents_total",
            help="Incident windows opened (failures, chaos events).")

        self._q_sid = self.quantum_duration.series(())
        self._qreq_sid = self.quantum_requests.series(())
        self._migr_sid = self.migrations.series(())
        self._incid_sid = self.incidents.series(())
        #: terminal verdict name → counter sid
        self._term_sids = {
            name: self.terminal.series((name,))
            for name in ("unknown_key", "unroutable")}

        #: pool name → attached TokenPool (decision-time column reads)
        self._pools: dict = {}
        #: pool name → (2, n_tiers) decision sids [admit/deny, tier]
        self._dec_sids: dict[str, np.ndarray] = {}
        #: pool name → (tick-histogram sid, waterfill sid, debt sid)
        self._tick_sids: dict[str, tuple[int, int, int]] = {}
        #: (pool, entitlement) → (class code, slo seconds)
        self._tier_cache: dict[tuple, tuple[int, float]] = {}
        #: open incident windows: key → start clock
        self._open_incidents: dict[str, float] = {}
        #: closed incident windows: (key, start, end) in close order
        self._closed_incidents: list[tuple[str, float, float]] = []

    # -- attachment --------------------------------------------------------
    def attach_pool(self, pool) -> None:
        """Wire one pool in (idempotent): set ``pool.telemetry``, bind
        its legacy ``gauges()`` callables as registry gauge series, and
        pre-resolve every hot-path series id."""
        name = pool.spec.name
        if name in self._pools:
            return
        self._pools[name] = pool
        pool.telemetry = self
        self.flight.pool_id(name)
        for stat, fn in pool.gauges().items():
            self.registry.gauge(
                f"repro_pool_{stat}",
                help=f"Live pool {stat} (bound to pool.gauges()).",
                labels=("pool",)).bind((name,), fn)
        sids = np.empty((2, _N_TIERS), np.int64)
        for t, tier in enumerate(TIER_NAMES):
            sids[0, t] = self.decisions.series((name, tier, "admit"))
            sids[1, t] = self.decisions.series((name, tier, "deny"))
        self._dec_sids[name] = sids
        self._tick_sids[name] = (
            self.tick_duration.series((name,)),
            self.waterfill.series((name,)),
            self.debt_total.series((name,)))

    def _tier_of(self, pool_name: str, ent: str) -> tuple[int, float]:
        key = (pool_name, ent)
        hit = self._tier_cache.get(key)
        if hit is None:
            espec = self._pools[pool_name].entitlements[ent]
            hit = (CLASS_CODES[espec.qos.service_class],
                   espec.qos.slo_target_ms / 1000.0)
            self._tier_cache[key] = hit
        return hit

    # -- per-request hot surfaces -----------------------------------------
    @hot_path
    def record_decisions(self, pool_name: str, now: float,
                         rids, rows, legs,
                         admitted: np.ndarray, reasons, prios,
                         threshold: float, tokens,
                         levels_at=None) -> None:
        """One pool dispatch's decisions: ONE flight scatter + ONE
        counter row-op.  ``rows`` may contain -1 (NOT_BOUND skips that
        never reached the kernel); their state dims record as 0.
        ``levels_at`` optionally supplies the full-width bucket-level
        array AT DECISION TIME (the quantum snapshot) — without it the
        current resident column is read, which for a post-charge call
        reflects this batch's own deductions."""
        pool = self._pools.get(pool_name)
        if pool is None:
            raise KeyError(
                f"pool {pool_name!r} not attached to telemetry; "
                "call attach_pool first (Gateway does this on init)")
        c = pool.store.col
        rows = np.asarray(rows, np.int64)
        level_src = (np.asarray(levels_at, np.float64)
                     if levels_at is not None else c["bucket_level"])
        ok = rows >= 0
        if ok.all():                       # common case: no NB skips
            codes = c["class_code"][rows]
            levels = level_src[rows]
            debts = c["debt"][rows]
            bursts = c["burst"][rows]
        else:
            safe = np.where(ok, rows, 0)
            codes = np.where(ok, c["class_code"][safe], 0)
            levels = np.where(ok, level_src[safe], 0.0)
            debts = np.where(ok, c["debt"][safe], 0.0)
            bursts = np.where(ok, c["burst"][safe], 0.0)
        admitted = np.asarray(admitted, bool)
        verdicts = np.where(admitted, fl.VERDICT_ADMIT,
                            fl.VERDICT_DENY).astype(np.int16)
        self.flight.record_batch(
            rids, now,
            self.flight.pool_id(pool_name), legs, rows, verdicts,
            np.asarray(reasons, np.int16), prios, threshold, levels,
            debts, bursts, tokens)
        sids = self._dec_sids[pool_name][
            np.where(admitted, 0, 1), codes]
        self.decisions.inc_rows(sids, 1.0)

    @hot_path
    def record_terminal(self, now: float, request_ids: Sequence[str],
                        verdict: int, reason: int) -> None:
        """Route-level terminal rows (unknown key / no live pool):
        pool-less flight rows + one aggregated counter bump."""
        m = len(request_ids)
        if m == 0:
            return
        self.flight.record_batch(
            request_ids, now, -1, -1, -1,
            np.int16(verdict), np.int16(reason),
            0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        name = ("unknown_key" if verdict == fl.VERDICT_UNKNOWN_KEY
                else "unroutable")
        self.terminal.inc(self._term_sids[name], float(m))

    @hot_path
    def record_completions(self, now: float, pools: Sequence[str],
                           ents: Sequence[str],
                           latencies: Sequence[float]) -> None:
        """One completion drain: resolve (pool, ent) → (tier, SLO)
        through the cold cache, then ONE SLO row-op."""
        m = len(ents)
        if m == 0:
            return
        codes = np.empty(m, np.int64)
        slos = np.empty(m, np.float64)
        tier_of = self._tier_of
        for i in range(m):
            codes[i], slos[i] = tier_of(pools[i], ents[i])
        self.slo.observe_rows(np.asarray(latencies, np.float64),
                              codes, slos)

    def record_decision(self, pool_name: str, now: float,
                        request_id: str, leg: int,
                        entitlement: Optional[str], admitted: bool,
                        reason_code: int, priority: float,
                        tokens: float) -> None:
        """Scalar twin for the sequential ``Gateway.handle`` path (and
        the flight recorder's parity oracle): one decision, state dims
        read off the resident columns at call time."""
        pool = self._pools.get(pool_name)
        row = -1
        level = debt = burst = 0.0
        code = 0
        threshold = 0.0
        if pool is not None:
            threshold = (pool.admission_threshold()
                         * (1.0 - pool.spec.admission_slack))
            if entitlement is not None:
                row = pool.store.slot_of.get(entitlement, -1)
            if row >= 0:
                c = pool.store.col
                code = int(c["class_code"][row])
                level = float(c["bucket_level"][row])
                debt = float(c["debt"][row])
                burst = float(c["burst"][row])
        self.flight.record(
            request_id, now, pool_name, leg, row,
            fl.VERDICT_ADMIT if admitted else fl.VERDICT_DENY,
            reason_code, priority, threshold, level, debt, burst,
            tokens)
        if pool_name in self._dec_sids:
            sid = self._dec_sids[pool_name][0 if admitted else 1, code]
            self.decisions.inc(int(sid))

    def record_terminal_one(self, now: float, request_id: str,
                            verdict: int, reason: int) -> None:
        """Scalar terminal twin (sequential path)."""
        self.flight.record(request_id, now, None, -1, -1, verdict,
                           reason, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
        name = ("unknown_key" if verdict == fl.VERDICT_UNKNOWN_KEY
                else "unroutable")
        self.terminal.inc(self._term_sids[name])

    # -- per-event surfaces (once per tick/quantum/plan) -------------------
    def on_tick(self, pool_name: str, now: float, duration_s: float,
                alloc_total: float, debt_total: float,
                in_flight: int) -> None:
        """One pool control tick: duration histogram, water-fill /
        debt gauges, and a trace slice + counter track."""
        sids = self._tick_sids.get(pool_name)
        if sids is None:
            return
        tick_sid, wf_sid, debt_sid = sids
        self.tick_duration.observe(tick_sid, duration_s)
        self.waterfill.set(wf_sid, alloc_total)
        self.debt_total.set(debt_sid, debt_total)
        track = f"pool:{pool_name}"
        self.trace.complete(
            "control_tick", track, now, duration_s,
            args={"alloc_tokens": alloc_total, "debt": debt_total,
                  "in_flight": in_flight})
        self.trace.counter(
            f"waterfill:{pool_name}", track, now,
            {"tokens": alloc_total, "debt": debt_total})

    def on_quantum(self, now: float, n_requests: int,
                   duration_s: float) -> None:
        """One admission quantum through ``handle_quantum``."""
        self.quantum_duration.observe(self._q_sid, duration_s)
        self.quantum_requests.inc(self._qreq_sid, float(n_requests))
        self.trace.complete("admit_quantum", "gateway", now, duration_s,
                            args={"requests": n_requests})

    def on_plan(self, now: float, plan, duration_s: float) -> None:
        """One fleet planning round: replica gauges, scale/migration
        counters, trace markers."""
        for name, d in plan.decisions.items():
            self.replicas.set(self.replicas.series((name,)),
                              float(d.desired))
        for name, (old, new) in plan.scale_events.items():
            if new == old:
                continue
            direction = "up" if new > old else "down"
            self.scale_events.inc(
                self.scale_events.series((name, direction)))
            self.trace.instant(
                f"scale_{direction}:{name}", "fleet", now,
                args={"from": old, "to": new})
        for prop in plan.applied:
            self.migrations.inc(self._migr_sid)
            self.trace.instant(
                f"migrate:{prop.entitlement}", "fleet", now,
                args={"dst": prop.dst})
        self.trace.complete("plan_quantum", "fleet", now, duration_s)

    def incident_start(self, key: str, now: float) -> None:
        self._open_incidents[key] = now
        self.incidents.inc(self._incid_sid)
        self.trace.instant(f"incident_start:{key}", "incidents", now)

    def incident_end(self, key: str, now: float) -> None:
        start = self._open_incidents.pop(key, None)
        if start is None:
            return
        self._closed_incidents.append((key, start, now))
        self.trace.complete(f"incident:{key}", "incidents", start,
                            now - start)

    def incident_windows(self) -> list[tuple[str, float, Optional[float]]]:
        """All incident windows as ``(key, start, end)`` — closed ones
        first (in close order), then still-open ones with ``end=None``.
        Scenario assertions (the chaos harness) read THIS rather than
        the trace buffer."""
        out: list[tuple[str, float, Optional[float]]] = list(
            self._closed_incidents)
        out.extend((k, s, None) for k, s in self._open_incidents.items())
        return out

    # -- export ------------------------------------------------------------
    def prometheus(self) -> str:
        return prometheus_text(self.registry)

    def snapshot(self) -> dict:
        return {
            "metrics": json_snapshot(self.registry),
            "slo": self.slo.snapshot(),
            "flight_rows": len(self.flight),
            "trace_events": len(self.trace.events),
        }

    def chrome_trace(self) -> str:
        return chrome_trace_json(self.trace)

    def attach_device(self) -> None:
        """Let spans carry device intervals: take the CUDA anchor that
        puts the device's events on ``clock()`` (idempotent; call it
        while the device is idle, in set-up)."""
        if self.trace.device_clock is None:
            from repro_torch.telemetry.device import DeviceClock
            self.trace.device_clock = DeviceClock(self.clock)

    @staticmethod
    def clock() -> float:
        """Wall-clock source for duration measurements."""
        return time.perf_counter()
