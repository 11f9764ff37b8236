"""SLO attainment tracking — per-tier latency histograms and
attainment ratios fed from ``on_complete_batch``.

The tracker owns three registry families:

* ``repro_request_latency_seconds{tier}`` — log-spaced histogram of
  end-to-end request latency per service class (live P50/P99 views);
* ``repro_slo_completions_total{tier}`` / ``repro_slo_met_total{tier}``
  — completion and SLO-met counters, whose ratio is the attainment
  fraction the experiments assert against.

The hot surface is ``observe_rows(latencies, tier_codes, slo_s)`` —
one histogram ``observe_rows`` plus two ``inc_rows`` per completion
drain.  The scalar ``observe`` twin is the parity oracle.  Series ids
are pre-resolved per class code at construction so the hot path does
no dict work.

Counterpart of ``repro/telemetry/slo.py`` (numpy only; the port
keeps its own copy).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.control_plane import CLASS_CODES
from repro_torch.core.markers import hot_path
from repro_torch.telemetry.registry import MetricsRegistry

__all__ = ["SloTracker", "TIER_NAMES"]

#: class code → tier label, ordered by code (see CLASS_CODES).
TIER_NAMES: tuple[str, ...] = tuple(
    sc.value for sc, _ in sorted(CLASS_CODES.items(), key=lambda kv: kv[1]))


class SloTracker:
    """Per-tier latency + attainment accounting over the registry."""

    def __init__(self, registry: MetricsRegistry) -> None:
        self.latency = registry.histogram(
            "repro_request_latency_seconds",
            help="End-to-end request latency by service tier.",
            labels=("tier",), lo=1e-3, hi=120.0, buckets=40)
        self.completions = registry.counter(
            "repro_slo_completions_total",
            help="Completed requests by service tier.",
            labels=("tier",))
        self.met = registry.counter(
            "repro_slo_met_total",
            help="Completions that met their SLO latency target.",
            labels=("tier",))
        #: class code → series id (identical across the 3 families by
        #: construction order; kept separate anyway for robustness)
        self._lat_sids = np.array(
            [self.latency.series((t,)) for t in TIER_NAMES], np.int64)
        self._cmp_sids = np.array(
            [self.completions.series((t,)) for t in TIER_NAMES], np.int64)
        self._met_sids = np.array(
            [self.met.series((t,)) for t in TIER_NAMES], np.int64)

    def observe(self, latency_s: float, tier_code: int,
                slo_s: float) -> None:
        """Scalar oracle — one completion."""
        self.latency.observe(int(self._lat_sids[tier_code]), latency_s)
        self.completions.inc(int(self._cmp_sids[tier_code]))
        if latency_s <= slo_s:
            self.met.inc(int(self._met_sids[tier_code]))

    @hot_path
    def observe_rows(self, latencies: np.ndarray,
                     tier_codes: np.ndarray, slo_s: np.ndarray) -> None:
        """Batch recorder: one completion drain = three row-ops."""
        latencies = np.asarray(latencies, np.float64)
        tier_codes = np.asarray(tier_codes, np.int64)
        self.latency.observe_rows(latencies, self._lat_sids[tier_codes])
        self.completions.inc_rows(self._cmp_sids[tier_codes], 1.0)
        met = latencies <= np.asarray(slo_s, np.float64)
        if np.any(met):
            self.met.inc_rows(self._met_sids[tier_codes[met]], 1.0)

    # -- live views --------------------------------------------------------
    def _code(self, tier: str) -> int:
        return TIER_NAMES.index(tier)

    def attainment(self, tier: str) -> float:
        """SLO-met fraction for ``tier`` (1.0 when nothing completed —
        an idle tier has not violated anything)."""
        code = self._code(tier)
        total = self.completions.read(int(self._cmp_sids[code]))
        if total == 0:
            return 1.0
        return self.met.read(int(self._met_sids[code])) / total

    def p50(self, tier: str) -> float:
        return self.latency.quantile(
            int(self._lat_sids[self._code(tier)]), 0.50)

    def p99(self, tier: str) -> float:
        return self.latency.quantile(
            int(self._lat_sids[self._code(tier)]), 0.99)

    def snapshot(self) -> dict:
        """Per-tier {completions, attainment, p50_s, p99_s} dict."""
        out = {}
        for code, tier in enumerate(TIER_NAMES):
            total = self.completions.read(int(self._cmp_sids[code]))
            if total == 0:
                continue
            out[tier] = {
                "completions": total,
                "attainment": self.attainment(tier),
                "p50_s": self.p50(tier),
                "p99_s": self.p99(tier),
            }
        return out
