"""Exporters: Prometheus text exposition, JSON snapshot, and a
Chrome-trace-event (Perfetto-loadable) timeline.

All three are COLD paths — they read registry arrays / the trace
buffer, never the other way round.  The trace buffer itself is
append-only Python (events are rare relative to decisions: one per
quantum / tick / scale event / incident, not one per request), with a
hard cap so a long simulation cannot grow without bound.

Chrome trace format notes (``chrome://tracing`` / ui.perfetto.dev):
timestamps and durations are MICROseconds; ``ph`` codes used here are
``X`` (complete slice), ``i`` (instant), ``C`` (counter) and ``M``
(metadata, for track names).

Counterpart of ``repro/telemetry/export.py`` (numpy only; the port
keeps its own copy).
"""
from __future__ import annotations

import json
from typing import Optional

from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            MetricsRegistry)

__all__ = ["TraceBuffer", "chrome_trace_json", "json_snapshot",
           "prometheus_text"]


# ---------------------------------------------------------------------------
# Prometheus text exposition (version 0.0.4)
# ---------------------------------------------------------------------------

def _escape_label(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _labels_str(names: tuple, values: tuple, extra: str = "") -> str:
    parts = [f'{n}="{_escape_label(str(v))}"'
             for n, v in zip(names, values)]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(registry: MetricsRegistry) -> str:
    """Render every family in the Prometheus text format.  Histograms
    emit cumulative ``_bucket{le=...}`` samples (closing with
    ``le="+Inf"``), ``_sum`` and ``_count``; callback gauges are
    evaluated at scrape time — exactly the Redis/Prometheus shape the
    paper's platform would scrape."""
    lines: list[str] = []
    for fam in registry.families():
        if fam.help:
            lines.append(f"# HELP {fam.name} {fam.help}")
        lines.append(f"# TYPE {fam.name} {fam.kind}")
        if isinstance(fam, Histogram):
            for sid, labels in enumerate(fam.series_labels):
                cum = 0
                for b, edge in enumerate(fam.edges):
                    cum += int(fam.counts[sid, b])
                    ls = _labels_str(fam.label_names, labels,
                                     f'le="{_fmt(edge)}"')
                    lines.append(f"{fam.name}_bucket{ls} {cum}")
                total = int(fam.totals[sid])
                ls = _labels_str(fam.label_names, labels, 'le="+Inf"')
                lines.append(f"{fam.name}_bucket{ls} {total}")
                ls = _labels_str(fam.label_names, labels)
                lines.append(f"{fam.name}_sum{ls} {_fmt(fam.sums[sid])}")
                lines.append(f"{fam.name}_count{ls} {total}")
        elif isinstance(fam, (Counter, Gauge)):
            for sid, labels in enumerate(fam.series_labels):
                ls = _labels_str(fam.label_names, labels)
                lines.append(f"{fam.name}{ls} {_fmt(fam.read(sid))}")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# JSON snapshot
# ---------------------------------------------------------------------------

def json_snapshot(registry: MetricsRegistry) -> dict:
    """Registry state as plain JSON-serializable dicts (one entry per
    family; series keyed by their joined label values)."""
    out: dict = {}
    for fam in registry.families():
        series: dict = {}
        for sid, labels in enumerate(fam.series_labels):
            key = ",".join(str(v) for v in labels) or "_"
            if isinstance(fam, Histogram):
                series[key] = {
                    "count": int(fam.totals[sid]),
                    "sum": float(fam.sums[sid]),
                    "p50": fam.quantile(sid, 0.50),
                    "p99": fam.quantile(sid, 0.99),
                }
            else:
                series[key] = float(fam.read(sid))
        out[fam.name] = {"kind": fam.kind,
                         "labels": list(fam.label_names),
                         "series": series}
    return out


# ---------------------------------------------------------------------------
# Chrome trace events
# ---------------------------------------------------------------------------

class TraceBuffer:
    """Append-only Chrome-trace event list with a hard cap.  Tracks
    (``tid``) are interned per pool/source; ``pid`` is always 1 (one
    logical process — the control plane)."""

    def __init__(self, max_events: int = 200_000) -> None:
        self.events: list[dict] = []
        self.max_events = max_events
        self.dropped = 0
        self._tids: dict[str, int] = {}

    def tid(self, track: str) -> int:
        """Intern a track name → tid (emits the ``M`` metadata event
        naming the track on first use)."""
        t = self._tids.get(track)
        if t is None:
            t = len(self._tids) + 1
            self._tids[track] = t
            self.events.append({
                "name": "thread_name", "ph": "M", "pid": 1, "tid": t,
                "args": {"name": track}})
        return t

    def _push(self, ev: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def complete(self, name: str, track: str, ts_s: float,
                 dur_s: float, args: Optional[dict] = None) -> None:
        """A ``ph:X`` slice — quanta, ticks, incident windows."""
        self._push({"name": name, "ph": "X", "pid": 1,
                    "tid": self.tid(track),
                    "ts": ts_s * 1e6, "dur": max(0.0, dur_s) * 1e6,
                    "args": args or {}})

    def instant(self, name: str, track: str, ts_s: float,
                args: Optional[dict] = None) -> None:
        """A ``ph:i`` marker — scale/migration events."""
        self._push({"name": name, "ph": "i", "s": "t", "pid": 1,
                    "tid": self.tid(track), "ts": ts_s * 1e6,
                    "args": args or {}})

    def counter(self, name: str, track: str, ts_s: float,
                values: dict) -> None:
        """A ``ph:C`` sample — water-fill level / debt timelines."""
        self._push({"name": name, "ph": "C", "pid": 1,
                    "tid": self.tid(track), "ts": ts_s * 1e6,
                    "args": values})


def chrome_trace_json(trace: TraceBuffer) -> str:
    """Serialize to the JSON object form Perfetto loads directly."""
    return json.dumps({"traceEvents": trace.events,
                       "displayTimeUnit": "ms"})
