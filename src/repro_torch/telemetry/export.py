"""Exporters: Prometheus text exposition, JSON snapshot, and a
Chrome-trace-event (Perfetto-loadable) timeline.

All three are COLD paths — they read registry arrays / the trace
buffer, never the other way round.  The trace buffer itself is
append-only Python (events are rare relative to decisions: one per
quantum / tick / scale event / incident, not one per request), with a
hard cap so a long simulation cannot grow without bound.

Beside the events, the buffer keeps SPANS: ``begin``/``end`` pairs on
the host clock, each with its parent span and request id, and, for a
span that brackets device work, the device interval that a pair of CUDA
events measured (``telemetry/device.py``).  Spans share the events' cap
and ``dropped`` count; ``spans()`` hands them to a reader as tuples, and
the Chrome export draws each as an ``X`` slice on its track and its
device interval as a second slice on the ``device`` track.

Chrome trace format notes (``chrome://tracing`` / ui.perfetto.dev):
timestamps and durations are MICROseconds; ``ph`` codes used here are
``X`` (complete slice), ``i`` (instant), ``C`` (counter) and ``M``
(metadata, for track names).

Counterpart of ``repro/telemetry/export.py`` (numpy only; the port
keeps its own copy).
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional

from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            MetricsRegistry)

__all__ = ["Span", "TraceBuffer", "chrome_trace_json", "json_snapshot",
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

class Span(NamedTuple):
    """One span as ``TraceBuffer.spans()`` gives it.  Times are seconds
    on the host clock; ``end`` is None while the span is open, and the
    device interval is None where no device events were taken."""

    sid: int
    name: str
    track: str
    start: float
    end: Optional[float]
    parent: Optional[int]
    rid: Optional[str]
    device_start: Optional[float]
    device_end: Optional[float]
    args: dict


#: positions in a span's record (a list, so ``end`` fills it in place)
_NAME, _TRACK, _T0, _T1, _PARENT, _RID, _ARGS, _D0, _D1 = range(9)


class TraceBuffer:
    """Append-only Chrome-trace event list with a hard cap.  Tracks
    (``tid``) are interned per pool/source; ``pid`` is always 1 (one
    logical process — the control plane).  ``device_clock`` (None until
    a ``DeviceClock`` is attached) lets spans carry device intervals."""

    def __init__(self, max_events: int = 200_000) -> None:
        self.events: list[dict] = []
        self.max_events = max_events
        self.dropped = 0
        self._tids: dict[str, int] = {}
        self._spans: list[list] = []
        #: span ids whose device events are not yet read
        self._unresolved: list[int] = []
        self.device_clock = None

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
        if len(self.events) + len(self._spans) >= self.max_events:
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

    # -- spans ---------------------------------------------------------------
    def begin(self, name: str, track: str, t: float,
              parent: Optional[int] = None, rid: Optional[str] = None,
              args: Optional[dict] = None, device: bool = False) -> int:
        """Open a span at host time ``t``; returns its id, or -1 when
        the buffer is full (``end(-1)`` does nothing).  With ``device``
        and a device clock attached, a CUDA event is recorded here and
        another at ``end``; neither synchronises."""
        if len(self.events) + len(self._spans) >= self.max_events:
            self.dropped += 1
            return -1
        sid = len(self._spans)
        d0 = None
        if device and self.device_clock is not None:
            d0 = self.device_clock.mark()
            self._unresolved.append(sid)
        self._spans.append([name, track, t, None, parent, rid, args, d0,
                            None])
        return sid

    def end(self, sid: int, t: float, args: Optional[dict] = None) -> None:
        """Close span ``sid`` at host time ``t``, merging ``args`` into
        its own."""
        if sid < 0:
            return
        span = self._spans[sid]
        span[_T1] = t
        if args:
            span[_ARGS] = {**span[_ARGS], **args} if span[_ARGS] else args
        if span[_D0] is not None:
            span[_D1] = self.device_clock.mark()

    def _resolve(self) -> None:
        """Put the recorded device events on the host clock (one
        synchronise), once; a span left open keeps no interval."""
        if not self._unresolved:
            return
        spans = [self._spans[sid] for sid in self._unresolved]
        done = [s for s in spans if s[_D1] is not None]
        times = self.device_clock.resolve(
            [e for s in done for e in (s[_D0], s[_D1])])
        for i, s in enumerate(done):
            s[_D0], s[_D1] = times[2 * i], times[2 * i + 1]
        for s in spans:
            if s[_D1] is None:
                s[_D0] = None
        self._unresolved = []

    def spans(self) -> list[Span]:
        """Every span, in the order begun, device intervals resolved."""
        self._resolve()
        return [Span(i, *s[:_ARGS], s[_D0], s[_D1], s[_ARGS] or {})
                for i, s in enumerate(self._spans)]

    def counters(self) -> list[tuple[str, float, dict]]:
        """Every ``ph:C`` sample as ``(name, seconds, values)``."""
        return [(e["name"], e["ts"] / 1e6, e["args"])
                for e in self.events if e["ph"] == "C"]

    def span_events(self) -> list[dict]:
        """The closed spans as ``ph:X`` slices, with ``parent`` and
        ``rid`` in ``args``, and their device intervals as slices on
        the ``device`` track."""
        out = []
        for sp in self.spans():
            if sp.end is None:
                continue
            args = {**sp.args, "span": sp.sid, "parent": sp.parent,
                    "rid": sp.rid}
            out.append({"name": sp.name, "ph": "X", "pid": 1,
                        "tid": self.tid(sp.track), "ts": sp.start * 1e6,
                        "dur": max(0.0, sp.end - sp.start) * 1e6,
                        "args": args})
            if sp.device_start is not None:
                out.append({
                    "name": sp.name, "ph": "X", "pid": 1,
                    "tid": self.tid("device"),
                    "ts": sp.device_start * 1e6,
                    "dur": max(0.0, sp.device_end - sp.device_start) * 1e6,
                    "args": args})
        return out


def chrome_trace_json(trace: TraceBuffer) -> str:
    """Serialize to the JSON object form Perfetto loads directly."""
    spans = trace.span_events()
    return json.dumps({"traceEvents": trace.events + spans,
                       "displayTimeUnit": "ms"})
