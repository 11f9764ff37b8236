"""The program's own spans and counters in a traced run.

``InferenceEngine(telemetry=)`` records, on the host clock the harness
shares (``time.perf_counter``), a span tree for each step, request
spans under one id and four counters a decode step
(``repro_torch/serving/engine.py``).  :func:`records` turns the
engine's telemetry into plain lists for the metric readers, under the
records' key ``"program"``; :func:`complete` gives a reader that
record, or None where the run has none or the program's trace dropped
events; :func:`idle_by_span` charges the device's idle gaps to the
innermost program span open at each gap's midpoint.

A traced run records them: ``harness.trace.Tracer`` sets the engine's
telemetry before it wraps ``engine.model`` (so the program's ``model.*``
spans sit inside the harness's synchronised ones) and reads the record
once the run is over; an untraced run has none (``"program"`` None).
"""
from __future__ import annotations

import bisect
from typing import Callable, Optional

from repro_torch.serving.engine import TRACK as ENGINE_TRACK
from repro_torch.telemetry import Span


def records(telemetry) -> dict:
    """The engine's spans, counter samples and dropped count."""
    trace = telemetry.trace
    return {"spans": [list(s) for s in trace.spans()],
            "counters": [list(c) for c in trace.counters()],
            "dropped": trace.dropped}


def complete(rec) -> Optional[dict]:
    """The run's program record, if it has one with nothing dropped."""
    prog = rec.get("program")
    if not prog or not prog["spans"] or prog["dropped"]:
        return None
    return prog


def spans(prog: dict, name: Optional[str] = None) -> list:
    """The closed spans of ``prog`` (named ``name``, if given)."""
    every = (Span(*s) for s in prog["spans"])
    return [s for s in every
            if s.end is not None and (name is None or s.name == name)]


def counter(prog: dict, name: str) -> list[float]:
    """The samples of counter ``name``, in order."""
    return [v[name] for n, _, v in prog["counters"] if n == name]


def _innermost(prog: dict) -> tuple[list, list]:
    """The engine track's nesting as a step function: boundary times
    and, from each, the innermost open span's name (None: no span)."""
    times, names = [], []
    stack = []
    for s in sorted(spans(prog), key=lambda s: (s.start, -s.end)):
        if s.track != ENGINE_TRACK:
            continue
        while stack and stack[-1].end <= s.start:
            done = stack.pop()
            times.append(done.end)
            names.append(stack[-1].name if stack else None)
        stack.append(s)
        times.append(s.start)
        names.append(s.name)
    while stack:
        done = stack.pop()
        times.append(done.end)
        names.append(stack[-1].name if stack else None)
    return times, names


def idle_by_span(gaps: list, prog: dict,
                 fallback: Callable[[float], str]) -> dict:
    """Seconds of device idle by program span: each gap ``(midpoint,
    seconds)``, its midpoint on the host clock, goes to the innermost
    engine span open there, or to ``fallback(midpoint)`` (the harness's
    phase) where none is."""
    times, names = _innermost(prog)
    out: dict[str, float] = {}
    for mid, length in gaps:
        i = bisect.bisect_right(times, mid) - 1
        who = names[i] if i >= 0 and names[i] is not None \
            else fallback(mid)
        out[who] = out.get(who, 0.0) + length
    return out
