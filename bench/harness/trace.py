"""The traced run: spans from the harness around the calls into each
layer, and the device trace of a slice of the window.

Spans are host times (``driver.clock``) taken by wrappers that the
harness puts around ``Gateway.handle``, ``Model.prefill``,
``Model.decode_step`` (each ending in a synchronise) and
``InferenceEngine._start`` on the objects of this run.  Before it wraps
them, the harness sets the engine's telemetry, so the program records
its own spans and counters (``harness.program``) on the same clock, its
``model.*`` spans inside the harness's synchronised ones; an untraced
run leaves the telemetry off.  ``torch.profiler`` records the device's
operations (CUDA activity only) from the first step boundary after a
third of the window to the first after its close; the kernels are
summed in memory, by name, once the window is over, and no trace file
is written.  A first, empty profiling session during set-up starts the
profiler's machinery, so that starting it in the window costs little.
The host clock and the profiler's clock are tied by a marker kernel
launched on an idle device right after the profiler starts.  Each
idle gap of the device is charged twice: to the harness's phase open at
its midpoint (``idle_by_phase``, the breakdown's) and to the innermost
program span open there, else that phase (``idle_by_span``).
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import Optional

from harness import program
from harness.driver import clock

#: host phases, innermost first, that an idle gap of the device is
#: charged to; a gap in none of them is the harness's
PHASES = ("model.prefill", "model.decode_step", "gateway.handle",
          "pool.tick", "engine.step")


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict
    kernel_n: dict
    idle_by_phase: dict
    idle_by_span: Optional[dict]
    prefill_tokens: list
    decode_contexts: list


class Tracer:
    def __init__(self, seconds: float, torch) -> None:
        self.torch = torch
        self.start_at = seconds / 3.0
        self.stop_at = seconds
        self.prof = None
        self.h0 = self.h1 = None
        self.spans: dict[str, list] = {
            "gateway.handle": [], "pool.tick": [], "model.prefill": [],
            "model.decode_step": []}
        self.host: dict[str, list] = {p: [] for p in PHASES}
        self.prefill_tokens: list[int] = []
        self.decode_contexts: list[list[int]] = []
        self.trace: Optional[Trace] = None
        #: the engine's telemetry, and its record once the run is over
        self.tel = None
        self.program: Optional[dict] = None

    @property
    def active(self) -> bool:
        return self.prof is not None and self.h1 is None

    # -- instrumentation ----------------------------------------------------
    def instrument(self, run) -> None:
        """Set the telemetry of ``run``'s engine, then wrap the calls
        into each layer of it."""
        import dataclasses as dc
        from repro_torch.telemetry import Telemetry
        torch = self.torch
        eng = run.engine
        eng.telemetry = self.tel = Telemetry()
        handle = eng.gateway.handle

        def timed_handle(*a, **k):
            t = clock()
            out = handle(*a, **k)
            self.record("gateway.handle", t, clock())
            return out
        eng.gateway.handle = timed_handle

        def synced(name, fn, size):
            def call(*a, **k):
                t = clock()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                self.record(name, t, clock(), size(*a))
                return out
            return call
        eng.model = dc.replace(
            eng.model,
            prefill=synced("model.prefill", eng.model.prefill,
                           lambda p, tok, *r: tok.shape[1]),
            decode_step=synced("model.decode_step", eng.model.decode_step,
                               lambda p, tok, *r: tok.shape[0]))
        start = eng._start

        def timed_start(lane_idx, req, now):
            run.by_rid[req.request_id].prefill_start = run.now()
            return start(lane_idx, req, now)
        eng._start = timed_start

    def record(self, name: str, t0: float, t1: float, size=None) -> None:
        self.spans[name].append(t1 - t0 if size is None else (t1 - t0, size))
        if self.active:
            self.host[name].append((t0, t1))

    def tick_done(self, t0: float, t1: float) -> None:
        self.torch.cuda.synchronize()
        self.record("pool.tick", t0, clock())

    def host_span(self, name: str, t0: float, t1: float) -> None:
        if self.active:
            self.host[name].append((t0, t1))

    def step_done(self, t0: float, t1: float, prefills: list,
                  contexts: list) -> None:
        if self.active:
            self.host["engine.step"].append((t0, t1))
            self.prefill_tokens += prefills
            if contexts:
                self.decode_contexts.append(contexts)

    # -- the profiler ----------------------------------------------------------
    def prepare(self) -> None:
        """An empty profiling session, in set-up."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            self.torch.cuda._sleep(1000)
            self.torch.cuda.synchronize()

    def boundary(self, now: float) -> None:
        """Called between steps: start or stop the profiler."""
        torch = self.torch
        if self.prof is None and now >= self.start_at:
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
            torch.cuda.synchronize()
            self.h0 = clock()
            torch.cuda._sleep(1000)             # the clock marker
            torch.cuda.synchronize()
        elif self.active and now >= self.stop_at:
            torch.cuda.synchronize()
            self.h1 = clock()
            self.prof.__exit__(None, None, None)

    def finish(self) -> None:
        """Read the program's record and sum the traced kernels, after
        the window."""
        if self.tel is not None:
            self.program = program.records(self.tel)
        if self.prof is not None and self.h1 is not None:
            self.trace = self.summarise()
        self.prof = None

    def summarise(self) -> Optional[Trace]:
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type().name != "CUDA":
                continue
            if hasattr(e, "start_ns"):
                t, d = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                t, d = e.start_us() * 1e-6, e.duration_us() * 1e-6
            events.append((t, d, e.name()))
        if not events:
            return None
        events.sort()
        offset = events[0][0] - self.h0          # the marker comes first
        lo, hi = self.h0 + offset, self.h1 + offset
        kernel_s: dict[str, float] = {}
        kernel_n: dict[str, int] = {}
        busy = 0.0
        gaps = []           # (host midpoint, seconds)
        phases = {p: sorted(self.host[p]) for p in PHASES}
        starts = {p: [s for s, _ in phases[p]] for p in PHASES}
        end = lo
        for t, d, name in events[1:]:
            kernel_s[name] = kernel_s.get(name, 0.0) + d
            kernel_n[name] = kernel_n.get(name, 0) + 1
            a, b = max(t, lo), min(t + d, hi)
            if b <= a:
                continue
            if a > end:
                gaps.append(((end + a) / 2.0 - offset, a - end))
            if b > end:
                busy += b - max(a, end)
                end = b
        if hi > end:
            gaps.append(((end + hi) / 2.0 - offset, hi - end))
        idle: dict[str, float] = {}
        for mid, length in gaps:
            who = self.phase(mid, phases, starts)
            idle[who] = idle.get(who, 0.0) + length
        by_span = None
        if self.program is not None:
            by_span = program.idle_by_span(
                gaps, self.program,
                lambda t: self.phase(t, phases, starts))
        return Trace(self.h1 - self.h0, busy, kernel_s, kernel_n, idle,
                     by_span, list(self.prefill_tokens),
                     list(self.decode_contexts))

    @staticmethod
    def phase(t: float, phases: dict, starts: dict) -> str:
        for p in PHASES:
            i = bisect.bisect_right(starts[p], t) - 1
            if i >= 0 and phases[p][i][1] >= t:
                return p
        return "harness"

    def breakdown(self) -> Optional[dict]:
        if self.trace is None:
            return None
        top = sorted(self.trace.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.trace.idle_by_phase.items(),
                      key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}
