"""Vectorized telemetry plane: metrics registry, admission flight
recorder, SLO attainment tracking, and Prometheus / JSON /
Chrome-trace exporters.

Quickstart::

    from repro_torch.telemetry import Telemetry
    gw = Gateway(pool, telemetry=True)       # or telemetry=Telemetry()
    ...
    print(gw.telemetry.prometheus())         # Prometheus exposition
    print(gw.telemetry.flight.explain(rid).narrative())
    open("trace.json", "w").write(gw.telemetry.chrome_trace())

    engine = InferenceEngine(model, params, slots, max_seq, gateway=gw,
                             telemetry=Telemetry())   # engine spans
    engine.telemetry.trace.spans()           # (sid, name, ..., device)

Counterpart of ``repro.telemetry``: numpy only, so the port keeps its
own copy of every module, importing the port's ``core``.
"""
from repro_torch.telemetry.export import (Span, TraceBuffer,
                                          chrome_trace_json, json_snapshot,
                                          prometheus_text)
from repro_torch.telemetry.facade import Telemetry
from repro_torch.telemetry.flight import (DecisionTrace, FlightRecorder,
                                          FlightRow)
from repro_torch.telemetry.registry import (Counter, Gauge, Histogram,
                                            MetricsRegistry)
from repro_torch.telemetry.slo import SloTracker, TIER_NAMES

__all__ = [
    "Counter",
    "DecisionTrace",
    "FlightRecorder",
    "FlightRow",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "SloTracker",
    "Span",
    "TIER_NAMES",
    "Telemetry",
    "TraceBuffer",
    "chrome_trace_json",
    "json_snapshot",
    "prometheus_text",
]
