"""The engine's spans and counters (``InferenceEngine(telemetry=)``) and
the trace buffer's spans, on the CPU.

A reduced qwen3-8b serves a seeded two-tenant workload through a
gateway, the way ``tests/test_torch_engine.py`` serves it; the traced
run is held to the span tree the engine's docstring draws, and the
untraced run to the same tokens with no telemetry work at all.
"""
import json

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.configs import get_config
from repro_torch.gateway import Gateway
from repro_torch.models import build_model
from repro_torch.serving import InferenceEngine, KVBlockManager, Request
from repro_torch.telemetry import Telemetry, TraceBuffer
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

SLOTS, MAX_TOKENS = 3, 10


@pytest.fixture(scope="module")
def model():
    cfg = get_config("qwen3-8b").reduced(dtype="float32", vocab_size=512,
                                         max_seq_len=64)
    m = build_model(cfg)
    return cfg, m, m.init(torch.Generator().manual_seed(0), "cpu")


def engine(model, telemetry=None, tps: float = 3000.0):
    cfg, m, params = model
    spec = T.PoolSpec(name="p", model=cfg.name,
                      scaling=T.ScalingBounds(1, 1),
                      per_replica=T.Resources(tps, float(1 << 30),
                                              float(SLOTS)),
                      default_max_tokens=MAX_TOKENS)
    pool = T.TokenPool(spec, device="cpu")
    pool.add_entitlement(T.EntitlementSpec(
        name="prod", tenant_id="prod", pool="p",
        qos=T.QoS(T.ServiceClass.GUARANTEED, 200.0),
        baseline=T.Resources(tps / 2, float(1 << 29), float(SLOTS))))
    gw = Gateway(pool)
    gw.register_key("k", "prod")
    return InferenceEngine(m, params, slots=SLOTS, max_seq=cfg.max_seq_len,
                           gateway=gw, telemetry=telemetry)


def serve(eng, seed: int = 0, n: int = 8):
    """Submit ``n`` requests over a few steps (more than the lanes, so
    some queue) and drain; returns the requests and the steps taken."""
    cfg = eng.model.cfg
    r = np.random.default_rng(seed)
    reqs, steps, now = [], 0, 0.0
    for i in range(n):
        req = Request(request_id=f"r{i}", entitlement="prod",
                      prompt_tokens=r.integers(
                          0, cfg.vocab_size, int(r.integers(3, 30))).tolist(),
                      max_tokens=int(r.integers(2, MAX_TOKENS + 1)),
                      arrival_s=now, api_key="k")
        reqs.append(req)
        eng.submit(req, now)
        if i % 3 == 2:
            eng.step(now)
            steps += 1
            now += 0.05
    while eng.queue or any(l.request for l in eng.lanes):
        eng.step(now)
        steps += 1
        now += 0.05
    return reqs, steps


@pytest.fixture(scope="module")
def traced(model):
    tel = Telemetry()
    eng = engine(model, tel)
    reqs, steps = serve(eng)
    return tel, eng, reqs, steps


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_one_step_span_a_step_with_its_children_inside(traced):
    tel, _, _, steps = traced
    spans = tel.trace.spans()
    assert len(by_name(spans, "engine.step")) == steps
    assert all(s.end is not None for s in spans)
    parent_of = {"engine.prefill": "engine.step",
                 "engine.decode": "engine.step",
                 "model.prefill": "engine.prefill",
                 "engine.first_token": "engine.prefill",
                 "engine.tables": "engine.decode",
                 "model.decode_step": "engine.decode",
                 "engine.sample": "engine.decode",
                 "engine.bookkeeping": "engine.decode"}
    for child, parent in parent_of.items():
        found = by_name(spans, child)
        assert found, child
        for s in found:
            p = spans[s.parent]
            assert p.name == parent
            assert p.start <= s.start <= s.end <= p.end
    decodes = by_name(spans, "engine.decode")
    assert len(by_name(spans, "model.decode_step")) == len(decodes)
    for name in ("engine.step", "engine.admit", "request.queued"):
        assert all(s.parent is None for s in by_name(spans, name))
    # the children of one decode run in the order the engine runs them
    for d in decodes:
        kids = [s.name for s in spans if s.parent == d.sid]
        assert kids == ["engine.tables", "model.decode_step",
                        "engine.sample", "engine.bookkeeping"]


def test_request_spans_share_the_request_id(traced):
    tel, eng, reqs, _ = traced
    spans = tel.trace.spans()
    prefills = by_name(spans, "engine.prefill")
    assert sorted(s.rid for s in prefills) == sorted(q.request_id
                                                     for q in reqs)
    for s in prefills:
        req = next(q for q in reqs if q.request_id == s.rid)
        assert s.args["prompt_tokens"] == req.input_len
        # on the CPU every prompt prefills eagerly, at its own length
        assert (s.args["graphed"], s.args["bucket"],
                s.args["padded_tokens"]) == (False, req.input_len, 0)
        kids = [k for k in spans if k.parent == s.sid]
        assert [k.name for k in kids] == ["model.prefill",
                                          "engine.first_token"]
        assert kids[1].rid == s.rid
    admits = {s.rid: s for s in by_name(spans, "engine.admit")}
    queued = {s.rid: s for s in by_name(spans, "request.queued")}
    starts = {s.rid: s.start for s in prefills}
    assert set(admits) == set(queued) == set(starts)
    for rid, q in queued.items():
        assert admits[rid].args["status"] == 200
        assert q.track == "queue"
        assert q.start == admits[rid].end
        assert q.end == starts[rid]
    # some requests waited for a lane
    assert max(q.end - q.start for q in queued.values()) > \
        min(q.end - q.start for q in queued.values())


def test_first_token_and_finished_instants(traced):
    tel, _, reqs, _ = traced
    spans = tel.trace.spans()
    events = tel.trace.events
    first = {e["args"]["rid"]: e["ts"] / 1e6 for e in events
             if e["name"] == "first_token"}
    finished = {e["args"]["rid"]: e["ts"] / 1e6 for e in events
                if e["name"] == "finished"}
    assert set(first) == set(finished) == {q.request_id for q in reqs}
    for s in by_name(spans, "model.prefill"):
        rid = spans[s.parent].rid
        assert first[rid] >= s.end
        assert finished[rid] > first[rid]


def test_counters_once_a_decode_step(traced):
    tel, eng, _, _ = traced
    decodes = by_name(tel.trace.spans(), "engine.decode")
    samples = tel.trace.counters()
    pool_bytes = (eng.kv_pages.total_pages * eng.kv_pages.page_tokens
                  * eng.kv_pages.bytes_per_token)
    for name in ("lanes_active", "queue_depth", "kv_used_bytes",
                 "kv_reserved_bytes", "decode_graph_replays",
                 "prefill_graph_replays"):
        mine = [(t, v[name]) for n, t, v in samples if n == name]
        assert len(mine) == len(decodes), name
        assert [t for t, _ in mine] == pytest.approx(
            [d.end for d in decodes], abs=1e-9)
    # on the CPU every step decodes eagerly: no graph, no replay
    assert eng.decode_graph is None
    assert all(d.args["graphed"] is False for d in decodes)
    assert eng.prefill_graph is None
    for name in ("decode_graph_replays", "prefill_graph_replays"):
        assert {v[name] for n, _, v in samples if n == name} == {0}
    lanes = [v["lanes_active"] for n, _, v in samples if n == "lanes_active"]
    assert lanes == [d.args["lanes"] for d in decodes]
    used = [v["kv_used_bytes"] for n, _, v in samples if n == "kv_used_bytes"]
    reserved = [v["kv_reserved_bytes"] for n, _, v in samples
                if n == "kv_reserved_bytes"]
    assert all(0 < u <= pool_bytes for u in used[:-1])
    assert all(r > 0 for r in reserved[:-1])
    # the last step finished every request: nothing held, nothing charged
    assert used[-1] == 0 and reserved[-1] == 0


def test_device_intervals_are_none_on_the_cpu(traced):
    tel, _, _, _ = traced
    assert tel.trace.device_clock is None
    assert all(s.device_start is None and s.device_end is None
               for s in tel.trace.spans())


def test_chrome_export_has_parent_and_rid(traced):
    tel, _, _, _ = traced
    doc = json.loads(tel.chrome_trace())
    spans = [e for e in doc["traceEvents"]
             if e["ph"] == "X" and "span" in e["args"]]
    assert len(spans) == len(tel.trace.spans())
    assert all("parent" in e["args"] and "rid" in e["args"] for e in spans)
    model = [e for e in spans if e["name"] == "model.prefill"]
    assert model and all(e["args"]["parent"] is not None for e in model)
    names = {e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert {"engine", "queue"} <= names and "device" not in names


def test_untraced_engine_records_nothing(model, traced, monkeypatch):
    """With ``telemetry=None`` the tokens are the traced run's, and no
    trace call is made, no CUDA event built, no clock read and no
    counter evaluated."""
    def refuse(*a, **k):
        raise AssertionError("telemetry work with telemetry=None")
    for name in ("begin", "end", "instant", "counter", "complete"):
        monkeypatch.setattr(TraceBuffer, name, refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(Telemetry, "clock", refuse)
    monkeypatch.setattr(KVBlockManager, "kv_bytes_in_use", refuse)
    monkeypatch.setattr(Gateway, "kv_reserved_bytes", refuse)
    eng = engine(model)
    assert eng.telemetry is None and eng.model is eng._plain_model
    reqs, steps = serve(eng)
    _, _, traced_reqs, traced_steps = traced
    assert steps == traced_steps
    assert [q.output_tokens for q in reqs] == \
        [q.output_tokens for q in traced_reqs]
    assert [(q.first_token_s, q.finished_s) for q in reqs] == \
        [(q.first_token_s, q.finished_s) for q in traced_reqs]


def test_model_spans_sit_inside_a_wrapper_set_afterwards(model):
    """A caller's wrapper around ``engine.model`` (a harness's
    synchronised span) brackets the program's ``model.*`` span."""
    import dataclasses
    eng = engine(model)
    eng.telemetry = Telemetry()
    outer = []

    def wrap(fn):
        def call(*a, **k):
            t0 = Telemetry.clock()
            out = fn(*a, **k)
            outer.append((t0, Telemetry.clock()))
            return out
        return call
    eng.model = dataclasses.replace(
        eng.model, prefill=wrap(eng.model.prefill),
        decode_step=wrap(eng.model.decode_step))
    serve(eng, seed=1, n=4)
    spans = [s for s in eng.telemetry.trace.spans()
             if s.name.startswith("model.")]
    assert len(spans) == len(outer)
    for s, (t0, t1) in zip(spans, outer):
        assert t0 <= s.start <= s.end <= t1
    eng.telemetry = None
    assert eng.model is eng._plain_model


def test_a_queued_request_evicted_closes_its_queue_span(model):
    eng = engine(model, Telemetry())
    reqs = [Request(f"q{i}", "prod", [1, 2, 3], 4, 0.0, api_key="k")
            for i in range(SLOTS + 1)]
    for q in reqs:
        eng.submit(q, 0.0)
    eng.step(0.0)
    assert eng.evict(reqs[-1].request_id, 0.1)
    queued = by_name(eng.telemetry.trace.spans(), "request.queued")
    last = next(s for s in queued if s.rid == reqs[-1].request_id)
    assert last.end is not None and last.args == {"evicted": True}
    assert not eng._queued


def test_a_refused_request_opens_no_queue_span(model):
    eng = engine(model, Telemetry(), tps=1.0)
    big = Request("big", "prod", list(range(40)), MAX_TOKENS, 0.0,
                  api_key="k")
    assert not eng.submit(big, 0.0)
    spans = eng.telemetry.trace.spans()
    assert [s.name for s in spans] == ["engine.admit"]
    assert spans[0].args["status"] == 429 and spans[0].rid == "big"


class FakeDeviceClock:
    """Events numbered as recorded; event k is read at 100 + k s."""

    def __init__(self):
        self.n = 0
        self.resolved = 0

    def mark(self):
        self.n += 1
        return self.n

    def resolve(self, events):
        self.resolved += 1
        return [100.0 + e for e in events]


def test_trace_buffer_spans_device_intervals_and_cap():
    tb = TraceBuffer(max_events=6)
    tb.device_clock = dev = FakeDeviceClock()
    a = tb.begin("outer", "t", 1.0, rid="r", args={"x": 1})
    b = tb.begin("inner", "t", 1.5, parent=a, device=True)
    c = tb.begin("open", "t", 1.6, device=True)
    tb.end(b, 2.0)
    tb.end(a, 3.0, {"y": 2})
    spans = tb.spans()
    assert [tuple(s) for s in spans] == [
        (0, "outer", "t", 1.0, 3.0, None, "r", None, None, {"x": 1, "y": 2}),
        (1, "inner", "t", 1.5, 2.0, 0, None, 101.0, 103.0, {}),
        (2, "open", "t", 1.6, None, None, None, None, None, {})]
    tb.spans()
    assert dev.resolved == 1             # read once
    assert c == 2
    tb.counter("kv", "t", 4.0, {"kv": 7})
    assert tb.counters() == [("kv", 4.0, {"kv": 7})]
    # spans count against the cap with the events; past it, dropped
    tb.instant("i", "t", 5.0)
    assert tb.begin("late", "t", 6.0) == -1 and tb.dropped == 1
    tb.end(-1, 7.0)
    doc = json.loads(__import__(
        "repro_torch.telemetry", fromlist=["chrome_trace_json"]
    ).chrome_trace_json(tb))
    device = [e for e in doc["traceEvents"]
              if e["ph"] == "X" and e["tid"] == tb.tid("device")]
    assert [(e["name"], e["ts"], e["dur"]) for e in device] == [
        ("inner", 101.0e6, 2.0e6)]
    assert all(e["name"] != "open" for e in doc["traceEvents"])


def test_device_clock_interpolates_between_its_anchors(monkeypatch):
    """A device timer 20 ppm slow against the host: events read back on
    the host clock to within a microsecond, where one anchor would be
    600 µs off after 30 s."""
    from repro_torch.telemetry.device import DeviceClock
    host = [10.0]

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing
            self.ms = None

        def record(self):
            self.ms = 5e3 + (host[0] - 10.0) * 1e3 * (1 - 20e-6)

        def elapsed_time(self, other):
            return other.ms - self.ms
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    dev = DeviceClock(lambda: host[0])
    marks = []
    for t in (20.0, 40.0):
        host[0] = t
        marks.append(dev.mark())
    host[0] = 50.0
    assert dev.resolve(marks) == pytest.approx([20.0, 40.0], abs=1e-6)
    assert dev.drift_s == pytest.approx(40.0 * 20e-6)
    assert dev.resolve([]) == []
