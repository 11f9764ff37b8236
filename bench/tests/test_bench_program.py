"""The readers of the program's own spans and counters
(``harness/program.py``): on synthetic records, on records without the
program's trace or with events dropped, the charging of device gaps to
program spans, the tracer's summary of a device trace, and tiny runs on
the CPU: traced, whose program spans agree with the harness's own
readings and whose host-side readers give numbers, and untraced, which
leaves the program's telemetry off."""
import types

import pytest

import bench_tiny_cells as tiny
from bench_tiny_cells import one_thread  # noqa: F401 (an autouse fixture)
from harness import arch, cell, driver, program, traffic
from harness.cell import reader
from harness.trace import Tracer

NAMES = ("decode_dispatch_ms", "decode_device_ms", "engine_host_ms",
         "dispatch_idle_share", "kv_used_share")
#: the readers that need the card (a device interval, a device trace)
DEVICE = ("decode_device_ms", "dispatch_idle_share")
SEED = 2**31 + 7


def span(sid, name, start, end, parent=None, rid=None, device=None,
         track="engine"):
    d0, d1 = device or (None, None)
    return [sid, name, track, start, end, parent, rid, d0, d1, {}]


def traced():
    """Two steps of one prefill and one decode each; the second decode's
    device interval 12 ms, the first's 8 ms; a request queued 0.1 s."""
    spans = [span(0, "request.queued", 0.9, 1.0, rid="a", track="queue")]
    counters = []
    for k, t in enumerate((1.0, 2.0)):
        b = len(spans)
        spans += [
            span(b, "engine.step", t, t + 0.1),
            span(b + 1, "engine.prefill", t, t + 0.03, b, "a"),
            span(b + 2, "model.prefill", t, t + 0.02, b + 1, None,
                 (t + 0.001, t + 0.025)),
            span(b + 3, "engine.decode", t + 0.03, t + 0.1, b),
            span(b + 4, "engine.tables", t + 0.03, t + 0.031, b + 3),
            span(b + 5, "model.decode_step", t + 0.031, t + 0.071, b + 3,
                 None, (t + 0.04, t + 0.048 + 0.004 * k)),
            span(b + 6, "engine.sample", t + 0.071, t + 0.098, b + 3),
            span(b + 7, "engine.bookkeeping", t + 0.098, t + 0.1, b + 3)]
        counters += [["kv_used_bytes", t + 0.1, {"kv_used_bytes": 30.0}],
                     ["kv_reserved_bytes", t + 0.1,
                      {"kv_reserved_bytes": 40.0 * k}]]
    return {"spans": spans, "counters": counters, "dropped": 0}


def records(prog=None, idle=None):
    return {"trace": {"window_s": 4.0, "busy_s": 2.0, "kernel_s": {},
                      "kernel_n": {}, "idle_by_phase": {},
                      "prefill_tokens": [], "decode_contexts": [],
                      **({"idle_by_span": idle} if idle is not None
                         else {})},
            **({"program": prog} if prog is not None else {})}


def test_readers_on_synthetic_records():
    rec = records(traced(), {"model.decode_step": 1.0, "model.prefill": 0.2,
                             "engine.sample": 0.5, "harness": 0.3})
    assert reader("decode_dispatch_ms")(rec) == pytest.approx(40.0)
    assert reader("decode_device_ms")(rec) == pytest.approx(10.0)
    assert reader("engine_host_ms")(rec) == pytest.approx(3.0)
    assert reader("dispatch_idle_share")(rec) == pytest.approx(30.0)
    # the first step had nothing charged and is skipped
    assert reader("kv_used_share")(rec) == pytest.approx(75.0)


@pytest.mark.parametrize("name", NAMES)
def test_no_program_trace_no_number(name):
    idle = {"model.decode_step": 1.0}
    dropped = dict(traced(), dropped=3)
    empty = {"spans": [], "counters": [], "dropped": 0}
    for rec in (records(idle=idle), records(dropped, idle),
                records(empty, idle)):
        assert reader(name)(rec) is None
    assert reader(name)(records(traced(), idle)) is not None


@pytest.mark.parametrize("name", NAMES)
def test_steady_name_reads_the_same(name):
    rec = records(traced(), {"model.prefill": 0.4})
    assert reader(f"{name}.steady")(rec) == reader(name)(rec)


def test_no_device_interval_no_device_number():
    prog = traced()
    for s in prog["spans"]:
        s[7] = s[8] = None
    assert reader("decode_device_ms")(records(prog)) is None
    assert reader("decode_dispatch_ms")(records(prog)) is not None


def test_a_gap_goes_to_the_innermost_program_span():
    prog = traced()
    gaps = [(1.05, 0.01),      # engine.tables' neighbour: model.decode_step
            (1.0305, 0.002),   # inside engine.tables
            (1.015, 0.003),    # model.prefill, inside engine.prefill
            (1.0995, 0.004),   # engine.bookkeeping
            (1.5, 0.2),        # between steps: the harness's phase
            (0.95, 0.1)]       # under request.queued alone: no engine span
    got = program.idle_by_span(gaps, prog, lambda t: f"harness@{t}")
    assert got == pytest.approx({
        "model.decode_step": 0.01, "engine.tables": 0.002,
        "model.prefill": 0.003, "engine.bookkeeping": 0.004,
        "harness@1.5": 0.2, "harness@0.95": 0.1})


class Kernel:
    """A device event as the profiler's results give it."""

    def __init__(self, t, d, name="k"):
        self.t, self.d, self.label = t, d, name

    def device_type(self):
        return types.SimpleNamespace(name="CUDA")

    def start_ns(self):
        return self.t * 1e9

    def duration_ns(self):
        return self.d * 1e9

    def name(self):
        return self.label


def test_summarise_charges_each_gap_to_phase_and_to_program_span():
    """Device gaps in a traced slice from 0.5 s to 2.5 s of host time,
    the device's clock 99.5 s ahead: each goes to the harness's phase
    open at its midpoint and to the innermost program span there (the
    phase where no engine span is open)."""
    tracer = Tracer(3.0, None)
    tracer.h0, tracer.h1 = 0.5, 2.5
    tracer.host["engine.step"] = [(1.0, 1.1), (2.0, 2.1)]
    tracer.host["model.prefill"] = [(1.0, 1.02)]
    tracer.host["model.decode_step"] = [(1.031, 1.071)]
    tracer.host["pool.tick"] = [(1.6, 1.8)]
    tracer.program = traced()
    off = 99.5
    events = [Kernel(0.5 + off, 1e-6, "marker"), Kernel(0.5 + off, 0.5),
              Kernel(1.05 + off, 0.01), Kernel(1.07 + off, 0.43),
              Kernel(1.9 + off, 0.1)]
    tracer.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    tr = tracer.summarise()
    assert tr.window_s == pytest.approx(2.0)
    assert tr.busy_s == pytest.approx(1.04)
    assert tr.idle_by_phase == pytest.approx({
        "engine.step": 0.05, "model.decode_step": 0.01, "pool.tick": 0.4,
        "harness": 0.5})
    assert tr.idle_by_span == pytest.approx({
        "engine.prefill": 0.05, "model.decode_step": 0.01,
        "pool.tick": 0.4, "harness": 0.5})
    tracer.program = None
    assert tracer.summarise().idle_by_span is None


class CpuTracer(Tracer):
    """The harness's tracer on the CPU: its spans and wrappers, no
    profiler (a no-op synchronise)."""

    def __init__(self, seconds, torch=None):
        fake = types.SimpleNamespace(
            cuda=types.SimpleNamespace(synchronize=lambda: None))
        super().__init__(seconds, fake)

    def prepare(self):
        pass

    def boundary(self, now):
        pass


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_a_tiny_traced_run_agrees_with_the_harness(name):
    res = tiny.resolved(name)
    conf, mix, seed, seconds = res["config"], res["traffic"], SEED, 2.0
    side = arch.load(conf).harness
    m, cfg, serve = side.dims(conf), side.arch_config(conf), conf["serve"]
    engine, pool, keys = driver.build(
        cfg, side.draw_model(m, seed, "cpu"), mix, serve, "cpu")
    driver.warm(engine, cfg, mix, serve, "cpu")
    sched = traffic.schedule(mix, seed, seconds)
    tracer = CpuTracer(seconds)
    run = driver.Run(engine, pool, mix, keys, seconds, tracer)
    assert engine.telemetry is None
    tracer.instrument(run)
    assert engine.telemetry is tracer.tel is not None
    run.drive(driver.requests(mix, sched, seed, cfg.vocab_size),
              sched.workers, driver.worker_prompts(sched, seed,
                                                   cfg.vocab_size),
              driver.clock())
    tracer.finish()
    rec = cell.records(run, m, serve, 0.0, tracer)
    assert rec["program"] is tracer.program is not None
    prog = program.complete(rec)
    steps = program.spans(prog, "model.decode_step")
    assert len(run.decodes) > 10
    assert len(steps) == len(run.decodes) == \
        len(rec["spans"]["model.decode_step"])
    # each program span inside the harness's synchronised span of its step
    for s, (t, _) in zip(steps, rec["spans"]["model.decode_step"]):
        assert s.end - s.start <= t
    queued = program.spans(prog, "request.queued")
    assert len(queued) == sum(r.prefill_start is not None for r in run.recs)
    mean_queued = 1e3 * sum(q.end - q.start for q in queued) / len(queued)
    assert mean_queued == pytest.approx(reader("queue_wait_ms")(rec), abs=1.0)
    assert reader("engine_host_ms")(rec) > 0
    # pages round a short request's KV up past its charge: no upper bound
    assert reader("kv_used_share")(rec) > 0


def serve(name, monkeypatch, trace):
    """``cell.serve`` of a tiny cell on the CPU (traced with the tracer
    above), with its records and its engine's telemetry as the window
    closed."""
    seen = {}
    records, drive = cell.records, driver.Run.drive

    def keep_records(*a, **k):
        seen["records"] = records(*a, **k)
        return seen["records"]

    def keep_telemetry(run, *a, **k):
        out = drive(run, *a, **k)
        seen["telemetry"] = run.engine.telemetry
        return out
    monkeypatch.setattr(cell, "records", keep_records)
    monkeypatch.setattr(driver.Run, "drive", keep_telemetry)
    monkeypatch.setattr("harness.trace.Tracer", CpuTracer)
    out = cell.serve(tiny.benchmark(), name, tiny.resolved(name), SEED, 2.0,
                     trace, "cpu", log=lambda s: None)
    return out, seen


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_a_tiny_traced_serve_reads_the_program(name, monkeypatch):
    """Through ``cell.serve``: the engine's telemetry on, the records
    carrying the program's, and the readers of the host's side giving a
    number, a plain name and its ``.steady`` twin alike, where those of
    the device's side give none on the CPU."""
    out, seen = serve(name, monkeypatch, True)
    assert seen["telemetry"] is not None
    prog = program.complete(seen["records"])
    assert prog is not None and program.spans(prog, "model.decode_step")
    got = out["metrics"]
    for base in NAMES:
        for metric in (base, f"{base}.steady"):
            if base in DEVICE:
                assert metric not in got
                assert reader(metric)(seen["records"]) is None
            else:
                assert got[metric]["value"] > 0


@pytest.mark.parametrize("name", sorted(tiny.CELLS))
def test_an_untraced_serve_leaves_the_telemetry_off(name, monkeypatch):
    """An untraced run, which gives the end-to-end metrics, runs the
    program with its telemetry off and has no program record."""
    out, seen = serve(name, monkeypatch, False)
    assert seen["telemetry"] is None
    assert seen["records"]["program"] is None
    assert all(reader(n)(seen["records"]) is None for n in NAMES)
    assert "setup_s" in out["metrics"]
