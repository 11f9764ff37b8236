"""The port's telemetry plane against the reference's, on the CPU.

``repro_torch.telemetry`` is the port's own copy of the numpy-only
``repro.telemetry``, wired into the port's gateway, pools and
simulators.  The same seeded traffic goes through both packages and
must leave:

- the same flight-recorder rows: ``explain(rid)`` on the scalar
  ``Gateway.handle`` path, the generic quantum leg-round path and the
  single-leg fast path, leg by leg and bit for bit (priority,
  threshold, bucket level, debt, burst), and the same summary as the
  gateway's response;
- the same counters, histograms and SLO values, and the same
  Prometheus text and ``snapshot()`` once the wall-clock durations
  (tick and quantum duration histograms) are masked;
- the same incident windows from the simulators.

No timing assertion: the overhead of telemetry is measured on the card
(``chip_smoke.py``), not gated on a shared CPU.
"""
import random
import re
from pathlib import Path

import numpy as np
import pytest

import repro.core as J
import repro.serving as JS
import repro_torch.core as T
import repro_torch.serving as TS
from repro.gateway import Gateway as JGateway, QuantumRequest as JQ
from repro.telemetry import FlightRecorder as JFlight
from repro.telemetry import MetricsRegistry as JRegistry
from repro.telemetry import Telemetry as JTelemetry
from repro.telemetry import flight as jfl
from repro_torch.gateway import Gateway as TGateway, QuantumRequest as TQ
from repro_torch.telemetry import FlightRecorder as TFlight
from repro_torch.telemetry import MetricsRegistry as TRegistry
from repro_torch.telemetry import Telemetry as TTelemetry
from repro_torch.telemetry import flight as tfl

PKG = {"jax": (J, JGateway, JQ), "port": (T, TGateway, TQ)}
ROOT = Path(__file__).resolve().parents[1]


# -- the recorder and the registry on their own ---------------------------------

def flight_ops(Flight, fl):
    """Scalar and batch writes, a wraparound and an oversize batch."""
    rng = np.random.RandomState(11)
    rec = Flight(capacity=16)
    rec.pool_id("p")
    total = 0
    for _ in range(10):
        m = int(rng.randint(0, 12))
        rids = [f"q{total + k}" for k in range(m)]
        rows = rng.randint(-1, 6, size=m)
        verd = rng.randint(0, 2, size=m).astype(np.int16)
        reas = rng.randint(0, 5, size=m).astype(np.int16)
        prio = rng.uniform(0, 5, size=m)
        rec.record_batch(rids, 1.5, 0, 0, rows, verd, reas, prio, 0.9,
                         3.0, 0.1, 0.2, 64.0)
        for k in range(min(m, 3)):
            rec.record(f"s{total + k}", 2.5, "p", 1, int(rows[k]),
                       fl.VERDICT_ADMIT, 0, float(prio[k]), 0.9, 3.0,
                       0.1, 0.2, 64.0)
        total += m
    rec.record_batch([f"big{k}" for k in range(40)], 3.0, -1,
                     np.arange(40), -1, np.zeros(40, np.int16),
                     np.zeros(40, np.int16), 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
    return rec


def test_flight_recorder_identical():
    a, b = flight_ops(JFlight, jfl), flight_ops(TFlight, tfl)
    assert a.head == b.head and len(a) == len(b)
    a._materialize(), b._materialize()
    for name in a.col:
        np.testing.assert_array_equal(a.col[name], b.col[name],
                                      err_msg=name)
    assert b.explain("big0") is None and b.explain("big39").legs[0].leg == 39
    assert [r.seq for r in b.recent(n=100)] == \
        [r.seq for r in a.recent(n=100)]
    for kw in (dict(verdict=tfl.VERDICT_ADMIT), dict(verdict=tfl.VERDICT_DENY),
               dict(pool="p"), dict(pool="x")):
        assert [r.seq for r in b.recent(n=100, **kw)] == \
            [r.seq for r in a.recent(n=100, **kw)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_identical(seed):
    """Histograms (batch and scalar recorders), counters and gauges:
    same series, same bucket counts and sums."""
    rng = np.random.RandomState(seed)
    vals = np.exp(rng.uniform(-9, 4, 500))
    sids = rng.randint(0, 4, 500)
    out = []
    for Reg in (JRegistry, TRegistry):
        reg = Reg()
        h = reg.histogram("h", labels=("s",), lo=1e-3, hi=1e3, buckets=24)
        c = reg.counter("c", labels=("s",))
        g = reg.gauge("g", labels=("s",))
        ids = np.array([h.series((f"s{i}",)) for i in range(4)])
        cids = np.array([c.series((f"s{i}",)) for i in range(4)])
        h.observe_rows(vals[:400], ids[sids[:400]])
        for v, s in zip(vals[400:], sids[400:]):
            h.observe(int(ids[s]), float(v))
        c.inc_rows(cids[sids], 2.0)
        g.set(g.series(("s0",)), 7.5)
        out.append((h.counts.copy(), h.sums.copy(), h.totals.copy(),
                    [h.quantile(int(i), q) for i in ids
                     for q in (0.5, 0.99)],
                    [c.read(int(i)) for i in cids],
                    g.read(g.series(("s0",)))))
    ref, port = out
    for x, y in zip(ref, port):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_slo_tracker_identical():
    lats = np.array([0.1, 0.2, 0.4, 2.0, 0.05, 9.0])
    tiers = np.array([1, 1, 1, 1, 3, 3])
    slos = np.array([0.5, 0.5, 0.5, 0.5, 30.0, 30.0])
    snaps = []
    for Tel in (JTelemetry, TTelemetry):
        tel = Tel()
        tel.slo.observe_rows(lats, tiers, slos)
        tel.slo.observe(0.3, 0, 0.2)
        snaps.append(tel.slo.snapshot())
    assert snaps[0] == snaps[1]
    assert snaps[1]["guaranteed"]["attainment"] == pytest.approx(0.75)


# -- explain(rid) on the three admission pipelines ------------------------------

def mkpool(core, name, tps=1000.0, slots=4.0):
    kw = {"device": "cpu"} if core is T else {}
    return core.TokenPool(core.PoolSpec(
        name=name, model="m", scaling=core.ScalingBounds(1, 1),
        per_replica=core.Resources(tps, float(1 << 30), slots),
        default_max_tokens=64, bucket_window_s=1.0), **kw)


def build_gateway(pkg: str, seed: int):
    """Three pools and six keys with prefix routes of 1–3 legs (the
    regime where the quantum paths replay the scalar interleaving)."""
    core, Gateway, _ = PKG[pkg]
    rng = random.Random(seed)
    mgr = core.PoolManager([
        mkpool(core, "a", tps=rng.choice([300.0, 600.0]),
               slots=rng.choice([2.0, 4.0])),
        mkpool(core, "b", tps=600.0, slots=4.0),
        mkpool(core, "c", tps=1000.0, slots=8.0)])
    classes = ["guaranteed", "elastic", "spot"]
    gw = Gateway(mgr, telemetry=True)
    for k in range(6):
        legs = []
        for pname in ["a", "b", "c"][:rng.randint(1, 3)]:
            ename = f"e{k}@{pname}"
            mgr.pool(pname).add_entitlement(core.EntitlementSpec(
                name=ename, tenant_id="t", pool=pname,
                qos=core.QoS(service_class=core.ServiceClass(
                    rng.choice(classes)), slo_target_ms=500.0),
                baseline=core.Resources(rng.choice([120.0, 400.0]), 0.0,
                                        rng.choice([1.0, 3.0]))))
            legs.append((pname, ename))
        gw.register_route(f"k{k}", legs)
    return gw, rng


def traffic(pkg: str, rng, n: int, prefix: str) -> list:
    Q = PKG[pkg][2]
    return [Q(api_key=(f"k{rng.randrange(6)}" if rng.random() > 0.1
                       else "unknown"),
              request_id=f"{prefix}{i}", input_tokens=rng.choice([16, 64]),
              max_tokens=rng.choice([None, 32])) for i in range(n)]


def drive(pkg: str, seed: int, path: str):
    """Three rounds of seeded traffic through one pipeline, with
    completions settled between rounds; returns the gateway and every
    (request, response) pair."""
    gw, rng = build_gateway(pkg, seed)
    gw.quantum_fast_enabled = path == "fast"
    pairs = []
    for rep in range(3):
        reqs = traffic(pkg, rng, 40, f"r{rep}-")
        if path == "scalar":
            resps = [gw.handle(q.api_key, q.request_id, q.input_tokens,
                               q.max_tokens, now=float(rep))
                     for q in reqs]
        else:
            resps = gw.handle_quantum(reqs, now=float(rep))
        pairs += list(zip(reqs, resps))
        gw.on_complete_batch([(r.request_id, 16, 0.05 * (1 + rep))
                              for r in resps if r.status == 200],
                             now=rep + 0.5)
        for pool in gw.manager.pools.values():
            pool.tick(rep + 0.75)
    return gw, pairs


def trace_record(tr) -> tuple:
    legs = tuple((r.t, r.pool, r.ent_slot, r.leg, r.verdict,
                  r.reason_code, np.float64(r.priority).tobytes(),
                  np.float64(r.threshold).tobytes(),
                  np.float64(r.bucket_level).tobytes(),
                  np.float64(r.debt).tobytes(),
                  np.float64(r.burst).tobytes(), r.tokens, r.seq)
                 for r in tr.legs)
    return (tr.status, tr.reason, tr.pool, tr.spill_hops, tr.priority,
            legs, tr.narrative())


CASES = [("fast", s) for s in (0, 1, 2, 3)] + \
    [("generic", s) for s in (4, 5)] + [("scalar", s) for s in (10, 11)]


@pytest.mark.parametrize("path,seed", CASES,
                         ids=[f"{p}-{s}" for p, s in CASES])
def test_explain_identical(path, seed):
    ref_gw, ref_pairs = drive("jax", seed, path)
    gw, pairs = drive("port", seed, path)
    assert [tuple(r) for _, r in pairs] == [tuple(r) for _, r in ref_pairs]
    for q, resp in pairs:
        tr = gw.telemetry.flight.explain(q.request_id)
        assert trace_record(tr) == trace_record(
            ref_gw.telemetry.flight.explain(q.request_id))
        # and the trace tells the response's story
        assert (tr.status, tr.reason) == (resp.status, resp.reason)
        if resp.status == 200:
            assert (tr.pool, tr.spill_hops) == (resp.pool, resp.spill_hops)
    denied = [r for _, r in pairs if r.status == 429]
    assert denied and any(r.status == 200 for _, r in pairs)
    assert len(gw.telemetry.flight) == len(ref_gw.telemetry.flight)


def unavailable(pkg: str) -> list:
    core, Gateway, Q = PKG[pkg]
    pool = mkpool(core, "a")
    gw = Gateway(pool, telemetry=True)
    pool.add_entitlement(core.EntitlementSpec(
        name="e", tenant_id="t", pool="a",
        qos=core.QoS(service_class=core.ServiceClass.GUARANTEED),
        baseline=core.Resources(500.0, 0.0, 4.0)))
    gw.register_route("k", [("ghost", "e@ghost")])
    resps = [gw.handle("k", "r1", 8, 8, now=0.0)] + list(
        gw.handle_quantum([Q("k", "r2", 8, 8), Q("k", "r3", 8, 8)],
                          now=0.0))
    return [(r._asdict(), trace_record(gw.telemetry.flight.explain(
        r.request_id))) for r in resps]


def test_pool_unavailable_terminal_identical():
    port = unavailable("port")
    assert port == unavailable("jax")
    assert all(r["status"] == 429 and r["reason"] == "pool_unavailable"
               for r, _ in port)


# -- metrics, SLO and exporters -------------------------------------------------

#: families whose values are wall-clock durations
DURATIONS = ("repro_pool_tick_duration_seconds",
             "repro_gateway_quantum_duration_seconds")


def masked_prometheus(tel) -> list:
    """The Prometheus text without the duration families' buckets and
    sums (their counts stay)."""
    out = []
    for line in tel.prometheus().splitlines():
        name = re.split(r"[{ ]", line)[0]
        if name.startswith(DURATIONS) and not name.endswith("_count"):
            continue
        out.append(line)
    return out


def masked_snapshot(tel) -> dict:
    snap = tel.snapshot()
    for name in DURATIONS:
        fam = snap["metrics"].get(name)
        if fam:
            for s in fam["series"].values():
                s["sum"] = s["p50"] = s["p99"] = None
    return snap


@pytest.mark.parametrize("path", ["fast", "generic", "scalar"])
def test_metrics_and_exporters_identical(path):
    ref_gw, _ = drive("jax", 7, path)
    gw, _ = drive("port", 7, path)
    assert masked_prometheus(gw.telemetry) == \
        masked_prometheus(ref_gw.telemetry)
    assert masked_snapshot(gw.telemetry) == masked_snapshot(ref_gw.telemetry)
    assert gw.telemetry.slo.snapshot() == ref_gw.telemetry.slo.snapshot()
    dec = gw.telemetry.snapshot()["metrics"][
        "repro_admission_decisions_total"]
    assert sum(dec["series"].values()) > 0
    names = {e["name"] for e in gw.telemetry.trace.events}
    assert {"control_tick"} <= names
    assert ("admit_quantum" in names) == (path != "scalar")


def routing_sim(core, serving, mode, **kw):
    sc, wl = core.ServiceClass, serving.Workload
    sim = serving.MultiPoolSimulator(
        workloads=[wl(name="prod-chat", service_class=sc.GUARANTEED,
                      slots=6, slo_ms=500.0, rate_rps=1.4,
                      pools=("east", "west")),
                   wl(name="batch-eval", service_class=sc.SPOT, slots=8,
                      slo_ms=30000.0, rate_rps=3.0, pools=("west", "east"),
                      max_retries=1)],
        sites=[serving.PoolSite("east", n_replicas=1, replica_slots=8,
                                replica_tps=120.0),
               serving.PoolSite("west", n_replicas=2, replica_slots=8,
                                replica_tps=120.0)],
        admission_mode=mode, telemetry=True, **kw)
    sim.at(20.0, "fail_replica", pool="east", idx=0)
    sim.at(40.0, "recover_replica", pool="east", idx=0)
    return sim


@pytest.mark.parametrize("mode", ["quantum", "scalar"])
def test_multi_pool_simulator_telemetry_identical(mode):
    ref = routing_sim(J, JS, mode)
    port = routing_sim(T, TS, mode, device="cpu")
    ref.run(60.0)
    port.run(60.0)
    assert port.telemetry is port.gateway.telemetry is not None
    windows = port.telemetry.incident_windows()
    assert windows == ref.telemetry.incident_windows()
    assert [w[0] for w in windows] == ["east/r0"]
    assert masked_prometheus(port.telemetry) == \
        masked_prometheus(ref.telemetry)
    rids = sorted(port.requests)
    for rid in rids[::7]:
        assert trace_record(port.telemetry.flight.explain(rid)) == \
            trace_record(ref.telemetry.flight.explain(rid))


def test_serving_simulator_telemetry_identical():
    """Experiment 1's overload (both guaranteed tenants and spot on one
    replica, 30 s), with telemetry, through both ``ServingSimulator``s."""
    def sim(core, serving, **kw):
        sc, wl = core.ServiceClass, serving.Workload
        rate = lambda slots: slots / (64.0 / (240.0 / 16.0))  # noqa: E731
        s = serving.ServingSimulator(
            [wl(name="guaranteed-a", service_class=sc.GUARANTEED, slots=6,
                slo_ms=200.0, rate_rps=rate(6)),
             wl(name="spot-b", service_class=sc.SPOT, slots=10,
                slo_ms=30000.0, rate_rps=rate(10)),
             wl(name="guaranteed-c", service_class=sc.GUARANTEED, slots=6,
                slo_ms=200.0, rate_rps=rate(6), start_s=10.0)],
            replica_slots=16, replica_tps=240.0, n_replicas=2,
            telemetry=True, **kw)
        s.at(12.0, "fail_replica", idx=1)
        s.at(20.0, "recover_replica", idx=1)
        return s

    ref, port = sim(J, JS), sim(T, TS, device="cpu")
    ref.run(30.0)
    port.run(30.0)
    windows = port.telemetry.incident_windows()
    assert windows == ref.telemetry.incident_windows()
    assert [w[0] for w in windows] == ["replica1"]
    assert masked_prometheus(port.telemetry) == \
        masked_prometheus(ref.telemetry)
    assert port.telemetry.slo.snapshot() == ref.telemetry.slo.snapshot()
    denied = [rid for rid, r in port.requests.items()
              if r.state.value == "denied"]
    assert denied
    for rid in denied[:20]:
        assert trace_record(port.telemetry.flight.explain(rid)) == \
            trace_record(ref.telemetry.flight.explain(rid))


def test_telemetry_off_records_nothing():
    gw, _ = build_gateway("port", 0)
    assert gw.telemetry is not None
    plain = TGateway(T.PoolManager([mkpool(T, "a")]))
    assert plain.telemetry is None
    assert all(p.telemetry is None for p in plain.manager.pools.values())
    shared = TTelemetry()
    g1 = TGateway(T.PoolManager([mkpool(T, "a")]), telemetry=shared)
    g2 = TGateway(T.PoolManager([mkpool(T, "b")]), telemetry=shared)
    assert g1.telemetry is g2.telemetry is shared


def test_port_hot_paths_record_in_batches():
    """The reference's ``telemetry-hot-path`` pass over the port's
    tree: no scalar recorder inside a ``@hot_path`` function."""
    from repro.analysis import analyze, default_manifest
    files = [str(p) for p in (ROOT / "src" / "repro_torch").rglob("*.py")]
    report = analyze(files, manifest=default_manifest(),
                     rules=["telemetry-hot-path"])
    assert report.unwaived == []
    assert any("telemetry" in f for f in files)
