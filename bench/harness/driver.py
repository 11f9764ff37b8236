"""The system under test, built from a cell's files, warmed, and driven
on the wall clock.

``build`` brings up ``TokenPool`` → ``Gateway`` → ``InferenceEngine``
over the program's ``Transformer``, whose weights the architecture's
``draw_model`` (``harness.arch``) drew from the seed.  The pool's declared capacity comes from the traffic
file: the engine's lanes as its concurrency, the engine's page pool as
its KV bytes, a token rate, and the seconds of that rate a token bucket
holds.  A tenant with ``reserve_lanes`` holds
that share of all three as its baseline; a spot tenant holds none, and
its bucket starts funded at the pool's rate.

``drive`` runs the window: open-loop arrivals are submitted through
``InferenceEngine.submit`` (which calls ``Gateway.handle``) as soon as
they are due, closed-loop workers send again when their request
finished or their ``Retry-After`` passed, ``TokenPool.tick`` runs once a
wall second between steps, and ``InferenceEngine.step`` runs whenever
the engine holds work.  A token is seen when the step that produced it
returns.  After the window closes, nothing new is sent and the engine
keeps stepping until every admitted guaranteed request due in the window
has its first token (at most ``DRAIN_S`` more).  The driver also
records, for the reference, which request sat in which row of each
decode step.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from harness import traffic as traffic_lib
from harness.readings import GUARANTEED

#: the longest the engine keeps stepping after the window closes
DRAIN_S = 60.0
#: deny reasons that a guaranteed tenant within its reservation never
#: gets (it may run out of its own token budget)
GUARANTEE_BREACHES = ("concurrency_limit", "low_priority",
                      "entitlement_not_bound", "pool_unavailable")


def clock() -> float:
    return time.perf_counter()


@dataclasses.dataclass
class Rec:
    """One request as the harness saw it.  Times are seconds after the
    window opened."""
    rid: str
    tenant: int
    klass: str
    due: float
    prompt_len: int
    output_len: int
    ids: np.ndarray
    sent: Optional[float] = None
    admitted: bool = False
    reason: Optional[str] = None
    retry: Optional[float] = None
    #: admitted requests of its tenant in flight when it was sent
    tenant_in_flight: int = 0
    worker: Optional[object] = None
    req: Optional[object] = None
    prefill_start: Optional[float] = None
    token_times: list = dataclasses.field(default_factory=list)
    finished: Optional[float] = None


def pool_kv_bytes(cfg, serve: dict) -> float:
    """The engine's page pool in bytes (lanes × pages per lane × page)."""
    T = int(serve["page_tokens"])
    pages = int(serve["lanes"]) * (int(serve["max_seq"]) // T + 1)
    return float(pages * T * cfg.kv_bytes_per_token)


def build_pool(cfg, mix: dict, serve: dict, device):
    """The pool and gateway of a mix: (pool, gateway, api key of each
    tenant)."""
    from repro_torch.core import (EntitlementSpec, PoolSpec, QoS, Resources,
                                  ScalingBounds, ServiceClass, TokenPool)
    from repro_torch.gateway import Gateway
    lanes = int(serve["lanes"])
    kv = pool_kv_bytes(cfg, serve)
    tps = float(mix["pool"]["tokens_per_s"])
    spec = PoolSpec(name="bench", model=cfg.name,
                    scaling=ScalingBounds(1, 1),
                    per_replica=Resources(tps, kv, float(lanes)),
                    default_max_tokens=int(mix["lengths"]["output"]["max"]),
                    bucket_window_s=float(mix["pool"]["bucket_window_s"]))
    pool = TokenPool(spec, device=device)
    pool.set_replicas(1)
    keys = []
    for ten in mix["tenants"]:
        klass = ServiceClass(ten["class"])
        share = float(ten.get("reserve_lanes", 0)) / lanes
        pool.add_entitlement(EntitlementSpec(
            name=ten["name"], tenant_id=ten["name"], pool="bench",
            qos=QoS(klass, float(ten["slo_ms"])),
            baseline=Resources(tps * share, kv * share,
                               float(ten.get("reserve_lanes", 0)))))
        if klass is ServiceClass.SPOT:
            pool.ledger.set_rate(ten["name"], tps, 0.0)
            pool.ledger.bucket(ten["name"]).level = tps * spec.bucket_window_s
        keys.append(f"key-{ten['name']}")
    gw = Gateway(pool)
    for ten, key in zip(mix["tenants"], keys):
        gw.register_key(key, ten["name"])
    return pool, gw, keys


def build(cfg, weights: dict, mix: dict, serve: dict, device):
    """(engine, pool, keys) over the program's model with ``weights``."""
    from repro_torch.models import build_model
    from repro_torch.models.transformer import Transformer
    from repro_torch.serving import InferenceEngine
    model = build_model(cfg)
    params = Transformer(cfg, weights)
    pool, gw, keys = build_pool(cfg, mix, serve, device)
    engine = InferenceEngine(model, params, slots=int(serve["lanes"]),
                             max_seq=int(serve["max_seq"]), gateway=gw,
                             page_tokens=int(serve["page_tokens"]))
    return engine, pool, keys


def warm(engine, cfg, mix: dict, serve: dict, device) -> None:
    """Warm the cell's own shapes outside admission: one prompt per lane
    at lengths spread geometrically over the mix's prompt range, each
    asking one token more than the last, so that decode runs every batch
    size from all lanes down to one; then one tick and one admission on
    a pool of the same declaration, which is thrown away."""
    from repro_torch.serving import Request
    lanes = int(serve["lanes"])
    law = mix["lengths"]["prompt"]
    lens = np.unique(np.rint(np.geomspace(law["min"], law["max"], lanes))
                     ).astype(int)
    gw, engine.gateway = engine.gateway, None
    for i in range(lanes):
        n = int(lens[i % len(lens)])
        engine.submit(Request(f"warm-{i}", "warm",
                              [(7 * j + i) % cfg.vocab_size
                               for j in range(n)], i + 1, 0.0), 0.0)
    engine.run_until_drained()
    engine.finished.clear()
    engine.gateway = gw
    pool, spare, keys = build_pool(cfg, mix, serve, device)
    spare.handle(keys[0], "warm", input_tokens=int(law["min"]),
                 max_tokens=8, now=0.0,
                 kv_bytes_per_token=cfg.kv_bytes_per_token)
    pool.tick(1.0)


def requests(mix: dict, sched, seed: int, vocab: int) -> list[Rec]:
    """The open-loop requests of a schedule, their prompts drawn."""
    out = []
    for q in sched.open:
        ten = mix["tenants"][q.tenant]
        out.append(Rec(f"{ten['name']}-{q.index}", q.tenant, ten["class"],
                       q.due, q.prompt_len, q.output_len,
                       np.asarray(traffic_lib.prompt_ids(
                           seed, q.tenant, q.index, q.prompt_len, vocab))))
    return out


def worker_prompts(sched, seed: int, vocab: int) -> dict:
    """Each closed-loop worker's cycle of prompts."""
    return {(w.tenant, w.index): [
        np.asarray(traffic_lib.prompt_ids(
            seed, w.tenant, 1_000_000 + w.index * traffic_lib.CYCLE + j,
            int(p), vocab))
        for j, p in enumerate(w.prompt_lens)] for w in sched.workers}


class Run:
    """Everything one window recorded."""

    def __init__(self, engine, pool, mix: dict, keys: list, seconds: float,
                 tracer=None) -> None:
        self.engine = engine
        self.pool = pool
        self.mix = mix
        self.keys = keys
        self.seconds = seconds
        self.tracer = tracer
        self.recs: list[Rec] = []
        self.by_rid: dict[str, Rec] = {}
        self.live: dict[str, Rec] = {}
        #: per decode step: (start, end, rows as (rid, position))
        self.decodes: list[tuple] = []
        #: request ids in the order their prefills ran
        self.prefills: list[str] = []
        self.ticks = 0
        self.t0 = 0.0
        self.close = 0.0
        self.end = 0.0

    def now(self) -> float:
        return clock() - self.t0

    # -- submission -------------------------------------------------------
    def submit(self, rec: Rec, now: float) -> None:
        from repro_torch.serving import Request
        ten = self.mix["tenants"][rec.tenant]
        rec.tenant_in_flight = sum(1 for r in self.live.values()
                                   if r.tenant == rec.tenant)
        req = Request(request_id=rec.rid, entitlement=ten["name"],
                      prompt_tokens=rec.ids.tolist(),
                      max_tokens=rec.output_len, arrival_s=rec.due,
                      api_key=self.keys[rec.tenant])
        rec.sent = now
        rec.req = req
        rec.admitted = self.engine.submit(req, now)
        if rec.admitted:
            self.live[rec.rid] = rec
        else:
            rec.reason = req.deny_reason
            rec.retry = req.retry_after_s
        self.recs.append(rec)
        self.by_rid[rec.rid] = rec

    # -- one engine step ----------------------------------------------------
    def step(self) -> None:
        eng = self.engine
        before = {i: l.request.request_id for i, l in enumerate(eng.lanes)
                  if l.request is not None}
        seen = {rid: len(self.by_rid[rid].token_times)
                for rid in before.values()}
        t_s = self.now()
        eng.step(t_s)
        t_e = self.now()
        rows = dict(before)
        for i, lane in enumerate(eng.lanes):
            if lane.request is not None and i not in before:
                rid = lane.request.request_id
                rows[i] = rid
                self.prefills.append(rid)
                seen[rid] = 1
        started = [rid for i, rid in sorted(rows.items()) if i not in before]
        if rows:
            self.decodes.append((t_s, t_e, [
                (rows[i], self.by_rid[rows[i]].prompt_len + seen[rows[i]] - 1)
                for i in sorted(rows)]))
        if self.tracer is not None:
            self.tracer.step_done(
                self.t0 + t_s, self.t0 + t_e,
                [self.by_rid[rid].prompt_len for rid in started],
                [pos + 1 for _, pos in self.decodes[-1][2]] if rows else [])
        for rid in rows.values():
            rec = self.by_rid[rid]
            new = len(rec.req.output_tokens) - len(rec.token_times)
            rec.token_times += [t_e] * new
            if rec.req.state.value == "finished":
                rec.finished = t_e
                self.live.pop(rid, None)
                if rec.worker is not None:
                    rec.worker.ready = t_e

    # -- the window ---------------------------------------------------------
    def drive(self, opened: list[Rec], workers: list, prompts: dict,
              t0: float) -> None:
        """Run the window that opens at ``t0`` (a ``clock()`` reading)."""
        self.t0 = t0
        for w in workers:
            w.ready = w.start
        pending = list(opened)
        nxt = 0
        next_tick = 1.0
        eng = self.engine
        while True:
            now = self.now()
            if self.tracer is not None:
                self.tracer.boundary(now)
            if now < self.seconds:
                while nxt < len(pending) and pending[nxt].due <= now:
                    self.submit(pending[nxt], now)
                    nxt += 1
                for w in workers:
                    if w.ready is not None and w.ready <= now:
                        self.send_worker(w, prompts, now)
            elif not self.close:
                self.close = now
            if self.close and (not self.waiting_first()
                               or now >= self.seconds + DRAIN_S):
                break
            if now >= next_tick:
                self.tick(now)
                next_tick = max(next_tick + 1.0, np.floor(now) + 1.0)
            if eng.queue or self.live:
                self.step()
                continue
            if self.close:
                break
            wake = min([next_tick]
                       + ([pending[nxt].due] if nxt < len(pending) else [])
                       + [w.ready for w in workers if w.ready is not None])
            time.sleep(max(0.0, min(wake - self.now(), 0.002)))
        self.end = self.now()
        if self.tracer is not None:
            self.tracer.boundary(float("inf"))

    def send_worker(self, w, prompts: dict, now: float) -> None:
        ten = self.mix["tenants"][w.tenant]
        p, o = w.next_lengths()
        ids = prompts[(w.tenant, w.index)][w.sent % traffic_lib.CYCLE]
        rec = Rec(f"{ten['name']}-w{w.index}-{w.sent}", w.tenant,
                  ten["class"], now, p, o, ids, worker=w)
        w.sent += 1
        w.ready = None
        self.submit(rec, now)
        if not rec.admitted:
            w.ready = now + (rec.retry if rec.retry is not None else 1.0)

    def tick(self, now: float) -> None:
        t = clock()
        self.pool.tick(now)
        if self.tracer is not None:
            self.tracer.tick_done(t, clock())
        self.ticks += 1

    def waiting_first(self) -> bool:
        """An admitted guaranteed request due in the window still has no
        first token."""
        return any(r.klass in GUARANTEED and r.due < self.seconds
                   and not r.token_times for r in self.live.values())

    # -- what the reference needs --------------------------------------------
    def fed_tokens(self, rid: str) -> list[int]:
        """The tokens the program fed for a request: its prompt and each
        served token but the last."""
        rec = self.by_rid[rid]
        return rec.ids.tolist() + list(rec.req.output_tokens[:-1])
