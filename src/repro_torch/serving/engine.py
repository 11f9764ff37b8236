"""InferenceEngine: continuous batching over a real model, on a paged
KV cache.

Counterpart of ``repro/serving/engine.py`` with the same ``submit``,
``step``, ``evict`` and ``run_until_drained``, the same gateway calls
and the same page bookkeeping.  A fixed pool of ``slots`` lanes each
holds one sequence at its own position.  Prefill runs per request
(B=1) and writes the prompt's K/V into the pages the ``KVBlockManager``
allocated; each step then decodes one token for every active lane in
one batched call.  Iteration-level scheduling in the Orca/vLLM sense,
admission-gated by the token-pool gateway at the API boundary (the
paper's control point).

The KV lives in the page pools the block tables index — one
``(P, T, H_kv, dh)`` K pool and one V pool per layer — and the paged
decode kernel reads it there; prefill attends through the flash-prefill
kernel.  On CUDA both are the hand-written kernels, on the CPU their
plain versions (the device of the params decides).

Idle lanes (fault C9, in the reference).  The reference engine decodes
all ``slots`` lanes every step, idle ones included with their stale
token and position.  This engine takes one of two paths, chosen once
from what it is given (``decode_graph.graphable``):

* the graph path — parameters on CUDA, an unsharded runtime, the
  library's own ``prefill`` and ``decode_step`` and only attention
  layers with dense MLPs: every step replays a CUDA graph of the fewest
  rows (``decode_graph.row_counts``) that holds the active lanes
  (``decode_graph.DecodeGraph``, ``self.decode_graph``), the lanes in
  its first rows and the rest padded with token 0 at position 0 over a
  scratch page that the cache holds past the ``KVBlockManager``'s
  pages, their logits dropped.  Rows of such a model do not interact,
  so each active lane's logits are the active-lane decode's.  Every
  prompt's prefill replays a CUDA graph of the smallest length bucket
  (``prefill_graph.buckets``) that holds it
  (``prefill_graph.PrefillGraph``, ``self.prefill_graph``), padded at
  its end with token 0, the padded positions' K/V past the prompt in
  its last page or on the scratch page, the logits taken at its last
  real position; the attention is causal, so the real rows are the
  unpadded prefill's;
* the eager path — everything else: the active lanes only, in one
  batched call, and each prompt prefilled at its own length (padded
  positions would take a MoE layer's capacity and advance a recurrent
  state past the prompt).  For MoE the two paths' decodes differ: the
  expert capacity ``C = max(1, int(T·k/E·cf))`` depends on the token
  count T, and the dispatch's stable sort gives an expert's slots to
  the lower lanes first, so in the reference a finished request's
  stale lane takes expert capacity from the live lanes above it.
  Copying that would mean decoding stale lanes over a stale cache; the
  port keeps the active-lane decode, and equals the reference wherever
  every lane is active (``tests/test_torch_families.py`` shows both
  sides).

Recurrent layers (rglru, mlstm, slstm) keep their state per lane, in
row ``lane`` of the cache's state tensors: ``_start`` resets the row
before the prompt's prefill, as the reference prefills into a fresh
B=1 cache, and each decode step gathers and scatters the active lanes'
rows.  Those layers treat every lane on its own, so for them the
active-lane decode equals the reference's lane by lane, idle lanes or
not.

Encoder-decoder models are refused (fault C10, in the reference): the
reference engine calls prefill without the encoder's frames, so its
encoder gets none; whisper runs through the model's entry points.

Spans (``telemetry=``, a ``repro_torch.telemetry.Telemetry``; off by
default, and then nothing is recorded).  On the host clock
(``Telemetry.clock``), on the ``engine`` track::

    engine.step                 queue_depth, lanes_active
    ├── engine.prefill          rid, lane, prompt_tokens; at its end
    │   │                       graphed (the prefill replayed a prefill
    │   │                       graph), bucket and padded_tokens (bucket
    │   │                       − prompt_tokens; eager: the prompt, 0)
    │   ├── model.prefill       + the device interval
    │   └── engine.first_token  argmax + int(); instant first_token (rid)
    └── engine.decode           lanes, graphed (the step replayed the
                                decode graph)
        ├── engine.tables       block tables, token/position/lane tensors
        ├── model.decode_step   + the device interval
        ├── engine.sample       argmax + tolist()
        └── engine.bookkeeping  KV extend, finishes (instant finished),
                                Gateway.on_complete

``engine.admit`` (rid, the verdict) wraps the gateway call of
``submit``, and ``request.queued`` (rid, on the ``queue`` track) runs
from its end to the start of the request's ``engine.prefill``.  Each
decode step samples the counters ``lanes_active``, ``queue_depth``,
``kv_used_bytes`` (the pages held), ``kv_reserved_bytes`` (the KV the
gateway's pools charged at admission, summed over their live rows),
``decode_graph_replays`` and ``prefill_graph_replays`` (the decode and
prefill graphs' replays so far; 0 on the eager path).
The ``model.*`` spans are taken in a copy of the ``Model`` whose
``prefill`` and ``decode_step`` record them, swapped in when the
telemetry is set: they bracket only the call into the model, and sit
inside any wrapper a caller puts around ``engine.model`` afterwards.
On CUDA the telemetry's device clock is attached then too (one
synchronise), and the two model spans carry their device interval.
``Request.first_token_s`` stays the ``now`` of the step, as in the
reference; the ``first_token`` instant is the host time after the
prefill.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.gateway import Gateway
from repro_torch.models import Model, Runtime
from repro_torch.serving.decode_graph import DecodeGraph, graphable
from repro_torch.serving.kv_manager import KVBlockManager
from repro_torch.serving.prefill_graph import PrefillGraph
from repro_torch.serving.request import Request, RequestState

#: the tracks of the engine's spans
TRACK, QUEUE_TRACK = "engine", "queue"


@dataclasses.dataclass
class Lane:
    request: Optional[Request] = None
    position: int = 0              # next decode position
    remaining: int = 0
    last_token: int = 0


class InferenceEngine:
    def __init__(self, model: Model, params, slots: int, max_seq: int,
                 gateway: Optional[Gateway] = None,
                 rt: Runtime = Runtime(), page_tokens: int = 16,
                 eos_id: Optional[int] = None, telemetry=None) -> None:
        if model.cfg.is_encoder_decoder:
            raise ValueError(
                f"{model.cfg.name}: the engine serves decoder-only models; "
                "an encoder-decoder prefill needs the encoder's frames, "
                "which the engine, like the reference's, never passes "
                "(ROADMAP fault C10); call the model's prefill and "
                "decode_step with extra_embed=frames instead")
        self.params = params
        self.device = params.device
        self.slots = slots
        self.max_seq = max_seq
        self.gateway = gateway
        self.rt = rt
        self.eos_id = eos_id
        self.max_pages = max_seq // page_tokens + 1
        self.kv_pages = KVBlockManager(
            total_pages=slots * self.max_pages,
            page_tokens=page_tokens,
            bytes_per_token=model.cfg.kv_bytes_per_token)
        graphed = graphable(model, params, rt)
        # the graph path's idle lanes and padded prompt positions write
        # one scratch page past the manager's
        scratch = self.kv_pages.total_pages
        self.cache = model.init_cache(scratch + int(graphed), page_tokens,
                                      rt, self.device, lanes=slots)
        #: the decode and prefill graphs (None: the eager path)
        self.decode_graph = self.prefill_graph = None
        if graphed:
            self.decode_graph = DecodeGraph(
                params, self.cache, slots, self.max_pages, scratch)
            self.prefill_graph = PrefillGraph(
                params, self.cache, max_seq, page_tokens, self.max_pages,
                scratch)
            model = dataclasses.replace(model, prefill=self.prefill_graph,
                                        decode_step=self.decode_graph)
        self.model = self._plain_model = model
        self.lanes = [Lane() for _ in range(slots)]
        self.queue: list[Request] = []
        self.finished: list[Request] = []
        #: the open ``request.queued`` span of each queued request
        self._queued: dict[str, int] = {}
        #: the open ``engine.step`` span, and the span the ``model.*``
        #: spans nest under
        self._step: Optional[int] = None
        self._parent: Optional[int] = None
        self.telemetry = telemetry

    # -- telemetry -------------------------------------------------------------
    @property
    def telemetry(self):
        return self._telemetry

    @telemetry.setter
    def telemetry(self, telemetry) -> None:
        """Set (a ``Telemetry``) or clear (None) the engine's telemetry.
        Set it before wrapping ``self.model``'s entry points: setting it
        swaps in a traced copy of the model."""
        self._telemetry = telemetry
        self._trace = None if telemetry is None else telemetry.trace
        self.model = self._plain_model
        if self._trace is None:
            return
        if torch.device(self.device).type == "cuda":
            self._telemetry.attach_device()
        self.model = dataclasses.replace(
            self.model,
            prefill=self._traced("model.prefill", self.model.prefill),
            decode_step=self._traced("model.decode_step",
                                     self.model.decode_step))

    def _traced(self, name: str, fn):
        trace, clock = self._trace, self._telemetry.clock

        def call(*args, **kwargs):
            sid = trace.begin(name, TRACK, clock(), parent=self._parent,
                              device=True)
            out = fn(*args, **kwargs)
            trace.end(sid, clock())
            return out
        return call

    def _kv_reserved(self) -> float:
        """The KV bytes the gateway's pools charged at admission for the
        requests they hold (their ``kv_in_use`` over live rows)."""
        if self.gateway is None:
            return 0.0
        total = 0.0
        for pool in self.gateway.manager.pools.values():
            store = pool.store
            total += float(store.col["kv_in_use"][store.live_slots()].sum())
        return total

    @staticmethod
    def _replays(graph) -> int:
        return 0 if graph is None else graph.replays

    def _sample(self, t: float, active: int) -> None:
        trace = self._trace
        for name, value in (
                ("lanes_active", active), ("queue_depth", len(self.queue)),
                ("kv_used_bytes", self.kv_pages.kv_bytes_in_use()),
                ("kv_reserved_bytes", self._kv_reserved()),
                ("decode_graph_replays", self._replays(self.decode_graph)),
                ("prefill_graph_replays",
                 self._replays(self.prefill_graph))):
            trace.counter(name, TRACK, t, {name: value})

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request, now: float,
               api_key: Optional[str] = None) -> bool:
        """Admission-gated enqueue.  Returns False on 429/401."""
        trace = self._trace
        if self.gateway is not None:
            if trace is not None:
                clock = self._telemetry.clock
                span = trace.begin("engine.admit", TRACK, clock(),
                                   rid=req.request_id)
            resp = self.gateway.handle(
                api_key or req.api_key, req.request_id,
                input_tokens=req.input_len, max_tokens=req.max_tokens,
                now=now,
                kv_bytes_per_token=self.model.cfg.kv_bytes_per_token)
            if trace is not None:
                t = clock()
                trace.end(span, t, {"status": resp.status,
                                    "reason": resp.reason})
            if resp.status != 200:
                req.state = RequestState.DENIED
                req.deny_reason = resp.reason
                req.retry_after_s = resp.retry_after_s
                self.finished.append(req)
                return False
            req.priority = resp.priority
        req.admitted_s = now
        if trace is not None:
            self._queued[req.request_id] = trace.begin(
                "request.queued", QUEUE_TRACK,
                t if self.gateway is not None else self._telemetry.clock(),
                rid=req.request_id)
        self.queue.append(req)
        self.queue.sort(key=lambda r: (-r.priority, r.arrival_s))
        return True

    # -- scheduling ------------------------------------------------------------
    def _free_lanes(self) -> list[int]:
        return [i for i, l in enumerate(self.lanes) if l.request is None]

    def _tables(self, request_ids: list[str]) -> torch.Tensor:
        rows = np.stack([self.kv_pages.block_table(rid, self.max_pages)
                         for rid in request_ids])
        return torch.from_numpy(rows).to(self.device)

    def _start(self, lane_idx: int, req: Request, now: float) -> None:
        trace = self._trace
        if trace is not None:
            clock, rid = self._telemetry.clock, req.request_id
            t = clock()
            trace.end(self._queued.pop(rid, -1), t)
            span = self._parent = trace.begin(
                "engine.prefill", TRACK, t, parent=self._step, rid=rid,
                args={"lane": lane_idx, "prompt_tokens": req.input_len})
            replays = self._replays(self.prefill_graph)
        lane = self.lanes[lane_idx]
        self.kv_pages.allocate(req.request_id, req.input_len)
        tokens = torch.tensor([req.prompt_tokens], dtype=torch.long,
                              device=self.device)
        self.cache.reset(lane_idx)
        logits = self.model.prefill(
            self.params, tokens, self.cache, self._tables([req.request_id]),
            lanes=torch.tensor([lane_idx], device=self.device))
        if trace is not None:
            first_span = trace.begin("engine.first_token", TRACK, clock(),
                                     parent=span, rid=rid)
        first = int(torch.argmax(logits[0, -1]))
        if trace is not None:
            t = clock()
            trace.end(first_span, t)
            trace.instant("first_token", TRACK, t, {"rid": rid})
        req.first_token_s = now
        req.output_tokens.append(first)
        req.state = RequestState.DECODING
        lane.request = req
        lane.position = req.input_len
        lane.remaining = req.max_tokens - 1
        lane.last_token = first
        self.kv_pages.extend(req.request_id, req.input_len + 1)
        if trace is not None:
            graphed = self._replays(self.prefill_graph) > replays
            bucket = (self.prefill_graph.bucket_for(req.input_len)
                      if graphed else req.input_len)
            trace.end(span, clock(),
                      {"graphed": graphed, "bucket": bucket,
                       "padded_tokens": bucket - req.input_len})

    def step(self, now: float) -> int:
        """One engine iteration: admit-from-queue → batched decode.
        Returns the number of tokens produced."""
        trace = self._trace
        free = self._free_lanes()
        if trace is not None:
            clock = self._telemetry.clock
            step_span = self._step = trace.begin(
                "engine.step", TRACK, clock(),
                args={"queue_depth": len(self.queue),
                      "lanes_active": self.slots - len(free)})
        for lane_idx in free:
            if not self.queue:
                break
            req = self.queue.pop(0)
            self._start(lane_idx, req, now)

        active = [i for i, l in enumerate(self.lanes)
                  if l.request is not None]
        if not active:
            if trace is not None:
                trace.end(step_span, clock())
            return 0
        if trace is not None:
            decode_span = self._parent = trace.begin(
                "engine.decode", TRACK, clock(), parent=step_span,
                args={"lanes": len(active)})
            replays = self._replays(self.decode_graph)
            span = trace.begin("engine.tables", TRACK, clock(),
                               parent=decode_span)
        lanes = [self.lanes[i] for i in active]
        tokens = torch.tensor([[l.last_token] for l in lanes],
                              dtype=torch.long, device=self.device)
        positions = torch.tensor([l.position for l in lanes],
                                 dtype=torch.int32, device=self.device)
        tables = self._tables([l.request.request_id for l in lanes])
        lane_ids = torch.tensor(active, device=self.device)
        if trace is not None:
            trace.end(span, clock())
        logits = self.model.decode_step(
            self.params, tokens, self.cache, tables, positions,
            lanes=lane_ids)
        if trace is not None:
            span = trace.begin("engine.sample", TRACK, clock(),
                               parent=decode_span)
        nxt = torch.argmax(logits[:, 0, :], dim=-1).tolist()
        if trace is not None:
            t = clock()
            trace.end(span, t)
            span = trace.begin("engine.bookkeeping", TRACK, t,
                               parent=decode_span)
        produced = 0
        for lane, tok in zip(lanes, nxt):
            req = lane.request
            req.output_tokens.append(tok)
            produced += 1
            lane.position += 1
            lane.remaining -= 1
            lane.last_token = tok
            self.kv_pages.extend(req.request_id, lane.position + 1)
            done = (lane.remaining <= 0
                    or (self.eos_id is not None and tok == self.eos_id)
                    or lane.position + 1 >= self.max_seq)
            if done:
                req.state = RequestState.FINISHED
                req.finished_s = now
                self.finished.append(req)
                self.kv_pages.free(req.request_id)
                if self.gateway is not None:
                    self.gateway.on_complete(
                        req.request_id, len(req.output_tokens),
                        latency_s=now - req.arrival_s, now=now)
                if trace is not None:
                    trace.instant("finished", TRACK, clock(),
                                  {"rid": req.request_id})
                lane.request = None
                lane.remaining = 0
        if trace is not None:
            t = clock()
            trace.end(span, t)
            trace.end(decode_span, t,
                      {"graphed": self._replays(self.decode_graph)
                       > replays})
            self._sample(t, len(active))
            trace.end(step_span, t)
        return produced

    def evict(self, request_id: str, now: float) -> bool:
        """Mid-stream eviction (preemption / client disconnect): free
        the lane and its KV pages, cancel the admission charge through
        the gateway failure path.  Queued-but-unstarted requests are
        evicted too (no KV to reclaim).  Returns False for unknown or
        already-terminal ids — nothing is freed twice."""
        for lane in self.lanes:
            if lane.request is not None \
                    and lane.request.request_id == request_id:
                req = lane.request
                req.state = RequestState.EVICTED
                req.finished_s = now
                self.finished.append(req)
                self.kv_pages.free(request_id)
                if self.gateway is not None:
                    self.gateway.on_failure(request_id, now)
                lane.request = None
                lane.remaining = 0
                return True
        for i, req in enumerate(self.queue):
            if req.request_id == request_id:
                if self._trace is not None:
                    self._trace.end(self._queued.pop(request_id, -1),
                                    self._telemetry.clock(),
                                    {"evicted": True})
                req.state = RequestState.EVICTED
                req.finished_s = now
                self.finished.append(self.queue.pop(i))
                if self.gateway is not None:
                    self.gateway.on_failure(request_id, now)
                return True
        return False

    def run_until_drained(self, now: float = 0.0,
                          time_per_step: float = 0.05,
                          max_steps: int = 10_000) -> float:
        """Drive steps until queue+lanes empty; returns final time."""
        steps = 0
        while (self.queue or any(l.request for l in self.lanes)) \
                and steps < max_steps:
            self.step(now)
            now += time_per_step
            steps += 1
        return now
