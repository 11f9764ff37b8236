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
default, and then nothing is recorded).  The engine records through
one recorder (``_Spans``; without telemetry the inert ``_NoSpans``,
which reads no clock and evaluates no counter), and a span's parent is
the span open around it in the code.  On the host clock
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
from its end to the start of the request's ``engine.prefill``.
``engine.bookkeeping`` starts where ``engine.sample`` ends, and
``engine.decode`` and ``engine.step`` end with it.  At that end each
decode step samples the counters ``lanes_active``, ``queue_depth``,
``kv_used_bytes`` (the pages held), ``kv_reserved_bytes`` (the KV the
gateway's pools charged at admission for live requests,
``Gateway.kv_reserved_bytes``), ``decode_graph_replays`` and
``prefill_graph_replays`` (the decode and prefill graphs' replays so
far; 0 on the eager path).
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
import types
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


def _replays(graph) -> int:
    return 0 if graph is None else graph.replays


class _Span:
    """An open span of :class:`_Spans`, closed when its ``with`` block
    is left, or before by :meth:`close`; ``end`` is its end time once
    closed."""
    __slots__ = ("spans", "sid", "end")

    def __init__(self, spans: "_Spans", sid: int) -> None:
        self.spans, self.sid, self.end = spans, sid, None

    def close(self, end: Optional[float] = None, **args) -> None:
        """End the span now, or at ``end``, adding ``args`` to its own."""
        if self.end is None:
            self.end = self.spans.clock() if end is None else end
            self.spans.trace.end(self.sid, self.end, args)

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
        self.spans.open.pop()


class _Spans:
    """The engine's spans and counters, on a ``Telemetry``'s trace and
    clock (the module docstring draws the tree)."""

    def __init__(self, telemetry, engine: "InferenceEngine") -> None:
        self.trace, self.clock = telemetry.trace, telemetry.clock
        self.engine = engine
        #: the spans open, innermost last
        self.open: list[_Span] = []
        #: the open ``request.queued`` span of each queued request
        self.queued: dict[str, int] = {}

    def span(self, name: str, rid: Optional[str] = None,
             start: Optional[float] = None, device: bool = False,
             **args) -> _Span:
        """Open ``name`` inside the innermost open span, now or at
        ``start``; with ``device`` it carries its device interval."""
        parent = self.open[-1].sid if self.open else None
        sid = self.trace.begin(
            name, TRACK, self.clock() if start is None else start,
            parent=parent, rid=rid, args=args or None, device=device)
        self.open.append(_Span(self, sid))
        return self.open[-1]

    def instant(self, name: str, rid: str,
                at: Optional[float] = None) -> None:
        self.trace.instant(name, TRACK, self.clock() if at is None else at,
                           {"rid": rid})

    def queue(self, rid: str, start: Optional[float] = None) -> None:
        """Open ``rid``'s ``request.queued`` span, now or at ``start``."""
        self.queued[rid] = self.trace.begin(
            "request.queued", QUEUE_TRACK,
            self.clock() if start is None else start, rid=rid)

    def dequeue(self, rid: str, **args) -> float:
        """Close ``rid``'s ``request.queued`` span now; returns when."""
        t = self.clock()
        self.trace.end(self.queued.pop(rid, -1), t, args)
        return t

    def sample(self, active: int, at: float) -> None:
        """The decode step's counters, at ``at``."""
        eng = self.engine
        gw = eng.gateway
        for name, value in (
                ("lanes_active", active), ("queue_depth", len(eng.queue)),
                ("kv_used_bytes", eng.kv_pages.kv_bytes_in_use()),
                ("kv_reserved_bytes",
                 0.0 if gw is None else gw.kv_reserved_bytes()),
                ("decode_graph_replays", _replays(eng.decode_graph)),
                ("prefill_graph_replays", _replays(eng.prefill_graph))):
            self.trace.counter(name, TRACK, at, {name: value})

    def traced(self, model: Model) -> Model:
        """A copy of ``model`` whose ``prefill`` and ``decode_step``
        each record a ``model.*`` span with its device interval."""
        def wrap(name, fn):
            def call(*args, **kwargs):
                with self.span(name, device=True):
                    return fn(*args, **kwargs)
            return call
        return dataclasses.replace(
            model, prefill=wrap("model.prefill", model.prefill),
            decode_step=wrap("model.decode_step", model.decode_step))


class _NoSpans:
    """The recorder of an engine without telemetry, and the one span it
    hands out: it records nothing, reads no clock and evaluates no
    counter."""
    queued = types.MappingProxyType({})
    end = None

    def span(self, *args, **kwargs) -> "_NoSpans":
        return self

    def close(self, *args, **kwargs) -> None:
        pass

    instant = queue = dequeue = sample = close

    def traced(self, model: Model) -> Model:
        return model

    def __enter__(self) -> "_NoSpans":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NO_SPANS = _NoSpans()


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
        self._spans = _NO_SPANS
        if telemetry is not None:
            self._spans = _Spans(telemetry, self)
            if torch.device(self.device).type == "cuda":
                telemetry.attach_device()
        self.model = self._spans.traced(self._plain_model)

    @property
    def _queued(self):
        """The open ``request.queued`` span of each queued request."""
        return self._spans.queued

    # -- submission ----------------------------------------------------------
    def submit(self, req: Request, now: float,
               api_key: Optional[str] = None) -> bool:
        """Admission-gated enqueue.  Returns False on 429/401."""
        admitted_at = None      # request.queued opens where admission ends
        if self.gateway is not None:
            with self._spans.span("engine.admit",
                                  rid=req.request_id) as admit:
                resp = self.gateway.handle(
                    api_key or req.api_key, req.request_id,
                    input_tokens=req.input_len, max_tokens=req.max_tokens,
                    now=now,
                    kv_bytes_per_token=self.model.cfg.kv_bytes_per_token)
                admit.close(status=resp.status, reason=resp.reason)
            if resp.status != 200:
                req.state = RequestState.DENIED
                req.deny_reason = resp.reason
                req.retry_after_s = resp.retry_after_s
                self.finished.append(req)
                return False
            req.priority = resp.priority
            admitted_at = admit.end
        req.admitted_s = now
        self._spans.queue(req.request_id, start=admitted_at)
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
        spans, rid = self._spans, req.request_id
        with spans.span("engine.prefill", rid=rid, start=spans.dequeue(rid),
                        lane=lane_idx, prompt_tokens=req.input_len) as prefill:
            replays = _replays(self.prefill_graph)
            self.kv_pages.allocate(rid, req.input_len)
            tokens = torch.tensor([req.prompt_tokens], dtype=torch.long,
                                  device=self.device)
            self.cache.reset(lane_idx)
            logits = self.model.prefill(
                self.params, tokens, self.cache, self._tables([rid]),
                lanes=torch.tensor([lane_idx], device=self.device))
            with spans.span("engine.first_token", rid=rid) as first_span:
                first = int(torch.argmax(logits[0, -1]))
            spans.instant("first_token", rid, at=first_span.end)
            req.first_token_s = now
            req.output_tokens.append(first)
            req.state = RequestState.DECODING
            lane = self.lanes[lane_idx]
            lane.request = req
            lane.position = req.input_len
            lane.remaining = req.max_tokens - 1
            lane.last_token = first
            self.kv_pages.extend(rid, req.input_len + 1)
            graphed = _replays(self.prefill_graph) > replays
            bucket = (self.prefill_graph.bucket_for(req.input_len)
                      if graphed else req.input_len)
            prefill.close(graphed=graphed, bucket=bucket,
                          padded_tokens=bucket - req.input_len)

    def step(self, now: float) -> int:
        """One engine iteration: admit-from-queue → batched decode.
        Returns the number of tokens produced."""
        spans = self._spans
        free = self._free_lanes()
        with spans.span("engine.step", queue_depth=len(self.queue),
                        lanes_active=self.slots - len(free)) as step:
            for lane_idx in free:
                if not self.queue:
                    break
                req = self.queue.pop(0)
                self._start(lane_idx, req, now)
            active = [i for i, l in enumerate(self.lanes)
                      if l.request is not None]
            if not active:
                return 0
            with spans.span("engine.decode", lanes=len(active)) as decode:
                replays = _replays(self.decode_graph)
                with spans.span("engine.tables"):
                    lanes = [self.lanes[i] for i in active]
                    tokens = torch.tensor([[l.last_token] for l in lanes],
                                          dtype=torch.long,
                                          device=self.device)
                    positions = torch.tensor([l.position for l in lanes],
                                             dtype=torch.int32,
                                             device=self.device)
                    tables = self._tables([l.request.request_id
                                           for l in lanes])
                    lane_ids = torch.tensor(active, device=self.device)
                logits = self.model.decode_step(
                    self.params, tokens, self.cache, tables, positions,
                    lanes=lane_ids)
                with spans.span("engine.sample") as sample:
                    nxt = torch.argmax(logits[:, 0, :], dim=-1).tolist()
                with spans.span("engine.bookkeeping",
                                start=sample.end) as book:
                    for lane, tok in zip(lanes, nxt):
                        self._advance(lane, tok, now)
                decode.close(book.end,
                             graphed=_replays(self.decode_graph) > replays)
            spans.sample(len(active), at=book.end)
            step.close(book.end)
        return len(nxt)

    def _advance(self, lane: Lane, tok: int, now: float) -> None:
        """A lane's decoded token in; its request finished when done."""
        req = lane.request
        req.output_tokens.append(tok)
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
            self._spans.instant("finished", req.request_id)
            lane.request = None
            lane.remaining = 0

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
                self._spans.dequeue(request_id, evicted=True)
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
