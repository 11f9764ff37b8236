"""AI Gateway: the admission boundary (paper Fig. 1, LiteLLM role).

Counterpart of ``repro/gateway/gateway.py``.
Responsibilities (paper §4.3):
  - resolve the inference key to its route (auth): an ordered list of
    (pool, entitlement) legs — one leg is the classic single-pool
    deployment, several legs give dual-pool-style spill-over routing;
  - run the admission pipeline BEFORE the request reaches a backend,
    walking the route until a pool admits (spill-over) or every leg
    has denied;
  - on rejection return 429 + Retry-After (the most optimistic hint
    across the legs that were actually tried);
  - on completion, post actual token consumption back to the auth
    service (the callback that closes admission ↔ execution
    accounting), attributed to whichever pool admitted the request.

Two request paths share these semantics:

- :meth:`Gateway.handle` — one request through the scalar §4.3
  pipeline (``AdmissionController.decide``); the per-request fallback
  and the parity oracle for the batched path;
- :meth:`Gateway.handle_quantum` — the DEFAULT path at scale: all
  requests of one scheduling quantum are grouped per (pool, leg), each
  pool is snapshotted once, and ONE ``admit_quantum`` call replays the
  §4.3 pipeline for the whole group (the hand-written CUDA kernel on a
  pool on the card, its plain version on a CPU pool); denials spill
  into the next leg's batch, so routes keep their ``route_order``
  semantics.  Requests are padded per call as the reference pads them.

:meth:`Gateway.plan_quantum` runs one fleet planning round
(``PoolManager.plan_quantum``) and surfaces it in the stats store.
``Gateway(telemetry=True)`` records every decision into the telemetry
plane (``repro_torch.telemetry``): one batch of rows per dispatch on
the quantum paths, the pool's bucket levels copied to the host once per
dispatch; with telemetry off (the default) none of this runs.

State lives in the StateStore (Redis contract): key → route mapping and
per-entitlement counters, so a real deployment can point this class at
an actual Redis.
"""
from __future__ import annotations

import dataclasses
import json
import time
from itertools import chain
from operator import attrgetter
from typing import NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import (
    AdmissionController,
    AdmissionRequest,
    DenyReason,
    RouteEntry,
    StateStore,
    TokenPool,
)
from repro_torch.core import shard_plane
from repro_torch.core.control_plane import (
    bucket_width,
    pad_rows,
    pad_state,
    quantum_width,
)
from repro_torch.core.markers import hot_path
from repro_torch.core.pool_manager import (
    SPILL_POLICIES,
    PoolOrManager,
    as_manager,
)
from repro_torch.core.vectorized import admit_quantum, quantum_snapshot
from repro_torch.telemetry import flight as flightrec

#: C-speed attribute extractors for the quantum fast path.
_Q_RID = attrgetter("request_id")
_Q_KV = attrgetter("kv_bytes_per_token")

#: ``admit_quantum`` deny-reason codes → gateway deny reasons.
_REASON_CODES = {
    1: DenyReason.NOT_BOUND,
    2: DenyReason.CONCURRENCY,
    3: DenyReason.TOKEN_BUDGET,
    4: DenyReason.LOW_PRIORITY,
}


class GatewayResponse(NamedTuple):
    """Immutable per-request verdict.  A NamedTuple, not a dataclass:
    the quantum path constructs one per request, and tuple construction
    is cheaper than a frozen dataclass's ``object.__setattr__`` per
    field."""

    status: int                      # 200 admitted / 401 / 429
    request_id: str
    retry_after_s: Optional[float] = None
    reason: Optional[str] = None
    priority: float = 0.0
    #: pool + entitlement that admitted the request (multi-pool routing)
    pool: Optional[str] = None
    entitlement: Optional[str] = None
    #: position of the admitting leg in the client's declared route
    #: (0 = preferred pool; >0 = request spilled past denied or
    #: unavailable higher-preference legs)
    spill_hops: int = 0


@dataclasses.dataclass(frozen=True)
class QuantumRequest:
    """One request of a scheduling quantum (``Gateway.handle_quantum``)."""

    api_key: str
    request_id: str
    input_tokens: int
    max_tokens: Optional[int] = None     # None → each leg's pool default
    kv_bytes_per_token: float = 0.0


@dataclasses.dataclass(slots=True)
class _Pending:
    """Per-request routing state while a quantum is in flight."""

    idx: int                             # position in the input quantum
    req: QuantumRequest
    legs: list[tuple[int, RouteEntry]]   # (declared position, leg)
    leg_ptr: int = 0
    first_reason: Optional[DenyReason] = None
    first_priority: float = 0.0
    best_retry: Optional[float] = None

    def current(self) -> tuple[int, RouteEntry]:
        return self.legs[self.leg_ptr]

    def note_denial(self, reason: Optional[DenyReason], priority: float,
                    retry: Optional[float]) -> None:
        if self.first_reason is None:
            self.first_reason = reason
            self.first_priority = priority
        if retry is not None:
            self.best_retry = (retry if self.best_retry is None
                               else min(self.best_retry, retry))


class Gateway:
    def __init__(self, pools: PoolOrManager,
                 store: Optional[StateStore] = None,
                 spill_policy: str = "static",
                 telemetry=None) -> None:
        if spill_policy not in SPILL_POLICIES:
            raise ValueError(f"unknown spill policy {spill_policy!r}; "
                             f"expected one of {SPILL_POLICIES}")
        self.manager = as_manager(pools)
        self.store = store or StateStore()
        self.spill_policy = spill_policy
        self.controllers: dict[str, AdmissionController] = {
            name: AdmissionController(pool)
            for name, pool in self.manager.pools.items()}
        # ``telemetry=True`` builds a fresh
        # ``repro_torch.telemetry.Telemetry``; passing an instance shares
        # one plane across gateways.  Off by default, and then the
        # quantum path does no telemetry work at all.
        if telemetry is True:
            from repro_torch.telemetry import Telemetry
            telemetry = Telemetry()
        self.telemetry = telemetry or None
        if self.telemetry is not None:
            for pool in self.manager.pools.values():
                self.telemetry.attach_pool(pool)
        #: public knob: False forces ``handle_quantum`` through the
        #: generic leg-round loop even when the single-leg fast path
        #: would apply — the chaos differential-replay harness runs the
        #: same seeded scenario with this on/off (and against the
        #: scalar ``handle``) to pin all three decision traces equal
        self.quantum_fast_enabled: bool = True

    # -- back-compat accessors -------------------------------------------------
    @property
    def pool(self) -> TokenPool:
        """The default (first) pool — single-pool callers' view."""
        return self.manager.default_pool()

    @property
    def controller(self) -> AdmissionController:
        return self.controllers[self.pool.spec.name]

    def _controller(self, pool_name: str) -> AdmissionController:
        ctrl = self.controllers.get(pool_name)
        if ctrl is None:
            ctrl = AdmissionController(self.manager.pool(pool_name))
            self.controllers[pool_name] = ctrl
        return ctrl

    # -- key management ---------------------------------------------------------
    def register_key(self, api_key: str, entitlement: str,
                     pool: Optional[str] = None) -> None:
        """Single-leg route (legacy API): key → entitlement on one pool.

        When ``pool`` is omitted the entitlement's OWNING pool is
        looked up, and a miss is an error — silently defaulting to the
        first pool would leave the key permanently 429-ing NOT_BOUND
        on a multi-pool gateway."""
        if pool is None:
            owners = [name for name, p in self.manager.pools.items()
                      if entitlement in p.entitlements]
            if not owners:
                raise ValueError(
                    f"entitlement {entitlement!r} exists in no pool; "
                    "add it before registering a key")
            if len(owners) > 1:
                raise ValueError(
                    f"entitlement {entitlement!r} exists in pools "
                    f"{owners}; pass pool= (or use register_route for "
                    "a multi-pool route)")
            pool = owners[0]
        self.register_route(api_key, [RouteEntry(pool, entitlement)])

    def register_route(self, api_key: str,
                       entries: Sequence[Union[RouteEntry,
                                               tuple[str, str]]]) -> None:
        """Ordered multi-pool route: first leg is the preferred pool,
        later legs are spill-over targets.

        Stored in the StateStore as a JSON string — the store keeps the
        Redis contract (string values), so a real Redis can be swapped
        in behind it."""
        route = tuple(e if isinstance(e, RouteEntry) else RouteEntry(*e)
                      for e in entries)
        if not route:
            raise ValueError("route must have at least one leg")
        self.store.set(f"route:{api_key}", json.dumps(
            [[e.pool, e.entitlement] for e in route]))

    def resolve(self, api_key: str, now: float = 0.0) -> Optional[str]:
        """Entitlement of the preferred leg (legacy single-pool view)."""
        route = self.route(api_key, now)
        return route[0].entitlement if route else None

    def route(self, api_key: str, now: float = 0.0
              ) -> Optional[tuple[RouteEntry, ...]]:
        raw = self.store.get(f"route:{api_key}", now)
        if raw is None:
            return None
        return tuple(RouteEntry(p, e) for p, e in json.loads(raw))

    # -- request path --------------------------------------------------------------
    def handle(self, api_key: str, request_id: str, input_tokens: int,
               max_tokens: Optional[int], now: float,
               kv_bytes_per_token: float = 0.0) -> GatewayResponse:
        tel = self.telemetry
        route = self.route(api_key, now)
        if not route:
            if tel is not None:
                tel.record_terminal_one(
                    now, request_id, flightrec.VERDICT_UNKNOWN_KEY,
                    flightrec.REASON_NONE)
            return GatewayResponse(status=401, request_id=request_id,
                                   reason="unknown_key")
        legs = self.manager.route_order_indexed(
            list(route), input_tokens, max_tokens, now,
            policy=self.spill_policy)
        first_denial = None
        best_retry: Optional[float] = None
        for i_leg, (hop, leg) in enumerate(legs):
            decision = self._controller(leg.pool).decide(AdmissionRequest(
                entitlement=leg.entitlement, input_tokens=input_tokens,
                max_tokens=max_tokens, arrival_s=now,
                request_id=request_id,
                kv_bytes_per_token=kv_bytes_per_token))
            if tel is not None:
                pool = self.manager.pool(leg.pool)
                tel.attach_pool(pool)
                mt = (max_tokens if max_tokens is not None
                      else pool.spec.default_max_tokens)
                tel.record_decision(
                    leg.pool, now, request_id, hop, leg.entitlement,
                    decision.admitted,
                    flightrec.REASON_NONE if decision.reason is None
                    else flightrec.REASON_CODES[decision.reason.value],
                    decision.priority, float(input_tokens + mt))
            if decision.admitted:
                self.store.incr(f"admits:{leg.entitlement}", 1.0, now)
                if hop > 0:
                    self.store.incr(f"spills:{api_key}", 1.0, now)
                if i_leg > 0:
                    # served by a spill leg: remember the PREFERRED leg
                    # so completion can transfer the debt credit
                    # (PoolManager.transfer_spill_debt)
                    rec = self.manager.pool(leg.pool).in_flight.get(
                        request_id)
                    if rec is not None:
                        first = legs[0][1]
                        rec.spill_from = (first.pool, first.entitlement)
                return GatewayResponse(
                    status=200, request_id=request_id,
                    priority=decision.priority, pool=leg.pool,
                    entitlement=leg.entitlement, spill_hops=hop)
            if first_denial is None:
                first_denial = decision
            if decision.retry_after_s is not None:
                best_retry = (decision.retry_after_s if best_retry is None
                              else min(best_retry, decision.retry_after_s))

        # Every leg denied, or none was available.  The denial is
        # attributed to the first leg actually TRIED — when the whole
        # route is down nothing denied it, so the unroutable counter
        # takes it instead of charging a pool that never saw the
        # request.
        if legs:
            self.store.incr(f"denials:{legs[0][1].entitlement}", 1.0, now)
        else:
            self.store.incr(f"unroutable:{api_key}", 1.0, now)
        if first_denial is None:           # no live pool on the route
            if tel is not None:
                tel.record_terminal_one(
                    now, request_id, flightrec.VERDICT_DENY,
                    flightrec.REASON_POOL_UNAVAILABLE)
            return GatewayResponse(
                status=429, request_id=request_id, retry_after_s=5.0,
                reason=DenyReason.POOL_UNAVAILABLE.value)
        return GatewayResponse(
            status=429, request_id=request_id,
            retry_after_s=best_retry,
            reason=(first_denial.reason.value
                    if first_denial.reason else None),
            priority=first_denial.priority)

    # -- batched request path (the scheduling-quantum hot path) -----------------
    @hot_path
    def handle_quantum(self, requests: Sequence[QuantumRequest],
                       now: float) -> list[GatewayResponse]:
        """Admit one scheduling quantum of requests through the fused
        kernel — ONE ``admit_quantum`` dispatch per (pool, leg-round)
        instead of five Python checks per request.

        Round ``k`` groups every still-undecided request by the pool of
        the ``k``-th leg of its ``route_order``; each pool is
        snapshotted once (a pure read), its group replayed through the
        kernel in arrival order, and the resulting charges/denials are
        scattered back through the real ledger + pool bookkeeping.
        Requests denied at round ``k`` re-enter round ``k+1`` with
        their next leg.  Responses come back in input order.

        Parity contract (pinned in ``tests/test_torch_gateway_quantum.py``):
        each pool decides its batch exactly as the scalar
        :meth:`handle` pipeline would decide that arrival sequence, so
        end-to-end decisions are identical to the sequential handle
        loop whenever routes are single-leg or share one pool order
        (prefixes of a common route — the typical deployment, where a
        pool is only ever reached at one leg depth).  Route sets that
        interleave pools in DIFFERENT orders are still served
        deterministically, but leg-round batching admits a pool's
        round-``k`` arrivals before another request's round-``k+1``
        spill reaches it — where the sequential loop may interleave
        the other way.  Likewise ``headroom`` spill rankings are
        evaluated once at quantum start (per key + token shape), not
        re-ranked between requests mid-quantum.
        """
        if len(requests) == 1:
            # A one-request quantum replays the sequential walk exactly
            # (per-pool batches of size one) — skip the snapshot +
            # kernel dispatch and use the scalar pipeline directly.
            q = requests[0]
            return [self.handle(q.api_key, q.request_id, q.input_tokens,
                                q.max_tokens, now,
                                kv_bytes_per_token=q.kv_bytes_per_token)]
        tel = self.telemetry
        t0 = time.perf_counter() if tel is not None else 0.0
        fast = (self._quantum_fast(requests, now)
                if self.quantum_fast_enabled else None)
        if fast is not None:
            if tel is not None:
                tel.on_quantum(now, len(requests),
                               time.perf_counter() - t0)
            return fast
        responses: list[Optional[GatewayResponse]] = [None] * len(requests)
        # Routes are resolved once per distinct (key, token shape) at
        # quantum start — within a quantum `now` is fixed, so a key's
        # route (and its headroom ordering) is a constant.
        route_cache: dict[tuple, Optional[list]] = {}
        pending: list[_Pending] = []
        unknown_ids: list[str] = []
        for i, q in enumerate(requests):
            ck = (q.api_key, q.input_tokens, q.max_tokens)
            legs = route_cache.get(ck, False)
            if legs is False:
                route = self.route(q.api_key, now)
                legs = None if route is None else \
                    self.manager.route_order_indexed(
                        list(route), q.input_tokens, q.max_tokens, now,
                        policy=self.spill_policy)
                route_cache[ck] = legs
            if legs is None:
                responses[i] = GatewayResponse(
                    status=401, request_id=q.request_id,
                    reason="unknown_key")
                unknown_ids.append(q.request_id)
                continue
            pending.append(_Pending(idx=i, req=q, legs=list(legs)))
        if tel is not None and unknown_ids:
            tel.record_terminal(now, unknown_ids,
                                flightrec.VERDICT_UNKNOWN_KEY,
                                flightrec.REASON_NONE)

        while pending:
            # spills from different pools (and espec-miss skips) land in
            # group order — restore arrival order so every pool batch
            # replays its requests exactly as the scalar loop would
            pending.sort(key=lambda p: p.idx)
            groups: dict[str, list[_Pending]] = {}
            for p in pending:
                if p.leg_ptr >= len(p.legs):
                    responses[p.idx] = self._finish_denied(p, now)
                else:
                    groups.setdefault(p.current()[1].pool, []).append(p)
            pending = []
            for pool_name, batch in groups.items():
                pending.extend(self._admit_batch(pool_name, batch,
                                                 responses, now))
        if tel is not None:
            tel.on_quantum(now, len(requests), time.perf_counter() - t0)
        return responses

    def _finish_denied(self, p: _Pending, now: float) -> GatewayResponse:
        """Route exhausted: the 429 (same attribution as ``handle``)."""
        if p.legs:
            self.store.incr(f"denials:{p.legs[0][1].entitlement}",
                            1.0, now)
        else:
            self.store.incr(f"unroutable:{p.req.api_key}", 1.0, now)
        if p.first_reason is None:         # no live pool on the route
            if self.telemetry is not None:
                self.telemetry.record_terminal_one(
                    now, p.req.request_id, flightrec.VERDICT_DENY,
                    flightrec.REASON_POOL_UNAVAILABLE)
            return GatewayResponse(
                status=429, request_id=p.req.request_id,
                retry_after_s=5.0,
                reason=DenyReason.POOL_UNAVAILABLE.value)
        return GatewayResponse(
            status=429, request_id=p.req.request_id,
            retry_after_s=p.best_retry, reason=p.first_reason.value,
            priority=p.first_priority)

    @hot_path
    def _dispatch_admit(self, pool: TokenPool, snap, rows, tokens, kvs,
                        m: int) -> tuple[np.ndarray, np.ndarray,
                                         np.ndarray]:
        """ONE padded ``admit_quantum`` call for a pool batch of ``m``
        live requests in replay order (``rows``/``tokens``/``kvs`` may
        be lists or arrays), on the pool's device: the hand-written
        kernel on a CUDA pool, its plain version on a CPU pool.  Returns
        host-side (admitted, reasons, weights) trimmed to the live
        prefix.  The request axis is padded as the reference pads it
        (``quantum_width``), so both replay the same padded quantum.  A
        sharded pool on a row mesh dispatches ``shard_admit_quantum`` on
        its rank's block (the same decisions)."""
        width = quantum_width(m)
        row_width = bucket_width(snap.state.n_rows)
        dev = snap.bucket_level.device

        def padvec(xs, dtype):
            a = np.zeros(width, dtype)
            a[:m] = xs
            return torch.from_numpy(a).to(dev)

        live = np.zeros(width, bool)
        live[:m] = True
        level, infl, kvu = snap.bucket_level, snap.in_flight, snap.kv_in_use
        mesh = shard_plane.pool_mesh(pool)
        admit_fn, admit_kw = admit_quantum, {}
        if mesh is not None:
            # the snapshot's state and weights are this rank's row block
            lo, hi = pool.store.mirror_rows()
            level, infl, kvu = level[lo:hi], infl[lo:hi], kvu[lo:hi]
            admit_fn = shard_plane.shard_admit_quantum
            admit_kw = {"mesh": mesh}
        admitted, reasons, req_w = admit_fn(
            pad_state(snap.state, row_width),
            pad_rows(level, row_width),
            pad_rows(infl, row_width),
            pad_rows(kvu, row_width),
            pool_in_flight=int(snap.pool_in_flight),
            pool_conc_cap=np.float32(snap.pool_conc_cap),
            running_min_priority=np.float32(snap.running_min_priority),
            pool_avg_slo=np.float32(snap.pool_avg_slo),
            req_ent=padvec(rows, np.int32),
            req_tokens=padvec(tokens, np.float32),
            req_kv=padvec(kvs, np.float32),
            pool_resident=int(snap.pool_resident),
            req_live=torch.from_numpy(live).to(dev),
            weights=pad_rows(snap.weights, row_width),
            coeff=pool.spec.coefficients,
            slack=pool.spec.admission_slack,
            **admit_kw)
        return (admitted.cpu().numpy()[:m], reasons.cpu().numpy()[:m],
                req_w.cpu().numpy()[:m])

    @hot_path
    def _quantum_fast(self, requests: Sequence[QuantumRequest],
                      now: float) -> Optional[list[GatewayResponse]]:
        """Array-native quantum for ALL-single-leg route sets — the
        dominant deployment shape, where every key resolves to exactly
        one live leg, a denial is terminal, and no leg-round loop is
        needed.

        Requests group per distinct (key, token shape): routes resolve
        once per group, group constants (row, tokens, hop) expand to
        request arrays with ``np.full``, and each pool batch runs the
        SAME padded kernel dispatch and batched row-op scatters as the
        generic path — so per-request Python shrinks to one response
        tuple plus id extraction.  Decision/state parity with the
        generic leg-round loop is pinned by
        ``tests/test_torch_gateway_quantum.py``.

        Returns None — before touching ANY state — when some key's
        route has several live legs; the generic loop takes over."""
        n = len(requests)
        by_ck: dict[tuple, list[int]] = {}
        for i, q in enumerate(requests):
            ck = (q.api_key, q.input_tokens, q.max_tokens)
            try:
                by_ck[ck].append(i)
            except KeyError:
                by_ck[ck] = [i]
        # resolve every distinct key first — pure reads, so the
        # multi-leg bail-out leaves no partial state behind
        resolved = []
        for ck, idxs in by_ck.items():
            key, inp, mx = ck
            route = self.route(key, now)
            legs = None if route is None else \
                self.manager.route_order_indexed(
                    list(route), inp, mx, now, policy=self.spill_policy)
            if legs is not None and len(legs) > 1:
                return None
            resolved.append((idxs, ck, legs))
        responses: list[Optional[GatewayResponse]] = [None] * n
        pools: dict[str, list] = {}
        tel = self.telemetry
        unknown_ids: list[str] = []
        unroutable_ids: list[str] = []
        unroutable_incr: dict[str, float] = {}
        for idxs, ck, legs in resolved:
            key, inp, mx = ck
            if legs is None:
                for i in idxs:
                    responses[i] = GatewayResponse(
                        status=401, request_id=requests[i].request_id,
                        reason="unknown_key")
                    unknown_ids.append(requests[i].request_id)
            elif not legs:               # route exists, no live pool
                for i in idxs:
                    responses[i] = GatewayResponse(
                        status=429, request_id=requests[i].request_id,
                        retry_after_s=5.0,
                        reason=DenyReason.POOL_UNAVAILABLE.value)
                    unroutable_ids.append(requests[i].request_id)
                unroutable_incr[f"unroutable:{key}"] = \
                    unroutable_incr.get(f"unroutable:{key}", 0.0) \
                    + float(len(idxs))
            else:
                hop, leg = legs[0]
                pools.setdefault(leg.pool, []).append(
                    (idxs, key, leg.entitlement, inp, mx, hop))
        if unroutable_incr:
            self.store.incr_many(unroutable_incr, now)
        if tel is not None:
            if unknown_ids:
                tel.record_terminal(now, unknown_ids,
                                    flightrec.VERDICT_UNKNOWN_KEY,
                                    flightrec.REASON_NONE)
            if unroutable_ids:
                tel.record_terminal(now, unroutable_ids,
                                    flightrec.VERDICT_DENY,
                                    flightrec.REASON_POOL_UNAVAILABLE)
        for pool_name, entries in pools.items():
            self._admit_batch_fast(pool_name, entries, requests,
                                   responses, now)
        return responses

    @hot_path
    def _admit_batch_fast(self, pool_name: str, entries: list,
                          requests: Sequence[QuantumRequest],
                          responses: list, now: float) -> None:
        """One pool's single-leg quantum batch: snapshot → kernel →
        batched scatter, exactly like ``_admit_batch``, but built from
        per-group constants (every request of a (key, shape) group
        shares its row/tokens/hop) stitched back into arrival order."""
        pool = self.manager.pool(pool_name)
        snap = quantum_snapshot(pool, now)
        row_of = snap.row_of
        default_mt = pool.spec.default_max_tokens
        store = self.store
        tel = self.telemetry
        #: StateStore deltas for the whole batch — flushed as ONE
        #: ``incr_many`` (the Redis pipeline shape) instead of one
        #: ``incr`` per key
        incr_acc: dict[str, float] = {}
        # NOT_BOUND skips never reach the kernel; their decision rows
        # record with ent_slot -1 and zeroed state dims
        nb_rids: list[str] = []
        nb_hops: list[int] = []
        nb_toks: list[float] = []
        g_ent: list[str] = []
        g_key: list[str] = []
        g_hop: list[int] = []
        g_row: list[int] = []
        g_tok: list[float] = []
        g_inp: list[int] = []
        g_mt: list[int] = []
        counts: list[int] = []
        idx_lists: list[list[int]] = []
        for idxs, key, ent, inp, mx, hop in entries:
            row = row_of.get(ent)
            mt = mx if mx is not None else default_mt
            if row is None:
                # the scalar pipeline's espec-is-None early out:
                # terminal NOT_BOUND without touching pool state
                for i in idxs:
                    responses[i] = GatewayResponse(
                        status=429, request_id=requests[i].request_id,
                        reason=DenyReason.NOT_BOUND.value)
                    if tel is not None:
                        nb_rids.append(requests[i].request_id)
                        nb_hops.append(hop)
                        nb_toks.append(float(inp + mt))
                incr_acc[f"denials:{ent}"] = \
                    incr_acc.get(f"denials:{ent}", 0.0) + float(len(idxs))
                continue
            g_ent.append(ent)
            g_key.append(key)
            g_hop.append(hop)
            g_row.append(row)
            g_tok.append(float(inp + mt))
            g_inp.append(inp)
            g_mt.append(mt)
            counts.append(len(idxs))
            idx_lists.append(idxs)
        if tel is not None and nb_rids:
            tel.record_decisions(
                pool_name, now, nb_rids,
                np.full(len(nb_rids), -1, np.int64),
                np.asarray(nb_hops, np.int64),
                np.zeros(len(nb_rids), bool),
                np.full(len(nb_rids), 1, np.int16),   # NOT_BOUND
                0.0, float(snap.running_min_priority)
                * (1.0 - pool.spec.admission_slack),
                np.asarray(nb_toks, np.float64))
        if not counts:
            if incr_acc:
                store.incr_many(incr_acc, now)
            return
        # per-group constants expand to per-request arrays by GATHER,
        # not per-group np.full loops; argsort restores arrival order
        cnt = np.asarray(counts, np.int64)
        m = int(cnt.sum())
        idx_cat = np.fromiter(chain.from_iterable(idx_lists),
                              np.int64, count=m)
        order = np.argsort(idx_cat)
        idx_arr = idx_cat[order]
        gids = np.repeat(np.arange(len(counts), dtype=np.int64),
                         cnt)[order]
        rows64 = np.asarray(g_row, np.int64)[gids]
        toks64 = np.asarray(g_tok, np.float64)[gids]
        inps = np.asarray(g_inp, np.int64)[gids]
        mts = np.asarray(g_mt, np.int64)[gids]
        idx_l = idx_arr.tolist()
        if m == len(requests):
            # whole quantum in one pool batch (the common single-pool
            # deployment): arrival order IS input order, so attribute
            # extraction runs as C-speed maps with no index gather
            rids = list(map(_Q_RID, requests))
            kvpt = np.fromiter(map(_Q_KV, requests), np.float64,
                               count=m)
        else:
            rids = [requests[i].request_id for i in idx_l]
            kvpt = np.fromiter(
                (requests[i].kv_bytes_per_token for i in idx_l),
                np.float64, count=m)
        kvs64 = toks64 * kvpt

        admitted, reasons, req_w = self._dispatch_admit(
            pool, snap, rows64, toks64, kvs64, m)

        ledger = pool.ledger
        js = np.flatnonzero(admitted)
        charged = np.zeros(m, bool)
        ch_slots = np.empty(0, np.int64)
        charge_ids: list[str] = []
        if js.size:
            # buckets ensured once per group with kernel admits (the
            # same entitlement set the generic pass-1 loop ensures),
            # vectorized: rates come off the eff_tps column, with the
            # scalar path's spec-f64 baseline on the eff==0 fallback
            ub = np.unique(gids[js])
            uslots = np.asarray(g_row, np.int64)[ub]
            rates = pool.store.col["eff_tps"][uslots].copy()
            for t in np.flatnonzero(rates == 0.0).tolist():
                rates[t] = pool.entitlements[
                    g_ent[int(ub[t])]].baseline.tokens_per_second
            ledger.ensure_rows(uslots, rates, now)
            charge_ids = rids if js.size == m else \
                [rids[t] for t in js.tolist()]
            ok, ch_slots = ledger.charge_rows(
                charge_ids, rows64[js], toks64[js], inps[js], mts[js],
                now)
            charged[js] = ok

        acc = np.flatnonzero(charged)
        w_l = req_w.tolist()
        gid_l = gids.tolist()
        if acc.size:
            admit_ids = charge_ids if acc.size == js.size else \
                [rids[t] for t in acc.tolist()]
            pool.admit_rows(admit_ids, rows64[acc], kvs64[acc],
                            toks64[acc], now, slots=ch_slots)
            # demand lands exactly like the scalar register_admit
            # loop: one unbuffered index-ordered f64 add chain
            np.add.at(pool.store.col["demand_window"], rows64[acc],
                      toks64[acc])
            per_gid = np.bincount(gids[acc], minlength=len(g_ent))
            for gid, cnt in enumerate(per_gid.tolist()):
                if cnt:
                    k_adm = f"admits:{g_ent[gid]}"
                    incr_acc[k_adm] = incr_acc.get(k_adm, 0.0) \
                        + float(cnt)
                    if g_hop[gid] > 0:
                        k_sp = f"spills:{g_key[gid]}"
                        incr_acc[k_sp] = incr_acc.get(k_sp, 0.0) \
                            + float(cnt)
            if acc.size == m:
                it = zip(idx_l, rids, w_l, gid_l)
            else:
                it = ((idx_l[k], rids[k], w_l[k], gid_l[k])
                      for k in acc.tolist())
            # tuple.__new__ skips the NamedTuple default-filling
            # wrapper — measurably faster at 10^5 responses/quantum
            mk = tuple.__new__
            for i, rid, w, gid in it:
                responses[i] = mk(GatewayResponse,
                                  (200, rid, None, None, w, pool_name,
                                   g_ent[gid], g_hop[gid]))

        den = np.flatnonzero(~charged)
        if den.size:
            hint_cache: dict = {}
            deny_ents: list[str] = []
            deny_demand = np.zeros(den.size, np.float64)
            deny_lp = np.zeros(den.size, bool)
            adm_kernel = admitted.tolist()
            reasons_l = reasons.tolist()
            toks_l = toks64.tolist()
            dcount: dict[str, int] = {}
            for d, k in enumerate(den.tolist()):
                ent = g_ent[gid_l[k]]
                w = w_l[k]
                code = 3 if adm_kernel[k] else int(reasons_l[k])
                reason = _REASON_CODES[code]
                retry = self._deny_hint(pool, pool_name, ent, reason,
                                        toks_l[k], w, now,
                                        cache=hint_cache)
                deny_ents.append(ent)
                if reason is not DenyReason.NOT_BOUND:
                    deny_demand[d] = toks_l[k]
                lp = reason is DenyReason.LOW_PRIORITY
                deny_lp[d] = lp
                dcount[ent] = dcount.get(ent, 0) + 1
                responses[idx_l[k]] = GatewayResponse(
                    status=429, request_id=rids[k],
                    retry_after_s=retry, reason=reason.value,
                    priority=w if lp else 0.0)
            pool.register_deny_batch(deny_ents, deny_demand, deny_lp)
            for ent, cnt in dcount.items():
                k_den = f"denials:{ent}"
                incr_acc[k_den] = incr_acc.get(k_den, 0.0) + float(cnt)
        if incr_acc:
            store.incr_many(incr_acc, now)
        if tel is not None:
            # ONE flight scatter for the kernel batch, with reasons
            # finalized the way responses were: a kernel admit the
            # ledger rejected flips to TOKEN_BUDGET (code 3)
            final_reasons = np.where(
                charged, 0,
                np.where(admitted, 3, reasons.astype(np.int64)))
            tel.record_decisions(
                pool_name, now, rids, rows64,
                np.asarray(g_hop, np.int64)[gids], charged,
                final_reasons.astype(np.int16),
                np.asarray(req_w, np.float64),
                float(snap.running_min_priority)
                * (1.0 - pool.spec.admission_slack),
                toks64,
                levels_at=snap.bucket_level.cpu().numpy().astype(
                    np.float64))

    @hot_path
    def _admit_batch(self, pool_name: str, batch: list[_Pending],
                     responses: list, now: float) -> list[_Pending]:
        """One fused kernel dispatch for one pool's leg-round group;
        scatters results into ``responses`` / pool state and returns
        the requests that spill into the next round."""
        pool = self.manager.pool(pool_name)
        snap = quantum_snapshot(pool, now)
        spilled: list[_Pending] = []

        # Legs naming an entitlement the pool has never heard of deny
        # NOT_BOUND without touching pool state (the scalar pipeline's
        # espec-is-None early out) — they skip the kernel entirely.
        kernel_batch: list[_Pending] = []
        tel = self.telemetry
        nb_rids: list[str] = []
        nb_hops: list[int] = []
        nb_toks: list[float] = []
        #: declared route position per kernel-batch entry, captured
        #: BEFORE the denial pass advances leg_ptr
        hops: list[int] = []
        rows, tokens, kvs, eff_max = [], [], [], []
        for p in batch:
            hop, leg = p.current()
            row = snap.row_of.get(leg.entitlement)
            mt = (p.req.max_tokens if p.req.max_tokens is not None
                  else pool.spec.default_max_tokens)
            if row is None:
                if tel is not None:
                    nb_rids.append(p.req.request_id)
                    nb_hops.append(hop)
                    nb_toks.append(float(p.req.input_tokens + mt))
                p.note_denial(DenyReason.NOT_BOUND, 0.0, None)
                p.leg_ptr += 1
                spilled.append(p)
                continue
            kernel_batch.append(p)
            hops.append(hop)
            rows.append(row)
            tokens.append(float(p.req.input_tokens + mt))
            kvs.append(float(p.req.input_tokens + mt)
                       * p.req.kv_bytes_per_token)
            eff_max.append(mt)
        if tel is not None and nb_rids:
            tel.record_decisions(
                pool_name, now, nb_rids,
                np.full(len(nb_rids), -1, np.int64),
                np.asarray(nb_hops, np.int64),
                np.zeros(len(nb_rids), bool),
                np.full(len(nb_rids), 1, np.int16),   # NOT_BOUND
                0.0, float(snap.running_min_priority)
                * (1.0 - pool.spec.admission_slack),
                np.asarray(nb_toks, np.float64))
        if not kernel_batch:
            return spilled

        m = len(kernel_batch)
        admitted, reasons, req_w = self._dispatch_admit(
            pool, snap, rows, tokens, kvs, m)

        # -- scatter, pass 1: the quantum's charges, in replay order —
        # array-native: no per-request ``Charge`` objects, accepted
        # charges land as batched request-table column writes
        # (``Ledger.charge_rows``).  Buckets are ensured once per
        # entitlement; the ledger re-checks every charge (it stays
        # authoritative if f32/f64 disagree on an exact budget
        # boundary — those flip to budget denials below).
        ledger = pool.ledger
        slot_of = pool.store.slot_of
        ensured: set = set()
        charge_js: list[int] = []
        charge_ids: list[str] = []
        ent_slots: list[int] = []
        inp_toks: list[int] = []
        max_toks: list[int] = []
        for j, p in enumerate(kernel_batch):
            if not admitted[j]:
                continue
            ent = p.current()[1].entitlement
            if ent not in ensured:
                st = pool.status[ent]
                ledger.ensure(
                    ent, st.effective.tokens_per_second
                    or pool.entitlements[ent].baseline.tokens_per_second,
                    now)
                ensured.add(ent)
            charge_js.append(j)
            charge_ids.append(p.req.request_id)
            ent_slots.append(slot_of[ent])
            inp_toks.append(p.req.input_tokens)
            max_toks.append(int(eff_max[j]))
        tokens64 = np.asarray(tokens, np.float64)
        kvs64 = np.asarray(kvs, np.float64)
        charged = np.zeros(m, bool)
        js = np.asarray(charge_js, np.int64)
        owners = np.asarray(ent_slots, np.int64)
        ch_slots = np.empty(0, np.int64)
        if charge_js:
            ok, ch_slots = ledger.charge_rows(
                charge_ids, owners, tokens64[js],
                np.asarray(inp_toks, np.int64),
                np.asarray(max_toks, np.int64), now)
            charged[js] = ok

        # -- scatter, pass 2a: admits.  ONE ``admit_rows`` column
        # scatter — no per-request ``InFlight`` objects — and counter
        # increments are aggregated: the StateStore and store columns
        # are hit once per distinct key per quantum, not per request.
        acc = np.flatnonzero(charged[js]) if charge_js else js
        if acc.size:
            n_admits: dict = {}
            n_spills: dict = {}
            demand: dict = {}
            # (row slot index in this admit batch, preferred leg) for
            # requests served off a spill leg — tagged on the new rows
            # below for completion-time debt transfer
            spill_tags: list[tuple[int, tuple[str, str]]] = []
            acc_l = acc.tolist()
            for k, i in enumerate(acc_l):
                p = kernel_batch[charge_js[i]]
                hop, leg = p.current()
                ent = leg.entitlement
                w = float(req_w[charge_js[i]])
                demand[ent] = demand.get(ent, 0.0) \
                    + float(tokens[charge_js[i]])
                n_admits[ent] = n_admits.get(ent, 0) + 1
                if hop > 0:
                    key = p.req.api_key
                    n_spills[key] = n_spills.get(key, 0) + 1
                if p.leg_ptr > 0:
                    first = p.legs[0][1]
                    spill_tags.append((k, (first.pool,
                                           first.entitlement)))
                responses[p.idx] = GatewayResponse(
                    status=200, request_id=p.req.request_id,
                    priority=w, pool=pool_name, entitlement=ent,
                    spill_hops=hop)
            js_acc = js[acc]
            # ch_slots aligns with the accepted subset of the charge
            # batch in charge order — exactly this admit batch, so the
            # rows charged are the rows admitted (no second id lookup)
            slots = pool.admit_rows(
                [charge_ids[i] for i in acc_l], owners[acc],
                kvs64[js_acc], tokens64[js_acc], now,
                demand_tokens=demand, slots=ch_slots)
            spill_col = pool.table.spill_from
            for k, leg_from in spill_tags:
                spill_col[int(slots[k])] = leg_from
            incr_acc = {f"admits:{ent}": float(cnt)
                        for ent, cnt in n_admits.items()}
            for key, cnt in n_spills.items():
                incr_acc[f"spills:{key}"] = float(cnt)
            self.store.incr_many(incr_acc, now)

        # -- scatter, pass 2b: denials.  Runs AFTER the quantum's
        # admits are registered, so Retry-After hints reflect the pool
        # the retrying client will actually face (the scalar loop's
        # hints see only the admits that preceded each request).
        # Bookkeeping lands as ONE ``register_deny_batch`` scatter, and
        # hints are memoized per (reason, entitlement, tokens): a
        # denial mutates only demand/denial counters, which no hint
        # formula reads, so within one batch equal keys give equal
        # hints — and the priority threshold (a pool-wide Eq. 1 min)
        # is evaluated at most once per batch.
        deny_js = np.flatnonzero(~charged)
        if deny_js.size:
            hint_cache: dict = {}
            deny_ents: list[str] = []
            deny_demand = np.zeros(deny_js.size, np.float64)
            deny_lp = np.zeros(deny_js.size, bool)
            for k, j in enumerate(deny_js.tolist()):
                p = kernel_batch[j]
                ent = p.current()[1].entitlement
                w = float(req_w[j])
                code = 3 if admitted[j] else int(reasons[j])
                reason = _REASON_CODES[code]
                retry = self._deny_hint(pool, pool_name, ent, reason,
                                        float(tokens[j]), w, now,
                                        cache=hint_cache)
                deny_ents.append(ent)
                if reason is not DenyReason.NOT_BOUND:
                    deny_demand[k] = float(tokens[j])
                deny_lp[k] = reason is DenyReason.LOW_PRIORITY
                p.note_denial(reason,
                              w if reason is DenyReason.LOW_PRIORITY
                              else 0.0, retry)
                p.leg_ptr += 1
                spilled.append(p)
            pool.register_deny_batch(deny_ents, deny_demand, deny_lp)
        if tel is not None:
            final_reasons = np.where(
                charged, 0,
                np.where(admitted, 3, reasons.astype(np.int64)))
            tel.record_decisions(
                pool_name, now,
                [p.req.request_id for p in kernel_batch],
                np.asarray(rows, np.int64), np.asarray(hops, np.int64),
                charged, final_reasons.astype(np.int16),
                np.asarray(req_w, np.float64),
                float(snap.running_min_priority)
                * (1.0 - pool.spec.admission_slack),
                tokens64,
                levels_at=snap.bucket_level.cpu().numpy().astype(
                    np.float64))
        return spilled

    def _deny_hint(self, pool: TokenPool, pool_name: str, ent: str,
                   reason: DenyReason, tokens: float, w: float,
                   now: float, cache: Optional[dict] = None
                   ) -> Optional[float]:
        """Retry-After for a kernel denial — the scalar pipeline's
        §4.3 hint formulas, evaluated on the post-quantum pool state
        (all of this batch's admits applied): the hint describes what
        a client retrying AFTER this quantum will face.

        ``cache`` (one dict per batch) memoizes hints per
        (reason, entitlement, tokens) and the priority threshold per
        batch — valid because post-quantum pool state is fixed for the
        whole denial pass (denials mutate nothing a hint reads)."""
        ctrl = self._controller(pool_name)
        if reason is DenyReason.NOT_BOUND:
            return 5.0
        if reason is DenyReason.LOW_PRIORITY:
            threshold = (cache.get("threshold")
                         if cache is not None else None)
            if threshold is None:
                threshold = (pool.admission_threshold()
                             * (1.0 - pool.spec.admission_slack))
                if cache is not None:
                    cache["threshold"] = threshold
            return ctrl._priority_backoff(w, threshold)
        key = (reason, ent, tokens)
        if cache is not None and key in cache:
            return cache[key]
        if reason is DenyReason.CONCURRENCY:
            hint = ctrl._concurrency_backoff(ent)
        else:                                # TOKEN_BUDGET
            espec = pool.entitlements[ent]
            st = pool.status[ent]
            bucket = pool.ledger.ensure(
                ent, st.effective.tokens_per_second
                or espec.baseline.tokens_per_second, now)
            if not bucket.can_afford(tokens, now):
                hint = min(pool.ledger.retry_after(ent, tokens, now),
                           60.0)
            else:
                hint = 1.0                   # KV headroom denial
        if cache is not None:
            cache[key] = hint
        return hint

    # -- fleet planning -----------------------------------------------------------
    def plan_quantum(self, now: float, records=None):
        """Run one fleet planning round (``PoolManager.plan_quantum``)
        and surface it in the gateway's stats store: per-pool replica
        gauges, scale-up/down counters, and migration counters —
        the same observability surface the admission counters use."""
        t0 = time.perf_counter()
        plan = self.manager.plan_quantum(now, records=records)
        if self.telemetry is not None:
            self.telemetry.on_plan(now, plan,
                                   time.perf_counter() - t0)
        for name, d in plan.decisions.items():
            self.store.set(f"replicas:{name}", float(d.desired), now)
        # count authorization TRANSITIONS, not convergence rounds —
        # under provisioning lag `desired > current` repeats every
        # plan until the replicas come live
        for name, (old, new) in plan.scale_events.items():
            if new > old:
                self.store.incr(f"scale_ups:{name}", 1.0, now)
            elif new < old:
                self.store.incr(f"scale_downs:{name}", 1.0, now)
        for prop in plan.applied:
            self.store.incr(f"migrations:{prop.entitlement}", 1.0, now)
            self.store.set(f"migrated_to:{prop.entitlement}", prop.dst,
                           now)
        return plan

    # -- completion callback ----------------------------------------------------------
    def on_complete(self, request_id: str, actual_output_tokens: int,
                    latency_s: float, now: float) -> None:
        settled = self.manager.on_complete(request_id,
                                           actual_output_tokens, now)
        if settled is not None:
            pool_name, rec = settled
            self.store.incr(f"tokens:{rec.entitlement}",
                            float(actual_output_tokens), now)
            self.store.set(f"last_latency:{rec.entitlement}", latency_s,
                           now)
            if self.telemetry is not None:
                self.telemetry.record_completions(
                    now, [pool_name], [rec.entitlement], [latency_s])

    @hot_path
    def on_complete_batch(self, completions: Sequence[tuple], now: float
                          ) -> None:
        """Batched completion callback — one vectorized settle per
        admitting pool per scheduling quantum.

        ``completions`` is a sequence of
        ``(request_id, actual_output_tokens, latency_s)`` tuples.
        Semantics per element match :meth:`on_complete` (the retained
        scalar oracle); StateStore counters are aggregated so the
        store is hit once per distinct entitlement per batch
        (``last_latency`` keeps last-write-wins order)."""
        if not completions:
            return
        settled = self.manager.on_complete_batch(
            [(rid, out) for rid, out, _ in completions], now)
        tel = self.telemetry
        tokens_incr: dict = {}
        last_lat: dict = {}
        done_pools: list[str] = []
        done_ents: list[str] = []
        done_lats: list[float] = []
        for (_, out, lat), res in zip(completions, settled):
            if res is None:
                continue
            ent = res[1]
            tokens_incr[f"tokens:{ent}"] = \
                tokens_incr.get(f"tokens:{ent}", 0.0) + float(out)
            last_lat[ent] = lat
            if tel is not None:
                done_pools.append(res[0])
                done_ents.append(ent)
                done_lats.append(lat)
        self.store.incr_many(tokens_incr, now)
        for ent, lat in last_lat.items():
            self.store.set(f"last_latency:{ent}", lat, now)
        if tel is not None and done_ents:
            # one SLO row-op for the whole drain (per-tier latency
            # histograms + attainment counters)
            tel.record_completions(now, done_pools, done_ents,
                                   done_lats)

    def on_failure(self, request_id: str, now: float) -> None:
        self.manager.on_evict(request_id, now)

    def kv_reserved_bytes(self) -> float:
        """The KV bytes the pools charged at admission for the requests
        they hold: each pool's ``kv_in_use`` over its live rows."""
        total = 0.0
        for pool in self.manager.pools.values():
            store = pool.store
            total += float(store.col["kv_in_use"][store.live_slots()].sum())
        return total
