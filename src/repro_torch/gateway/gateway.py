"""AI Gateway: the admission boundary (paper Fig. 1, LiteLLM role).

Counterpart of ``repro/gateway/gateway.py``, scalar path only.
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

:meth:`Gateway.handle` runs one request through the §4.3 pipeline
(``AdmissionController.decide``).  The batched quantum path
(``handle_quantum``, ``on_complete_batch``) and the fleet planner hook
wait for the quantum slice (ROADMAP queue A).

State lives in the StateStore (Redis contract): key → route mapping and
per-entitlement counters, so a real deployment can point this class at
an actual Redis.
"""
from __future__ import annotations

import json
from typing import NamedTuple, Optional, Sequence, Union

from repro_torch.core import (
    AdmissionController,
    AdmissionRequest,
    DenyReason,
    RouteEntry,
    StateStore,
    TokenPool,
)
from repro_torch.core.pool_manager import (
    SPILL_POLICIES,
    PoolOrManager,
    as_manager,
)


class GatewayResponse(NamedTuple):
    """Immutable per-request verdict."""

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


class Gateway:
    def __init__(self, pools: PoolOrManager,
                 store: Optional[StateStore] = None,
                 spill_policy: str = "static",
                 telemetry=None) -> None:
        if spill_policy not in SPILL_POLICIES:
            raise ValueError(f"unknown spill policy {spill_policy!r}; "
                             f"expected one of {SPILL_POLICIES}")
        if telemetry is not None:
            raise NotImplementedError(
                "Gateway(telemetry=...) — the telemetry plane is "
                "ROADMAP queue A, 'telemetry/chaos'")
        self.manager = as_manager(pools)
        self.store = store or StateStore()
        self.spill_policy = spill_policy
        self.controllers: dict[str, AdmissionController] = {
            name: AdmissionController(pool)
            for name, pool in self.manager.pools.items()}

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
        route = self.route(api_key, now)
        if not route:
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
            return GatewayResponse(
                status=429, request_id=request_id, retry_after_s=5.0,
                reason=DenyReason.POOL_UNAVAILABLE.value)
        return GatewayResponse(
            status=429, request_id=request_id,
            retry_after_s=best_retry,
            reason=(first_denial.reason.value
                    if first_denial.reason else None),
            priority=first_denial.priority)

    # -- completion callback ----------------------------------------------------------
    def on_complete(self, request_id: str, actual_output_tokens: int,
                    latency_s: float, now: float) -> None:
        settled = self.manager.on_complete(request_id,
                                           actual_output_tokens, now)
        if settled is not None:
            _, rec = settled
            self.store.incr(f"tokens:{rec.entitlement}",
                            float(actual_output_tokens), now)
            self.store.set(f"last_latency:{rec.entitlement}", latency_s,
                           now)

    def on_failure(self, request_id: str, now: float) -> None:
        self.manager.on_evict(request_id, now)
