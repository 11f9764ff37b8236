"""PoolManager — pool membership, routing and completion attribution.

Counterpart of ``repro/core/pool_manager.py``, cut to what the scalar
gateway path uses: membership, ``route_order`` (static client
preference or budget/latency-aware ``headroom`` ranking over a route's
(pool, entitlement) legs), and completion / eviction attribution with
the per-request cross-pool debt transfer.  The batched fleet ``tick``,
``on_complete_batch``, migration and ``plan_quantum`` wait for the
quantum and planner slices (ROADMAP queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Union

from repro_torch.core.pool import InFlight, TokenPool
from repro_torch.core.types import EntitlementSpec, PoolSpec
from repro_torch.core.virtual_node import VirtualNodeProvider


@dataclasses.dataclass(frozen=True)
class RouteEntry:
    """One leg of a multi-pool route: admit ``entitlement`` on ``pool``."""

    pool: str
    entitlement: str


#: Spill policies understood by ``route_order``.
SPILL_POLICIES = ("static", "headroom")


class PoolManager:
    """Holds the fleet of TokenPools and attributes their requests."""

    def __init__(self, pools: Iterable[TokenPool] = ()) -> None:
        self.pools: dict[str, TokenPool] = {}
        for p in pools:
            self.adopt(p)

    # -- membership -----------------------------------------------------------
    def add_pool(self, spec: PoolSpec,
                 provider: Optional[VirtualNodeProvider] = None,
                 now: float = 0.0, device="cuda") -> TokenPool:
        pool = TokenPool(spec, provider=provider, now=now, device=device)
        return self.adopt(pool)

    def adopt(self, pool: TokenPool) -> TokenPool:
        if pool.spec.name in self.pools:
            raise ValueError(f"duplicate pool {pool.spec.name!r}")
        self.pools[pool.spec.name] = pool
        return pool

    def pool(self, name: str) -> TokenPool:
        return self.pools[name]

    def default_pool(self) -> TokenPool:
        if not self.pools:
            raise LookupError("PoolManager has no pools")
        return next(iter(self.pools.values()))

    def add_entitlement(self, espec: EntitlementSpec,
                        now: float = 0.0):
        """Route an entitlement spec to the pool it names."""
        return self.pools[espec.pool].add_entitlement(espec, now=now)

    def available(self, name: str) -> bool:
        pool = self.pools.get(name)
        return pool is not None and pool.replicas > 0

    def owner_of(self, entitlement: str,
                 hint: Optional[str] = None) -> Optional[str]:
        """Pool currently holding ``entitlement`` (``hint`` = the pool
        a route leg *claims*, checked first).  Rebalancing migrates
        entitlements between pools, so a stored route's legs can go
        stale — resolution follows the entitlement, not the leg."""
        if hint is not None:
            pool = self.pools.get(hint)
            if pool is not None and entitlement in pool.entitlements:
                return hint
        for name, pool in self.pools.items():
            if entitlement in pool.entitlements:
                return name
        return None

    # -- routing ---------------------------------------------------------------
    def route_order(self, entries: list[RouteEntry], input_tokens: int,
                    max_tokens: Optional[int], now: float,
                    policy: str = "static") -> list[RouteEntry]:
        """Rank a route's legs; unavailable pools are dropped.

        ``static``   — the client's declared preference order.
        ``headroom`` — budget/latency-aware: legs whose token bucket can
        afford this request's charge (input + effective max_tokens,
        using each leg's own pool default) rank before legs that would
        deny on budget; within each group, larger remaining bucket
        budget wins, with the pool's load factor
        admitted-in-flight / concurrency (queueing latency proxy) as
        the tiebreak.  Preference order breaks exact ties so the
        policy degrades to ``static`` on fresh pools.
        """
        return [e for _, e in self.route_order_indexed(
            entries, input_tokens, max_tokens, now, policy=policy)]

    def route_order_indexed(self, entries: list[RouteEntry],
                            input_tokens: int, max_tokens: Optional[int],
                            now: float, policy: str = "static",
                            ) -> list[tuple[int, RouteEntry]]:
        """:meth:`route_order`, but each leg carries its position in the
        client's DECLARED route.  The gateway reports that position as
        ``spill_hops`` — re-searching the declared route for the
        admitting leg (``route.index``) would misattribute repeated
        legs and, under ``headroom`` reordering, renumbered ones.

        Legs follow MIGRATED entitlements: a leg whose entitlement the
        rebalancer has moved to another pool is rewritten to the
        current owner, so stored routes keep working across
        cross-pool rebalances."""
        remapped = []
        for e in entries:
            owner = self.owner_of(e.entitlement, hint=e.pool)
            remapped.append(e if owner is None or owner == e.pool
                            else RouteEntry(owner, e.entitlement))
        live = [(i, e) for i, e in enumerate(remapped)
                if self.available(e.pool)]
        if policy == "static":
            return live
        if policy != "headroom":
            raise ValueError(f"unknown spill policy {policy!r}; "
                             f"expected one of {SPILL_POLICIES}")

        def score(pos_entry):
            pos, e = pos_entry
            pool = self.pools[e.pool]
            espec = pool.entitlements.get(e.entitlement)
            if espec is None:
                return (1, float("inf"), float("inf"), pos)
            charged = input_tokens + (
                max_tokens if max_tokens is not None
                else pool.spec.default_max_tokens)
            bucket = pool.ledger.ensure(
                e.entitlement,
                pool.status[e.entitlement].effective.tokens_per_second
                or espec.baseline.tokens_per_second, now)
            bucket.refill(now)
            affordable = 0 if bucket.level >= charged else 1
            conc = max(1.0, pool.capacity().concurrency)
            load = pool.pool_in_flight() / conc
            return (affordable, -bucket.level, load, pos)

        return sorted(live, key=score)

    # -- completion attribution -------------------------------------------------
    def find_pool_of(self, request_id: str) -> Optional[TokenPool]:
        for pool in self.pools.values():
            if request_id in pool.in_flight:
                return pool
        return None

    def on_complete(self, request_id: str, actual_output_tokens: int,
                    now: float) -> Optional[tuple[str, InFlight]]:
        """Settle a completion on whichever pool admitted the request.
        Returns (pool name, settled record) or None if unknown.  A
        request served by a SPILL leg additionally transfers the
        corresponding debt credit from the preferred entitlement to the
        serving one (:meth:`transfer_spill_debt`)."""
        pool = self.find_pool_of(request_id)
        if pool is None:
            return None
        rec = pool.on_complete(request_id, actual_output_tokens, now)
        if rec is None:
            return None
        if rec.spill_from is not None:
            self.transfer_spill_debt(rec, pool.spec.name, now)
        return (pool.spec.name, rec)

    def transfer_spill_debt(self, rec: InFlight, serving_pool: str,
                            now: float) -> float:
        """Per-request cross-pool debt transfer (ROADMAP item 4, the
        per-request half): a request the client PREFERRED on leg
        ``rec.spill_from`` but that was served by a spill leg moves the
        service-equivalent debt credit between the two entitlements on
        completion —

          * the preferred entitlement's debt DRAINS: it was recorded as
            denied demand there (raising debt every tick), yet the
            tenant did get served, just elsewhere;
          * the serving entitlement INHERITS the drained amount (when
            it is debt-bearing): the underserved tenant carries its
            priority boost to the spill target, so the spilled traffic
            keeps being served there.

        The credit is the Eq. 2 gap-equivalent of the settled tokens:
        one completion of ``settled_tokens`` over its service window
        covers ``settled / (λ_e · window)`` of the preferred baseline,
        clipped and EWMA-weighted exactly like a tick's gap sample.
        Clamps: the source never drains below ``debt_min``, the target
        never exceeds ``debt_max``.  Returns the transferred amount."""
        from repro_torch.core.types import DEBT_CLASSES

        pref_pool, pref_ent = rec.spill_from
        if pref_ent == rec.entitlement:
            return 0.0
        src_name = self.owner_of(pref_ent, hint=pref_pool)
        if src_name is None:
            return 0.0
        spool = self.pools[src_name]
        espec = spool.entitlements[pref_ent]
        base = espec.baseline.tokens_per_second
        if (espec.qos.service_class not in DEBT_CLASSES or base <= 0.0
                or rec.settled_tokens <= 0.0):
            return 0.0
        coeff = spool.spec.coefficients
        window = max(now - rec.admitted_at,
                     spool.spec.accounting_interval_s)
        gap_credit = min(coeff.gap_clip,
                         rec.settled_tokens / (base * window))
        credit = (1.0 - coeff.gamma_debt) * gap_credit
        src_st = spool.status[pref_ent]
        delta = min(credit, src_st.debt - coeff.debt_min)
        if delta <= 0.0:
            return 0.0
        dpool = self.pools.get(serving_pool)
        dspec = (dpool.entitlements.get(rec.entitlement)
                 if dpool is not None else None)
        if dspec is not None \
                and dspec.qos.service_class in DEBT_CLASSES:
            dst = dpool.status[rec.entitlement]
            dmax = dpool.spec.coefficients.debt_max
            delta = min(delta, dmax - dst.debt)
            if delta <= 0.0:
                return 0.0
            dst.debt = dst.debt + delta
        src_st.debt = src_st.debt - delta
        return delta

    def on_evict(self, request_id: str, now: float
                 ) -> Optional[tuple[str, InFlight]]:
        pool = self.find_pool_of(request_id)
        if pool is None:
            return None
        rec = pool.on_evict(request_id, now)
        return (pool.spec.name, rec) if rec is not None else None

PoolOrManager = Union[TokenPool, PoolManager]


def as_manager(pools: PoolOrManager) -> PoolManager:
    """Wrap a bare TokenPool into a single-pool manager (legacy API)."""
    if isinstance(pools, PoolManager):
        return pools
    return PoolManager([pools])
