"""PoolManager — the multi-pool control plane.

Counterpart of ``repro/core/pool_manager.py``.  A platform runs several
TokenPools and an API key maps to an ORDERED list of (pool,
entitlement) legs with spill-over.  This module provides:

1. **Batched accounting** — ``PoolManager.tick`` stacks every pool's
   resident rows along a pool axis (padding narrower pools with inert
   unbound rows) and runs ``control_plane.control_tick_pools`` — one
   call for the whole fleet per group of pools that share priority
   coefficients and a device.
2. **Routing** — ``route_order`` ranks the legs of a route: the static
   client preference by default, or budget/latency-aware
   (``spill_policy="headroom"``).  Pools with zero live replicas are
   unavailable and always skipped.
3. **Completion attribution** — per request and batched, with the
   cross-pool debt transfer for requests served off a spill leg.
4. **Fleet planning** — ``plan_quantum`` closes the loop: batched
   tick → ``core.fleet.FleetPlanner`` (one ``plan_fleet`` call on the
   fleet's device) → authorize/provision each pool → apply the
   planner's rebalance proposals through ``migrate_entitlement``,
   which carries an entitlement's bucket level, debt/burst, in-flight
   records and demand signal to another pool.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Optional, Union

import numpy as np
import torch

from repro_torch.core import control_plane
from repro_torch.core.control_plane import ControlState
from repro_torch.core.markers import hot_path
from repro_torch.core.pool import InFlight, TickRecord, TokenPool
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
    """Holds the fleet of TokenPools and batches their accounting."""

    def __init__(self, pools: Iterable[TokenPool] = ()) -> None:
        self.pools: dict[str, TokenPool] = {}
        #: fleet capacity planner (created lazily by ``plan_quantum``;
        #: assign one to customize ``FleetPlannerConfig``)
        self.planner = None
        #: ``hook(pool, decision, now)`` — when set, scale decisions
        #: are handed to it instead of applied instantly, so a
        #: deployment (or ``MultiPoolSimulator``) can model
        #: provisioning lag and scale-down draining.  The promise
        #: ceiling (``authorize_replicas``) always moves at decision
        #: time regardless.
        self.provision_hook = None
        #: per-group cache of the stacked [P, W] device state fed to
        #: ``control_tick_pools`` — the tick's own output is next tick's
        #: input, so steady-state fleet ticks re-upload NOTHING
        #: (validity: each pool's ``device_state()`` must still be the
        #: state slice the last tick adopted; growth/``mark_dirty``/churn
        #: swap that object out and the changed pool's row is re-spliced
        #: device-side)
        self._stack_cache: dict[object, dict] = {}
        #: observability: whole-group stack reuses vs pool rows
        #: re-stacked (steady-state ticking re-stacks nothing)
        self.stack_reuses = 0
        self.stack_restacks = 0
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

    @hot_path
    def on_complete_batch(self, completions: list, now: float) -> list:
        """Batched :meth:`on_complete` — ``completions`` is a list of
        ``(request_id, actual_output_tokens)`` pairs; each admitting
        pool settles its share in ONE vectorized ``settle_rows`` call.
        Returns a list aligned with the input:
        ``(pool name, entitlement, settled_tokens)`` per known request,
        ``None`` per unknown one.  Spill-debt transfers run after each
        pool's settle, in batch order — transfers touch only debt,
        which no settle reads, so per-pool results match the scalar
        interleaving exactly."""
        results: list = [None] * len(completions)
        if not completions:
            return results
        if len(self.pools) == 1:
            pool = next(iter(self.pools.values()))
            groups = {pool.spec.name: list(range(len(completions)))}
        else:
            groups = {}
            for i, (rid, _) in enumerate(completions):
                pool = self.find_pool_of(rid)
                if pool is not None:
                    groups.setdefault(pool.spec.name, []).append(i)
        for name, idxs in groups.items():
            pool = self.pools[name]
            batch = pool.on_complete_batch(
                [completions[i][0] for i in idxs],
                [completions[i][1] for i in idxs], now)
            known = batch.known
            ents = batch.entitlements
            settled = batch.settled_tokens
            for k, i in enumerate(idxs):
                if known[k]:
                    results[i] = (name, ents[k], float(settled[k]))
            for rec in batch.spills:
                self.transfer_spill_debt(rec, name, now)
        return results

    def on_evict(self, request_id: str, now: float
                 ) -> Optional[tuple[str, InFlight]]:
        pool = self.find_pool_of(request_id)
        if pool is None:
            return None
        rec = pool.on_evict(request_id, now)
        return (pool.spec.name, rec) if rec is not None else None

    # -- the batched accounting tick --------------------------------------------
    @hot_path
    def tick(self, now: float) -> dict[str, TickRecord]:
        """Tick EVERY pool, one ``control_tick_pools`` call per group of
        pools that share priority coefficients (the reference groups by
        its static jit argument) and a device.

        The stacked inputs are the pools' RESIDENT arrays: each pool's
        vectorized window fold runs in place, its device-mirrored state
        is padded to the group's (pow2) width — free slots and padding
        are both inert unbound rows — and the outputs are absorbed back
        into each store with vectorized row ops.  A group of one pool
        runs that pool's own ``tick``.  No per-entitlement Python
        anywhere on this path."""
        groups: dict[object, list[TokenPool]] = {}
        for pool in self.pools.values():
            groups.setdefault((pool.spec.coefficients, pool.store.device),
                              []).append(pool)

        records: dict[str, TickRecord] = {}
        for (coeff, dev), group in groups.items():
            if len(group) == 1:
                pool = group[0]
                records[pool.spec.name] = pool.tick(now)
                continue
            for p in group:
                p._measure(now)
            # store capacities are powers of two; the group width is the
            # widest store
            width = control_plane.bucket_width(
                max(p.store.capacity for p in group))

            def padded(k):
                out = np.zeros((len(group), width), np.float32)
                for i, p in enumerate(group):
                    out[i, :p.store.capacity] = p.store.col[k]
                return torch.from_numpy(out).to(dev)

            members = tuple(p.spec.name for p in group)
            key = (coeff, dev)
            cache = self._stack_cache.get(key)
            if (cache is not None and cache["members"] == members
                    and cache["width"] == width):
                states = cache["stacked"]
                stale = [k for k, p in enumerate(group)
                         if p.store.device_state()
                         is not cache["sources"][k]]
                if stale:
                    # splice only the changed pools' rows back in
                    # (device-side copies: the cached stack is never
                    # written, since the pools' states are views of it)
                    fields = {f.name: getattr(states, f.name).clone()
                              for f in dataclasses.fields(ControlState)}
                    for k in stale:
                        row = control_plane.pad_state(
                            group[k].store.device_state(), width)
                        for name, t in fields.items():
                            t[k] = getattr(row, name)
                    states = ControlState(**fields)
                    self.stack_restacks += len(stale)
                else:
                    self.stack_reuses += 1
            else:
                states = control_plane.stack_states(
                    [p.store.device_state() for p in group], width=width)
                self.stack_restacks += len(group)
            new_state, alloc, weights = control_plane.control_tick_pools(
                states,
                torch.tensor([p.capacity().tokens_per_second
                              for p in group], dtype=torch.float32,
                             device=dev),
                padded("measured_tps"),
                padded("kv_in_use"),
                padded("resident"),
                padded("demand_tps"),
                torch.tensor([p.pool_avg_slo() for p in group],
                             dtype=torch.float32, device=dev),
                coeff=coeff)
            alloc = alloc.cpu().numpy()
            weights = weights.cpu().numpy()
            sources: list[ControlState] = []
            for k, pool in enumerate(group):
                w = pool.store.capacity
                sliced = ControlState(**{
                    f.name: getattr(new_state, f.name)[k, :w]
                    for f in dataclasses.fields(ControlState)})
                records[pool.spec.name] = pool._absorb_tick(
                    now, sliced, alloc[k, :w], weights[k, :w])
                sources.append(pool.store.device_state())
            # the [P, W] output IS next tick's input stack: live rows
            # carry the adopted per-pool state bit for bit, and padding
            # rows are inert under the tick (zero baselines ⇒ zero burst
            # delta, unbound ⇒ zero debt)
            self._stack_cache[key] = {
                "members": members, "width": width,
                "stacked": new_state, "sources": sources}
        return records

    # -- fleet capacity planning -------------------------------------------------
    def migrate_entitlement(self, name: str, src: str, dst: str,
                            now: float = 0.0):
        """Move ``name`` from pool ``src`` to pool ``dst``, carrying
        its ledger bucket level, debt/burst, in-flight records and
        demand signal (invariants: ``core.fleet`` module docstring).
        The destination's authorized ceiling is raised first if a
        planner had shrunk it, so the arriving reserve does not
        spuriously degrade.  Returns the entitlement's state on the
        destination."""
        from repro_torch.core.autoscaler import replicas_for
        from repro_torch.core.types import ServiceClass

        spool, dpool = self.pools[src], self.pools[dst]
        espec = spool.entitlements[name]
        if dpool._authorized is not None \
                and espec.qos.service_class not in (
                    ServiceClass.SPOT, ServiceClass.PREEMPTIBLE):
            node = dpool.provider.node(dst)
            needed = replicas_for(node.allocated + espec.baseline,
                                  dpool.spec.per_replica)
            needed = min(int(np.ceil(min(needed, 1e9))),
                         dpool.spec.scaling.max_replicas)
            if needed > dpool._authorized:
                dpool.authorize_replicas(needed)
        mig = spool.detach_entitlement(name, now)
        try:
            return dpool.attach_entitlement(mig, now)
        except Exception:
            # roll back: re-adopt on the source so nothing is lost —
            # bucket level, debt/burst, charges and in-flight records
            # all travel back with the same migration payload
            spool.attach_entitlement(mig, now)
            raise

    def plan_quantum(self, now: float, records=None):
        """One closed-loop planning round for the fleet: batched tick →
        ONE ``plan_fleet`` call on the fleet's device → apply.

        Per decision the pool's PROMISE ceiling moves immediately
        (``authorize_replicas`` — a shrink below committed reservations
        preempts leases via the virtual-node scheduler pass), while
        LIVE replicas move through ``provision_hook`` when one is set
        (provisioning lag / drain modelling) or instantly otherwise.
        Rebalance proposals are then executed via
        :meth:`migrate_entitlement`.  Pass the tick's ``records`` to
        reuse an accounting tick this quantum already ran."""
        from repro_torch.core.fleet import FleetPlanner

        if records is None:
            records = self.tick(now)
        if self.planner is None:
            self.planner = FleetPlanner()
        plan = self.planner.plan(self.pools, records, now)
        for name, d in plan.decisions.items():
            pool = self.pools[name]
            if pool._authorized != d.desired:
                prev = (pool._authorized if pool._authorized is not None
                        else d.current)
                if prev != d.desired:
                    plan.scale_events[name] = (prev, d.desired)
                preempted = pool.authorize_replicas(d.desired)
                if preempted:
                    plan.preempted[name] = preempted
            if d.desired != d.current:
                if self.provision_hook is not None:
                    self.provision_hook(pool, d, now)
                else:
                    pool.set_replicas(d.desired)
        for prop in plan.migrations:
            # a pool can FAIL between planning and execution (the plan
            # and the outage land in the same quantum): migrating into
            # a dead pool would strand the entitlement behind zero
            # capacity, so the proposal is skipped — the planner will
            # re-propose next round if the target recovers
            if not self.available(prop.dst):
                plan.skipped.append(prop)
                continue
            self.migrate_entitlement(prop.entitlement, prop.src,
                                     prop.dst, now)
            plan.applied.append(prop)
        return plan


PoolOrManager = Union[TokenPool, PoolManager]


def as_manager(pools: PoolOrManager) -> PoolManager:
    """Wrap a bare TokenPool into a single-pool manager (legacy API)."""
    if isinstance(pools, PoolManager):
        return pools
    return PoolManager([pools])
