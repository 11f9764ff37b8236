"""TokenPool controller — allocation, reclamation, debt accounting.

Realises paper §3–§4: a pool aggregates backend replicas into capacity
(Λ_p tokens/s, X_p KV bytes, R_p concurrency); entitlements hold
baselines (λ_e, χ_e, r_e) with a service class; every accounting tick
the controller

  1. measures per-entitlement usage (tokens completed, KV resident,
     in-flight sequences),
  2. updates burst intensity b_e (Eq. 3 EWMA),
  3. computes effective allocations λ̂_e by priority-weighted
     water-filling with the Table-1 protection ordering
     (dedicated/guaranteed reserved even when idle → elastic baselines,
     shrunk under scarcity → work-conserving backfill of surplus to
     burst-eligible classes),
  4. updates service debt d_e (Eq. 2) for debt-bearing classes,
  5. pushes λ̂_e into the token-bucket ledger that funds admission.

Steps 2–4 execute on the UNIFIED control plane
(``core.control_plane.control_tick``).  State ownership is RESIDENT
(``core.resident``): every control-plane column — statics, the
burst/debt EWMAs, window accumulators, KV/concurrency in use, token
bucket levels — lives in one structure-of-arrays per pool, padded to a
power-of-two capacity with free-slot recycling, mirrored as a cached
device ``ControlState``.  ``pool.status[name]`` hands out
``ResidentStatus`` VIEWS over rows (dicts are views, arrays are
truth), the accounting-window fold in :meth:`TokenPool._measure` is a
handful of vectorized column expressions, and :meth:`TokenPool.tick`
runs the tick directly over the resident arrays on the store's
device — per-tick Python work does not scale with the entitlement
count.  The scalar dict-loop oracle (``reference_tick``) stays in the
JAX package; ``waterfill`` below is its water-filling step.

Entitlement *creation* is admitted through the virtual-node scheduler
(`core.virtual_node`) against the pool's entitleable capacity
(per-replica × maxReplicas): a pool never promises more than it could
ever provision.  Runtime capacity (per-replica × live replicas) is what
allocation and admission run against, so replica failure shows up as
scarcity — shrinking elastic tenants and accruing debt — exactly the
paper's Experiment 2.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core import control_plane, priority as prio
from repro_torch.core.control_plane import CLASS_CODES, ControlState
from repro_torch.core.ledger import Ledger
from repro_torch.core.markers import hot_path
from repro_torch.core.request_table import InFlight, InFlightMap, RequestTable
from repro_torch.core.resident import ResidentStatus, ResidentStore, _DictView
from repro_torch.core.types import (
    EntitlementSpec,
    EntitlementState,
    EntitlementStatus,
    PoolSpec,
    Resources,
    ServiceClass,
)
from repro_torch.core.virtual_node import LeasePod, VirtualNodeProvider

__all__ = [  # noqa: F822 — InFlight re-exported from request_table
    "EntitlementMigration", "InFlight", "SettleBatch", "TickInputs",
    "TickRecord", "TokenPool", "waterfill",
]

#: class codes (DED/GUAR/ELASTIC) whose baseline counts toward the
#: reserved provisioning floor — see ``TokenPool.reserved_baseline``.
_RESERVING_CLASS = np.array([True, True, True, False, False])

#: Eq. 1 class weight by class CODE (f64 — mirrors the exact
#: ``priority.CLASS_WEIGHT`` values for the vectorized threshold).
_CLASS_WEIGHT_F64 = np.zeros(len(CLASS_CODES), np.float64)
for _sc, _code in CLASS_CODES.items():
    _CLASS_WEIGHT_F64[_code] = prio.CLASS_WEIGHT[_sc]
del _sc, _code


@dataclasses.dataclass
class SettleBatch:
    """Result of one batched settle/evict row-op, aligned with the
    input request ids (``known[i]`` False → unknown id, nothing
    changed for it)."""

    #: request id had an in-flight record
    known: np.ndarray
    #: owning entitlement per request (None where unknown)
    entitlements: list
    #: actual settled token cost per request (0.0 where unknown or
    #: uncharged; always 0.0 for evictions)
    settled_tokens: np.ndarray
    #: MATERIALIZED records of requests admitted via a spill leg
    #: (``spill_from`` set) — what cross-pool debt transfer consumes
    spills: list


@dataclasses.dataclass
class TickInputs:
    """Gathered per-tick state, ready for ``control_tick``.  Produced by
    ``TokenPool.begin_tick`` (live rows, compacted in slot order, on the
    pool's device); ``PoolManager`` batches pools on the full resident
    arrays instead."""

    names: list[str]
    state: ControlState
    capacity_tps: float
    measured_tps: torch.Tensor
    used_kv: torch.Tensor
    used_conc: torch.Tensor
    demand_tps: torch.Tensor
    avg_slo_ms: float


@dataclasses.dataclass
class EntitlementMigration:
    """Everything one entitlement owns, detached from its pool and
    ready to re-attach elsewhere (``PoolManager.migrate_entitlement``).

    Invariants (documented in ``core.fleet``): the ledger bucket keeps
    its accrued level and outstanding charges, the status keeps debt /
    burst / usage counters, and in-flight records follow the
    entitlement so completions settle on the NEW owner.  The payload is
    fully MATERIALIZED (plain ``EntitlementStatus`` / ``TokenBucket``):
    the source row is recycled the moment the entitlement detaches."""

    espec: EntitlementSpec
    status: EntitlementStatus
    bucket: object                       # Optional[TokenBucket]
    charges: list
    in_flight: list
    demand_window: float
    demand_tps: float


class TickRecord:
    """Per-tick observability snapshot (drives the experiment figures).

    The resident tick hands this class raw kernel-output ARRAYS; the
    per-name dicts (``allocations``/``priorities``/``debts``/…) are
    materialized lazily on first access and cached — observability
    costs nothing until somebody looks.  The dict-kwargs constructor is
    kept for oracles and tests that build records by hand."""

    _DICT_FIELDS = ("allocations", "priorities", "debts", "bursts",
                    "in_flight", "demand_tps")
    __slots__ = ("t", "capacity_tps", "_names", "_arrays", "_cache")

    def __init__(self, t: float, capacity_tps: float,
                 allocations: Optional[dict] = None,
                 priorities: Optional[dict] = None,
                 debts: Optional[dict] = None,
                 bursts: Optional[dict] = None,
                 in_flight: Optional[dict] = None,
                 demand_tps: Optional[dict] = None) -> None:
        self.t = t
        self.capacity_tps = capacity_tps
        self._names: Optional[list[str]] = None
        self._arrays: Optional[dict] = None
        self._cache = {
            "allocations": {} if allocations is None else allocations,
            "priorities": {} if priorities is None else priorities,
            "debts": {} if debts is None else debts,
            "bursts": {} if bursts is None else bursts,
            "in_flight": {} if in_flight is None else in_flight,
            "demand_tps": {} if demand_tps is None else demand_tps,
        }

    @classmethod
    def from_arrays(cls, t: float, capacity_tps: float, names: list[str],
                    allocations: np.ndarray, priorities: np.ndarray,
                    debts: np.ndarray, bursts: np.ndarray,
                    in_flight: np.ndarray, demand_tps: np.ndarray
                    ) -> "TickRecord":
        """Lazy record over compact per-live-row arrays (row i ↔
        ``names[i]``).  The arrays must be snapshots the caller will
        not mutate."""
        rec = cls(t, capacity_tps)
        rec._names = names
        rec._arrays = {
            "allocations": allocations, "priorities": priorities,
            "debts": debts, "bursts": bursts, "in_flight": in_flight,
            "demand_tps": demand_tps,
        }
        rec._cache = {}
        return rec

    def _dict(self, key: str) -> dict:
        d = self._cache.get(key)
        if d is None:
            conv = int if key == "in_flight" else float
            arr = self._arrays[key]
            d = {n: conv(arr[i]) for i, n in enumerate(self._names)}
            self._cache[key] = d
        return d

    @property
    def allocations(self) -> dict:
        return self._dict("allocations")

    @property
    def priorities(self) -> dict:
        return self._dict("priorities")

    @property
    def debts(self) -> dict:
        return self._dict("debts")

    @property
    def bursts(self) -> dict:
        return self._dict("bursts")

    @property
    def in_flight(self) -> dict:
        return self._dict("in_flight")

    @property
    def demand_tps(self) -> dict:
        return self._dict("demand_tps")

    def __repr__(self) -> str:
        return (f"TickRecord(t={self.t}, capacity_tps={self.capacity_tps},"
                f" rows={len(self._names) if self._names is not None else len(self._cache.get('allocations', {}))})")


def waterfill(capacity: float, want: dict[str, float],
              weight: dict[str, float]) -> dict[str, float]:
    """Priority-weighted progressive water-filling.

    Distributes ``capacity`` across keys proportionally to ``weight``,
    capping each key at ``want[key]`` and re-distributing the excess to
    still-unsatisfied keys.  Work-conserving: either every want is met
    or the full capacity is used.
    """
    alloc = {k: 0.0 for k in want}
    remaining = max(0.0, capacity)
    active = {k for k, w in want.items() if w > 1e-12}
    while remaining > 1e-9 and active:
        total_w = sum(weight[k] for k in active)
        if total_w <= 0:
            # equal split among zero-weight entitlements
            share = {k: remaining / len(active) for k in active}
        else:
            share = {k: remaining * weight[k] / total_w for k in active}
        done = set()
        used = 0.0
        for k in list(active):
            room = want[k] - alloc[k]
            take = min(room, share[k])
            alloc[k] += take
            used += take
            if alloc[k] >= want[k] - 1e-12:
                done.add(k)
        remaining -= used
        if not done:        # all shares landed below caps → finished
            break
        active -= done
    return alloc


class TokenPool:
    """The TokenPool controller (one instance per pool CRD)."""

    def __init__(self, spec: PoolSpec,
                 provider: Optional[VirtualNodeProvider] = None,
                 now: float = 0.0, device="cuda") -> None:
        self.spec = spec
        self.provider = provider or VirtualNodeProvider()
        self.replicas = spec.scaling.min_replicas
        #: the resident structure-of-arrays — source of truth for every
        #: control-plane column (``core.resident``); its device mirror,
        #: and so the tick, lives on ``device``
        if spec.shards is not None and spec.shards > 1:
            raise NotImplementedError(
                "PoolSpec(shards=...) — the sharded control plane is "
                "ROADMAP queue A, 'sharding'")
        self.store = ResidentStore(device=device)
        #: the resident request table — source of truth for every
        #: in-flight record and outstanding charge
        #: (``core.request_table``)
        self.table = RequestTable(self.store)
        self.entitlements: dict[str, EntitlementSpec] = {}
        #: name → ResidentStatus VIEW over the entitlement's row
        self.status: dict[str, ResidentStatus] = {}
        self.ledger = Ledger(burst_window_s=spec.bucket_window_s,
                             store=self.store, table=self.table)
        #: request id → InFlightRow VIEW over the request's row
        self.in_flight: InFlightMap = InFlightMap(self.table)
        #: bounded tick history (spec.history_maxlen; None = unbounded)
        self.history: deque = deque(maxlen=spec.history_maxlen)
        self._last_tick = now
        #: optional ``repro_torch.telemetry.Telemetry`` sink (set by
        #: ``Telemetry.attach_pool``); when present every tick emits a
        #: duration sample + water-fill/debt gauges + a trace slice
        self.telemetry = None
        self._tick_t0 = 0.0
        #: TTL deadlines for the (rare) entitlements that declare one —
        #: expiry scans these, not the whole membership
        self._ttl_deadline: dict[str, float] = {}
        # Replica count last AUTHORIZED by the fleet planner (None until
        # a planner has run: the virtual node then still advertises the
        # full entitleable ceiling).
        self._authorized: Optional[int] = None
        # Entitleable capacity: what may ever be promised (maxReplicas).
        self.provider.create_node(spec.name, self.entitleable_capacity())

    # -- capacity -------------------------------------------------------------
    def entitleable_capacity(self) -> Resources:
        return self.spec.per_replica.scale(self.spec.scaling.max_replicas)

    def capacity(self) -> Resources:
        """Runtime capacity from live replicas."""
        return self.spec.per_replica.scale(self.replicas)

    def set_replicas(self, n: int, planned: bool = False) -> list[str]:
        """Autoscaler / failure-injection entry point.

        ``planned=False`` (failure injection, recovery, the scalar
        oracle) moves RUNTIME capacity only: the virtual node keeps its
        promise ceiling, entitlements stay bound, and the scarcity
        shows up as shrunken allocations + debt (paper Exp. 2 — an
        outage must not unbind tenants).  ``planned=True`` (the fleet
        planner) is a deliberate capacity decision: the promise ceiling
        moves with it through :meth:`authorize_replicas`, preempting
        the least-protected leases if the committed reservations no
        longer fit.  Returns the preempted entitlement names (always
        empty for unplanned changes)."""
        self.replicas = max(0, n)
        if planned:
            return self.authorize_replicas(n)
        return []

    def authorize_replicas(self, n: int) -> list[str]:
        """Move the virtual node's promise ceiling to ``n`` replicas
        (the fleet planner's decision).  A shrink below the committed
        lease reservations preempts in reverse-protection order (the
        §4.1 scheduler pass); a grow reschedules pending leases.
        Entitlement states are re-synced from the lease outcomes —
        preempted entitlements degrade, re-bound ones recover.
        Returns the entitlement names whose leases were preempted."""
        n = max(0, int(n))
        self._authorized = n
        preempted = self.provider.set_capacity(
            self.spec.name, self.spec.per_replica.scale(n))
        self._sync_lease_states()
        prefix = "lease-"
        return [name[len(prefix):] for name in preempted
                if name.startswith(prefix)]

    def _sync_lease_states(self) -> None:
        """Reconcile entitlement Bound/Degraded states with the actual
        lease bind outcomes after a virtual-node capacity change."""
        for name, st in self.status.items():
            if st.state not in (EntitlementState.BOUND,
                                EntitlementState.DEGRADED):
                continue
            bound = self.provider.is_bound(f"lease-{name}")
            st.state = (EntitlementState.BOUND if bound
                        else EntitlementState.DEGRADED)

    def reserved_baseline(self) -> Resources:
        """Σ baselines the pool has promised to keep provisionable —
        dedicated/guaranteed/elastic entitlements in Bound OR Degraded
        state (a Degraded promise is precisely what the planner must
        raise capacity for).  Spot/preemptible reserve nothing.  This
        is the reserved floor of the scale policy (``core.autoscaler``
        / ``core.fleet``) — computed as three masked column sums over
        the resident arrays."""
        from repro_torch.core.resident import STATE_CODES
        c = self.store.col
        sc = c["state_code"]
        mask = (c["alive"]
                & ((sc == STATE_CODES[EntitlementState.BOUND])
                   | (sc == STATE_CODES[EntitlementState.DEGRADED]))
                & _RESERVING_CLASS[c["class_code"]])
        return Resources(
            float(np.sum(c["baseline_tps"][mask], dtype=np.float64)),
            float(np.sum(c["baseline_kv"][mask], dtype=np.float64)),
            float(np.sum(c["baseline_conc"][mask], dtype=np.float64)))

    def demand_snapshot(self) -> dict[str, float]:
        """Public copy of the per-entitlement demand EWMA (tok/s) the
        accounting tick maintains — the same values the latest
        ``TickRecord.demand_tps`` carries.  Planners read THIS, never
        the resident columns directly."""
        col = self.store.col["demand_tps"]
        return {n: float(col[s]) for n, s in self.store.slot_of.items()}

    def demand_total_tps(self) -> float:
        """Σ demand EWMA over the pool — one masked column sum (what
        fleet planning aggregates per pool)."""
        return float(np.sum(
            self.store.col["demand_tps"][self.store.col["alive"]]))

    # -- legacy private surfaces (dict facades over the columns) --------------
    @property
    def _demand_tps(self) -> _DictView:
        return _DictView(self.store, "demand_tps")

    @property
    def _demand_window(self) -> _DictView:
        return _DictView(self.store, "demand_window")

    # -- entitlement lifecycle --------------------------------------------------
    def _write_statics(self, slot: int, espec: EntitlementSpec) -> None:
        """Spec-derived static columns for one row — the single place
        both `add_entitlement` and `attach_entitlement` initialize
        from, so a future static column cannot diverge between the
        create and migration paths."""
        c = self.store.col
        c["class_code"][slot] = CLASS_CODES[espec.qos.service_class]
        c["baseline_tps"][slot] = espec.baseline.tokens_per_second
        c["baseline_kv"][slot] = espec.baseline.kv_bytes
        c["baseline_conc"][slot] = espec.baseline.concurrency
        c["slo_ms"][slot] = espec.qos.slo_target_ms
        # Both callers later write st.state (which invalidates), but the
        # mirror contract is per-write: statics land → mirror drops.
        self.store.mark_dirty()

    def add_entitlement(self, espec: EntitlementSpec, now: float = 0.0
                        ) -> EntitlementState:
        slot = self.store.allocate(espec.name)
        self.entitlements[espec.name] = espec
        self._write_statics(slot, espec)
        self.store.col["created_at"][slot] = now
        st = ResidentStatus(self.store, slot)
        self.status[espec.name] = st
        if espec.ttl_s is not None:
            self._ttl_deadline[espec.name] = now + espec.ttl_s
        # Lease request: protected + elastic reserve their baseline on
        # the virtual node; spot/preemptible request nothing.
        reserve = (espec.baseline
                   if espec.qos.service_class not in
                   (ServiceClass.SPOT, ServiceClass.PREEMPTIBLE)
                   else Resources.zero())
        lease = LeasePod(
            name=f"lease-{espec.name}",
            entitlement=espec.name,
            request=reserve,
            protection_weight=prio.CLASS_WEIGHT[espec.qos.service_class],
        )
        bound = self.provider.submit(self.spec.name, lease)
        st.state = EntitlementState.BOUND if bound else EntitlementState.DEGRADED
        # Fund the bucket at baseline immediately; ticks refine it.
        self.ledger.ensure(espec.name, espec.baseline.tokens_per_second, now)
        return st.state

    def remove_entitlement(self, name: str, now: float = 0.0) -> None:
        """Tear down an entitlement COMPLETELY.  Every piece of state
        keyed by the name must go: surviving in-flight records would
        make a later ``on_complete``/``on_evict`` KeyError on the
        missing status row, a surviving ledger bucket would keep
        refilling a dead tenant's budget, and a surviving resident row
        would leak into every future tick.  The freed row is zeroed
        (inert under every kernel mask) and recycled."""
        self.provider.delete(f"lease-{name}")
        # evict in-flight requests first (status row must still exist):
        # charges are refunded, then the whole bucket is dropped anyway
        slot = self.store.slot_of.get(name)
        if slot is not None:
            rows = self.table.record_slots_of_owner(slot)
            if rows.size:
                self.evict_rows([self.table.rid_of[s] for s in rows], now)
        self.entitlements.pop(name, None)
        self.status.pop(name, None)
        self.ledger.drop(name)
        self._ttl_deadline.pop(name, None)
        if name in self.store:
            self.store.release(name)
        # the freed reservation may have re-bound pending leases
        self._sync_lease_states()

    def detach_entitlement(self, name: str, now: float = 0.0
                           ) -> EntitlementMigration:
        """Detach an entitlement for migration to another pool
        (``PoolManager.migrate_entitlement``).  Unlike
        :meth:`remove_entitlement` nothing is forgotten: the ledger
        bucket (accrued level + outstanding charges), the status row
        (debt, burst, usage counters), the in-flight records and the
        demand signal are all MATERIALIZED into the migration payload
        — only the lease reservation is released here, and the
        resident row is recycled."""
        if name not in self.entitlements:
            raise KeyError(f"no entitlement {name!r} in pool "
                           f"{self.spec.name!r}")
        self.provider.delete(f"lease-{name}")
        # MATERIALIZE in-flight records before their rows die (the
        # charge halves go separately through ``ledger.detach``)
        t = self.table
        rows = t.record_slots_of_owner(self.store.slot_of[name])
        recs = [t.materialize_record(s) for s in rows]
        for s in rows:
            t.clear_record(int(s))
        bucket, charges = self.ledger.detach(name)
        slot = self.store.slot_of[name]
        c = self.store.col
        mig = EntitlementMigration(
            espec=self.entitlements.pop(name),
            status=self.store.snapshot_status(name),
            bucket=bucket, charges=charges, in_flight=recs,
            demand_window=float(c["demand_window"][slot]),
            demand_tps=float(c["demand_tps"][slot]))
        self.status.pop(name, None)
        self._ttl_deadline.pop(name, None)
        self.store.release(name)
        # the freed reservation may have re-bound a previously
        # preempted/pending lease — Degraded stickiness here would deny
        # a now-bound tenant with NOT_BOUND until the next authorize
        self._sync_lease_states()
        return mig

    def attach_entitlement(self, mig: EntitlementMigration,
                           now: float = 0.0) -> EntitlementState:
        """Adopt a migrated entitlement: submit its lease on THIS
        pool's virtual node (baseline reserve, same rule as
        :meth:`add_entitlement`) and restore every piece of carried
        state into a fresh resident row.  Debt is preserved verbatim —
        an underserved tenant arrives at the new pool with the
        priority boost it is owed (cross-pool debt, ROADMAP item 4)."""
        espec = mig.espec
        name = espec.name
        if name in self.entitlements:
            raise ValueError(f"entitlement {name!r} already in pool "
                             f"{self.spec.name!r}")
        espec.pool = self.spec.name
        slot = self.store.allocate(name)
        self.entitlements[name] = espec
        self._write_statics(slot, espec)
        self.store.load_status(slot, mig.status)
        st = ResidentStatus(self.store, slot)
        self.status[name] = st
        if espec.ttl_s is not None:
            self._ttl_deadline[name] = mig.status.created_at + espec.ttl_s
        reserve = (espec.baseline
                   if espec.qos.service_class not in
                   (ServiceClass.SPOT, ServiceClass.PREEMPTIBLE)
                   else Resources.zero())
        lease = LeasePod(
            name=f"lease-{name}",
            entitlement=name,
            request=reserve,
            protection_weight=prio.CLASS_WEIGHT[espec.qos.service_class],
        )
        bound = self.provider.submit(self.spec.name, lease)
        st.state = (EntitlementState.BOUND if bound
                    else EntitlementState.DEGRADED)
        if mig.bucket is not None:
            self.ledger.attach(name, mig.bucket, mig.charges, now)
        else:
            self.ledger.ensure(name, espec.baseline.tokens_per_second, now)
            self.ledger.attach(name, None, mig.charges, now)
        for rec in mig.in_flight:
            self.in_flight[rec.request_id] = rec
        self.store.col["demand_window"][slot] = mig.demand_window
        self.store.col["demand_tps"][slot] = mig.demand_tps
        return st.state

    def expire_entitlements(self, now: float) -> None:
        """TTL pass — scans only the entitlements that DECLARE a TTL
        (deadlines indexed at add/attach), so the common no-TTL pool
        pays nothing here."""
        if not self._ttl_deadline:
            return
        for name in [n for n, dl in self._ttl_deadline.items()
                     if now >= dl]:
            del self._ttl_deadline[name]
            st = self.status.get(name)
            if st is None or st.state == EntitlementState.EXPIRED:
                continue
            st.state = EntitlementState.EXPIRED
            self.provider.delete(f"lease-{name}")

    # -- priority --------------------------------------------------------------
    def pool_avg_slo(self) -> float:
        if self.spec.fixed_avg_slo_ms is not None:
            return self.spec.fixed_avg_slo_ms
        bound = self.store.col["bound"]
        n = int(np.count_nonzero(bound))
        if n == 0:
            return prio.pool_average_slo([])
        return float(np.sum(self.store.col["slo_ms"][bound],
                            dtype=np.float64) / n)

    def priority(self, name: str) -> float:
        """Live Eq. 1 weight for ONE entitlement (admission check 5).

        Single-request admission is inherently scalar, so this uses the
        scalar oracle directly; the accounting tick computes the same
        weights for ALL rows on the vectorized control plane (pinned
        equal by ``tests/test_control_plane.py``)."""
        espec = self.entitlements[name]
        st = self.status[name]
        return prio.priority_weight(
            espec.qos.service_class,
            espec.qos.slo_target_ms,
            self.pool_avg_slo(),
            st.burst,
            st.debt,
            self.spec.coefficients,
        )

    # -- in-flight bookkeeping (called by admission / completion) -----------------
    def register_admit(self, rec: InFlight, demand_tokens: float) -> None:
        st = self.status[rec.entitlement]
        st.in_flight += 1
        st.kv_bytes_in_use += rec.kv_bytes
        st.admitted_total += 1
        self.table.put_record(rec)
        slot = self.store.slot_of[rec.entitlement]
        self.store.col["demand_window"][slot] += demand_tokens

    @hot_path
    def register_admit_batch(self, recs: list[InFlight],
                             demand_tokens: dict[str, float]) -> None:
        """One scheduling quantum's admits in a single call — same
        bookkeeping as :meth:`register_admit`, but as masked
        scatter-adds on the store columns (``np.add.at`` applies
        updates in request order, so the f64 KV accumulation matches
        the scalar loop bit for bit) plus one batched row insertion
        into the request table."""
        if recs:
            slot_of = self.store.slot_of
            n = len(recs)
            owners = np.fromiter(
                (slot_of[r.entitlement] for r in recs),
                np.int64, count=n)
            self.table.put_records(recs, owners)
            sc = self.store.col
            np.add.at(sc["in_flight"], owners, 1)
            np.add.at(sc["kv_in_use"], owners, np.fromiter(
                (r.kv_bytes for r in recs), np.float64, count=n))
            np.add.at(sc["admitted_total"], owners, 1)
        window = self.store.col["demand_window"]
        for ent, tokens in demand_tokens.items():
            window[self.store.slot_of[ent]] += tokens

    @hot_path
    def admit_rows(self, request_ids: list, owners: np.ndarray,
                   kv_bytes: np.ndarray, charged_tokens: np.ndarray,
                   now: float,
                   demand_tokens: Optional[dict] = None,
                   slots: Optional[np.ndarray] = None) -> np.ndarray:
        """Array-native :meth:`register_admit_batch` — the gateway
        quantum hot path: no per-request ``InFlight`` objects, row
        insertion and counter updates are batched column ops.
        ``slots`` skips id resolution when the caller already holds
        the rows (``Ledger.charge_rows`` returns them).  Returns the
        new row slots (the caller tags spill legs on them)."""
        slots = self.table.admit_rows(
            request_ids, owners, kv_bytes, charged_tokens, now,
            slots=slots)
        sc = self.store.col
        np.add.at(sc["in_flight"], owners, 1)
        np.add.at(sc["kv_in_use"], owners, kv_bytes)
        np.add.at(sc["admitted_total"], owners, 1)
        if demand_tokens:
            window = sc["demand_window"]
            slot_of = self.store.slot_of
            for ent, tokens in demand_tokens.items():
                window[slot_of[ent]] += tokens
        return slots

    def register_deny(self, entitlement: str, demand_tokens: float,
                      low_priority: bool) -> None:
        st = self.status[entitlement]
        st.denied_total += 1
        if low_priority:
            st.denied_low_priority += 1
        # Denied demand still counts as demand (drives backfill/scaling).
        slot = self.store.slot_of[entitlement]
        self.store.col["demand_window"][slot] += demand_tokens

    @hot_path
    def register_deny_batch(self, entitlements: list,
                            demand_tokens: np.ndarray,
                            low_priority: np.ndarray) -> None:
        """One scheduling quantum's denials as masked scatter-adds —
        same bookkeeping as :meth:`register_deny` per element."""
        if not entitlements:
            return
        slot_of = self.store.slot_of
        # repro: allow[hot-path-scalar-loop] -- C-speed fromiter gather; a name->slot dict lookup has no vectorized form
        slots = np.fromiter((slot_of[e] for e in entitlements),
                            np.int64, count=len(entitlements))
        sc = self.store.col
        np.add.at(sc["denied_total"], slots, 1)
        lp = np.asarray(low_priority, bool)
        if lp.any():
            np.add.at(sc["denied_low_priority"], slots[lp], 1)
        np.add.at(sc["demand_window"], slots,
                  np.asarray(demand_tokens, np.float64))

    def on_start(self, request_id: str) -> None:
        """Backend callback: the request acquired a decode slot (its KV
        is now resident) — this is what §3.1's concurrency r counts."""
        t = self.table
        slot = t.slot_of.get(request_id)
        if slot is None or not t.col["has_record"][slot] \
                or t.col["resident"][slot]:
            return
        t.col["resident"][slot] = True
        owner = int(t.col["owner"][slot])
        self.store.col["resident"][owner] += 1

    def on_complete(self, request_id: str, actual_output_tokens: int,
                    now: float) -> Optional[InFlight]:
        """Gateway completion callback (paper §4.3): settle the charge,
        update usage counters that feed burst/debt at the next tick.

        This is the retained scalar ORACLE for :meth:`settle_rows`
        (pinned equal by ``tests/test_request_lifecycle.py``).

        Returns the settled ``InFlight`` record (None if unknown),
        MATERIALIZED — the row is recycled by the time this returns,
        and read-after-call on ``self.in_flight`` would silently miss.
        The record's ``settled_tokens`` is stamped with the actual
        cost."""
        t = self.table
        slot = t.slot_of.get(request_id)
        if slot is None or not t.col["has_record"][slot]:
            return None
        rec = t.materialize_record(slot)
        st = self.status[rec.entitlement]
        st.in_flight = max(0, st.in_flight - 1)
        if rec.resident:
            st.resident = max(0, st.resident - 1)
        st.kv_bytes_in_use = max(0.0, st.kv_bytes_in_use - rec.kv_bytes)
        st.completed_total += 1
        t.clear_record(slot)
        actual = self.ledger.settle(request_id, actual_output_tokens, now)
        st.window_tokens += actual
        st.tokens_total += actual
        rec.settled_tokens = actual
        return rec

    def on_evict(self, request_id: str, now: float) -> Optional[InFlight]:
        """Request terminated before completion (preemption/failure).
        Scalar oracle for :meth:`evict_rows`.  Returns the evicted
        ``InFlight`` record (None if unknown), materialized."""
        t = self.table
        slot = t.slot_of.get(request_id)
        if slot is None or not t.col["has_record"][slot]:
            return None
        rec = t.materialize_record(slot)
        st = self.status[rec.entitlement]
        st.in_flight = max(0, st.in_flight - 1)
        if rec.resident:
            st.resident = max(0, st.resident - 1)
        st.kv_bytes_in_use = max(0.0, st.kv_bytes_in_use - rec.kv_bytes)
        t.clear_record(slot)
        self.ledger.cancel(request_id, now)
        return rec

    # -- batched request lifecycle (the vectorized row-ops) -----------------------
    @hot_path
    def _lifecycle_rows(self, request_ids: list) -> tuple:
        """Resolve a batch of request ids to live record rows.  Returns
        ``(known mask, row slots of the known ids, entitlements list)``
        — the only per-request Python in the batched lifecycle (a dict
        hit and a list index per id)."""
        t = self.table
        n = len(request_ids)
        known = np.zeros(n, bool)
        slots = np.zeros(n, np.int64)
        get = t.slot_of.get
        has = t.col["has_record"]
        for i, rid in enumerate(request_ids):
            s = get(rid)
            if s is not None and has[s]:
                known[i] = True
                slots[i] = s
        ents: list = [None] * n
        ks = slots[known]
        if ks.size:
            name_of = self.store.name_of
            owners = t.col["owner"][ks]
            for i, o in zip(np.flatnonzero(known).tolist(),
                            owners.tolist()):
                ents[i] = name_of[o]
        return known, ks, ents

    @hot_path
    def _fold_record_rows(self, ks: np.ndarray, owners: np.ndarray,
                          completed: bool) -> None:
        """Fold a batch of record-half teardowns into the store
        columns.  Bit-parity with the scalar loop: ``np.add.at`` is
        unbuffered and applies in index order (the same f64 chain as
        sequential updates), and clamping ONCE after all decrements
        equals the scalar clamp-each — decrements are monotone, so
        once the running value hits the clamp floor every later scalar
        step re-clamps to the same 0."""
        c = self.table.col
        sc = self.store.col
        np.add.at(sc["in_flight"], owners, -1)
        res = c["resident"][ks]
        if res.any():
            np.add.at(sc["resident"], owners[res], -1)
        np.add.at(sc["kv_in_use"], owners, -c["kv_bytes"][ks])
        if completed:
            np.add.at(sc["completed_total"], owners, 1)
        touched = np.unique(owners)
        sc["in_flight"][touched] = np.maximum(
            sc["in_flight"][touched], 0)
        sc["resident"][touched] = np.maximum(
            sc["resident"][touched], 0)
        sc["kv_in_use"][touched] = np.maximum(
            sc["kv_in_use"][touched], 0.0)

    @hot_path
    def settle_rows(self, request_ids: list, actual_output_tokens,
                    now: float) -> SettleBatch:
        """One quantum's completions as vectorized row-ops — the
        batched :meth:`on_complete` (``on_complete_batch`` is the
        threaded alias).  Refunds, window/usage counters and
        kv/in-flight/resident decrements fold into masked column
        updates; rows release in batch order, so future slot recycling
        matches a scalar loop.  Each request id must appear at most
        once per batch.  Returns a :class:`SettleBatch` aligned with
        the inputs."""
        known, ks, ents = self._lifecycle_rows(request_ids)
        n = len(request_ids)
        settled = np.zeros(n, np.float64)
        spills: list = []
        if not ks.size:
            return SettleBatch(known, ents, settled, spills)
        t = self.table
        c = t.col
        owners = c["owner"][ks].astype(np.int64)
        self._fold_record_rows(ks, owners, completed=True)
        actual = self.ledger.settle_rows(
            ks, np.asarray(actual_output_tokens, np.int64)[known], now)
        settled[known] = actual
        sc = self.store.col
        np.add.at(sc["window_tokens"], owners, actual)
        np.add.at(sc["tokens_total"], owners, actual)
        spill = t.spill_from
        hits = [(j, int(s)) for j, s in enumerate(ks.tolist())
                if spill[s] is not None]
        if hits:
            for j, s in hits:
                rec = t.materialize_record(s)
                rec.settled_tokens = float(actual[j])
                spills.append(rec)
        t.release_rows(ks)
        return SettleBatch(known, ents, settled, spills)

    @hot_path
    def evict_rows(self, request_ids: list, now: float) -> SettleBatch:
        """One batch of evictions as vectorized row-ops — the batched
        :meth:`on_evict`: full refunds, usage decrements, no completion
        counters.  Returns a :class:`SettleBatch` (``settled_tokens``
        all zero — evictions settle nothing)."""
        known, ks, ents = self._lifecycle_rows(request_ids)
        settled = np.zeros(len(request_ids), np.float64)
        if not ks.size:
            return SettleBatch(known, ents, settled, [])
        owners = self.table.col["owner"][ks].astype(np.int64)
        self._fold_record_rows(ks, owners, completed=False)
        self.ledger.cancel_rows(ks, now)
        self.table.release_rows(ks)
        return SettleBatch(known, ents, settled, [])

    @hot_path
    def on_complete_batch(self, request_ids: list, actual_output_tokens,
                          now: float) -> SettleBatch:
        """Batched :meth:`on_complete` — one vectorized settle per
        scheduling quantum (threaded through ``PoolManager`` and
        ``Gateway``; the simulators drain completions once per step)."""
        return self.settle_rows(request_ids, actual_output_tokens, now)

    def gauges(self) -> dict:
        """Pool-level observability gauges as zero-arg callables — the
        single source both ``stats()`` (the legacy dict view) and the
        telemetry registry (``Telemetry.attach_pool`` binds each
        callable as a ``repro_pool_*`` gauge series) read through."""
        return {
            "in_flight": self.pool_in_flight,
            "resident": self.total_resident,
            "request_rows": lambda: self.table.capacity,
            "unknown_settles": lambda: self.ledger.unknown_settles,
        }

    def stats(self) -> dict:
        """Pool-level observability counters (request lifecycle) —
        a thin evaluation of :meth:`gauges`."""
        return {name: fn() for name, fn in self.gauges().items()}

    def audit_snapshot(self) -> dict:
        """Cheap public consistency snapshot for external invariant
        checkers (the chaos harness runs these after every quantum).
        Everything here is a masked column reduction — no per-row
        Python, no device sync, no state mutation.

        ``per_slot_in_flight`` / ``per_slot_resident`` recount the
        request table by owner (bincount over record rows), so a
        checker can diff them against the store's ``in_flight`` /
        ``resident`` counters without touching private columns."""
        sc = self.store.col
        tc = self.table.col
        alive = sc["alive"]
        width = self.store.capacity
        has_rec = tc["has_record"]
        owners = tc["owner"][has_rec].astype(np.int64)
        per_slot_in_flight = np.bincount(owners, minlength=width)
        res_owners = tc["owner"][has_rec & tc["resident"]].astype(np.int64)
        per_slot_resident = np.bincount(res_owners, minlength=width)
        live = np.flatnonzero(alive)
        return {
            "store": self.store.row_accounting(),
            "table": self.table.row_accounting(),
            "replicas": self.replicas,
            "authorized_replicas": self._authorized,
            "max_replicas": self.spec.scaling.max_replicas,
            "slots_per_replica": self.spec.per_replica.concurrency,
            "alive_slots": live,
            "alive_names": self.store.live_names(),
            "in_flight_col": sc["in_flight"][live],
            "resident_col": sc["resident"][live],
            "kv_in_use_col": sc["kv_in_use"][live],
            "debt_col": sc["debt"][live].astype(np.float64),
            "class_code_col": sc["class_code"][live],
            "per_slot_in_flight": per_slot_in_flight[live],
            "per_slot_resident": per_slot_resident[live],
            "mirror_drift": self.store.mirror_drift(),
            "unknown_settles": self.ledger.unknown_settles,
        }

    # -- contention & reclamation -------------------------------------------------
    def pool_in_flight(self) -> int:
        return len(self.in_flight)

    def total_resident(self) -> int:
        return int(self.store.col["resident"].sum())

    def has_free_slots(self) -> bool:
        return self.total_resident() < self.capacity().concurrency

    def contended(self) -> bool:
        """Demand exceeds supply: more admitted requests in flight than
        the pool has decode slots — i.e. someone is *waiting*.  A pool
        running at exactly full occupancy with an empty queue is busy,
        not contended (paper Exp. 1 phase 1: spot fills the pool)."""
        return self.pool_in_flight() > self.capacity().concurrency

    @hot_path
    def _priority_rows(self, slots: np.ndarray) -> np.ndarray:
        """Vectorized Eq. 1 over entitlement rows — the same factor
        chain as ``priority.priority_weight``, term for term, reading
        burst/debt from the store columns (the identical f32-sourced
        values the scalar ``priority()`` reads through its status
        view)."""
        sc = self.store.col
        coeff = self.spec.coefficients
        avg = self.pool_avg_slo()
        w_class = _CLASS_WEIGHT_F64[sc["class_code"][slots]]
        slo = sc["slo_ms"][slots].astype(np.float64)
        burst = sc["burst"][slots].astype(np.float64)
        debt = sc["debt"][slots].astype(np.float64)
        slo_factor = 1.0 / (1.0 + coeff.alpha_slo * (slo / avg))
        burst_factor = 1.0 / (1.0 + coeff.alpha_burst
                              * np.maximum(0.0, burst))
        debt_factor = np.maximum(1e-3, 1.0 + coeff.alpha_debt * debt)
        return w_class * slo_factor * burst_factor * debt_factor

    @hot_path
    def inflight_owner_slots(self) -> np.ndarray:
        """Distinct entitlement slots owning at least one in-flight
        record, ascending — one masked pass over the request table."""
        c = self.table.col
        return np.unique(c["owner"][c["has_record"]]).astype(np.int64)

    @hot_path
    def admission_threshold(self) -> float:
        """Min priority among currently-admitted requests (paper §4.3),
        evaluated at the owners' LIVE priorities: debt and burst evolve
        after admission, and the threshold must reflect what those
        tenants are entitled to *now* — otherwise a tenant whose debt is
        rising would strictly exceed its own older snapshots and push
        unbounded work into a contended pool.

        One vectorized Eq. 1 evaluation over the distinct owner rows
        (instead of O(#owners) scalar ``priority()`` calls), guarded
        against an empty owner set — every in-flight owner having been
        removed used to raise ``ValueError`` from an empty ``min``.

        Only meaningful when contended; returns 0.0 (admit-all) otherwise."""
        if not self.contended() or not self.in_flight:
            return 0.0
        owners = self.inflight_owner_slots()
        # lifecycle invariant: rows never outlive their entitlement —
        # but guard anyway (the old per-name filter, vectorized)
        owners = owners[self.store.col["alive"][owners]]
        if not owners.size:
            return 0.0
        return float(np.min(self._priority_rows(owners)))

    @hot_path
    def reclaim_preemptible(self) -> list[str]:
        """Table-1 eviction: returns request ids of preemptible in-flight
        requests to terminate (KV reclaimed, pod killed).  The caller
        (engine) performs the kill and then `on_evict`s each.

        One vectorized pass over the request table: gather each row's
        owner slot, mask by live record + live owner + preemptible
        class code.  ``slot_of`` is insertion-ordered, which is the
        same order the old per-record scan produced."""
        t = self.table
        if not t.slot_of:
            return []
        rids = list(t.slot_of.keys())
        slots = np.fromiter(t.slot_of.values(), np.int64, count=len(rids))
        tc = t.col
        owners = tc["owner"][slots]
        sc = self.store.col
        mask = (tc["has_record"][slots]
                & sc["alive"][owners]
                & (sc["class_code"][owners]
                   == CLASS_CODES[ServiceClass.PREEMPTIBLE]))
        if not mask.any():
            return []
        return [rid for rid, keep in zip(rids, mask) if keep]

    # -- the accounting tick ------------------------------------------------------
    #
    # The resident path: ``_measure`` folds the accounting window with a
    # handful of vectorized column expressions, ``tick`` runs
    # ``control_tick`` over the FULL resident arrays (free slots are
    # inert unbound rows; the width is the pow2 store capacity), and
    # ``_absorb_tick`` adopts the tick's output arrays as the new truth.
    # ``begin_tick``/``apply_tick`` survive as the compact gather/scatter
    # halves for tests and callers that drive the tick themselves.

    @hot_path
    def _measure(self, now: float) -> float:
        """Step 1 (measurement): fold the accounting window into the
        measured/demand columns.  O(width) numpy, no per-row Python.

        The demand EWMA is dt-aware: the retained fraction per tick is
        ``exp(-dt/τ)`` with ``τ = spec.demand_tau_s`` — at the default
        (τ = accounting_interval_s / ln 2) a tick at the nominal
        interval retains exactly ½, the historical fixed blend, while
        irregular tick spacing now yields a tick-rate-independent time
        constant."""
        self._tick_t0 = time.perf_counter()
        dt = max(1e-9, now - self._last_tick)
        self._last_tick = now
        self.expire_entitlements(now)
        c = self.store.col
        c["measured_tps"][:] = measured = c["window_tokens"] / dt
        c["window_tokens"][:] = 0.0
        inst = c["demand_window"] / dt
        tau = self.spec.demand_tau_s
        if tau is None:
            # exp(-dt·ln2 / interval) via exp2: EXACTLY ½ at dt=interval
            retain = 2.0 ** (-dt / self.spec.accounting_interval_s)
        else:
            retain = math.exp(-dt / max(tau, 1e-9))
        # demand signal: EWMA for stability, floored by live usage
        c["demand_tps"][:] = np.maximum(
            retain * c["demand_tps"] + (1.0 - retain) * inst, measured)
        c["demand_window"][:] = 0.0
        return dt

    @hot_path
    def _kernel_inputs(self) -> tuple:
        """f32 device copies of the measurement columns (full width)."""
        c = self.store.col
        dev = self.store.device
        return (torch.from_numpy(c["measured_tps"].astype(np.float32)).to(dev),
                torch.from_numpy(c["kv_in_use"].astype(np.float32)).to(dev),
                torch.from_numpy(c["resident"].astype(np.float32)).to(dev),
                torch.from_numpy(c["demand_tps"].astype(np.float32)).to(dev))

    def begin_tick(self, now: float) -> TickInputs:
        """Measurement + compact gather: live rows only, in slot order
        (row i of every array ↔ ``names[i]``), on the pool's device.
        Kept for tests and callers that run the tick themselves; the
        resident ``tick`` path skips the compaction entirely."""
        self._measure(now)
        idx = self.store.live_slots()
        c = self.store.col
        dev = self.store.device

        def rows(k, dtype=None):
            x = c[k][idx]
            return torch.from_numpy(x if dtype is None
                                    else x.astype(dtype)).to(dev)

        state = ControlState(**{f.name: rows(f.name)
                                for f in dataclasses.fields(ControlState)})
        return TickInputs(
            names=list(self.store.live_names()),
            state=state,
            capacity_tps=self.capacity().tokens_per_second,
            measured_tps=rows("measured_tps", np.float32),
            used_kv=rows("kv_in_use", np.float32),
            used_conc=rows("resident", np.float32),
            demand_tps=rows("demand_tps", np.float32),
            avg_slo_ms=self.pool_avg_slo(),
        )

    def apply_tick(self, now: float, names: list[str],
                   new_burst: np.ndarray, new_debt: np.ndarray,
                   alloc: np.ndarray, weights: np.ndarray) -> TickRecord:
        """Scatter compact tick outputs back into the resident columns
        (steps 5–6) and append the observability record.  Row i of
        every array belongs to ``names[i]``."""
        slot_of = self.store.slot_of
        slots = np.fromiter((slot_of[n] for n in names),
                            np.int64, count=len(names))
        c = self.store.col
        alloc64 = np.asarray(alloc, np.float64)
        c["burst"][slots] = np.asarray(new_burst, np.float32)
        c["debt"][slots] = np.asarray(new_debt, np.float32)
        c["eff_tps"][slots] = alloc64
        self.store.mark_dirty()
        mask = np.zeros(self.store.capacity, bool)
        mask[slots] = True
        rates = np.zeros(self.store.capacity, np.float64)
        rates[slots] = alloc64
        self.ledger.set_rate_rows(mask, rates, now)
        rec = TickRecord.from_arrays(
            now, self.capacity().tokens_per_second, list(names),
            allocations=alloc64,
            priorities=np.asarray(weights, np.float64),
            debts=c["debt"][slots].astype(np.float64),
            bursts=c["burst"][slots].astype(np.float64),
            in_flight=c["in_flight"][slots].copy(),
            demand_tps=c["demand_tps"][slots].copy(),
        )
        self.history.append(rec)
        return rec

    @hot_path
    def _absorb_tick(self, now: float, new_state: ControlState,
                     alloc: np.ndarray, weights: np.ndarray,
                     adopt_device: bool = True) -> TickRecord:
        """Adopt FULL-WIDTH kernel outputs as the new resident truth:
        burst/debt columns sync from the output state (free slots see
        zero inputs and stay zero), allocations land in the effective
        column, and ONE vectorized ledger row-op re-rates every live
        bucket.  No per-row Python."""
        s = self.store
        c = s.col
        if adopt_device:
            s.adopt_device(new_state)
        else:
            c["burst"][:] = new_state.burst.cpu().numpy()
            c["debt"][:] = new_state.debt.cpu().numpy()
            s.mark_dirty()
        alive = c["alive"]
        alloc64 = np.asarray(alloc, np.float64)
        c["eff_tps"][:] = np.where(alive, alloc64, c["eff_tps"])
        self.ledger.set_rate_rows(alive, alloc64, now)
        idx = s.live_slots()
        rec = TickRecord.from_arrays(
            now, self.capacity().tokens_per_second, s.live_names(),
            allocations=alloc64[idx],
            priorities=np.asarray(weights, np.float64)[idx],
            debts=c["debt"][idx].astype(np.float64),
            bursts=c["burst"][idx].astype(np.float64),
            in_flight=c["in_flight"][idx].copy(),
            demand_tps=c["demand_tps"][idx].copy(),
        )
        self.history.append(rec)
        if self.telemetry is not None:
            # once per tick (O(pools), not O(requests)): duration +
            # water-fill/debt totals into the registry + trace timeline
            self.telemetry.on_tick(
                self.spec.name, now,
                time.perf_counter() - self._tick_t0,
                alloc_total=float(alloc64[idx].sum()),
                debt_total=float(c["debt"][idx].sum()),
                in_flight=int(c["in_flight"][idx].sum()))
        return rec

    @hot_path
    def tick(self, now: float) -> TickRecord:
        """One accounting tick on the unified control plane, straight
        over the resident arrays: vectorized window fold → one
        ``control_tick`` at the store's (pow2) width on the store's
        device → vectorized absorb.  Free slots ride along as inert
        unbound rows."""
        self._measure(now)
        measured, used_kv, used_conc, demand = self._kernel_inputs()
        dev = self.store.device
        new_state, alloc, weights = control_plane.control_tick(
            self.store.device_state(),
            torch.tensor(self.capacity().tokens_per_second,
                         dtype=torch.float32, device=dev),
            measured, used_kv, used_conc, demand,
            torch.tensor(self.pool_avg_slo(), dtype=torch.float32,
                         device=dev),
            coeff=self.spec.coefficients)
        return self._absorb_tick(now, new_state, alloc.cpu().numpy(),
                                 weights.cpu().numpy())
