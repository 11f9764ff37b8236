"""Resident request lifecycle state — rows for in-flight requests.

The pool's :class:`~repro_torch.core.resident.ResidentStore` makes the
*entitlement* control-plane columns the source of truth; this module
does the same for the *request* lifecycle: in-flight records and
outstanding charges are rows, so charges, completions and evictions
are column operations.

:class:`RequestTable` is one structure-of-arrays per pool:

  * each row unifies the two halves of a request's lifecycle — the
    admission **record** (owner entitlement slot, priority, KV bytes,
    charged tokens, resident flag, admit clock) and the ledger
    **charge** (charged/input/max tokens, charge clock) — under one
    request-id keyed slot;
  * columns are padded to a power-of-two capacity with a LIFO free
    list, so request churn RECYCLES rows instead of reshaping arrays
    (rows on the free list are all-zero — release zeroes eagerly so
    the admission hot path never zeroes per row);
  * :class:`InFlightRow` is a *view* over one row with the exact
    ``InFlight`` attribute surface, and :class:`InFlightMap` is the
    dict facade behind ``pool.in_flight`` — dicts are views, arrays
    are truth;
  * the batched lifecycle ops (``TokenPool.settle_rows`` /
    ``evict_rows`` / ``register_admit_batch`` and
    ``Ledger.charge_rows``) are masked scatter-adds over these columns
    — O(batch) numpy instead of O(batch) Python object bookkeeping.

dtype discipline mirrors the store: every accumulator that feeds the
scalar bookkeeping is float64/int64, so the batched row-ops match the
retained per-request oracle (``on_complete`` / ``on_evict``) bit for
bit.  The record half and the charge half keep separate owner columns
(``owner`` vs ``ch_owner``): the legacy dicts were independent, and
the parity oracle allows a record and a charge for the same request id
to name different entitlements.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np

from repro_torch.core.control_plane import bucket_width
from repro_torch.core.ledger import Charge
from repro_torch.core.markers import hot_path


@dataclasses.dataclass
class InFlight:
    """One admitted, not-yet-completed request.

    The dataclass is the MATERIALIZED form: detached payloads
    (migrations, ``on_complete`` return values) and test fixtures.
    Live requests are rows of :class:`RequestTable`, handed out as
    :class:`InFlightRow` views with this exact attribute surface."""

    request_id: str
    entitlement: str
    priority: float
    kv_bytes: float
    charged_tokens: int
    admitted_at: float
    resident: bool = False       # dispatched to a decode worker
    #: (pool, entitlement) of the route leg the client PREFERRED when
    #: this request was admitted by a later (spill) leg — None when the
    #: request was served by its first leg.  Drives per-request
    #: cross-pool debt transfer on completion
    #: (``PoolManager.transfer_spill_debt``).
    spill_from: Optional[tuple] = None
    #: actual settled token cost (input + actual output), stamped by
    #: ``on_complete`` so callers can attribute service without
    #: re-reading the ledger charge (already popped by then)
    settled_tokens: float = 0.0


#: column name → dtype.  ``has_record``/``has_charge`` gate the two
#: lifecycle halves; a row dies when both are clear.
_COLUMNS: dict[str, np.dtype] = {
    # admission record half (pool.in_flight)
    "has_record": np.dtype(bool),
    "owner": np.dtype(np.int32),          # entitlement slot in the store
    "priority": np.dtype(np.float64),
    "kv_bytes": np.dtype(np.float64),
    "rec_charged": np.dtype(np.int64),    # InFlight.charged_tokens
    "rec_admitted": np.dtype(np.float64),
    "resident": np.dtype(bool),
    "settled": np.dtype(np.float64),
    # ledger charge half (ledger outstanding charges)
    "has_charge": np.dtype(bool),
    "ch_owner": np.dtype(np.int32),
    "charged": np.dtype(np.float64),      # Charge.charged_tokens
    "input_tokens": np.dtype(np.int64),
    "max_tokens": np.dtype(np.int64),
    "ch_admitted": np.dtype(np.float64),
}


def column_manifest() -> dict:
    """Machine-readable column contract for the static analyzer (the
    request-table twin of ``resident.column_manifest``).  The table has
    no cached device mirror today — ``mirrored`` is empty — but the
    moment a column is listed there, every un-invalidated host write to
    it becomes a ``mirror-invalidation`` finding."""
    return {
        "store": "RequestTable",
        "module": "repro_torch.core.request_table",
        "columns": {name: str(dtype) for name, dtype in _COLUMNS.items()},
        "mirrored": [],
        "kernel_f32": [],
        "sanctioned_mutators": [],
    }


class RequestTable:
    """Structure-of-arrays store for one pool's in-flight requests."""

    def __init__(self, store, capacity: int = 8) -> None:
        #: the pool's ResidentStore — owner columns index ITS slots,
        #: and entitlement names resolve through its ``name_of``
        self.store = store
        self.capacity = bucket_width(max(1, capacity))
        self.slot_of: dict[str, int] = {}
        self.rid_of: list[Optional[str]] = [None] * self.capacity
        #: per-row spill leg (rarely non-None → Python side list, not
        #: a column; follows record-half lifetime)
        self.spill_from: list[Optional[tuple]] = [None] * self.capacity
        # LIFO free list: recycling reuses the most recently freed slot
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self.col: dict[str, np.ndarray] = {
            name: np.zeros(self.capacity, dtype)
            for name, dtype in _COLUMNS.items()}
        #: live admission records (NOT rows: a charge-only row does not
        #: count toward ``len(pool.in_flight)``)
        self.n_records = 0
        #: bumps whenever capacity grows (array identities change)
        self.generation = 0

    # -- audit surface (public: chaos invariant checkers read these) ----------
    def row_accounting(self) -> dict:
        """Free-list / live-row closure snapshot: the invariant is
        ``rows + free == capacity``, with record rows a subset of live
        rows (``n_records`` counts record halves only)."""
        return {
            "capacity": self.capacity,
            "rows": len(self.slot_of),
            "free": len(self._free),
            "records": self.n_records,
            "record_rows": int(np.count_nonzero(self.col["has_record"])),
            "charge_rows": int(np.count_nonzero(self.col["has_charge"])),
        }

    # -- slot lifecycle -------------------------------------------------------
    def ensure_slot(self, request_id: str) -> int:
        """Row slot for ``request_id``, allocating one if needed.
        Allocation does NOT touch columns: rows on the free list are
        already all-zero (zeroed at release), which keeps the batched
        admit path free of per-row clearing."""
        slot = self.slot_of.get(request_id)
        if slot is None:
            if not self._free:
                self._grow()
            slot = self._free.pop()
            self.slot_of[request_id] = slot
            self.rid_of[slot] = request_id
        return slot

    @hot_path
    def ensure_slots(self, request_ids: list) -> np.ndarray:
        """Batched :meth:`ensure_slot`: one growth check, LIFO tail
        allocation, C-speed dict updates.  Known ids resolve to their
        existing rows; allocation order matches the scalar loop (the
        free-list tail is handed out in pop order).  Duplicate unknown
        ids fall back to the scalar loop so both occurrences land on
        one row."""
        n = len(request_ids)
        if not self.slot_of:             # empty table: all ids are new
            hits = [None] * n
            misses = n
        else:
            get = self.slot_of.get
            hits = [get(r) for r in request_ids]
            misses = hits.count(None)
        if misses == 0:
            return np.asarray(hits, np.int64)
        missing = request_ids if misses == n else \
            [r for r, s in zip(request_ids, hits) if s is None]
        if misses > 1 and len(set(missing)) != misses:
            return np.fromiter(
                (self.ensure_slot(r) for r in request_ids),
                np.int64, count=n)
        while len(self._free) < misses:
            self._grow()
        tail = self._free[-misses:]
        del self._free[-misses:]
        tail.reverse()                   # sequential pop() order
        self.slot_of.update(zip(missing, tail))
        rid_of = self.rid_of
        for r, s in zip(missing, tail):
            rid_of[s] = r
        if misses == n:
            return np.asarray(tail, np.int64)
        it = iter(tail)
        return np.asarray([next(it) if s is None else s for s in hits],
                          np.int64)

    def release(self, slot: int) -> None:
        """Free one row: zero every column (the free-list invariant)
        and push the slot for LIFO recycling."""
        if self.col["has_record"][slot]:
            self.n_records -= 1
        for arr in self.col.values():
            arr[slot] = 0
        rid = self.rid_of[slot]
        del self.slot_of[rid]
        self.rid_of[slot] = None
        self.spill_from[slot] = None
        self._free.append(slot)

    @hot_path
    def release_rows(self, slots: np.ndarray) -> None:
        """Batched :meth:`release` — column zeroing is one fancy-index
        write per column; the free list extends in iteration order, so
        future allocation order matches a scalar release loop."""
        c = self.col
        self.n_records -= int(np.count_nonzero(c["has_record"][slots]))
        for arr in c.values():
            arr[slots] = 0
        rid_of, spill = self.rid_of, self.spill_from
        slot_of = self.slot_of
        for s in slots.tolist():
            del slot_of[rid_of[s]]
            rid_of[s] = None
            spill[s] = None
        self._free.extend(slots.tolist())

    def _grow(self) -> None:
        old = self.capacity
        new = old * 2
        for name, arr in self.col.items():
            grown = np.zeros(new, arr.dtype)
            grown[:old] = arr
            self.col[name] = grown
        self.rid_of.extend([None] * (new - old))
        self.spill_from.extend([None] * (new - old))
        self._free.extend(range(new - 1, old - 1, -1))
        self.capacity = new
        self.generation += 1

    # -- record half ----------------------------------------------------------
    def put_record(self, rec) -> int:
        """Write an ``InFlight``-shaped object into its row (allocating
        or completing a charge-only row).  Owner resolves through the
        store — the entitlement must be resident."""
        slot = self.ensure_slot(rec.request_id)
        c = self.col
        if not c["has_record"][slot]:
            self.n_records += 1
        c["has_record"][slot] = True
        c["owner"][slot] = self.store.slot_of[rec.entitlement]
        c["priority"][slot] = rec.priority
        c["kv_bytes"][slot] = rec.kv_bytes
        c["rec_charged"][slot] = rec.charged_tokens
        c["rec_admitted"][slot] = rec.admitted_at
        c["resident"][slot] = rec.resident
        c["settled"][slot] = rec.settled_tokens
        self.spill_from[slot] = rec.spill_from
        return slot

    @hot_path
    def put_records(self, recs: list, owners: np.ndarray) -> np.ndarray:
        """One admission quantum's records as batched column writes
        (``owners`` are pre-resolved entitlement slots, aligned with
        ``recs``).  Returns the row slots."""
        n = len(recs)
        slots = self.ensure_slots([r.request_id for r in recs])
        c = self.col
        fresh = ~c["has_record"][slots]
        self.n_records += int(np.count_nonzero(fresh))
        c["has_record"][slots] = True
        c["owner"][slots] = owners
        c["priority"][slots] = np.fromiter(
            (r.priority for r in recs), np.float64, count=n)
        c["kv_bytes"][slots] = np.fromiter(
            (r.kv_bytes for r in recs), np.float64, count=n)
        c["rec_charged"][slots] = np.fromiter(
            (r.charged_tokens for r in recs), np.int64, count=n)
        c["rec_admitted"][slots] = np.fromiter(
            (r.admitted_at for r in recs), np.float64, count=n)
        spill = self.spill_from
        for s, r in zip(slots.tolist(), recs):
            if r.resident:
                c["resident"][s] = True
            if r.settled_tokens:
                c["settled"][s] = r.settled_tokens
            spill[s] = r.spill_from
        return slots

    @hot_path
    def admit_rows(self, request_ids: list, owners: np.ndarray,
                   kv_bytes: np.ndarray, charged_tokens: np.ndarray,
                   admitted_at: float,
                   slots: Optional[np.ndarray] = None) -> np.ndarray:
        """Array-native record insertion — the gateway quantum path
        (no per-request ``InFlight`` objects).  Rows start non-resident
        with no spill leg; the caller tags spill legs afterwards.
        ``slots`` skips the id resolution when the caller already holds
        the rows (the quantum path reuses the charge rows).  Returns
        the row slots."""
        if slots is None:
            slots = self.ensure_slots(request_ids)
        c = self.col
        fresh = ~c["has_record"][slots]
        self.n_records += int(np.count_nonzero(fresh))
        c["has_record"][slots] = True
        c["owner"][slots] = owners
        c["kv_bytes"][slots] = kv_bytes
        c["rec_charged"][slots] = charged_tokens
        c["rec_admitted"][slots] = admitted_at
        return slots

    def materialize_record(self, slot: int) -> InFlight:
        """Detached ``InFlight`` copy of one row's record half
        (completion return values, migration payloads — the row is
        about to be recycled)."""
        c = self.col
        owner = int(c["owner"][slot])
        return InFlight(
            request_id=self.rid_of[slot],
            entitlement=self.store.name_of[owner],
            priority=float(c["priority"][slot]),
            kv_bytes=float(c["kv_bytes"][slot]),
            charged_tokens=int(c["rec_charged"][slot]),
            admitted_at=float(c["rec_admitted"][slot]),
            resident=bool(c["resident"][slot]),
            spill_from=self.spill_from[slot],
            settled_tokens=float(c["settled"][slot]))

    def clear_record(self, slot: int) -> None:
        """Drop a row's record half; the row dies (and recycles) unless
        an outstanding charge still holds it."""
        c = self.col
        if not c["has_record"][slot]:
            return
        if not c["has_charge"][slot]:
            self.release(slot)
            return
        self.n_records -= 1
        c["has_record"][slot] = False
        c["owner"][slot] = 0
        c["priority"][slot] = 0.0
        c["kv_bytes"][slot] = 0.0
        c["rec_charged"][slot] = 0
        c["rec_admitted"][slot] = 0.0
        c["resident"][slot] = False
        c["settled"][slot] = 0.0
        self.spill_from[slot] = None

    def record_slots_of_owner(self, owner_slot: int) -> np.ndarray:
        """Row slots whose record half belongs to one entitlement, in
        request-id insertion (registration) order."""
        c = self.col
        mask = c["has_record"] & (c["owner"] == owner_slot)
        hits = [s for s in self.slot_of.values() if mask[s]]
        return np.asarray(hits, np.int64)

    # -- charge half ----------------------------------------------------------
    def put_charge(self, charge: Charge) -> int:
        """Write a ledger charge into its row (allocating or completing
        a record-only row)."""
        slot = self.ensure_slot(charge.request_id)
        c = self.col
        c["has_charge"][slot] = True
        c["ch_owner"][slot] = self.store.slot_of[charge.entitlement]
        c["charged"][slot] = charge.charged_tokens
        c["input_tokens"][slot] = charge.input_tokens
        c["max_tokens"][slot] = charge.max_tokens
        c["ch_admitted"][slot] = charge.admitted_at
        return slot

    @hot_path
    def put_charges(self, charges: list, owners: np.ndarray) -> np.ndarray:
        """One admission quantum's accepted charges as batched column
        writes (``owners`` pre-resolved, aligned with ``charges``)."""
        n = len(charges)
        slots = self.ensure_slots([ch.request_id for ch in charges])
        c = self.col
        c["has_charge"][slots] = True
        c["ch_owner"][slots] = owners
        c["charged"][slots] = np.fromiter(
            (ch.charged_tokens for ch in charges), np.float64, count=n)
        c["input_tokens"][slots] = np.fromiter(
            (ch.input_tokens for ch in charges), np.int64, count=n)
        c["max_tokens"][slots] = np.fromiter(
            (ch.max_tokens for ch in charges), np.int64, count=n)
        c["ch_admitted"][slots] = np.fromiter(
            (ch.admitted_at for ch in charges), np.float64, count=n)
        return slots

    @hot_path
    def charge_rows(self, request_ids: list, owners: np.ndarray,
                    charged: np.ndarray, input_tokens: np.ndarray,
                    max_tokens: np.ndarray, admitted_at: float
                    ) -> np.ndarray:
        """Array-native charge insertion (gateway quantum path — no
        per-request ``Charge`` objects).  Returns the row slots."""
        slots = self.ensure_slots(request_ids)
        c = self.col
        c["has_charge"][slots] = True
        c["ch_owner"][slots] = owners
        c["charged"][slots] = charged
        c["input_tokens"][slots] = input_tokens
        c["max_tokens"][slots] = max_tokens
        c["ch_admitted"][slots] = admitted_at
        return slots

    def pop_charge(self, request_id: str) -> Optional[Charge]:
        """Materialize and remove a row's charge half (scalar
        settle/cancel); the row dies unless its record half holds it.
        Returns None when the request has no outstanding charge."""
        slot = self.slot_of.get(request_id)
        if slot is None or not self.col["has_charge"][slot]:
            return None
        ch = self.materialize_charge(slot)
        self.clear_charge(slot)
        return ch

    def materialize_charge(self, slot: int) -> Charge:
        c = self.col
        return Charge(
            request_id=self.rid_of[slot],
            entitlement=self.store.name_of[int(c["ch_owner"][slot])],
            charged_tokens=float(c["charged"][slot]),
            input_tokens=int(c["input_tokens"][slot]),
            max_tokens=int(c["max_tokens"][slot]),
            admitted_at=float(c["ch_admitted"][slot]))

    def clear_charge(self, slot: int) -> None:
        c = self.col
        if not c["has_charge"][slot]:
            return
        if not c["has_record"][slot]:
            self.release(slot)
            return
        c["has_charge"][slot] = False
        c["ch_owner"][slot] = 0
        c["charged"][slot] = 0.0
        c["input_tokens"][slot] = 0
        c["max_tokens"][slot] = 0
        c["ch_admitted"][slot] = 0.0

    def charge_slots_of_owner(self, owner_slot: int) -> list[int]:
        """Row slots whose charge half belongs to one entitlement, in
        request-id insertion order (matches the legacy dict sweep)."""
        c = self.col
        mask = c["has_charge"] & (c["ch_owner"] == owner_slot)
        return [s for s in self.slot_of.values() if mask[s]]


class InFlightRow:
    """``InFlight``-compatible VIEW over one request-table row.

    Same attribute surface as the dataclass, but every read and write
    goes straight to the columns — ``pool.in_flight[rid]`` returns
    these (dicts are views, arrays are truth)."""

    __slots__ = ("_table", "_slot")

    def __init__(self, table: RequestTable, slot: int) -> None:
        self._table = table
        self._slot = slot

    @property
    def slot(self) -> int:
        return self._slot

    @property
    def request_id(self) -> str:
        return self._table.rid_of[self._slot]

    @property
    def entitlement(self) -> str:
        t = self._table
        return t.store.name_of[int(t.col["owner"][self._slot])]

    @property
    def priority(self) -> float:
        return float(self._table.col["priority"][self._slot])

    @priority.setter
    def priority(self, v: float) -> None:
        self._table.col["priority"][self._slot] = v

    @property
    def kv_bytes(self) -> float:
        return float(self._table.col["kv_bytes"][self._slot])

    @kv_bytes.setter
    def kv_bytes(self, v: float) -> None:
        self._table.col["kv_bytes"][self._slot] = v

    @property
    def charged_tokens(self) -> int:
        return int(self._table.col["rec_charged"][self._slot])

    @charged_tokens.setter
    def charged_tokens(self, v: int) -> None:
        self._table.col["rec_charged"][self._slot] = v

    @property
    def admitted_at(self) -> float:
        return float(self._table.col["rec_admitted"][self._slot])

    @admitted_at.setter
    def admitted_at(self, v: float) -> None:
        self._table.col["rec_admitted"][self._slot] = v

    @property
    def resident(self) -> bool:
        return bool(self._table.col["resident"][self._slot])

    @resident.setter
    def resident(self, v: bool) -> None:
        self._table.col["resident"][self._slot] = v

    @property
    def spill_from(self) -> Optional[tuple]:
        return self._table.spill_from[self._slot]

    @spill_from.setter
    def spill_from(self, v: Optional[tuple]) -> None:
        self._table.spill_from[self._slot] = v

    @property
    def settled_tokens(self) -> float:
        return float(self._table.col["settled"][self._slot])

    @settled_tokens.setter
    def settled_tokens(self, v: float) -> None:
        self._table.col["settled"][self._slot] = v

    def materialize(self) -> InFlight:
        return self._table.materialize_record(self._slot)

    def __repr__(self) -> str:
        return (f"InFlightRow(slot={self._slot}, "
                f"request_id={self.request_id!r}, "
                f"entitlement={self.entitlement!r}, "
                f"charged_tokens={self.charged_tokens}, "
                f"resident={self.resident})")


class InFlightMap:
    """Dict facade over a pool's request-table RECORD rows — the
    ``pool.in_flight`` surface.  Membership, iteration and length count
    admission records only (a charge-only row is ledger state, not an
    in-flight request).  ``__setitem__`` writes an ``InFlight``-shaped
    object into its row (the migration attach path)."""

    __slots__ = ("_table",)

    def __init__(self, table: RequestTable) -> None:
        self._table = table

    def __len__(self) -> int:
        return self._table.n_records

    def __bool__(self) -> bool:
        return self._table.n_records > 0

    def __contains__(self, request_id: str) -> bool:
        t = self._table
        slot = t.slot_of.get(request_id)
        return slot is not None and bool(t.col["has_record"][slot])

    def __iter__(self) -> Iterator[str]:
        t = self._table
        has = t.col["has_record"]
        return (rid for rid, slot in t.slot_of.items() if has[slot])

    def keys(self) -> list[str]:
        return list(self)

    def __getitem__(self, request_id: str) -> InFlightRow:
        t = self._table
        slot = t.slot_of.get(request_id)
        if slot is None or not t.col["has_record"][slot]:
            raise KeyError(request_id)
        return InFlightRow(t, slot)

    def get(self, request_id: str, default=None):
        t = self._table
        slot = t.slot_of.get(request_id)
        if slot is None or not t.col["has_record"][slot]:
            return default
        return InFlightRow(t, slot)

    def __setitem__(self, request_id: str, rec) -> None:
        if rec.request_id != request_id:
            raise ValueError(f"record id {rec.request_id!r} != key "
                             f"{request_id!r}")
        self._table.put_record(rec)

    def __delitem__(self, request_id: str) -> None:
        t = self._table
        slot = t.slot_of.get(request_id)
        if slot is None or not t.col["has_record"][slot]:
            raise KeyError(request_id)
        t.clear_record(slot)

    def pop(self, request_id: str, default=None):
        t = self._table
        slot = t.slot_of.get(request_id)
        if slot is None or not t.col["has_record"][slot]:
            return default
        rec = t.materialize_record(slot)
        t.clear_record(slot)
        return rec

    def values(self) -> Iterator[InFlightRow]:
        t = self._table
        has = t.col["has_record"]
        return (InFlightRow(t, slot) for slot in t.slot_of.values()
                if has[slot])

    def items(self) -> Iterator[tuple[str, InFlightRow]]:
        t = self._table
        has = t.col["has_record"]
        return ((rid, InFlightRow(t, slot))
                for rid, slot in t.slot_of.items() if has[slot])

    def __repr__(self) -> str:
        return f"InFlightMap(n_records={self._table.n_records})"
