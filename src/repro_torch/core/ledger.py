"""Token-throughput ledger: per-entitlement token budgets.

The paper's admission check (4) requires that "the request's token
budget (input tokens plus max_tokens) must fit within the entitlement's
remaining throughput allocation" (§4.3).  We realise the throughput
entitlement λ_e (tokens/second) as a token bucket:

  - the bucket refills continuously at the entitlement's *effective*
    rate λ̂_e (which the pool controller adjusts: shrunk under
    contention, grown by work-conserving backfill);
  - bucket capacity is ``burst_window_s`` seconds of the rate, so short
    bursts above λ are fundable from accumulated idle credit, matching
    the paper's "burst capacity is satisfied by reallocating unused
    tokens before triggering scaling";
  - admission *charges* the nominal cost n_in + n_out_max up front and
    the completion callback *refunds* the unused portion
    (max_tokens − actual output), closing the admission/execution gap.

Storage has two modes sharing one semantics:

  - **resident** (``Ledger(store=...)`` — what ``TokenPool`` uses):
    bucket level / rate / refill-clock live as float64 COLUMNS of the
    pool's :class:`~repro_torch.core.resident.ResidentStore`;
    :class:`RowBucket` is a view over one row with the exact
    ``TokenBucket`` API, and ``set_rate_rows`` updates every bucket of
    an accounting tick as one vectorized row operation (the per-name
    ``set_rate`` loop the tick used to run was O(n) Python);
  - **standalone** (no store): plain ``TokenBucket`` objects in a dict,
    for tests and detached/migrating buckets.

Deterministic; time is an explicit argument.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.core.markers import hot_path


@dataclasses.dataclass
class TokenBucket:
    rate_tps: float                 # current refill rate λ̂_e
    burst_window_s: float = 4.0     # bucket capacity = rate · window
    level: float = 0.0              # current tokens available
    last_refill_s: float = 0.0

    def capacity(self) -> float:
        return self.rate_tps * self.burst_window_s

    def refill(self, now: float) -> None:
        dt = max(0.0, now - self.last_refill_s)
        self.level = min(self.capacity(), self.level + dt * self.rate_tps)
        self.last_refill_s = now

    def set_rate(self, rate_tps: float, now: float) -> None:
        """Adjust the refill rate (pool shrink/backfill).  Refill first so
        credit accrued at the old rate is preserved, then clamp to the
        new capacity."""
        self.refill(now)
        self.rate_tps = max(0.0, rate_tps)
        self.level = min(self.level, self.capacity())

    def can_afford(self, tokens: float, now: float) -> bool:
        self.refill(now)
        return self.level >= tokens

    def charge(self, tokens: float, now: float) -> bool:
        self.refill(now)
        if self.level < tokens:
            return False
        self.level -= tokens
        return True

    def refund(self, tokens: float, now: float) -> None:
        self.refill(now)
        self.level = min(self.capacity(), self.level + max(0.0, tokens))

    def time_until_affordable(self, tokens: float, now: float) -> float:
        """Seconds until ``tokens`` would be available — the Retry-After
        hint returned with HTTP 429 (paper §4.3)."""
        self.refill(now)
        deficit = tokens - self.level
        if deficit <= 0:
            return 0.0
        if self.rate_tps <= 0:
            return float("inf")
        return deficit / self.rate_tps


class RowBucket:
    """``TokenBucket``-API view over one resident-store row.

    Level / rate / refill clock live in the store's float64 bucket
    columns (the arrays are the truth); this object carries no state of
    its own, so two views of the same row can never diverge.
    """

    __slots__ = ("_store", "_slot")

    def __init__(self, store, slot: int) -> None:
        self._store = store
        self._slot = slot

    # -- column-backed fields (same names as the dataclass) -------------------
    @property
    def rate_tps(self) -> float:
        return float(self._store.col["bucket_rate"][self._slot])

    @rate_tps.setter
    def rate_tps(self, v: float) -> None:
        self._store.col["bucket_rate"][self._slot] = v

    @property
    def level(self) -> float:
        return float(self._store.col["bucket_level"][self._slot])

    @level.setter
    def level(self, v: float) -> None:
        self._store.col["bucket_level"][self._slot] = v
        audit = self._store.level_audit
        if audit is not None:
            audit.note("scalar", self._slot)

    @property
    def burst_window_s(self) -> float:
        return float(self._store.col["bucket_window"][self._slot])

    @burst_window_s.setter
    def burst_window_s(self, v: float) -> None:
        self._store.col["bucket_window"][self._slot] = v

    @property
    def last_refill_s(self) -> float:
        return float(self._store.col["bucket_refill"][self._slot])

    @last_refill_s.setter
    def last_refill_s(self, v: float) -> None:
        self._store.col["bucket_refill"][self._slot] = v

    # -- TokenBucket semantics, verbatim --------------------------------------
    capacity = TokenBucket.capacity
    refill = TokenBucket.refill
    set_rate = TokenBucket.set_rate
    can_afford = TokenBucket.can_afford
    charge = TokenBucket.charge
    refund = TokenBucket.refund
    time_until_affordable = TokenBucket.time_until_affordable

    def to_token_bucket(self) -> TokenBucket:
        """Materialize a detached plain bucket (migration payloads)."""
        return TokenBucket(rate_tps=self.rate_tps,
                           burst_window_s=self.burst_window_s,
                           level=self.level,
                           last_refill_s=self.last_refill_s)

    def __repr__(self) -> str:
        return (f"RowBucket(slot={self._slot}, rate_tps={self.rate_tps}, "
                f"level={self.level}, window={self.burst_window_s})")


Bucket = Union[TokenBucket, RowBucket]


class LevelAudit:
    """Opt-in conservation ledger for the ``bucket_level`` column.

    Every SANCTIONED mutation site (scalar ``RowBucket.level`` writes,
    the vectorized charge/refund/rate row-ops, bucket init/teardown,
    store row recycling) notifies the audit after mutating, which
    accrues the net delta into a per-kind flow total and advances the
    per-slot ``expected`` mirror.  The conservation invariant is then

        bucket_level[s] == expected[s]            (per slot)
        Σ level − Σ baseline == Σ flows           (in aggregate)

    i.e. refills − charges + refunds (+ init/teardown) fully explain
    the observed level deltas.  Any write that bypasses the sanctioned
    entry points (a stray ``col["bucket_level"]`` poke) shows up as
    non-zero :meth:`drift`.  Off by default — production paths pay one
    attribute load + ``is None`` check per mutation batch."""

    def __init__(self, store) -> None:
        self._store = store
        self.expected = store.col["bucket_level"].astype(np.float64)
        #: net level delta per sanctioned-flow kind ("refill",
        #: "charge", "refund", "init", "lifecycle", "scalar")
        self.flows: dict[str, float] = {}
        self.baseline_total = float(self.expected.sum())

    def _sync_width(self) -> None:
        cap = self._store.capacity
        if len(self.expected) < cap:        # store grew: pad with zeros
            grown = np.zeros(cap, np.float64)
            grown[:len(self.expected)] = self.expected
            self.expected = grown

    def note(self, kind: str, slots=None) -> None:
        """Absorb the level delta at ``slots`` (an int, an index array,
        or None for full width) as sanctioned flow of ``kind``."""
        self._sync_width()
        lvl = self._store.col["bucket_level"]
        if slots is None:
            delta = float(lvl.sum() - self.expected.sum())
            self.expected = lvl.astype(np.float64)
        elif np.ndim(slots) == 0:
            delta = float(lvl[slots] - self.expected[slots])
            self.expected[slots] = lvl[slots]
        else:
            u = np.unique(np.asarray(slots, np.int64))
            delta = float(lvl[u].sum() - self.expected[u].sum())
            self.expected[u] = lvl[u]
        self.flows[kind] = self.flows.get(kind, 0.0) + delta

    def drift(self) -> np.ndarray:
        """Per-slot unsanctioned level movement (actual − expected);
        all-zero when every mutation went through a sanctioned path."""
        self._sync_width()
        return (self._store.col["bucket_level"]
                - self.expected[:self._store.capacity])

    def conservation_gap(self) -> float:
        """|Σ level − (Σ baseline + Σ flows)| — 0.0 when the flow
        ledger fully explains the column."""
        total = float(self._store.col["bucket_level"].sum())
        return abs(total - (self.baseline_total
                            + sum(self.flows.values())))


@dataclasses.dataclass
class Charge:
    """Record of an admission-time charge, so completion can refund."""

    request_id: str
    entitlement: str
    charged_tokens: float
    input_tokens: int
    max_tokens: int
    admitted_at: float


class Ledger:
    """Per-entitlement token buckets + outstanding charges.

    Charges follow the same two-mode storage as buckets: with a
    request ``table`` (``core.request_table.RequestTable`` — what
    ``TokenPool`` wires up) each outstanding charge is the charge half
    of a request-table ROW, and the batched entry points
    (:meth:`charge_rows`, :meth:`settle_rows`, :meth:`cancel_rows`)
    are vectorized column ops; without one, charges are plain
    ``Charge`` dataclasses in a dict (tests, detached/migrating
    state)."""

    def __init__(self, burst_window_s: float = 4.0, store=None,
                 table=None) -> None:
        #: standalone mode only; resident mode derives buckets from the
        #: store columns (``has_bucket`` + the bucket_* columns)
        self._buckets: dict[str, TokenBucket] = {}
        #: standalone mode only; table mode keeps charges on rows
        self._charges: dict[str, Charge] = {}
        self.burst_window_s = burst_window_s
        self._store = store
        self._table = table
        #: settles/cancels for request ids with no outstanding charge —
        #: silently 0.0/no-op by contract (late duplicate completions),
        #: but counted so lifecycle bugs can't hide (surfaced through
        #: ``TokenPool.stats``)
        self.unknown_settles = 0

    # -- conservation audit (opt-in) -------------------------------------------
    @property
    def level_audit(self) -> Optional[LevelAudit]:
        """The active :class:`LevelAudit` (None unless enabled)."""
        return None if self._store is None else self._store.level_audit

    def enable_level_audit(self) -> LevelAudit:
        """Start auditing sanctioned ``bucket_level`` flows (resident
        mode only) — the chaos harness's token-conservation checker
        reads :meth:`LevelAudit.drift` after every quantum."""
        if self._store is None:
            raise ValueError("level audit requires resident mode")
        if self._store.level_audit is None:
            self._store.level_audit = LevelAudit(self._store)
        return self._store.level_audit

    def _audit_note(self, kind: str, slots) -> None:
        if self._store is not None \
                and self._store.level_audit is not None:
            self._store.level_audit.note(kind, slots)

    # -- charge storage (both modes) -------------------------------------------
    def _put_charge(self, charge: Charge) -> None:
        if self._table is None:
            self._charges[charge.request_id] = charge
        else:
            self._table.put_charge(charge)

    def _pop_charge(self, request_id: str) -> Optional[Charge]:
        if self._table is None:
            return self._charges.pop(request_id, None)
        return self._table.pop_charge(request_id)

    def outstanding_charges(self) -> int:
        if self._table is None:
            return len(self._charges)
        return int(np.count_nonzero(self._table.col["has_charge"]))

    # -- bucket resolution (both modes) ----------------------------------------
    def _slot(self, entitlement: str) -> int:
        """Resident slot of an entitlement's bucket row; KeyError when
        the entitlement is unknown OR holds no bucket (dict-miss parity
        with the standalone mode)."""
        slot = self._store.slot_of[entitlement]
        if not self._store.col["has_bucket"][slot]:
            raise KeyError(entitlement)
        return slot

    def bucket(self, entitlement: str) -> Bucket:
        if self._store is None:
            return self._buckets[entitlement]
        return RowBucket(self._store, self._slot(entitlement))

    def has_bucket(self, entitlement: str) -> bool:
        if self._store is None:
            return entitlement in self._buckets
        slot = self._store.slot_of.get(entitlement)
        return slot is not None and bool(
            self._store.col["has_bucket"][slot])

    def ensure(self, entitlement: str, rate_tps: float,
               now: float) -> Bucket:
        if self._store is None:
            b = self._buckets.get(entitlement)
            if b is None:
                b = TokenBucket(rate_tps=rate_tps,
                                burst_window_s=self.burst_window_s,
                                level=rate_tps * self.burst_window_s,
                                last_refill_s=now)
                self._buckets[entitlement] = b
            return b
        slot = self._store.slot_of[entitlement]
        c = self._store.col
        if not c["has_bucket"][slot]:
            c["has_bucket"][slot] = True
            c["bucket_rate"][slot] = rate_tps
            c["bucket_window"][slot] = self.burst_window_s
            c["bucket_level"][slot] = rate_tps * self.burst_window_s
            c["bucket_refill"][slot] = now
            self._audit_note("init", slot)
        return RowBucket(self._store, slot)

    @hot_path
    def ensure_rows(self, slots: np.ndarray, rates: np.ndarray,
                    now: float) -> None:
        """Vectorized get-or-create over resident bucket rows (resident
        mode only).  Rows that already hold a bucket are untouched;
        the rest are initialized with the per-row ``rates`` exactly as
        :meth:`ensure` would — one masked column write per field
        instead of a per-entitlement Python loop."""
        c = self._store.col
        need = ~c["has_bucket"][slots]
        if not need.any():
            return
        ns = slots[need]
        r = np.asarray(rates, np.float64)[need]
        c["has_bucket"][ns] = True
        c["bucket_rate"][ns] = r
        c["bucket_window"][ns] = self.burst_window_s
        c["bucket_level"][ns] = r * self.burst_window_s
        c["bucket_refill"][ns] = now
        self._audit_note("init", ns)

    def peek_level(self, entitlement: str, rate_tps: float,
                   now: float) -> float:
        """Level the bucket WOULD have after a refill at ``now`` — pure
        read: no bucket is created and no refill clock advances.  For an
        entitlement with no bucket yet, this is the full initial level
        ``ensure`` would create.  Snapshotting code (the batched
        admission quantum) uses this so observing a pool never mutates
        it."""
        try:
            b = self.bucket(entitlement)
        except KeyError:
            return rate_tps * self.burst_window_s
        dt = max(0.0, now - b.last_refill_s)
        return min(b.capacity(), b.level + dt * b.rate_tps)

    @hot_path
    def peek_levels(self, rates: np.ndarray, now: float) -> np.ndarray:
        """Vectorized :meth:`peek_level` over EVERY resident row (pure
        read; resident mode only).  ``rates`` supplies the would-be
        initial rate for rows without a bucket (the effective-or-
        baseline fallback the scalar path uses).  Rows are in slot
        order — one O(width) numpy expression replaces the per-name
        loop the admission snapshot used to run."""
        c = self._store.col
        cap = c["bucket_rate"] * c["bucket_window"]
        dt = np.maximum(0.0, now - c["bucket_refill"])
        projected = np.minimum(cap, c["bucket_level"]
                               + dt * c["bucket_rate"])
        return np.where(c["has_bucket"], projected,
                        np.asarray(rates, np.float64)
                        * self.burst_window_s)

    def drop(self, entitlement: str) -> None:
        """Remove an entitlement's bucket and any outstanding charges
        (entitlement teardown — the bucket must stop refilling)."""
        if self._store is None:
            self._buckets.pop(entitlement, None)
        else:
            self.drop_bucket_only(entitlement)
        if self._table is not None:
            slot = self._store.slot_of.get(entitlement)
            if slot is not None:
                for s in self._table.charge_slots_of_owner(slot):
                    self._table.clear_charge(s)
            return
        for rid in [rid for rid, ch in self._charges.items()
                    if ch.entitlement == entitlement]:
            del self._charges[rid]

    # -- migration (cross-pool entitlement rebalancing) ------------------------
    def detach(self, entitlement: str
               ) -> tuple[Optional[TokenBucket], list[Charge]]:
        """Remove and RETURN an entitlement's bucket + outstanding
        charges so they can be re-attached on another pool's ledger.
        Unlike :meth:`drop`, nothing is forgotten: the accrued bucket
        level and every admission-time charge (still owed a refund on
        completion) travel with the entitlement.  Resident-mode buckets
        are materialized into detached ``TokenBucket`` objects (the row
        is about to be recycled)."""
        bucket: Optional[TokenBucket]
        if self._store is None:
            bucket = self._buckets.pop(entitlement, None)
        else:
            try:
                bucket = RowBucket(
                    self._store, self._slot(entitlement)).to_token_bucket()
            except KeyError:
                bucket = None
            self.drop_bucket_only(entitlement)
        if self._table is not None:
            slot = self._store.slot_of.get(entitlement)
            charges = []
            if slot is not None:
                for s in self._table.charge_slots_of_owner(slot):
                    charges.append(self._table.materialize_charge(s))
                    self._table.clear_charge(s)
            return bucket, charges
        charges = [ch for ch in self._charges.values()
                   if ch.entitlement == entitlement]
        for ch in charges:
            del self._charges[ch.request_id]
        return bucket, charges

    def drop_bucket_only(self, entitlement: str) -> None:
        """Clear a resident bucket row without touching charges."""
        slot = self._store.slot_of.get(entitlement)
        if slot is not None:
            c = self._store.col
            c["has_bucket"][slot] = False
            c["bucket_level"][slot] = 0.0
            c["bucket_rate"][slot] = 0.0
            c["bucket_refill"][slot] = 0.0
            c["bucket_window"][slot] = 0.0
            self._audit_note("lifecycle", slot)

    def attach(self, entitlement: str, bucket: Optional[TokenBucket],
               charges: list[Charge], now: float) -> None:
        """Adopt a migrated bucket + charges.  The bucket keeps its
        accrued level and refill rate; only the burst window is
        re-based to THIS ledger's window (clamping the level if the
        new capacity is smaller) — the target pool's TPM semantics
        apply from the moment of the move."""
        if bucket is not None:
            bucket.refill(now)
            bucket.burst_window_s = self.burst_window_s
            bucket.level = min(bucket.level, bucket.capacity())
            if self._store is None:
                self._buckets[entitlement] = bucket
            else:
                slot = self._store.slot_of[entitlement]
                c = self._store.col
                c["has_bucket"][slot] = True
                c["bucket_rate"][slot] = bucket.rate_tps
                c["bucket_window"][slot] = bucket.burst_window_s
                c["bucket_level"][slot] = bucket.level
                c["bucket_refill"][slot] = bucket.last_refill_s
                self._audit_note("init", slot)
        for ch in charges:
            self._put_charge(ch)

    def set_rate(self, entitlement: str, rate_tps: float, now: float) -> None:
        self.ensure(entitlement, rate_tps, now).set_rate(rate_tps, now)

    @hot_path
    def set_rate_rows(self, mask: np.ndarray, rates: np.ndarray,
                      now: float) -> None:
        """One accounting tick's rate updates as a single vectorized row
        operation (resident mode): for every row where ``mask`` is
        True, apply exactly ``TokenBucket.set_rate`` — refill at the
        old rate, adopt the (non-negative) new rate, clamp to the new
        capacity.  Masked rows without a bucket yet get a fresh one at
        the new rate, matching what ``ensure`` + ``set_rate`` would
        create.  ``mask``/``rates`` are full-width (slot-indexed)."""
        c = self._store.col
        has = c["has_bucket"] & mask
        rate = c["bucket_rate"]
        window = c["bucket_window"]
        dt = np.maximum(0.0, now - c["bucket_refill"])
        refilled = np.minimum(rate * window,
                              c["bucket_level"] + dt * rate)
        new_rate = np.maximum(0.0, np.asarray(rates, np.float64))
        clamped = np.minimum(refilled, new_rate * window)
        fresh = mask & ~c["has_bucket"]
        c["bucket_level"][:] = np.where(
            has, clamped,
            np.where(fresh, new_rate * self.burst_window_s,
                     c["bucket_level"]))
        c["bucket_rate"][:] = np.where(mask, new_rate, rate)
        c["bucket_window"][:] = np.where(
            fresh, self.burst_window_s, window)
        c["bucket_refill"][:] = np.where(mask, now, c["bucket_refill"])
        c["has_bucket"][:] = c["has_bucket"] | mask
        self._audit_note("refill", None)

    def charge(self, charge: Charge, now: float) -> bool:
        b = self.bucket(charge.entitlement)
        if not b.charge(charge.charged_tokens, now):
            return False
        self._put_charge(charge)
        return True

    @hot_path
    def charge_batch(self, charges: list[Charge], now: float
                     ) -> list[bool]:
        """Apply one admission quantum's charges in order: each bucket
        refills ONCE (all charges share ``now``, so per-charge refills
        are no-ops after the first) and every charge still re-checks
        affordability — the ledger stays authoritative even if the
        caller pre-validated on a snapshot.

        Table mode runs the vectorized row-op (:meth:`charge_rows`
        machinery): one refill per touched bucket + a per-entitlement
        ordered prefix-sum affordability check, falling back to the
        scalar greedy replay for any entitlement whose quantum does not
        fit entirely (a mid-group failure skips that charge and keeps
        admitting later ones — cumulative sums can't express that).
        An unknown entitlement falls back wholesale so the scalar
        KeyError surfaces at the same charge index."""
        if self._table is None or not charges:
            return self._charge_batch_scalar(charges, now)
        n = len(charges)
        sc = self._store.col
        slot_by_ent: dict[str, int] = {}
        ent_slot = np.empty(n, np.int64)
        for i, ch in enumerate(charges):
            s = slot_by_ent.get(ch.entitlement)
            if s is None:
                s = self._store.slot_of.get(ch.entitlement)
                if s is None or not sc["has_bucket"][s]:
                    return self._charge_batch_scalar(charges, now)
                slot_by_ent[ch.entitlement] = s
            ent_slot[i] = s
        tokens = np.fromiter((ch.charged_tokens for ch in charges),
                             np.float64, count=n)
        ok = self._charge_decide_rows(ent_slot, tokens, now)
        acc = np.flatnonzero(ok)
        if acc.size:
            self._table.put_charges([charges[i] for i in acc],
                                    ent_slot[acc])
        return ok.tolist()

    def _charge_batch_scalar(self, charges: list[Charge], now: float
                             ) -> list[bool]:
        """The retained per-charge loop (standalone mode + the table
        mode fallback) — the parity oracle for the vectorized path."""
        refilled: set[str] = set()
        out = []
        for ch in charges:
            b = self.bucket(ch.entitlement)
            if ch.entitlement not in refilled:
                b.refill(now)
                refilled.add(ch.entitlement)
            if b.level >= ch.charged_tokens:
                b.level -= ch.charged_tokens
                self._put_charge(ch)
                out.append(True)
            else:
                out.append(False)
        return out

    @hot_path
    def _charge_decide_rows(self, ent_slot: np.ndarray,
                            tokens: np.ndarray, now: float) -> np.ndarray:
        """Vectorized affordability for one quantum of charges against
        resident buckets (``ent_slot``/``tokens`` aligned, every slot
        pre-validated to hold a bucket).  Mutates bucket levels exactly
        like the scalar loop and returns the accept mask.

        Parity with the scalar greedy: each touched bucket refills once
        at the shared ``now`` (later per-charge refills are dt=0
        no-ops); a stable argsort groups charges by bucket while
        preserving arrival order inside each group, so when a group's
        inclusive prefix sums all fit the opening level, committing via
        ``np.subtract.at`` (unbuffered, index-ordered) replays the
        identical f64 subtraction chain.  Any group with a miss is
        replayed charge by charge in arrival order instead."""
        sc = self._store.col
        lvl = sc["bucket_level"]
        u = np.unique(ent_slot)
        cap = sc["bucket_rate"][u] * sc["bucket_window"][u]
        dt = np.maximum(0.0, now - sc["bucket_refill"][u])
        lvl[u] = np.minimum(cap, lvl[u] + dt * sc["bucket_rate"][u])
        sc["bucket_refill"][u] = now
        self._audit_note("refill", u)
        n = len(ent_slot)
        order = np.argsort(ent_slot, kind="stable")
        s_ord = ent_slot[order]
        t_ord = tokens[order]
        cum = np.cumsum(t_ord)
        group_start = np.empty(n, bool)
        group_start[0] = True
        group_start[1:] = s_ord[1:] != s_ord[:-1]
        start_idx = np.flatnonzero(group_start)
        gid = np.cumsum(group_start) - 1
        base = np.concatenate(([0.0], cum[start_idx[1:] - 1]))
        prefix = cum - base[gid]
        fits = prefix <= lvl[s_ord]
        group_ok = np.logical_and.reduceat(fits, start_idx)
        fast = group_ok[gid]
        ok = np.zeros(n, bool)
        if fast.any():
            np.subtract.at(lvl, s_ord[fast], t_ord[fast])
            ok[order[fast]] = True
        if not fast.all():
            for pos in np.flatnonzero(~fast):
                s = s_ord[pos]
                t = t_ord[pos]
                if lvl[s] >= t:
                    lvl[s] -= t
                    ok[order[pos]] = True
        self._audit_note("charge", u)
        return ok

    @hot_path
    def charge_rows(self, request_ids: list, ent_slot: np.ndarray,
                    tokens: np.ndarray, input_tokens: np.ndarray,
                    max_tokens: np.ndarray, now: float
                    ) -> tuple[np.ndarray, np.ndarray]:
        """Array-native :meth:`charge_batch` — the gateway quantum hot
        path: no per-request ``Charge`` objects, accepted charges land
        as batched request-table column writes.  Every ``ent_slot``
        must hold a bucket (the gateway ensures buckets per entitlement
        beforehand).  Returns ``(accept mask, accepted row slots)`` —
        the slots align with the accepted subset in charge order, so
        the caller can thread them straight into the admit scatter."""
        ok = self._charge_decide_rows(
            np.asarray(ent_slot, np.int64),
            np.asarray(tokens, np.float64), now)
        acc = np.flatnonzero(ok)
        slots = np.empty(0, np.int64)
        if acc.size:
            acc_l = acc.tolist()
            ids = (request_ids if acc.size == len(request_ids)
                   else [request_ids[i] for i in acc_l])
            slots = self._table.charge_rows(
                ids, ent_slot[acc],
                np.asarray(tokens, np.float64)[acc],
                np.asarray(input_tokens, np.int64)[acc],
                np.asarray(max_tokens, np.int64)[acc], now)
        return ok, slots

    def settle(self, request_id: str, actual_output_tokens: int,
               now: float) -> float:
        """Completion callback: refund the unused reservation.

        Returns the *actual* token cost (input + actual output);
        0.0 — counted in ``unknown_settles`` — when no charge is
        outstanding for the request."""
        ch = self._pop_charge(request_id)
        if ch is None:
            self.unknown_settles += 1
            return 0.0
        actual = ch.input_tokens + actual_output_tokens
        refund = max(0.0, ch.charged_tokens - actual)
        self.bucket(ch.entitlement).refund(refund, now)
        return float(actual)

    def cancel(self, request_id: str, now: float) -> None:
        """Request failed/evicted before producing tokens: full refund.
        Unknown request ids no-op but count in ``unknown_settles``."""
        ch = self._pop_charge(request_id)
        if ch is None:
            self.unknown_settles += 1
            return
        self.bucket(ch.entitlement).refund(ch.charged_tokens, now)

    @hot_path
    def _refund_rows(self, ch_owner: np.ndarray, refunds: np.ndarray,
                     now: float) -> None:
        """Batched ``TokenBucket.refund`` over bucket rows: one refill
        per touched bucket at the shared ``now``, refunds applied with
        ``np.add.at`` (unbuffered, index-ordered — the same f64
        addition chain as sequential scalar refunds), one capacity
        clamp at the end.  Clamp-once equals clamp-each: refunds are
        non-negative, so once the running level would exceed capacity
        every subsequent scalar step re-clamps to the same cap."""
        sc = self._store.col
        lvl = sc["bucket_level"]
        u = np.unique(ch_owner)
        cap = sc["bucket_rate"][u] * sc["bucket_window"][u]
        dt = np.maximum(0.0, now - sc["bucket_refill"][u])
        lvl[u] = np.minimum(cap, lvl[u] + dt * sc["bucket_rate"][u])
        sc["bucket_refill"][u] = now
        self._audit_note("refill", u)
        np.add.at(lvl, ch_owner, refunds)
        lvl[u] = np.minimum(lvl[u], cap)
        self._audit_note("refund", u)

    @hot_path
    def settle_rows(self, slots: np.ndarray, actual_output_tokens:
                    np.ndarray, now: float) -> np.ndarray:
        """Batched :meth:`settle` over request-table rows (table mode).
        Folds every refund into one vectorized bucket update and clears
        the charge halves; the caller owns releasing the rows.  Rows
        with no outstanding charge settle to 0.0 and count in
        ``unknown_settles``.  Returns per-row actual token costs."""
        t = self._table
        c = t.col
        n = len(slots)
        actual = np.zeros(n, np.float64)
        has = c["has_charge"][slots]
        missing = n - int(np.count_nonzero(has))
        if missing:
            self.unknown_settles += missing
        if missing == n:
            return actual
        cs = slots[has]
        owners = c["ch_owner"][cs].astype(np.int64)
        bad = ~self._store.col["has_bucket"][owners]
        if bad.any():          # KeyError parity with the scalar settle
            raise KeyError(self._store.name_of[int(owners[bad][0])])
        outs = np.asarray(actual_output_tokens, np.int64)[has]
        act = (c["input_tokens"][cs] + outs).astype(np.float64)
        refunds = np.maximum(0.0, c["charged"][cs] - act)
        self._refund_rows(owners, refunds, now)
        actual[has] = act
        c["has_charge"][cs] = False
        c["ch_owner"][cs] = 0
        c["charged"][cs] = 0.0
        c["input_tokens"][cs] = 0
        c["max_tokens"][cs] = 0
        c["ch_admitted"][cs] = 0.0
        return actual

    @hot_path
    def cancel_rows(self, slots: np.ndarray, now: float) -> None:
        """Batched :meth:`cancel` over request-table rows (table
        mode): full refunds, vectorized.  The caller owns releasing
        the rows."""
        t = self._table
        c = t.col
        has = c["has_charge"][slots]
        missing = len(slots) - int(np.count_nonzero(has))
        if missing:
            self.unknown_settles += missing
        if missing == len(slots):
            return
        cs = slots[has]
        owners = c["ch_owner"][cs].astype(np.int64)
        bad = ~self._store.col["has_bucket"][owners]
        if bad.any():
            raise KeyError(self._store.name_of[int(owners[bad][0])])
        refunds = np.maximum(0.0, c["charged"][cs])
        self._refund_rows(owners, refunds, now)
        c["has_charge"][cs] = False
        c["ch_owner"][cs] = 0
        c["charged"][cs] = 0.0
        c["input_tokens"][cs] = 0
        c["max_tokens"][cs] = 0
        c["ch_admitted"][cs] = 0.0

    def retry_after(self, entitlement: str, tokens: float, now: float) -> float:
        return self.bucket(entitlement).time_until_affordable(tokens, now)
