"""Admission flight recorder — a fixed-capacity SoA ring buffer with
one row per admission DECISION (one request may contribute several
rows: one per route leg it was tried on, plus terminal rows for
unknown keys and unroutable requests).

Each row captures the decision *and the control-plane state it was
made against*: rid hash, clock, pool, leg, verdict, deny-reason code,
the request's live Eq. 1 priority vs the pool's admission threshold,
and the owning entitlement's bucket level / debt / burst dims at
decision time — enough to answer "why was request X denied at t=42.3"
without replaying the simulation.

Writes are batched: the gateway emits ONE ``record_batch`` call per
``admit_quantum`` / ``_quantum_fast`` dispatch (a masked scatter per
column into ring positions ``(head + arange(m)) & (cap-1)``); the
scalar ``record`` twin is the parity oracle and serves the scalar
``Gateway.handle`` path.  ``explain(request_id)`` reconstructs the
full multi-leg decision narrative; ``recent(...)`` is the structured
query surface.

The columns are declared in ``column_manifest`` below, the contract
the reference's analyzer reads from its own copy of this module.
Requests are
matched by Python string hash — stable within a process (explain is
an in-process debugging surface), 64-bit so collisions are
negligible.  The hot path stores raw id POINTERS only; the
``rid_hash`` column is materialized lazily at query time so dispatch
never pays the per-string hash loop.

Counterpart of ``repro/telemetry/flight.py`` (numpy only; the port
keeps its own copy).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.markers import hot_path
from repro_torch.core.types import DenyReason

__all__ = [
    "DecisionTrace",
    "FlightRecorder",
    "FlightRow",
    "REASON_NAMES",
    "REASON_NONE",
    "REASON_POOL_UNAVAILABLE",
    "VERDICT_ADMIT",
    "VERDICT_DENY",
    "VERDICT_NAMES",
    "VERDICT_UNKNOWN_KEY",
    "column_manifest",
    "hash_ids",
]

#: verdict codes (``verdict`` column)
VERDICT_ADMIT = 0
VERDICT_DENY = 1
VERDICT_UNKNOWN_KEY = 2
VERDICT_NAMES = {VERDICT_ADMIT: "admit", VERDICT_DENY: "deny",
                 VERDICT_UNKNOWN_KEY: "unknown_key"}

#: deny-reason codes (``reason`` column): 1–4 are the kernel's
#: ``admit_quantum`` codes (``gateway._REASON_CODES``), 5 is the
#: route-level "no live pool" denial, 0 means "no denial".
REASON_NONE = 0
REASON_POOL_UNAVAILABLE = 5
REASON_NAMES = {
    REASON_NONE: None,
    1: DenyReason.NOT_BOUND.value,
    2: DenyReason.CONCURRENCY.value,
    3: DenyReason.TOKEN_BUDGET.value,
    4: DenyReason.LOW_PRIORITY.value,
    REASON_POOL_UNAVAILABLE: DenyReason.POOL_UNAVAILABLE.value,
}
#: DenyReason → code (the scalar ``Gateway.handle`` path records
#: through enum values; the quantum paths carry kernel codes already)
REASON_CODES = {v: k for k, v in REASON_NAMES.items() if v is not None}

#: SoA ring columns.  Names are distinct from every resident /
#: request-table column (the analyzer's mirror & dtype rules match by
#: column NAME across all manifests).
_COLUMNS: dict[str, np.dtype] = {
    "rid_hash": np.dtype(np.int64),
    "t": np.dtype(np.float64),        # decision clock (sim seconds)
    "pool_id": np.dtype(np.int32),    # interned pool (-1: no pool)
    "ent_slot": np.dtype(np.int32),   # resident row (-1: not bound)
    "leg": np.dtype(np.int32),        # declared route position (-1: n/a)
    "verdict": np.dtype(np.int16),
    "reason": np.dtype(np.int16),
    "prio": np.dtype(np.float64),     # live Eq. 1 priority w
    "threshold": np.dtype(np.float64),  # pool admission threshold
    "level_at": np.dtype(np.float64),   # bucket level at decision
    "debt_at": np.dtype(np.float64),    # debt dim at decision
    "burst_at": np.dtype(np.float64),   # burst dim at decision
    "tokens_at": np.dtype(np.float64),  # charged tokens requested
    "seq": np.dtype(np.int64),        # global write sequence (1-based)
}


def column_manifest() -> dict:
    """Machine-readable column contract for the static analyzer (the
    telemetry twin of ``resident.column_manifest``).  No device
    mirror, no kernel-facing f32 columns — but the f64 value columns
    get dtype-discipline coverage the moment they land here."""
    return {
        "store": "FlightRecorder",
        "module": "repro_torch.telemetry.flight",
        "columns": {name: str(dtype) for name, dtype in _COLUMNS.items()},
        "mirrored": [],
        "kernel_f32": [],
        "sanctioned_mutators": [],
    }


def hash_ids(request_ids) -> np.ndarray:
    """Vectorize ``hash`` over request-id strings (C-speed map) —
    what lazy ``rid_hash`` materialization runs at query time."""
    return np.fromiter(map(hash, request_ids), np.int64,
                       count=len(request_ids))


@dataclasses.dataclass(frozen=True)
class FlightRow:
    """One materialized decision row (query results / explain legs)."""

    t: float
    pool: Optional[str]
    ent_slot: int
    leg: int
    verdict: int
    reason_code: int
    priority: float
    threshold: float
    bucket_level: float
    debt: float
    burst: float
    tokens: float
    seq: int

    @property
    def verdict_name(self) -> str:
        return VERDICT_NAMES.get(self.verdict, f"verdict{self.verdict}")

    @property
    def reason(self) -> Optional[str]:
        return REASON_NAMES.get(self.reason_code)


@dataclasses.dataclass(frozen=True)
class DecisionTrace:
    """The reconstructed multi-leg narrative for one request.  The
    summary properties reproduce the ``GatewayResponse`` attribution
    rules exactly (pinned request-by-request by the randomized parity
    sweep in the reference package's telemetry tests): admit anywhere → 200 with
    the admitting leg's pool/priority/hops; otherwise the FIRST
    denial's reason, with priority surfaced only for low-priority
    denials — same as ``_Pending.note_denial``."""

    request_id: str
    legs: tuple[FlightRow, ...]

    @property
    def _admit(self) -> Optional[FlightRow]:
        for row in self.legs:
            if row.verdict == VERDICT_ADMIT:
                return row
        return None

    @property
    def status(self) -> int:
        if self._admit is not None:
            return 200
        if self.legs[0].verdict == VERDICT_UNKNOWN_KEY:
            return 401
        return 429

    @property
    def reason(self) -> Optional[str]:
        if self._admit is not None:
            return None
        if self.legs[0].verdict == VERDICT_UNKNOWN_KEY:
            return "unknown_key"
        return self.legs[0].reason

    @property
    def priority(self) -> float:
        adm = self._admit
        if adm is not None:
            return adm.priority
        first = self.legs[0]
        if REASON_NAMES.get(first.reason_code) \
                == DenyReason.LOW_PRIORITY.value:
            return first.priority
        return 0.0

    @property
    def pool(self) -> Optional[str]:
        adm = self._admit
        return adm.pool if adm is not None else None

    @property
    def spill_hops(self) -> int:
        adm = self._admit
        return adm.leg if adm is not None else 0

    def narrative(self) -> str:
        """Human-readable multi-leg decision story."""
        lines = [f"{self.request_id}: status={self.status}"
                 + (f" reason={self.reason}" if self.reason else "")]
        for row in self.legs:
            where = (f"pool={row.pool} leg={row.leg}"
                     if row.pool is not None else "route")
            lines.append(
                f"  t={row.t:.3f} {where} -> {row.verdict_name}"
                + (f" ({row.reason})" if row.reason else "")
                + f" prio={row.priority:.3f}/thr={row.threshold:.3f}"
                + f" level={row.bucket_level:.1f} debt={row.debt:.3f}"
                + f" burst={row.burst:.3f} tokens={row.tokens:.0f}")
        return "\n".join(lines)


class FlightRecorder:
    """Fixed-capacity SoA decision ring (pow2, masked positions)."""

    def __init__(self, capacity: int = 65536) -> None:
        cap = 1
        while cap < max(2, capacity):
            cap *= 2
        self.capacity = cap
        self.col: dict[str, np.ndarray] = {
            name: np.zeros(cap, dtype)
            for name, dtype in _COLUMNS.items()}
        #: total rows ever written (ring head); row seq is 1-based
        self.head = 0
        #: raw request-id ring (pointer copies on the hot path); the
        #: ``rid_hash`` column is materialized LAZILY from this at
        #: query time so dispatch never pays the per-string hash loop
        self._rids = np.empty(cap, object)
        self._hashed_upto = 0
        self._pool_ids: dict[str, int] = {}
        self._pool_names: list[str] = []

    # -- pool interning ----------------------------------------------------
    def pool_id(self, name: str) -> int:
        pid = self._pool_ids.get(name)
        if pid is None:
            pid = len(self._pool_names)
            self._pool_ids[name] = pid
            self._pool_names.append(name)
        return pid

    def pool_name(self, pid: int) -> Optional[str]:
        if 0 <= pid < len(self._pool_names):
            return self._pool_names[pid]
        return None

    # -- recording ---------------------------------------------------------
    @hot_path
    def record_batch(self, rids, now: float,
                     pool_id, legs, ent_slots, verdicts, reasons,
                     prios, threshold, levels, debts, bursts,
                     tokens) -> None:
        """ONE masked scatter per column for a whole dispatch batch.
        ``rids`` is the raw request-id sequence (hashing is deferred to
        query time); every value argument may be a scalar (broadcast)
        or a length-m array.  A batch longer than the ring keeps its
        TAIL (newest rows win, same as sequential wraparound)."""
        m = len(rids)
        if m == 0:
            return
        cap = self.capacity
        if m > cap:
            drop = m - cap

            def tail(x):
                return x[drop:] if np.ndim(x) else x

            rids = rids[drop:]
            legs, ent_slots = tail(legs), tail(ent_slots)
            verdicts, reasons = tail(verdicts), tail(reasons)
            prios, levels = tail(prios), tail(levels)
            debts, bursts = tail(debts), tail(bursts)
            tokens = tail(tokens)
            self.head += drop
            m = cap
        start = self.head & (cap - 1)
        if start + m <= cap:               # no wrap: slice writes
            pos = slice(start, start + m)
        else:
            pos = (self.head + np.arange(m)) & (cap - 1)
        c = self.col
        self._rids[pos] = rids
        c["t"][pos] = now
        c["pool_id"][pos] = pool_id
        c["ent_slot"][pos] = ent_slots
        c["leg"][pos] = legs
        c["verdict"][pos] = verdicts
        c["reason"][pos] = reasons
        c["prio"][pos] = prios
        c["threshold"][pos] = threshold
        c["level_at"][pos] = levels
        c["debt_at"][pos] = debts
        c["burst_at"][pos] = bursts
        c["tokens_at"][pos] = tokens
        c["seq"][pos] = np.arange(self.head + 1, self.head + 1 + m)
        self.head += m

    def record(self, request_id: str, now: float,
               pool: Optional[str], leg: int, ent_slot: int,
               verdict: int, reason: int, priority: float,
               threshold: float, level: float, debt: float,
               burst: float, tokens: float) -> None:
        """Scalar oracle — one decision row, written independently of
        ``record_batch`` so the parity sweep pins batch == loop-of-
        scalar ring state.  Serves the scalar ``Gateway.handle``."""
        pos = self.head & (self.capacity - 1)
        c = self.col
        self._rids[pos] = request_id
        c["t"][pos] = now
        c["pool_id"][pos] = -1 if pool is None else self.pool_id(pool)
        c["ent_slot"][pos] = ent_slot
        c["leg"][pos] = leg
        c["verdict"][pos] = verdict
        c["reason"][pos] = reason
        c["prio"][pos] = priority
        c["threshold"][pos] = threshold
        c["level_at"][pos] = level
        c["debt_at"][pos] = debt
        c["burst_at"][pos] = burst
        c["tokens_at"][pos] = tokens
        self.head += 1
        c["seq"][pos] = self.head

    # -- queries -----------------------------------------------------------
    def _materialize(self) -> None:
        """Fill ``rid_hash`` for rows written since the last query —
        the hot path stores raw id pointers only, so the per-string
        hash loop runs at (cold) query time, amortized over the span
        written in between."""
        dirty = self.head - self._hashed_upto
        if dirty <= 0:
            return
        cap = self.capacity
        dirty = min(dirty, cap)
        start = (self.head - dirty) & (cap - 1)
        if start + dirty <= cap:
            pos = slice(start, start + dirty)
        else:
            pos = (self.head - dirty + np.arange(dirty)) & (cap - 1)
        self.col["rid_hash"][pos] = np.fromiter(
            map(hash, self._rids[pos]), np.int64, count=dirty)
        self._hashed_upto = self.head

    def _valid_mask(self) -> np.ndarray:
        """Rows not yet overwritten (and ever written: seq 0 = empty)."""
        return self.col["seq"] > max(0, self.head - self.capacity)

    def _row(self, i: int) -> FlightRow:
        c = self.col
        return FlightRow(
            t=float(c["t"][i]),
            pool=self.pool_name(int(c["pool_id"][i])),
            ent_slot=int(c["ent_slot"][i]),
            leg=int(c["leg"][i]),
            verdict=int(c["verdict"][i]),
            reason_code=int(c["reason"][i]),
            priority=float(c["prio"][i]),
            threshold=float(c["threshold"][i]),
            bucket_level=float(c["level_at"][i]),
            debt=float(c["debt_at"][i]),
            burst=float(c["burst_at"][i]),
            tokens=float(c["tokens_at"][i]),
            seq=int(c["seq"][i]))

    def explain(self, request_id: str) -> Optional[DecisionTrace]:
        """Reconstruct one request's decision narrative: every
        still-resident row whose rid hash matches, in decision (seq)
        order.  None once the ring has overwritten the request (or it
        was never seen)."""
        self._materialize()
        h = hash(request_id)
        c = self.col
        hits = np.flatnonzero((c["rid_hash"] == h) & self._valid_mask())
        if hits.size == 0:
            return None
        hits = hits[np.argsort(c["seq"][hits])]
        return DecisionTrace(
            request_id=request_id,
            legs=tuple(self._row(int(i)) for i in hits))

    def recent(self, n: int = 50, pool: Optional[str] = None,
               verdict: Optional[int] = None,
               reason: Optional[int] = None) -> list[FlightRow]:
        """The last ``n`` matching decisions, newest first."""
        c = self.col
        mask = self._valid_mask()
        if pool is not None:
            pid = self._pool_ids.get(pool)
            if pid is None:
                return []
            mask &= c["pool_id"] == pid
        if verdict is not None:
            mask &= c["verdict"] == verdict
        if reason is not None:
            mask &= c["reason"] == reason
        hits = np.flatnonzero(mask)
        hits = hits[np.argsort(c["seq"][hits])][::-1][:n]
        return [self._row(int(i)) for i in hits]

    def __len__(self) -> int:
        return min(self.head, self.capacity)
