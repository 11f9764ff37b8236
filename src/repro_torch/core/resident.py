"""Resident control-plane state — the arrays ARE the source of truth.

Counterpart of ``repro/core/resident.py``: the numpy host columns are
the same; the device mirror is a ``ControlState`` of torch tensors on
the store's device.  :class:`ResidentStore` owns the pool's state:

  * one structure-of-arrays per pool holds every control-plane column
    — class/baseline/SLO statics, the Eq. 2–3 ``burst``/``debt``
    EWMAs, the accounting-window accumulators (window tokens, demand
    window, demand EWMA), KV / concurrency in use, the token-bucket
    ledger columns (level / rate / refill clock), and the
    observability counters;
  * columns are padded to a power-of-two capacity with a free-slot
    list, so entitlement churn RECYCLES rows instead of reshaping the
    arrays — the tick's positional tree reductions see a stable pow2
    width;
  * :class:`ResidentStatus` is a *view* over one row: it exposes the
    exact ``EntitlementStatus`` attribute surface, but every read and
    write goes straight to the columns (``pool.status[name]`` hands
    out these views — dicts are views, arrays are truth);
  * the kernel-facing float32 columns are mirrored as a cached device
    ``ControlState``; Python-side writes invalidate the cache, the
    tick re-adopts its own device outputs, so steady-state ticking
    uploads nothing row-by-row;
  * :class:`ShardedResidentStore` partitions the rows into equal pow2
    shards with their own free lists and mirror blocks, so churn
    re-uploads one block; on a row mesh (``core.shard_plane``) each
    rank mirrors only its own blocks.

dtype discipline: columns feeding the f32 kernels (baselines, SLO,
burst, debt) are stored as float32 — numerically identical to the old
gather path, which cast the f64 status floats to f32 on every snapshot
(and scattered back ``float(f32)`` values).  Accumulator columns
(window/demand/bucket/KV) stay float64 so sequential accumulation
matches the scalar bookkeeping bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.control_plane import CLASS_CODES, ControlState, bucket_width
from repro_torch.core.shard_plane import store_mesh
from repro_torch.core.types import EntitlementState, EntitlementStatus, Resources

#: EntitlementState <-> int8 codes for the ``state_code`` column.
STATE_CODES: dict[EntitlementState, int] = {
    s: i for i, s in enumerate(EntitlementState)}
STATES: tuple[EntitlementState, ...] = tuple(EntitlementState)
_BOUND_CODE = STATE_CODES[EntitlementState.BOUND]

#: column name → dtype.  ``_F32_KERNEL`` columns feed the jit kernels
#: (device-mirrored); the rest are host-side truth.
_F32_KERNEL = ("baseline_tps", "baseline_kv", "baseline_conc", "slo_ms",
               "burst", "debt")
_COLUMNS: dict[str, np.dtype] = {
    "class_code": np.dtype(np.int32),
    "state_code": np.dtype(np.int8),
    "alive": np.dtype(bool),
    "bound": np.dtype(bool),
    **{c: np.dtype(np.float32) for c in _F32_KERNEL},
    # accounting accumulators (float64: sequential-accumulation parity
    # with the scalar bookkeeping)
    "window_tokens": np.dtype(np.float64),
    "measured_tps": np.dtype(np.float64),
    "kv_in_use": np.dtype(np.float64),
    "demand_window": np.dtype(np.float64),
    "demand_tps": np.dtype(np.float64),
    "eff_tps": np.dtype(np.float64),
    "eff_kv": np.dtype(np.float64),
    "eff_conc": np.dtype(np.float64),
    # token-bucket ledger columns (core.ledger.RowBucket views)
    "has_bucket": np.dtype(bool),
    "bucket_level": np.dtype(np.float64),
    "bucket_rate": np.dtype(np.float64),
    "bucket_refill": np.dtype(np.float64),
    "bucket_window": np.dtype(np.float64),
    # counters / observability
    "in_flight": np.dtype(np.int64),
    "resident": np.dtype(np.int64),
    "admitted_total": np.dtype(np.int64),
    "denied_total": np.dtype(np.int64),
    "denied_low_priority": np.dtype(np.int64),
    "completed_total": np.dtype(np.int64),
    "tokens_total": np.dtype(np.float64),
    "created_at": np.dtype(np.float64),
}

#: columns carried by the cached device ``ControlState`` mirror — any
#: host-side write to one of these MUST be followed by ``mark_dirty()``
#: (or adopt the kernel output via ``adopt_device``), else every later
#: admission kernel reads stale burst/debt.  Enforced statically by the
#: ``mirror-invalidation`` pass (``python -m repro_torch.analysis``).
_MIRRORED = ("class_code", "bound") + _F32_KERNEL

#: qualnames allowed to write mirrored columns WITHOUT a trailing
#: ``mark_dirty()`` — ``adopt_device`` replaces the cache wholesale.
_SANCTIONED_MUTATORS = ("ResidentStore.adopt_device",)


def column_manifest() -> dict:
    """Machine-readable column contract for the static analyzer:
    column dtypes, the device-mirrored set, the f32 kernel-facing set,
    and the sanctioned mirror mutators.  The analyzer seeds the
    mirror-invalidation and dtype-discipline passes from this, so a
    new column is covered the moment it lands in ``_COLUMNS``."""
    return {
        "store": "ResidentStore",
        "module": "repro_torch.core.resident",
        "columns": {name: str(dtype) for name, dtype in _COLUMNS.items()},
        "mirrored": list(_MIRRORED),
        "kernel_f32": list(_F32_KERNEL),
        "sanctioned_mutators": list(_SANCTIONED_MUTATORS),
    }


class ResidentStore:
    """Structure-of-arrays store for one pool's control-plane rows."""

    def __init__(self, capacity: int = 8, device="cuda") -> None:
        #: device of the ``ControlState`` mirror (the tick runs there)
        self.device = torch.device(device)
        self.capacity = bucket_width(max(1, capacity))
        self.slot_of: dict[str, int] = {}
        self.name_of: list[Optional[str]] = [None] * self.capacity
        # LIFO free list: recycling reuses the most recently freed slot
        self._free: list[int] = list(range(self.capacity - 1, -1, -1))
        self.col: dict[str, np.ndarray] = {
            name: np.zeros(self.capacity, dtype)
            for name, dtype in _COLUMNS.items()}
        self._device: Optional[ControlState] = None
        self._live_slots: Optional[np.ndarray] = None
        self._live_names: Optional[list[str]] = None
        #: bumps whenever capacity grows (array identities change)
        self.generation = 0
        #: opt-in ``repro_torch.core.ledger.LevelAudit`` (None = off); set by
        #: ``Ledger.enable_level_audit`` — sanctioned bucket_level
        #: mutators notify it so conservation checkers can diff
        self.level_audit = None
        #: mirror uploads: whole-mirror rebuilds and rows sent to the
        #: device in all
        self.full_uploads = 0
        self.uploaded_rows = 0

    # -- slot lifecycle -------------------------------------------------------
    def __len__(self) -> int:
        return len(self.slot_of)

    def __contains__(self, name: str) -> bool:
        return name in self.slot_of

    def allocate(self, name: str) -> int:
        """Claim a free slot for ``name`` (growing capacity ×2 when
        full — the only event that changes array shapes, bounding jit
        variants to log2(N)).  The slot's columns are zeroed."""
        if name in self.slot_of:
            raise ValueError(f"entitlement {name!r} already resident")
        if not self._free:
            self._grow()
        slot = self._free.pop()
        self.slot_of[name] = slot
        self.name_of[slot] = name
        for arr in self.col.values():          # recycled slots start clean
            arr[slot] = 0
        self.col["alive"][slot] = True
        if self.level_audit is not None:
            self.level_audit.note("lifecycle", slot)
        self._membership_changed()
        return slot

    def release(self, name: str) -> int:
        """Free ``name``'s slot.  The row is zeroed (inert for every
        kernel mask: unbound, zero baselines/EWMAs) and pushed on the
        free list for recycling."""
        slot = self.slot_of.pop(name)
        self.name_of[slot] = None
        for arr in self.col.values():
            arr[slot] = 0
        self._free.append(slot)
        if self.level_audit is not None:
            self.level_audit.note("lifecycle", slot)
        self._membership_changed()
        return slot

    def _grow(self) -> None:
        old = self.capacity
        new = old * 2
        for name, arr in self.col.items():
            grown = np.zeros(new, arr.dtype)
            grown[:old] = arr
            self.col[name] = grown
        self.name_of.extend([None] * (new - old))
        self._free.extend(range(new - 1, old - 1, -1))
        self.capacity = new
        self.generation += 1
        self._membership_changed()

    def _membership_changed(self) -> None:
        self._device = None
        self._live_slots = None
        self._live_names = None

    def mark_dirty(self) -> None:
        """A kernel-facing column was written host-side: drop the
        cached device mirror (rebuilt lazily from the numpy columns)."""
        self._device = None

    def mark_dirty_slot(self, slot: int) -> None:
        """Slot-granular mirror invalidation.  The flat store has no
        sub-mirror structure, so this is :meth:`mark_dirty`."""
        self.mark_dirty()

    # -- audit surface (public: chaos invariant checkers read these) ----------
    def row_accounting(self) -> dict:
        """Free-list / live-row closure snapshot: the invariant is
        ``live + free == capacity`` with the ``alive`` column agreeing
        on both counts."""
        return {
            "capacity": self.capacity,
            "live": len(self.slot_of),
            "free": len(self._free),
            "alive_rows": int(np.count_nonzero(self.col["alive"])),
        }

    def mirror_drift(self) -> dict[str, float]:
        """Max |device − host| per mirrored column, for the cached
        device mirror ONLY (empty dict when no mirror is cached — an
        invalidated mirror is coherent by definition).  Non-zero means
        a host write to a mirrored column skipped ``mark_dirty()``."""
        if self._device is None:
            return {}
        dev = self._device
        lo, hi = self.mirror_rows()
        out: dict[str, float] = {}
        for name in _MIRRORED:
            host = self.col[name][lo:hi]
            mirror = getattr(dev, name).cpu().numpy()
            out[name] = float(np.max(np.abs(
                mirror.astype(np.float64) - host.astype(np.float64))))
        return out

    # -- live-row views (cached until membership changes) ---------------------
    def live_slots(self) -> np.ndarray:
        if self._live_slots is None:
            self._live_slots = np.flatnonzero(self.col["alive"])
        return self._live_slots

    def live_names(self) -> list[str]:
        """Live entitlement names in slot order (cached)."""
        if self._live_names is None:
            self._live_names = [self.name_of[s] for s in self.live_slots()]
        return self._live_names

    # -- device mirror --------------------------------------------------------
    def mirror_rows(self) -> tuple[int, int]:
        """[lo, hi) of the slots this process mirrors on its device."""
        return 0, self.capacity

    def _upload(self, lo: int, hi: int) -> ControlState:
        c = self.col
        self.uploaded_rows += hi - lo
        return ControlState(**{
            f.name: torch.from_numpy(c[f.name][lo:hi].copy()).to(self.device)
            for f in dataclasses.fields(ControlState)})

    def device_state(self) -> ControlState:
        """Kernel-facing ``ControlState`` over the mirrored slots (all
        of them but on a row mesh; free slots are inert unbound rows).
        Cached: rebuilt only after host-side writes; after a tick the
        kernel's own output state is adopted via :meth:`adopt_device`,
        so steady-state ticking re-uploads nothing."""
        if self._device is None:
            self._device = self._upload(*self.mirror_rows())
            self.full_uploads += 1
        return self._device

    def adopt_device(self, state: ControlState, rows=None) -> None:
        """Adopt a tick's output state as the device mirror and sync the
        numpy burst/debt columns from it (two C-speed copies).  On a row
        mesh ``state`` is this rank's block and ``rows`` holds the full
        (burst, debt) host columns gathered from every rank."""
        burst, debt = rows if rows is not None else (
            state.burst.cpu().numpy(), state.debt.cpu().numpy())
        self.col["burst"][:] = burst
        self.col["debt"][:] = debt
        self._device = state

    # -- row <-> EntitlementStatus --------------------------------------------
    def view(self, name: str) -> "ResidentStatus":
        return ResidentStatus(self, self.slot_of[name])

    def snapshot_status(self, name: str) -> EntitlementStatus:
        """Materialize a detached ``EntitlementStatus`` copy of a row
        (migration payloads, debugging)."""
        v = self.view(name)
        return EntitlementStatus(
            state=v.state, in_flight=v.in_flight, resident=v.resident,
            kv_bytes_in_use=v.kv_bytes_in_use, debt=v.debt, burst=v.burst,
            effective=v.effective, window_tokens=v.window_tokens,
            measured_tps=v.measured_tps, admitted_total=v.admitted_total,
            denied_total=v.denied_total,
            denied_low_priority=v.denied_low_priority,
            completed_total=v.completed_total, tokens_total=v.tokens_total,
            created_at=v.created_at)

    def load_status(self, slot: int, st) -> None:
        """Write an ``EntitlementStatus``-shaped object into a row
        (attach side of a migration)."""
        v = ResidentStatus(self, slot)
        v.state = st.state
        v.in_flight = st.in_flight
        v.resident = st.resident
        v.kv_bytes_in_use = st.kv_bytes_in_use
        v.debt = st.debt
        v.burst = st.burst
        v.effective = st.effective
        v.window_tokens = st.window_tokens
        v.measured_tps = st.measured_tps
        v.admitted_total = st.admitted_total
        v.denied_total = st.denied_total
        v.denied_low_priority = st.denied_low_priority
        v.completed_total = st.completed_total
        v.tokens_total = st.tokens_total
        v.created_at = st.created_at


def _state_block(state: ControlState, lo: int, hi: int) -> ControlState:
    """Device-side row slice of a ``ControlState`` (views, no upload)."""
    return ControlState(**{
        f.name: getattr(state, f.name)[lo:hi]
        for f in dataclasses.fields(ControlState)})


class ShardedResidentStore(ResidentStore):
    """:class:`ResidentStore` partitioned into ``n_shards`` equal
    contiguous row blocks — the host-side half of the sharded control
    plane (``core.shard_plane``).

    Same columns, same view objects, same ``slot_of`` surface — the
    facade changes WHERE work lands, not what callers see:

      * **per-shard free lists**: allocation picks the emptiest shard
        and recycles within it, so entitlement churn touches exactly
        one block and never crosses shards;
      * **block-granular mirror invalidation**: ``mark_dirty_slot``
        marks only the owning shard's block stale; ``device_state()``
        re-uploads dirty blocks and concatenates them with the cached
        clean ones device-side — attach/detach/migration of one row
        re-uploads ``capacity/n_shards`` rows, not the pool
        (``block_uploads`` / ``full_uploads`` / ``uploaded_rows``
        counters pin this in tests);
      * **rank-local mirror**: on a row mesh (``shard_plane.store_mesh``)
        the host columns stay whole on every rank, but rank r mirrors,
        uploads and re-uploads only the shards of its row block r, and
        ``device_state()`` is that block;
      * **slot stability**: shards are equal blocks of the CURRENT
        capacity.  Growth doubles the whole store — slots never move
        (every persistent view/row index stays valid) — and the
        shard boundaries are recomputed with the free lists rebuilt,
        an O(N) step on the already-O(N) grow path.

    ``n_shards`` must be a power of two so shard blocks align with
    the pow2 rank blocks of any ``row_mesh`` of size ≤ ``n_shards``
    (the tree reductions are blocking-invariant, so ANY such mesh
    yields bit-identical decisions — mesh size is decoupled from the
    shard count)."""

    def __init__(self, capacity: int = 8, n_shards: int = 4,
                 device="cuda") -> None:
        if n_shards < 1 or n_shards & (n_shards - 1):
            raise ValueError(
                f"n_shards must be a power of two, got {n_shards}")
        super().__init__(max(capacity, n_shards), device=device)
        self.n_shards = n_shards
        #: global free list retired: per-shard LIFO lists own recycling
        self._free = []
        self._shard_free: list[list[int]] = []
        self._rebuild_shard_free(list(range(self.capacity - 1, -1, -1)))
        #: device ``ControlState`` blocks of the mirrored shards (None =
        #: no block cache; their concatenation == the mirror)
        self._device_blocks: Optional[dict[int, ControlState]] = None
        self._dirty_shards: set[int] = set()
        self.block_uploads = 0

    @property
    def shard_rows(self) -> int:
        return self.capacity // self.n_shards

    def shard_of(self, slot: int) -> int:
        return slot // self.shard_rows

    def shard_of_name(self, name: str) -> int:
        """Owning shard of a resident entitlement (routing surface)."""
        return self.shard_of(self.slot_of[name])

    def local_shards(self) -> range:
        """Shards this process mirrors: all, or on a row mesh the run
        of shards in this rank's row block."""
        mesh = store_mesh(self)
        if mesh is None:
            return range(self.n_shards)
        k = self.n_shards // mesh.size
        return range(mesh.rank * k, (mesh.rank + 1) * k)

    def mirror_rows(self) -> tuple[int, int]:
        local = self.local_shards()
        return local.start * self.shard_rows, local.stop * self.shard_rows

    def _rebuild_shard_free(self, free_desc: list[int]) -> None:
        """Rebuild per-shard LIFO free lists from a descending global
        free list (descending append ⇒ pop() yields ascending slots,
        matching the flat store's initial recycle order)."""
        rows = self.capacity // self.n_shards
        self._shard_free = [[] for _ in range(self.n_shards)]
        for slot in free_desc:
            self._shard_free[slot // rows].append(slot)

    def _pick_shard(self) -> Optional[int]:
        """Emptiest shard (ties → lowest id): balanced residency keeps
        per-rank work even across the mesh."""
        best, best_free = None, 0
        for s, fl in enumerate(self._shard_free):
            if len(fl) > best_free:
                best, best_free = s, len(fl)
        return best

    # -- slot lifecycle (shard-local churn) -----------------------------------
    def allocate(self, name: str) -> int:
        if name in self.slot_of:
            raise ValueError(f"entitlement {name!r} already resident")
        shard = self._pick_shard()
        if shard is None:
            self._grow()
            shard = self._pick_shard()
        slot = self._shard_free[shard].pop()
        self.slot_of[name] = slot
        self.name_of[slot] = name
        for arr in self.col.values():          # recycled slots start clean
            arr[slot] = 0
        self.col["alive"][slot] = True
        if self.level_audit is not None:
            self.level_audit.note("lifecycle", slot)
        self._membership_changed_shard(slot)
        return slot

    def release(self, name: str) -> int:
        slot = self.slot_of.pop(name)
        self.name_of[slot] = None
        for arr in self.col.values():
            arr[slot] = 0
        self._shard_free[self.shard_of(slot)].append(slot)
        if self.level_audit is not None:
            self.level_audit.note("lifecycle", slot)
        self._membership_changed_shard(slot)
        return slot

    def _grow(self) -> None:
        old = self.capacity
        kept = [s for fl in self._shard_free for s in fl]
        super()._grow()                        # doubles arrays + capacity
        self._free = []
        # shard BOUNDARIES move (shard_rows doubled); slots do not —
        # rebuild the free lists under the new mapping
        self._rebuild_shard_free(
            sorted(kept + list(range(old, self.capacity)), reverse=True))

    def _membership_changed_shard(self, slot: int) -> None:
        """Shard-local flavor of ``_membership_changed``: live caches
        drop (they index the whole store) but the mirror goes stale
        only in the owning shard's block."""
        self._live_slots = None
        self._live_names = None
        self.mark_dirty_slot(slot)

    def _membership_changed(self) -> None:
        super()._membership_changed()
        self._device_blocks = None
        self._dirty_shards.clear()

    # -- block-granular device mirror -----------------------------------------
    def mark_dirty(self) -> None:
        self._device = None
        self._device_blocks = None
        self._dirty_shards.clear()

    def mark_dirty_slot(self, slot: int) -> None:
        if self._device is not None:
            # split the (clean) mirror into blocks before any goes
            # stale — device-side slicing, no upload
            rows = self.shard_rows
            local = self.local_shards()
            base = local.start * rows
            self._device_blocks = {
                s: _state_block(self._device, s * rows - base,
                                (s + 1) * rows - base)
                for s in local}
            self._device = None
        if self._device_blocks is None:
            return                             # fully dirty: next build is full
        shard = self.shard_of(slot)
        if shard in self._device_blocks:       # another rank's block: its job
            self._dirty_shards.add(shard)

    def device_state(self) -> ControlState:
        if self._device is not None or self._device_blocks is None:
            return super().device_state()      # cached, or a full (re)build
        rows = self.shard_rows
        for s in sorted(self._dirty_shards):
            self._device_blocks[s] = self._upload(s * rows, (s + 1) * rows)
        self.block_uploads += len(self._dirty_shards)
        self._dirty_shards.clear()
        blocks = list(self._device_blocks.values())
        self._device = ControlState(**{
            f.name: torch.cat([getattr(b, f.name) for b in blocks])
            for f in dataclasses.fields(ControlState)})
        return self._device

    def adopt_device(self, state: ControlState, rows=None) -> None:
        super().adopt_device(state, rows)
        self._device_blocks = None             # blocks stale; resliced lazily
        self._dirty_shards.clear()

    # -- audit surface --------------------------------------------------------
    def row_accounting(self) -> dict:
        return {
            "capacity": self.capacity,
            "live": len(self.slot_of),
            "free": sum(len(fl) for fl in self._shard_free),
            "alive_rows": int(np.count_nonzero(self.col["alive"])),
            "n_shards": self.n_shards,
            "shard_free": [len(fl) for fl in self._shard_free],
        }


def _col_property(col: str, py, *, dirty: bool = False):
    """Property accessing ``store.col[col][slot]`` coerced through
    ``py`` (float/int); ``dirty=True`` invalidates the device mirror
    on write (kernel-facing columns only)."""

    def fget(self):
        return py(self._store.col[col][self._slot])

    if dirty:
        def fset(self, value):
            self._store.col[col][self._slot] = value
            self._store.mark_dirty_slot(self._slot)
    else:
        def fset(self, value):
            self._store.col[col][self._slot] = value

    return property(fget, fset)


class ResidentStatus:
    """``EntitlementStatus``-compatible VIEW over one resident row.

    Same attribute surface, but reads and writes go straight to the
    store columns — mutating the view mutates the arrays the kernels
    consume, and vice versa.  ``pool.status[name]`` returns these.
    """

    __slots__ = ("_store", "_slot")

    def __init__(self, store: ResidentStore, slot: int) -> None:
        self._store = store
        self._slot = slot

    @property
    def slot(self) -> int:
        return self._slot

    # lifecycle state: code column + derived kernel ``bound`` mask
    @property
    def state(self) -> EntitlementState:
        return STATES[self._store.col["state_code"][self._slot]]

    @state.setter
    def state(self, value: EntitlementState) -> None:
        s, i = self._store, self._slot
        s.col["state_code"][i] = STATE_CODES[value]
        s.col["bound"][i] = STATE_CODES[value] == _BOUND_CODE
        s.mark_dirty_slot(i)

    burst = _col_property("burst", float, dirty=True)
    debt = _col_property("debt", float, dirty=True)
    in_flight = _col_property("in_flight", int)
    resident = _col_property("resident", int)
    kv_bytes_in_use = _col_property("kv_in_use", float)
    window_tokens = _col_property("window_tokens", float)
    measured_tps = _col_property("measured_tps", float)
    admitted_total = _col_property("admitted_total", int)
    denied_total = _col_property("denied_total", int)
    denied_low_priority = _col_property("denied_low_priority", int)
    completed_total = _col_property("completed_total", int)
    tokens_total = _col_property("tokens_total", float)
    created_at = _col_property("created_at", float)

    @property
    def effective(self) -> Resources:
        s, i = self._store, self._slot
        return Resources(float(s.col["eff_tps"][i]),
                         float(s.col["eff_kv"][i]),
                         float(s.col["eff_conc"][i]))

    @effective.setter
    def effective(self, value: Resources) -> None:
        s, i = self._store, self._slot
        s.col["eff_tps"][i] = value.tokens_per_second
        s.col["eff_kv"][i] = value.kv_bytes
        s.col["eff_conc"][i] = value.concurrency

    def __repr__(self) -> str:  # debugging parity with the dataclass
        return (f"ResidentStatus(slot={self._slot}, state={self.state}, "
                f"in_flight={self.in_flight}, resident={self.resident}, "
                f"debt={self.debt}, burst={self.burst})")


@dataclasses.dataclass
class _DictView:
    """Read-only dict facade over a float64 column (legacy private
    surface: ``TokenPool._demand_tps`` used to be a plain dict; tests
    and tooling may still index it by name)."""

    store: ResidentStore
    column: str

    def __getitem__(self, name: str) -> float:
        return float(self.store.col[self.column][self.store.slot_of[name]])

    def get(self, name: str, default: float = 0.0) -> float:
        slot = self.store.slot_of.get(name)
        return default if slot is None else \
            float(self.store.col[self.column][slot])

    def __contains__(self, name: str) -> bool:
        return name in self.store.slot_of

    def __iter__(self):
        return iter(self.store.live_names())

    def __len__(self) -> int:
        return len(self.store.slot_of)

    def items(self):
        col = self.store.col[self.column]
        for name, slot in self.store.slot_of.items():
            yield name, float(col[slot])

    def keys(self):
        return list(self.store.slot_of)

    def values(self):
        return [v for _, v in self.items()]
