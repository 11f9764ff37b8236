"""Vectorized admission path + back-compat shims over the unified
control plane.

Counterpart of ``repro/core/vectorized.py``.  This module keeps:

- :func:`admit_quantum` — exact sequential admission replay for one
  scheduling quantum: the gateway's default request path
  (``Gateway.handle_quantum`` batches each (pool, leg) group through
  one call).  On CUDA tensors it launches the hand-written kernel
  ``kernels/csrc/admit_quantum.cu``; on CPU tensors it runs that
  kernel's plain version (``kernels.admit_quantum``);
- :func:`arrays_from_pool` / :func:`quantum_snapshot` — O(1) views
  over a ``TokenPool``'s RESIDENT arrays (``core.resident``): the
  kernel state is the store's cached device mirror and bucket levels
  are one vectorized projection, with nothing mutated and nothing
  gathered per row;
- aliases (``PoolArrays``, ``tick_batch``, ``waterfill_batch``, …) so
  the reference's names keep working.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.control_plane import (
    BURSTOK_MASK as _BURSTOK,
    CLASS_CODES,
    CLASS_W as _W,
    ControlState,
    DEBTOK_MASK as _DEBTOK,
    ELASTIC_MASK as _ELASTIC,
    PROTECTED_MASK as _PROTECTED,
    allocate_rows as allocate_tps_batch,
    burst_delta_rows as burst_delta_batch,
    control_tick,
    ewma,
    priority_rows as priority_batch,
    waterfill_rows as waterfill_batch,
)
from repro_torch.core.types import PriorityCoefficients
from repro_torch.kernels.admit_quantum import admit_scan

#: Back-compat name: the array-of-rows state is the ControlState.
PoolArrays = ControlState


@torch.no_grad()
def tick_batch(arr: ControlState, capacity_tps: torch.Tensor,
               measured_tps: torch.Tensor, used_kv: torch.Tensor,
               used_conc: torch.Tensor, demand_tps: torch.Tensor,
               coeff: PriorityCoefficients = PriorityCoefficients(),
               ) -> tuple[ControlState, torch.Tensor, torch.Tensor]:
    """Legacy entry point: one tick with ℓ̄* computed as the live mean
    over bound rows (``control_tick`` takes it explicitly instead, so
    the pool can pin it via ``PoolSpec.fixed_avg_slo_ms``)."""
    n_bound = arr.bound.sum().clamp_min(1)
    avg_slo = torch.where(arr.bound, arr.slo_ms, 0.0).sum() / n_bound
    return control_tick(arr, capacity_tps, measured_tps, used_kv,
                        used_conc, demand_tps, avg_slo.clamp_min(1e-9),
                        coeff=coeff)


@torch.no_grad()
def admit_quantum(arr: ControlState,
                  bucket_level: torch.Tensor,    # f32 [N] tokens available
                  in_flight: torch.Tensor,       # i32 [N] RESIDENT seqs
                  kv_in_use: torch.Tensor,       # f32 [N]
                  pool_in_flight: int,
                  pool_conc_cap: float,
                  running_min_priority: float,   # inf if none
                  pool_avg_slo: float,
                  req_ent: torch.Tensor,         # i32 [M] entitlement row
                  req_tokens: torch.Tensor,      # f32 [M] input+max_tokens
                  req_kv: torch.Tensor,          # f32 [M] kv bytes needed
                  pool_resident: Optional[int] = None,  # RESIDENT seqs
                  req_live: Optional[torch.Tensor] = None,  # bool [M]
                  weights: Optional[torch.Tensor] = None,   # f32 [N] Eq. 1
                  coeff: PriorityCoefficients = PriorityCoefficients(),
                  slack: float = 0.0,
                  ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact sequential admission replay for one scheduling quantum.

    Requests are processed in array order (arrival order).  Returns
    (admitted bool [M], deny_reason int32 [M], priority f32 [M]) on the
    requests' device, with reason codes: 0=admitted, 1=not_bound,
    2=concurrency, 3=token_budget, 4=low_priority.  State updates
    (bucket charge, KV, the pool's admitted count, the running-min
    threshold) are applied between requests exactly as the scalar
    controller does; the inputs are not written.

    The row arrays and the request arrays live on one device: CUDA
    launches the kernel, the CPU runs its plain version.  The pool
    scalars are host numbers (float32 values; ``pool_in_flight`` and
    ``pool_resident`` counts).

    ``running_min_priority`` must be seeded with the LIVE priorities of
    the entitlements that currently own in-flight requests (use
    :func:`quantum_snapshot`, which seeds it from the same float32
    ``weights`` array it returns); ``pool_resident`` is the pool-wide
    count of RESIDENT sequences (frozen within a quantum) feeding the
    burst-class free-slot escape of check 3 — when omitted there is no
    escape.  ``req_live=False`` marks padding rows: they are denied
    without touching any state (their reason is still computed from
    their row).  Pass the snapshot's ``weights`` so the kernel and the
    threshold seed share one array; when omitted they are recomputed
    here."""
    m = req_ent.shape[0]
    dev = req_ent.device
    if pool_resident is None:
        # legacy callers: no resident count ⇒ no free-slot escape
        pool_resident = pool_conc_cap
    if weights is None:
        weights = priority_batch(
            arr, torch.tensor(pool_avg_slo, dtype=torch.float32,
                              device=arr.slo_ms.device), coeff)
    if req_live is None:
        req_live = torch.ones(m, dtype=torch.bool, device=dev)
    return admit_scan(
        arr.class_code, arr.bound, arr.baseline_kv, arr.baseline_conc,
        weights, bucket_level, in_flight, kv_in_use, req_ent, req_tokens,
        req_kv, req_live,
        pool_in_flight=int(pool_in_flight),
        pool_resident=np.float32(pool_resident),
        pool_conc_cap=np.float32(pool_conc_cap),
        running_min=np.float32(running_min_priority),
        # the reference multiplies the f32 threshold by the Python float
        # (1 - slack), which JAX rounds to f32 first
        slack_factor=np.float32(1.0 - slack))


def arrays_from_pool(pool, now: float = 0.0
                     ) -> tuple[ControlState, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Bridge: view a ``TokenPool``'s RESIDENT arrays in kernel form on
    the pool's device.  Returns (ControlState, bucket_levels, in_flight,
    kv_in_use) with rows in resident-slot order (``pool.store.slot_of``
    maps names to rows); free slots ride along as inert unbound rows, so
    the width is the store's pow2 capacity.

    Pure read: bucket levels are projected to ``now`` with one
    vectorized ``Ledger.peek_levels`` expression — snapshotting
    neither creates buckets nor advances refill clocks, so observing a
    pool cannot change any later admission decision.  The
    ``ControlState`` is the store's cached device mirror."""
    c = pool.store.col
    dev = pool.store.device
    # scalar fallback rate for bucketless rows: effective-or-baseline,
    # the same `eff or baseline` rule the scalar §4.3 pipeline applies
    fallback = np.where(c["eff_tps"] != 0.0, c["eff_tps"],
                        c["baseline_tps"].astype(np.float64))
    levels = pool.ledger.peek_levels(fallback, now)
    return (pool.store.device_state(),
            torch.from_numpy(levels.astype(np.float32)).to(dev),
            torch.from_numpy(c["resident"].astype(np.int32)).to(dev),
            torch.from_numpy(c["kv_in_use"].astype(np.float32)).to(dev))


def running_min_live(pool) -> float:
    """Seed for ``running_min_priority``: the minimum LIVE priority
    among entitlements that currently own in-flight requests — exactly
    what ``TokenPool.admission_threshold`` evaluates when the pool is
    contended.  +inf when the pool is empty.

    Scalar-oracle form (float64); :func:`quantum_snapshot` seeds the
    kernel with the float32 equivalent instead so a request whose OWN
    entitlement sets the threshold ties bit-exactly inside the kernel."""
    owners = {r.entitlement for r in pool.in_flight.values()}
    ws = [pool.priority(e) for e in owners if e in pool.entitlements]
    return min(ws) if ws else float("inf")


def _running_min_f32(pool, weights: torch.Tensor,
                     row_of: dict[str, int], mesh=None) -> float:
    """float32 twin of :func:`running_min_live`, evaluated on the SAME
    Eq. 1 weight array handed to ``admit_quantum`` — one computation
    serves both the seed and the kernel, so a request whose own
    entitlement sets the threshold ties bit-exactly.  Owner rows come
    straight off the request table's owner column (owner slots ARE
    store row indices, which is what ``weights`` is indexed by).  On a
    row mesh ``weights`` is this rank's block: each rank takes the
    minimum over its owners, then over the ranks (exact in any order)."""
    rows = pool.inflight_owner_slots()
    if not rows.size:
        return float("inf")
    if mesh is None:
        idx = torch.from_numpy(rows).to(weights.device)
        return float(weights[idx].min())
    lo, hi = pool.store.mirror_rows()
    rows = rows[(rows >= lo) & (rows < hi)] - lo
    local = (weights[torch.from_numpy(rows).to(weights.device)].min()
             if rows.size else weights.new_tensor(float("inf")))
    return float(mesh.gather_roots(local)[0].min())


@dataclasses.dataclass
class QuantumSnapshot:
    """Everything ``admit_quantum`` needs about one pool, snapshotted
    once per (pool, leg) batch by the gateway.  ``row_of`` maps
    entitlement name → row index in the arrays; ``weights`` holds the
    Eq. 1 row weights (pass them back to ``admit_quantum`` so the
    kernel and the ``running_min_priority`` seed share one array).
    Tensors are on the pool's device.  On a row mesh
    (``shard_plane.pool_mesh``) ``state`` and ``weights`` are this
    rank's row block (``pool.store.mirror_rows()``); the other arrays
    stay full width."""

    names: list[str]
    row_of: dict[str, int]
    state: ControlState
    bucket_level: torch.Tensor
    in_flight: torch.Tensor
    kv_in_use: torch.Tensor
    weights: torch.Tensor
    pool_in_flight: int
    pool_resident: int
    pool_conc_cap: float
    running_min_priority: float
    pool_avg_slo: float


def quantum_snapshot(pool, now: float) -> QuantumSnapshot:
    """Snapshot a ``TokenPool`` for one batched admission quantum.
    Pure read (see :func:`arrays_from_pool`): the state arrays are
    views of the pool's resident arrays — no per-row Python gather."""
    # deferred: shard_plane replays quanta through this module
    from repro_torch.core.shard_plane import pool_mesh
    state, levels, infl, kvu = arrays_from_pool(pool, now)
    row_of = dict(pool.store.slot_of)
    avg_slo = float(pool.pool_avg_slo())
    weights = priority_batch(
        state, torch.tensor(avg_slo, dtype=torch.float32,
                            device=state.slo_ms.device),
        pool.spec.coefficients)
    return QuantumSnapshot(
        names=list(pool.store.live_names()),
        row_of=row_of,
        state=state,
        bucket_level=levels,
        in_flight=infl,
        kv_in_use=kvu,
        weights=weights,
        pool_in_flight=pool.pool_in_flight(),
        pool_resident=pool.total_resident(),
        pool_conc_cap=float(pool.capacity().concurrency),
        running_min_priority=_running_min_f32(pool, weights, row_of,
                                              pool_mesh(pool)),
        pool_avg_slo=avg_slo,
    )
