"""The unified control plane in PyTorch — the paper's capacity model
(Eq. 1–3 + priority-weighted water-filling) over rows of tensors.

Every accounting tick runs here: ``TokenPool.tick`` hands its resident
:class:`ControlState` (on the pool's device) to :func:`control_tick`,
and scatters the results back into the ledger and per-entitlement
status.  Entitlements are rows; service classes are small int codes.

Counterpart of ``repro/core/control_plane.py``.  On the CPU the results
are bit-for-bit those of the JAX ``control_tick``.  XLA contracts six
multiply-adds of the tick into fused multiply-adds, so a plain
transcription differs in the last bit; :func:`fma` reproduces them:

  * the burst and debt EWMAs ``γ·prev + (1−γ)·x`` (:func:`ewma`);
  * the three ``1 + α·x`` factors of Eq. 1 (:func:`priority_rows`);
  * the water-fill completion test ``room − 1e-6·max(1, want)``.

Pool-level aggregates reduce with the same positional binary tree as
the reference (:func:`tree_sum`), never with ``torch.sum``'s
backend-chosen order.  The water-fill loop is a Python loop with the
reference ``while_loop``'s condition; on a CUDA tensor each round reads
its condition back to the host.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.types import PriorityCoefficients, ServiceClass

# class codes (row order matters: used for lookups)
CLASS_CODES: dict[ServiceClass, int] = {
    ServiceClass.DEDICATED: 0,
    ServiceClass.GUARANTEED: 1,
    ServiceClass.ELASTIC: 2,
    ServiceClass.SPOT: 3,
    ServiceClass.PREEMPTIBLE: 4,
}
CLASS_W = (1000.0, 1000.0, 100.0, 1.0, 0.1)                 # CLASS_WEIGHT
PROTECTED_MASK = (True, True, False, False, False)
BURSTOK_MASK = (True, False, True, True, True)              # Table 1 "Burst"
DEBTOK_MASK = (False, False, True, False, False)            # debt classes
ELASTIC_MASK = (False, False, True, False, False)


@dataclasses.dataclass(frozen=True)
class ControlState:
    """Per-entitlement state-of-the-world, array-of-rows layout.

    The first six fields mirror the EntitlementSpec (static between
    membership changes); ``burst``/``debt`` are the Eq. 2–3 EWMAs that
    the tick evolves.  Every field is a 1-D tensor on one device.
    """

    class_code: torch.Tensor     # int32 [N]
    bound: torch.Tensor          # bool  [N]
    baseline_tps: torch.Tensor   # f32 [N] λ_e
    baseline_kv: torch.Tensor    # f32 [N] χ_e
    baseline_conc: torch.Tensor  # f32 [N] r_e
    slo_ms: torch.Tensor         # f32 [N] ℓ*_e
    burst: torch.Tensor          # f32 [N] b_e
    debt: torch.Tensor           # f32 [N] d_e

    @property
    def n_rows(self) -> int:
        return self.class_code.shape[-1]


def _lookup(table: tuple, codes: torch.Tensor) -> torch.Tensor:
    """Per-row class-table gather (f32 for weights, bool for masks)."""
    dtype = torch.bool if isinstance(table[0], bool) else torch.float32
    return torch.tensor(table, dtype=dtype, device=codes.device)[codes.long()]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a·b + c`` with the product unrounded — what XLA emits for
    the reference's multiply-adds.  The f32·f32 product is exact in f64,
    so only the sum rounds (then once more to f32)."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (_f32(x, ref).double() for x in (a, b, c))
    return (a * b + c).float()


def priority_rows(state: ControlState, pool_avg_slo: torch.Tensor,
                  coeff: PriorityCoefficients) -> torch.Tensor:
    """Eq. (1), row-parallel."""
    w_class = _lookup(CLASS_W, state.class_code)
    slo_f = 1.0 / fma(coeff.alpha_slo, state.slo_ms / pool_avg_slo, 1.0)
    burst_f = 1.0 / fma(coeff.alpha_burst, state.burst.clamp_min(0.0), 1.0)
    debt_f = fma(coeff.alpha_debt, state.debt, 1.0).clamp_min(1e-3)
    return w_class * slo_f * burst_f * debt_f


def burst_delta_rows(used_tps: torch.Tensor, used_kv: torch.Tensor,
                     used_conc: torch.Tensor,
                     state: ControlState) -> torch.Tensor:
    """Eq. (3), row-parallel, matching the scalar zero-baseline rule:
    a dimension with no baseline contributes 1 whenever it is used."""

    def term(used, base):
        over = (used / base.clamp_min(1e-30) - 1.0).clamp_min(0.0)
        return torch.where(base > 0.0, over, (used > 0.0).float())

    return (term(used_tps, state.baseline_tps)
            + term(used_kv, state.baseline_kv)
            + term(used_conc, state.baseline_conc))


def ewma(prev: torch.Tensor, x: torch.Tensor, gamma: float) -> torch.Tensor:
    """Eq. (2) form: γ·prev + (1−γ)·x, with the reference's fused add."""
    return fma(gamma, prev, _f32(1.0 - gamma, x) * x)


# -- shard-stable reductions --------------------------------------------------
#
# Pool-level aggregates reduce the row axis with a FIXED binary tree
# over the pow2-padded rows: the pairing depends only on element
# POSITION, exactly as in the reference, so sums agree bit for bit.

def _pairwise(x: torch.Tensor, op) -> torch.Tensor:
    """Reduce the trailing (pow2) axis with positional pairing."""
    while x.shape[-1] > 1:
        x = op(x[..., 0::2], x[..., 1::2])
    return x[..., 0]


def _pad_pow2(x: torch.Tensor) -> torch.Tensor:
    w = bucket_width(x.shape[-1])
    if w == x.shape[-1]:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (w - x.shape[-1],))],
                     dim=-1)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Binary-tree sum over the row axis; non-pow2 widths pad with
    zeros (exact for adds)."""
    return _pairwise(_pad_pow2(x), torch.add)


def tree_any(x: torch.Tensor) -> torch.Tensor:
    """Binary-tree logical-or over the row axis (pad with False)."""
    return _pairwise(_pad_pow2(x), torch.logical_or)


def tree_count(x: torch.Tensor) -> torch.Tensor:
    """Row count of a bool mask as int32 (integer adds are exact, so
    any order agrees — the tree keeps the structure uniform)."""
    return tree_sum(x.to(torch.int32))


def waterfill_rows(capacity: torch.Tensor, want: torch.Tensor,
                   weight: torch.Tensor,
                   max_rounds: int = 32) -> torch.Tensor:
    """Priority-weighted progressive water-filling (tensor mirror of
    ``core.pool.waterfill``): the reference ``while_loop`` as a Python
    loop with the same ``cond``; converges in ≤ #distinct-caps rounds,
    bounded by ``max_rounds``."""
    want = want.clamp_min(0.0)
    active = want > 1e-12
    alloc = torch.zeros_like(want)
    remaining = capacity.clamp_min(0.0)
    i = 0
    has_active = tree_any(active)
    while bool((remaining > 1e-9) & has_active) and i < max_rounds:
        w = torch.where(active, weight, 0.0)
        total_w = tree_sum(w)
        n_active = tree_count(active)
        total_w_safe = torch.where(total_w > 0.0, total_w, 1.0)
        share = torch.where(
            total_w > 0.0,
            remaining * (w / total_w_safe),
            torch.where(active, remaining / n_active.clamp_min(1), 0.0))
        room = want - alloc
        take = torch.where(active, torch.minimum(room, share), 0.0)
        alloc = alloc + take
        remaining = remaining - tree_sum(take)
        # done when the share covered the remaining room — compare take
        # to room with a magnitude-scaled epsilon (f32-safe)
        newly_done = active & (take >= fma(-1e-6, want.clamp_min(1.0),
                                           room))
        # scalar loop breaks when a round fills nobody
        progress = bool(tree_any(newly_done))
        active = active & ~newly_done
        i = i + 1 if progress else max_rounds
        has_active = tree_any(active)
    return alloc


def allocate_rows(capacity: torch.Tensor, state: ControlState,
                  weights: torch.Tensor,
                  demand_tps: torch.Tensor) -> torch.Tensor:
    """Funding allocation with work conservation (the Table-1 ordering):
    protected funded at baseline (emergency-scaled if their *active* use
    exceeds capacity) → elastic demand-capped baselines water-filled →
    work-conserving backfill of the surplus to burst-eligible classes."""
    live = state.bound
    protected = live & _lookup(PROTECTED_MASK, state.class_code)
    base_p = torch.where(protected, state.baseline_tps, 0.0)
    active_p = torch.minimum(base_p,
                             torch.where(protected, demand_tps, 0.0))
    total_active_p = tree_sum(active_p)
    emergency = total_active_p > capacity
    scale = torch.where(emergency,
                        capacity / total_active_p.clamp_min(1e-30), 1.0)
    alloc_p = base_p * scale
    remaining = torch.where(
        emergency, 0.0, (capacity - total_active_p).clamp_min(0.0))

    elastic = live & _lookup(ELASTIC_MASK, state.class_code)
    want_e = torch.where(elastic,
                         torch.minimum(state.baseline_tps, demand_tps), 0.0)
    fill_e = waterfill_rows(remaining, want_e,
                            torch.where(elastic, weights, 0.0))
    alloc = alloc_p + fill_e
    remaining = (remaining - tree_sum(fill_e)).clamp_min(0.0)

    burst_ok = live & _lookup(BURSTOK_MASK, state.class_code)
    used = torch.where(protected, active_p, torch.minimum(alloc, demand_tps))
    want_b = torch.where(burst_ok, (demand_tps - used).clamp_min(0.0), 0.0)
    fill_b = waterfill_rows(remaining, want_b,
                            torch.where(burst_ok, weights, 0.0))
    return alloc + fill_b


def _tick_impl(state: ControlState, capacity_tps: torch.Tensor,
               measured_tps: torch.Tensor, used_kv: torch.Tensor,
               used_conc: torch.Tensor, demand_tps: torch.Tensor,
               avg_slo_ms: torch.Tensor, coeff: PriorityCoefficients,
               ) -> tuple[ControlState, torch.Tensor, torch.Tensor]:
    """Tick body: burst EWMA → priority → allocation → debt EWMA (the
    scalar controller's steps 2–5)."""
    delta = burst_delta_rows(measured_tps, used_kv, used_conc, state)
    burst = ewma(state.burst, delta, coeff.gamma_burst)
    s1 = dataclasses.replace(state, burst=burst)

    weights = priority_rows(s1, avg_slo_ms.clamp_min(1e-9), coeff)
    alloc = allocate_rows(capacity_tps, s1, weights, demand_tps)

    # Eq. 2 debt: underservice only counts against live demand, service
    # is the measured completion rate floored by demand-capped funding.
    served = torch.maximum(measured_tps, torch.minimum(alloc, demand_tps))
    entitled_now = torch.minimum(s1.baseline_tps,
                                 torch.maximum(demand_tps, served))
    gap = torch.where(
        (demand_tps > 1e-9) & (s1.baseline_tps > 0.0),
        (entitled_now - served) / s1.baseline_tps.clamp_min(1e-30),
        0.0)
    gap = gap.clamp(-coeff.gap_clip, coeff.gap_clip)
    debtok = _lookup(DEBTOK_MASK, s1.class_code)
    debt = torch.where(
        debtok,
        ewma(s1.debt, gap, coeff.gamma_debt).clamp(coeff.debt_min,
                                                   coeff.debt_max),
        s1.debt)
    return dataclasses.replace(s1, debt=debt), alloc, weights


@torch.no_grad()
def control_tick(state: ControlState, capacity_tps: torch.Tensor,
                 measured_tps: torch.Tensor, used_kv: torch.Tensor,
                 used_conc: torch.Tensor, demand_tps: torch.Tensor,
                 avg_slo_ms: torch.Tensor,
                 coeff: PriorityCoefficients = PriorityCoefficients(),
                 ) -> tuple[ControlState, torch.Tensor, torch.Tensor]:
    """One accounting tick for one pool: returns (new state,
    allocations λ̂, priority weights), all on ``state``'s device.
    ``capacity_tps`` and ``avg_slo_ms`` are 0-d f32 tensors there;
    ``avg_slo_ms`` is ℓ̄* — the caller owns the Fixed-vs-live-mean
    policy (PoolSpec.fixed_avg_slo_ms)."""
    return _tick_impl(state, capacity_tps, measured_tps, used_kv,
                      used_conc, demand_tps, avg_slo_ms, coeff)


# -- padding helpers ------------------------------------------------------------

def bucket_width(n_rows: int) -> int:
    """Next power of two ≥ ``n_rows`` (min 1).  The resident stores pad
    their rows to pow2 buckets, so every pool-level tree reduction runs
    over the same positional tree as the reference."""
    return max(1, 1 << (max(n_rows, 1) - 1).bit_length())


def quantum_width(n_requests: int) -> int:
    """Pad width for the REQUEST axis of an admission quantum: pow2
    buckets up to 4096, quarter-steps (5/8, 6/8, 7/8 of the next
    pow2) between octaves above that (the reference's padding rule,
    kept so both packages pad quanta identically)."""
    w = bucket_width(n_requests)
    if n_requests > 4096:
        step = w >> 3
        for num in (5, 6, 7):
            c = step * num
            if n_requests <= c:
                return c
    return w


def pad_rows(x: torch.Tensor, n_rows: int, fill=0) -> torch.Tensor:
    """Right-pad a row vector to ``n_rows``."""
    n = x.shape[0]
    if n == n_rows:
        return x
    return torch.cat([x, x.new_full((n_rows - n,), fill)])
