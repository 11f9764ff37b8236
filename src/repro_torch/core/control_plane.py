"""The unified control plane in PyTorch — the paper's capacity model
(Eq. 1–3 + priority-weighted water-filling) over rows of tensors.

Every accounting tick runs here: ``TokenPool.tick`` hands its resident
:class:`ControlState` (on the pool's device) to :func:`control_tick`,
and scatters the results back into the ledger and per-entitlement
status.  ``PoolManager`` stacks P pools along a leading pool axis and
ticks them in one :func:`control_tick_pools` call.  Entitlements are
rows; service classes are small int codes.

Counterpart of ``repro/core/control_plane.py``.  On the CPU the results
are bit-for-bit those of the JAX ``control_tick``.  XLA contracts six
multiply-adds of the tick into fused multiply-adds, so a plain
transcription differs in the last bit; :func:`fma` reproduces them:

  * the burst and debt EWMAs ``γ·prev + (1−γ)·x`` (:func:`ewma`);
  * the three ``1 + α·x`` factors of Eq. 1 (:func:`priority_rows`);
  * the water-fill completion test ``room − 1e-6·max(1, want)``.

Pool-level aggregates reduce with the same positional binary tree as
the reference (:func:`tree_sum`), never with ``torch.sum``'s
backend-chosen order.  With ``mesh=`` (a ``shard_plane.RowMesh``) the
rows are one rank's block and the block roots combine across the ranks
through the top of the same tree, which is how ``shard_plane`` runs
this very tick body sharded.  The water-fill loop is a Python loop with the
reference ``while_loop``'s condition; on a CUDA tensor each round reads
its condition back to the host.  With a leading pool axis it runs while
ANY pool is still active and freezes the pools that are done, as the
reference's ``vmap`` of a ``while_loop`` does.

The module also keeps :func:`reference_tick`, the naive pure-Python
replay of the same math on the scalar oracle functions — the TEST
ORACLE; production code never calls it.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from repro_torch.core.markers import device_kernel
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
    the tick evolves.  Every field is a tensor on one device: [N] for
    one pool, [P, N] with a leading pool axis for
    :func:`control_tick_pools`.
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


def _rows(x: torch.Tensor) -> torch.Tensor:
    """A per-pool scalar ([] or [P]) broadcast against its pool's rows."""
    return x.unsqueeze(-1)


def priority_rows(state: ControlState, pool_avg_slo: torch.Tensor,
                  coeff: PriorityCoefficients) -> torch.Tensor:
    """Eq. (1), row-parallel."""
    w_class = _lookup(CLASS_W, state.class_code)
    slo_f = 1.0 / fma(coeff.alpha_slo,
                      state.slo_ms / _rows(pool_avg_slo), 1.0)
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
# Any contiguous pow2 blocking of the rows computes the same partials:
# per-rank subtrees plus the top tree over the gathered block roots IS
# the full single-device tree, so a row mesh changes no bit.

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


def _trees(mesh, *reductions) -> list[torch.Tensor]:
    """One positional-tree reduction of the (pow2-padded) row axis per
    ``(x, op)`` pair.  With a row mesh each local root is one rank's
    subtree; the roots of all the pairs cross the ranks in ONE combine
    (rank order = block order) and are paired on up."""
    roots = [_pairwise(_pad_pow2(x), op) for x, op in reductions]
    if mesh is None:
        return roots
    return [_pairwise(g, op) for g, (_, op)
            in zip(mesh.gather_roots(*roots), reductions)]


def tree_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Binary-tree sum over the row axis; non-pow2 widths pad with
    zeros (exact for adds)."""
    return _trees(mesh, (x, torch.add))[0]


def tree_any(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Binary-tree logical-or over the row axis (pad with False)."""
    return _trees(mesh, (x, torch.logical_or))[0]


def tree_count(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Row count of a bool mask as int32 (integer adds are exact, so
    any order agrees — the tree keeps the structure uniform)."""
    return tree_sum(x.to(torch.int32), mesh)


def waterfill_rows(capacity: torch.Tensor, want: torch.Tensor,
                   weight: torch.Tensor, max_rounds: int = 32,
                   mesh=None) -> torch.Tensor:
    """Priority-weighted progressive water-filling (tensor mirror of
    ``core.pool.waterfill``): the reference ``while_loop`` as a Python
    loop with the same ``cond``; converges in ≤ #distinct-caps rounds,
    bounded by ``max_rounds``.  ``capacity`` is a per-pool scalar ([] or
    [P]); with a pool axis every pool keeps its own loop state, the loop
    runs while any pool's ``cond`` holds, and a pool whose ``cond``
    failed keeps its state unchanged (``vmap`` of a ``while_loop``).

    With ``mesh`` the rows are one rank's block: every value the loop
    condition reads (remaining, the round counter, any-active) comes
    from combined tree reductions, so all ranks run the same rounds and
    meet at the same collectives — two a round, each carrying every
    reduction that is ready."""
    want = want.clamp_min(0.0)
    active = want > 1e-12
    alloc = torch.zeros_like(want)
    remaining = capacity.clamp_min(0.0)
    i = torch.zeros_like(remaining, dtype=torch.int32)
    has_active = tree_any(active, mesh)
    while True:
        run = (remaining > 1e-9) & has_active & (i < max_rounds)
        if not bool(run.any()):
            return alloc
        w = torch.where(active, weight, 0.0)
        total_w, n_active = _trees(mesh, (w, torch.add),
                                   (active.to(torch.int32), torch.add))
        total_w_safe = torch.where(total_w > 0.0, total_w, 1.0)
        share = torch.where(
            _rows(total_w > 0.0),
            _rows(remaining) * (w / _rows(total_w_safe)),
            torch.where(active, _rows(remaining / n_active.clamp_min(1)),
                        0.0))
        room = want - alloc
        take = torch.where(active, torch.minimum(room, share), 0.0)
        new_alloc = alloc + take
        # done when the share covered the remaining room — compare take
        # to room with a magnitude-scaled epsilon (f32-safe)
        newly_done = active & (take >= fma(-1e-6, want.clamp_min(1.0),
                                           room))
        new_active = active & ~newly_done
        # scalar loop breaks when a round fills nobody (``progress``)
        taken, progress, new_has_active = _trees(
            mesh, (take, torch.add), (newly_done, torch.logical_or),
            (new_active, torch.logical_or))
        new_remaining = remaining - taken
        new_i = torch.where(progress, i + 1, max_rounds)
        # a pool whose cond failed keeps its state (vmap of while_loop)
        alloc = torch.where(_rows(run), new_alloc, alloc)
        active = torch.where(_rows(run), new_active, active)
        remaining = torch.where(run, new_remaining, remaining)
        i = torch.where(run, new_i, i)
        has_active = torch.where(run, new_has_active, has_active)


def allocate_rows(capacity: torch.Tensor, state: ControlState,
                  weights: torch.Tensor, demand_tps: torch.Tensor,
                  mesh=None) -> torch.Tensor:
    """Funding allocation with work conservation (the Table-1 ordering):
    protected funded at baseline (emergency-scaled if their *active* use
    exceeds capacity) → elastic demand-capped baselines water-filled →
    work-conserving backfill of the surplus to burst-eligible classes."""
    live = state.bound
    protected = live & _lookup(PROTECTED_MASK, state.class_code)
    base_p = torch.where(protected, state.baseline_tps, 0.0)
    active_p = torch.minimum(base_p,
                             torch.where(protected, demand_tps, 0.0))
    total_active_p = tree_sum(active_p, mesh)
    emergency = total_active_p > capacity
    scale = torch.where(emergency,
                        capacity / total_active_p.clamp_min(1e-30), 1.0)
    alloc_p = base_p * _rows(scale)
    remaining = torch.where(
        emergency, 0.0, (capacity - total_active_p).clamp_min(0.0))

    elastic = live & _lookup(ELASTIC_MASK, state.class_code)
    want_e = torch.where(elastic,
                         torch.minimum(state.baseline_tps, demand_tps), 0.0)
    fill_e = waterfill_rows(remaining, want_e,
                            torch.where(elastic, weights, 0.0), mesh=mesh)
    alloc = alloc_p + fill_e
    remaining = (remaining - tree_sum(fill_e, mesh)).clamp_min(0.0)

    burst_ok = live & _lookup(BURSTOK_MASK, state.class_code)
    used = torch.where(protected, active_p, torch.minimum(alloc, demand_tps))
    want_b = torch.where(burst_ok, (demand_tps - used).clamp_min(0.0), 0.0)
    fill_b = waterfill_rows(remaining, want_b,
                            torch.where(burst_ok, weights, 0.0), mesh=mesh)
    return alloc + fill_b


def _tick_impl(state: ControlState, capacity_tps: torch.Tensor,
               measured_tps: torch.Tensor, used_kv: torch.Tensor,
               used_conc: torch.Tensor, demand_tps: torch.Tensor,
               avg_slo_ms: torch.Tensor, coeff: PriorityCoefficients,
               mesh=None,
               ) -> tuple[ControlState, torch.Tensor, torch.Tensor]:
    """Tick body: burst EWMA → priority → allocation → debt EWMA (the
    scalar controller's steps 2–5).  Shared by :func:`control_tick`,
    :func:`control_tick_pools` and ``shard_plane.shard_tick`` (with
    ``mesh``: the rows are one rank's block)."""
    delta = burst_delta_rows(measured_tps, used_kv, used_conc, state)
    burst = ewma(state.burst, delta, coeff.gamma_burst)
    s1 = dataclasses.replace(state, burst=burst)

    weights = priority_rows(s1, avg_slo_ms.clamp_min(1e-9), coeff)
    alloc = allocate_rows(capacity_tps, s1, weights, demand_tps,
                          mesh=mesh)

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


@device_kernel(oracle="repro.core.control_plane.control_tick")
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


@device_kernel(oracle="repro.core.control_plane.control_tick_pools")
@torch.no_grad()
def control_tick_pools(states: ControlState, capacity_tps: torch.Tensor,
                       measured_tps: torch.Tensor, used_kv: torch.Tensor,
                       used_conc: torch.Tensor, demand_tps: torch.Tensor,
                       avg_slo_ms: torch.Tensor,
                       coeff: PriorityCoefficients = PriorityCoefficients(),
                       ) -> tuple[ControlState, torch.Tensor, torch.Tensor]:
    """Batched tick across P pools: every array carries a leading pool
    axis ([P, N] rows, [P] scalars) and the whole fleet ticks in one
    call.  The reference ``vmap``s the tick body; here the pool axis is
    written out (per-pool scalars broadcast over their rows, tree
    reductions run per pool, and the water-fill freezes pools that are
    done).  Pools with fewer rows are padded with unbound rows (see
    :func:`pad_state`) — padding cannot affect live rows because every
    mask is ANDed with ``bound``."""
    return _tick_impl(states, capacity_tps, measured_tps, used_kv,
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
    """Right-pad a row vector to ``n_rows`` (the single source of the
    padding idiom — ``pad_state``, ``PoolManager.tick`` and the
    gateway's quantum batches all bucket through this)."""
    n = x.shape[0]
    if n == n_rows:
        return x
    return torch.cat([x, x.new_full((n_rows - n,), fill)])


def pad_state(state: ControlState, n_rows: int) -> ControlState:
    """Right-pad a state to ``n_rows`` with inert rows: unbound, zero
    baselines, class 0.  Unbound rows are excluded from every allocation
    mask and their EWMAs see zero inputs, so they stay identically zero."""
    if state.n_rows == n_rows:
        return state
    return ControlState(
        class_code=pad_rows(state.class_code, n_rows),
        bound=pad_rows(state.bound, n_rows, False),
        baseline_tps=pad_rows(state.baseline_tps, n_rows),
        baseline_kv=pad_rows(state.baseline_kv, n_rows),
        baseline_conc=pad_rows(state.baseline_conc, n_rows),
        slo_ms=pad_rows(state.slo_ms, n_rows, 1.0),
        burst=pad_rows(state.burst, n_rows),
        debt=pad_rows(state.debt, n_rows),
    )


def stack_states(states: Sequence[ControlState],
                 width: int = 0) -> ControlState:
    """Stack per-pool states (padded to a common width — at least the
    widest state; pass ``width`` to bucket it) along a new leading
    pool axis."""
    width = max(width, max(s.n_rows for s in states))
    padded = [pad_state(s, width) for s in states]
    return ControlState(**{
        f.name: torch.stack([getattr(s, f.name) for s in padded])
        for f in dataclasses.fields(ControlState)})


# -- the scalar test oracle ---------------------------------------------------

@dataclasses.dataclass
class OracleRow:
    """One entitlement row for :func:`reference_tick` — plain floats."""

    service_class: ServiceClass
    bound: bool
    baseline_tps: float
    baseline_kv: float
    baseline_conc: float
    slo_ms: float
    burst: float
    debt: float
    measured_tps: float = 0.0
    used_kv: float = 0.0
    used_conc: float = 0.0
    demand_tps: float = 0.0


def reference_tick(rows: list[OracleRow], capacity_tps: float,
                   avg_slo_ms: float,
                   coeff: PriorityCoefficients = PriorityCoefficients(),
                   ) -> tuple[list[OracleRow], list[float], list[float]]:
    """Pure-Python per-entitlement replay of the tick — the TEST ORACLE.

    A dict loop over ``core.priority`` Eq. 1–3 plus ``core.pool.waterfill``.
    Returns (updated rows, allocations, priority weights) in row order.
    O(N) Python; never call it from the serving path.
    """
    from repro_torch.core import priority as prio
    from repro_torch.core.pool import waterfill
    from repro_torch.core.types import (
        BURST_CLASSES,
        DEBT_CLASSES,
        PROTECTED_CLASSES,
        Resources,
    )

    rows = [dataclasses.replace(r) for r in rows]
    idx = list(range(len(rows)))

    # burst EWMA (Eq. 3) then priority (Eq. 1)
    weights: list[float] = []
    for r in rows:
        delta = prio.burst_overconsumption(
            Resources(r.measured_tps, r.used_kv, r.used_conc),
            Resources(r.baseline_tps, r.baseline_kv, r.baseline_conc))
        r.burst = prio.burst_update(r.burst, delta, coeff.gamma_burst)
        weights.append(prio.priority_weight(
            r.service_class, r.slo_ms, max(avg_slo_ms, 1e-9),
            r.burst, r.debt, coeff))

    # allocation: protected reserved → elastic baselines → backfill
    alloc = [0.0] * len(rows)
    live = [i for i in idx if rows[i].bound]
    protected = [i for i in live
                 if rows[i].service_class in PROTECTED_CLASSES]
    base_p = {i: rows[i].baseline_tps for i in protected}
    active_p = {i: min(base_p[i], rows[i].demand_tps) for i in protected}
    total_active_p = sum(active_p.values())
    if total_active_p > capacity_tps and total_active_p > 0:
        scale = capacity_tps / total_active_p
        for i in protected:
            alloc[i] = base_p[i] * scale
        remaining = 0.0
    else:
        for i in protected:
            alloc[i] = base_p[i]
        remaining = max(0.0, capacity_tps - total_active_p)

        elastic = [i for i in live
                   if rows[i].service_class is ServiceClass.ELASTIC]
        want_e = {i: min(rows[i].baseline_tps, rows[i].demand_tps)
                  for i in elastic}
        fill = waterfill(remaining, want_e, {i: weights[i] for i in elastic})
        for i in elastic:
            alloc[i] = fill[i]
        remaining = max(0.0, remaining - sum(fill.values()))

        burst_ok = [i for i in live
                    if rows[i].service_class in BURST_CLASSES]
        want_b = {}
        for i in burst_ok:
            used = (active_p[i] if i in active_p
                    else min(alloc[i], rows[i].demand_tps))
            want_b[i] = max(0.0, rows[i].demand_tps - used)
        fill = waterfill(remaining, want_b, {i: weights[i] for i in burst_ok})
        for i in burst_ok:
            alloc[i] += fill[i]

    # debt EWMA (Eq. 2) for debt-bearing classes
    for i, r in enumerate(rows):
        if r.service_class not in DEBT_CLASSES:
            continue
        demand, base = r.demand_tps, r.baseline_tps
        if demand <= 1e-9 or base <= 0.0:
            gap = 0.0
        else:
            served = max(r.measured_tps, min(alloc[i], demand))
            entitled_now = min(base, max(demand, served))
            gap = (entitled_now - served) / base
        gap = min(coeff.gap_clip, max(-coeff.gap_clip, gap))
        r.debt = min(coeff.debt_max, max(
            coeff.debt_min, prio.debt_update(r.debt, gap, coeff.gamma_debt)))
    return rows, alloc, weights


def state_from_rows(rows: Sequence[OracleRow],
                    device="cuda") -> ControlState:
    """Build a ControlState on ``device`` from oracle rows (tests)."""
    def col(values, dtype):
        return torch.tensor(values, dtype=dtype, device=device)

    return ControlState(
        class_code=col([CLASS_CODES[r.service_class] for r in rows],
                       torch.int32),
        bound=col([r.bound for r in rows], torch.bool),
        baseline_tps=col([r.baseline_tps for r in rows], torch.float32),
        baseline_kv=col([r.baseline_kv for r in rows], torch.float32),
        baseline_conc=col([r.baseline_conc for r in rows], torch.float32),
        slo_ms=col([r.slo_ms for r in rows], torch.float32),
        burst=col([r.burst for r in rows], torch.float32),
        debt=col([r.debt for r in rows], torch.float32),
    )
