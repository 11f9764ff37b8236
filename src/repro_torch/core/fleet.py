"""Fleet capacity planner — entitlement-driven autoscaling + cross-pool
rebalancing on the vectorized control plane.

The paper's central claim is that token pools authorize *both*
admission and autoscaling from one capacity model.  This module is the
autoscaling half at FLEET scale: :func:`plan_fleet` consumes the
per-pool signals the batched accounting tick already produces (demand
EWMA, reserved baselines, replica bounds) and emits, in one call of
elementwise tensor ops over the whole fleet, a :class:`ScaleDecision`
per pool — the reserved-floor + headroom-on-demand policy with
scale-down hysteresis of the scalar ``core.autoscaler`` (which survives
as the single-pool PARITY ORACLE; ``tests/test_torch_fleet.py`` pins
the two decision-identical).

On top of the scale decisions, :class:`FleetPlanner` proposes
cross-pool REBALANCES: an ELASTIC/SPOT entitlement that stays
underserved on a scarce pool (debt above threshold, or allocation
persistently below its demand) for ``starve_persistence_ticks``
consecutive plans is migrated to the slack pool with the most headroom
(capacity-aware pool selection in the spirit of token-budget-aware
pool routing; debt-based fairness per VTC).

Migration invariants (``TokenPool.detach_entitlement`` /
``attach_entitlement``, applied by ``PoolManager.migrate_entitlement``):

  * the ledger bucket moves with its ACCRUED LEVEL and outstanding
    charges — no budget is minted or burned by a move (the burst
    window re-bases to the target ledger, clamping if smaller);
  * ``EntitlementStatus`` moves verbatim — debt, burst and usage
    counters carry, so an underserved tenant arrives at the target
    with the compensatory priority it is owed (cross-pool debt);
  * in-flight records move — completions settle on the NEW owner,
    which also holds their charges;
  * the demand EWMA moves — the target's next tick sees the real
    demand instead of a cold start;
  * the source lease is released before the target lease is
    submitted; the target's authorized ceiling is raised first
    (``PoolManager.migrate_entitlement``) so a planner-shrunk target
    does not spuriously degrade the arrival.

The closed control loop this enables (wired through
``PoolManager.plan_quantum``):

  admission → batched tick → plan_fleet → authorize/provision →
  admission

— the same signals that deny spot traffic also raise capacity, which
is the paper's consistency story (``benchmarks/experiment3_autoscale``).

Counterpart of ``repro/core/fleet.py``.  The reference's
``plan_fleet`` is a jitted ``vmap`` (not a Pallas kernel); here it is a
dozen torch ops over [P] tensors on the fleet's device.  On the CPU its
five outputs are bit for bit the reference's: XLA contracts the demand
EWMA ``g·prev + (1−g)·demand`` into a fused multiply-add, and so does
this module (``control_plane.ewma``, fault C1).  :class:`FleetPlanner`
plans on the device of the pools' resident stores: one host-to-device
copy of the padded inputs, one device-to-host copy of the outputs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core import control_plane
from repro_torch.core.autoscaler import ScaleDecision, replicas_for
from repro_torch.core.markers import device_kernel
from repro_torch.core.pool import TickRecord, TokenPool
from repro_torch.core.types import ServiceClass

#: Reason codes emitted by :func:`plan_fleet` (index = code), matching
#: the scalar ``Autoscaler.plan`` reason strings.
REASONS = ("steady", "scale_up:reserved", "scale_up:demand",
           "hold:cooldown", "scale_down")
_STEADY, _UP_RESERVED, _UP_DEMAND, _HOLD, _DOWN = range(5)


@dataclasses.dataclass(frozen=True)
class FleetPlannerConfig:
    """Scale policy (identical semantics to ``AutoscalerConfig``) plus
    the rebalance policy knobs."""

    headroom: float = 1.2          # demand multiplier before scaling
    demand_ewma: float = 0.5       # smoothing of the demand signal
    cooldown_ticks: int = 5        # consecutive low ticks before shrink
    #: elastic entitlements migrate once their debt EWMA crosses this
    debt_migrate_threshold: float = 0.25
    #: spot entitlements count as starved when alloc < frac · demand
    starve_frac: float = 0.5
    #: consecutive starved plans before a migration is proposed
    starve_persistence_ticks: int = 3
    #: plans an entitlement is pinned to its pool after migrating
    migrate_cooldown_ticks: int = 10
    #: migrations proposed per scarce pool per plan (anti-thrash)
    max_migrations_per_pool: int = 1


@dataclasses.dataclass(frozen=True)
class RebalanceProposal:
    """Move ``entitlement`` from the scarce ``src`` to the slack
    ``dst``, carrying ``debt`` (the Eq. 2 EWMA at proposal time)."""

    entitlement: str
    src: str
    dst: str
    debt: float
    baseline_tps: float
    reason: str                     # "debt" | "starved_demand"


@dataclasses.dataclass
class FleetPlan:
    """One planning round: per-pool decisions + rebalance proposals.
    ``applied``/``preempted`` are filled by ``PoolManager.plan_quantum``
    when the plan is executed."""

    decisions: dict[str, ScaleDecision]
    migrations: list[RebalanceProposal]
    #: replicas the fleet cannot place (need beyond maxReplicas), tok/s
    #: equivalent — scarcity observability, keyed by pool
    unmet_replicas: dict[str, float]
    applied: list[RebalanceProposal] = dataclasses.field(
        default_factory=list)
    #: proposals NOT applied because the destination pool lost its
    #: replicas between planning and execution (same-quantum failure) —
    #: the entitlement stays put rather than migrating into a dead pool
    skipped: list[RebalanceProposal] = dataclasses.field(
        default_factory=list)
    preempted: dict[str, list[str]] = dataclasses.field(
        default_factory=dict)
    #: pools whose AUTHORIZED replica count moved this round, as
    #: (old, new) — one entry per actual scaling event, unlike the
    #: per-round decisions which repeat desired > current every tick
    #: while provisioning lag is converging
    scale_events: dict[str, tuple[int, int]] = dataclasses.field(
        default_factory=dict)


@device_kernel(oracle="repro.core.fleet.plan_fleet")
@torch.no_grad()
def plan_fleet(current: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
               per_tps: torch.Tensor, per_kv: torch.Tensor,
               per_conc: torch.Tensor, res_tps: torch.Tensor,
               res_kv: torch.Tensor, res_conc: torch.Tensor,
               demand_tps: torch.Tensor, ewma_prev: torch.Tensor,
               seeded: torch.Tensor, low_ticks: torch.Tensor,
               config: FleetPlannerConfig = FleetPlannerConfig(),
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor, torch.Tensor]:
    """One scale plan for the WHOLE fleet — the tensor mirror of the
    scalar ``Autoscaler.observe_demand`` + ``Autoscaler.plan`` pair.

    Every argument is a [P] tensor on one device (int32 ``current``,
    ``lo``, ``hi``, ``low_ticks``; bool ``seeded``; float32 the rest);
    the returns are ``(desired, reason_code, demand_ewma, low_ticks,
    need_replicas)``, all [P] (int32, int32, f32, int32, f32).
    ``need_replicas`` is the unclamped fractional requirement —
    ``need > hi`` means the pool is SCARCE (feeds the rebalancer),
    ``need < hi`` leaves slack.  Padding rows (see
    ``FleetPlanner._arrays``) use per_replica 1 / bounds [1, 1] so they
    stay inert and finite."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32,   # noqa: E731
                                 device=demand_tps.device)
    zero, inf = f32(0.0), f32(float("inf"))
    ewma = torch.where(
        seeded, control_plane.ewma(ewma_prev, demand_tps,
                                   config.demand_ewma), demand_tps)

    def dim(need, per):
        return torch.where(per > 0.0, need / per.clamp_min(1e-30),
                           torch.where(need > 0.0, inf, zero))

    need_reserved = torch.maximum(
        dim(res_tps, per_tps),
        torch.maximum(dim(res_kv, per_kv), dim(res_conc, per_conc)))
    need_demand = dim(ewma * f32(config.headroom), per_tps)
    need = torch.maximum(need_reserved, need_demand)
    # an unsatisfiable dimension (need inf) must clamp UP to hi, not
    # wrap through the int cast — bound the ceil operand first
    desired = torch.ceil(need.clamp_max(1e9)).to(torch.int32).clamp_min(1)
    desired = torch.minimum(torch.maximum(desired, lo), hi)

    scale_up = desired > current
    scale_dn = desired < current
    hold = scale_dn & (low_ticks + 1 < config.cooldown_ticks)
    new_low = torch.where(hold, low_ticks + 1, 0).to(torch.int32)
    desired = torch.where(hold, current, desired)

    def code(c):
        return torch.tensor(c, dtype=torch.int32, device=desired.device)

    reason = torch.where(
        scale_up,
        torch.where(need_demand > need_reserved, code(_UP_DEMAND),
                    code(_UP_RESERVED)),
        torch.where(hold, code(_HOLD),
                    torch.where(scale_dn, code(_DOWN), code(_STEADY))))
    return desired, reason, ewma, new_low, need


def _reserve_replicas(espec, pool: TokenPool) -> float:
    """Replica cost of hosting an entitlement's reserve on ``pool`` —
    the same rule the virtual-node lease uses: spot/preemptible
    reserve nothing."""
    if espec.qos.service_class in (ServiceClass.SPOT,
                                   ServiceClass.PREEMPTIBLE):
        return 0.0
    return max(0.0, replicas_for(espec.baseline, pool.spec.per_replica))


@dataclasses.dataclass
class _PoolPlanState:
    """Planner-side hysteresis state for one pool."""

    ewma: float = 0.0
    seeded: bool = False
    low_ticks: int = 0


#: ``FleetPlanner._arrays`` fields in the order of :func:`plan_fleet`'s
#: arguments, with their dtypes and padding fills
_FIELDS = (("current", np.int32, 1), ("lo", np.int32, 1),
           ("hi", np.int32, 1), ("per_tps", np.float32, 1.0),
           ("per_kv", np.float32, 1.0), ("per_conc", np.float32, 1.0),
           ("res_tps", np.float32, 0.0), ("res_kv", np.float32, 0.0),
           ("res_conc", np.float32, 0.0), ("demand_tps", np.float32, 0.0),
           ("ewma_prev", np.float32, 0.0), ("seeded", np.bool_, False),
           ("low_ticks", np.int32, 0))


class FleetPlanner:
    """Stateful shell around :func:`plan_fleet` + the rebalancer.

    Holds the per-pool demand EWMA / cooldown state and the
    per-entitlement starvation counters between plans; each
    :meth:`plan` call gathers the fleet's signals (padded to a
    power-of-two pool bucket, as the reference pads them), runs ONE
    :func:`plan_fleet` on the fleet's device, and derives rebalance
    proposals from the scarcity outputs.  ``device=None`` plans on the
    device of the pools' resident stores."""

    def __init__(self, config: Optional[FleetPlannerConfig] = None,
                 device=None) -> None:
        self.config = (config if config is not None
                       else FleetPlannerConfig())
        self.device = None if device is None else torch.device(device)
        self._state: dict[str, _PoolPlanState] = {}
        self._starved: dict[str, int] = {}          # entitlement → plans
        self._cooldown: dict[str, int] = {}         # entitlement → plans
        self._plans = 0

    # -- signal gathering ------------------------------------------------------
    @staticmethod
    def pool_demand(pool: TokenPool,
                    record: Optional[TickRecord]) -> float:
        """Total demand (tok/s) — the sum of the demand EWMAs the tick
        emits (admitted + denied demand, so denial pressure raises
        capacity).  Without a tick record this is one masked column sum
        over the pool's resident arrays (``demand_total_tps``), not a
        per-name dict walk."""
        if record is None:
            return pool.demand_total_tps()
        return float(sum(record.demand_tps.values()))

    def _arrays(self, pools: dict[str, TokenPool],
                records: dict[str, TickRecord]) -> tuple[list, dict]:
        names = sorted(pools)
        width = control_plane.bucket_width(len(names))
        arr = {k: np.full(width, fill, dt) for k, dt, fill in _FIELDS}
        for i, name in enumerate(names):
            pool = pools[name]
            st = self._state.setdefault(name, _PoolPlanState())
            reserved = pool.reserved_baseline()
            per = pool.spec.per_replica
            arr["current"][i] = pool.replicas
            arr["lo"][i] = pool.spec.scaling.min_replicas
            arr["hi"][i] = pool.spec.scaling.max_replicas
            arr["per_tps"][i] = per.tokens_per_second
            arr["per_kv"][i] = per.kv_bytes
            arr["per_conc"][i] = per.concurrency
            arr["res_tps"][i] = reserved.tokens_per_second
            arr["res_kv"][i] = reserved.kv_bytes
            arr["res_conc"][i] = reserved.concurrency
            arr["demand_tps"][i] = self.pool_demand(
                pool, records.get(name))
            arr["ewma_prev"][i] = st.ewma
            arr["seeded"][i] = st.seeded
            arr["low_ticks"][i] = st.low_ticks
        return names, arr

    def _device_of(self, pools: dict[str, TokenPool]) -> torch.device:
        if self.device is not None:
            return self.device
        devices = {pool.store.device for pool in pools.values()}
        if len(devices) != 1:
            raise ValueError(f"the fleet's pools live on several devices "
                             f"{sorted(map(str, devices))}; give the "
                             f"planner a device")
        return devices.pop()

    @staticmethod
    def _upload(arr: dict, device: torch.device) -> dict:
        """The padded host arrays as :func:`plan_fleet`'s arguments on
        ``device``, in ONE host-to-device copy: the 13 fields travel in
        one int32 buffer (float32 fields by bit pattern)."""
        width = len(arr["current"])
        buf = np.empty((len(_FIELDS), width), np.int32)
        for i, (k, dt, _) in enumerate(_FIELDS):
            buf[i] = arr[k].view(np.int32) if dt is np.float32 else arr[k]
        dev = torch.from_numpy(buf).to(device)
        return {k: (dev[i].view(torch.float32) if dt is np.float32
                    else dev[i] != 0 if dt is np.bool_ else dev[i])
                for i, (k, dt, _) in enumerate(_FIELDS)}

    @staticmethod
    def _download(outs: tuple) -> tuple:
        """:func:`plan_fleet`'s five outputs on the host, in ONE
        device-to-host copy (float32 outputs by bit pattern)."""
        desired, reason, ewma, low, need = outs
        out = torch.stack([desired, reason, ewma.view(torch.int32), low,
                           need.view(torch.int32)]).cpu().numpy()
        return (out[0], out[1], out[2].view(np.float32), out[3],
                out[4].view(np.float32))

    # -- the plan --------------------------------------------------------------
    def plan(self, pools: dict[str, TokenPool],
             records: Optional[dict[str, TickRecord]] = None,
             now: float = 0.0) -> FleetPlan:
        """One planning round over the fleet: ONE ``plan_fleet`` call
        + the Python-side rebalance pass."""
        records = records or {}
        self._plans += 1
        # drop state of pools that left the fleet
        for gone in set(self._state) - set(pools):
            del self._state[gone]
        if not pools:
            return FleetPlan(decisions={}, migrations=[],
                             unmet_replicas={})
        names, arr = self._arrays(pools, records)
        desired, reason, ewma, low, need = self._download(plan_fleet(
            **self._upload(arr, self._device_of(pools)),
            config=self.config))

        decisions: dict[str, ScaleDecision] = {}
        unmet: dict[str, float] = {}
        for i, name in enumerate(names):
            st = self._state[name]
            st.ewma = float(ewma[i])
            st.seeded = True
            st.low_ticks = int(low[i])
            decisions[name] = ScaleDecision(
                current=int(arr["current"][i]), desired=int(desired[i]),
                reserved_tps=float(arr["res_tps"][i]),
                demand_tps=float(ewma[i]),
                reason=REASONS[int(reason[i])], pool=name)
            over = float(need[i]) - float(arr["hi"][i])
            if over > 1e-6:
                unmet[name] = over
        migrations = self._rebalance(pools, records, names, need, arr)
        return FleetPlan(decisions=decisions, migrations=migrations,
                         unmet_replicas=unmet)

    # -- rebalancing -----------------------------------------------------------
    def _starvation(self, pool: TokenPool, name: str,
                    record: Optional[TickRecord]) -> Optional[str]:
        """Starvation signal for one elastic/spot entitlement, or None."""
        st = pool.status[name]
        klass = pool.entitlements[name].qos.service_class
        if klass is ServiceClass.ELASTIC \
                and st.debt >= self.config.debt_migrate_threshold:
            return "debt"
        if record is None:
            return None
        demand = record.demand_tps.get(name, 0.0)
        alloc = record.allocations.get(name, 0.0)
        if demand > 1e-9 and alloc < self.config.starve_frac * demand:
            return "starved_demand"
        return None

    def _rebalance(self, pools: dict[str, TokenPool],
                   records: dict[str, TickRecord], names: list[str],
                   need: np.ndarray, arr: dict) -> list[RebalanceProposal]:
        cfg = self.config
        hi = {n: float(arr["hi"][i]) for i, n in enumerate(names)}
        need_by = {n: float(need[i]) for i, n in enumerate(names)}
        slack = {n: hi[n] - need_by[n] for n in names}

        # 1. persistence counters for every migratable entitlement
        live: set[str] = set()
        for pname in names:
            pool = pools[pname]
            rec = records.get(pname)
            for ent, espec in pool.entitlements.items():
                if espec.qos.service_class not in (ServiceClass.ELASTIC,
                                                   ServiceClass.SPOT):
                    continue
                live.add(ent)
                if self._starvation(pool, ent, rec) is not None:
                    self._starved[ent] = self._starved.get(ent, 0) + 1
                else:
                    self._starved.pop(ent, None)
        for gone in set(self._starved) - live:
            del self._starved[gone]

        # 2. proposals: scarce pools shed their most-indebted starved
        #    entitlements onto the slackest pool that can hold them
        proposals: list[RebalanceProposal] = []
        for src in names:
            if need_by[src] <= hi[src] + 1e-6:
                continue                             # not scarce
            pool = pools[src]
            rec = records.get(src)
            candidates = []
            for ent, espec in pool.entitlements.items():
                if espec.qos.service_class not in (ServiceClass.ELASTIC,
                                                   ServiceClass.SPOT):
                    continue
                if self._starved.get(ent, 0) < cfg.starve_persistence_ticks:
                    continue
                if self._plans - self._cooldown.get(ent, -10**9) \
                        < cfg.migrate_cooldown_ticks:
                    continue
                why = self._starvation(pool, ent, rec)
                if why is None:
                    continue
                candidates.append((pool.status[ent].debt,
                                   ent, espec, why))
            candidates.sort(key=lambda c: (-c[0], c[1]))
            moved = 0
            for debt, ent, espec, why in candidates:
                if moved >= cfg.max_migrations_per_pool:
                    break
                dst = self._pick_target(pools, names, src, espec, slack)
                if dst is None:
                    continue
                slack[dst] -= _reserve_replicas(espec,
                                                pools[dst])
                self._cooldown[ent] = self._plans
                self._starved.pop(ent, None)
                proposals.append(RebalanceProposal(
                    entitlement=ent, src=src, dst=dst, debt=float(debt),
                    baseline_tps=espec.baseline.tokens_per_second,
                    reason=why))
                moved += 1
        return proposals

    def _pick_target(self, pools: dict[str, TokenPool], names: list[str],
                     src: str, espec, slack: dict[str, float]
                     ) -> Optional[str]:
        """Slackest pool (≠ src) whose remaining headroom under
        maxReplicas can absorb the entitlement's baseline reserve."""
        best, best_slack = None, 0.0
        for dst in names:
            if dst == src:
                continue
            remaining = slack[dst] - _reserve_replicas(espec, pools[dst])
            if remaining < -1e-6:
                continue
            if best is None or slack[dst] > best_slack:
                best, best_slack = dst, slack[dst]
        return best
