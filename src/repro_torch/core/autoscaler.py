"""Autoscaler — entitlement-driven capacity planning (paper Fig. 1,
"Dynamo planner" role).

Token pools authorize *both* admission and autoscaling from the same
capacity model: the desired replica count is derived from the very
entitlement/demand signals that admission uses, so what is promised and
what is provisioned stay consistent.

Policy (deterministic, hysteresis-damped):

  desired = ceil( max(replicas_for(reserved_baselines),
                      demand_ewma · headroom / per_replica_tps) )
  clamped to [minReplicas, maxReplicas]

  - ``reserved_baselines`` = Σ baselines (all three resource
    dimensions) of dedicated/guaranteed/elastic entitlements the pool
    has ACCEPTED — Bound *and* Degraded: a Degraded entitlement is a
    promise the pool cannot currently honor, which is exactly the
    signal that must raise capacity (counting only Bound would
    deadlock the authorize-shrink loop: a planner-shrunk pool could
    never grow back for a newly joined tenant).
  - ``demand_ewma`` tracks total admitted + denied token demand
    (seeded with the first observation — decaying up from 0.0 would
    under-provision the cold start), so denial pressure from
    burstable classes (spot backfill) can raise capacity up to the
    cap — burst is satisfied by *reallocating unused tokens first*,
    and only sustained unmet demand triggers scaling.
  - scale-down requires ``cooldown_ticks`` consecutive low-demand ticks
    (anti-flap); scale-up is immediate (protecting SLOs beats cost).

This scalar, single-pool planner is the PARITY ORACLE for the fleet
plan: ``core.fleet.plan_fleet`` executes the same policy for every
pool of the fleet in one call of elementwise tensor ops, and
``tests/test_torch_fleet.py`` pins the two decision-identical.  Any
policy change here must be mirrored there.

Counterpart of ``repro/core/autoscaler.py``: numpy float32 throughout,
with the reference's arithmetic as written (the EWMA unfused).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core.pool import TickRecord, TokenPool
from repro_torch.core.types import Resources


@dataclasses.dataclass(frozen=True)
class AutoscalerConfig:
    headroom: float = 1.2          # demand multiplier before scaling
    demand_ewma: float = 0.5       # smoothing of the demand signal
    cooldown_ticks: int = 5        # consecutive low ticks before shrink


@dataclasses.dataclass
class ScaleDecision:
    current: int
    desired: int
    reserved_tps: float
    demand_tps: float
    reason: str
    #: which pool this decision is for (filled by the fleet planner;
    #: the single-pool Autoscaler leaves its own pool implicit)
    pool: str = ""


def replicas_for(need: Resources, per_replica: Resources) -> float:
    """Fractional replicas required to hold ``need`` — the max over
    the three resource dimensions.  A dimension the replica shape does
    not provide (per-replica 0) but the need requires is unsatisfiable
    (inf → clamps to maxReplicas)."""

    def dim(need_v: float, per_v: float) -> float:
        if per_v > 0.0:
            return need_v / per_v
        return math.inf if need_v > 0.0 else 0.0

    return max(dim(need.tokens_per_second, per_replica.tokens_per_second),
               dim(need.kv_bytes, per_replica.kv_bytes),
               dim(need.concurrency, per_replica.concurrency))


class Autoscaler:
    def __init__(self, pool: TokenPool,
                 config: Optional[AutoscalerConfig] = None) -> None:
        # config is constructed per instance: a shared mutable default
        # instance would alias tuning across every autoscaler.  (The
        # other dataclass-valued defaults in core/ — QoS and
        # PriorityCoefficients — are frozen, so sharing them is safe.)
        self.pool = pool
        self.config = config if config is not None else AutoscalerConfig()
        self._demand: Optional[float] = None     # None until first obs
        self._low_ticks = 0

    def reserved_baseline(self) -> Resources:
        return self.pool.reserved_baseline()

    def reserved_tps(self) -> float:
        return self.reserved_baseline().tokens_per_second

    @property
    def demand_tps(self) -> float:
        return self._demand if self._demand is not None else 0.0

    def observe_demand(self, demand_tps: float) -> None:
        # float32 arithmetic end-to-end: this scalar policy is the
        # parity oracle for the f32 `fleet.plan_fleet`, and f64
        # here would flip ceil() on exact replica boundaries (e.g.
        # 400·1.2/240 straddles 2.0 differently in the two widths).
        d = np.float32(demand_tps)
        if self._demand is None:          # seed with the first observation
            self._demand = float(d)
            return
        g = self.config.demand_ewma
        self._demand = float(np.float32(g) * np.float32(self._demand)
                             + np.float32(1.0 - g) * d)

    def plan(self) -> ScaleDecision:
        pool = self.pool
        per = pool.spec.per_replica
        reserved = self.reserved_baseline()

        def dim(need: float, per_v: float) -> np.float32:
            need, per_v = np.float32(need), np.float32(per_v)
            if per_v > 0.0:
                return need / max(per_v, np.float32(1e-30))
            return np.float32(np.inf if need > 0.0 else 0.0)

        need_reserved = max(
            dim(reserved.tokens_per_second, per.tokens_per_second),
            dim(reserved.kv_bytes, per.kv_bytes),
            dim(reserved.concurrency, per.concurrency))
        need_demand = dim(
            np.float32(self.demand_tps) * np.float32(self.config.headroom),
            per.tokens_per_second)
        need = max(need_reserved, need_demand)
        # unsatisfiable dimension (inf need) clamps to maxReplicas
        desired = max(1, math.ceil(min(float(need), 1e9)))
        lo = pool.spec.scaling.min_replicas
        hi = pool.spec.scaling.max_replicas
        desired = min(hi, max(lo, desired))

        current = pool.replicas
        if desired > current:
            self._low_ticks = 0
            reason = ("scale_up:demand" if need_demand > need_reserved
                      else "scale_up:reserved")
        elif desired < current:
            self._low_ticks += 1
            if self._low_ticks < self.config.cooldown_ticks:
                desired = current        # hold during cooldown
                reason = "hold:cooldown"
            else:
                reason = "scale_down"
                self._low_ticks = 0
        else:
            self._low_ticks = 0
            reason = "steady"
        return ScaleDecision(current=current, desired=desired,
                             reserved_tps=reserved.tokens_per_second,
                             demand_tps=self.demand_tps, reason=reason,
                             pool=pool.spec.name)

    def step(self, record: Optional[TickRecord] = None) -> ScaleDecision:
        """Observe demand, plan, and apply.

        Demand is fed from the ``TickRecord.demand_tps`` the control
        plane already emits (pass the pool's latest record); without
        one, the pool's public :meth:`TokenPool.demand_snapshot` is
        read — never the private accounting dicts.
        """
        demand = (record.demand_tps if record is not None
                  else self.pool.demand_snapshot())
        self.observe_demand(sum(demand.values()))
        decision = self.plan()
        if decision.desired != decision.current:
            # The scalar oracle only moves RUNTIME capacity; the fleet
            # planner (PoolManager.plan_quantum) additionally reconciles
            # the virtual-node promise ceiling via authorize_replicas.
            self.pool.set_replicas(decision.desired)
        return decision
