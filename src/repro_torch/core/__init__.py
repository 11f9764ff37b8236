"""Token pools in PyTorch — the control plane of the serve path.

Counterpart of ``repro.core``, holding what the token-pool-gated serve
path uses:

- types: ServiceClass, Resources, QoS, EntitlementSpec, PoolSpec, ...
- control_plane: THE tick over rows of tensors (single pool and the
  batched multi-pool tick), plus the scalar test oracle
- priority: Eq. (1)-(3) scalar math
- resident: ResidentStore — the structure-of-arrays that OWNS each
  pool's control-plane state, mirrored on the pool's device — and
  ShardedResidentStore (per-shard free lists and mirror blocks)
- shard_plane: the tick, admission quantum and fleet plan with the row
  axis split over the ranks of a ``torch.distributed`` group
- pool: TokenPool controller (stateful shell over the control plane)
- pool_manager: PoolManager (batched fleet tick, spill-over routing,
  completion attribution, fleet planning and entitlement migration)
- autoscaler: Autoscaler (scalar single-pool scale policy, the oracle)
- fleet: FleetPlanner (``plan_fleet`` over the whole fleet on its
  device + cross-pool rebalancing)
- admission: AdmissionController (the §4.3 five-check pipeline)
- virtual_node: VirtualNodeProvider (scheduler-as-admission, §4.1)
- vectorized: batched admission replay (``admit_quantum``, a
  hand-written CUDA kernel on the card) + control-plane bridges
- ledger / state: token buckets and the Redis-contract state store
"""
from repro_torch.core.admission import AdmissionController
from repro_torch.core.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
    ScaleDecision,
    replicas_for,
)
from repro_torch.core.control_plane import (
    ControlState,
    OracleRow,
    control_tick,
    control_tick_pools,
    reference_tick,
)
from repro_torch.core.fleet import (
    FleetPlan,
    FleetPlanner,
    FleetPlannerConfig,
    RebalanceProposal,
    plan_fleet,
)
from repro_torch.core.ledger import Charge, Ledger, RowBucket, TokenBucket
from repro_torch.core.request_table import (
    InFlight,
    InFlightMap,
    InFlightRow,
    RequestTable,
)
from repro_torch.core.resident import (
    ResidentStatus,
    ResidentStore,
    ShardedResidentStore,
)
from repro_torch.core.pool import (
    EntitlementMigration,
    SettleBatch,
    TickInputs,
    TickRecord,
    TokenPool,
    waterfill,
)
from repro_torch.core.pool_manager import PoolManager, RouteEntry, as_manager
from repro_torch.core.priority import (
    burst_overconsumption,
    burst_update,
    debt_update,
    pool_average_slo,
    priority_breakdown,
    priority_weight,
    service_gap,
)
from repro_torch.core.state import CASConflict, StateStore
from repro_torch.core.vectorized import (
    QuantumSnapshot,
    admit_quantum,
    arrays_from_pool,
    quantum_snapshot,
    running_min_live,
)
from repro_torch.core.types import (
    AdmissionDecision,
    AdmissionRequest,
    DenyReason,
    EntitlementSpec,
    EntitlementState,
    EntitlementStatus,
    PoolSpec,
    PriorityCoefficients,
    QoS,
    Resources,
    ScalingBounds,
    ServiceClass,
    kv_bytes_per_token,
    max_concurrency,
)
from repro_torch.core.virtual_node import (
    LeasePod,
    VirtualNode,
    VirtualNodeProvider,
)

__all__ = [
    "AdmissionController", "AdmissionDecision", "AdmissionRequest",
    "Autoscaler", "AutoscalerConfig", "CASConflict", "Charge",
    "ControlState", "DenyReason", "EntitlementMigration",
    "EntitlementSpec", "EntitlementState", "EntitlementStatus",
    "FleetPlan", "FleetPlanner", "FleetPlannerConfig", "InFlight",
    "InFlightMap", "InFlightRow", "LeasePod", "Ledger", "OracleRow",
    "PoolManager", "PoolSpec", "PriorityCoefficients", "QoS",
    "QuantumSnapshot", "RebalanceProposal", "RequestTable",
    "ResidentStatus", "ResidentStore", "Resources", "RouteEntry",
    "RowBucket", "ScaleDecision", "ScalingBounds", "ServiceClass",
    "ShardedResidentStore",
    "SettleBatch", "StateStore", "TickInputs", "TickRecord",
    "TokenBucket", "TokenPool", "VirtualNode", "VirtualNodeProvider",
    "admit_quantum", "arrays_from_pool", "as_manager",
    "burst_overconsumption", "burst_update", "control_tick",
    "control_tick_pools", "debt_update", "kv_bytes_per_token",
    "max_concurrency", "plan_fleet", "pool_average_slo",
    "priority_breakdown", "priority_weight", "quantum_snapshot",
    "reference_tick", "replicas_for", "running_min_live",
    "service_gap", "waterfill",
]
