"""Token pools in PyTorch — the control plane of the serve path.

Counterpart of ``repro.core``, holding what the token-pool-gated serve
path uses:

- types: ServiceClass, Resources, QoS, EntitlementSpec, PoolSpec, ...
- control_plane: THE tick (``control_tick``) over rows of tensors
- priority: Eq. (1)-(3) scalar math
- resident: ResidentStore — the structure-of-arrays that OWNS each
  pool's control-plane state, mirrored on the pool's device
- pool: TokenPool controller (stateful shell over the control plane)
- pool_manager: PoolManager (membership, spill-over routing,
  completion attribution)
- admission: AdmissionController (the §4.3 five-check pipeline)
- virtual_node: VirtualNodeProvider (scheduler-as-admission, §4.1)
- ledger / state: token buckets and the Redis-contract state store
"""
from repro_torch.core.admission import AdmissionController
from repro_torch.core.control_plane import ControlState, control_tick
from repro_torch.core.ledger import Charge, Ledger, RowBucket, TokenBucket
from repro_torch.core.request_table import (
    InFlight,
    InFlightMap,
    InFlightRow,
    RequestTable,
)
from repro_torch.core.resident import ResidentStatus, ResidentStore
from repro_torch.core.pool import (
    EntitlementMigration,
    SettleBatch,
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
    "CASConflict", "Charge", "ControlState", "DenyReason",
    "EntitlementMigration", "EntitlementSpec", "EntitlementState",
    "EntitlementStatus", "InFlight", "InFlightMap", "InFlightRow",
    "LeasePod", "Ledger", "PoolManager", "PoolSpec",
    "PriorityCoefficients", "QoS", "RequestTable", "ResidentStatus",
    "ResidentStore", "Resources", "RouteEntry", "RowBucket",
    "ScalingBounds", "ServiceClass", "SettleBatch", "StateStore",
    "TickRecord", "TokenBucket", "TokenPool", "VirtualNode",
    "VirtualNodeProvider", "as_manager", "burst_overconsumption",
    "burst_update", "control_tick", "debt_update", "kv_bytes_per_token",
    "max_concurrency", "pool_average_slo", "priority_breakdown",
    "priority_weight", "service_gap", "waterfill",
]
