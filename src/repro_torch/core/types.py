"""Core datatypes for the token-pool control plane.

Faithful to the paper's §3 formalism:

- three schedulable resources per entitlement: token throughput ``lambda``
  (tokens/second), KV-cache capacity ``chi`` (bytes), concurrency ``r``
  (active sequences);
- five service classes (Table 1) with base weights 1000/1000/100/1/0.1;
- an entitlement state machine (Pending / Bound / Degraded / Expired).

Everything here is plain-Python and deterministic: no wall clock, no
randomness.  Time enters only through explicit ``now`` arguments.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class ServiceClass(str, enum.Enum):
    """Paper Table 1.  Ordering here is the *protection* ordering: when
    reclaiming capacity, preemptible is evicted first, spot throttled
    next, elastic shrunk, dedicated/guaranteed never touched."""

    DEDICATED = "dedicated"
    GUARANTEED = "guaranteed"
    ELASTIC = "elastic"
    SPOT = "spot"
    PREEMPTIBLE = "preemptible"


#: Base priority weights w_kappa (paper Table 1).  The multi-order-of-
#: magnitude gaps ensure class dominates other priority factors.
CLASS_WEIGHT: dict[ServiceClass, float] = {
    ServiceClass.DEDICATED: 1000.0,
    ServiceClass.GUARANTEED: 1000.0,
    ServiceClass.ELASTIC: 100.0,
    ServiceClass.SPOT: 1.0,
    ServiceClass.PREEMPTIBLE: 0.1,
}

#: Reclamation order (first = reclaimed first).  Paper §3.2.
RECLAIM_ORDER: tuple[ServiceClass, ...] = (
    ServiceClass.PREEMPTIBLE,
    ServiceClass.SPOT,
    ServiceClass.ELASTIC,
)

#: Classes whose baseline is reserved and never reclaimed.
PROTECTED_CLASSES: frozenset[ServiceClass] = frozenset(
    {ServiceClass.DEDICATED, ServiceClass.GUARANTEED}
)

#: Classes allowed to burst above baseline (Table 1 "Burst" column).
BURST_CLASSES: frozenset[ServiceClass] = frozenset(
    {
        ServiceClass.DEDICATED,
        ServiceClass.ELASTIC,
        ServiceClass.SPOT,
        ServiceClass.PREEMPTIBLE,
    }
)

#: Classes that accumulate service debt (only elastic receives
#: compensatory allocation; paper §3.2).
DEBT_CLASSES: frozenset[ServiceClass] = frozenset({ServiceClass.ELASTIC})


class EntitlementState(str, enum.Enum):
    """Entitlement lifecycle (paper §4.1/§4.3).  Admission requires Bound."""

    PENDING = "Pending"      # created, lease pod not yet bound
    BOUND = "Bound"          # lease bound on the virtual node; admitting
    DEGRADED = "Degraded"    # insufficient pool capacity for the lease
    EXPIRED = "Expired"      # TTL elapsed / revoked


@dataclasses.dataclass(frozen=True)
class Resources:
    """The three schedulable resources (paper §3.1).

    ``tokens_per_second`` — λ: rate of token production.
    ``kv_bytes``          — χ: KV-cache capacity in bytes.
    ``concurrency``       — r: simultaneously active sequences.
    """

    tokens_per_second: float = 0.0
    kv_bytes: float = 0.0
    concurrency: float = 0.0

    def __add__(self, other: "Resources") -> "Resources":
        return Resources(
            self.tokens_per_second + other.tokens_per_second,
            self.kv_bytes + other.kv_bytes,
            self.concurrency + other.concurrency,
        )

    def __sub__(self, other: "Resources") -> "Resources":
        return Resources(
            self.tokens_per_second - other.tokens_per_second,
            self.kv_bytes - other.kv_bytes,
            self.concurrency - other.concurrency,
        )

    def scale(self, f: float) -> "Resources":
        return Resources(
            self.tokens_per_second * f, self.kv_bytes * f, self.concurrency * f
        )

    def fits_within(self, cap: "Resources", eps: float = 1e-9) -> bool:
        return (
            self.tokens_per_second <= cap.tokens_per_second + eps
            and self.kv_bytes <= cap.kv_bytes + eps
            and self.concurrency <= cap.concurrency + eps
        )

    def clamp_nonneg(self) -> "Resources":
        return Resources(
            max(0.0, self.tokens_per_second),
            max(0.0, self.kv_bytes),
            max(0.0, self.concurrency),
        )

    @staticmethod
    def zero() -> "Resources":
        return Resources(0.0, 0.0, 0.0)


@dataclasses.dataclass(frozen=True)
class QoS:
    """QoS block of a TokenEntitlement (paper §4.2)."""

    service_class: ServiceClass = ServiceClass.ELASTIC
    slo_target_ms: float = 1000.0


@dataclasses.dataclass(frozen=True)
class PriorityCoefficients:
    """α coefficients of Eq. 1 and the EWMA decays of Eqs. 2–3.

    Paper defaults: α_slo=2.0, α_burst=1.0, α_debt=4.0; γ_d=0.7 in Exp. 2.
    The clip bounds are anti-windup on top of the EWMA (paper §3.3 calls
    the decay itself anti-windup): the instantaneous gap is clipped to
    ±1 (one baseline's worth per tick) and accumulated debt saturates —
    credit from a transient overservice burst must not zero a tenant's
    priority (the debt factor stays ≥ 1 + α_debt·debt_min > 0).
    """

    alpha_slo: float = 2.0
    alpha_burst: float = 1.0
    alpha_debt: float = 4.0
    gamma_debt: float = 0.7
    gamma_burst: float = 0.7
    gap_clip: float = 1.0
    debt_min: float = -0.15
    debt_max: float = 2.0


@dataclasses.dataclass
class EntitlementSpec:
    """Declarative spec (mirrors the TokenEntitlement CRD, paper §4.2)."""

    name: str
    tenant_id: str
    pool: str
    qos: QoS
    baseline: Resources
    api_keys: tuple[str, ...] = ()
    ttl_s: Optional[float] = None   # None = no expiry


@dataclasses.dataclass
class EntitlementStatus:
    """Mutable per-entitlement control-plane state (stored in the
    StateStore; the paper keeps this in Redis)."""

    state: EntitlementState = EntitlementState.PENDING
    in_flight: int = 0                       # admitted, not yet completed
    resident: int = 0                        # sequences with KV resident
    #                                          on decode workers (§3.1 r)
    kv_bytes_in_use: float = 0.0             # resident KV attribution
    debt: float = 0.0                        # d_e, Eq. 2
    burst: float = 0.0                       # b_e, EWMA of Eq. 3
    effective: Resources = dataclasses.field(default_factory=Resources.zero)
    # Rolling token-throughput measurement (tokens completed in the
    # current accounting window); converted to tok/s by the pool tick.
    window_tokens: float = 0.0
    measured_tps: float = 0.0
    # Counters for observability / the experiments.
    admitted_total: int = 0
    denied_total: int = 0
    denied_low_priority: int = 0
    completed_total: int = 0
    tokens_total: float = 0.0
    created_at: float = 0.0


@dataclasses.dataclass(frozen=True)
class ScalingBounds:
    min_replicas: int = 1
    max_replicas: int = 10


@dataclasses.dataclass
class PoolSpec:
    """TokenPool CRD (paper §4.2): a logical capacity pool bound to a
    model backend with autoscaling bounds."""

    name: str
    model: str
    scaling: ScalingBounds = dataclasses.field(default_factory=ScalingBounds)
    #: capacity contributed by ONE backend replica
    per_replica: Resources = dataclasses.field(
        default_factory=lambda: Resources(240.0, 16 * (1 << 30), 16)
    )
    coefficients: PriorityCoefficients = dataclasses.field(
        default_factory=PriorityCoefficients
    )
    #: default applied when a request omits max_tokens (admission check 2)
    default_max_tokens: int = 256
    #: EWMA window (seconds) for throughput measurement
    accounting_interval_s: float = 1.0
    #: relative slack on the contention threshold (check 5): admit iff
    #: w > (1 − slack)·threshold.  The default 0 keeps the paper's
    #: strict "must exceed" semantics (an entitlement that already sets
    #: the pool minimum cannot add work while others wait); operators
    #: can add slack to soften same-class self-competition.
    admission_slack: float = 0.0
    #: pin ℓ̄* to a constant instead of the live mean over bound members
    #: (the paper's Exp. 2 keeps ℓ̄*=15250 ms after a third tenant joins)
    fixed_avg_slo_ms: Optional[float] = None
    #: token-bucket window (seconds of λ̂ of burst credit).  Commercial
    #: tokens-per-minute semantics (paper §1 [7]) ⇒ 60; short windows
    #: make check (4) bind before the contention check (5).
    bucket_window_s: float = 4.0
    #: time constant τ of the dt-aware demand EWMA: each tick retains
    #: exp(−dt/τ) of the previous estimate (α = 1 − exp(−dt/τ)), so the
    #: smoothing horizon no longer depends on the tick rate.  None (the
    #: default) uses τ = accounting_interval_s / ln 2 — a tick at the
    #: nominal interval then retains exactly ½, the historical fixed
    #: blend.
    demand_tau_s: Optional[float] = None
    #: cap on retained ``TickRecord`` history (``TokenPool.history`` is
    #: a deque(maxlen=...)); None = unbounded.  Long-running
    #: deployments tick forever — an unbounded history is a slow leak.
    history_maxlen: Optional[int] = 4096
    #: partition the resident rows into this many shards (pow2) — the
    #: pool then uses ``ShardedResidentStore`` (shard-local churn,
    #: block-granular mirror uploads) and its tick/admission kernels
    #: dispatch over a ``shard_map`` row mesh whenever ≥2 devices are
    #: visible (``core.shard_plane``; decisions are bit-identical to
    #: the single-device kernels).  None/1 keeps the flat store.
    shards: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class AdmissionRequest:
    """What the gateway presents to admission control for one request."""

    entitlement: str
    input_tokens: int
    max_tokens: Optional[int]            # None → pool default applied
    arrival_s: float
    request_id: str = ""
    #: per-token KV bytes of the pool's model (c = 2·L·H_kv·d_h·b)
    kv_bytes_per_token: float = 0.0


class DenyReason(str, enum.Enum):
    NOT_BOUND = "entitlement_not_bound"
    CONCURRENCY = "concurrency_limit"
    TOKEN_BUDGET = "token_budget"
    LOW_PRIORITY = "low_priority"
    POOL_UNAVAILABLE = "pool_unavailable"


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: Optional[DenyReason] = None
    #: seconds the client should wait before retrying (429 Retry-After)
    retry_after_s: Optional[float] = None
    #: priority at decision time, for observability
    priority: float = 0.0
    #: token budget charged on admit (input + effective max_tokens)
    charged_tokens: int = 0
    effective_max_tokens: int = 0


def kv_bytes_per_token(
    num_layers: int, kv_heads: int, head_dim: int, bytes_per_elem: int = 2
) -> float:
    """c = 2 · L · H_kv · d_h · b   (paper §3.1)."""
    return 2.0 * num_layers * kv_heads * head_dim * bytes_per_elem


def max_concurrency(kv_budget_bytes: float, context_len: int, c: float) -> int:
    """r_max = floor(χ_gpu / (S·c))   (paper §3.1)."""
    denom = context_len * c
    if denom <= 0:
        return 0
    return int(kv_budget_bytes // denom)
