"""Priority, debt, and burst math — paper §3.3, Eqs. (1)–(3).

Scalar reference implementation.  ``core.vectorized`` provides a
jit-compiled jnp batch equivalent; ``tests/test_vectorized_equiv.py``
pins the two equal with hypothesis.

All functions are pure: state in, state out.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.types import (
    CLASS_WEIGHT,
    PriorityCoefficients,
    Resources,
    ServiceClass,
)


def priority_weight(
    service_class: ServiceClass,
    slo_target_ms: float,
    pool_avg_slo_ms: float,
    burst: float,
    debt: float,
    coeff: PriorityCoefficients = PriorityCoefficients(),
) -> float:
    """Eq. (1):

        w_e = w_κ · (1 + α_slo · ℓ*_e / ℓ̄*)⁻¹
                  · (1 + α_burst · b_e)⁻¹
                  · (1 + α_debt · d_e)

    Tighter SLO targets (small ℓ*_e) yield higher priority; sustained
    bursting reduces priority; positive accumulated debt raises it.

    The debt factor may be < 1 when d_e < 0 (credit from overservice),
    but is floored at a small positive value so priority never goes
    non-positive for a live entitlement.
    """
    w_class = CLASS_WEIGHT[service_class]
    slo_factor = 1.0 / (1.0 + coeff.alpha_slo * (slo_target_ms / pool_avg_slo_ms))
    burst_factor = 1.0 / (1.0 + coeff.alpha_burst * max(0.0, burst))
    debt_factor = max(1e-3, 1.0 + coeff.alpha_debt * debt)
    return w_class * slo_factor * burst_factor * debt_factor


def service_gap(baseline_tps: float, allocated_tps: float) -> float:
    """g_e = (λ_e − λ̂_e) / λ_e  (paper §3.3).

    Positive ⇒ underserved (allocation below baseline); negative ⇒
    overserved (bursting above baseline).  Zero-baseline entitlements
    (spot/preemptible) have no defined gap; return 0.
    """
    if baseline_tps <= 0.0:
        return 0.0
    return (baseline_tps - allocated_tps) / baseline_tps


def debt_update(debt_prev: float, gap: float, gamma_d: float) -> float:
    """Eq. (2):  d_e(k) = γ_d · d_e(k−1) + (1 − γ_d) · g_e(k).

    EWMA accumulation — the integral term of the PI analogy, with the
    decay acting as anti-windup.
    """
    return gamma_d * debt_prev + (1.0 - gamma_d) * gap


def burst_overconsumption(usage: Resources, baseline: Resources) -> float:
    """Eq. (3): instantaneous multi-dimensional overconsumption

        δ_e = max(0, λ̂/λ − 1) + max(0, χ̂/χ − 1) + max(0, r̂/r − 1)

    Dimensions with zero baseline contribute their full relative usage
    (a zero-baseline entitlement consuming anything is pure burst); the
    paper's spot class has no baseline, so any consumption is burst.
    We normalise zero-baseline dimensions against a unit scale to keep
    δ finite, matching "consume only surplus capacity" semantics.
    """

    def term(used: float, base: float) -> float:
        if base <= 0.0:
            # No baseline: any use is overconsumption.  Normalise by the
            # usage itself → contributes 1.0 when active, 0 when idle.
            return 1.0 if used > 0.0 else 0.0
        return max(0.0, used / base - 1.0)

    return (
        term(usage.tokens_per_second, baseline.tokens_per_second)
        + term(usage.kv_bytes, baseline.kv_bytes)
        + term(usage.concurrency, baseline.concurrency)
    )


def burst_update(burst_prev: float, delta: float, gamma_b: float) -> float:
    """EWMA of Eq. (3): b_e(k) = γ_b · b_e(k−1) + (1 − γ_b) · δ_e(k)."""
    return gamma_b * burst_prev + (1.0 - gamma_b) * delta


def pool_average_slo(slo_targets_ms: list[float]) -> float:
    """ℓ̄* — arithmetic mean of member SLO targets (paper §5.3 uses the
    mean of the participating entitlements: (500+30000+...)/n)."""
    if not slo_targets_ms:
        return 1.0
    return sum(slo_targets_ms) / len(slo_targets_ms)


@dataclasses.dataclass(frozen=True)
class PriorityBreakdown:
    """All factors of Eq. 1, for observability panels (paper Fig. 5)."""

    w_class: float
    slo_factor: float
    burst_factor: float
    debt_factor: float
    weight: float


def priority_breakdown(
    service_class: ServiceClass,
    slo_target_ms: float,
    pool_avg_slo_ms: float,
    burst: float,
    debt: float,
    coeff: PriorityCoefficients = PriorityCoefficients(),
) -> PriorityBreakdown:
    w_class = CLASS_WEIGHT[service_class]
    slo_factor = 1.0 / (1.0 + coeff.alpha_slo * (slo_target_ms / pool_avg_slo_ms))
    burst_factor = 1.0 / (1.0 + coeff.alpha_burst * max(0.0, burst))
    debt_factor = max(1e-3, 1.0 + coeff.alpha_debt * debt)
    return PriorityBreakdown(
        w_class=w_class,
        slo_factor=slo_factor,
        burst_factor=burst_factor,
        debt_factor=debt_factor,
        weight=w_class * slo_factor * burst_factor * debt_factor,
    )
