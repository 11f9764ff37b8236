"""Admission control — the paper's §4.3 five-check pipeline.

The auth service intercepts every request before it reaches the
backend.  Checks run in order; a failing check short-circuits:

  1. entitlement state must be Bound;
  2. output-length bound: a pool default is applied if the request
     omits max_tokens (capacity planning);
  3. concurrency: in-flight < r_e;
  4. token budget: (input + max_tokens) must fit the entitlement's
     remaining throughput allocation (token bucket funded at λ̂_e);
     KV headroom ((input + max_tokens)·c ≤ χ_e − in-use) is enforced
     here too, folding the paper's χ resource into the same check;
  5. pool contention: when the pool is saturated, the request's
     priority w_e must not fall below the admission threshold (the
     minimum priority among currently-admitted requests).

Rejections produce HTTP-429 semantics with a Retry-After hint derived
from the token bucket refill time (budget denials) or a class-scaled
backoff (priority denials).

This scalar pipeline is the per-request fallback and the DECISION
ORACLE for the batched hot path: ``vectorized.admit_quantum`` replays
these five checks for a whole scheduling quantum in one fused
dispatch (``Gateway.handle_quantum``), and
``tests/test_admit_quantum.py`` / ``tests/test_gateway_quantum.py``
pin the two decision-identical — any semantic change here must be
mirrored in the kernel.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.ledger import Charge
from repro_torch.core.pool import InFlight, TokenPool
from repro_torch.core.types import (
    PROTECTED_CLASSES,
    AdmissionDecision,
    AdmissionRequest,
    DenyReason,
    EntitlementState,
    ServiceClass,
)


class AdmissionController:
    """Stateless decision logic over a TokenPool's state."""

    def __init__(self, pool: TokenPool) -> None:
        self.pool = pool

    def decide(self, req: AdmissionRequest) -> AdmissionDecision:
        pool = self.pool
        espec = pool.entitlements.get(req.entitlement)
        if espec is None:
            return AdmissionDecision(False, DenyReason.NOT_BOUND,
                                     retry_after_s=None)
        st = pool.status[req.entitlement]
        now = req.arrival_s

        # (1) entitlement state -------------------------------------------------
        if st.state != EntitlementState.BOUND:
            dec = AdmissionDecision(False, DenyReason.NOT_BOUND,
                                    retry_after_s=5.0)
            pool.register_deny(req.entitlement, 0.0, low_priority=False)
            return dec

        # (2) output-length bound ------------------------------------------------
        max_tokens = (req.max_tokens if req.max_tokens is not None
                      else pool.spec.default_max_tokens)
        budget_tokens = req.input_tokens + max_tokens
        kv_need = budget_tokens * req.kv_bytes_per_token

        # (3) concurrency limit ---------------------------------------------------
        # counts RESIDENT sequences (KV on decode workers, §3.1) — an
        # admitted-but-queued request holds no KV and no decode slot.
        # Burst-capable classes (Table 1) may exceed r_e while the pool
        # has idle slots: the concurrency *burst dimension* of the
        # work-conserving backfill.  The overage shows up in b_e (Eq. 3)
        # and progressively lowers their priority.
        from repro_torch.core.types import BURST_CLASSES
        r_limit = espec.baseline.concurrency
        if espec.qos.service_class is ServiceClass.SPOT and r_limit <= 0:
            # spot with no explicit limit: bounded by pool capacity
            r_limit = pool.capacity().concurrency
        if r_limit > 0 and st.resident >= r_limit:
            burst_ok = (espec.qos.service_class in BURST_CLASSES
                        and pool.has_free_slots()
                        and not pool.contended())
            if not burst_ok:
                dec = AdmissionDecision(
                    False, DenyReason.CONCURRENCY,
                    retry_after_s=self._concurrency_backoff(
                        req.entitlement),
                    effective_max_tokens=max_tokens)
                pool.register_deny(req.entitlement, float(budget_tokens),
                                   low_priority=False)
                return dec

        # (4) token budget (+ KV headroom) ---------------------------------------
        bucket = pool.ledger.ensure(
            req.entitlement, st.effective.tokens_per_second
            or espec.baseline.tokens_per_second, now)
        if not bucket.can_afford(budget_tokens, now):
            retry = pool.ledger.retry_after(req.entitlement,
                                            budget_tokens, now)
            dec = AdmissionDecision(
                False, DenyReason.TOKEN_BUDGET,
                retry_after_s=min(retry, 60.0),
                effective_max_tokens=max_tokens)
            pool.register_deny(req.entitlement, float(budget_tokens),
                               low_priority=False)
            return dec
        chi_limit = espec.baseline.kv_bytes
        if chi_limit > 0 and st.kv_bytes_in_use + kv_need > chi_limit:
            dec = AdmissionDecision(
                False, DenyReason.TOKEN_BUDGET, retry_after_s=1.0,
                effective_max_tokens=max_tokens)
            pool.register_deny(req.entitlement, float(budget_tokens),
                               low_priority=False)
            return dec

        # (5) pool contention ------------------------------------------------------
        # Applies to burst classes only: "guaranteed requests are never
        # rejected (within their concurrency limits)" (§5.2) — protected
        # classes are shielded by their reservations and checks 1–4.
        # The comparison is STRICT ("must exceed the threshold", §4.3):
        # an entitlement whose requests already set the pool minimum
        # cannot push more work into a contended pool — this is what
        # directs throttling at the lowest-priority tenant.
        w = pool.priority(req.entitlement)
        shielded = espec.qos.service_class in PROTECTED_CLASSES
        if pool.contended() and not shielded:
            threshold = (pool.admission_threshold()
                         * (1.0 - pool.spec.admission_slack))
            if w <= threshold:
                dec = AdmissionDecision(
                    False, DenyReason.LOW_PRIORITY,
                    retry_after_s=self._priority_backoff(w, threshold),
                    priority=w, effective_max_tokens=max_tokens)
                pool.register_deny(req.entitlement, float(budget_tokens),
                                   low_priority=True)
                return dec

        # admitted: charge the bucket, register in-flight -----------------------
        charge = Charge(request_id=req.request_id,
                        entitlement=req.entitlement,
                        charged_tokens=float(budget_tokens),
                        input_tokens=req.input_tokens,
                        max_tokens=max_tokens,
                        admitted_at=now)
        if not pool.ledger.charge(charge, now):   # raced the refill window
            dec = AdmissionDecision(False, DenyReason.TOKEN_BUDGET,
                                    retry_after_s=1.0,
                                    effective_max_tokens=max_tokens)
            pool.register_deny(req.entitlement, float(budget_tokens),
                               low_priority=False)
            return dec
        pool.register_admit(
            InFlight(request_id=req.request_id,
                     entitlement=req.entitlement,
                     priority=w,
                     kv_bytes=kv_need,
                     charged_tokens=budget_tokens,
                     admitted_at=now),
            demand_tokens=float(budget_tokens))
        return AdmissionDecision(True, priority=w,
                                 charged_tokens=budget_tokens,
                                 effective_max_tokens=max_tokens)

    # -- retry hints -------------------------------------------------------------
    def _concurrency_backoff(self, entitlement: str) -> float:
        """Expected time for one slot to free: tokens outstanding / rate.

        Outstanding tokens are one masked sum over the request table's
        owner/charged columns — not a walk of every in-flight record."""
        pool = self.pool
        st = pool.status[entitlement]
        rate = max(1e-6, st.effective.tokens_per_second
                   or pool.entitlements[entitlement]
                   .baseline.tokens_per_second or 1.0)
        c = pool.table.col
        slot = pool.store.slot_of.get(entitlement)
        if slot is None:
            outstanding = 0
        else:
            mask = c["has_record"] & (c["owner"] == slot)
            outstanding = int(np.sum(c["rec_charged"][mask]))
        per_slot = outstanding / max(1, st.in_flight)
        return min(30.0, max(0.25, per_slot / rate))

    def _priority_backoff(self, w: float, threshold: float) -> float:
        """Lower-priority requests back off longer (graceful degradation)."""
        ratio = max(1.0, threshold / max(w, 1e-6))
        return min(30.0, 0.5 * ratio ** 0.5)
