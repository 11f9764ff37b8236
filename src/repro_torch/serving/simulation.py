"""Discrete-time serving simulator — the experiment harness.

Counterpart of ``repro/serving/simulation.py``.  The control plane runs
on the device each simulator is given (``device=``, default ``"cuda"``):
the pools' resident mirrors, the control tick and, in the multi-pool
simulator's quantum mode, ``admit_quantum`` (the hand-written CUDA
kernel on the card, its plain version on the CPU).

The CONTROL PLANE under test is the real code (TokenPool,
AdmissionController, ledger, debt/burst accounting).  Only the GPU
backend is simulated: each replica is a processor-sharing server with
``slots`` concurrent sequences and an aggregate decode rate Λ_r
(tokens/s) split evenly among active sequences — calibrated to the
paper's single vLLM replica (16 slots, ~240 tok/s on Qwen3-8B).

Fixed-step simulation (dt = 20 ms): deterministic, fine enough for
sub-second TTFT claims.  Supports: replica failure/recovery events
(paper Exp 2's outage), entitlement join/leave windows (Exp 1/2),
work-conserving backfill, hedged re-dispatch of stragglers, and a
no-admission baseline mode.  ``telemetry=`` records every decision,
completion, tick and incident into the telemetry plane; the multi-pool
simulator's ``autoscale=True`` closes the fleet planner's loop (each
accounting tick → ``Gateway.plan_quantum`` → provisioning with lag,
draining, migrations).  Sharded pools (``PoolSite.shards``) wait for
their slice (ROADMAP queue A) and raise.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from repro_torch.core import (
    AdmissionController,
    AdmissionRequest,
    EntitlementSpec,
    InFlight,
    PoolSpec,
    PriorityCoefficients,
    QoS,
    Resources,
    ScalingBounds,
    ServiceClass,
    TokenPool,
)
from repro_torch.serving.request import Request, RequestState


@dataclasses.dataclass
class Workload:
    name: str                      # entitlement name
    service_class: ServiceClass
    slots: float                   # baseline concurrency r_e
    slo_ms: float
    rate_rps: float                # arrival rate
    in_tokens: int = 64
    out_tokens: int = 64
    start_s: float = 0.0
    end_s: float = 1e9
    tokens_per_second: float = 0.0  # λ_e baseline (0 → derive from slots)
    #: client retry behaviour on 429 (Retry-After honoured, capped)
    max_retries: int = 0
    retry_cap_s: float = 5.0
    #: ordered pool preference for MultiPoolSimulator routing (first =
    #: preferred, later legs are spill-over targets); ignored by the
    #: single-pool ServingSimulator
    pools: tuple[str, ...] = ()


@dataclasses.dataclass
class ReplicaSim:
    name: str
    slots: int
    rate_tps: float
    prefill_tps: float = 4000.0
    alive: bool = True
    #: scale-down drain: no new dispatch, residual work completes
    draining: bool = False
    #: replica lost to a FAILURE (cannot be re-provisioned until the
    #: matching recover event, unlike a scaled-down slot)
    failed: bool = False
    active: dict = dataclasses.field(default_factory=dict)
    # req_id → [remaining_out_tokens, prefill_remaining_tokens]

    def load(self) -> int:
        return len(self.active)

    def serving(self) -> bool:
        return self.alive and not self.draining


def dispatch_waiting(waiting: list, alive: list[ReplicaSim],
                     requests: dict[str, Request], on_start) -> None:
    """Drain a priority heap onto the least-loaded live replicas.
    Shared by both simulators so the scheduling policy cannot diverge."""
    while waiting:
        candidates = [r for r in alive if r.load() < r.slots]
        if not candidates:
            return
        replica = min(candidates, key=lambda r: r.load() / r.slots)
        _, _, rid = heapq.heappop(waiting)
        req = requests[rid]
        if req.state not in (RequestState.QUEUED,):
            continue                          # stale/duplicate entry
        req.state = RequestState.PREFILLING
        req.replica = replica.name
        replica.active[rid] = [float(req.max_tokens),
                               float(req.input_len)]
        on_start(rid)           # KV becomes resident (§3.1 r)


def advance_replicas(alive: list[ReplicaSim],
                     requests: dict[str, Request], dt: float, now: float,
                     on_finish) -> None:
    """One dt of processor-sharing prefill/decode on live replicas.
    ``on_finish(rid, req)`` receives each completed request AFTER its
    terminal fields are stamped.  Shared by both simulators: the
    timing model (TTFT stamping, decode-rate sharing) lives here once."""
    for replica in alive:
        if not replica.active:
            continue
        decoding = [rid for rid, st in replica.active.items()
                    if st[1] <= 0.0]
        n_prefilling = max(1, len(replica.active) - len(decoding))
        decode_rate = replica.rate_tps / max(len(replica.active), 1)
        finished = []
        for rid, st in replica.active.items():
            req = requests[rid]
            if st[1] > 0.0:                      # prefilling
                st[1] -= replica.prefill_tps * dt / n_prefilling
                if st[1] <= 0.0:
                    req.state = RequestState.DECODING
            else:                                # decoding
                before = st[0]
                st[0] -= decode_rate * dt
                if req.first_token_s is None and st[0] < before:
                    req.first_token_s = now + dt
                if st[0] <= 0.0:
                    finished.append(rid)
        for rid in finished:
            req = requests[rid]
            req.state = RequestState.FINISHED
            req.finished_s = now + dt
            req.output_tokens = [1] * req.max_tokens
            del replica.active[rid]
            on_finish(rid, req)


@dataclasses.dataclass
class TimelinePoint:
    t: float
    running: int
    waiting: int
    per_ent_running: dict[str, int]
    capacity_slots: int


class ServingSimulator:
    def __init__(self, workloads: list[Workload],
                 replica_slots: int = 16, replica_tps: float = 240.0,
                 n_replicas: int = 1, admission: bool = True,
                 coeff: PriorityCoefficients = PriorityCoefficients(),
                 dt: float = 0.02, seed: int = 0,
                 hedge_after_s: Optional[float] = None,
                 accounting_interval_s: float = 1.0,
                 fixed_avg_slo_ms: Optional[float] = None,
                 bucket_window_s: float = 4.0,
                 telemetry=None, device="cuda") -> None:
        self.dt = dt
        self.admission = admission
        self.workloads = {w.name: w for w in workloads}
        self.rng = np.random.RandomState(seed)
        self.hedge_after_s = hedge_after_s

        per_slot_tps = replica_tps / replica_slots
        # Admission charges input+max_tokens (paper check 4) while the
        # backend decode rate counts output tokens only; express pool λ
        # capacity in *charged* units so the two ledgers agree.
        charge_factor = float(np.mean(
            [(w.in_tokens + w.out_tokens) / max(w.out_tokens, 1)
             for w in workloads]))
        self.charge_factor = charge_factor
        spec = PoolSpec(
            name="sim-pool", model="qwen3-8b",
            scaling=ScalingBounds(1, n_replicas),
            per_replica=Resources(replica_tps * charge_factor, 0.0,
                                  float(replica_slots)),
            coefficients=coeff,
            accounting_interval_s=accounting_interval_s,
            fixed_avg_slo_ms=fixed_avg_slo_ms,
            bucket_window_s=bucket_window_s,
        )
        self.pool = TokenPool(spec, device=device)
        self.pool.set_replicas(n_replicas)
        self.controller = AdmissionController(self.pool)
        for w in workloads:
            lam = w.tokens_per_second or w.slots * per_slot_tps \
                * (w.in_tokens + w.out_tokens) / max(w.out_tokens, 1)
            if w.service_class in (ServiceClass.SPOT,
                                   ServiceClass.PREEMPTIBLE):
                lam = 0.0
            self.pool.add_entitlement(EntitlementSpec(
                name=w.name, tenant_id=w.name, pool="sim-pool",
                qos=QoS(service_class=w.service_class,
                        slo_target_ms=w.slo_ms),
                baseline=Resources(lam, 0.0, w.slots)))
            # spot buckets are funded by backfill ticks; give them the
            # pool surplus initially so t=0 arrivals aren't starved
            if lam == 0.0:
                self.pool.ledger.set_rate(
                    w.name, replica_tps * charge_factor, 0.0)

        # telemetry=True builds a fresh plane; an instance is shared
        if telemetry is True:
            from repro_torch.telemetry import Telemetry
            telemetry = Telemetry()
        self.telemetry = telemetry or None
        if self.telemetry is not None:
            self.telemetry.attach_pool(self.pool)

        self.replicas = [ReplicaSim(f"r{i}", replica_slots, replica_tps)
                         for i in range(n_replicas)]
        self.waiting: list[tuple[float, float, str]] = []  # heap
        self.requests: dict[str, Request] = {}
        self.timeline: list[TimelinePoint] = []
        self._events: list[tuple[float, int, str, dict]] = []
        self._eid = 0
        self._req_counter = 0
        self._next_arrival: dict[str, float] = {
            w.name: w.start_s for w in workloads}

    # -- event API -----------------------------------------------------------
    def at(self, t: float, kind: str, **payload) -> None:
        """Schedule an external event: ``fail_replica`` (idx),
        ``recover_replica`` (idx)."""
        heapq.heappush(self._events, (t, self._eid, kind, payload))
        self._eid += 1

    # -- internals ------------------------------------------------------------
    def _alive(self) -> list[ReplicaSim]:
        return [r for r in self.replicas if r.alive]

    def _arrive(self, w: Workload, now: float, attempt: int = 0) -> None:
        self._req_counter += 1
        rid = f"{w.name}-{self._req_counter}"
        req = Request(request_id=rid, entitlement=w.name,
                      prompt_tokens=[1] * w.in_tokens,
                      max_tokens=w.out_tokens, arrival_s=now)
        self.requests[rid] = req
        if self.admission:
            dec = self.controller.decide(AdmissionRequest(
                entitlement=w.name, input_tokens=w.in_tokens,
                max_tokens=w.out_tokens, arrival_s=now, request_id=rid))
            if self.telemetry is not None:
                from repro_torch.telemetry import flight as flightrec
                code = (flightrec.REASON_NONE if dec.reason is None
                        else flightrec.REASON_CODES[dec.reason.value])
                self.telemetry.record_decision(
                    self.pool.spec.name, now, rid, 0, w.name,
                    dec.admitted, code, dec.priority,
                    float(w.in_tokens + w.out_tokens))
            if not dec.admitted:
                req.state = RequestState.DENIED
                req.deny_reason = dec.reason.value if dec.reason else None
                req.retry_after_s = dec.retry_after_s
                # client honours Retry-After (bounded retries)
                if attempt < w.max_retries:
                    backoff = min(dec.retry_after_s or 1.0, w.retry_cap_s)
                    self.at(now + max(backoff, self.dt), "retry",
                            workload=w.name, attempt=attempt + 1)
                return
            req.priority = dec.priority
            req.admitted_s = now
        else:
            # baseline: everything admitted, FIFO (priority constant)
            req.priority = 0.0
            req.admitted_s = now
            self.pool.register_admit(
                InFlight(rid, w.name, 0.0, 0.0,
                         w.in_tokens + w.out_tokens, now),
                float(w.in_tokens + w.out_tokens))
        # waiting heap ordered by (-priority, arrival)
        heapq.heappush(self.waiting, (-req.priority, now, rid))

    def _dispatch(self, now: float) -> None:
        dispatch_waiting(self.waiting, self._alive(), self.requests,
                         self.pool.on_start)

    def _advance_replicas(self, now: float) -> None:
        # every completion of one dt step is stamped
        # ``finished_s = now + dt`` — drain them in ONE vectorized
        # settle per step instead of a scalar ``on_complete`` each
        done: list[tuple[str, Request]] = []
        advance_replicas(self._alive(), self.requests, self.dt, now,
                         lambda rid, req: done.append((rid, req)))
        # settle in (finished_s, rid) order — collection order follows
        # dict iteration over ``replica.active``, which tracks dispatch
        # history; sorting pins the settle sequence regardless of how
        # requests were interleaved onto replicas
        done.sort(key=lambda p: (p[1].finished_s, p[0]))
        if done:
            self.pool.on_complete_batch(
                [rid for rid, _ in done],
                [req.max_tokens for _, req in done], now + self.dt)
            if self.telemetry is not None:
                name = self.pool.spec.name
                self.telemetry.record_completions(
                    now + self.dt, [name] * len(done),
                    [req.entitlement for _, req in done],
                    [now + self.dt - req.arrival_s
                     for _, req in done])

    def _handle_event(self, kind: str, payload: dict, now: float) -> None:
        if kind == "fail_replica":
            replica = self.replicas[payload["idx"]]
            replica.alive = False
            # in-flight requests on the dead node are re-queued (charged
            # budget is kept — they are still owed service)
            for rid in list(replica.active):
                req = self.requests[rid]
                req.state = RequestState.QUEUED
                req.replica = None
                heapq.heappush(self.waiting,
                               (-req.priority, req.arrival_s, rid))
                del replica.active[rid]
            self.pool.set_replicas(len(self._alive()))
            if self.telemetry is not None:
                self.telemetry.incident_start(
                    f"replica{payload['idx']}", now)
        elif kind == "recover_replica":
            self.replicas[payload["idx"]].alive = True
            self.pool.set_replicas(len(self._alive()))
            if self.telemetry is not None:
                self.telemetry.incident_end(
                    f"replica{payload['idx']}", now)
        elif kind == "retry":
            w = self.workloads[payload["workload"]]
            if now < w.end_s:
                self._arrive(w, now, attempt=payload["attempt"])
        else:
            raise ValueError(kind)

    def _hedge(self, now: float) -> None:
        """Straggler mitigation: a request queued longer than the hedge
        timeout is re-enqueued at boosted priority (front of the line
        within its class) — bounded to one hedge per request.  The
        stale heap entry is skipped by the started-state check in
        ``_dispatch`` (lazy deletion)."""
        if self.hedge_after_s is None:
            return
        for _, t_arr, rid in list(self.waiting):
            req = self.requests[rid]
            if (req.state == RequestState.QUEUED
                    and not getattr(req, "_hedged", False)
                    and now - t_arr > self.hedge_after_s):
                req._hedged = True           # type: ignore[attr-defined]
                req.priority += 1e4          # jump the queue
                heapq.heappush(self.waiting,
                               (-req.priority, t_arr, rid))

    # -- main loop ------------------------------------------------------------
    def run(self, duration_s: float) -> dict:
        now = 0.0
        next_tick = self.pool.spec.accounting_interval_s
        steps = int(duration_s / self.dt)
        for _ in range(steps):
            # external events
            while self._events and self._events[0][0] <= now:
                _, _, kind, payload = heapq.heappop(self._events)
                self._handle_event(kind, payload, now)
            # arrivals
            for w in self.workloads.values():
                while (self._next_arrival[w.name] <= now
                       and w.start_s <= now < w.end_s):
                    self._arrive(w, now)
                    self._next_arrival[w.name] += 1.0 / w.rate_rps
                if now >= w.end_s:
                    self._next_arrival[w.name] = 1e18
            self._hedge(now)
            self._dispatch(now)
            self._advance_replicas(now)
            if now >= next_tick:
                self.pool.tick(now)
                next_tick += self.pool.spec.accounting_interval_s
            # timeline sample every 0.5 s
            if int(now / self.dt) % max(1, int(0.5 / self.dt)) == 0:
                per_ent: dict[str, int] = {}
                running = 0
                for r in self._alive():
                    for rid in r.active:
                        running += 1
                        e = self.requests[rid].entitlement
                        per_ent[e] = per_ent.get(e, 0) + 1
                self.timeline.append(TimelinePoint(
                    t=now, running=running,
                    waiting=len([1 for _, _, rid in self.waiting
                                 if self.requests[rid].state
                                 == RequestState.QUEUED]),
                    per_ent_running=per_ent,
                    capacity_slots=sum(r.slots for r in self._alive())))
            now += self.dt
        return self.summary()

    # -- results ---------------------------------------------------------------
    def per_entitlement(self) -> dict[str, list[Request]]:
        out: dict[str, list[Request]] = {w: [] for w in self.workloads}
        for req in self.requests.values():
            out[req.entitlement].append(req)
        return out

    def summary(self) -> dict:
        from repro_torch.serving.request import latency_summary
        per = {}
        for name, reqs in self.per_entitlement().items():
            s = latency_summary(reqs)
            st = self.pool.status[name]
            s["denied_low_priority"] = st.denied_low_priority
            s["denied_total"] = st.denied_total
            s["peak_debt"] = max(
                (h.debts.get(name, 0.0) for h in self.pool.history),
                default=0.0)
            per[name] = s
        return {
            "per_entitlement": per,
            "max_waiting": max((p.waiting for p in self.timeline),
                               default=0),
            # the pool keeps a bounded deque (PoolSpec.history_maxlen);
            # expose a list so consumers can slice it
            "history": list(self.pool.history),
            "timeline": self.timeline,
        }


# -- multi-pool simulation -------------------------------------------------------


@dataclasses.dataclass
class PoolSite:
    """One pool's backend fleet in a multi-pool simulation."""

    name: str
    n_replicas: int = 1
    replica_slots: int = 16
    replica_tps: float = 240.0
    #: autoscaling ceiling (0 → n_replicas, i.e. a fixed fleet).  With
    #: ``autoscale=True`` the fleet starts at ``n_replicas`` live and
    #: the planner provisions up to this many.
    max_replicas: int = 0
    #: resident-store shard count (0 → flat store; the sharded store,
    #: ``PoolSpec.shards``, waits for its slice and raises)
    shards: int = 0


class MultiPoolSimulator:
    """Discrete-time simulator over a ``PoolManager`` fleet.

    The control plane under test is the real multi-pool code: a
    ``Gateway`` with ordered (pool, entitlement) routes per workload,
    spill-over on denial, and the BATCHED accounting tick
    (``PoolManager.tick`` — one fused kernel for all pools).  Each pool
    has its own simulated replica fleet; per-pool replica outages
    (``at(t, "fail_replica", pool=..., idx=...)``) shrink only that
    pool, pushing its traffic across the route to the surviving pools
    — the cross-pool spill scenario of dual-pool routing.

    Each workload is entitled on every pool in its ``pools`` preference
    list (entitlement name ``{workload}@{pool}``); metrics are reported
    per workload with per-pool admission attribution.
    """

    def __init__(self, workloads: list[Workload], sites: list[PoolSite],
                 coeff: PriorityCoefficients = PriorityCoefficients(),
                 dt: float = 0.02, seed: int = 0,
                 accounting_interval_s: float = 1.0,
                 bucket_window_s: float = 4.0,
                 spill_policy: str = "static",
                 admission_mode: str = "quantum",
                 autoscale: bool = False,
                 planner_config=None,
                 provision_lag_s: float = 2.0,
                 drain_s: float = 2.0,
                 telemetry=None, device="cuda") -> None:
        from repro_torch.core import FleetPlanner, PoolManager
        from repro_torch.gateway import Gateway

        if admission_mode not in ("quantum", "scalar"):
            raise ValueError(f"unknown admission_mode {admission_mode!r};"
                             " expected 'quantum' or 'scalar'")
        #: "quantum" (default) batches each dt-step's arrivals through
        #: ``Gateway.handle_quantum`` — one fused kernel dispatch per
        #: (pool, leg round); "scalar" keeps the per-request
        #: ``Gateway.handle`` pipeline.  Per pool both decide the same
        #: arrival sequence identically; when workloads declare pools
        #: in DIFFERENT orders, cross-pool spills settle in leg-round
        #: order rather than the scalar loop's interleaving (see
        #: ``Gateway.handle_quantum``).
        self.admission_mode = admission_mode
        self.dt = dt
        self.workloads = {w.name: w for w in workloads}
        self.sites = {s.name: s for s in sites}
        self.rng = np.random.RandomState(seed)

        # Admission charges input+max_tokens while decode counts output
        # tokens; express pool λ capacity in charged units (see
        # ServingSimulator).
        charge_factor = float(np.mean(
            [(w.in_tokens + w.out_tokens) / max(w.out_tokens, 1)
             for w in workloads]))
        self.charge_factor = charge_factor

        self.autoscale = autoscale
        self.provision_lag_s = provision_lag_s
        self.drain_s = drain_s
        self.manager = PoolManager()
        self.replicas: dict[str, list[ReplicaSim]] = {}
        for s in sites:
            max_r = s.max_replicas or s.n_replicas
            spec = PoolSpec(
                name=s.name, model="sim-model",
                scaling=ScalingBounds(1, max_r),
                per_replica=Resources(s.replica_tps * charge_factor, 0.0,
                                      float(s.replica_slots)),
                coefficients=coeff,
                accounting_interval_s=accounting_interval_s,
                bucket_window_s=bucket_window_s,
                shards=s.shards or None)
            pool = self.manager.add_pool(spec, device=device)
            pool.set_replicas(s.n_replicas)
            # fleet sized to the autoscaling ceiling; slots beyond the
            # initial n_replicas start dead, awaiting provisioning
            self.replicas[s.name] = [
                ReplicaSim(f"{s.name}/r{i}", s.replica_slots,
                           s.replica_tps, alive=i < s.n_replicas)
                for i in range(max_r)]
        if autoscale:
            self.manager.planner = FleetPlanner(planner_config)
            self.manager.provision_hook = self._provision
        #: replicas scheduled to come live (pool → replica indices)
        self._incoming: dict[str, set[int]] = {s.name: set() for s in sites}
        #: per-replica drain deadline (replica name → t)
        self._drain_deadline: dict[str, float] = {}
        #: (t, FleetPlan) per planning round (autoscale mode)
        self.plans: list = []
        #: per-pool (t, live_replicas) trajectory, sampled at each tick
        self.replica_timeline: dict[str, list[tuple[float, int]]] = {
            s.name: [] for s in sites}

        self.gateway = Gateway(self.manager, spill_policy=spill_policy,
                               telemetry=telemetry)
        self.telemetry = self.gateway.telemetry
        for w in workloads:
            if not w.pools:
                raise ValueError(f"workload {w.name!r} names no pools")
            for pname in w.pools:
                site = self.sites[pname]
                per_slot_tps = site.replica_tps / site.replica_slots
                lam = w.tokens_per_second or w.slots * per_slot_tps \
                    * (w.in_tokens + w.out_tokens) / max(w.out_tokens, 1)
                if w.service_class in (ServiceClass.SPOT,
                                       ServiceClass.PREEMPTIBLE):
                    lam = 0.0
                ent = f"{w.name}@{pname}"
                pool = self.manager.pool(pname)
                pool.add_entitlement(EntitlementSpec(
                    name=ent, tenant_id=w.name, pool=pname,
                    qos=QoS(service_class=w.service_class,
                            slo_target_ms=w.slo_ms),
                    baseline=Resources(lam, 0.0, w.slots)))
                if lam == 0.0:   # spot: fund as the first backfill would
                    pool.ledger.set_rate(
                        ent, site.replica_tps * charge_factor, 0.0)
            self.gateway.register_route(
                w.name, [(p, f"{w.name}@{p}") for p in w.pools])

        self.waiting: dict[str, list[tuple[float, float, str]]] = {
            s.name: [] for s in sites}
        self.requests: dict[str, Request] = {}
        self._events: list[tuple[float, int, str, dict]] = []
        self._eid = 0
        self._req_counter = 0
        self._next_arrival: dict[str, float] = {
            w.name: w.start_s for w in workloads}
        self.tick_records: dict[str, list] = {s.name: [] for s in sites}
        self._step_batch: list = []     # quantum mode: this step's batch
        #: callables ``hook(sim, now)`` run after EVERY completed step
        #: (post-settle, post-tick) — the chaos harness registers its
        #: invariant checkers here; the simulator stays policy-free
        self.step_hooks: list = []
        #: optional override ``fn(workload, req, attempt, resp) -> s``
        #: replacing the Retry-After-driven client backoff (see
        #: ``_apply_response``)
        self.retry_backoff = None

    # -- event API -----------------------------------------------------------
    def at(self, t: float, kind: str, **payload) -> None:
        """Schedule an external event: ``fail_replica`` /
        ``recover_replica`` (pool=<name>, idx=<replica>), or the
        generic ``call`` (fn=<callable(sim, now)>) used by scripted
        scenarios to inject arbitrary control-plane actions."""
        heapq.heappush(self._events, (t, self._eid, kind, payload))
        self._eid += 1

    # -- internals ------------------------------------------------------------
    def _alive(self, pool: str) -> list[ReplicaSim]:
        """Replicas still decoding — includes DRAINING ones, whose
        residual work must finish even though they accept no new
        dispatch (scale-down drains; see :meth:`_serving`)."""
        return [r for r in self.replicas[pool] if r.alive]

    def _serving(self, pool: str) -> list[ReplicaSim]:
        """Replicas eligible for new dispatch (alive, not draining)."""
        return [r for r in self.replicas[pool] if r.serving()]

    def _sync_replicas(self, pool: str) -> None:
        """Pool runtime capacity follows the SERVING replica count:
        a draining replica stops counting the moment the planner
        marks it (admission must see the post-decision capacity)."""
        self.manager.pool(pool).set_replicas(len(self._serving(pool)))

    # -- provisioning-lag model (the fleet planner's provision hook) ----------
    def _provision(self, pool, decision, now: float) -> None:
        """Apply a ScaleDecision to the simulated fleet.

        Scale-up: each missing replica becomes live ``provision_lag_s``
        seconds from now (draining slots are un-drained first — they
        are already warm).  Scale-down: surplus serving replicas drain
        — no new dispatch, residual requests finish (bounded by
        ``drain_s``, after which leftovers are re-queued) — and the
        pool's admission capacity drops immediately."""
        pname = pool.spec.name
        fleet = self.replicas[pname]
        incoming = self._incoming[pname]
        eff = len(self._serving(pname)) + len(incoming)
        target = decision.desired
        if target > eff:
            want = target - eff
            # warm slots first: cancel drains in progress
            for r in fleet:
                if want <= 0:
                    break
                if r.alive and r.draining:
                    r.draining = False
                    self._drain_deadline.pop(r.name, None)
                    want -= 1
            for i, r in enumerate(fleet):
                if want <= 0:
                    break
                if not r.alive and not r.failed and i not in incoming:
                    incoming.add(i)
                    self.at(now + self.provision_lag_s, "replica_live",
                            pool=pname, idx=i)
                    want -= 1
        elif target < eff:
            shrink = eff - target
            # cancel not-yet-live arrivals first (cheapest to undo)
            for i in sorted(incoming, reverse=True):
                if shrink <= 0:
                    break
                incoming.discard(i)
                shrink -= 1
            serving = sorted(self._serving(pname), key=ReplicaSim.load)
            for r in serving:
                if shrink <= 0:
                    break
                r.draining = True
                self._drain_deadline[r.name] = now + self.drain_s
                shrink -= 1
        self._sync_replicas(pname)

    def _complete_drains(self, now: float) -> None:
        """Retire draining replicas that emptied (or hit the drain
        deadline — leftovers re-queue on the same pool, like a
        failure)."""
        for pname, fleet in self.replicas.items():
            for r in fleet:
                if not (r.alive and r.draining):
                    continue
                if r.active and now < self._drain_deadline.get(
                        r.name, now):
                    continue
                for rid in list(r.active):
                    req = self.requests[rid]
                    req.state = RequestState.QUEUED
                    req.replica = None
                    heapq.heappush(self.waiting[pname],
                                   (-req.priority, req.arrival_s, rid))
                    del r.active[rid]
                r.alive = False
                r.draining = False
                self._drain_deadline.pop(r.name, None)

    def _new_request(self, w: Workload, now: float) -> Request:
        self._req_counter += 1
        rid = f"{w.name}-{self._req_counter}"
        req = Request(request_id=rid, entitlement=w.name,
                      prompt_tokens=[1] * w.in_tokens,
                      max_tokens=w.out_tokens, arrival_s=now,
                      api_key=w.name)
        self.requests[rid] = req
        return req

    def _apply_response(self, w: Workload, attempt: int, req: Request,
                        resp, now: float) -> None:
        if resp.status != 200:
            req.state = RequestState.DENIED
            req.deny_reason = resp.reason
            req.retry_after_s = resp.retry_after_s
            if attempt < w.max_retries:
                if self.retry_backoff is not None:
                    # scenario-controlled backoff: Retry-After hints
                    # legitimately differ between the scalar and
                    # quantum admission paths, so differential replay
                    # substitutes a deterministic function of
                    # (workload, attempt) to keep retry timelines —
                    # and therefore decision traces — comparable
                    backoff = self.retry_backoff(w, req, attempt, resp)
                else:
                    backoff = min(resp.retry_after_s or 1.0,
                                  w.retry_cap_s)
                self.at(now + max(backoff, self.dt), "retry",
                        workload=w.name, attempt=attempt + 1)
            return
        req.priority = resp.priority
        req.admitted_s = now
        req.pool = resp.pool
        req.spill_hops = resp.spill_hops
        heapq.heappush(self.waiting[resp.pool],
                       (-req.priority, now, req.request_id))

    def _arrive(self, w: Workload, now: float, attempt: int = 0) -> None:
        """Scalar per-request admission (the parity oracle path)."""
        req = self._new_request(w, now)
        resp = self.gateway.handle(
            w.name, req.request_id, input_tokens=w.in_tokens,
            max_tokens=w.out_tokens, now=now)
        self._apply_response(w, attempt, req, resp, now)

    def _arrive_batch(self, batch: list, now: float) -> None:
        """Quantum admission: ONE ``handle_quantum`` call for all of a
        step's arrivals (new + due retries), in arrival order."""
        from repro_torch.gateway import QuantumRequest
        if not batch:
            return
        reqs = [self._new_request(w, now) for w, _ in batch]
        resps = self.gateway.handle_quantum(
            [QuantumRequest(api_key=w.name, request_id=r.request_id,
                            input_tokens=w.in_tokens,
                            max_tokens=w.out_tokens)
             for (w, _), r in zip(batch, reqs)], now)
        for (w, attempt), req, resp in zip(batch, reqs, resps):
            self._apply_response(w, attempt, req, resp, now)

    def _dispatch(self, now: float) -> None:
        for pname, waiting in self.waiting.items():
            dispatch_waiting(waiting, self._serving(pname), self.requests,
                             self.manager.pool(pname).on_start)

    def _advance_replicas(self, now: float) -> None:
        # all pools' completions of one dt step share
        # ``finished_s = now + dt`` — ONE batched gateway callback per
        # step (the gateway settles each admitting pool's share in one
        # vectorized ``settle_rows``)
        done: list[tuple[str, Request]] = []
        for pname in self.replicas:
            advance_replicas(self._alive(pname), self.requests, self.dt,
                             now, lambda rid, req: done.append((rid, req)))
        # settle in (finished_s, rid) order — collection order follows
        # per-replica dict iteration and the pool map; sorting pins the
        # settle (and retry re-submission) sequence deterministically
        done.sort(key=lambda p: (p[1].finished_s, p[0]))
        if done:
            self.gateway.on_complete_batch(
                [(rid, req.max_tokens, req.finished_s - req.arrival_s)
                 for rid, req in done], now + self.dt)

    def _handle_event(self, kind: str, payload: dict, now: float) -> None:
        if kind == "fail_replica":
            pname = payload["pool"]
            replica = self.replicas[pname][payload["idx"]]
            replica.alive = False
            replica.failed = True
            replica.draining = False
            # in-flight requests on the dead node are re-queued on the
            # SAME pool (their charge lives in its ledger)
            for rid in list(replica.active):
                req = self.requests[rid]
                req.state = RequestState.QUEUED
                req.replica = None
                heapq.heappush(self.waiting[pname],
                               (-req.priority, req.arrival_s, rid))
                del replica.active[rid]
            self._sync_replicas(pname)
            if self.telemetry is not None:
                self.telemetry.incident_start(
                    f"{pname}/r{payload['idx']}", now)
        elif kind == "recover_replica":
            replica = self.replicas[payload["pool"]][payload["idx"]]
            replica.failed = False
            replica.alive = True
            self._sync_replicas(payload["pool"])
            if self.telemetry is not None:
                self.telemetry.incident_end(
                    f"{payload['pool']}/r{payload['idx']}", now)
        elif kind == "replica_live":
            # provisioning completed (scheduled by ``_provision``);
            # ignored if the planner cancelled it or the slot failed
            pname, idx = payload["pool"], payload["idx"]
            if idx not in self._incoming[pname]:
                return
            self._incoming[pname].discard(idx)
            replica = self.replicas[pname][idx]
            if replica.failed:
                return
            replica.alive = True
            replica.draining = False
            self._sync_replicas(pname)
        elif kind == "set_rate":
            # demand change (e.g. the experiment-3 surge): takes effect
            # from the next arrival on
            self.workloads[payload["workload"]].rate_rps = payload["rate"]
        elif kind == "retry":
            w = self.workloads[payload["workload"]]
            if now < w.end_s:
                if self.admission_mode == "quantum":
                    # retries join the step's quantum (ahead of new
                    # arrivals — same order the scalar path processes)
                    self._step_batch.append((w, payload["attempt"]))
                else:
                    self._arrive(w, now, attempt=payload["attempt"])
        elif kind == "call":
            # scripted-scenario escape hatch: run an arbitrary action
            # against the simulator at a scheduled instant (entitlement
            # churn, migrations, rate reshaping, ...)
            payload["fn"](self, now)
        else:
            raise ValueError(kind)

    # -- main loop ------------------------------------------------------------
    def run(self, duration_s: float) -> dict:
        now = 0.0
        interval = min(p.spec.accounting_interval_s
                       for p in self.manager.pools.values())
        next_tick = interval
        steps = int(duration_s / self.dt)
        quantum = self.admission_mode == "quantum"
        for _ in range(steps):
            self._step_batch = []
            while self._events and self._events[0][0] <= now:
                _, _, kind, payload = heapq.heappop(self._events)
                self._handle_event(kind, payload, now)
            for w in self.workloads.values():
                while (self._next_arrival[w.name] <= now
                       and w.start_s <= now < w.end_s):
                    if quantum:
                        self._step_batch.append((w, 0))
                    else:
                        self._arrive(w, now)
                    self._next_arrival[w.name] += 1.0 / w.rate_rps
                if now >= w.end_s:
                    self._next_arrival[w.name] = 1e18
            if quantum:
                self._arrive_batch(self._step_batch, now)
            if self.autoscale:
                self._complete_drains(now)
            self._dispatch(now)
            self._advance_replicas(now)
            if now >= next_tick:
                recs = self.manager.tick(now)   # ONE batched dispatch
                for pname, rec in recs.items():
                    self.tick_records[pname].append(rec)
                if self.autoscale:
                    # close the loop: tick outputs → ONE plan_fleet
                    # call on the fleet's device → authorize/provision/
                    # migrate
                    plan = self.gateway.plan_quantum(now, records=recs)
                    self.plans.append((now, plan))
                for pname in self.replicas:
                    self.replica_timeline[pname].append(
                        (now, self.manager.pool(pname).replicas))
                next_tick += interval
            for hook in self.step_hooks:
                hook(self, now)
            now += self.dt
        return self.summary()

    # -- results ---------------------------------------------------------------
    def summary(self) -> dict:
        from repro_torch.serving.request import latency_summary
        per: dict[str, dict] = {}
        for wname in self.workloads:
            reqs = [r for r in self.requests.values()
                    if r.entitlement == wname]
            s = latency_summary(reqs)
            s["admitted_by_pool"] = {}
            for r in reqs:
                if r.pool is not None:
                    s["admitted_by_pool"][r.pool] = (
                        s["admitted_by_pool"].get(r.pool, 0) + 1)
            s["spilled"] = sum(1 for r in reqs if r.spill_hops > 0)
            s["denied_total"] = sum(
                1 for r in reqs if r.state == RequestState.DENIED)
            per[wname] = s
        return {
            "per_workload": per,
            "per_pool_history": {n: list(p.history)
                                 for n, p in self.manager.pools.items()},
            "replica_timeline": self.replica_timeline,
            "migrations": [prop for _, plan in self.plans
                           for prop in plan.applied],
        }
