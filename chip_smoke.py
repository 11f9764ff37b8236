#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--requests 16]

Run from a checkout (the port is imported from ``src/`` beside this
file); it needs one CUDA card and the CUDA toolkit (``nvcc``).  Phases,
each reported on its own line:

1. ``build``   — every CUDA kernel of the serve path built by ``nvcc``
   for sm_90a from ``src/repro_torch/kernels/csrc`` (one process per
   source, in parallel), and the card's name and power limit;
2. ``kernels`` — each kernel, on each of its routes, against its plain
   PyTorch version on the card: flash on the tensor-core route (bf16,
   dh 64 and 128) and the scalar route (float32, bf16 at dh 96, and bf16
   at dh 128 forced), over prompt lengths on both sides of the 64-row
   tiles, a window that starts inside a key tile and a softcap; paged
   (split-K, and the serial baseline in bf16) over contexts on both
   sides of its 64-token splits, empty to full, mixed, and with a whole
   split of -1 pages;
3. ``control`` — the control tick on the card against the same tick on
   the CPU for a seeded 4096-row state;
4. ``quantum`` — the batched admission path: the ``admit_quantum``
   kernel's default route and the first port's serial kernel against
   the plain version (decisions identical, not within a tolerance) on
   four seeded quanta of 65,536 requests over 4,096 entitlements (one
   that reaches every reason code, a pool that fills, falling weights
   that hand the rounds over to the serial walk, a hot row), each with
   its route, rounds, SM cycles by phase and both kernels' times; every
   route on edge cases; both routes timed over quantum lengths; the
   batched tick of 8 pools x 100,000 rows on the card against the CPU;
   one 10,000-request ``Gateway.handle_quantum`` over 512 entitlements
   on a pool on the card against one on the CPU; and the paper's
   Experiments 1 and 2 and the multi-pool routing scenario (quantum and
   scalar admission) through the port's simulators on the card against
   the CPU, with the kernel's launches counted by route on that path;
5. ``serve``   — TokenPool → Gateway → InferenceEngine on full-width,
   full-depth Qwen3-8B (bf16, random init from ``--seed``) serving a
   guaranteed and a spot tenant; every flash launch on this path must
   take the tensor-core route and every paged launch the split kernel,
   and a reduced model served on the card must give the same greedy
   tokens as on the CPU;
6. ``profile`` — a decode step and a prefill of 8 lanes on the same
   model, on the host clock and under ``torch.profiler`` (device time
   by kernel).

Then a ``timer`` line gives each kernel, the kernel it replaced and the
library call timed once more with the first port's serial timer (host
time inside the window), one JSON line describes each kernel (launches
on the serve path, error against the plain version, device times at
the path's shapes of the kernel, the kernel it replaced, its plain
version and the library call, and the card's bound for that work), and
the last line is the result.  Any failure exits non-zero
before the result line.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import importlib
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

#: H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
#: FLOP/s by operand type
HBM_BYTES_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
#: |kernel − plain| ≤ atol + rtol·|plain|, by dtype (the tolerances of
#: tests/test_kernels.py)
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
FLASH_SRC = "src/repro_torch/kernels/csrc/flash_attention.cu"
PAGED_SRC = "src/repro_torch/kernels/csrc/paged_attention.cu"
ADMIT_SRC = "src/repro_torch/kernels/csrc/admit_quantum.cu"
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:85"
PAGED_TPU = "src/repro/kernels/paged_attention/paged_attention.py:85"
#: not a Pallas kernel: the jitted lax.fori_loop of the JAX package
ADMIT_TPU = "src/repro/core/vectorized.py:70"
#: the port's kernel functions, as the profiler names them
PORT_KERNELS = ("flash_prefill_wgmma_kernel", "flash_prefill_kernel",
                "paged_split_kernel", "paged_merge_kernel",
                "paged_decode_kernel", "admit_rounds_kernel",
                "admit_walk_kernel")


class PhaseFailed(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseFailed(msg)


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


# -- timing ------------------------------------------------------------------
#: clock cycles per second that ``torch.cuda._sleep`` is sized with (the
#: H100 SXM's top SM clock; a slower clock only makes the wait longer)
SLEEP_CYCLES_S = 1.98e9


class Timer:
    """Median device time of one call over ``iters`` launches, each after
    a write of a buffer larger than L2 (the serve path finds each layer's
    K/V and weights cold), measured with CUDA events.

    :meth:`ms` times the device alone: a device-side wait is queued
    first, then all the (flush, start event, call, end event) groups,
    and the host synchronises once, so the device reaches every start
    event with its call already queued behind it.  The wait is sized
    from the host time of one group and doubled until the host finishes
    enqueuing before the wait ends.  :meth:`serial_ms` is the timer of
    the first port, one launch at a time, whose window also holds the
    host's time between the start event and the launch; it is kept only
    to show that difference."""

    def __init__(self, torch, iters: int = 30) -> None:
        self.torch = torch
        self.iters = iters
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def _warm(self, fn) -> float:
        torch = self.torch
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        self.flush.zero_()
        fn()
        host_s = time.perf_counter() - t
        torch.cuda.synchronize()
        return host_s

    def ms(self, fn) -> float:
        torch = self.torch
        wait_s = 2 * self.iters * self._warm(fn) + 1e-3
        for _ in range(4):
            pairs = [(torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                     for _ in range(self.iters)]
            torch.cuda._sleep(int(SLEEP_CYCLES_S * wait_s))
            waited = torch.cuda.Event()
            waited.record()
            for a, b in pairs:
                self.flush.zero_()
                a.record()
                fn()
                b.record()
            ahead = not waited.query()      # the device still waiting
            torch.cuda.synchronize()
            if ahead:
                times = sorted(a.elapsed_time(b) for a, b in pairs)
                return times[len(times) // 2]
            wait_s *= 2
        raise PhaseFailed("timer: the host never got ahead of the device")

    def serial_ms(self, fn) -> float:
        torch = self.torch
        self._warm(fn)
        times = []
        for _ in range(self.iters):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]


def max_err(torch, out, ref, dtype: str) -> tuple[float, bool]:
    """Max |out − ref| and whether every element is within tolerance."""
    o, r = out.float(), ref.float()
    diff = (o - r).abs()
    ok = bool((diff <= TOL[dtype] + TOL[dtype] * r.abs()).all())
    return float(diff.max()) if diff.numel() else 0.0, ok


# -- phase 1 -------------------------------------------------------------------
def phase_build() -> dict:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    paths = build.build_all()
    secs = time.perf_counter() - t0
    regs = {name: sorted({int(m) for m in re.findall(
        r"Used (\d+) registers", log)}) for name, (_, log)
        in build.BUILD_LOG.items()}
    spills = {name: max((int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)),
        default=0) for name, (_, log) in build.BUILD_LOG.items()}
    print(f"build: {len(paths)} kernel libraries (nvcc -gencode "
          f"arch=compute_90a,code=sm_90a, parallel) in {secs:.2f} s; "
          f"registers per thread {regs}; most spill bytes (stores + loads) "
          f"of one kernel {spills}")
    card = card_line()
    print(f"card: {card}")
    return {"seconds": secs, "card": card}


# -- phase 2 -------------------------------------------------------------------
def phase_kernels(torch, seed: int) -> dict:
    """Each kernel, on each of its routes, against its plain version on
    the card.  Returns the max error per kernel in the serve path's type
    (bfloat16) and route."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, reference_attention)
    from repro_torch.kernels.paged_attention import (
        paged_attention_serial, paged_decode_attention,
        reference_paged_attention)

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"flash_prefill": 0.0, "paged_decode": 0.0}
    lines = []
    H, Hkv = 32, 8
    # ragged lengths on both sides of the 64-row tiles, a window that
    # starts inside a key tile, a softcap
    flash_cases = [(S, None, None) for S in
                   (1, 3, 37, 63, 64, 65, 128, 130, 300, 512)]
    flash_cases += [(130, 40, None), (300, 64, None), (300, None, 50.0)]
    # (dtype, head width, route): the tensor-core route at both widths,
    # the scalar route for float32, for bf16 at a width wgmma does not
    # take, and forced at the serve path's width
    routes = [("bfloat16", 128, None), ("bfloat16", 64, None),
              ("float32", 128, None), ("bfloat16", 96, None),
              ("bfloat16", 128, "scalar")]
    for dt, dh, kernel in routes:
        dtype = getattr(torch, dt)
        errs = []
        before = dict(flash_attention.route_launches)
        for S, window, cap in flash_cases:
            # (B, H, S, dh) views of the model's (B, S, H, dh) tensors,
            # read in place as the serve path reads them
            q, k, v = (torch.randn(1, S, h, dh, device="cuda", generator=g)
                       .to(dtype).transpose(1, 2) for h in (H, Hkv, Hkv))
            out = flash_attention(q, k, v, causal=True, window=window,
                                  softcap=cap, kernel=kernel)
            torch.cuda.synchronize()
            ref = reference_attention(q, k, v, causal=True, window=window,
                                      softcap=cap)
            err, ok = max_err(torch, out, ref, dt)
            check(ok, f"flash {dt} dh={dh} route={kernel} S={S} "
                      f"window={window} softcap={cap}: max |err| {err} "
                      f"beyond tolerance {TOL[dt]}")
            errs.append(err)
        took = [r for r, n in flash_attention.route_launches.items()
                if n > before[r]]
        check(len(took) == 1, f"flash {dt} dh={dh}: routes taken {took}")
        if (dt, dh, kernel) == ("bfloat16", 128, None):
            check(took == ["wgmma"], "flash bf16 dh=128 did not take wgmma")
            worst["flash_prefill"] = max(errs)
        lines.append(f"flash {dt} dh={dh} {took[0]} max|err| "
                     f"{max(errs):.3g} (tol {TOL[dt]}, {len(errs)} cases)")

    B, T, mp, dh = 8, 16, 128, 128
    P = B * mp
    # contexts on both sides of the 64-token splits, empty to full; one
    # batch of mixed contexts; one where a whole split's pages are -1
    ctx_sets = [[c] * B for c in (0, 1, 63, 64, 65, 128, 2047)]
    ctx_sets.append([0, 1, 63, 64, 65, 128, 2047, 1000])
    ctx_sets.append([300] * B)
    for q_dt, kv_dt in (("float32", "float32"), ("bfloat16", "bfloat16"),
                        ("float32", "bfloat16")):
        qd, kd = getattr(torch, q_dt), getattr(torch, kv_dt)
        errs, serial_errs = [], []
        kp = torch.randn(P, T, Hkv, dh, device="cuda", generator=g).to(kd)
        vp = torch.randn(P, T, Hkv, dh, device="cuda", generator=g).to(kd)
        for i, ctxs in enumerate(ctx_sets):
            q = torch.randn(B, H, dh, device="cuda", generator=g).to(qd)
            bt = torch.randperm(P, device="cuda", generator=g) \
                .to(torch.int32).reshape(B, mp)
            cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
            for b, c in enumerate(ctxs):
                bt[b, (c + T - 1) // T:] = -1
            if i == len(ctx_sets) - 1:
                bt[:, 4:8] = -1               # tokens 64-127: one split
            outs = [paged_decode_attention(q, kp, vp, bt, cl)]
            if q_dt == kv_dt == "bfloat16":
                outs.append(paged_attention_serial(q, kp, vp, bt, cl))
            torch.cuda.synchronize()
            ref = reference_paged_attention(q, kp, vp, bt, cl)
            tol_dt = "bfloat16" if "bfloat16" in (q_dt, kv_dt) else q_dt
            for out, sink in zip(outs, (errs, serial_errs)):
                err, ok = max_err(torch, out, ref, tol_dt)
                check(ok, f"paged q {q_dt} pages {kv_dt} ctx={ctxs}: max "
                          f"|err| {err} beyond tolerance {TOL[tol_dt]}")
                zero = [b for b, c in enumerate(ctxs) if c == 0]
                check(not out[zero].float().abs().sum().item(),
                      "paged: context 0 must give zeros")
                sink.append(err)
        if q_dt == kv_dt == "bfloat16":
            worst["paged_decode"] = max(errs)
            lines.append(f"paged serial q {q_dt} / pages {kv_dt} max|err| "
                         f"{max(serial_errs):.3g} ({len(serial_errs)} cases)")
        lines.append(f"paged split q {q_dt} / pages {kv_dt} max|err| "
                     f"{max(errs):.3g} ({len(errs)} cases)")
    # the other head widths and group sizes the split kernel takes
    # (the reduced model of the serve phase has dh 16, G 2)
    ctxs = ctx_sets[-2]
    cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    for dt in ("float32", "bfloat16"):
        errs = []
        for dh_, (h, hkv) in ((16, (4, 2)), (32, (8, 1)), (64, (4, 4))):
            kp, vp = (torch.randn(P, T, hkv, dh_, device="cuda", generator=g)
                      .to(getattr(torch, dt)) for _ in range(2))
            q = torch.randn(B, h, dh_, device="cuda", generator=g) \
                .to(getattr(torch, dt))
            bt = torch.randperm(P, device="cuda", generator=g) \
                .to(torch.int32).reshape(B, mp)
            for b, c in enumerate(ctxs):
                bt[b, (c + T - 1) // T:] = -1
            out = paged_decode_attention(q, kp, vp, bt, cl)
            torch.cuda.synchronize()
            ref = reference_paged_attention(q, kp, vp, bt, cl)
            err, ok = max_err(torch, out, ref, dt)
            check(ok, f"paged {dt} dh={dh_} H={h}/{hkv} ctx={ctxs}: max "
                      f"|err| {err} beyond tolerance {TOL[dt]}")
            errs.append(err)
        lines.append(f"paged split {dt} dh 16/32/64, G 2/8/1 max|err| "
                     f"{max(errs):.3g}")
    print("kernels: all within tolerance vs plain versions on the card; "
          + "; ".join(lines))
    return worst


# -- phase 3 -------------------------------------------------------------------
def seeded_state(np, seed: int, n: int):
    """Columns of a mixed-class control state and the tick's inputs."""
    r = np.random.default_rng(seed)
    cols = dict(
        class_code=r.integers(0, 5, n).astype(np.int32),
        bound=r.random(n) < 0.85,
        baseline_tps=(r.random(n) * 400
                      * (r.random(n) < 0.8)).astype(np.float32),
        baseline_kv=(r.random(n) * 1e9
                     * (r.random(n) < 0.5)).astype(np.float32),
        baseline_conc=r.integers(0, 16, n).astype(np.float32),
        slo_ms=(50 + r.random(n) * 30000).astype(np.float32),
        burst=(r.random(n) * 3 * (r.random(n) < 0.5)).astype(np.float32),
        debt=((r.random(n) - 0.3) * 2
              * (r.random(n) < 0.6)).astype(np.float32))
    ins = [(r.random(n) * 500 * (r.random(n) < 0.7)).astype(np.float32),
           (r.random(n) * 2e9 * (r.random(n) < 0.5)).astype(np.float32),
           r.integers(0, 20, n).astype(np.float32),
           (r.random(n) * 800 * (r.random(n) < 0.8)).astype(np.float32)]
    return cols, ins, np.float32(0.5 * 400 * n * r.random()), \
        np.float32(100 + 5000 * r.random())


def ulps(np, a, b) -> int:
    """Largest distance in units of the last place between two f32
    arrays (ordered-integer view)."""
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max())


def phase_control(torch, np, seed: int) -> None:
    from repro_torch.core import control_plane as cp
    bound_ulps = 4
    cols, ins, cap, slo = seeded_state(np, seed, 4096)
    out = {}
    for dev in ("cuda", "cpu"):
        st = cp.ControlState(**{k: torch.from_numpy(v.copy()).to(dev)
                                for k, v in cols.items()})
        new, alloc, w = cp.control_tick(
            st, torch.tensor(cap, device=dev),
            *(torch.from_numpy(x).to(dev) for x in ins),
            torch.tensor(slo, device=dev))
        out[dev] = {"burst": new.burst.cpu().numpy(),
                    "debt": new.debt.cpu().numpy(),
                    "alloc": alloc.cpu().numpy(), "weights": w.cpu().numpy()}
    g, c = out["cuda"], out["cpu"]
    funded_equal = bool((g["alloc"] > 0).tolist() == (c["alloc"] > 0).tolist())
    check(funded_equal, "control: funded rows differ between CUDA and CPU")
    worst = {k: ulps(np, g[k], c[k]) for k in g}
    check(max(worst.values()) <= bound_ulps,
          f"control: CUDA vs CPU beyond {bound_ulps} ulps: {worst}")
    print(f"control: control_tick on cuda vs cpu, N=4096: funded rows "
          f"equal ({int((c['alloc'] > 0).sum())} funded), max ulps {worst} "
          f"(bound {bound_ulps})")


# -- phase 4 -------------------------------------------------------------------
#: Scenarios of the paper's experiments and of the multi-pool example,
#: with their parameters kept here (the script imports nothing of the
#: JAX package and nothing of ``benchmarks/``): Experiment 1 (§5.2,
#: ``benchmarks/experiment1_protection.py``), Experiment 2 (§5.3,
#: ``benchmarks/experiment2_fairshare.py``) and
#: ``examples/multi_pool_routing.py``.
EXP1_SERVICE_S = 64.0 / (240.0 / 16.0)       # one request on 1/16 replica


def exp1_sim(serving, core, admission: bool, device: str):
    rate = lambda slots: slots / EXP1_SERVICE_S          # noqa: E731
    sc, wl = core.ServiceClass, serving.Workload
    return serving.ServingSimulator(
        [wl(name="guaranteed-a", service_class=sc.GUARANTEED, slots=6,
            slo_ms=200.0, rate_rps=rate(6)),
         wl(name="spot-b", service_class=sc.SPOT, slots=10,
            slo_ms=30000.0, rate_rps=rate(10)),
         wl(name="guaranteed-c", service_class=sc.GUARANTEED, slots=6,
            slo_ms=200.0, rate_rps=rate(6), start_s=30.0, end_s=60.0)],
        replica_slots=16, replica_tps=240.0, n_replicas=1,
        admission=admission, device=device)


def exp2_sim(serving, core, device: str):
    sc, wl = core.ServiceClass, serving.Workload
    sim = serving.ServingSimulator(
        [wl(name="elastic-copilot", service_class=sc.ELASTIC, slots=5,
            slo_ms=500.0, rate_rps=2.33, in_tokens=32, out_tokens=32,
            max_retries=2),
         wl(name="elastic-synth", service_class=sc.ELASTIC, slots=5,
            slo_ms=30000.0, rate_rps=2.33, in_tokens=64, out_tokens=64,
            max_retries=2),
         wl(name="elastic-reports", service_class=sc.ELASTIC, slots=5,
            slo_ms=5000.0, rate_rps=0.67, in_tokens=80, out_tokens=96,
            start_s=210.0, max_retries=2)],
        replica_slots=8, replica_tps=120.0, n_replicas=2, admission=True,
        coeff=core.PriorityCoefficients(alpha_slo=2.0, alpha_burst=1.0,
                                        alpha_debt=4.0, gamma_debt=0.7),
        fixed_avg_slo_ms=15250.0, bucket_window_s=60.0, device=device)
    sim.at(30.0, "fail_replica", idx=1)
    sim.at(120.0, "recover_replica", idx=1)
    return sim


def routing_sim(serving, core, mode: str, device: str):
    sc, wl = core.ServiceClass, serving.Workload
    sim = serving.MultiPoolSimulator(
        workloads=[wl(name="prod-chat", service_class=sc.GUARANTEED,
                      slots=6, slo_ms=500.0, rate_rps=1.4,
                      pools=("east", "west")),
                   wl(name="batch-eval", service_class=sc.SPOT, slots=8,
                      slo_ms=30000.0, rate_rps=3.0, pools=("west", "east"),
                      max_retries=1)],
        sites=[serving.PoolSite("east", n_replicas=1, replica_slots=8,
                                replica_tps=120.0),
               serving.PoolSite("west", n_replicas=2, replica_slots=8,
                                replica_tps=120.0)],
        admission_mode=mode, device=device)
    sim.at(20.0, "fail_replica", pool="east", idx=0)
    sim.at(40.0, "recover_replica", pool="east", idx=0)
    return sim


def sim_record(sim) -> tuple:
    """Every request's outcome and timestamps, the timeline and every
    tick record of a finished simulation."""
    reqs = [(r.request_id, r.state.value, r.arrival_s, r.admitted_s,
             r.first_token_s, r.finished_s, r.priority, r.deny_reason,
             r.retry_after_s, r.pool, r.spill_hops)
            for r in sim.requests.values()]
    pools = ({"sim-pool": sim.pool.history} if hasattr(sim, "pool")
             else sim.tick_records)
    ticks = {name: [(h.t, h.allocations, h.priorities, h.debts, h.bursts,
                     h.in_flight, h.demand_tps) for h in recs]
             for name, recs in pools.items()}
    line = [(p.t, p.running, p.waiting, p.per_ent_running)
            for p in getattr(sim, "timeline", [])]
    return reqs, ticks, line


def ttft_p99(np, sim, ent: str, t0: float, t1: float) -> float:
    vals = [r.ttft for r in sim.requests.values()
            if r.entitlement == ent and r.ttft is not None
            and t0 <= r.arrival_s < t1]
    return float(np.percentile(vals, 99)) if vals else float("nan")


def admit_case(np, torch, r, n: int, m: int, **over):
    """Inputs of one ``admit_scan`` call on the CPU: the distribution of
    ``benchmarks/admission_throughput.py::vectorized_admission_rate``
    (random classes, Eq. 1 weights from random SLOs, 128-token
    requests) with tight buckets, some unbound rows, some rows at a
    concurrency limit of 1, some KV ceilings and a contended pool, so
    that every reason code occurs; ``over`` replaces any column or
    scalar."""
    from repro_torch.core import control_plane as cp
    cols = dict(
        class_code=r.randint(0, 5, n).astype(np.int32),
        bound=r.random_sample(n) < 0.97,
        baseline_tps=r.uniform(10, 100, n).astype(np.float32),
        baseline_kv=np.where(r.random_sample(n) < 0.2, 3 * 128 * 1000.0,
                             0.0).astype(np.float32),
        baseline_conc=np.where(r.random_sample(n) < 0.1, 1.0,
                               64.0).astype(np.float32),
        slo_ms=r.uniform(100, 30000, n).astype(np.float32),
        burst=np.zeros(n, np.float32), debt=np.zeros(n, np.float32))
    rows = dict(bucket_level=r.uniform(0, 2000, n).astype(np.float32),
                in_flight=r.randint(0, 3, n).astype(np.int32),
                kv_in_use=np.zeros(n, np.float32))
    reqs = dict(req_ent=r.randint(0, n, m).astype(np.int32),
                req_tokens=np.full(m, 128.0, np.float32),
                req_kv=np.where(r.random_sample(m) < 0.3, 128 * 1000.0,
                                0.0).astype(np.float32),
                req_live=np.ones(m, bool))
    scal = dict(pool_in_flight=5000, pool_resident=4096.0,
                pool_conc_cap=4096.0, running_min=5.0, slack_factor=1.0)
    for k, v in over.items():
        for d in (cols, rows, reqs, scal):
            if k in d:
                d[k] = v
    state = cp.ControlState(**{k: torch.from_numpy(v.copy())
                               for k, v in cols.items()})
    weights = cp.priority_rows(state, torch.tensor(1000.0),
                               cp.PriorityCoefficients())
    args = (state.class_code, state.bound, state.baseline_kv,
            state.baseline_conc, weights,
            *(torch.from_numpy(v.copy()) for v in rows.values()),
            *(torch.from_numpy(v.copy()) for v in reqs.values()))
    return args, {k: (np.float32(v) if isinstance(v, float) else v)
                  for k, v in scal.items()}


def admit_edge_cases(np, torch, seed: int):
    """(label, args, scalars): the decision-parity regressions of the
    reference's tests and the places where exactness is likely to
    break."""
    r = np.random.RandomState(seed + 13)
    n = 64
    el = np.full(n, 2, np.int32)                   # elastic: burst-capable
    cases = [
        # burst escape with free slots, until the pool turns contended
        ("burst escape", dict(class_code=el, baseline_conc=np.full(
            n, 2.0, np.float32), in_flight=np.full(n, 2, np.int32),
            bucket_level=np.full(n, 1e6, np.float32), pool_in_flight=0,
            pool_resident=10.0, pool_conc_cap=16.0), 40),
        # guaranteed over r_e: no escape even with free slots
        ("guaranteed over r_e", dict(class_code=np.full(n, 1, np.int32),
            baseline_conc=np.full(n, 2.0, np.float32),
            in_flight=np.full(n, 2, np.int32), pool_in_flight=0,
            pool_resident=10.0, pool_conc_cap=16.0), 40),
        # the escape closed: contended although slots are free
        ("escape closed when contended", dict(class_code=el,
            baseline_conc=np.full(n, 1.0, np.float32),
            in_flight=np.full(n, 1, np.int32), pool_in_flight=20,
            pool_resident=3.0, pool_conc_cap=16.0), 40),
        # spot with no limit is bounded by the pool's concurrency
        ("spot without a limit", dict(class_code=np.full(n, 3, np.int32),
            baseline_conc=np.zeros(n, np.float32),
            in_flight=r.randint(14, 18, n).astype(np.int32),
            pool_conc_cap=16.0, pool_in_flight=0), 200),
        # int32 against float32: 2^24 + 1 rounds to 2^24 as JAX promotes
        ("int to float promotion", dict(
            baseline_conc=np.full(n, 16777216.0, np.float32),
            in_flight=np.full(n, 16777217, np.int32),
            pool_in_flight=16777217, pool_conc_cap=16777216.0,
            running_min=1e9), 200),
        # padding rows: reasons computed, nothing admitted or charged
        ("padding rows", dict(req_live=np.arange(300) % 3 == 0), 300),
        # quanta that end inside a chunk of the kernel's walk
        ("one request", {}, 1),
        ("1,025 requests", {}, 1025),
    ]
    for label, over, m in cases:
        yield (label, *admit_case(np, torch, r, n, m, **over))
    # the threshold tie: requests whose own row sets the running min —
    # strict > denies them without slack, slack admits them
    tie_draw = dict(class_code=np.full(n, 3, np.int32),
                    bound=np.ones(n, bool),
                    baseline_conc=np.full(n, 64.0, np.float32),
                    bucket_level=np.full(n, 1e6, np.float32),
                    baseline_kv=np.zeros(n, np.float32),
                    req_ent=np.full(50, 7, np.int32))
    probe, _ = admit_case(np, torch, np.random.RandomState(seed + 29), n,
                          50, **tie_draw)
    tie = float(probe[4][7])
    for slack in (0.0, 0.5):
        yield (f"threshold tie, slack {slack}", *admit_case(
            np, torch, np.random.RandomState(seed + 29), n, 50,
            running_min=tie, slack_factor=float(np.float32(1.0 - slack)),
            **tie_draw))
    # more rows than shared memory holds: bucket and KV in global scratch
    yield ("32,768 rows (global scratch)",
           *admit_case(np, torch, r, 32768, 20000))


def admit_draws(np, torch, seed: int, n: int, m: int):
    """(label, args, scalars) of the four draws the kernel is checked
    and timed on: the kernel draw (contended from the start); a pool
    that fills during the quantum (none in flight, the running minimum
    unset, slack 0.1); shielded rows admitted in blocks of strictly
    falling weight under contention, so every block's first admit
    lowers the running minimum (the rounds hand over to the serial
    walk); and one row holding half of the requests."""
    r = np.random.RandomState
    yield ("draw", *admit_case(np, torch, r(seed), n, m))
    yield ("filling pool, slack 0.1", *admit_case(
        np, torch, r(seed), n, m, pool_in_flight=0, pool_conc_cap=4096.0,
        running_min=float("inf"), slack_factor=float(np.float32(0.9))))
    args, scal = admit_case(
        np, torch, r(seed + 1), n, m, class_code=np.full(n, 1, np.int32),
        bound=np.ones(n, bool), baseline_conc=np.zeros(n, np.float32),
        baseline_kv=np.zeros(n, np.float32),
        bucket_level=np.full(n, 1e9, np.float32), running_min=float("inf"))
    by_weight = np.argsort(-args[4].numpy(), kind="stable")
    args = (*args[:8], torch.from_numpy(
        np.repeat(by_weight, m // n).astype(np.int32)), *args[9:])
    yield ("falling weights", args, scal)
    args, scal = admit_case(np, torch, r(seed + 2), n, m)
    hot = np.random.RandomState(seed + 3).random_sample(m) < 0.5
    args[8][torch.from_numpy(hot)] = 7
    yield ("hot row (50 %)", args, scal)


def phase_quantum(torch, np, seed: int, card: str) -> dict:
    """The batched admission path on the card (see the module
    docstring).  Returns the ``admit_quantum`` kernel's report entry."""
    import repro_torch.core as core
    import repro_torch.serving as serving
    from repro_torch.core import control_plane as cp
    from repro_torch.gateway import Gateway, QuantumRequest
    aq_mod = importlib.import_module(
        "repro_torch.kernels.admit_quantum.admit_quantum")
    admit_scan = aq_mod.admit_scan

    def on(dev, args):
        return tuple(a.to(dev) for a in args)

    def reset_counts():
        admit_scan.launches = 0
        for k in admit_scan.route_launches:
            admit_scan.route_launches[k] = 0

    def same(out_k, out_p) -> int:
        """Number of requests whose admit bit, reason or priority bits
        differ between the kernel and the plain version."""
        a, rs, w = (x.cpu() for x in out_k)
        pa, prs, pw = out_p
        bad = (a != pa) | (rs != prs) | (w.view(torch.int32)
                                         != pw.view(torch.int32))
        return int(bad.sum())

    # a plain version reached with CUDA tensors would be a silent
    # fallback: count such calls for the whole phase
    plain_on_cuda = [0]
    plain = aq_mod.reference_admit_scan

    def guarded(*a, **kw):
        plain_on_cuda[0] += int(a[8].is_cuda)
        return plain(*a, **kw)

    aq_mod.reference_admit_scan = guarded
    try:
        # 1. the kernel's routes and the first port's serial kernel
        # against the plain version on four draws at the benchmark's
        # size, then on the edge cases, then timed
        n, m = 4096, 65536
        timer = Timer(torch)
        draws, first = [], None
        for label, args, scal in admit_draws(np, torch, seed, n, m):
            out_p = plain(*args, **scal)
            dev_args = on("cuda", args)
            how = aq_mod.route(m)
            out_k = admit_scan(*dev_args, **scal)
            stats = admit_scan.last_stats.tolist()
            out_s = admit_scan(*dev_args, **scal, kernel="serial")
            torch.cuda.synchronize()
            for name, out in ((how, out_k), ("serial", out_s)):
                diff = same(out, out_p)
                check(diff == 0, f"quantum: {label}: the {name} kernel and "
                                 f"the plain version disagree on {diff} of "
                                 f"{m} requests")
            codes = np.bincount(out_p[1].numpy(), minlength=5).tolist()
            if first is None:
                check(all(codes), f"quantum: the draw missed a reason "
                                  f"code: {codes}")
                first = (args, scal, dev_args, codes)
            k_ms = timer.ms(lambda: admit_scan(*dev_args, **scal))
            s_ms = timer.ms(lambda: admit_scan(*dev_args, **scal,
                                               kernel="serial"))
            draws.append({"draw": label, "route": how, "rounds": stats[0],
                          "fallback_at": stats[1], "ms": k_ms,
                          "previous_ms": s_ms, "reasons": codes,
                          "cycles": stats[2:]})
            print(f"quantum draw: {label}, N={n} M={m}, reasons 0-4 "
                  f"{codes}: {how} and serial kernels identical to the "
                  f"plain version (admit bits, reasons, priority bits); "
                  f"route {how}, rounds {stats[0]}, serial walk from "
                  f"{stats[1]}, SM cycles from the rounds kernel's start "
                  f"to the end of its grouping / its rounds {stats[2]} / "
                  f"{stats[3]}, of the walk kernel {stats[4]} (first "
                  f"launch); {k_ms:.5f} ms ({1e6 * k_ms / m:.2f} ns a "
                  f"request), serial kernel {s_ms:.4f} ms "
                  f"({1e6 * s_ms / m:.1f} ns a request); card {card}")
        args, scal, dev_args, codes = first
        edges = []
        for label, e_args, e_scal in admit_edge_cases(np, torch, seed):
            e_p = plain(*e_args, **e_scal)
            e_dev = on("cuda", e_args)
            for kernel in ("rounds", "walk", "serial"):
                e_k = admit_scan(*e_dev, **e_scal, kernel=kernel)
                torch.cuda.synchronize()
                d = same(e_k, e_p)
                check(d == 0, f"quantum: edge case '{label}': the {kernel} "
                              f"kernel and the plain version disagree on "
                              f"{d} requests")
            edges.append(f"{label} {np.bincount(e_p[1].numpy(), minlength=5).tolist()}")
        print("quantum edges: rounds, walk and serial kernels identical to "
              "the plain version (reasons 0-4): " + "; ".join(edges))
        kernel_ms = draws[0]["ms"]
        t = time.perf_counter()
        plain(*args, **scal)
        plain_ms = 1e3 * (time.perf_counter() - t)
        row_bytes = sum(a.element_size() for a in args[:8]) * n
        req_bytes = sum(a.element_size() for a in args[8:]) * m
        out_bytes = (1 + 4 + 4) * m
        t_bytes = (row_bytes + req_bytes + out_bytes) / HBM_BYTES_S
        # ~24 operations a request (compares, selects, two adds, one
        # multiply, the gather's index arithmetic)
        t_ops = 24.0 * m / PEAK_FLOPS["float32"]
        # the routes against each other over quantum lengths (where the
        # walk should hand over to the rounds), and the adversarial draw
        # with the rounds unbounded (what the fallback saves)
        sweep = []
        for nn, mm in ((64, 32), (64, 256), (n, 256), (n, 1024), (n, 2048),
                       (n, 4096), (n, 16384)):
            s_args, s_scal = admit_case(np, torch,
                                        np.random.RandomState(seed), nn, mm)
            s_dev = on("cuda", s_args)
            sweep.append(f"N={nn} M={mm} walk " + "{:.5f}".format(timer.ms(
                lambda: admit_scan(*s_dev, **s_scal, kernel="walk")))
                + " rounds " + "{:.5f}".format(timer.ms(
                    lambda: admit_scan(*s_dev, **s_scal, kernel="rounds"))))
        f_label, f_args, f_scal = next(
            d for d in admit_draws(np, torch, seed, n, m)
            if d[0].startswith("falling"))
        f_dev = on("cuda", f_args)
        kept = aq_mod.MAX_ROUNDS, aq_mod.MIN_COMMIT
        aq_mod.MAX_ROUNDS, aq_mod.MIN_COMMIT = 1 << 30, 1
        try:
            out_u = admit_scan(*f_dev, **f_scal, kernel="rounds")
            u_stats = admit_scan.last_stats.tolist()
            check(same(out_u, plain(*f_args, **f_scal)) == 0,
                  "quantum: unbounded rounds disagree with the plain version")
            u_ms = timer.ms(lambda: admit_scan(*f_dev, **f_scal,
                                               kernel="rounds"))
        finally:
            aq_mod.MAX_ROUNDS, aq_mod.MIN_COMMIT = kept
        print(f"quantum routes: ms by quantum length (draw "
              f"distribution): " + "; ".join(sweep) + f"; {f_label} with "
              f"the rounds unbounded: {u_stats[0]} rounds, {u_ms:.4f} ms; "
              f"plain version of the first draw on the CPU {plain_ms:.1f} "
              f"ms (host clock); card {card}")

        # 2. the batched tick, 8 pools x 100,000 rows
        P, rows_n = 8, 100_000
        width = cp.bucket_width(rows_n)
        pools = [seeded_state(np, seed + 100 + k, rows_n) for k in range(P)]
        ins = [np.zeros((P, width), np.float32) for _ in range(4)]
        for k, (_, pin, _, _) in enumerate(pools):
            for i in range(4):
                ins[i][k, :rows_n] = pin[i]
        caps = np.array([c for _, _, c, _ in pools], np.float32)
        slos = np.array([s for _, _, _, s in pools], np.float32)
        outs = {}
        for dev in ("cuda", "cpu"):
            states = cp.stack_states(
                [cp.ControlState(**{k: torch.from_numpy(v.copy()).to(dev)
                                    for k, v in cols.items()})
                 for cols, _, _, _ in pools], width=width)
            t = time.perf_counter()
            new, alloc, w = cp.control_tick_pools(
                states, torch.from_numpy(caps).to(dev),
                *(torch.from_numpy(x).to(dev) for x in ins),
                torch.from_numpy(slos).to(dev))
            if dev == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t
            outs[dev] = ({"burst": new.burst.cpu().numpy(),
                          "debt": new.debt.cpu().numpy(),
                          "alloc": alloc.cpu().numpy(),
                          "weights": w.cpu().numpy()}, secs)
        (g, g_s), (c, c_s) = outs["cuda"], outs["cpu"]
        check(bool(((g["alloc"] > 0) == (c["alloc"] > 0)).all()),
              "quantum: batched tick funds other rows on CUDA than on CPU")
        worst = {k: ulps(np, g[k], c[k]) for k in g}
        check(max(worst.values()) <= 4,
              f"quantum: batched tick CUDA vs CPU beyond 4 ulps: {worst}")
        print(f"quantum tick: control_tick_pools {P} pools x {rows_n} rows "
              f"(width {width}) on cuda vs cpu: funded rows equal, max ulps "
              f"{worst} (bound 4); {1e3 * g_s:.1f} ms on the card, "
              f"{1e3 * c_s:.1f} ms on the CPU (host clock, first call); "
              f"card {card}")

        # 3. one 10,000-request quantum through the gateway
        def gateway(dev):
            pool = core.TokenPool(core.PoolSpec(
                name="p", model="m", scaling=core.ScalingBounds(1, 1),
                per_replica=core.Resources(1e9, 1e15, 1e6)), device=dev)
            gw = Gateway(pool)
            for i in range(512):
                pool.add_entitlement(core.EntitlementSpec(
                    name=f"e{i}", tenant_id=f"t{i}", pool="p",
                    qos=core.QoS(core.ServiceClass.ELASTIC, 1000.0),
                    baseline=core.Resources(1e6, 0.0, 1e3)))
                gw.register_key(f"k{i}", f"e{i}", pool="p")
            return gw

        def quantum(tag):
            return [QuantumRequest(f"k{i % 512}", f"{tag}{i}", 64, 64)
                    for i in range(10_000)]

        # a warm-up quantum and a second one compared between the
        # devices, then two more timed on the card alone
        resp, best = {}, float("inf")
        reset_counts()
        for dev in ("cuda", "cpu"):
            gw = gateway(dev)
            resp[dev] = []
            for rep in range(4 if dev == "cuda" else 2):
                qs = quantum(f"q{rep}-")
                t = time.perf_counter()
                out = gw.handle_quantum(qs, 0.0)
                if rep:
                    best = min(best, time.perf_counter() - t)
                if rep < 2:
                    resp[dev] += [tuple(x) for x in out]
                if rep == 1:
                    resp[dev].append([gw.pool.ledger.bucket(f"e{i}").level
                                      for i in range(512)])
            if dev == "cuda":
                gw_best, best = best, float("inf")
        gw_launches = admit_scan.launches
        gw_routes = dict(admit_scan.route_launches)
        bad = [i for i, (a, b) in enumerate(zip(resp["cuda"], resp["cpu"]))
               if a != b]
        check(len(resp["cuda"]) == len(resp["cpu"]) and not bad,
              f"quantum: handle_quantum on a CUDA pool and on a CPU pool "
              f"gave different responses or bucket levels, first at "
              f"{bad[:1]}")
        check(gw_launches == 4, f"quantum: {gw_launches} kernel launches for "
              "4 gateway quanta on the card")
        check(gw_routes == {"rounds": 4, "walk": 0, "serial": 0},
              f"quantum: the gateway's launches by route {gw_routes}")
        print(f"quantum gateway: handle_quantum of 10,000 requests over 512 "
              f"entitlements, responses identical on cuda and cpu; "
              f"{10_000 / gw_best:.0f} decisions/s on the card (best of 3 "
              f"after a warm-up, host clock, all bookkeeping), {10_000 / best:.0f} "
              f"on the CPU (one quantum after a warm-up); kernel launches by route "
              f"{gw_routes}; card {card}")

        # 4. the paper's experiments and the multi-pool scenario; the
        # kernel's launches are counted on the card's quantum-mode runs
        reset_counts()
        recs, claims = {}, []
        for dev in ("cuda", "cpu"):
            for name, make in (
                    ("exp1 admission", lambda: exp1_sim(serving, core, True,
                                                        dev)),
                    ("exp1 baseline", lambda: exp1_sim(serving, core, False,
                                                       dev)),
                    ("exp2", lambda: exp2_sim(serving, core, dev)),
                    ("routing quantum", lambda: routing_sim(
                        serving, core, "quantum", dev)),
                    ("routing scalar", lambda: routing_sim(
                        serving, core, "scalar", dev))):
                sim = make()
                t = time.perf_counter()
                sim.run(300.0 if name == "exp2" else
                        60.0 if name.startswith("routing") else 90.0)
                recs[dev, name] = (sim_record(sim),
                                   time.perf_counter() - t, sim)
        launches = admit_scan.launches
        route_counts = dict(admit_scan.route_launches)
        for name in ("exp1 admission", "exp1 baseline", "exp2",
                     "routing quantum", "routing scalar"):
            check(recs["cuda", name][0] == recs["cpu", name][0],
                  f"quantum: {name} differs between cuda and cpu (requests, "
                  "tick records or timeline)")
        check(launches > 0, "quantum: admit_quantum never launched on the "
                            "card's quantum-mode run")
        check(route_counts["serial"] == 0 and launches == sum(
            route_counts.values()), f"quantum: the experiments' launches "
              f"by route {route_counts} (of {launches})")
        check(not plain_on_cuda[0], f"quantum: the plain version was called "
              f"on CUDA tensors {plain_on_cuda[0]} times")
    finally:
        aq_mod.reference_admit_scan = plain

    e1, e1b = recs["cuda", "exp1 admission"][2], recs["cuda", "exp1 baseline"][2]
    e2, rq = recs["cuda", "exp2"][2], recs["cuda", "routing quantum"][2]
    for arm, sim in (("token pools", e1), ("baseline", e1b)):
        p99 = [ttft_p99(np, sim, "guaranteed-a", a, b)
               for a, b in ((0, 30), (30, 60), (60, 90))]
        claims.append(f"exp1 {arm}: guaranteed-a TTFT P99 by phase "
                      f"{p99[0]:.3f} / {p99[1]:.3f} / {p99[2]:.3f} s, max "
                      f"queue {max(p.waiting for p in sim.timeline)}")

    def spot_share(t0, t1):
        pts = [p for p in e1.timeline if t0 <= p.t < t1 and p.running]
        return sum(p.per_ent_running.get("spot-b", 0) / p.running
                   for p in pts) / max(len(pts), 1)

    spot = [r for r in e1.requests.values()
            if r.entitlement == "spot-b" and 30 <= r.arrival_s < 60]
    claims.append(
        f"exp1 spot share by phase {spot_share(10, 30):.2f} / "
        f"{spot_share(35, 60):.2f} / {spot_share(65, 90):.2f}, spot "
        f"throttled in phase 2 "
        f"{sum(r.state.value == 'denied' for r in spot) / len(spot):.2f}")
    claims.append("exp2 low-priority denials " + ", ".join(
        f"{w} {e2.pool.status[w].denied_low_priority}" for w in e2.workloads)
        + "; peak debt " + ", ".join(
            f"{w} {max(h.debts.get(w, 0.0) for h in e2.pool.history):.3f}"
            for w in e2.workloads))
    prod = [r for r in rq.requests.values() if r.entitlement == "prod-chat"]
    claims.append(f"routing (quantum): prod-chat spilled "
                  f"{sum(r.spill_hops > 0 for r in prod)}, denied "
                  f"{sum(r.state.value == 'denied' for r in prod)}")
    wall = {(dev, name): secs for (dev, name), (_, secs, _) in recs.items()}
    secs = ", ".join(f"{name} {wall['cuda', name]:.2f} / "
                     f"{wall['cpu', name]:.2f} s"
                     for name in ("exp1 admission", "exp1 baseline", "exp2",
                                  "routing quantum", "routing scalar"))
    print("quantum experiments: requests, tick records and timelines "
          "identical on cuda and cpu for exp1 (both arms), exp2 and the "
          f"routing scenario (both modes); admit_quantum launches on the "
          f"card's run {launches}, by route {route_counts}; plain calls on CUDA {plain_on_cuda[0]}; "
          f"wall cuda / cpu: {secs}; card {card}")
    for line in claims:
        print(f"quantum claim: {line}; card {card}")
    return {
        "name": "admit_quantum", "route": "cuda", "source": ADMIT_SRC,
        "replaces": ADMIT_TPU, "launches": launches, "max_abs_err": 0.0,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": None,
        "previous_ms": draws[0]["previous_ms"],
        "previous": "serial kernel (admit_quantum_serial_launch)",
        "launches_by_route": route_counts,
        "draws": draws,
        "shape": f"N={n} rows, M={m} requests, first draw; plain version "
                 "on the CPU (host clock)",
    }


# -- phase 5 -------------------------------------------------------------------
def workload(np, seed: int, n: int, vocab: int):
    """Prompts of 32–512 tokens drawn from ``seed``, alternating
    tenants, one arrival every 0.25 simulated seconds."""
    r = np.random.default_rng(seed)
    lens = r.integers(32, 513, n)
    return [(f"r{i}", "prod" if i % 2 == 0 else "batch",
             r.integers(0, vocab, int(lens[i])).tolist(), 0.25 * i)
            for i in range(n)]


def drive(torch, eng, pool, serving, reqs_spec, max_tokens: int):
    """Submit the workload over simulated time, ticking the pool once a
    simulated second, then drain (and wait for the card).  Returns the
    requests."""
    reqs, now, k = [], 0.0, 0
    while k < len(reqs_spec):
        while k < len(reqs_spec) and reqs_spec[k][3] <= now:
            rid, tenant, prompt, t = reqs_spec[k]
            req = serving.Request(request_id=rid, entitlement=tenant,
                                  prompt_tokens=prompt,
                                  max_tokens=max_tokens, arrival_s=t,
                                  api_key=f"k-{tenant}")
            reqs.append(req)
            eng.submit(req, now=t)
            k += 1
        eng.step(now)
        if int(now + 0.05) > int(now):
            pool.tick(float(int(now + 0.05)))
        now += 0.05
    eng.run_until_drained(now)
    if eng.device.type == "cuda":
        torch.cuda.synchronize()
    return reqs


def phase_serve(torch, np, seed: int, n_requests: int) -> dict:
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_gateway
    from repro_torch.models import build_model, param_count
    from repro_torch.serving.request import latency_summary

    # the kernels' modules (the packages export functions of the same
    # names, so ``import a.b.c as m`` would bind the function)
    fa_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    slots, max_seq, page, max_tokens = 8, 2048, 16, 32
    cfg = get_config("qwen3-8b")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)

    # prefill timing: the Model contract's prefill, synchronised
    prefill_ms = []

    def timed_prefill(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.prefill(*a, **kw)
        torch.cuda.synchronize()
        prefill_ms.append((a[1].shape[1], 1e3 * (time.perf_counter() - t)))
        return out

    # a plain version reached with CUDA tensors would be a silent
    # fallback: count such calls on the serve path
    plain_on_cuda = {"flash": 0, "paged": 0}

    def guard(fn, key):
        def wrapped(q, *a, **kw):
            plain_on_cuda[key] += int(q.is_cuda)
            return fn(q, *a, **kw)
        return wrapped

    saved = (fa_mod.reference_attention, pa_mod.reference_paged_attention)
    fa_mod.reference_attention = guard(saved[0], "flash")
    pa_mod.reference_paged_attention = guard(saved[1], "paged")
    try:
        pool, gw = build_gateway(cfg, slots, max_tokens, "cuda")
        eng = serving.InferenceEngine(
            dataclasses.replace(model, prefill=timed_prefill), params,
            slots=slots, max_seq=max_seq, gateway=gw, page_tokens=page)
        spec = workload(np, seed, n_requests, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        for fn in (fa_mod.flash_attention, pa_mod.paged_attention):
            fn.launches = 0
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        t = time.perf_counter()
        reqs = drive(torch, eng, pool, serving, spec, max_tokens)
        wall = time.perf_counter() - t
        launches = {
            "flash_prefill": fa_mod.flash_attention.route_launches["wgmma"],
            "paged_decode": pa_mod.paged_attention.route_launches["split"]}
        routes = {"flash": dict(fa_mod.flash_attention.route_launches),
                  "paged": dict(pa_mod.paged_attention.route_launches)}
    finally:
        fa_mod.reference_attention, pa_mod.reference_paged_attention = saved
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    check(launches["flash_prefill"] > 0 and launches["paged_decode"] > 0,
          f"serve: a kernel never launched on the serve path: {launches}")
    check(launches["flash_prefill"] == fa_mod.flash_attention.launches
          and launches["paged_decode"] == pa_mod.paged_attention.launches,
          f"serve: a launch took another route than wgmma flash and split "
          f"paged: {routes}")
    check(not any(plain_on_cuda.values()),
          f"serve: plain versions called on CUDA tensors: {plain_on_cuda}")
    fin = [r for r in reqs if r.state.value == "finished"]
    denied = [r for r in reqs if r.state.value == "denied"]
    check(len(fin) + len(denied) == len(reqs),
          "serve: a request neither finished nor was denied")
    for tenant in ("prod", "batch"):
        check(any(r.entitlement == tenant for r in fin),
              f"serve: tenant {tenant} had no request served")
    for r in fin:
        check(len(r.output_tokens) == max_tokens
              and all(0 <= tok < cfg.vocab_size for tok in r.output_tokens),
              f"serve: {r.request_id} gave {len(r.output_tokens)} tokens "
              "or ids outside the vocabulary")
    check(len(prefill_ms) == len(fin), "serve: one prefill per request")
    check(launches["flash_prefill"] == len(fin) * cfg.num_layers,
          f"serve: {launches['flash_prefill']} prefill launches for "
          f"{len(fin)} requests x {cfg.num_layers} layers")
    prefill_s = sum(ms for _, ms in prefill_ms) / 1e3
    decode_tokens = sum(len(r.output_tokens) - 1 for r in fin)
    decode_s = wall - prefill_s

    # the path's output is finite at full width: logits of a fresh
    # prompt through the engine's pages
    kv = eng.kv_pages
    kv.allocate("probe", 40)
    table = torch.from_numpy(kv.block_table("probe", eng.max_pages)[None]) \
        .to("cuda")
    tok = torch.tensor([spec[0][2][:40]], device="cuda")
    logits = model.prefill(params, tok, eng.cache, table)
    kv.free("probe")
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          "serve: full-width logits not finite or of the wrong shape")

    for tenant in ("prod", "batch"):
        sel = [r for r in reqs if r.entitlement == tenant]
        print(f"serve {tenant}: {latency_summary(sel)}")
    lens = [s for s, _ in prefill_ms]
    print(
        f"serve: qwen3-8b full width and depth ({cfg.num_layers} layers, "
        f"d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
        f"dh={cfg.head_dim}, d_ff={cfg.d_ff}, vocab {cfg.vocab_size} padded "
        f"to {cfg.padded_vocab}), {n_params / 1e9:.3f} B params "
        f"{cfg.dtype}, "
        f"init {init_s:.1f} s; slots {slots}, max_seq {max_seq}, "
        f"{kv.total_pages} pages of {page}; admits "
        f"{len(reqs) - len(denied)} denies {len(denied)} "
        f"(prod {sum(r.entitlement == 'prod' for r in denied)}, batch "
        f"{sum(r.entitlement == 'batch' for r in denied)}); tokens generated "
        f"{sum(len(r.output_tokens) for r in fin)}; prefill "
        f"{1e3 * prefill_s / max(len(prefill_ms), 1):.2f} ms per request "
        f"(prompts {min(lens)}-{max(lens)} tokens); decode "
        f"{decode_tokens / decode_s:.1f} tokens/s of wall time "
        f"({decode_tokens} tokens in {decode_s:.2f} s); peak memory "
        f"{peak_gb:.2f} GB; launches by route {routes}; plain calls on CUDA "
        f"{plain_on_cuda}")
    return {"launches": launches, "prompts": [len(s[2]) for s in spec],
            "fin_ctx": [len(r.prompt_tokens) + max_tokens // 2
                        for r in fin[:slots]],
            "engine": eng, "model": model, "params": params, "cfg": cfg}


def phase_profile(torch, np, seed: int, served: dict) -> None:
    """Where the serve path's time goes, at the model layer: 8 prompts
    of 256 tokens prefilled one at a time into the engine's pages (as
    the engine does), then decode steps of those 8 lanes; a decode step
    and a prefill are timed on the host clock and, separately, under
    ``torch.profiler`` for the device time by kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng, model, params, cfg = (served[k] for k in
                               ("engine", "model", "params", "cfg"))
    B, S, n = 8, 256, 5
    kv = eng.kv_pages
    ids = [f"profile{i}" for i in range(B)]
    for rid in ids:
        kv.allocate(rid, S + 3 * n)
    tables = torch.from_numpy(np.stack(
        [kv.block_table(rid, eng.max_pages) for rid in ids])).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 3)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), device="cuda",
                           generator=g)
    state = {"pos": torch.full((B,), S, dtype=torch.int32, device="cuda"),
             "tok": torch.zeros((B, 1), dtype=torch.long, device="cuda")}

    def prefill(b=0):
        logits = model.prefill(params, prompt[b:b + 1], eng.cache,
                               tables[b:b + 1])
        state["tok"][b, 0] = logits[0, -1].argmax()

    def decode():
        logits = model.decode_step(params, state["tok"], eng.cache, tables,
                                   state["pos"])
        state["tok"] = logits[:, 0].argmax(-1, keepdim=True)
        state["pos"] = state["pos"] + 1

    def wall_ms(fn, reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / reps

    for b in range(B):
        prefill(b)
    decode()
    step_ms = wall_ms(decode, n)
    prefill_ms = wall_ms(prefill, 1)
    parts = []
    for name, fn in (("decode step", decode), ("prefill", prefill)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            profiled_ms = wall_ms(fn, 1)
        # kernel events only: a CPU op's row also carries the device
        # time of the kernels it launched
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0]
        if not events:
            parts.append(f"{name}: the profiler recorded no device time "
                         "(not measured)")
            continue
        dev = sum(e.self_device_time_total for e in events) / 1e3
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        # the port's own kernels, wherever they rank
        ours = [e for e in events if any(k in e.key for k in PORT_KERNELS)]
        parts.append(
            f"{name}: {dev:.2f} ms of kernels in {profiled_ms:.2f} ms "
            f"({100 * dev / profiled_ms:.0f} % busy); top " + ", ".join(
                f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms "
                f"({e.count}x)" for e in top) + "; port kernels " + ", ".join(
                f"{next(k for k in PORT_KERNELS if k in e.key)} "
                f"{e.self_device_time_total / 1e3:.3f} ms ({e.count}x)"
                for e in ours))
    for rid in ids:
        kv.free(rid)
    print(f"profile: {B} lanes at {S} tokens, full-width model; decode step "
          f"{step_ms:.2f} ms wall (mean of {n}); prefill of 1x{S} tokens "
          f"{prefill_ms:.2f} ms wall; under torch.profiler " + "; ".join(parts))


def phase_small_reference(torch, np, seed: int) -> None:
    """The same chain on a reduced Qwen3-8B in float32, served on the
    card (kernels) and on the CPU (plain versions): identical greedy
    tokens."""
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_gateway
    from repro_torch.models import Runtime, build_model

    cfg = get_config("qwen3-8b").reduced(dtype="float32", max_seq_len=256)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    spec = workload(np, seed + 1, 6, cfg.vocab_size)
    spec = [(rid, ten, p[:int(np.clip(len(p) // 4, 3, 120))], t)
            for rid, ten, p, t in spec]
    outs = {}
    for dev in ("cuda", "cpu"):
        pool, gw = build_gateway(cfg, 4, 12, dev)
        eng = serving.InferenceEngine(
            model, copy.deepcopy(params).to(dev), slots=4,
            max_seq=cfg.max_seq_len,
            gateway=gw, rt=Runtime(kv_cache_dtype="float32"))
        reqs = drive(torch, eng, pool, serving, spec, 12)
        outs[dev] = [(r.request_id, r.state.value, list(r.output_tokens))
                     for r in reqs]
    check(outs["cuda"] == outs["cpu"],
          "serve reference: reduced model on the card and on the CPU "
          "gave different greedy tokens")
    n_tok = sum(len(o[2]) for o in outs["cpu"])
    print(f"serve reference: reduced qwen3-8b float32, {len(spec)} "
          f"requests, {n_tok} greedy tokens identical on cuda (kernels) and "
          "cpu (plain versions)")


# -- kernel report ----------------------------------------------------------------
def kernel_report(torch, seed: int, served: dict, errs: dict) -> list:
    """Times of each kernel, of the kernel it replaced (``previous_ms``),
    of its plain version and of the library's attention at the serve
    path's shapes, beside the card's bound; then each kernel, its
    predecessor and the library call once more with the serial timer of
    the first port, on a line of their own."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, reference_attention)
    from repro_torch.kernels.paged_attention import (
        paged_attention_serial, paged_decode_attention,
        reference_paged_attention)

    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    bf16 = torch.bfloat16
    H, Hkv, dh = 32, 8, 128
    out, calls = [], {}

    # flash: one prefill (B=1) at the longest prompt of the workload, in
    # the model's (B, S, H, dh) layout as the serve path passes it
    S = max(served["prompts"])
    qm, km, vm = (torch.randn(1, S, h, dh, device="cuda", generator=g)
                  .to(bf16) for h in (H, Hkv, Hkv))
    q, k, v = (x.transpose(1, 2) for x in (qm, km, vm))
    flops = 4.0 * H * dh * S * (S + 1) / 2          # causal pairs only
    nbytes = 2.0 * (2 * H + 2 * Hkv) * S * dh         # q, k, v in; out
    t_ops = flops / PEAK_FLOPS["bfloat16"]
    t_bytes = nbytes / HBM_BYTES_S
    o = torch.empty_like(q)
    calls["flash_prefill"] = {
        "kernel": lambda: flash_attention(q, k, v, causal=True, out=o),
        "previous": lambda: flash_attention(q, k, v, causal=True, out=o,
                                            kernel="scalar"),
        "library": lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)}
    out.append({
        "name": "flash_prefill", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU,
        "launches": served["launches"]["flash_prefill"],
        "max_abs_err": errs["flash_prefill"],
        "ms": timer.ms(calls["flash_prefill"]["kernel"]),
        "plain_ms": timer.ms(lambda: reference_attention(q, k, v,
                                                         causal=True)),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": timer.ms(calls["flash_prefill"]["library"]),
        "previous_ms": timer.ms(calls["flash_prefill"]["previous"]),
        "previous": "scalar route (flash_prefill_bf16)",
        "shape": f"B=1 H={H} H_kv={Hkv} S={S} dh={dh} bf16 causal",
    })

    # paged: one decode step of the 8 lanes at the contexts they reach
    # mid-generation on the serve path, in the engine's page layout
    ctx = served["fin_ctx"]
    B, T = len(ctx), 16
    mp = 2048 // T + 1
    P = B * mp
    kp = torch.randn(P, T, Hkv, dh, device="cuda", generator=g).to(bf16)
    vp = torch.randn(P, T, Hkv, dh, device="cuda", generator=g).to(bf16)
    qd = torch.randn(B, H, dh, device="cuda", generator=g).to(bf16)
    bt = torch.randperm(P, device="cuda", generator=g).to(torch.int32) \
        .reshape(B, mp)
    for b, c in enumerate(ctx):
        bt[b, (c + T - 1) // T:] = -1
    cl = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    live = sum(ctx)
    nbytes = 2.0 * (2 * B * H * dh + 2 * live * Hkv * dh) \
        + 4.0 * (bt.numel() + B)
    flops = 4.0 * H * dh * live
    t_ops = flops / PEAK_FLOPS["bfloat16"]
    t_bytes = nbytes / HBM_BYTES_S
    # the library yardstick: SDPA over the same K/V gathered to dense
    # per sequence up to the longest live context, masked (the gather
    # itself is not timed)
    n_live = -(-max(ctx) // T)
    K = n_live * T
    pages = bt[:, :n_live].long().clamp_min(0)
    dk = kp[pages].reshape(B, K, Hkv, dh).transpose(1, 2)
    dv = vp[pages].reshape(B, K, Hkv, dh).transpose(1, 2)
    mask = (torch.arange(K, device="cuda")[None, :] < cl[:, None].long())
    mask = mask[:, None, None, :]
    qs = qd[:, :, None, :]
    calls["paged_decode"] = {
        "kernel": lambda: paged_decode_attention(qd, kp, vp, bt, cl),
        "previous": lambda: paged_attention_serial(qd, kp, vp, bt, cl),
        "library": lambda: F.scaled_dot_product_attention(
            qs, dk, dv, attn_mask=mask, enable_gqa=True)}
    out.append({
        "name": "paged_decode", "route": "cuda", "source": PAGED_SRC,
        "replaces": PAGED_TPU,
        "launches": served["launches"]["paged_decode"],
        "max_abs_err": errs["paged_decode"],
        "ms": timer.ms(calls["paged_decode"]["kernel"]),
        "plain_ms": timer.ms(lambda: reference_paged_attention(
            qd, kp, vp, bt, cl)),
        "bound_ms": 1e3 * max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops > t_bytes else "bytes",
        "library_ms": timer.ms(calls["paged_decode"]["library"]),
        "previous_ms": timer.ms(calls["paged_decode"]["previous"]),
        "previous": "serial kernel (paged_decode_serial_bf16)",
        "shape": f"B={B} H={H} H_kv={Hkv} dh={dh} T={T} max_pages={mp} "
                 f"ctx={ctx} bf16; library over {K} keys",
    })
    parts = []
    for r in out:
        for what, fn in calls[r["name"]].items():
            key = "ms" if what == "kernel" else f"{what}_ms"
            parts.append(f"{r['name']} {what} {timer.serial_ms(fn):.4f} "
                         f"(device alone {r[key]:.4f})")
    print("timer: ms with the serial timer of the first port, one launch "
          "at a time, host time inside the window: " + "; ".join(parts))
    for r in out:
        r["max_err"], r["kernel_ms"] = r["max_abs_err"], r["ms"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not in {ROOT / 'src'} ({e}); run "
              "this script from a checkout of the repository",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase = "build"
    try:
        card = phase_build()["card"]
        phase = "kernels"
        errs = phase_kernels(torch, args.seed)
        phase = "control"
        phase_control(torch, np, args.seed)
        phase = "quantum"
        admit_report = phase_quantum(torch, np, args.seed, card)
        phase = "serve"
        served = phase_serve(torch, np, args.seed, args.requests)
        phase_small_reference(torch, np, args.seed)
        phase = "profile"
        phase_profile(torch, np, args.seed, served)
        phase = "kernel report"
        report = kernel_report(torch, args.seed, served, errs)
        report.append(admit_report)
        card = card_line()
    except Exception:                     # noqa: BLE001 — report and fail
        traceback.print_exc()
        print(f"chip_smoke: phase '{phase}' failed", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": report}))
    print(card)                # as nvidia-smi gives it: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
