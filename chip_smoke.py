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
4. ``serve``   — TokenPool → Gateway → InferenceEngine on full-width,
   full-depth Qwen3-8B (bf16, random init from ``--seed``) serving a
   guaranteed and a spot tenant; every flash launch on this path must
   take the tensor-core route and every paged launch the split kernel,
   and a reduced model served on the card must give the same greedy
   tokens as on the CPU;
5. ``profile`` — a decode step and a prefill of 8 lanes on the same
   model, on the host clock and under ``torch.profiler`` (device time
   by kernel).

Then a ``timer`` line gives each kernel, the kernel it replaced and the
library call timed once more with the first port's serial timer (host
time inside the window), one JSON line describes each kernel (launches
on the serve path, error against the plain version, device times at
the serve path's shapes of the kernel, the kernel it replaced, its
plain version and the library call, and the card's bound for that
work), and the last line is the result.  Any failure exits non-zero
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
FLASH_TPU = "src/repro/kernels/flash_attention/flash_attention.py:85"
PAGED_TPU = "src/repro/kernels/paged_attention/paged_attention.py:85"
#: the port's kernel functions, as the profiler names them
PORT_KERNELS = ("flash_prefill_wgmma_kernel", "flash_prefill_kernel",
                "paged_split_kernel", "paged_merge_kernel",
                "paged_decode_kernel")


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
        phase_build()
        phase = "kernels"
        errs = phase_kernels(torch, args.seed)
        phase = "control"
        phase_control(torch, np, args.seed)
        phase = "serve"
        served = phase_serve(torch, np, args.seed, args.requests)
        phase_small_reference(torch, np, args.seed)
        phase = "profile"
        phase_profile(torch, np, args.seed, served)
        phase = "kernel report"
        report = kernel_report(torch, args.seed, served, errs)
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
