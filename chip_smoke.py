#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--requests 16]
    python3 chip_smoke.py --paged-probe [--parent OLD.cu] [--out ROWS.json]

Run from a checkout (the port is imported from ``src/`` beside this
file); it needs one CUDA card and the CUDA toolkit (``nvcc``).  Phases,
each reported on its own line:

1. ``build``   — every CUDA kernel of the serve path built by ``nvcc``
   for sm_90a from ``src/repro_torch/kernels/csrc`` (one process per
   source, in parallel), the registers and spill bytes of the dh 256
   tensor-core flash kernel from ``ptxas`` (no spill allowed), and the
   card's name and power limit;
2. ``analysis`` — the port's static analyzer, ``python -m
   repro_torch.analysis --strict`` over ``src/repro_torch`` (exit 0, its
   report in ``build/ANALYSIS_report.json``), then its runtime
   cross-check ``assert_no_rebuild`` around ten gateway quanta of 1 to
   10,000 requests on a 4-shard pool on the card, entitlements churned
   within the store's capacity before each: no kernel built, no
   whole-mirror upload, ``admit_quantum`` launches by route as the
   quanta's padded widths predict, and every admit bit and deny reason
   (a denying ``rounds`` quantum among them) equal to the same requests
   replayed one by one through ``Gateway.handle`` on a CPU pool; a
   growth past the store's capacity inside the check must raise;
3. ``kernels`` — each kernel, on each of its routes, against its plain
   PyTorch version on the card: flash on the tensor-core route (bf16,
   dh 64, 128 and 256) and the scalar route (float32, bf16 at dh 96, and
   bf16 at dh 128 and 256 forced), over prompt lengths on both sides of
   the 64-row tiles, a window that starts inside a key tile and a
   softcap; paged on the route ``route()`` names for each dtype (the
   ``group`` route for bf16 at G 4, the split route for float32 and for
   float32 queries over bf16 pages) and the split route forced in bf16,
   over contexts on both sides of its 64-token splits, empty to full,
   mixed, and with a whole split of -1 pages; the split route at dh
   16/32/64 (G 2/8/1); the group route at G 8, 10 and
   16 over dh 64, 128 and 256, and its partial form at G 8 and 10 over
   two ranks' blocks merged as the ranks merge them;
4. ``control`` — the control tick on the card against the same tick on
   the CPU for a seeded 4096-row state;
5. ``quantum`` — the batched admission path: the ``admit_quantum``
   kernel's default route against the plain version (decisions
   identical, not within a tolerance) on four seeded quanta of 65,536
   requests over 4,096 entitlements (one that reaches every reason
   code, a pool that fills, falling weights that hand the rounds over
   to the serial walk, a hot row), each with its route, rounds, SM
   cycles by phase and the kernel's time; every
   route on edge cases; both routes timed over quantum lengths; the
   batched tick of 8 pools x 100,000 rows on the card against the CPU;
   one 10,000-request ``Gateway.handle_quantum`` over 512 entitlements
   on a pool on the card against one on the CPU; and the paper's
   Experiments 1 and 2 and the multi-pool routing scenario (quantum and
   scalar admission) through the port's simulators on the card against
   the CPU, with the kernel's launches counted by route on that path;
6. ``planner`` — the fleet planner, the telemetry plane and the chaos
   harness: ``plan_fleet`` on the card against the CPU at 8, 64 and 512
   seeded pools (``demand_ewma`` 0.7; decisions identical, EWMA 0 ulps)
   and one ``FleetPlanner.plan`` timed on each device; Experiment 3
   (surge, outage, scale-up, migration, cooldown) in quantum and scalar
   admission on the card against the CPU, with its claim rows; the
   10,000-request gateway quantum with telemetry off and on, and
   ``explain()`` against the CPU's; every chaos scenario under every
   invariant checker and its three-mode replay, on the card against
   the CPU, with the kernel's denials; ``admit_quantum`` launches
   counted by route in each part;
7. ``shard``   — the sharded control plane (``core.shard_plane``), its
   ranks local processes of a gloo group that all use the one card:
   ``benchmarks/shard_scale.py``'s cells (1,048,576, 4,194,304 and
   16,777,216 rows on 1, 2, 4 and 8 ranks, one launch of ranks a size)
   with ``shard_tick`` bit for bit equal to the flat ``control_tick`` on
   the card, each cell's ms a tick, combines a tick and rows a rank;
   one 65,536-request quantum over 16,777,216 rows (draw (a)) through
   ``shard_admit_quantum`` on 1, 2 and 4 ranks equal to the flat kernel
   and the plain version, every rank's replay one launch of the
   ``rounds`` route; ``shard_plan_fleet`` equal to ``plan_fleet`` at
   512 pools on 2 and 4 ranks; a ``shards=4`` pool equal to a flat one
   (3 ticks and a 100-request ``handle_quantum``) on 2 ranks and in one
   process; the rows one detach and one attach re-upload and the tick
   ms of a 65,536-entitlement pool, flat and ``shards=8``; and the
   ``churn_migration`` chaos scenario with ``shards: 4`` on every site
   (0 violations, the card's trace equal to the CPU's);
8. ``serve``   — TokenPool → Gateway → InferenceEngine on full-width,
   full-depth Qwen3-8B (bf16, random init from ``--seed``) serving a
   guaranteed and a spot tenant; every flash launch on this path must
   take the tensor-core route and every paged launch the route
   ``route()`` names (``group`` at Qwen3-8B's G 4), every decode step
   a replay of one of the engine's decode graphs, each row count
   captured once (the same workload served on the eager path launching
   the same kernels by route, and five of the eight lanes decoding 8
   steps through the graph of 5 rows and the eager step in turn, logits
   within bf16's tolerance),
   and a reduced model served on the card must give the same greedy
   tokens as on the CPU;
9. ``profile`` — a decode step (eager, and through the engine's decode
   graph) and a prefill of 8 lanes on the same model, on the host clock
   and under ``torch.profiler`` (device time by kernel);
10. ``families`` — after the kernel report, with Qwen3-8B freed: the
   paged kernel at the families' shapes (gemma2-9b's dh 256 / G 2 with
   window 4096 and softcap 50 over contexts 0-8,192, recurrentgemma-2b's
   dh 256 / G 10 with window 2048, G 16, G 8, internvl2-2b's G 2 and
   whisper-small's dh 64 / G 1; f32 queries at dh 256) and flash at
   dh 256 with window and softcap (S = 512 and 4,608), at dh 256 / G 10
   with window 2048 (S = 2,600), at dh 128 / G 2, and without the
   causal mask at whisper's shapes (S = Sk = 1,500; Sq 64 and 1 over
   Sk = 1,500) against their plain versions, the paged group route also
   against its own plain mirror and beside the split route forced, each
   windowed case also with its window a chunk off and each non-causal
   case also causal, which must fail; gemma2-9b, qwen3-moe-30b-a3b, recurrentgemma-2b,
   xlstm-350m and internvl2-2b served at full width and depth through
   the gateway (every request admitted, flash on the route ``route()``
   names, every paged launch on the route ``route()`` names and the
   local layers windowed, no
   plain version on CUDA tensors, the MoE capacity's dropped share, the
   recurrent layers' share of a prefill and a decode step; gemma2-9b
   and internvl2-2b decoding through the engine's decode graphs, each
   row count captured once and a replay a decode step, the others
   eagerly), one line
   per model, and internvl2-2b's image prefix (256 patch embeddings) at
   the model level; whisper-small at full width and depth through its
   model entry points (4 sequences of 1,500 frames, 32 decode steps,
   flash launches counted by call); and every configuration the engine
   serves, reduced in float32, with identical greedy tokens on the card
   (the dense ones through the decode graphs) and the CPU, and reduced
   whisper-small at the model level;
11. ``train`` — last, after the families (every served model freed):
   (a) full-width, full-depth tinyllama-1.1b (bf16 params, float32
   moments) trained 8 steps on the launcher's batch of 8 × 256 tokens
   through ``TrainLoop``, with ms a step, tokens/s, peak memory and one
   step's busy share under ``torch.profiler``; the same run again with
   a checkpoint every 4 steps, crashed after step 4 and resumed by a
   new ``TrainLoop`` from the step-4 commit, its steps 4-7 held to the
   uninterrupted run's losses; (b) 2 full-width steps with each
   gradient compressor (int8, top-k) and their wire bytes; (c) the
   reference's end-to-end example, ``python -m repro_torch.launch.train
   --reduce 100m``, for 200 steps, its loss falling; (d) the step-8
   checkpoint restored into a fresh model and served: a prefill of 4
   prompts on the flash kernel's ``wgmma`` route (each layer's output
   held to its plain version on the trained activations) and 16 greedy
   decode steps on the paged kernel's ``group`` route, launches counted
   by route,
   no plain version on CUDA tensors, the logits against
   ``forward_train``'s no further than bf16's own drift from float32;
   (e) reduced float32 tinyllama-1.1b trained 8 steps on the card and on
   the CPU, and one train step of each reduced family of
   ``tests/test_torch_train_families.py`` on both;
12. ``model_shard`` — last: model sharding, its ranks local gloo
   processes that all use the one card (the collectives staged through
   the host): (a) full-width, full-depth Qwen3-8B on a 1×2 mesh
   (head-sharded KV): the first 8 of the serve phase's prompts
   prefilled, then 32 greedy decode steps through ``prefill`` /
   ``decode_step`` with the mesh-ful runtime, every flash launch on
   ``wgmma`` and every paged launch on the route ``route()`` names
   (``group``), no plain version on CUDA
   tensors, the decode step's ms and its share in collectives, then a
   pass of the same weights in float32 that holds each layer's sharded
   attention and MLP within 1e-4·max|ref| of rank 0's single-device
   float32 layer on the same inputs; (b) tinyllama-1.1b on 1×8
   (sequence-sharded KV: every paged launch the partial form of the
   ``group`` route) held the
   same way; (c)
   qwen3-moe-30b-a3b cut to 4 of its 48 layers on 2×2: ``moe_mlp_ep``
   against ``moe_mlp`` at a capacity that drops nothing, and the
   all-to-alls' bytes of a served prefill and decode; (d) the sharded
   train step of full-width tinyllama-1.1b on 2×2 (FSDP and TP): 2
   float32 steps against 2 single-device steps (losses, params, each
   leaf's update and first moment), then 2 bfloat16 steps
   with ms and peak memory a rank; (e) the dry-run of qwen3-8b
   decode_32k on 16×16 and its roofline under the card's peaks; (f)
   one launch of 1×2 ranks serving, in turn and each freed before the
   next, full-width, full-depth recurrentgemma-2b (4 prompts of
   2,100–2,600 tokens past its 2,048 window; its one KV head does not
   split, so every paged launch is the partial form of the ``group``
   route), xlstm-350m (4
   prompts of 32–64 tokens) and whisper-small through its entry points
   (2 prompts over 1,500 frames each; KV heads split, every paged
   launch split, its G 1), 8 greedy steps each: launches by route, the same
   tokens on every rank, then a float32 pass holding every layer (its
   attention and MLP, RG-LRU block, xLSTM cell, encoder or decoder
   layer) within 1e-4·max|ref − in| of rank 0's single-device float32
   layer on the same input; then flash and paged at 16 local heads over
   4 KV heads and the partial route (a window across two ranks' blocks,
   empty blocks), and (f)'s new shapes (flash at dh 256 with 5 local
   heads over 1 KV head and a window of 2,048; the partial route at dh
   256, G 10, window 2,048) against their plain versions, timed beside
   SDPA and the paged rows beside the split route forced.

Then a ``timer`` line gives each kernel, the route it replaced and the
library call timed once more with the first port's serial timer (host
time inside the window), one JSON line describes each kernel (launches
on the serve path — and, for ``admit_quantum``, on the planner and
shard phases, for the attention kernels on the ``train`` phase's (d)
— error against the plain version, device times at
the path's shapes of the kernel, the route it replaced, its plain
version and the library call, and the card's bound for that work; one
row per shape of the ``families`` phase; and the ``model_shard``
phase's rows, with their launches on that phase's main paths), and the
last line is the result.  Any failure exits non-zero
before the result line.

With ``--paged-probe`` it runs the paged decode kernel alone (about a
minute and a half on an H100, builds included): the registers and spill
bytes of each group and merge instance, each route against the plain
version, each route's call and its two passes (by kernel name under
``torch.profiler``) timed beside SDPA and the bound at the served and
sharded shapes, and both routes over group sizes 1-16; with ``--parent
OLD.cu`` (another version of ``paged_attention.cu``, for example ``git
show <rev>:src/repro_torch/kernels/csrc/paged_attention.cu``) that
source's split route too, timed in turns with this one's (parent, this,
this, parent).  Its rows go to ``--out`` (``build/paged_probe.json``).
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import gc
import importlib
import json
import math
import os
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
                "paged_split_kernel", "paged_group_kernel",
                "paged_merge_kernel",
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


def paged_key(pa_mod, torch, dh: int, group: int, partial: bool = False,
              dtype=None) -> str:
    """The ``paged_attention.route_launches`` key of a paged call at this
    head width and group (bf16 unless ``dtype`` says otherwise): the
    route ``route()`` names, in its partial form where the KV is
    sequence-sharded."""
    r = pa_mod.route(dtype or torch.bfloat16, dh, group)
    return {("split", False): "split", ("split", True): "partial",
            ("group", False): "group",
            ("group", True): "group_partial"}[r, partial]


def paged_inputs(torch, g, B, H, Hkv, dh, ctxs, dtype, q_dtype=None,
                 T=16, mp=None):
    """Random pages and queries on the card; each lane's table (``mp``
    pages wide, by default just wide enough) holds distinct page ids up
    to its context and −1 after it."""
    mp = mp or max(ctxs) // T + 1
    P = B * mp
    kp, vp = (torch.randn(P, T, Hkv, dh, device="cuda", generator=g)
              .to(dtype) for _ in range(2))
    q = torch.randn(B, H, dh, device="cuda", generator=g) \
        .to(q_dtype or dtype)
    bt = torch.randperm(P, device="cuda", generator=g).to(torch.int32) \
        .reshape(B, mp)
    for b, c in enumerate(ctxs):
        bt[b, (c + T - 1) // T:] = -1
    cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, cl


# -- phase 1 -------------------------------------------------------------------
#: the mangled name's part that marks the dh 256 tensor-core flash kernel
FLASH_DH256_KERNEL = "flash_prefill_wgmma_kernelILi256E"


def ptxas_kernel(log: str, name: str) -> tuple[int, int] | None:
    """(registers a thread, spill bytes stored + loaded) of the first
    kernel whose mangled name holds ``name`` in an ``nvcc -Xptxas -v``
    log; None if there is none."""
    for chunk in log.split("Compiling entry function")[1:]:
        if name in chunk.split("'")[1]:
            regs = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                              r"spill loads", chunk)
            if regs and spill:
                return (int(regs.group(1)),
                        int(spill.group(1)) + int(spill.group(2)))
    return None


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
    if "flash_attention" in build.BUILD_LOG:
        found = ptxas_kernel(build.BUILD_LOG["flash_attention"][1],
                             FLASH_DH256_KERNEL)
        check(found is not None, "build: no ptxas report for "
                                 f"{FLASH_DH256_KERNEL}")
        regs256, spill256 = found
        print(f"build: flash_prefill_wgmma_kernel<256> (bf16 flash at dh "
              f"256, tensor cores) {regs256} registers a thread, "
              f"{spill256} spill bytes (stores + loads)")
        check(spill256 == 0, f"build: the dh 256 flash kernel spills "
                             f"{spill256} bytes")
    else:
        print("build: flash_attention was not rebuilt in this process; "
              "no ptxas report for its dh 256 kernel")
    if "paged_attention" in build.BUILD_LOG:
        found = {dh: ptxas_kernel(build.BUILD_LOG["paged_attention"][1],
                                  f"paged_group_kernelILi{dh}E")
                 for dh in (64, 128, 256)}
        check(all(found.values()), f"build: no ptxas report for a "
                                   f"paged_group_kernel instance: {found}")
        print("build: paged_group_kernel<dh> (bf16 paged decode, tensor "
              "cores) registers, spill bytes (stores + loads): "
              + ", ".join(f"dh {dh} {r}, {sp}"
                          for dh, (r, sp) in found.items()))
        check(not any(sp for _, sp in found.values()),
              f"build: a paged_group_kernel instance spills: {found}")
    else:
        print("build: paged_attention was not rebuilt in this process; "
              "no ptxas report for its group kernels")
    card = card_line()
    print(f"card: {card}")
    return {"seconds": secs, "card": card}


# -- phase 1b: analysis -------------------------------------------------------
#: the analysis phase's quantum lengths, on both sides of the walk/rounds
#: boundary (a padded width of ``WALK_BELOW`` = 256) up to the gateway's
#: 10,000; a one-request quantum takes the scalar path (no launch)
ANALYSIS_SIZES = (1, 2, 100, 128, 129, 255, 256, 1000, 4096, 10_000)
#: entitlements of the analysis pool: its store holds 512 rows, so the
#: churn (3 out, 3 in before each quantum) stays within capacity
ANALYSIS_ENTS = 448
ANALYSIS_CHURN = 3


def analysis_add(core, gw, i: int) -> None:
    """Entitlement ``e{i}`` behind key ``k{i}``: elastic, with a small
    bucket and 3 slots for every eighth (so long quanta deny)."""
    tight = i % 8 == 0
    gw.pool.add_entitlement(core.EntitlementSpec(
        name=f"e{i}", tenant_id=f"t{i}", pool="p",
        qos=core.QoS(core.ServiceClass.ELASTIC, 1000.0),
        baseline=core.Resources(400.0 if tight else 1e6, 0.0,
                                3.0 if tight else 1e3)))
    gw.register_key(f"k{i}", f"e{i}", pool="p")


def analysis_gateway(core, Gateway, dev: str):
    """A pool of ``ANALYSIS_ENTS`` entitlements on a 4-shard store (churn
    re-uploads one block of the mirror, never the whole) on ``dev``."""
    pool = core.TokenPool(core.PoolSpec(
        name="p", model="m", scaling=core.ScalingBounds(1, 1),
        per_replica=core.Resources(1e9, 1e15, 1e6), shards=4), device=dev)
    gw = Gateway(pool)
    for i in range(ANALYSIS_ENTS):
        analysis_add(core, gw, i)
    return gw


def analysis_requests(QuantumRequest, gw, m: int, tag: str) -> list:
    """``m`` requests over the live keys, every other one on a key with
    a small bucket."""
    keys = sorted(f"k{n[1:]}" for n in gw.pool.entitlements)
    tight = [k for k in keys if int(k[1:]) % 8 == 0]
    return [QuantumRequest(tight[i // 2 % len(tight)] if i % 2 == 0
                           else keys[i % len(keys)], f"{tag}{i}", 64, 64)
            for i in range(m)]


def phase_analysis(torch, np, seed: int, card: str) -> dict:
    """(a) the port's static analyzer, strict, over ``src/repro_torch``;
    (b) its runtime cross-check on a pool on the card: across a loop of
    churned gateway quanta no kernel is built and the store's mirror is
    never re-uploaded whole, the launches by route are what the quantum
    lengths predict, and every decision equals the same requests
    replayed one by one through ``Gateway.handle`` on a CPU pool; a
    growth past the store's capacity inside the check must make it
    raise.  Returns the ``admit_quantum`` launches by route."""
    import repro_torch.core as core
    from repro_torch.analysis.runtime import assert_no_rebuild
    from repro_torch.core.control_plane import quantum_width
    from repro_torch.gateway import Gateway, QuantumRequest
    from repro_torch.kernels.admit_quantum.admit_quantum import WALK_BELOW

    # (a) the strict scan, as CI runs it
    t0 = time.perf_counter()
    report_path = ROOT / "build" / "ANALYSIS_report.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--strict",
         "--report", str(report_path), "src/repro_torch"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    scan_s = time.perf_counter() - t0
    check(res.returncode == 0,
          f"analysis: the strict scan exited {res.returncode}:\n"
          f"{res.stdout[-4000:]}{res.stderr[-4000:]}")
    blob = json.loads(report_path.read_text())
    check(blob["unwaived_total"] == 0 and len(blob["rules"]) == 7,
          f"analysis: report {blob['rules']}, "
          f"{blob['unwaived_total']} unwaived")
    by_rule = {r: (v["findings"], v["waived"])
               for r, v in sorted(blob["rules"].items())}
    print(f"analysis scan: python -m repro_torch.analysis --strict "
          f"src/repro_torch exit 0 in {scan_s:.2f} s: "
          f"{blob['files_scanned']} files, {len(blob['rules'])} rules, "
          f"findings (all, waived) by rule {by_rule}; report "
          f"build/ANALYSIS_report.json")

    # (b) the runtime cross-check around churned quanta
    t1 = time.perf_counter()
    gws = {dev: analysis_gateway(core, Gateway, dev)
           for dev in ("cuda", "cpu")}
    gw, ref = gws["cuda"], gws["cpu"]
    store = gw.pool.store

    def replay(qs, now):
        return [ref.handle(q.api_key, q.request_id, q.input_tokens,
                           q.max_tokens, now,
                           kv_bytes_per_token=q.kv_bytes_per_token)
                for q in qs]

    def decisions(out):
        return [(r.status == 200, r.reason) for r in out]

    warm = analysis_requests(QuantumRequest, gw, 64, "warm")
    check(decisions(gw.handle_quantum(warm, 0.0))
          == decisions(replay(warm, 0.0)),
          "analysis: the warm quantum differs from Gateway.handle")
    nxt = ANALYSIS_ENTS
    rows, predicted = [], {"rounds": 0, "walk": 0}
    blocks0 = store.block_uploads
    with assert_no_rebuild(store) as start:
        for j, m in enumerate(ANALYSIS_SIZES):
            now = 0.25 * (j + 1)
            for g in (gw, ref):
                for name in sorted(g.pool.entitlements)[:ANALYSIS_CHURN]:
                    g.pool.remove_entitlement(name, now)
                for k in range(ANALYSIS_CHURN):
                    analysis_add(core, g, nxt + k)
            nxt += ANALYSIS_CHURN
            qs = analysis_requests(QuantumRequest, gw, m, f"a{j}-")
            out = decisions(gw.handle_quantum(qs, now))
            bad = [i for i, (a, b) in enumerate(
                zip(out, decisions(replay(qs, now)))) if a != b]
            check(not bad, f"analysis: quantum of {m} on the card differs "
                  f"from Gateway.handle on the CPU at request {bad[:3]}")
            width = quantum_width(m)
            route = None if m == 1 else (
                "walk" if width < WALK_BELOW else "rounds")
            if route:
                predicted[route] += 1
            rows.append((m, width, route, sum(not a for a, _ in out)))
    launched = start.launched()
    check(launched["admit_quantum"] == predicted,
          f"analysis: admit_quantum launches by route "
          f"{launched['admit_quantum']}, the lengths predict {predicted}")
    check(not any(n for k in ("flash_attention", "paged_attention")
                  for n in launched[k].values()),
          f"analysis: attention launches on the gateway path {launched}")
    check(store.capacity == 512 and len(gw.pool.entitlements)
          == ANALYSIS_ENTS, f"analysis: the churn left {store.capacity} "
          f"rows for {len(gw.pool.entitlements)} entitlements")
    denying = [r for r in rows if r[2] == "rounds" and r[0] >= 256 and r[3]]
    check(bool(denying), f"analysis: no denying rounds quantum of >= 256 "
          f"requests: {rows}")
    loop_s = time.perf_counter() - t1
    print(f"analysis runtime: {len(rows)} gateway quanta on a 4-shard pool "
          f"of {ANALYSIS_ENTS} entitlements (512 rows) on the card, "
          f"{ANALYSIS_CHURN} entitlements out and {ANALYSIS_CHURN} in before "
          f"each; (requests, padded width, route, denied) {rows}; inside "
          f"assert_no_rebuild no kernel built and no whole-mirror upload "
          f"(full uploads {start.full_uploads[0]} before and after, "
          f"{store.block_uploads - blocks0} block uploads); admit_quantum "
          f"launches by route {launched['admit_quantum']} = predicted; "
          f"every admit bit and deny reason equal to the requests replayed "
          f"through Gateway.handle on a CPU pool ({len(denying)} denying "
          f"rounds quanta of >= 256); {loop_s:.2f} s; card {card}")

    # the planted growth must fire the check
    raised = None
    try:
        with assert_no_rebuild(store):
            for k in range(store.capacity - len(gw.pool.entitlements) + 1):
                analysis_add(core, gw, nxt + k)
            gw.handle_quantum(analysis_requests(QuantumRequest, gw, 300,
                                                "grown-"), 9.0)
    except AssertionError as e:
        raised = str(e)
    check(raised is not None and store.capacity == 1024,
          f"analysis: a growth to {store.capacity} rows inside "
          f"assert_no_rebuild did not raise")
    print(f"analysis planted: growth past 512 rows inside assert_no_rebuild "
          f"raised as it must: {raised}")
    return launched["admit_quantum"]


# -- phase 2 -------------------------------------------------------------------
def phase_kernels(torch, seed: int) -> dict:
    """Each kernel, on each of its routes, against its plain version on
    the card.  Returns the max error per kernel in the serve path's type
    (bfloat16) and route."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, reference_attention)
    from repro_torch.kernels.paged_attention import (
        merge_partials, paged_attention, paged_attention_partial,
        reference_paged_attention)
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")

    def took_route(fn):
        """fn's output and the paged routes that counted a launch."""
        before = dict(paged_attention.route_launches)
        out = fn()
        return out, [r for r, n in paged_attention.route_launches.items()
                     if n > before[r]]

    g = torch.Generator(device="cuda").manual_seed(seed)
    worst = {"flash_prefill": 0.0, "paged_decode": 0.0}
    lines = []
    H, Hkv = 32, 8
    # ragged lengths on both sides of the 64-row tiles, a window that
    # starts inside a key tile, a softcap
    flash_cases = [(S, None, None) for S in
                   (1, 3, 37, 63, 64, 65, 128, 130, 300, 512)]
    flash_cases += [(130, 40, None), (300, 64, None), (300, None, 50.0)]
    # (dtype, head width, route asked for, route taken): the tensor-core
    # route at its three widths, the scalar route for float32, for bf16
    # at a width wgmma does not take, and forced at the serve path's
    # width and at dh 256
    routes = [("bfloat16", 128, None, "wgmma"),
              ("bfloat16", 64, None, "wgmma"),
              ("bfloat16", 256, None, "wgmma"),
              ("float32", 128, None, "scalar"),
              ("bfloat16", 96, None, "scalar"),
              ("bfloat16", 128, "scalar", "scalar"),
              ("bfloat16", 256, "scalar", "scalar")]
    for dt, dh, kernel, want in routes:
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
        check(took == [want], f"flash {dt} dh={dh} kernel={kernel}: "
                              f"routes taken {took}, want {want}")
        if (dt, dh, kernel) == ("bfloat16", 128, None):
            worst["flash_prefill"] = max(errs)
        lines.append(f"flash {dt} dh={dh} {took[0]} max|err| "
                     f"{max(errs):.3g} (tol {TOL[dt]}, {len(errs)} cases)")

    B, T, mp, dh = 8, 16, 128, 128
    # contexts on both sides of the 64-token splits, empty to full; one
    # batch of mixed contexts; one where a whole split's pages are -1
    ctx_sets = [[c] * B for c in (0, 1, 63, 64, 65, 128, 2047)]
    ctx_sets.append([0, 1, 63, 64, 65, 128, 2047, 1000])
    ctx_sets.append([300] * B)
    # (q dtype, page dtype, route asked for): every pair on the route
    # route() names, and bf16 at the serve path's G 4 on the split route
    # forced too
    for q_dt, kv_dt, kernel in (("float32", "float32", None),
                                ("bfloat16", "bfloat16", None),
                                ("bfloat16", "bfloat16", "split"),
                                ("float32", "bfloat16", None)):
        qd, kd = getattr(torch, q_dt), getattr(torch, kv_dt)
        want = kernel or pa_mod.route(qd, dh, H // Hkv)
        errs = []
        for i, ctxs in enumerate(ctx_sets):
            q, kp, vp, bt, cl = paged_inputs(torch, g, B, H, Hkv, dh, ctxs,
                                             kd, qd, T, mp)
            if i == len(ctx_sets) - 1:
                bt[:, 4:8] = -1               # tokens 64-127: one split
            out, took = took_route(lambda: paged_attention(
                q, kp, vp, bt, cl, kernel=kernel))
            check(took == [want], f"paged q {q_dt} pages {kv_dt} "
                                  f"kernel={kernel}: routes {took}, want "
                                  f"{want}")
            torch.cuda.synchronize()
            ref = reference_paged_attention(q, kp, vp, bt, cl)
            tol_dt = "bfloat16" if "bfloat16" in (q_dt, kv_dt) else q_dt
            err, ok = max_err(torch, out, ref, tol_dt)
            check(ok, f"paged q {q_dt} pages {kv_dt} ctx={ctxs}: max "
                      f"|err| {err} beyond tolerance {TOL[tol_dt]}")
            zero = [b for b, c in enumerate(ctxs) if c == 0]
            check(not out[zero].float().abs().sum().item(),
                  "paged: context 0 must give zeros")
            errs.append(err)
        if q_dt == kv_dt == "bfloat16" and kernel is None:
            worst["paged_decode"] = max(errs)
        lines.append(f"paged {want} q {q_dt} / pages {kv_dt} max|err| "
                     f"{max(errs):.3g} ({len(errs)} cases)")
    # the group route at the groups and widths it was built for (G 8 at
    # dh 64 and 128, G 10 at dh 256, G 16 at dh 128), on the mixed batch
    # (context 0 among them) and with a whole chunk of -1 pages; then its
    # partial form at G 8 and 10 over two ranks' blocks, with and
    # without a window across them, merged as the ranks merge
    errs = []
    for dh_, h, hkv in ((64, 32, 4), (128, 32, 4), (256, 10, 1),
                        (128, 64, 4)):
        for i, ctxs in enumerate(ctx_sets[-2:]):
            q, kp, vp, bt, cl = paged_inputs(torch, g, B, h, hkv, dh_, ctxs,
                                             torch.bfloat16, T=T, mp=mp)
            if i:
                bt[:, 4:8] = -1
            out, took = took_route(lambda: paged_attention(q, kp, vp, bt,
                                                           cl))
            check(took == ["group"], f"paged bf16 dh={dh_} H={h}/{hkv}: "
                                     f"routes {took}, want group")
            torch.cuda.synchronize()
            ref = reference_paged_attention(q, kp, vp, bt, cl)
            err, ok = max_err(torch, out, ref, "bfloat16")
            check(ok, f"paged group dh={dh_} H={h}/{hkv} ctx={ctxs}: max "
                      f"|err| {err} beyond tolerance {TOL['bfloat16']}")
            zero = [b for b, c in enumerate(ctxs) if c == 0]
            check(not out[zero].float().abs().sum().item(),
                  "paged group: context 0 must give zeros")
            errs.append(err)
    lines.append(f"paged group bf16 G 8/8/10/16 at dh 64/128/256/128 "
                 f"max|err| {max(errs):.3g} ({len(errs)} cases)")
    errs = []
    half = mp // 2 * T                        # positions of a rank's block
    gctx = [0, 1, 63, 64, half - 1, half, half + 65, 2 * half - 1]
    for dh_, h, hkv in ((64, 32, 4), (256, 10, 1)):
        q, kp, vp, bt, cl = paged_inputs(torch, g, B, h, hkv, dh_, gctx,
                                         torch.bfloat16, T=T, mp=mp)
        for window in (None, 700):
            parts = []
            for r in range(2):
                bt_r = bt[:, r * mp // 2:(r + 1) * mp // 2].contiguous()
                koff = torch.full((B,), r * half, dtype=torch.int32,
                                  device="cuda")
                part, took = took_route(lambda: paged_attention_partial(
                    q, kp, vp, bt_r, cl, koff, window=window))
                check(took == ["group_partial"],
                      f"paged partial bf16 dh={dh_} H={h}/{hkv}: routes "
                      f"{took}, want group_partial")
                parts.append(part)
            out = merge_partials(torch.stack([p[0] for p in parts]),
                                 torch.stack([p[1] for p in parts]))
            torch.cuda.synchronize()
            ref = reference_paged_attention(q, kp, vp, bt, cl,
                                            window=window)
            err, ok = max_err(torch, out, ref, "bfloat16")
            check(ok, f"paged group partial dh={dh_} H={h}/{hkv} window "
                      f"{window}, two ranks merged: max |err| {err}")
            check(not out[0].abs().sum().item(),
                  "paged group partial: context 0 must give zeros")
            errs.append(err)
    lines.append(f"paged group_partial bf16 G 8/10 at dh 64/256, two "
                 f"ranks' blocks merged, window none/700 max|err| "
                 f"{max(errs):.3g} ({len(errs)} cases)")
    # the other head widths and group sizes the split kernel takes
    # (the reduced model of the serve phase has dh 16, G 2)
    ctxs = ctx_sets[-2]
    for dt in ("float32", "bfloat16"):
        errs = []
        for dh_, (h, hkv) in ((16, (4, 2)), (32, (8, 1)), (64, (4, 4))):
            q, kp, vp, bt, cl = paged_inputs(torch, g, B, h, hkv, dh_, ctxs,
                                             getattr(torch, dt), T=T, mp=mp)
            out, took = took_route(lambda: paged_attention(q, kp, vp, bt,
                                                           cl))
            check(took == ["split"], f"paged {dt} dh={dh_} H={h}/{hkv}: "
                                     f"routes {took}, want split")
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


def quantum_gateway(core, Gateway, dev: str, telemetry=None):
    """The gateway quantum's fleet (``admission_throughput._bench_gateway``):
    one pool of 512 elastic entitlements, one key each, on ``dev``."""
    pool = core.TokenPool(core.PoolSpec(
        name="p", model="m", scaling=core.ScalingBounds(1, 1),
        per_replica=core.Resources(1e9, 1e15, 1e6)), device=dev)
    gw = Gateway(pool, telemetry=telemetry)
    for i in range(512):
        pool.add_entitlement(core.EntitlementSpec(
            name=f"e{i}", tenant_id=f"t{i}", pool="p",
            qos=core.QoS(core.ServiceClass.ELASTIC, 1000.0),
            baseline=core.Resources(1e6, 0.0, 1e3)))
        gw.register_key(f"k{i}", f"e{i}", pool="p")
    return gw


def quantum_requests(QuantumRequest, tag: str) -> list:
    """The 10,000 requests of one gateway quantum."""
    return [QuantumRequest(f"k{i % 512}", f"{tag}{i}", 64, 64)
            for i in range(10_000)]


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
        # 1. the kernel's routes against the plain version on four draws
        # at the benchmark's size, then on the edge cases, then timed
        n, m = 4096, 65536
        timer = Timer(torch)
        draws, first = [], None
        for label, args, scal in admit_draws(np, torch, seed, n, m):
            out_p = plain(*args, **scal)
            dev_args = on("cuda", args)
            how = aq_mod.route(m)
            out_k = admit_scan(*dev_args, **scal)
            stats = admit_scan.last_stats.tolist()
            torch.cuda.synchronize()
            diff = same(out_k, out_p)
            check(diff == 0, f"quantum: {label}: the {how} kernel and the "
                             f"plain version disagree on {diff} of {m} "
                             f"requests")
            codes = np.bincount(out_p[1].numpy(), minlength=5).tolist()
            if first is None:
                check(all(codes), f"quantum: the draw missed a reason "
                                  f"code: {codes}")
                first = (args, scal, dev_args, codes)
            k_ms = timer.ms(lambda: admit_scan(*dev_args, **scal))
            draws.append({"draw": label, "route": how, "rounds": stats[0],
                          "fallback_at": stats[1], "ms": k_ms,
                          "reasons": codes, "cycles": stats[2:]})
            print(f"quantum draw: {label}, N={n} M={m}, reasons 0-4 "
                  f"{codes}: the {how} kernel identical to the plain "
                  f"version (admit bits, reasons, priority bits); "
                  f"route {how}, rounds {stats[0]}, serial walk from "
                  f"{stats[1]}, SM cycles from the rounds kernel's start "
                  f"to the end of its grouping / its rounds {stats[2]} / "
                  f"{stats[3]}, of the walk kernel {stats[4]} (first "
                  f"launch); {k_ms:.5f} ms ({1e6 * k_ms / m:.2f} ns a "
                  f"request); card {card}")
        args, scal, dev_args, codes = first
        edges = []
        for label, e_args, e_scal in admit_edge_cases(np, torch, seed):
            e_p = plain(*e_args, **e_scal)
            e_dev = on("cuda", e_args)
            for kernel in ("rounds", "walk"):
                e_k = admit_scan(*e_dev, **e_scal, kernel=kernel)
                torch.cuda.synchronize()
                d = same(e_k, e_p)
                check(d == 0, f"quantum: edge case '{label}': the {kernel} "
                              f"kernel and the plain version disagree on "
                              f"{d} requests")
            edges.append(f"{label} {np.bincount(e_p[1].numpy(), minlength=5).tolist()}")
        print("quantum edges: rounds and walk kernels identical to "
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
        # a warm-up quantum and a second one compared between the
        # devices, then two more timed on the card alone
        resp, best = {}, float("inf")
        reset_counts()
        for dev in ("cuda", "cpu"):
            gw = quantum_gateway(core, Gateway, dev)
            resp[dev] = []
            for rep in range(4 if dev == "cuda" else 2):
                qs = quantum_requests(QuantumRequest, f"q{rep}-")
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
        check(gw_routes == {"rounds": 4, "walk": 0},
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
        check(launches == sum(route_counts.values()), f"quantum: the "
              f"experiments' launches by route {route_counts} (of "
              f"{launches})")
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
        "launches_by_route": route_counts,
        "draws": draws,
        "shape": f"N={n} rows, M={m} requests, first draw; plain version "
                 "on the CPU (host clock)",
    }


# -- phase 5: the planner --------------------------------------------------------
def exp3_sim(serving, core, mode: str, device: str):
    """Experiment 3 (``benchmarks/experiment3_autoscale.py::build``, the
    parameters kept here): a guaranteed assistant and an elastic
    analytics tenant on east, spot batch; analytics surges 4x at 20 s,
    east loses two replicas at 30 s (back at 55 s), the surge ends at
    65 s; the fleet planner closes the loop every accounting tick."""
    sc, wl = core.ServiceClass, serving.Workload
    sim = serving.MultiPoolSimulator(
        [wl(name="assist", service_class=sc.GUARANTEED, slots=4,
            slo_ms=500.0, rate_rps=1.0, in_tokens=64, out_tokens=64,
            pools=("east", "west"), max_retries=2),
         wl(name="analytics", service_class=sc.ELASTIC, slots=8,
            slo_ms=2000.0, rate_rps=0.8, in_tokens=64, out_tokens=64,
            pools=("east",), max_retries=2),
         wl(name="batch", service_class=sc.SPOT, slots=4, slo_ms=30000.0,
            rate_rps=0.6, in_tokens=64, out_tokens=64, pools=("east",),
            max_retries=1)],
        sites=[serving.PoolSite("east", n_replicas=2, replica_slots=8,
                                replica_tps=120.0, max_replicas=3),
               serving.PoolSite("west", n_replicas=1, replica_slots=8,
                                replica_tps=120.0, max_replicas=3)],
        autoscale=True, provision_lag_s=3.0, drain_s=2.0,
        planner_config=core.FleetPlannerConfig(
            cooldown_ticks=5, debt_migrate_threshold=0.2,
            starve_persistence_ticks=3, migrate_cooldown_ticks=15),
        admission_mode=mode, device=device)
    sim.at(20.0, "set_rate", workload="analytics", rate=3.2)
    for t, kind in ((30.0, "fail_replica"), (55.0, "recover_replica")):
        for idx in (1, 2):
            sim.at(t, kind, pool="east", idx=idx)
    sim.at(65.0, "set_rate", workload="analytics", rate=0.8)
    return sim


def plan_record(plan) -> tuple:
    """Every decision, scale event and migration of one fleet plan."""
    return (sorted((k, d.current, d.desired, d.reason, d.reserved_tps,
                    d.demand_tps) for k, d in plan.decisions.items()),
            sorted(plan.scale_events.items()),
            sorted(plan.unmet_replicas.items()),
            [dataclasses.astuple(m) for m in plan.migrations],
            [dataclasses.astuple(m) for m in plan.applied],
            [dataclasses.astuple(m) for m in plan.skipped])


def plan_inputs(np, seed: int, P: int) -> dict:
    """[P] seeded ``plan_fleet`` inputs: mixed bounds, replica shapes
    with a missing dimension (infinite need), reserves, demands, a fifth
    of the rows unseeded."""
    r = np.random.RandomState(seed)
    return dict(
        current=r.randint(1, 9, P).astype(np.int32),
        lo=r.randint(1, 3, P).astype(np.int32),
        hi=r.randint(3, 9, P).astype(np.int32),
        per_tps=r.choice([0.0, 120.0, 240.0, 250.0], P).astype(np.float32),
        per_kv=r.choice([0.0, 1e9], P).astype(np.float32),
        per_conc=r.choice([0.0, 4.0, 16.0], P).astype(np.float32),
        res_tps=(r.uniform(0, 960, P) * (r.rand(P) < 0.7)).astype(
            np.float32),
        res_kv=r.choice([0.0, 5e8, 3e9], P).astype(np.float32),
        res_conc=(r.uniform(0, 32, P) * (r.rand(P) < 0.5)).astype(
            np.float32),
        demand_tps=r.uniform(0, 2500, P).astype(np.float32),
        ewma_prev=r.uniform(0, 2500, P).astype(np.float32),
        seeded=r.rand(P) < 0.8,
        low_ticks=r.randint(0, 6, P).astype(np.int32))


def planner_fleet(core, np, seed: int, P: int, dev: str):
    """P pools of one guaranteed or elastic entitlement each on ``dev``,
    and a seeded demand per pool for each of 8 planning rounds."""
    r = np.random.RandomState(seed)
    pools, demand = {}, []
    for i in range(P):
        name = f"p{i:03d}"
        pool = core.TokenPool(core.PoolSpec(
            name=name, model="m",
            scaling=core.ScalingBounds(1, int(r.randint(2, 9))),
            per_replica=core.Resources(240.0, 0.0, 16.0)), device=dev)
        pool.add_entitlement(core.EntitlementSpec(
            name=f"e{i}", tenant_id="t", pool=name,
            qos=core.QoS(core.ServiceClass.ELASTIC if i % 2
                         else core.ServiceClass.GUARANTEED, 1000.0),
            baseline=core.Resources(float(r.uniform(0, 960)), 0.0,
                                    float(r.randint(0, 32)))))
        pools[name] = pool
    for _ in range(8):
        demand.append({name: float(r.uniform(0, 2500)) for name in pools})
    return pools, demand


def phase_planner(torch, np, seed: int, card: str) -> dict:
    """The fleet planner, the closed loop, telemetry and the chaos
    library on the card, each against the same on the CPU (see the
    module docstring).  Returns the ``admit_quantum`` launches by route
    of each part, for the kernel report."""
    import repro_torch.core as core
    import repro_torch.serving as serving
    from repro_torch import chaos
    from repro_torch.core.fleet import plan_fleet
    from repro_torch.gateway import Gateway, QuantumRequest
    gw_mod = importlib.import_module("repro_torch.gateway.gateway")
    aq_mod = importlib.import_module(
        "repro_torch.kernels.admit_quantum.admit_quantum")
    admit_scan = aq_mod.admit_scan

    def reset_counts():
        admit_scan.launches = 0
        for k in admit_scan.route_launches:
            admit_scan.route_launches[k] = 0

    def read_counts(what: str) -> dict:
        routes = dict(admit_scan.route_launches)
        check(admit_scan.launches == sum(routes.values()), f"planner: "
              f"{what}: admit_quantum launches by route {routes} (of "
              f"{admit_scan.launches})")
        return routes

    # 1. plan_fleet on the card against the CPU, then one
    # FleetPlanner.plan (gather, one copy each way, the plan) timed on
    # each device
    cfg = core.FleetPlannerConfig(demand_ewma=0.7, cooldown_ticks=3)
    rows = []
    for P in (8, 64, 512):
        a = plan_inputs(np, seed + P, P)
        outs = {dev: [x.cpu().numpy() for x in plan_fleet(
            **{k: torch.from_numpy(v).to(dev) for k, v in a.items()},
            config=cfg)] for dev in ("cuda", "cpu")}
        g, c = outs["cuda"], outs["cpu"]
        for i, name in ((0, "desired"), (1, "reason"), (3, "low ticks")):
            check(np.array_equal(g[i], c[i]), f"planner: plan_fleet {name} "
                  f"differ between cuda and cpu at P={P}")
        ewma_ulps, need_ulps = ulps(np, g[2], c[2]), ulps(np, g[4], c[4])
        check(ewma_ulps == 0, f"planner: plan_fleet EWMA {ewma_ulps} ulps "
                              f"from the CPU's at P={P}")
        # the need is one correctly rounded division on both devices
        check(need_ulps == 0, f"planner: plan_fleet need {need_ulps} ulps "
                              f"from the CPU's at P={P}")
        wall, plans = {}, {}
        for dev in ("cuda", "cpu"):
            pools, demand = planner_fleet(core, np, seed + P, P, dev)
            planner = core.FleetPlanner(cfg)
            times, plans[dev] = [], []
            for t, d in enumerate(demand, start=1):
                records = {n: core.TickRecord(
                    t=float(t), capacity_tps=0.0, allocations={},
                    priorities={}, debts={}, bursts={}, in_flight={},
                    demand_tps={f"e{int(n[1:])}": v}) for n, v in d.items()}
                s = time.perf_counter()
                plan = planner.plan(pools, records, float(t))
                times.append(time.perf_counter() - s)
                plans[dev].append(plan_record(plan))
                for n, dec in plan.decisions.items():
                    pools[n].set_replicas(dec.desired)
            wall[dev] = 1e3 * float(np.median(times[1:]))
        check(plans["cuda"] == plans["cpu"], f"planner: FleetPlanner plans "
              f"differ between a CUDA fleet and a CPU fleet at P={P}")
        reasons = np.bincount(c[1], minlength=5).tolist()
        rows.append(f"P={P}: decisions and reasons {reasons} identical, "
                    f"EWMA 0 ulps, need {need_ulps} ulps; one "
                    f"FleetPlanner.plan {wall['cuda']:.3f} ms on the card, "
                    f"{wall['cpu']:.3f} ms on the CPU")
    print("planner plan_fleet: demand_ewma 0.7, cuda vs cpu; wall ms of "
          "one plan (median of 7 after a first, host clock: gather, one "
          "copy each way, the plan, 8 rounds of identical plans on both "
          f"devices): " + "; ".join(rows) + f"; card {card}")

    # a plain version reached with CUDA tensors would be a silent
    # fallback: count such calls for the rest of the phase
    plain_on_cuda = [0]
    plain = aq_mod.reference_admit_scan

    def guarded(*a, **kw):
        plain_on_cuda[0] += int(a[8].is_cuda)
        return plain(*a, **kw)

    kernel_denials = [0]
    admit = gw_mod.admit_quantum

    def counted(*a, **kw):
        out = admit(*a, **kw)
        kernel_denials[0] += int(((~out[0]) & kw["req_live"]).sum())
        return out

    aq_mod.reference_admit_scan = guarded
    launches = {}
    try:
        # 2. Experiment 3, quantum and scalar admission, on the card and
        # the CPU
        recs = {}
        for mode in ("quantum", "scalar"):
            for dev in ("cuda", "cpu"):
                reset_counts()
                sim = exp3_sim(serving, core, mode, dev)
                t = time.perf_counter()
                res = sim.run(90.0)
                secs = time.perf_counter() - t
                if dev == "cuda" and mode == "quantum":
                    launches["exp3"] = read_counts("exp3")
                rec = (sim_record(sim), res["replica_timeline"],
                       [(t, plan_record(p)) for t, p in sim.plans],
                       [dataclasses.astuple(m) for m in res["migrations"]])
                recs[mode, dev] = (rec, secs, sim, res)
        for mode in ("quantum", "scalar"):
            check(recs[mode, "cuda"][0] == recs[mode, "cpu"][0],
                  f"planner: exp3 ({mode}) differs between cuda and cpu "
                  "(requests, ticks, replica timeline, plans or "
                  "migrations)")
        check(sum(launches["exp3"].values()) > 0,
              "planner: admit_quantum never launched on exp3's card run")
        sim, res = recs["quantum", "cuda"][2:]
        east = res["replica_timeline"]["east"]
        reasons: dict = {}
        for _, plan in sim.plans:
            for d in plan.decisions.values():
                reasons[d.reason] = reasons.get(d.reason, 0) + 1
        east_ups = [t for t, p in sim.plans
                    if p.decisions["east"].reason == "scale_up:demand"]
        east_downs = [t for t, p in sim.plans
                      if p.decisions["east"].reason == "scale_down"]
        migs = res["migrations"]
        after = [n for t, n in east if t >= 55.0]
        p99 = {}
        for label, t0, t1 in (("before", 5.0, 20.0), ("surge", 20.0, 30.0),
                              ("outage", 30.0, 55.0), ("after", 70.0, 90.0)):
            e2e = [r.e2e for r in sim.requests.values()
                   if r.entitlement == "assist" and r.e2e is not None
                   and t0 <= r.arrival_s < t1]
            p99[label] = float(np.percentile(e2e, 99)) if e2e else \
                float("nan")
        # the claims as ``experiment3_autoscale`` checks them
        check(east_ups and any(n >= 3 for t, n in east
                               if 20.0 <= t < 30.0),
              "planner: exp3 C1: east was not scaled up through the surge")
        check(len(migs) >= 1 and migs[0].debt > 0.0,
              f"planner: exp3 C2: no migration with carried debt: {migs}")
        check(after == sorted(after, reverse=True) and east[-1][1] == 2,
              f"planner: exp3 C4: east did not drain to 2 without "
              f"flapping after its recovery: {after}")
        wall = {(mode, dev): recs[mode, dev][1] for mode, dev in recs}
        print(f"planner exp3: requests, tick records, replica timelines, "
              f"{len(sim.plans)} plans and the migrations identical on "
              f"cuda and cpu in quantum and scalar admission; "
              f"{len(sim.requests)} requests; admit_quantum launches on the "
              f"card's quantum run by route {launches['exp3']}; wall cuda / "
              f"cpu: quantum {wall['quantum', 'cuda']:.2f} / "
              f"{wall['quantum', 'cpu']:.2f} s, scalar "
              f"{wall['scalar', 'cuda']:.2f} / {wall['scalar', 'cpu']:.2f} "
              f"s; card {card}")
        print(f"planner claim C1: east at 3 replicas through the surge "
              f"(20-30 s); east's scale_up:demand plans {len(east_ups)}, "
              f"the first at {east_ups[0]:.2f} s; scale reasons of all "
              f"plans {reasons}; card {card}")
        m = migs[0]
        print(f"planner claim C2: migrated {m.entitlement} {m.src}->{m.dst} "
              f"({m.reason}), debt {m.debt:.4f} carried; west peak "
              f"{max(n for _, n in res['replica_timeline']['west'])}; card "
              f"{card}")
        print("planner claim C3: assist P99 e2e by window (before / surge / "
              "outage / after) " + " / ".join(
                  f"{p99[k]:.3f}" for k in ("before", "surge", "outage",
                                            "after")) + f" s; card {card}")
        print(f"planner claim C4: east from its recovery at 55 s "
              f"{after[:6]} ..., final {east[-1][1]}, never rising; "
              f"scale_down at {[round(t, 2) for t in east_downs]} s; card "
              f"{card}")

        # 3. the 10,000-request gateway quantum with telemetry off and on
        # (turns, best of 3 after a warm-up), and explain() against the
        # CPU's
        reset_counts()
        gws = {tel: quantum_gateway(core, Gateway, "cuda", telemetry=tel)
               for tel in (None, True)}
        best = {None: float("inf"), True: float("inf")}
        for rep in range(4):
            for tel, gw in gws.items():
                qs = quantum_requests(QuantumRequest, f"t{rep}-")
                t = time.perf_counter()
                gw.handle_quantum(qs, 0.0)
                if rep:
                    best[tel] = min(best[tel], time.perf_counter() - t)
        launches["telemetry"] = read_counts("telemetry")
        cpu_gw = quantum_gateway(core, Gateway, "cpu", telemetry=True)
        for rep in range(4):
            cpu_gw.handle_quantum(quantum_requests(QuantumRequest,
                                                   f"t{rep}-"), 0.0)
        sample = [f"t{rep}-{i}" for rep in range(4)
                  for i in range(0, 10_000, 97)]

        def explained(gw, rid):
            tr = gw.telemetry.flight.explain(rid)
            return (tr.status, tr.reason, tr.pool, tr.spill_hops,
                    [dataclasses.astuple(r) for r in tr.legs])

        bad = [rid for rid in sample
               if explained(gws[True], rid) != explained(cpu_gw, rid)]
        check(not bad, f"planner: explain() differs between the card and "
                       f"the CPU for {len(bad)} of {len(sample)} requests, "
                       f"first {bad[:1]}")
        off, on = 10_000 / best[None], 10_000 / best[True]
        print(f"planner telemetry: handle_quantum of 10,000 requests on the "
              f"card, {off:.0f} decisions/s with telemetry off, {on:.0f} "
              f"with it on ({100 * (off / on - 1):+.1f} % time; best of 3 "
              f"after a warm-up, in turns, host clock); explain() of "
              f"{len(sample)} sampled requests identical to the CPU run's; "
              f"{len(gws[True].telemetry.flight)} flight rows; launches by "
              f"route {launches['telemetry']}; card {card}")

        # 4. the chaos library: every checker, and the three-mode replay,
        # on the card and on the CPU
        gw_mod.admit_quantum = counted
        reset_counts()
        lines = []
        for sc in chaos.SCENARIOS:
            row = {}
            for dev in ("cuda", "cpu"):
                kernel_denials[0] = 0
                t = time.perf_counter()
                rep = chaos.run_scenario(sc, device=dev)
                run_s = time.perf_counter() - t
                check(rep["passed"], f"planner: chaos {sc.name} on {dev}: "
                      f"{rep['violations'][:3]}")
                t = time.perf_counter()
                res = chaos.run_replay(sc, device=dev)
                replay_s = time.perf_counter() - t
                check(res.identical, f"planner: chaos {sc.name} on {dev}: "
                      f"the three modes differ: {res.mismatches[:3]}")
                traces = {label: (
                    {rid: dataclasses.astuple(o)
                     for rid, o in tr.outcomes.items()},
                    tr.flight_legs, tr.flight_priority)
                    for label, tr in res.traces.items()}
                row[dev] = (traces, run_s, replay_s, kernel_denials[0],
                            len(rep["checkers"]))
            check(row["cuda"][0] == row["cpu"][0], f"planner: chaos "
                  f"{sc.name}: the card's traces differ from the CPU's")
            denied = sum(o[2] == "denied" for o in
                         row["cuda"][0]["quantum_fast"][0].values())
            lines.append(
                f"{sc.name} {row['cuda'][1]:.2f}+{row['cuda'][2]:.2f} / "
                f"{row['cpu'][1]:.2f}+{row['cpu'][2]:.2f} s, "
                f"{row['cuda'][3]} kernel denials, {denied} of "
                f"{len(row['cuda'][0]['quantum_fast'][0])} requests denied")
        launches["chaos"] = read_counts("chaos")
        check(sum(launches["chaos"].values()) > 0,
              "planner: admit_quantum never launched on the chaos runs")
        check(not plain_on_cuda[0], f"planner: the plain version was called "
              f"on CUDA tensors {plain_on_cuda[0]} times")
    finally:
        aq_mod.reference_admit_scan = plain
        gw_mod.admit_quantum = admit
    print(f"planner chaos: {len(chaos.SCENARIOS)} scenarios, each with "
          f"every checker ({row['cuda'][4]}, mirror-coherence included): 0 "
          f"violations on cuda and cpu; three-mode replays identical, and "
          f"the card's traces identical to the CPU's; per scenario wall "
          f"s cuda (run + replay) / cpu (run + replay), admit_quantum "
          f"denials decided by the kernel on the card (run and both "
          f"quantum modes of the replay): " + "; ".join(lines)
          + f"; launches by route {launches['chaos']}; card {card}")
    return launches


# -- phase 6: the sharded control plane --------------------------------------------
#: ``benchmarks/shard_scale.py``'s cells: its FULL_ROWS by its DEVICES
SHARD_ROWS = (1_048_576, 4_194_304, 16_777_216)
SHARD_SIZES = (1, 2, 4, 8)
#: the sharded admission quantum: requests, rows, mesh sizes
SHARD_ADMIT = (65_536, 16_777_216, (1, 2, 4))
#: the sharded fleet plan: pools, mesh sizes
SHARD_PLAN = (512, (2, 4))
#: a launch of ranks that has not finished by then counts as a hang
RANK_TIMEOUT_S = 480.0


def same_bits(torch, a, b) -> bool:
    """Equal shapes and equal words (floats as raw bits)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def same_words(np, xs, ys) -> bool:
    """Host arrays pairwise equal in dtype, shape and every word (floats
    as raw bits)."""
    def words(x):
        return x.view(np.int32) if x.dtype == np.float32 else x
    return len(xs) == len(ys) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and np.array_equal(words(x), words(y)) for x, y in zip(xs, ys))


def row_slice(state, lo: int, hi: int, dev: str):
    """Rows [lo, hi) of a ``ControlState``, contiguous, on ``dev``."""
    return type(state)(**{
        f.name: getattr(state, f.name)[lo:hi].to(dev, copy=True)
        for f in dataclasses.fields(state)})


def shard_tick_inputs(torch, seed: int, n: int):
    """``benchmarks/shard_scale.py``'s worker inputs at ``n`` rows, drawn
    on the card from ``seed`` (the same draw on every rank): bound rows
    of random class, baselines, SLOs, EWMAs, measured use and demand;
    capacity 25 tokens/s a row, ℓ̄* 10 s."""
    from repro_torch.core.control_plane import ControlState
    g = torch.Generator(device="cuda").manual_seed(seed)

    def u(lo, hi):
        return torch.rand(n, generator=g, device="cuda") * (hi - lo) + lo

    def ri(hi):
        return torch.randint(0, hi, (n,), generator=g, device="cuda",
                             dtype=torch.int32)

    zeros = torch.zeros(n, device="cuda")
    state = ControlState(
        class_code=ri(5), bound=torch.ones(n, dtype=torch.bool,
                                           device="cuda"),
        baseline_tps=u(10, 100), baseline_kv=zeros,
        baseline_conc=torch.full((n,), 8.0, device="cuda"),
        slo_ms=u(100, 30000), burst=u(0, 0.5), debt=u(-0.1, 0.5))
    cols = (u(0, 120), zeros, ri(8).float(), u(0, 200))
    return (state, cols, torch.tensor(25.0 * n, device="cuda"),
            torch.tensor(10_000.0, device="cuda"))


def shard_admit_inputs(np, torch, seed: int, n: int, m: int):
    """The ``quantum`` phase's draw (a) at ``n`` rows and ``m``
    requests, in ``vectorized.admit_quantum``'s form, on the CPU:
    (state, row columns with the Eq. 1 weights, requests, scalars)."""
    from repro_torch.core.control_plane import ControlState
    args, scal = admit_case(np, torch, np.random.RandomState(seed), n, m)
    code, bound, bkv, bconc, w, level, infl, kvu = args[:8]
    zeros = torch.zeros(n)
    state = ControlState(class_code=code, bound=bound, baseline_tps=zeros,
                         baseline_kv=bkv, baseline_conc=bconc,
                         slo_ms=torch.ones(n), burst=zeros, debt=zeros)
    rows = dict(bucket_level=level, in_flight=infl, kv_in_use=kvu,
                weights=w)
    reqs = dict(zip(("req_ent", "req_tokens", "req_kv", "req_live"),
                    args[8:]))
    kw = dict(pool_in_flight=int(scal["pool_in_flight"]),
              pool_conc_cap=float(scal["pool_conc_cap"]),
              running_min_priority=float(scal["running_min"]),
              pool_avg_slo=1000.0, pool_resident=int(scal["pool_resident"]),
              slack=0.0)
    return state, rows, reqs, kw


def shard_pool(core, shards, dev: str, n_ents: int = 37):
    """A pool of ``n_ents`` entitlements of four classes on ``dev``
    (flat store, or the sharded one with ``shards``)."""
    pool = core.TokenPool(core.PoolSpec(
        name="p", model="m", shards=shards,
        scaling=core.ScalingBounds(1, 1),
        per_replica=core.Resources(2000.0, float(1 << 40), 64.0)),
        device=dev)
    classes = (core.ServiceClass.GUARANTEED, core.ServiceClass.DEDICATED,
               core.ServiceClass.ELASTIC, core.ServiceClass.SPOT)
    for i in range(n_ents):
        pool.add_entitlement(core.EntitlementSpec(
            name=f"e{i}", tenant_id=f"t{i}", pool="p",
            qos=core.QoS(service_class=classes[i % 4],
                         slo_target_ms=100.0 + 10 * (i % 64)),
            baseline=core.Resources(20.0 + i % 97, float(1 << 20), 4.0)))
    return pool


def shard_pool_drive(shards, dev: str) -> tuple:
    """Three ticks, then one 100-request ``handle_quantum``: the pool's
    columns name for name and the responses."""
    import repro_torch.core as core
    from repro_torch.gateway import Gateway, QuantumRequest
    pool = shard_pool(core, shards, dev)
    for t in (1.0, 2.0, 3.0):
        pool.tick(t)
    gw = Gateway(pool)
    for i in range(37):
        gw.register_route(f"k{i}", [("p", f"e{i}")])
    out = gw.handle_quantum(
        [QuantumRequest(api_key=f"k{i % 37}", request_id=f"r{i}",
                        input_tokens=50, max_tokens=64 + 8 * (i % 5))
         for i in range(100)], now=3.5)
    c = pool.store.col
    cols = {name: tuple(c[k][slot].item() for k in (
        "burst", "debt", "eff_tps", "bucket_level", "in_flight",
        "admitted_total", "denied_total"))
        for name, slot in sorted(pool.store.slot_of.items())}
    return cols, [(r.request_id, r.status, r.reason, r.priority)
                  for r in out]


def shard_rank(seed: int, rows: tuple, admit: bool, plan: bool,
               pool: bool) -> dict:
    """One rank of a ``shard`` phase launch; every rank uses the one
    card.  Tick cells: this rank's block through ``shard_tick`` (one
    warm-up, then 10 ticks on the host clock, each ending in a
    synchronise), held bit for bit against the flat ``control_tick`` of
    all rows on the card; then, as asked, the sharded admission quantum
    (kernel launches counted by route around it), the sharded fleet
    plan against ``plan_fleet``, and a sharded pool against a flat one."""
    import numpy as np
    import torch
    from repro_torch.core import control_plane as cp
    from repro_torch.core import shard_plane as sp
    from repro_torch.core import vectorized as vz
    mesh = sp.row_mesh()
    out = {"mesh": (mesh.size, mesh.rank), "cells": []}
    names = [f.name for f in dataclasses.fields(cp.ControlState)]
    for n in rows:
        state, cols, cap, slo = shard_tick_inputs(torch, seed, n)
        lo, hi = mesh.block(n)
        blk = row_slice(state, lo, hi, "cuda")
        bcols = [c[lo:hi].clone() for c in cols]
        got = sp.shard_tick(blk, cap, *bcols, slo, mesh=mesh)
        times, combines = [], []
        for _ in range(10):
            torch.cuda.synchronize()
            c0, t = mesh.combines, time.perf_counter()
            sp.shard_tick(blk, cap, *bcols, slo, mesh=mesh)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t))
            combines.append(mesh.combines - c0)
        ref = cp.control_tick(state, cap, *cols, slo)
        equal = all(same_bits(torch, getattr(got[0], k),
                              getattr(ref[0], k)[lo:hi]) for k in names)
        equal &= all(same_bits(torch, g, r[lo:hi])
                     for g, r in zip(got[1:], ref[1:]))
        cell = dict(rows=n, rows_per_rank=hi - lo, equal=equal, ms=times,
                    combines=combines)
        if mesh.size == 1:              # the flat tick, for scale
            flat = []
            for _ in range(10):
                torch.cuda.synchronize()
                t = time.perf_counter()
                cp.control_tick(state, cap, *cols, slo)
                torch.cuda.synchronize()
                flat.append(1e3 * (time.perf_counter() - t))
            cell["flat_ms"] = flat
        out["cells"].append(cell)
        del state, cols, blk, bcols, got, ref
        torch.cuda.empty_cache()
    if admit:
        m, n, _ = SHARD_ADMIT
        state, rws, reqs, kw = shard_admit_inputs(np, torch, seed, n, m)
        lo, hi = mesh.block(n)
        blk = row_slice(state, lo, hi, "cuda")
        brows = {k: v[lo:hi].cuda() for k, v in rws.items()}
        creqs = {k: v.cuda() for k, v in reqs.items()}
        aq_mod = importlib.import_module(
            "repro_torch.kernels.admit_quantum.admit_quantum")
        scan, plain = aq_mod.admit_scan, aq_mod.reference_admit_scan
        plain_on_cuda = [0]

        def guarded(*a, **k):
            plain_on_cuda[0] += int(a[8].is_cuda)
            return plain(*a, **k)

        aq_mod.reference_admit_scan = guarded
        try:
            def run():
                return sp.shard_admit_quantum(blk, **brows, **creqs, **kw,
                                              mesh=mesh)
            scan.launches = 0
            for k in scan.route_launches:
                scan.route_launches[k] = 0
            dec = run()
            launches = dict(scan.route_launches, total=scan.launches,
                            plain_on_cuda=plain_on_cuda[0])
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t = time.perf_counter()
                run()
                torch.cuda.synchronize()
                times.append(1e3 * (time.perf_counter() - t))
        finally:
            aq_mod.reference_admit_scan = plain
        out["admit"] = dict(decisions=[x.cpu().numpy() for x in dec],
                            launches=launches, ms=times)
        del blk, brows, creqs
        torch.cuda.empty_cache()
    if plan:
        import repro_torch.core as core
        from repro_torch.core.fleet import plan_fleet
        p = SHARD_PLAN[0]
        cfg = core.FleetPlannerConfig(demand_ewma=0.7, cooldown_ticks=3)
        args = [torch.from_numpy(v).cuda() for v in
                plan_inputs(np, seed + p, p).values()]
        lo, hi = mesh.block(p)
        got = sp.gather_rows(mesh, *sp.shard_plan_fleet(
            *(a[lo:hi] for a in args), config=cfg, mesh=mesh))
        ref = [x.cpu().numpy() for x in plan_fleet(*args, config=cfg)]
        out["plan"] = same_words(np, got, ref)
    if pool:
        flat = shard_pool_drive(None, "cuda")
        c0 = mesh.combines
        sharded = shard_pool_drive(4, "cuda")
        import repro_torch.core as core
        out["pool"] = dict(
            equal=flat == sharded, combines=mesh.combines - c0,
            mesh=sp.pool_mesh(shard_pool(core, 4, "cuda")) is mesh)
    return out


def phase_shard(torch, np, seed: int, card: str) -> dict:
    """The sharded control plane on the card (see the module
    docstring).  Returns the sharded admission replay's
    ``admit_quantum`` launches by route, summed over its ranks."""
    import repro_torch.core as core
    from repro_torch import chaos
    from repro_torch.core import shard_plane as sp
    from repro_torch.core import vectorized as vz
    torch.cuda.empty_cache()
    m, n_admit, admit_sizes = SHARD_ADMIT
    runs = {}
    for size in SHARD_SIZES:
        t = time.perf_counter()
        runs[size] = sp.launch_ranks(
            shard_rank, size, seed, SHARD_ROWS, size in admit_sizes,
            size in SHARD_PLAN[1], size == 2, timeout=RANK_TIMEOUT_S)
        check([r["mesh"] for r in runs[size]]
              == [(size, k) for k in range(size)],
              f"shard: the ranks of a launch of {size} did not form one "
              f"mesh: {[r['mesh'] for r in runs[size]]}")
        print(f"shard launch: {size} ranks on the one card, "
              f"{time.perf_counter() - t:.1f} s (start, every cell, "
              "stop)")

    # 1. the tick cells
    lines = []
    for size in SHARD_SIZES:
        for k, n in enumerate(SHARD_ROWS):
            cells = [r["cells"][k] for r in runs[size]]
            check(all(c["equal"] for c in cells), f"shard: shard_tick at "
                  f"{n} rows on {size} ranks differs from control_tick "
                  "(state, allocations or weights)")
            c0 = cells[0]
            check(len(set(c0["combines"])) == 1,
                  f"shard: combines a tick vary: {c0['combines']}")
            flat = (f", flat control_tick {np.median(c0['flat_ms']):.3f} ms"
                    if "flat_ms" in c0 else "")
            lines.append(f"{n} rows x {size}: {np.median(c0['ms']):.3f} ms "
                         f"a tick on rank 0, {c0['combines'][0]} combines a "
                         f"tick, {c0['rows_per_rank']} rows a rank{flat}")
    print("shard tick: shard_tick == control_tick bit for bit (state, "
          "allocations, weights) in every cell; median of 10 ticks, host "
          "clock, each ending in a synchronise; the ranks share one card, "
          "so these times measure the collectives' overhead, not a "
          "speed-up from sharding: " + "; ".join(lines) + f"; card {card}")

    # 2. the sharded admission quantum against the flat kernel and the
    # plain version
    state, rows, reqs, kw = shard_admit_inputs(np, torch, seed, n_admit, m)
    plain = [x.numpy() for x in vz.admit_quantum(state, **rows, **reqs,
                                                 **kw)]
    cstate = row_slice(state, 0, n_admit, "cuda")
    crows = {k: v.cuda() for k, v in rows.items()}
    creqs = {k: v.cuda() for k, v in reqs.items()}
    flat = [x.cpu().numpy() for x in vz.admit_quantum(cstate, **crows,
                                                      **creqs, **kw)]
    flat_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        vz.admit_quantum(cstate, **crows, **creqs, **kw)
        torch.cuda.synchronize()
        flat_ms.append(1e3 * (time.perf_counter() - t))
    del cstate, crows, creqs

    check(same_words(np, flat, plain), "shard: the flat admit_quantum kernel differs "
          "from its plain version on the sharded quantum's draw")
    launches = {"rounds": 0, "walk": 0}
    rows_out = []
    for size in admit_sizes:
        for r, res in enumerate(runs[size]):
            a = res["admit"]
            check(same_words(np, a["decisions"], flat), f"shard: shard_admit_quantum "
                  f"on {size} ranks (rank {r}) differs from admit_quantum")
            lc = a["launches"]
            check(lc["rounds"] == 1 and lc["total"] == 1
                  and lc["plain_on_cuda"] == 0, f"shard: the replay on "
                  f"{size} ranks (rank {r}) launched {lc}, not one rounds "
                  "kernel")
            for k in launches:
                launches[k] += lc[k]
        rows_out.append(f"{size} ranks {np.median(runs[size][0]['admit']['ms']):.3f} ms")
    admitted = int(flat[0].sum())
    reasons = np.bincount(flat[1], minlength=5).tolist()
    print(f"shard admit: {m} requests over {n_admit} rows (draw (a)): "
          f"admit bits, reasons {reasons} ({admitted} admitted) and "
          f"priorities of shard_admit_quantum identical to the flat "
          f"kernel's and the plain version's at 1, 2 and 4 ranks; each "
          f"rank's replay one launch of the rounds route, no "
          f"plain call on CUDA tensors; rank 0's ms (median of 5, host "
          f"clock): " + ", ".join(rows_out) + f"; flat kernel "
          f"{np.median(flat_ms):.3f} ms; launches {launches}; card {card}")

    # 3. the sharded fleet plan
    for size in SHARD_PLAN[1]:
        check(all(r["plan"] for r in runs[size]), f"shard: "
              f"shard_plan_fleet on {size} ranks differs from plan_fleet")
    print(f"shard plan: shard_plan_fleet == plan_fleet bit for bit at "
          f"{SHARD_PLAN[0]} pools on {' and '.join(map(str, SHARD_PLAN[1]))} "
          "ranks")

    # 4. pools: two ranks, then one process
    for r, res in enumerate(runs[2]):
        check(res["pool"]["mesh"], f"shard: rank {r}: pool_mesh of a "
              "shards=4 pool is not the 2-rank mesh")
        check(res["pool"]["equal"], f"shard: rank {r}: the 2-rank sharded "
              "pool differs from the flat pool (columns or responses)")
    flat_run, sharded_run = (shard_pool_drive(s, "cuda") for s in (None, 4))
    check(flat_run == sharded_run, "shard: a shards=4 pool differs from a "
          "flat pool on the card (columns or responses)")
    admitted = sum(s == 200 for _, s, _, _ in flat_run[1])

    big, pools = {}, {}
    for shards in (None, 8):
        pool = pools[shards] = shard_pool(core, shards, "cuda", n_ents=65_536)
        pool.tick(1.0)
        st = pool.store
        r0 = st.uploaded_rows
        pool.remove_entitlement("e100", now=1.5)
        st.device_state()
        r1 = st.uploaded_rows
        pool.add_entitlement(core.EntitlementSpec(
            name="e100b", tenant_id="t", pool="p",
            qos=core.QoS(service_class=core.ServiceClass.ELASTIC,
                         slo_target_ms=500.0),
            baseline=core.Resources(25.0, float(1 << 20), 4.0)))
        st.device_state()
        big[shards] = [r1 - r0, st.uploaded_rows - r1, [], st.capacity]
    for k in range(12):             # in turns: flat, sharded, sharded, flat
        for shards in ((None, 8) if k % 2 == 0 else (8, None)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pools[shards].tick(2.0 + k)
            big[shards][2].append(1e3 * (time.perf_counter() - t))
    for shards in (None, 8):
        big[shards][2] = float(np.median(big[shards][2][2:]))
    del pools
    check(big[8][0] == big[8][1] == big[8][3] // 8,
          f"shard: one detach/attach re-uploaded {big[8][:2]} rows of a "
          f"shards=8 store, not one block of {big[8][3] // 8}")
    print(f"shard pool: 2 ranks (pool_mesh non-None) and one process: "
          f"shards=4 pool == flat pool, 3 ticks and a 100-request "
          f"handle_quantum ({admitted} admitted) name for name; "
          f"65,536 entitlements, rows re-uploaded by one detach / one "
          f"attach and tick ms (median of 10 taken in turns, host clock, "
          f"a tick includes the host fold and absorb): flat {big[None][0]} / "
          f"{big[None][1]}, {big[None][2]:.3f} ms; shards=8 {big[8][0]} / "
          f"{big[8][1]}, {big[8][2]:.3f} ms; card {card}")

    # 5. the churn-and-migration scenario over sharded stores
    sc = chaos.by_name("churn_migration")
    sc = dataclasses.replace(sc, sites=tuple(
        {**dict(s), "shards": 4} for s in sc.sites))
    traces = {}
    for dev in ("cuda", "cpu"):
        rep = chaos.run_scenario(sc, device=dev)
        check(rep["passed"], f"shard: sharded churn_migration on {dev}: "
              f"{rep['violations'][:3]}")
        sim = chaos.build_sim(sc, "quantum", True, device=dev)
        check(all(isinstance(p.store, core.ShardedResidentStore)
                  for p in sim.manager.pools.values()),
              "shard: the scenario's stores are not sharded")
        sim.run(sc.duration_s)
        tr = chaos.capture_trace(sim, "quantum_fast")
        traces[dev] = ({rid: dataclasses.astuple(o)
                        for rid, o in tr.outcomes.items()},
                       tr.flight_legs, tr.flight_priority)
    check(traces["cuda"] == traces["cpu"], "shard: the sharded "
          "churn_migration trace on the card differs from the CPU's")
    print(f"shard chaos: churn_migration with shards=4 on every site: 0 "
          f"violations under {len(rep['checkers'])} checkers on cuda and "
          f"cpu, {len(traces['cuda'][0])} requests, the card's trace "
          f"identical to the CPU's")
    return launches


# -- phase 7 -------------------------------------------------------------------
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


def guard_plain(fa_mod, pa_mod, plain_on_cuda: dict):
    """Count the plain versions' calls on CUDA tensors in
    ``plain_on_cuda`` (a silent fallback); returns the originals, to
    put back."""
    saved = (fa_mod.reference_attention, pa_mod.reference_paged_attention)

    def guard(fn, key):
        def wrapped(q, *a, **kw):
            plain_on_cuda[key] += int(q.is_cuda)
            return fn(q, *a, **kw)
        return wrapped

    fa_mod.reference_attention = guard(saved[0], "flash")
    pa_mod.reference_paged_attention = guard(saved[1], "paged")
    return saved


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
        out = engine_prefill(*a, **kw)
        torch.cuda.synchronize()
        prefill_ms.append((a[1].shape[1], 1e3 * (time.perf_counter() - t)))
        return out

    # a plain version reached with CUDA tensors would be a silent
    # fallback: count such calls on the serve path
    plain_on_cuda = {"flash": 0, "paged": 0}
    saved = guard_plain(fa_mod, pa_mod, plain_on_cuda)
    try:
        pool, gw = build_gateway(cfg, slots, max_tokens, "cuda")
        eng = serving.InferenceEngine(
            model, params, slots=slots, max_seq=max_seq, gateway=gw,
            page_tokens=page)
        # the engine's prefills timed and its decode steps counted, on
        # top of its graphs
        decode_calls = [0]
        engine_prefill = eng.model.prefill
        graph_decode = eng.model.decode_step

        def counted_decode(*a, **kw):
            decode_calls[0] += 1
            return graph_decode(*a, **kw)
        eng.model = dataclasses.replace(eng.model, prefill=timed_prefill,
                                        decode_step=counted_decode)
        spec = workload(np, seed, n_requests, cfg.vocab_size)
        torch.cuda.reset_peak_memory_stats()
        for fn in (fa_mod.flash_attention, pa_mod.paged_attention):
            fn.launches = 0
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        t = time.perf_counter()
        reqs = drive(torch, eng, pool, serving, spec, max_tokens)
        wall = time.perf_counter() - t
        pkey = paged_key(pa_mod, torch, cfg.head_dim,
                         cfg.num_heads // cfg.num_kv_heads)
        launches = {
            "flash_prefill": fa_mod.flash_attention.route_launches["wgmma"],
            "paged_decode": pa_mod.paged_attention.route_launches[pkey]}
        routes = {"flash": dict(fa_mod.flash_attention.route_launches),
                  "paged": dict(pa_mod.paged_attention.route_launches)}
    finally:
        fa_mod.reference_attention, pa_mod.reference_paged_attention = saved
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    graphs_txt = check_decode_graph(eng, decode_calls[0], True, "serve",
                                    prefills=len(prefill_ms))

    check(launches["flash_prefill"] > 0 and launches["paged_decode"] > 0,
          f"serve: a kernel never launched on the serve path: {launches}")
    check(launches["flash_prefill"] == fa_mod.flash_attention.launches
          and launches["paged_decode"] == pa_mod.paged_attention.launches,
          f"serve: a launch took another route than wgmma flash and {pkey} "
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
    graph_txt = serve_graph_check(torch, np, serving, build_gateway, model,
                                  params, cfg, eng, spec, routes, wall,
                                  max_tokens, seed)

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
        f"{plain_on_cuda}; {graphs_txt}; {graph_txt}")
    return {"launches": launches, "prompts": [len(s[2]) for s in spec],
            "fin_ctx": [len(r.prompt_tokens) + max_tokens // 2
                        for r in fin[:slots]],
            "engine": eng, "model": model, "params": params, "cfg": cfg}


def check_decode_graph(eng, calls: int, graphed: bool, what: str,
                       prefills=None) -> str:
    """That ``eng`` decodes through its decode graphs and prefills
    through its prefill graphs where ``graphed`` (each row count and
    each length bucket captured once, one replay for each of its
    ``calls`` decode calls and, where given, its ``prefills`` prefill
    calls) and eagerly elsewhere.  Returns the report's text."""
    graph, pre = eng.decode_graph, eng.prefill_graph
    check((graph is not None) == (pre is not None) == graphed,
          f"{what}: the engine decodes "
          f"{'eagerly' if graph is None else 'through the decode graphs'}"
          f" and prefills "
          f"{'eagerly' if pre is None else 'through the prefill graphs'}, "
          f"which its model should not")
    if graph is None:
        return "decode eager (the active lanes), prefill eager"
    check(graph.captures == len(graph.graphs) and graph.replays == calls,
          f"{what}: {calls} decode calls, the decode graphs replayed "
          f"{graph.replays} times and captured {graph.captures} times at "
          f"rows {sorted(graph.graphs)}")
    check(pre.captures == len(pre.graphs) and pre.replays > 0
          and prefills in (None, pre.replays),
          f"{what}: {prefills} prefill calls, the prefill graphs replayed "
          f"{pre.replays} times and captured {pre.captures} times at "
          f"buckets {sorted(pre.graphs)}")
    return (f"decode graphs at rows {sorted(graph.graphs)}: "
            f"{graph.captures} captures, {graph.replays} replays; prefill "
            f"graphs at buckets {sorted(pre.graphs)}: {pre.captures} "
            f"captures, {pre.replays} replays")


def serve_graph_check(torch, np, serving, build_gateway, model, params,
                      cfg, eng, spec, routes: dict, wall: float,
                      max_tokens: int, seed: int) -> str:
    """The serve path's decode graph against the eager path: the same
    workload served by an engine whose ``decode_step`` is wrapped (so it
    decodes eagerly, the active lanes only) launches the same kernels by
    route; then lanes 0, 2, 3, 5 and 7 of the served engine's 8, their
    prompts prefilled into its pages, decode 8 steps, each first through
    the eager step and then through the graph of 5 rows on the same
    inputs (its K/V writes overwrite the eager ones), logits within
    ``TOL['bfloat16']``.  Returns the report's text."""
    fa_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    pool, gw = build_gateway(cfg, eng.slots, max_tokens, "cuda")
    twin = serving.InferenceEngine(
        dataclasses.replace(
            model, decode_step=lambda *a, **k: model.decode_step(*a, **k)),
        params, slots=eng.slots, max_seq=eng.max_seq, gateway=gw,
        page_tokens=eng.kv_pages.page_tokens)
    check(twin.decode_graph is None,
          "serve: a wrapped decode_step took the graph path")
    for fn in (fa_mod.flash_attention, pa_mod.paged_attention):
        fn.launches = 0
        fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    t = time.perf_counter()
    drive(torch, twin, pool, serving, spec, max_tokens)
    eager_wall = time.perf_counter() - t
    eager_routes = {"flash": dict(fa_mod.flash_attention.route_launches),
                    "paged": dict(pa_mod.paged_attention.route_launches)}
    check(eager_routes == routes,
          f"serve: the graph path launched {routes}, the eager path "
          f"{eager_routes}")
    del twin
    torch.cuda.empty_cache()

    lanes, steps = [0, 2, 3, 5, 7], 8
    ctx = [100, 517, 1023, 1500, 1990]
    kv = eng.kv_pages
    ids = [f"graph{i}" for i in lanes]
    for rid, n in zip(ids, ctx):
        kv.allocate(rid, n + steps)
    tables = torch.from_numpy(np.stack(
        [kv.block_table(rid, eng.max_pages) for rid in ids])).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 7)
    tok = torch.zeros((len(lanes), 1), dtype=torch.long, device="cuda")
    for b, n in enumerate(ctx):
        prompt = torch.randint(0, cfg.vocab_size, (1, n), device="cuda",
                               generator=g)
        tok[b, 0] = model.prefill(params, prompt, eng.cache,
                                  tables[b:b + 1])[0, -1].argmax()
    pos = torch.tensor(ctx, dtype=torch.int32, device="cuda")
    lane_ids = torch.tensor(lanes, device="cuda")
    graph = eng.decode_graph
    errs, agree = [], 0
    for _ in range(steps):
        ref = model.decode_step(params, tok, eng.cache, tables, pos,
                                lanes=lane_ids)
        out = graph(params, tok, eng.cache, tables, pos, lanes=lane_ids)
        err, ok = max_err(torch, out[..., :cfg.vocab_size],
                          ref[..., :cfg.vocab_size], "bfloat16")
        check(ok, f"serve: the decode graph's logits {err:.3g} from the "
              f"eager step's, beyond {TOL['bfloat16']}")
        errs.append(err)
        agree += int((out.argmax(-1) == ref.argmax(-1)).sum())
        tok, pos = out.argmax(-1), pos + 1
    for rid in ids:
        kv.free(rid)
    return (f"the same workload served "
            f"eagerly launched the same kernels by route in "
            f"{eager_wall:.2f} s of wall time (graph {wall:.2f} s); lanes "
            f"{lanes} of {eng.slots} at contexts {ctx}, {steps} steps: "
            f"graph vs eager logits max |err| {max(errs):.3g}, greedy "
            f"tokens agree {agree}/{steps * len(lanes)}")


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
        kv.allocate(rid, S + 5 * n)
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

    lane_ids = torch.arange(B, device="cuda")

    def graph_decode():
        logits = eng.decode_graph(params, state["tok"], eng.cache, tables,
                                  state["pos"], lanes=lane_ids)
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
    graph_decode()                  # this row count's capture, not timed
    graph_ms = wall_ms(graph_decode, n)
    prefill_ms = wall_ms(prefill, 1)
    parts = []
    for name, fn in (("decode step", decode),
                     ("decode step through the engine's graph",
                      graph_decode), ("prefill", prefill)):
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
          f"{step_ms:.2f} ms wall (mean of {n}), through the engine's decode "
          f"graph {graph_ms:.2f} ms; prefill of 1x{S} tokens "
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


# -- phase 9 -----------------------------------------------------------------------
#: the slice's new kernel shapes: (label, H, H_kv, dh, window, softcap,
#: contexts of the 8 lanes per batch); 16-token pages, bf16
FAMILY_PAGED_CASES = [
    ("gemma2-9b local", 16, 8, 256, 4096, 50.0,
     [[0, 1, 63, 64, 4095, 4096, 4097, 4160],
      [6000, 8192, 0, 4096, 4097, 1, 8192, 6000]]),
    ("gemma2-9b global", 16, 8, 256, None, 50.0,
     [[0, 1, 63, 64, 4095, 4096, 4097, 4160]]),
    ("recurrentgemma-2b local", 10, 1, 256, 2048, None,
     [[0, 1, 63, 64, 2047, 2048, 2049, 4000]]),
    ("qwen3-moe-235b-a22b", 64, 4, 128, None, None,
     [[0, 1, 63, 64, 65, 128, 2047, 1000]]),
    ("qwen3-moe-30b-a3b", 32, 4, 128, None, None,
     [[0, 1, 63, 64, 65, 128, 2047, 1000]]),
    ("internvl2-2b", 16, 8, 128, None, None,
     [[0, 1, 63, 64, 65, 128, 2047, 1000]]),
    ("whisper-small decoder", 12, 12, 64, None, None,
     [[0, 1, 8, 63, 64, 65, 96, 40]]),
]
#: (atol, rtol) of the families kernel checks in bf16: an output
#: averaged over ~4,096 random keys is ~0.03, so TOL["bfloat16"] would
#: pass a window off by a whole 64-token chunk (a change of ~1e-3-4e-2);
#: the sound kernels stay within a bf16 rounding of the plain versions
TOL_FAMILIES = (2e-3, 2e-2)
#: every configuration the engine serves beside qwen3-8b
FAMILY_ARCHS = ("deepseek-7b", "tinyllama-1.1b", "gemma2-2b", "gemma2-9b",
                "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
                "recurrentgemma-2b", "xlstm-350m", "internvl2-2b")
#: the configurations whose engines decode through the decode graphs on
#: the card (attention layers with dense MLPs only); the others decode
#: eagerly
FAMILY_GRAPHED = ("deepseek-7b", "tinyllama-1.1b", "gemma2-2b", "gemma2-9b",
                  "internvl2-2b")
#: whisper-small's encoder frames (30 s of audio) and decode steps
WHISPER_FRAMES, WHISPER_STEPS = 1500, 32


def limit_ratio(out, ref, atol: float, rtol: float) -> float:
    """Largest |out − ref| / (atol + rtol·|ref|): within the limit
    where it is at most 1."""
    o, r = out.float(), ref.float()
    return float(((o - r).abs() / (atol + rtol * r.abs())).max())


def value_scaled_ratio(out, ref, v) -> float:
    """:func:`limit_ratio` at ``TOL_FAMILIES`` with the absolute term
    scaled by the largest |v| (at least 1): an attention output is a
    convex combination of V's rows, so its rounding scales with them
    (``TOL_FAMILIES`` was set on unit-scale V)."""
    s = max(float(v.float().abs().max()), 1.0)
    return limit_ratio(out.float() / s, ref.float() / s, *TOL_FAMILIES)


def family_kernel_checks(torch, seed: int) -> dict:
    """The paged kernel at the families' shapes (bf16, windows, G 1 to
    16, dh 64 to 256), flash at dh 256 with a window and a softcap
    (gemma2-9b) and with a window at G 10 (recurrentgemma-2b), and flash
    without the causal mask (whisper-small's encoder, and its
    cross-attention with Sq 1 and 64 over 1,500 keys), each against its
    plain version at ``TOL_FAMILIES``.  Each windowed case also runs
    the kernel with its window 64 tokens (one chunk) too long and too
    short, and each non-causal case runs it causal: that wrong output
    must fail the same check.  Returns the max error per case."""
    from repro_torch.kernels.flash_attention import (
        flash_attention, reference_attention)
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_decode_attention, reference_paged_attention)
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    errs, lines = {}, []
    sound, wrong = [], []

    def hold(out, ref, what):
        err = float((out.float() - ref.float()).abs().max())
        ratio = limit_ratio(out, ref, *TOL_FAMILIES)
        check(ratio <= 1, f"families {what}: max |err| {err}, "
                          f"{ratio:.3g} x the limit {TOL_FAMILIES}")
        sound.append((ratio, what))
        return err

    def off_by_a_chunk(fn, ref, window, what):
        for shift in (-64, 64):
            ratio = limit_ratio(fn(window + shift), ref, *TOL_FAMILIES)
            check(ratio > 1, f"families {what}: the kernel with window "
                             f"{window + shift} passes the check at window "
                             f"{window} ({ratio:.3g} x the limit)")
            wrong.append(ratio)

    for label, H, Hkv, dh, window, cap, batches in FAMILY_PAGED_CASES:
        worst = worst_split = 0.0
        want = pa_mod.route(torch.bfloat16, dh, H // Hkv)
        for ctxs in batches:
            q, kp, vp, bt, cl = paged_inputs(torch, g, 8, H, Hkv, dh, ctxs,
                                             torch.bfloat16)
            before = dict(paged_attention.route_launches)
            out = paged_decode_attention(q, kp, vp, bt, cl, softcap=cap,
                                         window=window)
            took = [r for r, n in paged_attention.route_launches.items()
                    if n > before[r]]
            check(took == [want], f"families paged {label}: routes {took}, "
                                  f"want {want}")
            torch.cuda.synchronize()
            ref = reference_paged_attention(q, kp, vp, bt, cl, softcap=cap,
                                            window=window)
            worst = max(worst, hold(out, ref, f"paged {label} ctx={ctxs}"))
            zero = [b for b, c in enumerate(ctxs) if c == 0]
            check(not out[zero].float().abs().sum().item(),
                  f"families paged {label}: context 0 must give zeros")
            if want == "group":
                # the route's own arithmetic (P as hi + lo), then the
                # split route, forced
                hold(out, pa_mod.reference_paged_attention_group(
                    q, kp, vp, bt, cl, softcap=cap, window=window),
                    f"paged {label} against the group mirror ctx={ctxs}")
                out = paged_attention(q, kp, vp, bt, cl, softcap=cap,
                                      window=window, kernel="split")
                torch.cuda.synchronize()
                worst_split = max(worst_split, hold(
                    out, ref, f"split {label} ctx={ctxs}"))
            if window is not None:
                off_by_a_chunk(lambda w: paged_decode_attention(
                    q, kp, vp, bt, cl, softcap=cap, window=w), ref, window,
                    f"paged {label} ctx={ctxs}")
        errs[label] = worst
        lines.append(f"paged {label} (dh {dh}, G {H // Hkv}, window "
                     f"{window}, softcap {cap}) {want} max|err| {worst:.3g}"
                     + (f", split {worst_split:.3g}" if want == "group"
                        else ""))
    # the f32 and f32-over-bf16 entries at dh 256 with a window (the
    # small-model check runs f32 at dh 16)
    for q_dt, kv_dt in (("float32", "float32"), ("float32", "bfloat16")):
        ctxs = [0, 1, 63, 64, 2047, 2048, 2049, 4000]
        q, kp, vp, bt, cl = paged_inputs(
            torch, g, 8, 10, 1, 256, ctxs, getattr(torch, kv_dt),
            getattr(torch, q_dt))
        out = paged_decode_attention(q, kp, vp, bt, cl, window=2048)
        torch.cuda.synchronize()
        ref = reference_paged_attention(q, kp, vp, bt, cl, window=2048)
        what = f"paged q {q_dt} pages {kv_dt} dh 256 G 10 window 2048"
        if kv_dt == "float32":
            err, ok = max_err(torch, out, ref, "float32")
            check(ok, f"families {what}: max |err| {err}")
        else:
            err = hold(out, ref, what)
        lines.append(f"{what} max|err| {err:.3g}")
    # flash at gemma2-9b's width: tensor-core route, causal, window,
    # softcap
    before = dict(flash_attention.route_launches)
    for S in (512, 4608):
        q, k, v = (torch.randn(1, S, h, 256, device="cuda", generator=g)
                   .to(torch.bfloat16).transpose(1, 2) for h in (16, 8, 8))
        out = flash_attention(q, k, v, causal=True, window=4096,
                              softcap=50.0)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v, causal=True, window=4096,
                                  softcap=50.0)
        errs[f"flash S={S}"] = hold(out, ref, f"flash dh 256 S={S}")
        if S > 4096:                       # the window cuts in
            off_by_a_chunk(lambda w: flash_attention(
                q, k, v, causal=True, window=w, softcap=50.0), ref, 4096,
                f"flash dh 256 S={S}")
        del ref
        lines.append(f"flash bf16 dh 256 S={S} window 4096 softcap 50 "
                     f"max|err| {errs[f'flash S={S}']:.3g}")
    # recurrentgemma-2b's local layers: dh 256, G 10, window 2048, past it
    S = 2600
    q, k, v = (torch.randn(1, S, h, 256, device="cuda", generator=g)
               .to(torch.bfloat16).transpose(1, 2) for h in (10, 1, 1))
    out = flash_attention(q, k, v, causal=True, window=2048)
    torch.cuda.synchronize()
    ref = reference_attention(q, k, v, causal=True, window=2048)
    errs["flash dh 256 G 10"] = hold(out, ref, f"flash dh 256 G 10 S={S}")
    off_by_a_chunk(lambda w: flash_attention(q, k, v, causal=True,
                                             window=w), ref, 2048,
                   f"flash dh 256 G 10 S={S}")
    del ref
    lines.append(f"flash bf16 dh 256 G 10 S={S} window 2048 max|err| "
                 f"{errs['flash dh 256 G 10']:.3g}")
    took = [r for r, n in flash_attention.route_launches.items()
            if n > before[r]]
    check(took == ["wgmma"], f"families flash dh 256 took {took}")
    # whisper-small: the encoder's bidirectional attention (S = Sk =
    # 1,500) and the decoder's cross-attention (Sq 1 and 64 over the
    # 1,500 encoder keys), dh 64, G 1; each run again causal, which must
    # miss the limit
    before = dict(flash_attention.route_launches)
    k, v = (torch.randn(1, WHISPER_FRAMES, 12, 64, device="cuda",
                        generator=g).to(torch.bfloat16).transpose(1, 2)
            for _ in range(2))
    for Sq in (WHISPER_FRAMES, 64, 1):
        q = torch.randn(1, Sq, 12, 64, device="cuda", generator=g) \
            .to(torch.bfloat16).transpose(1, 2)
        out = flash_attention(q, k, v, causal=False)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v, causal=False)
        what = f"flash non-causal Sq={Sq} Sk={WHISPER_FRAMES}"
        errs[what] = hold(out, ref, what)
        flipped = limit_ratio(flash_attention(q, k, v, causal=True), ref,
                              *TOL_FAMILIES)
        check(flipped > 1, f"families {what}: the causal kernel passes the "
                           f"non-causal check ({flipped:.3g} x the limit)")
        wrong.append(flipped)
        lines.append(f"{what} dh 64 bf16 max|err| {errs[what]:.3g} (causal "
                     f"twin {flipped:.3g} x the limit)")
    # internvl2-2b's prefill: causal, dh 128, G 2
    q, k, v = (torch.randn(1, 512, h, 128, device="cuda", generator=g)
               .to(torch.bfloat16).transpose(1, 2) for h in (16, 8, 8))
    out = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    errs["flash dh 128 G 2"] = hold(out, reference_attention(q, k, v),
                                    "flash dh 128 G 2 S=512")
    lines.append(f"flash bf16 dh 128 G 2 S=512 causal max|err| "
                 f"{errs['flash dh 128 G 2']:.3g}")
    took = [r for r, n in flash_attention.route_launches.items()
            if n > before[r]]
    check(took == ["wgmma"], f"families flash dh 64/128 took {took}")
    print(f"families kernels: within |err| <= {TOL_FAMILIES[0]} + "
          f"{TOL_FAMILIES[1]}·|ref| of the plain versions on the card "
          f"(largest reading {max(sound)[0]:.3g} of the limit, "
          f"{max(sound)[1]}); every window "
          f"off by 64 tokens either way and every causal twin of a "
          f"non-causal case fails it (smallest reading "
          f"{min(wrong):.3g} of the limit, {len(wrong)} runs); "
          + "; ".join(lines))
    return errs


def busy_share(torch, fn):
    """(device ms of the kernels, wall ms) of one call under
    ``torch.profiler``; None where it records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    dev = sum(e.self_device_time_total for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA) / 1e3
    return (dev, wall) if dev > 0 else None


def family_workload(np, seed: int, vocab: int, long=None,
                    short=(32, 513), n: int = 16):
    """``n`` − 4 prompts with lengths drawn from ``short`` (a half-open
    range), and 4 more from ``long`` (or ``short``) at positions 3, 7,
    11, 15; tenants alternate, one arrival every 0.25 simulated
    seconds."""
    r = np.random.default_rng(seed)
    lens = list(r.integers(*short, n - 4))
    extra = r.integers(*(long or short), 4)
    for j, k in enumerate(extra):
        lens.insert(4 * j + 3, k)
    return [(f"r{i}", "prod" if i % 2 == 0 else "batch",
             r.integers(0, vocab, int(k)).tolist(), 0.25 * i)
            for i, k in enumerate(lens)]


def serve_family(torch, np, seed: int, arch: str, max_seq: int,
                 long=None, max_tokens: int = 32, short=(32, 513),
                 n: int = 16, probe=None):
    """One full-width model through TokenPool → Gateway → InferenceEngine
    on the card (8 slots, 16-token pages, the pool given the KV bytes of
    the engine's page pool, or 1 GiB where the model keeps none), with
    every kernel launch counted and plain versions on CUDA tensors
    refused; the workload is ``family_workload``'s.  A model with
    recurrent layers then has their share of a decode step and of a
    prefill timed (``recurrence_share``).  ``probe(engine, model,
    params)``, where given, runs last, on the served model.  Returns
    what the report needs."""
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_gateway
    from repro_torch.models import build_model, param_count
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import ATTN_KINDS, layer_kinds
    fa_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    slots, page = 8, 16
    cfg = get_config(arch)
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = param_count(params)

    prefill_ms, decode_ms, busy = [], [], {}
    # flash launches by prompt length: up to 512 tokens, and longer
    flash_by_len = {"short": 0, "long": 0}

    def timed_prefill(*a, **kw):
        n0 = fa_mod.flash_attention.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine_prefill(*a, **kw)
        torch.cuda.synchronize()
        S = a[1].shape[1]
        prefill_ms.append((S, 1e3 * (time.perf_counter() - t)))
        flash_by_len["long" if S > 512 else "short"] += \
            fa_mod.flash_attention.launches - n0
        return out

    # the engine's own decode step (its graphs, or the eager step),
    # called through inner() and counted
    decode_calls = [0]

    def inner(*a, **kw):
        decode_calls[0] += 1
        return engine_decode(*a, **kw)

    def timed_decode(*a, **kw):
        # each step with more lanes than any before it runs under the
        # profiler instead (not timed); the last is the busiest step
        B = a[1].shape[0]
        if B > busy.get("lanes", 0):
            if eng.decode_graph is not None:
                # this row count's graph captured outside the profiler: a
                # dense step run twice on the same inputs writes the same
                # K/V and gives the same logits
                inner(*a, **kw)
            res = {}
            busy["lanes"] = B
            busy["share"] = busy_share(
                torch, lambda: res.setdefault("out", inner(*a, **kw)))
            return res["out"]
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        decode_ms.append((B, 1e3 * (time.perf_counter() - t)))
        return out

    plain_on_cuda = {"flash": 0, "paged": 0}

    # the share of MoE assignments dropped by the reference's capacity,
    # at prefill (T = prompt) and at decode (T = lanes)
    drops = {"prefill": [0, 0], "decode": [0, 0]}
    dispatch = moe_mod._dispatch_indices

    def counted_dispatch(ids, E, C):
        perm, dst, keep = dispatch(ids, E, C)
        key = "decode" if ids.shape[0] <= slots * cfg.experts_per_token \
            else "prefill"
        drops[key][0] += ids.shape[0]
        drops[key][1] += (~keep).sum()
        return perm, dst, keep

    saved = guard_plain(fa_mod, pa_mod, plain_on_cuda)
    moe_mod._dispatch_indices = counted_dispatch
    try:
        max_pages = max_seq // page + 1
        kv_bytes = slots * max_pages * page * cfg.kv_bytes_per_token \
            or float(1 << 30)
        pool, gw = build_gateway(cfg, slots, max_tokens, "cuda",
                                 kv_bytes=kv_bytes)
        eng = serving.InferenceEngine(
            model, params, slots=slots, max_seq=max_seq, gateway=gw,
            page_tokens=page)
        engine_prefill = eng.model.prefill
        engine_decode = eng.model.decode_step
        eng.model = dataclasses.replace(eng.model, prefill=timed_prefill,
                                        decode_step=timed_decode)
        spec = family_workload(np, seed + 5, cfg.vocab_size, long, short, n)
        for fn in (fa_mod.flash_attention, pa_mod.paged_attention):
            fn.launches = 0
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        pa_mod.paged_attention.windowed_launches = 0
        reqs = drive(torch, eng, pool, serving, spec, max_tokens)
        routes = {"flash": dict(fa_mod.flash_attention.route_launches),
                  "paged": dict(pa_mod.paged_attention.route_launches),
                  "paged windowed": pa_mod.paged_attention.windowed_launches}
        launches = {"flash": fa_mod.flash_attention.launches,
                    "paged": pa_mod.paged_attention.launches}
    finally:
        fa_mod.reference_attention, pa_mod.reference_paged_attention = saved
        moe_mod._dispatch_indices = dispatch
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    graph_txt = check_decode_graph(eng, decode_calls[0],
                                   arch in FAMILY_GRAPHED, f"families {arch}",
                                   prefills=len(prefill_ms))

    fin = [r for r in reqs if r.state.value == "finished"]
    check(len(fin) == len(reqs), f"families {arch}: "
          f"{len(reqs) - len(fin)} requests not admitted or not finished "
          f"({sorted({r.state.value for r in reqs})})")
    for r in fin:
        check(len(r.output_tokens) == max_tokens
              and all(0 <= t < cfg.vocab_size for t in r.output_tokens),
              f"families {arch}: {r.request_id} gave "
              f"{len(r.output_tokens)} tokens or ids outside the vocabulary")
    kinds = layer_kinds(cfg)
    n_attn = sum(k in ATTN_KINDS for k in kinds)
    n_local = kinds.count("local")
    fa_route = fa_mod.route(torch.bfloat16, cfg.head_dim)
    check(n_attn == 0 or fa_route == "wgmma",
          f"families {arch}: bf16 flash at dh {cfg.head_dim} routes to "
          f"{fa_route}, not the tensor cores")
    check(routes["flash"][fa_route] == launches["flash"]
          == len(fin) * n_attn,
          f"families {arch}: flash launches {routes['flash']} for "
          f"{len(fin)} prompts x {n_attn} attention layers, route {fa_route}")
    pkey = paged_key(pa_mod, torch, cfg.head_dim,
                     cfg.num_heads // cfg.num_kv_heads)
    check(routes["paged"][pkey] == launches["paged"]
          and (launches["paged"] > 0) == (n_attn > 0),
          f"families {arch}: paged launches off the {pkey} route {routes}")
    check(routes["paged windowed"] * n_attn == launches["paged"] * n_local,
          f"families {arch}: {routes['paged windowed']} windowed of "
          f"{launches['paged']} paged launches; {n_local} of "
          f"{n_attn} attention layers are local")
    check(not any(plain_on_cuda.values()),
          f"families {arch}: plain versions on CUDA tensors {plain_on_cuda}")
    # a fresh prompt's logits through the engine's pages are finite
    kv = eng.kv_pages
    kv.allocate("probe", 40)
    eng.cache.reset(0)
    table = torch.from_numpy(kv.block_table("probe", eng.max_pages)[None]) \
        .to("cuda")
    logits = model.prefill(params, torch.tensor([spec[0][2][:40]],
                                                device="cuda"),
                           eng.cache, table)
    kv.free("probe")
    check(tuple(logits.shape) == (1, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab_size]).all()),
          f"families {arch}: logits not finite or of the wrong shape")

    short_ms = [ms for s, ms in prefill_ms if s <= 512]
    longs = [(s, ms) for s, ms in prefill_ms if s > 512]
    dec_tok = sum(b for b, _ in decode_ms)
    dec_s = sum(ms for _, ms in decode_ms) / 1e3
    by_lanes = {}
    for b, ms in decode_ms:
        by_lanes.setdefault(b, []).append(ms)
    dev_wall = busy.get("share")
    rec_txt = ""
    probe_len = min(short[1] - 1, 256)
    if n_attn < len(kinds):
        (pre_ms, pre_rec), (dec_ms, dec_rec) = recurrence_share(
            torch, np, eng, model, params, seed, probe_len)
        rec_txt = (f"; the {len(kinds) - n_attn} recurrent layers (host "
                   f"clock, a synchronise around each) take {pre_rec:.2f} of "
                   f"{pre_ms:.2f} ms of a {probe_len}-token "
                   f"prefill ({100 * pre_rec / pre_ms:.0f} %) and "
                   f"{dec_rec:.2f} of {dec_ms:.2f} ms of an 8-lane decode "
                   f"step ({100 * dec_rec / dec_ms:.0f} %)")
    drop_txt = ""
    if cfg.is_moe:
        drop_txt = "; MoE assignments dropped by capacity " + ", ".join(
            f"{k} {int(d)}/{n} ({100 * int(d) / max(n, 1):.1f} %)"
            for k, (n, d) in drops.items())
    print(
        f"families {arch}: full width and depth ({cfg.num_layers} layers, "
        f"d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
        f"dh={cfg.head_dim}, d_ff={cfg.d_ff}"
        + (f" x {cfg.num_experts} experts top-{cfg.experts_per_token}"
           if cfg.is_moe else "")
        + (f", window {cfg.window_size}" if n_local else "")
        + f", vocab {cfg.vocab_size}), {n_params / 1e9:.3f} B params "
        f"{cfg.dtype}, init {init_s:.1f} s; slots {slots}, max_seq "
        f"{max_seq}, pool KV {kv_bytes / 1e9:.2f} GB; admitted "
        f"{len(fin)}/{len(reqs)}; prefill ms: {len(short_ms)} prompts of "
        f"{short[0]}-{min(short[1] - 1, 512)} tokens mean "
        f"{sum(short_ms) / max(len(short_ms), 1):.2f}"
        + "".join(f", {s} tokens {ms:.2f}" for s, ms in longs)
        + f"; decode {dec_tok / max(dec_s, 1e-9):.1f} tok/s ({dec_tok} "
        f"tokens in {dec_s:.2f} s of decode steps; mean step ms by lanes "
        + ", ".join(f"{b}: {sum(v) / len(v):.2f}"
                    for b, v in sorted(by_lanes.items()))
        + f"); device busy in a {busy.get('lanes')}-lane decode step (the "
        f"most lanes of the run) "
        + (f"{dev_wall[0]:.2f} of {dev_wall[1]:.2f} ms "
           f"({100 * dev_wall[0] / dev_wall[1]:.0f} %)" if dev_wall
           else "not measured (no device time recorded)")
        + f"; peak memory {peak_gb:.2f} GB; launches by route {routes}; "
        f"plain calls on CUDA {plain_on_cuda}; {graph_txt}" + rec_txt
        + drop_txt)
    ctx = [len(r.prompt_tokens) + max_tokens // 2 for r in fin[:slots]]
    return {"launches": launches, "routes": routes,
            "flash_by_len": flash_by_len, "cfg": cfg, "ctx": ctx,
            "prompts": [len(s[2]) for s in spec],
            "probe": probe and probe(eng, model, params)}


def recurrence_share(torch, np, eng, model, params, seed: int, S: int):
    """The recurrent layers' share of a prefill and of a decode step, on
    the host clock with a synchronise around each recurrent layer (so
    the shares include the launch overhead of their eager ops): 8 seeded
    prompts of ``S`` tokens prefilled one at a time into lanes 0-7 of
    the served engine's cache, then one decode step of the 8.  Returns
    ((prefill ms, of it recurrent ms), (step ms, of it recurrent
    ms)), the prefill the last of the 8."""
    from repro_torch.models import transformer
    kv, B = eng.kv_pages, eng.slots
    ids = [f"rec{i}" for i in range(B)]
    for rid in ids:
        kv.allocate(rid, S + 1)
    tables = torch.from_numpy(np.stack(
        [kv.block_table(rid, eng.max_pages) for rid in ids])).to("cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 17)
    prompt = torch.randint(0, model.cfg.vocab_size, (B, S), device="cuda",
                           generator=g)
    spent = []
    inner = transformer._recurrent

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out

    def run(fn):
        spent.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t), 1e3 * sum(spent)

    transformer._recurrent = timed
    try:
        for b in range(B):
            eng.cache.reset(b)
            pre = run(lambda b=b: model.prefill(
                params, prompt[b:b + 1], eng.cache, tables[b:b + 1],
                lanes=torch.tensor([b], device="cuda")))
        tok = prompt[:, -1:]
        pos = torch.full((B,), S, dtype=torch.int32, device="cuda")
        dec = run(lambda: model.decode_step(params, tok, eng.cache, tables,
                                            pos))
    finally:
        transformer._recurrent = inner
    for rid in ids:
        kv.free(rid)
    return pre, dec


def vlm_prefix(torch, seed: int, eng, model, params, n_text: int = 64,
               steps: int = 16) -> dict:
    """internvl2-2b's image path at the model level, on the served
    engine's pages: one prefill of ``num_vision_tokens`` seeded patch
    embeddings in front of a seeded prompt of ``n_text`` tokens, then
    ``steps`` greedy decode steps from position N + ``n_text``; every
    logit finite, the kernels' launches counted."""
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention").flash_attention
    pa = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention").paged_attention
    cfg = model.cfg
    N = cfg.num_vision_tokens
    kv = eng.kv_pages
    kv.allocate("vlm", N + n_text + steps)
    table = torch.from_numpy(kv.block_table("vlm", eng.max_pages)[None]) \
        .to("cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 23)
    patches = torch.randn(1, N, cfg.d_model, device="cuda", generator=g) \
        .to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (1, n_text), device="cuda",
                           generator=g)
    n0 = (fa.launches, pa.launches)
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits = model.prefill(params, prompt, eng.cache, table,
                           extra_embed=patches)
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t)
    finite = [bool(torch.isfinite(logits[..., :cfg.vocab_size]).all())]
    tok = logits[:, -1].argmax(-1, keepdim=True)
    t = time.perf_counter()
    for i in range(steps):
        pos = torch.tensor([N + n_text + i], dtype=torch.int32, device="cuda")
        logits = model.decode_step(params, tok, eng.cache, table, pos)
        finite.append(bool(torch.isfinite(logits[..., :cfg.vocab_size])
                           .all()))
        tok = logits[:, 0].argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = 1e3 * (time.perf_counter() - t) / steps
    kv.free("vlm")
    launches = (fa.launches - n0[0], pa.launches - n0[1])
    check(all(finite), "families internvl2-2b image prefix: logits not "
                       "finite")
    check(launches == (cfg.num_layers, steps * cfg.num_layers),
          f"families internvl2-2b image prefix: launches (flash, paged) "
          f"{launches}")
    print(f"families internvl2-2b image prefix: {N} seeded patch embeddings "
          f"through vision_proj in front of a {n_text}-token prompt "
          f"(positions 0-{N + n_text - 1}), prefill {prefill_ms:.2f} ms; "
          f"{steps} decode steps from position {N + n_text}, "
          f"{decode_ms:.2f} ms each; logits finite; launches (flash, paged) "
          f"{launches}")
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms}


def whisper_run(torch, np, seed: int) -> dict:
    """whisper-small at full width and depth through its model entry
    points (no engine serves it: fault C10): 4 sequences of 1,500 seeded
    frames, prefilled one at a time into lanes 0-3 with decoder prompts
    of 8-64 tokens, then 32 greedy decode steps of the 4 together.
    Every flash launch is counted by call (the encoder, cross-attention
    at prefill and at decode, the causal self-attention), every paged
    launch too, and plain versions on CUDA tensors are refused."""
    from repro_torch.configs import get_config
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import build_model, param_count
    from repro_torch.serving.kv_manager import KVBlockManager
    fa_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    cfg = get_config("whisper-small")
    model = build_model(cfg)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(seed),
                        "cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n, page, L = 4, 16, cfg.num_layers
    r = np.random.default_rng(seed + 19)
    lens = [int(x) for x in r.integers(8, 65, n)]
    prompts = [torch.tensor([r.integers(0, cfg.vocab_size, k).tolist()],
                            device="cuda") for k in lens]
    g = torch.Generator(device="cuda").manual_seed(seed + 19)
    frames = torch.randn(n, WHISPER_FRAMES, cfg.d_model, device="cuda",
                         generator=g).to(torch.bfloat16)
    max_pages = (max(lens) + WHISPER_STEPS) // page + 1
    kv = KVBlockManager(total_pages=n * max_pages, page_tokens=page,
                        bytes_per_token=cfg.kv_bytes_per_token)
    cache = model.init_cache(kv.total_pages, page, device="cuda", lanes=n)

    calls = dict.fromkeys(("encoder", "cross prefill", "cross decode",
                           "self prefill"), 0)
    bshd = attn_mod.flash_attention_bshd

    def counted(q, k, v, *, causal=True, **kw):
        kind = ("self prefill" if causal else "cross decode"
                if q.shape[1] == 1 else "encoder" if q.shape[1] == k.shape[1]
                else "cross prefill")
        before = fa_mod.flash_attention.launches
        out = bshd(q, k, v, causal=causal, **kw)
        calls[kind] += fa_mod.flash_attention.launches - before
        return out

    def tables():
        return torch.from_numpy(np.stack(
            [kv.block_table(f"w{i}", max_pages) for i in range(n)])).to("cuda")

    plain_on_cuda = {"flash": 0, "paged": 0}
    saved = guard_plain(fa_mod, pa_mod, plain_on_cuda)
    attn_mod.flash_attention_bshd = counted
    prefill_ms, decode_ms, finite, first = [], [], [], []
    try:
        for fn in (fa_mod.flash_attention, pa_mod.paged_attention):
            fn.launches = 0
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        for i in range(n):
            kv.allocate(f"w{i}", lens[i])
            table = torch.from_numpy(kv.block_table(f"w{i}", max_pages)[None]) \
                .to("cuda")
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits = model.prefill(params, prompts[i], cache, table,
                                   lanes=torch.tensor([i], device="cuda"),
                                   extra_embed=frames[i:i + 1])
            torch.cuda.synchronize()
            prefill_ms.append(1e3 * (time.perf_counter() - t))
            finite.append(bool(torch.isfinite(
                logits[..., :cfg.vocab_size]).all()))
            first.append(logits[0, -1].argmax())
        tok = torch.stack(first)[:, None]
        pos = torch.tensor(lens, dtype=torch.int32, device="cuda")
        out_tokens = [tok]
        for step in range(WHISPER_STEPS):
            for i in range(n):
                kv.extend(f"w{i}", lens[i] + step + 1)
            bt = tables()
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits = model.decode_step(params, tok, cache, bt, pos)
            torch.cuda.synchronize()
            decode_ms.append(1e3 * (time.perf_counter() - t))
            finite.append(bool(torch.isfinite(
                logits[..., :cfg.vocab_size]).all()))
            tok = logits[:, 0].argmax(-1, keepdim=True)
            out_tokens.append(tok)
            pos = pos + 1
        routes = {"flash": dict(fa_mod.flash_attention.route_launches),
                  "paged": dict(pa_mod.paged_attention.route_launches)}
        launches = {"flash": fa_mod.flash_attention.launches,
                    "paged": pa_mod.paged_attention.launches}
        counted_calls = dict(calls)
        # one more decode step under the profiler: the device-busy share
        for i in range(n):
            kv.extend(f"w{i}", lens[i] + WHISPER_STEPS + 1)
        bt = tables()
        dev_wall = busy_share(torch, lambda: model.decode_step(
            params, tok, cache, bt, pos))
    finally:
        attn_mod.flash_attention_bshd = bshd
        fa_mod.reference_attention, pa_mod.reference_paged_attention = saved
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    toks = torch.cat(out_tokens, 1)

    check(all(finite), "families whisper-small: logits not finite")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "families whisper-small: token ids outside the vocabulary")
    want = {"encoder": n * cfg.encoder_layers, "cross prefill": n * L,
            "self prefill": n * L, "cross decode": WHISPER_STEPS * L}
    check(counted_calls == want and launches["flash"] == sum(want.values())
          == routes["flash"]["wgmma"],
          f"families whisper-small: flash launches {counted_calls}, routes "
          f"{routes['flash']}; want {want}, all wgmma")
    pkey = paged_key(pa_mod, torch, cfg.head_dim,
                     cfg.num_heads // cfg.num_kv_heads)
    check(launches["paged"] == routes["paged"][pkey] == WHISPER_STEPS * L,
          f"families whisper-small: paged launches {routes['paged']}, all "
          f"{pkey}")
    check(not any(plain_on_cuda.values()),
          f"families whisper-small: plain versions on CUDA tensors "
          f"{plain_on_cuda}")
    print(
        f"families whisper-small: full width and depth ({cfg.encoder_layers} "
        f"encoder + {L} decoder layers, d={cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads, dh={cfg.head_dim}, "
        f"d_ff={cfg.d_ff}, vocab {cfg.vocab_size}), "
        f"{param_count(params) / 1e9:.3f} B params {cfg.dtype}, init "
        f"{init_s:.1f} s; {n} sequences of {WHISPER_FRAMES} seeded frames, "
        f"decoder prompts {lens}; prefill (encoder, cross K/V, decoder) ms "
        + ", ".join(f"{ms:.2f}" for ms in prefill_ms)
        + f"; {WHISPER_STEPS} decode steps of {n} lanes, mean "
        f"{sum(decode_ms) / len(decode_ms):.2f} ms "
        f"({n * len(decode_ms) / (sum(decode_ms) / 1e3):.1f} tok/s); device "
        f"busy in a decode step "
        + (f"{dev_wall[0]:.2f} of {dev_wall[1]:.2f} ms "
           f"({100 * dev_wall[0] / dev_wall[1]:.0f} %)" if dev_wall
           else "not measured (no device time recorded)")
        + f"; peak memory {peak_gb:.2f} GB; flash launches by call "
        f"{counted_calls}, by route {routes['flash']}; paged "
        f"{routes['paged']}; plain calls on CUDA {plain_on_cuda}")
    return {"calls": counted_calls, "launches": launches, "lens": lens,
            "ctx": [k + WHISPER_STEPS // 2 for k in lens]}


def whisper_small_reference(torch, np, seed: int) -> int:
    """whisper-small reduced, in float32, at the model level on the card
    (kernels) and on the CPU (plain versions): 2 sequences of 48 frames,
    9-token prompts, 12 greedy decode steps; identical tokens.  Returns
    the token count."""
    from repro_torch.configs import get_config
    from repro_torch.models import Runtime, build_model
    from repro_torch.serving.kv_manager import KVBlockManager
    cfg = get_config("whisper-small").reduced(dtype="float32",
                                              max_seq_len=256)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed + 29)
    frames = torch.randn(2, 48, cfg.d_model, generator=g)
    prompts = torch.randint(0, cfg.vocab_size, (2, 9), generator=g)
    outs = {}
    for dev in ("cuda", "cpu"):
        p = copy.deepcopy(params).to(dev)
        kv = KVBlockManager(total_pages=4, page_tokens=16)
        cache = model.init_cache(kv.total_pages, 16,
                                 Runtime(kv_cache_dtype="float32"), dev,
                                 lanes=2)
        for b in range(2):
            kv.allocate(f"s{b}", 9 + 12)
        bt = torch.from_numpy(np.stack([kv.block_table(f"s{b}", 2)
                                        for b in range(2)])).to(dev)
        logits = model.prefill(p, prompts.to(dev), cache, bt,
                               extra_embed=frames.to(dev))
        toks = [logits[:, -1].argmax(-1)]
        for t in range(12):
            logits = model.decode_step(
                p, toks[-1][:, None], cache, bt,
                torch.full((2,), 9 + t, dtype=torch.int32, device=dev))
            toks.append(logits[:, 0].argmax(-1))
        outs[dev] = torch.stack(toks, 1).cpu().tolist()
    check(outs["cuda"] == outs["cpu"],
          "families reference: reduced whisper-small gave different greedy "
          "tokens on the card and on the CPU")
    return 2 * 13


def family_small_reference(torch, np, seed: int) -> None:
    """Each configuration the engine serves beside qwen3-8b, reduced and
    in float32, served on the card (kernels) and on the CPU (plain
    versions), and whisper-small reduced at the model level: identical
    greedy tokens; on the card the dense ones decode through the decode
    graphs and the others eagerly."""
    from repro_torch import serving
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import build_gateway
    from repro_torch.models import Runtime, build_model
    parts = []
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch).reduced(dtype="float32", max_seq_len=256)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(seed), "cpu")
        spec = workload(np, seed + 2, 6, cfg.vocab_size)
        spec = [(rid, ten, p[:int(np.clip(len(p) // 4, 3, 120))], t)
                for rid, ten, p, t in spec]
        outs = {}
        for dev in ("cuda", "cpu"):
            pool, gw = build_gateway(cfg, 4, 12, dev)
            eng = serving.InferenceEngine(
                model, copy.deepcopy(params).to(dev), slots=4,
                max_seq=cfg.max_seq_len, gateway=gw,
                rt=Runtime(kv_cache_dtype="float32"))
            calls, engine_decode = [0], eng.model.decode_step

            def counted(*a, **kw):
                calls[0] += 1
                return engine_decode(*a, **kw)
            eng.model = dataclasses.replace(eng.model, decode_step=counted)
            reqs = drive(torch, eng, pool, serving, spec, 12)
            outs[dev] = [(r.request_id, r.state.value,
                          list(r.output_tokens)) for r in reqs]
            if dev == "cuda":
                graph_txt = check_decode_graph(
                    eng, calls[0], arch in FAMILY_GRAPHED,
                    f"families reference {arch}")
        check(outs["cuda"] == outs["cpu"],
              f"families reference: reduced {arch} gave different greedy "
              "tokens on the card and on the CPU")
        parts.append(f"{arch} {sum(len(o[2]) for o in outs['cpu'])} "
                     f"({graph_txt})")
    parts.append(f"whisper-small (model level) "
                 f"{whisper_small_reference(torch, np, seed)}")
    print("families reference: reduced float32 configs, greedy tokens "
          "identical on cuda (kernels) and cpu (plain versions): "
          + ", ".join(parts))


def family_kernel_rows(torch, seed: int, errs: dict, served: dict) -> list:
    """Kernel JSON rows at the families' shapes: device ms (median of
    30 after an L2 flush; of 10 for the plain versions and at S of
    2,600 and 4,608), plain version, SDPA and the card's bound; flash at
    dh 256 also beside the scalar route the tensor-core one replaced
    (``previous_ms``), paged on the group route beside the split route
    forced in the same call (``split_ms``)."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, reference_attention)
    route = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention").route
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_decode_attention, reference_paged_attention)
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    timer = Timer(torch)
    # the plain versions launch ~50 kernels a call: 10 calls keep the
    # launch queue from filling while the device waits
    plain_timer = Timer(torch, iters=10)
    g = torch.Generator(device="cuda").manual_seed(seed + 13)
    bf16 = torch.bfloat16
    rows = []
    gem, moe_ = served["gemma2-9b"], served["qwen3-moe-30b-a3b"]

    def paged_row(name, label, H, Hkv, dh, ctx, window, cap, launches,
                  note):
        q, kp, vp, bt, cl = paged_inputs(torch, g, len(ctx), H, Hkv, dh,
                                         ctx, bf16)
        B = len(ctx)
        live = [min(c, window or c) for c in ctx]
        nbytes = 2.0 * (2 * B * H * dh + 2 * sum(live) * Hkv * dh) \
            + 4.0 * (bt.numel() + B)
        flops = 4.0 * H * dh * sum(live)
        t_ops = flops / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes / HBM_BYTES_S
        # SDPA over each lane's live keys, gathered dense (not timed),
        # without the softcap, which SDPA does not take
        K = max(live)
        idx = torch.stack([torch.arange(c - l, c - l + K, device="cuda")
                           .clamp(max=max(c - 1, 0)) for c, l in
                           zip(ctx, live)])                     # (B, K)
        pages = bt.long().gather(1, (idx // 16).clamp(max=bt.shape[1] - 1))
        slot = idx % 16
        dk = kp[pages.clamp_min(0), slot].transpose(1, 2)
        dv = vp[pages.clamp_min(0), slot].transpose(1, 2)
        mask = (torch.arange(K, device="cuda")[None, :]
                < torch.tensor(live, device="cuda")[:, None])
        mask = mask[:, None, None, :]
        qs = q[:, :, None, :]
        which = pa_mod.route(bf16, dh, H // Hkv)
        row = {
            "name": name, "route": "cuda", "source": PAGED_SRC,
            "replaces": PAGED_TPU, "launches": launches,
            "max_abs_err": errs[label],
            "ms": timer.ms(lambda: paged_decode_attention(
                q, kp, vp, bt, cl, softcap=cap, window=window)),
            "plain_ms": plain_timer.ms(lambda: reference_paged_attention(
                q, kp, vp, bt, cl, softcap=cap, window=window)),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
                qs, dk, dv, attn_mask=mask, enable_gqa=True)),
            "shape": f"B={B} H={H} H_kv={Hkv} dh={dh} T=16 ctx={ctx} "
                     f"window={window} softcap={cap} bf16, {which} route; "
                     f"{note}"}
        if which == "group":     # the route the group one replaced here
            row["split_ms"] = timer.ms(lambda: paged_attention(
                q, kp, vp, bt, cl, softcap=cap, window=window,
                kernel="split"))
        return row

    def flash_row(name, H, Hkv, Sq, Sk, dh, causal, window, cap, err,
                  launches, note, B=1, t=timer, previous=False):
        q = torch.randn(B, Sq, H, dh, device="cuda", generator=g) \
            .to(bf16).transpose(1, 2)
        k, v = (torch.randn(B, Sk, Hkv, dh, device="cuda", generator=g)
                .to(bf16).transpose(1, 2) for _ in range(2))
        qp = torch.arange(Sq, device="cuda")[:, None]
        kp = torch.arange(Sk, device="cuda")[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device="cuda")
        if causal:
            mask &= kp <= qp
        if window:
            mask &= qp - kp < window
        flops = 4.0 * B * H * dh * int(mask.sum())    # visible pairs only
        nbytes = 2.0 * B * (2 * H * Sq + 2 * Hkv * Sk) * dh
        t_ops = flops / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes / HBM_BYTES_S
        o = torch.empty_like(q)
        # SDPA's own causal path where no window needs the mask
        masked = bool(window)
        row = {
            "name": name, "route": "cuda", "source": FLASH_SRC,
            "replaces": FLASH_TPU, "launches": launches,
            "max_abs_err": err,
            "ms": t.ms(lambda: flash_attention(q, k, v, causal=causal,
                                               window=window, softcap=cap,
                                               out=o)),
            "plain_ms": plain_timer.ms(lambda: reference_attention(
                q, k, v, causal=causal, window=window, softcap=cap)),
            "bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "library_ms": t.ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask if masked else None,
                is_causal=causal and not masked, enable_gqa=True)),
            "shape": f"B={B} H={H} H_kv={Hkv} Sq={Sq} Sk={Sk} dh={dh} bf16 "
                     f"causal={causal} window={window} softcap={cap}, "
                     f"{route(bf16, dh)} route; {note}"
                     + "; library: SDPA" + (" with the window as a mask"
                                            if masked else " is_causal"
                                            if causal else "")
                     + (", no softcap" if cap else "")}
        if previous:             # the route the tensor cores replaced here
            row["previous_ms"] = t.ms(lambda: flash_attention(
                q, k, v, causal=causal, window=window, softcap=cap, out=o,
                kernel="scalar"))
            row["previous"] = "scalar route (flash_prefill_bf16)"
        return row

    rg, vl, wh = (served[a] for a in ("recurrentgemma-2b", "internvl2-2b",
                                      "whisper-small"))
    windowed = gem["routes"]["paged windowed"]
    rows.append(paged_row(
        "paged_decode_window", "gemma2-9b local", 16, 8, 256, gem["ctx"],
        4096, 50.0, windowed,
        "gemma2-9b local layers at the serve run's contexts; launches: "
        "the windowed ones of that run; library: SDPA over the live "
        "window"))
    rows.append(paged_row(
        "paged_decode_dh256", "gemma2-9b global", 16, 8, 256, gem["ctx"],
        None, 50.0, gem["launches"]["paged"] - windowed,
        "gemma2-9b global layers; launches: the unwindowed ones of the "
        "gemma2-9b serve run"))
    rows.append(paged_row(
        "paged_decode_g8", "qwen3-moe-30b-a3b", 32, 4, 128, moe_["ctx"],
        None, None, moe_["launches"]["paged"],
        "qwen3-moe-30b-a3b at its serve run's contexts"))
    rows.append(paged_row(
        "paged_decode_g10_window", "recurrentgemma-2b local", 10, 1, 256,
        rg["ctx"], 2048, None, rg["routes"]["paged windowed"],
        "recurrentgemma-2b's local layers at its serve run's contexts; "
        "launches: that run's, all windowed; library: SDPA over the live "
        "window"))
    far = [4000, 3000, 2500, 2100, 2048, 1000, 300, 64]
    rows.append(paged_row(
        "paged_decode_g16", "qwen3-moe-235b-a22b", 64, 4, 128, far, None,
        None, 0,
        "qwen3-moe-235b-a22b's shape; no served path runs it (470 GB of "
        "weights are not served at full width), so 0 launches"))
    rows.append(paged_row(
        "paged_decode_g2", "internvl2-2b", 16, 8, 128, vl["ctx"], None,
        None, vl["launches"]["paged"],
        "internvl2-2b at its serve run's contexts (text)"))
    rows.append(paged_row(
        "paged_decode_dh64_g1", "whisper-small decoder", 12, 12, 64,
        wh["ctx"], None, None, wh["launches"]["paged"],
        "whisper-small's decoder self-attention at the run's contexts "
        "mid-decode"))

    # flash at gemma2-9b's width, a short and a long prompt, beside the
    # scalar route it replaced
    for S in (512, 4608):
        rows.append(flash_row(
            f"flash_prefill_dh256_s{S}", 16, 8, S, S, 256, True, 4096, 50.0,
            errs[f"flash S={S}"],
            gem["flash_by_len"]["long" if S > 512 else "short"],
            "launches: the gemma2-9b serve run's flash launches on prompts "
            "of " + ("4,160-4,608 tokens" if S > 512 else "32-512 tokens"),
            t=plain_timer if S > 512 else timer, previous=True))
    rows.append(flash_row(
        "flash_prefill_dh256_g10_s2600", 10, 1, 2600, 2600, 256, True, 2048,
        None, errs["flash dh 256 G 10"], rg["flash_by_len"]["long"],
        "recurrentgemma-2b's local layers; launches: its serve run's on "
        "prompts of 2,100-2,600 tokens", t=plain_timer, previous=True))
    S = max(vl["prompts"])
    rows.append(flash_row(
        "flash_prefill_g2", 16, 8, S, S, 128, True, None, None,
        errs["flash dh 128 G 2"], vl["launches"]["flash"],
        "internvl2-2b at its longest prompt; launches: its serve run's"))
    # whisper-small: max_abs_err from the check at Sq 1,500, 64 and 1
    for name, Sq, checked, B, kind in (
            ("flash_encoder_s1500", WHISPER_FRAMES, WHISPER_FRAMES, 1,
             "encoder"),
            ("flash_cross_prefill", max(wh["lens"]), 64, 1, "cross prefill"),
            ("flash_cross_decode", 1, 1, len(wh["lens"]), "cross decode")):
        rows.append(flash_row(
            name, 12, 12, Sq, WHISPER_FRAMES, 64, False, None, None,
            errs[f"flash non-causal Sq={checked} Sk={WHISPER_FRAMES}"],
            wh["calls"][kind], f"whisper-small's {kind} attention, no "
            "mask; launches: the whisper run's", B=B))
    return rows


def phase_families(torch, np, seed: int) -> list:
    """The families' kernel shapes; gemma2-9b, qwen3-moe-30b-a3b,
    recurrentgemma-2b, xlstm-350m and internvl2-2b (and its image
    prefix) served at full width and depth; whisper-small at full width
    and depth through its model entry points; the reduced configs card =
    CPU.  Returns the kernel JSON rows of the families' shapes."""
    errs = family_kernel_checks(torch, seed)
    served = {}
    runs = (
        ("gemma2-9b", dict(max_seq=4736, long=(4160, 4609))),
        ("qwen3-moe-30b-a3b", dict(max_seq=1024)),
        ("recurrentgemma-2b", dict(max_seq=2688, long=(2100, 2601))),
        # the xLSTM cells step token by token in eager ops: prompts of
        # 32-128 tokens keep a prefill to ~100 k launches
        ("xlstm-350m", dict(max_seq=256, short=(32, 129), n=8,
                            max_tokens=16)),
        ("internvl2-2b", dict(max_seq=1024, probe=lambda *a: vlm_prefix(
            torch, seed, *a))))
    for arch, kw in runs:
        served[arch] = serve_family(torch, np, seed, arch, **kw)
        gc.collect()
        torch.cuda.empty_cache()
    served["whisper-small"] = whisper_run(torch, np, seed)
    gc.collect()
    torch.cuda.empty_cache()
    family_small_reference(torch, np, seed)
    return family_kernel_rows(torch, seed, errs, served)


# -- phase 10 ----------------------------------------------------------------------
#: the training launcher's batch (8 sequences of 256 tokens) and the
#: reference's train-loop test schedule: 8 steps, a checkpoint every 4,
#: a crash after step 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_CRASH = 8, 256, 8, 4
#: steps of the reference's end-to-end example (``--reduce 100m``; its
#: docstring runs 300, ~92 ms a step with set-up on an H100 at 700 W):
#: what the phase's time allows
TRAIN_100M_STEPS = 200
#: resume against the uninterrupted run: the reference's own bound for
#: its bit-exact resume
RESUME_RTOL = 1e-5
#: card against CPU in float32, reduced configs: one step's loss within
#: 1e-5 and each gradient leaf within 1e-4 of its largest entry, the
#: tolerances of tests/test_torch_train_loop.py and
#: test_torch_train_families.py (1e-3 for whisper-small, as there, and
#: for xlstm-350m, whose 40 exponential-gated steps in series reach
#: 1.15e-4 on an H100 at 700 W); 8 steps' losses within 1e-2
#: relative: Adam divides each gradient by its size, so a gradient at
#: rounding noise (cuBLAS and the CPU sum in other orders) flips its
#: step, and at the reference's init (fault C14) the model amplifies
#: each flip (1.6e-3 by step 7 on an H100 at 700 W, 3.9e-5 at step 1)
CARD_CPU_LOSS_RTOL, CARD_CPU_STEP_RTOL = 1e-2, 1e-5
CARD_CPU_GRAD_TOL = {"whisper-small": 1e-3, "xlstm-350m": 1e-3}
#: the families of tests/test_torch_train_families.py
TRAIN_FAMILIES = ("gemma2-2b", "qwen3-moe-30b-a3b", "recurrentgemma-2b",
                  "xlstm-350m", "internvl2-2b", "whisper-small")
#: trained checkpoint through the kernels: prompts and decode steps
TRAIN_PROMPTS, TRAIN_DECODE = 4, 16


def profile_step(torch, fn):
    """One call of ``fn`` under ``torch.profiler``: (device ms of its
    kernels, wall ms, kernel launches, the five kernels with the most
    device time as "name ms")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    check(dev, "train: torch.profiler recorded no device time")
    dev.sort(key=lambda e: -e.self_device_time_total)
    top = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f}"
                    for e in dev[:5])
    return (sum(e.self_device_time_total for e in dev) / 1e3, wall,
            sum(e.count for e in dev), top)


def train_batch(torch, np, cfg, seed: int, dev: str, B=2, S=40):
    """Seeded tokens and targets (and a VLM's patches or whisper's
    frames) on ``dev``."""
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab_size, (B, S)),
             "targets": r.integers(0, cfg.vocab_size, (B, S))}
    if cfg.is_encoder_decoder:
        batch["extra_embed"] = r.standard_normal((B, 24, cfg.d_model))
    elif cfg.num_vision_tokens:
        batch["extra_embed"] = r.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model))
    return {k: torch.as_tensor(v, dtype=torch.float32 if v.dtype.kind == "f"
                               else torch.int32, device=dev)
            for k, v in batch.items()}


def train_reference(torch, np, seed: int) -> str:
    """(e) Reduced float32 tinyllama-1.1b trained 8 steps on the card and
    on the CPU from the same weights; one train step of each reduced
    family of ``tests/test_torch_train_families.py`` on both."""
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models import build_model, param_tree
    from repro_torch.training.optimizer import OptimizerConfig, adamw_init
    from repro_torch.training.train_loop import TrainConfig, TrainLoop, \
        make_train_step

    cfg = get_config("tinyllama-1.1b").reduced(num_layers=2, vocab_size=256,
                                               dtype="float32")
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(seed), "cpu")
    data = SyntheticLMData(DataConfig(vocab_size=256, seq_len=32,
                                      global_batch=4))
    tc = TrainConfig(steps=8, checkpoint_every=100, log_every=1,
                     optimizer=OptimizerConfig(lr=1e-2, warmup_steps=2,
                                               total_steps=8))
    losses = {}
    for dev in ("cuda", "cpu"):
        loop = TrainLoop(model, data, tc, params=copy.deepcopy(params).to(dev),
                         device=dev)
        losses[dev] = [e["loss"] for e in loop.run()]
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                     losses["cpu"]))
    failed = []
    if not (all(np.isfinite(losses["cuda"])) and worst <= CARD_CPU_LOSS_RTOL):
        failed.append(f"reduced tinyllama losses on the card {losses['cuda']} "
                      f"against the CPU {losses['cpu']}")
    parts = [f"tinyllama-1.1b 8 steps, losses {losses['cpu'][0]:.4f} -> "
             f"{losses['cpu'][-1]:.4f}, card/CPU differences "
             + " ".join(f"{abs(a - b) / abs(b):.2g}" for a, b in
                        zip(losses["cuda"], losses["cpu"])) + " relative"]
    for arch in TRAIN_FAMILIES:
        cfg = get_config(arch).reduced(dtype="float32")
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(seed), "cpu")
        step = make_train_step(model, TrainConfig(optimizer=OptimizerConfig(
            lr=1e-3, warmup_steps=0, total_steps=10)))
        out = {}
        for dev in ("cuda", "cpu"):
            p = copy.deepcopy(params).to(dev)
            opt = adamw_init(param_tree(p))
            _, opt, _, m = step(p, opt, None,
                                train_batch(torch, np, cfg, seed, dev))
            out[dev] = (m["loss"].item(), m["skipped"].item(),
                        {T.key_of(k): T.stacked(v).cpu() for k, v in
                         T.leaves_with_paths(opt.mu)})
        (lc, sc, gc_), (lp, _, gp) = out["cuda"], out["cpu"]
        tol = CARD_CPU_GRAD_TOL.get(arch, 1e-4)
        floor = 1e-3 * max(float(g.abs().max()) for g in gp.values())
        grad_err = max(float((gc_[k] - g).abs().max())
                       / max(float(g.abs().max()), floor)
                       for k, g in gp.items())
        if not (np.isfinite(lc) and sc == 0.0
                and abs(lc - lp) <= CARD_CPU_STEP_RTOL * abs(lp)
                and grad_err <= tol):
            failed.append(f"{arch} step on the card (loss {lc}, skipped {sc}) "
                          f"against the CPU (loss {lp}); gradient "
                          f"{grad_err:.3g} of its scale (limit {tol})")
        parts.append(f"{arch} loss {lp:.4f} (card - cpu {lc - lp:+.2e}), "
                     f"gradients within {grad_err:.2g} of scale")
    check(not failed, "train reference: " + "; ".join(failed)
          + " || " + "; ".join(parts))
    return "; ".join(parts)


def phase_train(torch, np, seed: int, card: str) -> dict:
    """(a) full-width tinyllama-1.1b trained 8 steps, crashed after
    step 4 and resumed from its checkpoint; (b) both compressors; (c)
    the reference's ``--reduce 100m`` example; (d) the trained
    checkpoint restored into a fresh model and served through the
    kernels; (e) card against CPU.  Returns the (d) launches."""
    import shutil

    from repro_torch import tree as T
    from repro_torch.checkpointing import latest_step, restore
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import train as train_launch
    from repro_torch.models import build_model, param_count, param_tree
    from repro_torch.training.grad_compress import CompressorConfig, \
        compressed_bytes
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, TrainLoop

    fa_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    t_phase = time.perf_counter()
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size,
                                      seq_len=TRAIN_SEQ,
                                      global_batch=TRAIN_BATCH))
    opt = OptimizerConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    ckdir = ROOT / "build" / "train_checkpoints"
    shutil.rmtree(ckdir, ignore_errors=True)

    def fresh(s):
        return model.init(torch.Generator(device="cuda").manual_seed(s),
                          "cuda")

    def timed(loop, ms):
        step_fn = loop.step_fn

        def run(*a):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = step_fn(*a)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
            return out
        loop.step_fn = run

    # (a) the uninterrupted run, then the crash and the resume
    torch.cuda.reset_peak_memory_stats()
    plain = TrainConfig(steps=TRAIN_STEPS, checkpoint_every=100,
                        optimizer=opt, log_every=1)
    loop = TrainLoop(model, data, plain, params=fresh(seed))
    n_params = param_count(loop.params)
    step_ms = []
    timed(loop, step_ms)
    ref = loop.run()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             data.global_batch_at(TRAIN_STEPS).items()}
    prof = profile_step(torch, lambda: loop.step_fn(
        loop.params, loop.opt_state, loop.err_state, batch))
    del loop
    gc.collect()
    torch.cuda.empty_cache()

    ck = TrainConfig(steps=TRAIN_STEPS, checkpoint_every=4,
                     checkpoint_dir=str(ckdir), optimizer=opt, log_every=1)
    loop = TrainLoop(model, data, ck, params=fresh(seed))
    t = time.perf_counter()
    try:
        loop.run(crash_after_step=TRAIN_CRASH)
        raise PhaseFailed("train: the injected crash did not happen")
    except RuntimeError as e:
        check("injected crash" in str(e), f"train: {e}")
    crash_s = time.perf_counter() - t
    check(latest_step(str(ckdir)) == TRAIN_CRASH,
          f"train: newest commit {latest_step(str(ckdir))}, expected "
          f"{TRAIN_CRASH}")
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    loop = TrainLoop(model, data, ck, params=fresh(seed + 1))
    resume_s = time.perf_counter() - t
    check(loop.start_step == TRAIN_CRASH,
          f"train: resumed at {loop.start_step}")
    resumed = loop.run()
    check([e["step"] for e in resumed] == list(range(TRAIN_CRASH,
                                                     TRAIN_STEPS)),
          f"train: resumed steps {[e['step'] for e in resumed]}")
    check(latest_step(str(ckdir)) == TRAIN_STEPS, "train: no step-8 commit")
    diffs = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
             for a, b in zip(resumed, ref[TRAIN_CRASH:])]
    check(max(diffs) <= RESUME_RTOL,
          f"train: resumed losses {[e['loss'] for e in resumed]} against "
          f"{[e['loss'] for e in ref[TRAIN_CRASH:]]}")
    check(all(np.isfinite(e["loss"]) and e["skipped"] == 0.0
              for e in ref + resumed), "train: a non-finite or skipped step")
    trained = {T.key_of(p): T.stacked(leaf).detach().clone() for p, leaf in
               T.leaves_with_paths(param_tree(loop.params))}
    del loop
    gc.collect()
    torch.cuda.empty_cache()
    ms = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    dev_ms, wall_ms, n_kernels, top = prof
    print(f"train (a): tinyllama-1.1b full width and depth ({cfg.num_layers} "
          f"layers, d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
          f"heads, dh={cfg.head_dim}, d_ff={cfg.d_ff}, vocab "
          f"{cfg.vocab_size}), {n_params / 1e9:.3f} B params {cfg.dtype}, "
          f"moments float32; batch {TRAIN_BATCH} x {TRAIN_SEQ}; step "
          f"{ms:.2f} ms (median of steps 1-{TRAIN_STEPS - 1}, host clock, "
          f"synchronised; step 0 {step_ms[0]:.1f} ms), "
          f"{TRAIN_BATCH * TRAIN_SEQ / ms * 1e3:.0f} tokens/s; one step "
          f"under torch.profiler {dev_ms:.2f} ms of kernels in {wall_ms:.2f} "
          f"ms ({100 * dev_ms / wall_ms:.0f} % busy), {n_kernels} kernel "
          f"launches, most device time in {top}; peak memory "
          f"{peak_gb:.2f} GB; losses "
          + " ".join(f"{e['loss']:.4f}" for e in ref)
          + f"; crash after step {TRAIN_CRASH} ({crash_s:.1f} s with the "
          f"step-{TRAIN_CRASH} checkpoint), resume {resume_s:.1f} s, steps "
          f"{TRAIN_CRASH}-{TRAIN_STEPS - 1} "
          + " ".join(f"{e['loss']:.4f}" for e in resumed)
          + f", largest difference from the uninterrupted run "
          f"{max(diffs):.3g} relative (limit {RESUME_RTOL}; "
          f"{'bit for bit' if max(diffs) == 0 else 'not bit for bit'}); "
          f"card {card}")

    # (b) both compressors at full width
    parts = []
    for kind in ("int8", "topk"):
        comp = CompressorConfig(kind=kind)
        loop = TrainLoop(model, data, TrainConfig(
            steps=2, checkpoint_every=100, optimizer=opt, compressor=comp,
            log_every=1), params=fresh(seed))
        kind_ms = []
        timed(loop, kind_ms)
        logs = loop.run()
        check(all(np.isfinite(e["loss"]) and e["skipped"] == 0.0
                  for e in logs), f"train (b): {kind} gave {logs}")
        tree = param_tree(loop.params)
        parts.append(
            f"{kind}: losses {logs[0]['loss']:.4f} {logs[1]['loss']:.4f}, "
            f"skipped 0, step {kind_ms[-1]:.1f} ms, wire bytes a step "
            f"{compressed_bytes(tree, comp):.4g} of dense "
            f"{compressed_bytes(tree, CompressorConfig('none')):.4g}")
        del loop, tree
        gc.collect()
        torch.cuda.empty_cache()
    print("train (b): full width, 2 steps each (topk ratio "
          f"{CompressorConfig('topk').topk_ratio}): " + "; ".join(parts))

    # (c) the reference's end-to-end example through the launcher
    t = time.perf_counter()
    logs = train_launch.main(["--arch", "tinyllama-1.1b", "--reduce", "100m",
                              "--steps", str(TRAIN_100M_STEPS), "--device",
                              "cuda", "--seed", str(seed)])
    e2e_s = time.perf_counter() - t
    first, last = logs[0]["loss"], logs[-1]["loss"]
    check(last < first - 1.0,
          f"train (c): --reduce 100m loss {first} -> {last} did not fall")
    print(f"train (c): python -m repro_torch.launch.train --arch "
          f"tinyllama-1.1b --reduce 100m --steps {TRAIN_100M_STEPS}: loss "
          f"{first:.4f} -> {last:.4f} (accuracy {logs[0]['accuracy']:.4f} -> "
          f"{logs[-1]['accuracy']:.4f}) in {e2e_s:.1f} s, "
          f"{1e3 * e2e_s / TRAIN_100M_STEPS:.1f} ms a step with set-up")
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the trained checkpoint through the kernels
    params = fresh(seed + 2)
    tree = param_tree(params)
    restored = restore(str(ckdir), TRAIN_STEPS, {"params": tree})["params"]
    with torch.no_grad():
        for a, b in zip(T.tensors(tree), T.tensors(restored)):
            a.copy_(b)
    del restored
    same = all(torch.equal(T.stacked(leaf), trained[T.key_of(p)])
               for p, leaf in T.leaves_with_paths(tree))
    check(same, "train (d): the restored params differ from the trained")
    del trained
    B, S, page = TRAIN_PROMPTS, TRAIN_SEQ, 16
    mp = (S + TRAIN_DECODE) // page + 1
    cache = model.init_cache(B * mp, page, device="cuda")
    tables = torch.arange(B * mp, dtype=torch.int32, device="cuda") \
        .view(B, mp)
    tokens = torch.as_tensor(data.global_batch_at(1000)["tokens"][:B],
                             device="cuda")
    # each layer's kernel output on the trained activations against
    # its plain version on the same inputs (these comparisons launch
    # nothing), and flash against forward_train's dense attention
    attn_mod = importlib.import_module("repro_torch.models.attention")
    kernels = (attn_mod.flash_attention_bshd, attn_mod.paged_decode_attention)
    plain = (fa_mod.reference_attention, pa_mod.reference_paged_attention)
    ratios = {"flash": [], "paged": [], "dense": []}

    def flash_held(q, k, v, causal=True, window=None, softcap=None):
        out = kernels[0](q, k, v, causal=causal, window=window,
                         softcap=softcap)
        ref = plain[0](*(x.transpose(1, 2) for x in (q, k, v)),
                       causal=causal, window=window,
                       softcap=softcap).transpose(1, 2)
        ratios["flash"].append(value_scaled_ratio(out, ref, v))
        G = q.shape[2] // k.shape[2]
        pos = torch.arange(q.shape[1], device=q.device)
        dense = attn_mod.attend(q, attn_mod._repeat_kv(k, G),
                                attn_mod._repeat_kv(v, G),
                                attn_mod._mask_bias(pos, causal, window),
                                softcap)
        ratios["dense"].append(value_scaled_ratio(out, dense, v))
        return out

    def paged_held(q, kp, vp, bt, cl, softcap=None, window=None):
        out = kernels[1](q, kp, vp, bt, cl, softcap=softcap, window=window)
        ref = plain[1](q, kp, vp, bt, cl, softcap=softcap, window=window)
        ratios["paged"].append(value_scaled_ratio(out, ref, vp))
        return out

    plain_on_cuda = {"flash": 0, "paged": 0}
    saved = guard_plain(fa_mod, pa_mod, plain_on_cuda)
    attn_mod.flash_attention_bshd = flash_held
    attn_mod.paged_decode_attention = paged_held
    try:
        for fn in (fa_mod.flash_attention, pa_mod.paged_attention):
            fn.launches = 0
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        prefill_logits = model.prefill(params, tokens, cache, tables)
        logits, seq = prefill_logits, tokens
        for i in range(TRAIN_DECODE):
            nxt = logits[:, -1, :cfg.vocab_size].argmax(-1, keepdim=True)
            seq = torch.cat([seq, nxt], dim=1)
            logits = model.decode_step(
                params, nxt, cache, tables,
                torch.full((B,), S + i, dtype=torch.int32, device="cuda"))
        torch.cuda.synchronize()
        routes = {"flash": dict(fa_mod.flash_attention.route_launches),
                  "paged": dict(pa_mod.paged_attention.route_launches)}
    finally:
        attn_mod.flash_attention_bshd, attn_mod.paged_decode_attention = \
            kernels
        fa_mod.reference_attention, pa_mod.reference_paged_attention = saved
    pkey = paged_key(pa_mod, torch, cfg.head_dim,
                     cfg.num_heads // cfg.num_kv_heads)
    launches = {"flash_prefill": routes["flash"]["wgmma"],
                "paged_decode": routes["paged"][pkey]}
    # forward_train over the prompt and the generated tokens (position
    # S-1 is the prefill's, the last the last decode step's), in bf16
    # and on a float32 copy of the same weights: bf16's own drift
    V = cfg.vocab_size
    with torch.no_grad():
        full = model.forward_train(params, seq)[..., :V].float()
        full32 = model.forward_train(copy.deepcopy(params).float(),
                                     seq)[..., :V]

    def dist(a, b):
        return float((a.float() - b.float()).abs().max())

    finite = bool(torch.isfinite(prefill_logits[..., :V]).all()
                  and torch.isfinite(logits[..., :V]).all())
    agree = [float((x[:, S - 1:-1].argmax(-1) == seq[:, S:]).float().mean())
             for x in (full, full32)]
    print(f"train (d): step-{TRAIN_STEPS} checkpoint restored into a fresh "
          f"model (bit for bit); {B} prompts of {S} tokens, then "
          f"{TRAIN_DECODE} greedy decode steps; every layer's kernel output "
          f"against its plain version on the same inputs, |err| <= "
          f"{TOL_FAMILIES[0]}·max|v| + {TOL_FAMILIES[1]}·|ref|: flash "
          f"({len(ratios['flash'])} prefill layers, wgmma) largest "
          f"{max(ratios['flash']):.3g} of the limit, paged "
          f"({len(ratios['paged'])} layer-steps, {pkey}) largest "
          f"{max(ratios['paged']):.3g}; flash against forward_train's dense "
          f"attention (bf16 softmax weights) {max(ratios['dense']):.3g}; "
          f"end to end (not held: the model is chaotic at the reference's "
          f"init, fault C14): prefill's last-position logits "
          f"{dist(prefill_logits[:, 0, :V], full[:, S - 1]):.4g} from "
          f"forward_train's (max |logit| {float(full[:, S - 1].abs().max()):.4g}),"
          f" forward_train bf16 {dist(full[:, S - 1], full32[:, S - 1]):.4g} "
          f"from its float32 copy; the last decode step "
          f"{dist(logits[:, 0, :V], full[:, -1]):.4g} (bf16 against float32 "
          f"{dist(full[:, -1], full32[:, -1]):.4g}); the greedy tokens are "
          f"forward_train's argmax at {100 * agree[0]:.1f} % of positions "
          f"in bf16, {100 * agree[1]:.1f} % in float32; launches by route "
          f"{routes}; plain calls on CUDA {plain_on_cuda}")
    check(finite and tuple(prefill_logits.shape) == (B, 1, cfg.padded_vocab),
          "train (d): prefill logits not finite or of the wrong shape")
    check(launches["flash_prefill"] == cfg.num_layers
          and launches["paged_decode"] == cfg.num_layers * TRAIN_DECODE
          and sum(routes["flash"].values()) == cfg.num_layers
          and sum(routes["paged"].values()) == cfg.num_layers * TRAIN_DECODE,
          f"train (d): launches {routes}")
    check(not any(plain_on_cuda.values()),
          f"train (d): plain versions on CUDA tensors {plain_on_cuda}")
    check(len(ratios["flash"]) == cfg.num_layers
          and len(ratios["paged"]) == cfg.num_layers * TRAIN_DECODE
          and max(ratios["flash"] + ratios["paged"]) <= 1,
          f"train (d): kernels against their plain versions {ratios}")
    del full32
    del params, tree, cache, full, prefill_logits, logits
    shutil.rmtree(ckdir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()

    # (e) card against CPU
    print("train (e): card against CPU, float32: "
          + train_reference(torch, np, seed))
    print(f"train: phase {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- phase 11: model sharding --------------------------------------------------
#: the model_shard phase's serve launches: (label, arch, (data, model),
#: decode steps on the main path, decode steps of the check pass); on 8
#: ranks a collective costs ~18 ms (the ranks' processes time-slice the
#: card), so (b) takes fewer steps
MSHARD_SERVE = (("a", "qwen3-8b", (1, 2), 32, 4),
                ("b", "tinyllama-1.1b", (1, 8), 8, 2))
MSHARD_PROMPTS = 8
MSHARD_MOE = ("qwen3-moe-30b-a3b", (2, 2), 4)
MSHARD_TRAIN = ("tinyllama-1.1b", (2, 2), 8, 256)
MSHARD_TIMEOUT_S = 600.0
#: a sharded float32 layer against the single-device one on the same
#: input: |err| <= this · max|ref|, the CPU tests' bound on the logits
#: (only the order of the sums differs; at the reference's init the bf16
#: layers part ways on a rounding, fault C14)
MSHARD_F32_TOL = 1e-4
#: (d)'s float32 update checks, those of
#: tests/test_torch_model_shard_train.py: each leaf's p_new − p_old
#: within this share of its norm (a lost update is off by 1) ...
MSHARD_STEP_SHARE = 5e-2
#: ... and its first moment within this share of its largest element
MSHARD_MU_SHARE = 2e-3
#: one H100 SXM's NVLink 4 bandwidth each way (NVIDIA data sheet: 900
#: GB/s in all, both ways), the roofline's link term
NVLINK_BYTES_S = 450e9


def mshard_bound(flops: float, nbytes: float) -> tuple:
    """The least ms of ``flops`` bfloat16 operations and ``nbytes``
    moved on the card, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                       else "bytes")


def mshard_counts(fa_mod, pa_mod, reset: bool = False) -> dict:
    """The attention kernels' launches by route (set to 0 first with
    ``reset``)."""
    fns = (fa_mod.flash_attention, pa_mod.paged_attention)
    if reset:
        for fn in fns:
            fn.launches = 0
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
    return {"flash": dict(fns[0].route_launches),
            "paged": dict(fns[1].route_launches)}


def guard_partial(pa_mod, plain_on_cuda: dict):
    """As :func:`guard_plain`, for the partial route's plain version."""
    saved = pa_mod.reference_paged_attention_partial

    def wrapped(q, *a, **kw):
        plain_on_cuda["paged"] += int(q.is_cuda)
        return saved(q, *a, **kw)

    pa_mod.reference_paged_attention_partial = wrapped
    return saved


def mshard_prompts(np, seed: int, vocab: int) -> list:
    """The serve phase's prompts: the first MSHARD_PROMPTS of
    :func:`workload`, 32–512 tokens."""
    return [p for _, _, p, _ in workload(np, seed, MSHARD_PROMPTS, vocab)]


def mshard_serve_rank(label: str, arch: str, shape: tuple, n_decode: int,
                      n_check: int, seed: int) -> dict:
    """One rank of a model_shard serve launch: the whole model drawn from
    ``seed`` on the card, cut to this rank's compute view; the main path
    (each prompt prefilled, then ``n_decode`` greedy steps of all
    lanes, through ``prefill``/``decode_step`` with the mesh-ful
    runtime) with the kernels' launches counted by route; then a check
    pass of the same model in float32 (the prompts and ``n_check``
    decode steps) that holds every layer's sharded attention and MLP
    within ``MSHARD_F32_TOL``·max|ref| of rank 0's single-device
    float32 layer on the same input."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import kv_layout, make_plan, \
        shard_module
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import Runtime, build_model
    from repro_torch.models import attention as attn
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    fa_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    mesh = make_test_mesh(*shape).bind()
    cfg = get_config(arch)
    model = build_model(cfg)
    plan = make_plan(cfg, mesh, "serve")
    rt = plan.runtime()
    torch.cuda.reset_peak_memory_stats()
    full = model.init(torch.Generator(device="cuda").manual_seed(seed),
                      "cuda")
    local = shard_module(full, plan)
    if mesh.rank:
        del full
        full = None
    torch.cuda.empty_cache()
    prompts = mshard_prompts(np, seed, cfg.vocab_size)
    B, T = len(prompts), 16
    lens = [len(p) for p in prompts]
    unit = T * mesh.size
    max_seq = -(-(max(lens) + n_decode) // unit) * unit
    layout = kv_layout(plan, B, max_seq)
    mp = layout.block_len(mesh) // T
    cache = model.init_cache(B * mp, T, rt, "cuda", layout=layout)
    tables = torch.arange(B * mp, dtype=torch.int32,
                          device="cuda").reshape(B, mp)
    toks = [torch.tensor(p, device="cuda")[None] for p in prompts]
    pos0 = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def run(n_decode, state=None):
        """Prefill every prompt, then ``n_decode`` greedy steps; the
        tokens, and the host ms of each decode step with its
        collectives' host seconds."""
        first = []
        for b in range(B):
            if state is not None:
                state.update(mode="prefill", tables=tables[b:b + 1])
            lg = model.prefill(local, toks[b], cache, tables[b:b + 1], rt=rt)
            first.append(tf.greedy(local, lg, rt))
        nxt = torch.cat(first)                              # (B, 1)
        out, ms, coll = [nxt], [], []
        for t in range(n_decode):
            if state is not None:
                state.update(mode="decode", tables=tables, pos=pos0 + t)
            torch.cuda.synchronize()
            c0, t0 = mesh.tally["seconds"], time.perf_counter()
            lg = model.decode_step(local, nxt, cache, tables, pos0 + t,
                                   rt=rt)
            nxt = tf.greedy(local, lg, rt)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            coll.append(1e3 * (mesh.tally["seconds"] - c0))
            out.append(nxt)
        return torch.cat(out, dim=1), ms, coll

    # the main path, its launches counted
    plain_on_cuda = {"flash": 0, "paged": 0}
    saved = guard_plain(fa_mod, pa_mod, plain_on_cuda)
    saved_partial = guard_partial(pa_mod, plain_on_cuda)
    try:
        mshard_counts(fa_mod, pa_mod, reset=True)
        mesh.reset_tally()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, ms, coll = run(n_decode)
        wall = time.perf_counter() - t0
        counts = mshard_counts(fa_mod, pa_mod)
        tally = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in mesh.tally.items()}
    finally:
        fa_mod.reference_attention, pa_mod.reference_paged_attention = saved
        pa_mod.reference_paged_attention_partial = saved_partial
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the check pass, in float32: the sharded model's weights, each
    # rank's block of them, and a float32 cache, through the same
    # routes; each layer's attention and MLP, on the inputs the sharded
    # model gave them, against rank 0's single-device layer in float32
    del cache
    local.float()
    cache = model.init_cache(B * mp, T, plan.runtime(
        kv_cache_dtype="float32"), "cuda", layout=layout)
    torch.cuda.empty_cache()
    stats = {"attn": [], "mlp": []}
    state = {}
    if full is not None:
        fcache = model.init_cache(B * max_seq // T, T, Runtime(
            kv_cache_dtype="float32"), "cuda")
        ftables = torch.arange(B * max_seq // T, dtype=torch.int32,
                               device="cuda").reshape(B, -1)

    def single(i, h, y):
        """Layer i's attention on h and MLP on y on one device."""
        lay, j = full.layers[i], full.slots[i]
        p = {k: v.float() for k, v in lay.attn.items()}
        rows = ftables[state["tables"][:, 0] // mp]
        prefill_fn, decode_fn = originals[:2]       # not the recorders
        if state["mode"] == "prefill":
            a = prefill_fn(p, h, cfg, lay.kind, fcache.k[j], fcache.v[j],
                           rows)
        else:
            a = decode_fn(p, h, cfg, lay.kind, fcache.k[j], fcache.v[j],
                          rows, state["pos"])
        m = tf.mlp({k: v.float() for k, v in lay.mlp.items()}, y,
                   cfg.mlp_kind)
        return a, m

    index = {id(layer): i for i, layer in enumerate(local.layers)}
    index.update({id(layer.attn): i for i, layer in enumerate(local.layers)})
    probe = {}
    originals = (attn.prefill_attention, attn.decode_attention,
                 tf.Block.feed_forward)

    def recorded(fn, what):
        """``fn``, keeping each layer's input and output of it."""
        def wrapped(p, y, *a, **kw):
            out = fn(p, y, *a, **kw)
            probe.setdefault(index[id(p)], {})[what] = (y, out)
            return out
        return wrapped

    def hook(i):
        def fn(mod, args, out):
            (h, a), (y, m) = probe[i]["attn"], probe[i]["mlp"]
            for w, got, ref in zip(("attn", "mlp"), (a, m), single(i, h, y)):
                stats[w].append(float((got - ref).abs().max()) / (
                    MSHARD_F32_TOL * float(ref.abs().max())))
        return fn

    check(not cfg.is_moe, f"model_shard: the layer probe holds dense MLPs "
          f"({arch})")
    handles = ([layer.register_forward_hook(hook(i))
                for i, layer in enumerate(local.layers)]
               if full is not None else [])
    attn.prefill_attention = recorded(originals[0], "attn")
    attn.decode_attention = recorded(originals[1], "attn")
    tf.Block.feed_forward = recorded(originals[2], "mlp")
    try:
        check_tokens, _, _ = run(n_check, state)
    finally:
        (attn.prefill_attention, attn.decode_attention,
         tf.Block.feed_forward) = originals
        for h in handles:
            h.remove()
    return {"mesh": (mesh.size, mesh.rank), "layout": str(layout),
            "counts": counts, "plain_on_cuda": plain_on_cuda,
            "tokens": tokens.cpu().tolist(),
            "check_tokens": check_tokens.cpu().tolist(),
            "decode_ms": ms, "coll_ms": coll, "wall_s": wall,
            "tally": tally, "peak_gib": peak, "stats": stats,
            "lens": lens, "max_seq": max_seq, "layers": cfg.num_layers}


def mshard_moe_rank(arch: str, shape: tuple, layers: int, seed: int) -> dict:
    """One rank of the expert-parallel launch: the EP MLP of layer 0
    against the local ``moe_mlp`` on this rank's tokens with a capacity
    that drops nothing; then the cut model served (8 prompts of 32
    tokens, 4 decode steps) through the entry points, with each
    all-to-all's bytes."""
    import dataclasses as dc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import kv_layout, make_plan, \
        shard_module
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh(*shape).bind()
    cfg = dc.replace(get_config(arch), num_layers=layers)
    model = build_model(cfg)
    plan = make_plan(cfg, mesh, "serve")
    rt = plan.runtime()
    full = model.init(torch.Generator(device="cuda").manual_seed(seed),
                      "cuda")
    local = shard_module(full, plan)
    g = torch.Generator(device="cuda").manual_seed(seed + mesh.rank // 2)
    x = torch.randn(64, cfg.d_model, device="cuda", generator=g) \
        .to(torch.bfloat16)
    roomy = dc.replace(cfg, moe_capacity_factor=float(
        cfg.num_experts // cfg.experts_per_token))
    mesh.reset_tally()
    ep = moe_lib.moe_mlp_ep(local.layers[0].moe, x, roomy, rt)
    a2a = mesh.tally["bytes_by_kind"].get("all-to-all", 0)
    ref = moe_lib.moe_mlp(full.layers[0].moe, x, roomy)
    ratio = value_scaled_ratio(ep, ref, ref)
    del full
    torch.cuda.empty_cache()

    B, S, T = 8, 32, 16
    b = B // mesh.axis_size(rt.dp_axes)
    layout = kv_layout(plan, B, 64)
    mp = layout.block_len(mesh) // T
    cache = model.init_cache(b * mp, T, rt, "cuda", layout=layout)
    tables = torch.arange(b * mp, dtype=torch.int32,
                          device="cuda").reshape(b, mp)
    r = np.random.default_rng(seed + 1)
    tokens = torch.as_tensor(r.integers(0, cfg.vocab_size, (B, S)),
                             device="cuda")
    i = mesh.axis_index(rt.dp_axes)
    mesh.reset_tally()
    lg = model.prefill(local, tokens[i * b:(i + 1) * b], cache, tables,
                       rt=rt)
    prefill_a2a = dict(mesh.tally["bytes_by_kind"])
    nxt = tf.greedy(local, lg, rt)
    steps = []
    for t in range(4):
        mesh.reset_tally()
        lg = model.decode_step(local, nxt, cache, tables,
                               torch.full((b,), S + t, dtype=torch.int32,
                                          device="cuda"), rt=rt)
        nxt = tf.greedy(local, lg, rt)
        steps.append(mesh.tally["bytes_by_kind"].get("all-to-all", 0))
    torch.cuda.synchronize()
    return {"ratio": ratio, "ep_a2a": a2a,
            "experts": local.layers[0].moe["w_gate"].shape[0],
            "prefill_bytes": prefill_a2a, "decode_a2a": steps,
            "finite": bool(torch.isfinite(lg).all()),
            "layout": str(layout)}


def mshard_train_rank(arch: str, shape: tuple, B: int, S: int,
                      seed: int) -> dict:
    """One rank of the sharded-train launch: 2 float32 steps of the
    sharded step (FSDP over data, TP over model) on this rank's rows,
    held on rank 0 against 2 single-device float32 steps of the same
    model and batch (run first, their params and first moments kept on
    the host): the losses, the params, each leaf's update p_new − p_old
    and first moment, leaf by leaf; then 2 bfloat16 steps timed, with
    this rank's peak memory.  ``wq`` and ``wk`` are drawn at the fan-in
    d: the init's own fan-in (the heads, fault C14) makes attention
    near one-hot, and any two float32 orders of computation then put
    each token's nll a median ~15 % apart, which no bound on the loss or
    the update can hold."""
    import dataclasses as dc
    import math

    import numpy as np
    import torch
    from repro_torch import tree as T
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import NamedSharding, \
        gather_block, make_plan, shard_params
    from repro_torch.launch.mesh import axes_of, make_test_mesh
    from repro_torch.models import build_model, param_tree
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_loop import TrainConfig, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh(*shape).bind()
    r = np.random.default_rng(seed)
    batch = {k: torch.as_tensor(r.integers(0, get_config(arch).vocab_size,
                                           (B, S)), device="cuda")
             for k in ("tokens", "targets")}

    def host(tree) -> list:
        return [T.stacked(leaf).detach().to("cpu", torch.float32, copy=True)
                for _, leaf in T.leaves_with_paths(tree)]

    out = {}
    for dtype in ("float32", "bfloat16"):
        cfg = dc.replace(get_config(arch), dtype=dtype)
        model = build_model(cfg)
        plan = make_plan(cfg, mesh, "train")
        rt = plan.runtime()
        full = model.init(torch.Generator(device="cuda").manual_seed(seed),
                          "cuda")
        with torch.no_grad():
            for layer in full.layers:
                layer.attn["wq"].mul_(math.sqrt(cfg.num_heads / cfg.d_model))
                layer.attn["wk"].mul_(
                    math.sqrt(cfg.num_kv_heads / cfg.d_model))
        sp = shard_params(full, plan)
        single = None
        if dtype == "float32" and mesh.rank == 0:
            before = host(param_tree(full))
            step = make_train_step(model, TrainConfig())
            opt = adamw_init(param_tree(full))
            losses = []
            for _ in range(2):
                full, opt, _, m = step(full, opt, None, batch)
                losses.append(float(m["loss"]))
            single = {"losses": losses, "before": before,
                      "after": host(param_tree(full)), "mu": host(opt.mu)}
            del opt, m
        del full
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        n = B // mesh.axis_size(rt.dp_axes)
        i = mesh.axis_index(rt.dp_axes)
        rows = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
        step = make_train_step(model, TrainConfig(), rt)
        opt = adamw_init(sp.shards)
        losses, ms = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sp, opt, _, m = step(sp, opt, None, rows)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(float(m["loss"]))
        res = {"losses": losses, "ms": ms,
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        if dtype == "float32":
            # leaf by leaf: every rank gathers, rank 0 compares (in a
            # function, so that no leaf outlives its turn)
            held = {"param": 0.0, "step": 0.0, "mu": 0.0,
                    "least_update": math.inf, "swapped_mu": math.inf}

            def compare(j, p, mu, spec):
                got, got_mu = (T.stacked(gather_block(
                    x, NamedSharding(mesh, spec))).float() for x in (p, mu))
                if single is None:
                    return
                p0, p1, mu1 = (single[k][j].cuda()
                               for k in ("before", "after", "mu"))
                d1 = p1 - p0
                held["least_update"] = min(held["least_update"],
                                           float(d1.abs().max()))
                held["param"] = max(held["param"],
                                    limit_ratio(got, p1, 5e-3, 5e-2))
                held["step"] = max(held["step"], float(
                    (got - p0 - d1).norm() / d1.norm()))
                scale = float(mu1.abs().max())
                held["mu"] = max(held["mu"], float(
                    (got_mu - mu1).abs().max()) / scale)
                # a planted fault: the moment's FSDP blocks one data rank
                # along, which the bound must catch on every such leaf
                for dim, e in enumerate(spec):
                    if e is not None and set(axes_of(e)) <= set(rt.dp_axes):
                        blocks = got_mu.chunk(mesh.axis_size(e), dim)
                        moved = torch.cat(blocks[1:] + blocks[:1], dim)
                        held["swapped_mu"] = min(held["swapped_mu"], float(
                            (moved - mu1).abs().max()) / scale)
                        return

            for j, ((_, p), (_, mu), (_, spec)) in enumerate(zip(*(
                    T.leaves_with_paths(x)
                    for x in (sp.shards, opt.mu, sp.specs)))):
                compare(j, p, mu, spec)
            del p, mu
            if single is not None:
                res.update(single_losses=single["losses"], held=held)
        out[dtype] = res
        del sp, opt
        torch.cuda.empty_cache()
    return out


def mshard_plain_ms(timer, name: str, fn) -> float:
    """A plain version's device time; where its host time outruns the
    device wait, the serial timer's (host time inside the window)."""
    try:
        return timer.ms(fn)
    except PhaseFailed:
        print(f"model_shard: {name}'s plain version timed with the serial "
              "timer (its host never got ahead of the device)")
        return timer.serial_ms(fn)


def mshard_kernel_rows(torch, seed: int, launches: dict) -> list:
    """The kernel JSON's rows at the model_shard phase's new shapes:
    flash at qwen3-8b's 16 local query heads over 4 kv heads (G 4) on 1×2,
    the paged kernel at the same heads, and the partial route at
    tinyllama-1.1b's 1×8 (one rank's block of 8 lanes, all 32 heads over
    4 kv heads), each on the route ``route()`` names against its plain
    version and SDPA on the same inputs, and beside the split route
    forced in the same call (``split_ms``); the partial route also on a
    window that straddles two ranks' blocks and on a rank whose block is
    empty (o 0, lse −inf)."""
    import math as m

    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, \
        reference_attention
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_attention_partial, paged_decode_attention,
        reference_paged_attention, reference_paged_attention_partial)
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    bf16 = torch.bfloat16
    rows = []

    # flash: one 498-token prefill on one rank of qwen3-8b at tp 2
    H, Hkv, dh, S = 16, 4, 128, 498
    q, k, v = (torch.randn(1, h, S, dh, device="cuda", generator=g).to(bf16)
               for h in (H, Hkv, Hkv))
    o = torch.empty_like(q)
    out = flash_attention(q, k, v, causal=True, out=o)
    ref = reference_attention(q, k, v, causal=True)
    err, ok = max_err(torch, out, ref, "bfloat16")
    check(ok, f"model_shard: flash at G 4 / 16 local heads off its plain "
          f"version by {err}")
    b_ms, b_by = mshard_bound(4.0 * H * dh * S * (S + 1) / 2,
                              2.0 * (2 * H + 2 * Hkv) * S * dh)
    rows.append({
        "name": "flash_prefill_tp2", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU, "launches": launches["flash_prefill_tp2"],
        "max_abs_err": err,
        "ms": timer.ms(lambda: flash_attention(q, k, v, causal=True, out=o)),
        "plain_ms": mshard_plain_ms(timer, "flash_prefill_tp2",
                                    lambda: reference_attention(
                                        q, k, v, causal=True)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
        "shape": f"B=1 H={H} H_kv={Hkv} S={S} dh={dh} bf16 causal "
                 "(one rank of qwen3-8b at tp 2)"})

    # paged: one decode step of 8 lanes on one rank of qwen3-8b at tp 2
    ctx = [int(c) for c in torch.randint(40, 545, (8,), generator=g,
                                         device="cuda")]
    mp = 576 // 16
    qd, kp, vp, bt, cl = paged_inputs(torch, g, 8, H, Hkv, dh, ctx, bf16,
                                      mp=mp)
    out = paged_decode_attention(qd, kp, vp, bt, cl)
    err, ok = max_err(torch, out, reference_paged_attention(
        qd, kp, vp, bt, cl), "bfloat16")
    check(ok, f"model_shard: paged at G 4 / 16 local heads off by {err}")
    live = sum(ctx)
    b_ms, b_by = mshard_bound(4.0 * H * dh * live,
                              2.0 * (2 * 8 * H * dh + 2 * live * Hkv * dh)
                              + 4.0 * (bt.numel() + 8))
    K = -(-max(ctx) // 16) * 16
    pages = bt[:, :K // 16].long().clamp_min(0)
    dk = kp[pages].reshape(8, K, Hkv, dh).transpose(1, 2)
    dv = vp[pages].reshape(8, K, Hkv, dh).transpose(1, 2)
    mask = (torch.arange(K, device="cuda")[None, :]
            < cl[:, None].long())[:, None, None, :]
    rows.append({
        "name": "paged_decode_tp2", "route": "cuda", "source": PAGED_SRC,
        "replaces": PAGED_TPU, "launches": launches["paged_decode_tp2"],
        "max_abs_err": err,
        "ms": timer.ms(lambda: paged_decode_attention(qd, kp, vp, bt, cl)),
        "plain_ms": mshard_plain_ms(timer, "paged_decode_tp2",
                                    lambda: reference_paged_attention(
                                        qd, kp, vp, bt, cl)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], dk, dv, attn_mask=mask, enable_gqa=True)),
        "split_ms": timer.ms(lambda: paged_attention(qd, kp, vp, bt, cl,
                                                     kernel="split")),
        "shape": f"B=8 H={H} H_kv={Hkv} dh={dh} T=16 max_pages={mp} "
                 f"ctx={ctx} bf16 (one rank of qwen3-8b at tp 2), "
                 f"{pa_mod.route(bf16, dh, H // Hkv)} route; split_ms: the "
                 "split route forced in the same call"})

    # the partial route: rank 3 of tinyllama-1.1b's 1×8 (positions
    # 192-255 of each lane's 512), 8 lanes
    H, Hkv, dh, L, T = 32, 4, 64, 64, 16
    off = 3 * L
    gctx = [0, 150, 192, 200, 230, 256, 300, 511]
    local = [min(max(c - off, 0), L) for c in gctx]
    qd, kp, vp, bt, _ = paged_inputs(torch, g, 8, H, Hkv, dh,
                                     [L] * 8, bf16, T=T, mp=L // T)
    cl = torch.tensor(gctx, dtype=torch.int32, device="cuda")
    koff = torch.full((8,), off, dtype=torch.int32, device="cuda")
    errs = []
    for window in (None, 40):
        o_k, l_k = paged_attention_partial(qd, kp, vp, bt, cl, koff,
                                           window=window)
        o_r, l_r = reference_paged_attention_partial(qd, kp, vp, bt, cl,
                                                     koff, window=window)
        live = torch.isfinite(l_r)
        check(bool((torch.isfinite(l_k) == live).all())
              and bool((o_k[~live] == 0).all()),
              f"model_shard: partial route's empty blocks (window "
              f"{window}): lse {l_k.tolist()}")
        e1, ok1 = max_err(torch, o_k, o_r, "bfloat16")
        e2, ok2 = max_err(torch, torch.where(live, l_k, 0.0),
                          torch.where(live, l_r, 0.0), "bfloat16")
        check(ok1 and ok2, f"model_shard: partial route (window {window}) "
              f"off its plain version: o {e1}, lse {e2}")
        errs.append(max(e1, e2))
    n_live = sum(local)
    b_ms, b_by = mshard_bound(4.0 * H * dh * n_live,
                              2.0 * 8 * H * dh + 2.0 * 2 * n_live * Hkv * dh
                              + 4.0 * 8 * H * (dh + 1)
                              + 4.0 * (bt.numel() + 16))
    pages = bt.long()
    dk = kp[pages].reshape(8, L, Hkv, dh).transpose(1, 2)
    dv = vp[pages].reshape(8, L, Hkv, dh).transpose(1, 2)
    lmask = (torch.arange(L, device="cuda")[None, :]
             < torch.tensor(local, device="cuda")[:, None])
    lmask[:, 0] |= True               # SDPA rows must see a key
    rows.append({
        "name": "paged_partial", "route": "cuda", "source": PAGED_SRC,
        "replaces": PAGED_TPU, "launches": launches["paged_partial"],
        "max_abs_err": max(errs),
        "ms": timer.ms(lambda: paged_attention_partial(qd, kp, vp, bt, cl,
                                                       koff)),
        "split_ms": timer.ms(lambda: paged_attention_partial(
            qd, kp, vp, bt, cl, koff, kernel="split")),
        "plain_ms": mshard_plain_ms(timer, "paged_partial",
                                    lambda: reference_paged_attention_partial(
                                        qd, kp, vp, bt, cl, koff)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], dk, dv, attn_mask=lmask[:, None, None, :],
            enable_gqa=True)),
        "shape": f"B=8 H={H} H_kv={Hkv} dh={dh} T={T}, one rank's block of "
                 f"{L} positions at offset {off}, global ctx={gctx} "
                 "(local {local}) bf16, {route} route (split_ms: the split "
                 "route forced in the same call); window 40 checked "
                 "too".format(
                     local=local, route=pa_mod.route(bf16, dh, H // Hkv))})
    return rows


#: (f) the RG-LRU, xLSTM and encoder-decoder families on one 1×2 launch,
#: in turn: (arch, prompts (count, shortest, longest + 1), greedy decode
#: steps on the main path, prompts and decode steps of the float32
#: check pass); recurrentgemma's prompts pass its 2,048-token window,
#: whisper's are decoder prompts over WHISPER_FRAMES frames each
MSHARD_FAMILIES = (("recurrentgemma-2b", (4, 2100, 2601), 8, 2, 2),
                   ("xlstm-350m", (4, 32, 65), 8, 2, 2),
                   ("whisper-small", (2, 8, 17), 8, 2, 2))
MSHARD_FAMILY_MESH = (1, 2)


def mshard_family_inputs(torch, np, seed: int, cfg, count: int, lo: int,
                         hi: int) -> tuple:
    """``count`` prompts with lengths in [lo, hi) and, for an
    encoder-decoder, their frames (bfloat16 on the card)."""
    r = np.random.default_rng(seed + 23)
    lens = [int(x) for x in r.integers(lo, hi, count)]
    toks = [torch.tensor([r.integers(0, cfg.vocab_size, k).tolist()],
                         device="cuda") for k in lens]
    frames = None
    if cfg.is_encoder_decoder:
        g = torch.Generator(device="cuda").manual_seed(seed + 23)
        frames = torch.randn(count, WHISPER_FRAMES, cfg.d_model,
                             device="cuda", generator=g).to(torch.bfloat16)
    return lens, toks, frames


def mshard_fan_in_d(torch, model) -> None:
    """Scale every attention layer's wq and wk to the fan-in d (C14: the
    init draws them at the head count's, 16× and 50× too large for
    recurrentgemma-2b's 10 and 1 heads, and its softmax is then so
    nearly one-hot that two float32 orders of a layer's sums pick other
    keys)."""
    d = model.cfg.d_model
    with torch.no_grad():
        for mod in model.modules():
            for name in ("attn", "self_attn", "cross_attn"):
                p = getattr(mod, name, None)
                if isinstance(p, torch.nn.ParameterDict):
                    for w in ("wq", "wk"):
                        p[w].mul_((p[w].shape[-2] / d) ** 0.5)


def mshard_family_one(mesh, arch: str, inputs: tuple, steps: int,
                      n_check: int, check_steps: int, seed: int) -> dict:
    """One model of (f) on this rank: drawn whole from ``seed`` on the
    card (wq and wk at the fan-in d: :func:`mshard_fan_in_d`) and cut to
    the rank's compute view; the main path (each prompt
    prefilled into its lane, then ``steps`` greedy steps of all lanes)
    with the attention kernels' launches counted by route; then the same
    weights in float32 over ``n_check`` prompts and ``check_steps``
    steps, where rank 0 holds every layer's sharded output against its
    single-device float32 layer on the same input (as (a)), the
    single-device layer carrying its own KV pages, recurrent state and
    cross K/V.  A layer is held on what it adds to its input:
    max |out − ref| ≤ MSHARD_F32_TOL · max |ref − in|."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import kv_layout, make_plan, \
        shard_module
    from repro_torch.models import LOCAL, Runtime, build_model
    from repro_torch.models import attention as attn
    from repro_torch.models import encdec as ed
    from repro_torch.models import transformer as tf
    fa_mod = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    cfg = get_config(arch)
    model = build_model(cfg)
    plan = make_plan(cfg, mesh, "serve")
    rt = plan.runtime()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    full = model.init(torch.Generator(device="cuda").manual_seed(seed),
                      "cuda")
    mshard_fan_in_d(torch, full)
    local = shard_module(full, plan)
    if mesh.rank:
        del full
        full = None
    torch.cuda.empty_cache()
    lens, toks, frames = inputs
    n, T = len(lens), 16
    unit = T * mesh.size
    max_seq = -(-(max(lens) + steps) // unit) * unit
    layout = kv_layout(plan, n, max_seq)
    mp = layout.block_len(mesh) // T
    tables = torch.arange(n * mp, dtype=torch.int32,
                          device="cuda").reshape(n, mp)
    pos0 = torch.tensor(lens, dtype=torch.int32, device="cuda")

    def run(cache, k, n_decode, state=None):
        """Prefill the first ``k`` prompts one by one into lanes 0..k-1,
        then ``n_decode`` greedy steps of the k together: the tokens,
        each decode step's host ms and its collectives' host ms."""
        first = []
        for b in range(k):
            if state is not None:
                state.update(mode="prefill", rows=slice(b, b + 1))
            ex = None if frames is None else frames[b:b + 1]
            lg = model.prefill(local, toks[b], cache, tables[b:b + 1],
                               lanes=torch.tensor([b], device="cuda"),
                               extra_embed=ex, rt=rt)
            first.append(tf.greedy(local, lg, rt))
        nxt = torch.cat(first)
        out, ms, coll = [nxt], [], []
        for t in range(n_decode):
            if state is not None:
                state.update(mode="decode", rows=slice(0, k),
                             pos=pos0[:k] + t)
            torch.cuda.synchronize()
            c0, t0 = mesh.tally["seconds"], time.perf_counter()
            lg = model.decode_step(local, nxt, cache, tables[:k],
                                   pos0[:k] + t, rt=rt)
            nxt = tf.greedy(local, lg, rt)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            coll.append(1e3 * (mesh.tally["seconds"] - c0))
            out.append(nxt)
        return torch.cat(out, dim=1), ms, coll

    # the main path, its launches counted
    cache = model.init_cache(n * mp, T, rt, "cuda", lanes=n, layout=layout)
    plain_on_cuda = {"flash": 0, "paged": 0}
    saved = guard_plain(fa_mod, pa_mod, plain_on_cuda)
    saved_partial = guard_partial(pa_mod, plain_on_cuda)
    try:
        mshard_counts(fa_mod, pa_mod, reset=True)
        mesh.reset_tally()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens, ms, coll = run(cache, n, steps)
        wall = time.perf_counter() - t0
        counts = mshard_counts(fa_mod, pa_mod)
        tally = {k: (dict(v) if isinstance(v, dict) else v)
                 for k, v in mesh.tally.items()}
    finally:
        fa_mod.reference_attention, pa_mod.reference_paged_attention = saved
        pa_mod.reference_paged_attention_partial = saved_partial
    peak = torch.cuda.max_memory_allocated() / 2**30

    # the check pass in float32 (the config's dtype too: the encoder
    # casts its frames to it)
    del cache
    cfg = dataclasses.replace(cfg, dtype="float32")
    local.float().cfg = cfg
    f32 = plan.runtime(kv_cache_dtype="float32")
    cache = model.init_cache(n * mp, T, f32, "cuda", lanes=n, layout=layout)
    torch.cuda.empty_cache()
    stats: dict = {}
    state: dict = {}
    hooks, originals = [], {}
    if full is not None:
        full.float().cfg = cfg
        fpages = n * max_seq // T
        fcache = model.init_cache(fpages, T, Runtime(kv_cache_dtype="float32"),
                                  "cuda", lanes=n)
        ftables = torch.arange(fpages, dtype=torch.int32,
                               device="cuda").reshape(n, -1)
        fcross = {}

        def attend_single(kind, j):
            rows = ftables[state["rows"]]
            k_pages, v_pages = fcache.k[j], fcache.v[j]
            if state["mode"] == "prefill":
                return lambda p, y: attn.prefill_attention(
                    p, y, cfg, kind, k_pages, v_pages, rows)
            return lambda p, y: attn.decode_attention(
                p, y, cfg, kind, k_pages, v_pages, rows, state["pos"])

        def single(stack, i, args):
            """Layer i of ``stack`` on one device, on the sharded
            layer's input."""
            x = args[0]
            rows = torch.arange(n, device="cuda")[state["rows"]]
            if stack == "enc":
                return full.enc_layers[i](x, cfg)
            if stack == "dec":
                return full.dec_layers[i](
                    x, cfg, attend_single("global", i),
                    {k: t[i][rows] for k, t in fcross.items()})
            lay, j = full.layers[i], full.slots[i]
            if lay.kind in tf.ATTN_KINDS:
                return lay(x, cfg, attend_single(lay.kind, j))
            return tf._recurrent(lay, x, cfg, fcache.state[j], rows,
                                 state["mode"] == "decode")

        def hook(stack, i, kind):
            def fn(mod, args, out):
                got = out[0] if isinstance(out, tuple) else out
                ref = single(stack, i, args)
                stats.setdefault(kind, []).append(
                    float((got - ref).abs().max()) / (MSHARD_F32_TOL * float(
                        (ref - args[0]).abs().max())))
            return fn

        if cfg.is_encoder_decoder:
            stacks = [("enc", local.enc_layers, "encoder"),
                      ("dec", local.dec_layers, "decoder")]
            originals["cross_kv"] = ed.cross_kv

            def cross_kv(m, enc_out, rt=LOCAL):
                # the single-device cross K/V of the sharded encoder's
                # output, kept in the prompt's lane
                one = originals["cross_kv"](full, enc_out)
                for k, t in one.items():
                    if k not in fcross:
                        fcross[k] = t.new_zeros((t.shape[0], n)
                                                + t.shape[2:])
                    fcross[k][:, state["rows"]] = t
                return originals["cross_kv"](m, enc_out, rt)

            ed.cross_kv = cross_kv
        else:
            stacks = [("dec-only", local.layers, None)]
        for stack, layers, kind in stacks:
            for i, layer in enumerate(layers):
                hooks.append(layer.register_forward_hook(
                    hook(stack, i, kind or layer.kind)))
    try:
        check_tokens, _, _ = run(cache, n_check, check_steps, state)
    finally:
        for h in hooks:
            h.remove()
        if "cross_kv" in originals:
            ed.cross_kv = originals["cross_kv"]
    del cache, local, full
    torch.cuda.empty_cache()
    return {"counts": counts, "plain_on_cuda": plain_on_cuda,
            "tokens": tokens.cpu().tolist(),
            "check_tokens": check_tokens.cpu().tolist(),
            "decode_ms": ms, "coll_ms": coll, "wall_s": wall,
            "tally": tally, "peak_gib": peak, "stats": stats, "lens": lens,
            "max_seq": max_seq, "block_len": layout.block_len(mesh),
            "layout": str(layout)}


def mshard_family_rank(seed: int) -> dict:
    """One rank of (f): the MSHARD_FAMILIES models in turn, each freed
    before the next."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_test_mesh(*MSHARD_FAMILY_MESH).bind()
    out = {}
    for arch, (count, lo, hi), steps, n_check, check_steps in \
            MSHARD_FAMILIES:
        t = time.perf_counter()
        inputs = mshard_family_inputs(torch, np, seed, get_config(arch),
                                      count, lo, hi)
        out[arch] = mshard_family_one(mesh, arch, inputs, steps, n_check,
                                      check_steps, seed)
        out[arch]["seconds"] = time.perf_counter() - t
    return out


def mshard_family_launches(cfg, steps: int, prompts: int) -> dict:
    """The attention kernels' launches a rank of (f) must count on its
    main path, by route: flash and paged on the routes ``route()`` names
    for the model's bf16 heads, paged in its partial form where the KV
    is sequence-sharded."""
    import torch
    from repro_torch.models import transformer as tf
    route = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention").route
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    heads_split = cfg.num_kv_heads % MSHARD_FAMILY_MESH[1] == 0
    if cfg.is_encoder_decoder:
        L = cfg.num_layers
        flash = prompts * (cfg.encoder_layers + 2 * L) + steps * L
        paged = steps * L
    else:
        n_attn = sum(k in tf.ATTN_KINDS for k in tf.layer_kinds(cfg))
        flash, paged = prompts * n_attn, steps * n_attn
    fr = route(torch.bfloat16, cfg.head_dim)
    pkey = paged_key(pa_mod, torch, cfg.head_dim,
                     cfg.num_heads // cfg.num_kv_heads,
                     partial=not heads_split)
    return {"flash": {r: flash if r == fr else 0
                      for r in ("wgmma", "scalar")},
            "paged": {r: paged if r == pkey else 0
                      for r in pa_mod.paged_attention.route_launches}}


def mshard_family_check(np, res: list, card: str) -> dict:
    """(f)'s checks and lines; the main paths' launches for the kernel
    rows."""
    from repro_torch.configs import get_config
    launches = {}
    for arch, (count, _, _), steps, n_check, check_steps in MSHARD_FAMILIES:
        cfg = get_config(arch)
        want = mshard_family_launches(cfg, steps, count)
        check(want["flash"]["scalar"] == 0,
              f"model_shard (f): {arch}'s bf16 flash at dh {cfg.head_dim} "
              "routes to the scalar kernel, not the tensor cores")
        for r, x in enumerate(res):
            got = x[arch]
            check(got["counts"] == want,
                  f"model_shard (f): {arch} rank {r} launches "
                  f"{got['counts']}, want {want}")
            check(not any(got["plain_on_cuda"].values()),
                  f"model_shard (f): {arch} plain versions on CUDA tensors "
                  f"{got['plain_on_cuda']}")
            check(got["tokens"] == res[0][arch]["tokens"]
                  and got["check_tokens"] == res[0][arch]["check_tokens"],
                  f"model_shard (f): {arch} rank {r}'s greedy tokens differ "
                  "from rank 0's")
        x = res[0][arch]
        # every layer at each prefill, the decoder's at each step too
        calls = cfg.num_layers * (n_check + check_steps) \
            + cfg.encoder_layers * n_check
        st = x["stats"]
        worst = {k: round(max(v), 4) for k, v in st.items()}
        check(sum(len(v) for v in st.values()) == calls
              and all(max(v) <= 1 for v in st.values()),
              f"model_shard (f): {arch} float32 layers against the "
              f"single-device ones: largest {worst} of {MSHARD_F32_TOL}"
              f"·max|ref − in| over {[len(v) for v in st.values()]} calls "
              f"(want {calls})")
        for k in ("flash", "paged"):
            for route, c in want[k].items():
                if c:
                    key = f"{arch} {k} {route}"
                    launches[key] = sum(y[arch]["counts"][k][route]
                                        for y in res)
        ms = float(np.median(x["decode_ms"]))
        share = sum(x["coll_ms"]) / sum(x["decode_ms"])
        enc = (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers
               else "")
        frames = (f" over {WHISPER_FRAMES} frames each"
                  if cfg.is_encoder_decoder else "")
        print(f"model_shard (f): {arch} ({cfg.num_layers} layers{enc}"
              f", d {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
              f"bf16) on {MSHARD_FAMILY_MESH[0]}x{MSHARD_FAMILY_MESH[1]} "
              f"ranks sharing the card, {x['layout']}; {count} prompts of "
              f"{x['lens']} tokens{frames} prefilled one by one, then "
              f"{steps} greedy steps of all lanes (cache {x['max_seq']} "
              f"positions): decode step "
              f"{ms:.2f} ms (median, host clock, rank 0), "
              f"{100 * share:.1f} % of it in the host-staged collectives "
              f"({x['tally']['counts']}); main path {x['wall_s']:.2f} s; "
              f"launches a rank {x['counts']}, the same greedy tokens on "
              f"every rank, no plain call on CUDA tensors; in float32, each "
              f"layer's sharded output against rank 0's single-device layer "
              f"on the same input over {calls} layer calls ({n_check} "
              f"prefills, {check_steps} decode steps): largest {worst} of "
              f"{MSHARD_F32_TOL}·max|ref − in|; peak memory a rank (main "
              f"path) {[round(y[arch]['peak_gib'], 2) for y in res]} GiB; "
              f"{x['seconds']:.1f} s on rank 0; card {card}")
    return launches


def mshard_family_rows(torch, seed: int, launches: dict, rg: dict,
                       steps: int) -> list:
    """The kernel JSON's rows at (f)'s new shapes, each against its plain
    version within TOL_FAMILIES and timed beside SDPA: flash at
    recurrentgemma-2b's 5 local query heads over its one KV head (dh
    256, window 2,048) on one rank of 1×2 at the main path's longest
    prompt, beside the scalar route it replaced, and the paged kernel's
    partial form (on the route ``route()`` names, beside the split route
    forced) over rank 0's block of the main path's
    sequence-sharded cache at dh 256 and G 10 (the
    query heads gathered over tp) at its last step's contexts, the
    window straddling the two ranks' blocks.  ``rg``: rank 0's result of
    recurrentgemma-2b on the main path (its prompts' ``lens``, its
    cache's ``max_seq`` and ``block_len``), ``steps`` its decode
    steps."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention, \
        reference_attention
    from repro_torch.kernels.paged_attention import (
        paged_attention_partial, reference_paged_attention_partial)
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    bf16, rows = torch.bfloat16, []

    # flash: the longest prompt's prefill on one rank of recurrentgemma
    # at tp 2 (the main path's prompts: mshard_family_inputs)
    H, Hkv, dh, S, W = 5, 1, 256, max(rg["lens"]), 2048
    q, k, v = (torch.randn(1, h, S, dh, device="cuda", generator=g).to(bf16)
               for h in (H, Hkv, Hkv))
    out = flash_attention(q, k, v, causal=True, window=W)
    ratio = limit_ratio(out, reference_attention(q, k, v, causal=True,
                                                 window=W), *TOL_FAMILIES)
    check(ratio <= 1, f"model_shard (f): flash at dh 256, 5/1 heads, window "
          f"{W} at {ratio:.3g} of TOL_FAMILIES")
    i = torch.arange(S, device="cuda")
    mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < W)
    pairs = int(mask.sum())
    b_ms, b_by = mshard_bound(4.0 * H * dh * pairs,
                              2.0 * (2 * H + 2 * Hkv) * S * dh)
    rows.append({
        "name": "flash_prefill_rg_tp2", "route": "cuda", "source": FLASH_SRC,
        "replaces": FLASH_TPU,
        "launches": launches["recurrentgemma-2b flash wgmma"],
        "max_abs_err": float((out.float() - reference_attention(
            q, k, v, causal=True, window=W).float()).abs().max()),
        "ms": timer.ms(lambda: flash_attention(q, k, v, causal=True,
                                               window=W)),
        "plain_ms": mshard_plain_ms(timer, "flash_prefill_rg_tp2",
                                    lambda: reference_attention(
                                        q, k, v, causal=True, window=W)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True)),
        "previous_ms": timer.ms(lambda: flash_attention(
            q, k, v, causal=True, window=W, kernel="scalar")),
        "previous": "scalar route (flash_prefill_bf16)",
        "shape": f"B=1 H={H} H_kv={Hkv} S={S} dh={dh} window={W} bf16 "
                 "causal, wgmma route (one rank of recurrentgemma-2b at "
                 "tp 2)"})

    # paged partial: rank 0's block of the lanes at the main path's last
    # step (each prompt and its decode steps), all 10 query heads over 1
    # KV head
    H, Hkv, L, T = 10, 1, rg["block_len"], 16
    gctx = [n + steps for n in rg["lens"]]
    B = len(gctx)
    local = [min(c, L) for c in gctx]
    qd, kp, vp, bt, _ = paged_inputs(torch, g, B, H, Hkv, dh, [L] * B, bf16,
                                     T=T, mp=L // T)
    cl = torch.tensor(gctx, dtype=torch.int32, device="cuda")
    errs = []
    for off in (0, L):
        koff = torch.full((B,), off, dtype=torch.int32, device="cuda")
        o_k, l_k = paged_attention_partial(qd, kp, vp, bt, cl, koff,
                                           window=W)
        o_r, l_r = reference_paged_attention_partial(qd, kp, vp, bt, cl,
                                                     koff, window=W)
        live = torch.isfinite(l_r)
        r1 = limit_ratio(o_k, o_r, *TOL_FAMILIES)
        r2 = limit_ratio(torch.where(live, l_k, 0.0),
                         torch.where(live, l_r, 0.0), *TOL_FAMILIES)
        check(r1 <= 1 and r2 <= 1 and bool(
            (torch.isfinite(l_k) == live).all()),
              f"model_shard (f): partial route at dh 256 / G 10 / window "
              f"{W}, block offset {off}: o {r1:.3g}, lse {r2:.3g} of "
              "TOL_FAMILIES")
        errs.append(float((o_k.float() - o_r.float()).abs().max()))
    koff = torch.zeros(B, dtype=torch.int32, device="cuda")
    n_live = sum(min(c, L) - max(c - W, 0) for c in gctx)
    b_ms, b_by = mshard_bound(4.0 * H * dh * n_live,
                              2.0 * B * H * dh + 2.0 * 2 * n_live * Hkv * dh
                              + 4.0 * B * H * (dh + 1)
                              + 4.0 * (bt.numel() + 2 * B))
    pages = bt.long()
    dk = kp[pages].reshape(B, L, Hkv, dh).transpose(1, 2)
    dv = vp[pages].reshape(B, L, Hkv, dh).transpose(1, 2)
    j = torch.arange(L, device="cuda")[None, :]
    c = cl[:, None].long()
    lmask = (j < c) & (j >= c - W)
    rows.append({
        "name": "paged_partial_rg", "route": "cuda", "source": PAGED_SRC,
        "replaces": PAGED_TPU,
        "launches": launches["recurrentgemma-2b paged "
                             + paged_key(pa_mod, torch, dh, H // Hkv, True)],
        "max_abs_err": max(errs),
        "ms": timer.ms(lambda: paged_attention_partial(
            qd, kp, vp, bt, cl, koff, window=W)),
        "split_ms": timer.ms(lambda: paged_attention_partial(
            qd, kp, vp, bt, cl, koff, window=W, kernel="split")),
        "plain_ms": mshard_plain_ms(
            timer, "paged_partial_rg",
            lambda: reference_paged_attention_partial(
                qd, kp, vp, bt, cl, koff, window=W)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": timer.ms(lambda: F.scaled_dot_product_attention(
            qd[:, :, None], dk, dv, attn_mask=lmask[:, None, None, :],
            enable_gqa=True)),
        "shape": f"B={B} H={H} H_kv={Hkv} dh={dh} T={T} window={W}, rank "
                 f"0's block of {L} positions of {rg['max_seq']} "
                 f"(recurrentgemma-2b on 1x2, the query heads gathered), "
                 f"global ctx={gctx} "
                 f"(local {local}) bf16, "
                 f"{pa_mod.route(bf16, dh, H // Hkv)} route (split_ms: the "
                 "split route forced in the same call); rank 1's block "
                 "checked too"})
    return rows


def phase_model_shard(torch, np, seed: int, card: str) -> tuple:
    """Model sharding on the card (see the module docstring); returns
    the kernel JSON's rows at its new shapes and (f)'s seconds."""
    from repro_torch.configs import get_config
    from repro_torch.core import shard_plane as sp
    from repro_torch.launch import dryrun, roofline
    pa_mod = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    launches = {}
    for label, arch, shape, steps, check_steps in MSHARD_SERVE:
        t = time.perf_counter()
        res = sp.launch_ranks(mshard_serve_rank, shape[0] * shape[1], label,
                              arch, shape, steps, check_steps, seed,
                              timeout=MSHARD_TIMEOUT_S)
        cfg = get_config(arch)
        L = res[0]["layers"]
        n_prefill = MSHARD_PROMPTS * L
        n_decode = steps * L
        for r, x in enumerate(res):
            c = x["counts"]
            check(c["flash"] == {"wgmma": n_prefill, "scalar": 0},
                  f"model_shard ({label}): rank {r} flash launches {c}")
            want = paged_key(pa_mod, torch, cfg.head_dim,
                             cfg.num_heads // cfg.num_kv_heads,
                             partial=label != "a")
            check(c["paged"][want] == n_decode
                  and sum(c["paged"].values()) == n_decode,
                  f"model_shard ({label}): rank {r} paged launches {c}")
            check(not any(x["plain_on_cuda"].values()),
                  f"model_shard ({label}): plain versions on CUDA tensors "
                  f"{x['plain_on_cuda']}")
            check(x["tokens"] == res[0]["tokens"]
                  and x["check_tokens"] == res[0]["check_tokens"],
                  f"model_shard ({label}): rank {r}'s greedy tokens differ "
                  "from rank 0's")
        st = res[0]["stats"]
        calls = MSHARD_PROMPTS * L + check_steps * L
        worst = {w: round(max(v), 4) for w, v in st.items()}
        check(all(len(v) == calls and max(v) <= 1 for v in st.values()),
              f"model_shard ({label}): float32 sublayers against the "
              f"single-device ones: largest {worst} of {MSHARD_F32_TOL}"
              f"·max|ref| over {[len(v) for v in st.values()]} calls")
        ms = np.median(res[0]["decode_ms"])
        share = sum(res[0]["coll_ms"]) / sum(res[0]["decode_ms"])
        counts = res[0]["tally"]["counts"]
        if label == "a":
            launches["flash_prefill_tp2"] = sum(
                x["counts"]["flash"]["wgmma"] for x in res)
            launches["paged_decode_tp2"] = sum(
                x["counts"]["paged"][want] for x in res)
        else:
            launches["paged_partial"] = sum(
                x["counts"]["paged"][want] for x in res)
        print(f"model_shard ({label}): {arch} ({L} layers, d "
              f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads, "
              f"bf16) on {shape[0]}x{shape[1]} ranks sharing the card, "
              f"{res[0]['layout']}; {MSHARD_PROMPTS} prompts of "
              f"{res[0]['lens']} tokens prefilled one by one, then "
              f"{steps} greedy steps of all lanes (cache "
              f"{res[0]['max_seq']} positions): decode step "
              f"{ms:.2f} ms (median, host clock, rank 0), "
              f"{100 * share:.1f} % of it in the host-staged collectives "
              f"({counts}); main path {res[0]['wall_s']:.2f} s; launches "
              f"a rank {res[0]['counts']}, the same greedy tokens on every "
              f"rank, no plain call on CUDA tensors; in float32, each "
              f"layer's sharded attention and MLP against rank 0's "
              f"single-device ones on the same inputs over {calls} layer "
              f"calls ({MSHARD_PROMPTS} prefills, {check_steps} decode "
              f"steps): largest {worst} of {MSHARD_F32_TOL}·max|ref|; peak "
              f"memory a rank (main path) "
              f"{[round(x['peak_gib'], 2) for x in res]} GiB; launch "
              f"{time.perf_counter() - t:.1f} s; card {card}")

    # (c) expert parallelism
    arch, shape, layers = MSHARD_MOE
    t = time.perf_counter()
    res = sp.launch_ranks(mshard_moe_rank, shape[0] * shape[1], arch, shape,
                          layers, seed, timeout=MSHARD_TIMEOUT_S)
    check(all(x["ratio"] <= 1 and x["finite"] for x in res),
          f"model_shard (c): moe_mlp_ep against moe_mlp "
          f"{[x['ratio'] for x in res]}")
    print(f"model_shard (c): {arch} cut to {layers} of its 48 layers at "
          f"full width (128 experts, d 2048, expert ffn 768) on "
          f"{shape[0]}x{shape[1]} ranks, {res[0]['experts']} experts a "
          f"rank: layer 0's moe_mlp_ep against moe_mlp on 64 tokens a data "
          f"rank (capacity factor 16, nothing dropped): largest "
          f"{max(x['ratio'] for x in res):.3g} of the limit, both "
          f"all-to-alls {res[0]['ep_a2a']} B a rank; served (8 prompts of "
          f"32 tokens, 4 greedy steps, {res[0]['layout']}): the prefill's "
          f"collectives {res[0]['prefill_bytes']} B a rank, a decode "
          f"step's all-to-alls {res[0]['decode_a2a']} B; launch "
          f"{time.perf_counter() - t:.1f} s; card {card}")

    # (d) the sharded train step
    arch, shape, B, S = MSHARD_TRAIN
    t = time.perf_counter()
    res = sp.launch_ranks(mshard_train_rank, shape[0] * shape[1], arch,
                          shape, B, S, seed, timeout=MSHARD_TIMEOUT_S)
    f32 = res[0]["float32"]
    held = f32["held"]
    rel = [abs(a - b) / abs(b) for a, b in zip(f32["losses"],
                                               f32["single_losses"])]
    # the reference test's bounds on the losses and the params; the
    # update and the first moments as tests/test_torch_model_shard_train.py
    # holds them, and the moments' FSDP blocks one data rank along (a
    # planted fault) failing that bound on every leaf that has them
    check(max(rel) <= 2e-3 and held["param"] <= 1
          and held["least_update"] > 0
          and held["step"] <= MSHARD_STEP_SHARE
          and held["mu"] <= MSHARD_MU_SHARE
          and held["swapped_mu"] > MSHARD_MU_SHARE,
          f"model_shard (d): sharded float32 steps against single-device: "
          f"losses {f32['losses']} vs {f32['single_losses']} (rel {rel}), "
          f"{held}")
    check(all(x["bfloat16"]["losses"] == res[0]["bfloat16"]["losses"]
              for x in res), "model_shard (d): ranks report other losses")
    print(f"model_shard (d): {arch} at full width and depth (wq, wk drawn "
          f"at the fan-in d) on {shape[0]}x{shape[1]} ranks (FSDP over "
          f"data, TP over model, ZeRO moments), {B} x {S} tokens: 2 "
          f"float32 steps, losses {f32['losses']} against single-device "
          f"{f32['single_losses']} (rel {rel[0]:.3g}, {rel[1]:.3g} of "
          f"2e-3); params {held['param']:.3g} of rtol 5e-2 / atol 5e-3; "
          f"each leaf's update within {held['step']:.3g} of its norm "
          f"(bound {MSHARD_STEP_SHARE}) and first moment within "
          f"{held['mu']:.3g} of its largest (bound {MSHARD_MU_SHARE}); "
          f"the moments' FSDP blocks one data rank along at least "
          f"{held['swapped_mu']:.3g}; float32 step ms {f32['ms']}; 2 "
          f"bfloat16 steps {res[0]['bfloat16']['ms']} ms (rank 0, host "
          f"clock), losses {res[0]['bfloat16']['losses']}; peak memory a "
          f"rank float32 {[round(x['float32']['peak_gib'], 2) for x in res]}"
          f" GiB, bfloat16 "
          f"{[round(x['bfloat16']['peak_gib'], 2) for x in res]}"
          f" GiB; launch {time.perf_counter() - t:.1f} s; card {card}")

    # (e) a production dry-run cell and its roofline under the card's peaks
    art = dryrun.run_cell("qwen3-8b", "decode_32k", False, verbose=False)
    row = roofline.analyze(art, peak_flops=PEAK_FLOPS["bfloat16"],
                           hbm_bw=HBM_BYTES_S, link_bw=NVLINK_BYTES_S)
    check(art["status"] == "ok" and row is not None,
          f"model_shard (e): dry-run {art.get('reason')}")
    print(f"model_shard (e): dry-run qwen3-8b decode_32k on 16x16 (meta, "
          f"rank 0): flops {art['flops']:.4g} a device, arguments "
          f"{art['argument_size_in_bytes']} B (cache paged "
          f"{art['cache_bytes']} B, dense {art['cache_bytes_dense']} B), "
          f"collectives {art['collectives']['bytes_by_kind']} B; roofline "
          f"under the H100 SXM data-sheet peaks (989e12 FLOP/s bf16, 3.35e12 "
          f"B/s HBM, 450e9 B/s NVLink each way): {row.row()}")

    # (f) the RG-LRU, xLSTM and encoder-decoder families on 1×2
    t = time.perf_counter()
    res = sp.launch_ranks(mshard_family_rank,
                          MSHARD_FAMILY_MESH[0] * MSHARD_FAMILY_MESH[1],
                          seed, timeout=MSHARD_TIMEOUT_S)
    family_launches = mshard_family_check(np, res, card)
    rows = mshard_kernel_rows(torch, seed, launches)
    arch, _, steps, _, _ = MSHARD_FAMILIES[0]
    rows += mshard_family_rows(torch, seed, family_launches, res[0][arch],
                               steps)
    f_seconds = time.perf_counter() - t
    print(f"model_shard (f): launch and kernel rows {f_seconds:.1f} s")
    print(f"model_shard: phase {time.perf_counter() - t_phase:.1f} s")
    return rows, f_seconds


# -- kernel report ----------------------------------------------------------------
def kernel_report(torch, seed: int, served: dict, errs: dict) -> list:
    """Times of each kernel, of the route it replaced (flash's scalar
    route as ``previous_ms``, paged's split route as ``split_ms``), of
    its plain version and of the library's attention at the serve path's
    shapes, beside the card's bound; then each kernel, that route and
    the library call once more with the serial timer of the first port,
    on a line of their own."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (
        flash_attention, reference_attention)
    from repro_torch.kernels.paged_attention import (
        paged_attention, paged_decode_attention, reference_paged_attention)

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
    qd, kp, vp, bt, cl = paged_inputs(torch, g, B, H, Hkv, dh, ctx, bf16,
                                      T=T, mp=mp)
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
        "split": lambda: paged_attention(qd, kp, vp, bt, cl, kernel="split"),
        "library": lambda: F.scaled_dot_product_attention(
            qs, dk, dv, attn_mask=mask, enable_gqa=True)}
    which = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention").route(
            bf16, dh, H // Hkv)
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
        "split_ms": timer.ms(calls["paged_decode"]["split"]),
        "shape": f"B={B} H={H} H_kv={Hkv} dh={dh} T={T} max_pages={mp} "
                 f"ctx={ctx} bf16, {which} route (split_ms: the split "
                 f"route forced); library over {K} keys",
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


# -- paged probe (``--paged-probe``) ---------------------------------------------
#: the paged decode shapes the probe times: (name, H, H_kv, dh, global
#: contexts, window, block) with block None for the plain call, else
#: (positions, offset) of the partial route's one block of each lane
PROBE_PAGED = (
    ("qwen3-8b G4 dh128", 32, 8, 128,
     (513, 450, 390, 330, 270, 210, 150, 102), None, None, None),
    ("qwen3-moe-30b-a3b G8 dh128", 32, 4, 128,
     (540, 470, 400, 330, 260, 190, 120, 60), None, None, None),
    ("recurrentgemma-2b G10 dh256 window 2048", 10, 1, 256,
     (2402, 2330, 2210, 2150, 120, 96, 70, 58), 2048, None, None),
    ("qwen3-moe-235b-a22b G16 dh128", 64, 4, 128,
     (4000, 3000, 2500, 2100, 2048, 1000, 300, 64), None, None, None),
    ("recurrentgemma-2b 1x2 partial G10 dh256 window 2048", 10, 1, 256,
     (2125, 2263, 2390, 2455), 2048, None, (1232, 0)),
    ("tinyllama-1.1b 1x8 partial G8 dh64", 32, 4, 64,
     (0, 150, 192, 200, 230, 256, 300, 511), None, None, (64, 192)),
    ("gemma2-9b global G2 dh256 softcap 50", 16, 8, 256,
     (4640, 4448, 4375, 4250, 4212, 544, 300, 100), None, 50.0, None),
    ("gemma2-9b local G2 dh256 window 4096 softcap 50", 16, 8, 256,
     (4640, 4448, 4375, 4250, 4212, 544, 300, 100), 4096, 50.0, None),
    ("internvl2-2b G2 dh128", 16, 8, 128,
     (535, 470, 400, 330, 260, 190, 120, 64), None, None, None),
    ("deepseek-7b G1 dh128", 32, 32, 128,
     (535, 470, 400, 330, 260, 190, 120, 64), None, None, None),
    ("whisper-small decoder G1 dh64", 12, 12, 64, (76, 60, 52, 44), None,
     None, None))
#: the group sizes of the probe's route sweep, and its (dh, H_kv,
#: contexts, window) settings
PROBE_GROUPS = (1, 2, 4, 8, 10, 16)
PROBE_SWEEP = ((64, 4, (511, 400, 300, 256, 200, 150, 100, 60), None),
               (128, 8, (513, 450, 390, 330, 270, 210, 150, 102), None),
               (256, 1, (2402, 2330, 2210, 2150, 120, 96, 70, 58), 2048))
#: the paged kernels' names as the profiler gives them
PAGED_PASSES = ("paged_split_kernel", "paged_group_kernel",
                "paged_merge_kernel")


def paged_spans(ctxs, window, block) -> list:
    """Each lane's live positions [lo, hi) in its block's (or its whole
    table's) local positions."""
    spans = []
    for c in ctxs:
        if block is None:
            spans.append((max(0, c - window) if window else 0, c))
        else:
            L, off = block
            hi = min(max(c - off, 0), L)
            lo = max(0, c - window - off) if window else 0
            spans.append((min(lo, hi), hi))
    return spans


def paged_sdpa(torch, q, kp, vp, bt, spans):
    """SDPA over each lane's live keys gathered dense (not timed); a
    lane with none sees its first key, as SDPA rows must see one."""
    import torch.nn.functional as F
    T = kp.shape[1]
    n = [hi - lo for lo, hi in spans]
    K = max(max(n), 1)
    idx = torch.stack([torch.arange(lo, lo + K, device="cuda")
                       .clamp(max=max(hi - 1, 0)) for lo, hi in spans])
    pages = bt.long().gather(1, (idx // T).clamp(max=bt.shape[1] - 1))
    dk = kp[pages.clamp_min(0), idx % T].transpose(1, 2)
    dv = vp[pages.clamp_min(0), idx % T].transpose(1, 2)
    mask = (torch.arange(K, device="cuda")[None, :]
            < torch.tensor(n, device="cuda")[:, None])
    mask[:, 0] = True
    qs = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(
        qs, dk, dv, attn_mask=mask[:, None, None, :], enable_gqa=True)


def pass_ms(torch, timer, fn, n: int = 20) -> dict:
    """Device ms a call of each paged kernel under ``torch.profiler``,
    over ``n`` calls each after the timer's L2 flush."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            timer.flush.zero_()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for k in PAGED_PASSES:
            if k in e.key:
                out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / n
    return out


def parent_paged_call(torch, lib, pa, q, kp, vp, bt, cl, window, cap,
                      koff):
    """A call of another build of ``paged_attention.cu``'s split entry
    (its C signature unchanged), allocating as the wrapper does."""
    B, H, dh = q.shape
    _, T, Hkv, _ = kp.shape
    mp = bt.shape[1]
    n_split = -(-mp // pa.pages_per_split(T))
    partial = koff is not None
    fn = getattr(lib, "paged_partial_bf16" if partial
                 else "paged_decode_bf16")
    fn.argtypes = pa._PARTIAL_ARGTYPES if partial else pa._ARGTYPES
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        part = torch.empty(B * Hkv * n_split * (H // Hkv) * (dh + 2),
                           dtype=torch.float32, device="cuda")
        if partial:
            o = torch.empty(q.shape, dtype=torch.float32, device="cuda")
            lse = torch.empty(q.shape[:2], dtype=torch.float32,
                              device="cuda")
            ptrs = [koff.data_ptr(), o.data_ptr(), lse.data_ptr()]
        else:
            o = torch.empty_like(q)
            ptrs = [o.data_ptr()]
        err = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), bt.data_ptr(),
                 cl.data_ptr(), *ptrs, part.data_ptr(), B, H, Hkv, T, dh,
                 mp, int(window or 0), float(cap or 0.0),
                 1.0 / math.sqrt(dh), stream)
        check(err == 0, f"paged probe: the parent's launch failed ({err})")
        return (o, lse) if partial else o
    return call


def paged_probe(torch, seed: int, parent: Path | None) -> dict:
    """The paged decode kernel alone: the registers and spills of every
    instance, each route against the plain version at the probe's
    shapes, each route's call and its passes timed beside SDPA and the
    bound (and, with ``parent``, another build of the same source's
    split route in turns: parent, this, this, parent), and both routes
    over group sizes 2-16.  Returns the rows."""
    import ctypes
    from repro_torch.kernels import build
    pa = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    proc = None
    if parent is not None:
        out = ROOT / "build" / "kernels" / "libpaged_probe_parent.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-o",
                                 str(out), str(parent)],
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
    lib = build.library("paged_attention")
    log = build.BUILD_LOG.get("paged_attention", (0.0, ""))[1]
    plib = None
    if proc is not None:
        plog, _ = proc.communicate()
        check(proc.returncode == 0, f"paged probe: nvcc failed for "
                                    f"{parent}:\n{plog}")
        plib = ctypes.CDLL(str(out))
    routes = ["split"] + (["group"] if hasattr(lib, "paged_group_bf16")
                          else [])
    regs = {}
    for chunk in log.split("Compiling entry function")[1:]:
        name = chunk.split("'")[1]
        if "paged_group_kernel" in name or "paged_merge_kernel" in name:
            found = ptxas_kernel(log, name)
            if found:
                regs[name] = found
    print(f"paged probe: routes {routes}; ptxas (registers, spill bytes) "
          f"{regs}", flush=True)
    check(all(sp == 0 for _, sp in regs.values()),
          f"paged probe: a kernel spills: {regs}")
    timer = Timer(torch)
    g = torch.Generator(device="cuda").manual_seed(seed + 29)
    bf16 = torch.bfloat16
    rows = []

    def call(rt, q, kp, vp, bt, cl, window, koff, cap=None):
        if koff is None:
            return lambda: pa.paged_attention(q, kp, vp, bt, cl, softcap=cap,
                                              window=window, kernel=rt)
        return lambda: pa.paged_attention_partial(q, kp, vp, bt, cl, koff,
                                                  softcap=cap, window=window,
                                                  kernel=rt)

    for name, H, Hkv, dh, ctxs, window, cap, block in PROBE_PAGED:
        B = len(ctxs)
        if block is None:
            q, kp, vp, bt, cl = paged_inputs(torch, g, B, H, Hkv, dh, ctxs,
                                             bf16)
            koff = None
            plain = pa.reference_paged_attention(q, kp, vp, bt, cl,
                                                 softcap=cap, window=window)
        else:
            L, off = block
            q, kp, vp, bt, _ = paged_inputs(torch, g, B, H, Hkv, dh,
                                            [L] * B, bf16, mp=L // 16)
            cl = torch.tensor(ctxs, dtype=torch.int32, device="cuda")
            koff = torch.full((B,), off, dtype=torch.int32, device="cuda")
            plain = pa.reference_paged_attention_partial(
                q, kp, vp, bt, cl, koff, softcap=cap, window=window)[0]
        spans = paged_spans(ctxs, window, block)
        live = sum(hi - lo for lo, hi in spans)
        out_bytes = (4.0 * B * H * (dh + 1) if block else 2.0 * B * H * dh)
        nbytes = (2.0 * B * H * dh + out_bytes + 4.0 * dh * live * Hkv
                  + 4.0 * (bt.numel() + 2 * B))
        t_ops = 4.0 * H * dh * live / PEAK_FLOPS["bfloat16"]
        t_bytes = nbytes / HBM_BYTES_S
        row = {"shape": name, "B": B, "live_tokens": live,
               "bound_ms": 1e3 * max(t_ops, t_bytes),
               "bound_by": "operations" if t_ops > t_bytes else "bytes"}
        fns = {rt: call(rt, q, kp, vp, bt, cl, window, koff, cap)
               for rt in routes}
        if plib is not None:
            fns["parent split"] = parent_paged_call(
                torch, plib, pa, q, kp, vp, bt, cl, window, cap, koff)
        for rt, fn in fns.items():
            out = fn()
            err, ok = max_err(torch, out if koff is None else out[0], plain,
                              "bfloat16")
            check(ok, f"paged probe {name}: {rt} off the plain version by "
                      f"{err}")
            row[f"{rt} max_abs_err"] = err
        order = (["parent split", "split", "split", "parent split"]
                 if plib is not None else ["split"])
        for rt in order:
            row.setdefault(f"{rt} ms", []).append(timer.ms(fns[rt]))
        for rt in routes[1:]:
            row[f"{rt} ms"] = [timer.ms(fns[rt])]
        for rt, fn in fns.items():
            row[f"{rt} passes ms"] = pass_ms(torch, timer, fn)
        row["sdpa ms"] = timer.ms(paged_sdpa(torch, q, kp, vp, bt, spans))
        rows.append(row)
        print(f"paged probe {name}: " + json.dumps(row), flush=True)

    for dh, Hkv, ctxs, window in PROBE_SWEEP:
        sweep = {"dh": dh, "H_kv": Hkv, "window": window}
        for G in PROBE_GROUPS:
            q, kp, vp, bt, cl = paged_inputs(torch, g, len(ctxs), G * Hkv,
                                             Hkv, dh, ctxs, bf16)
            for rt in routes:
                sweep[f"G{G} {rt} ms"] = timer.ms(
                    call(rt, q, kp, vp, bt, cl, window, None))
        rows.append(sweep)
        print("paged probe sweep: " + json.dumps(sweep), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--paged-probe", action="store_true",
                    help="build and probe the paged decode kernel only")
    ap.add_argument("--parent", type=Path, default=None,
                    help="with --paged-probe: another paged_attention.cu "
                         "whose split route is timed in turns")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "paged_probe.json",
                    help="with --paged-probe: where its rows go (JSON)")
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
    if args.paged_probe:
        try:
            print(f"card: {card_line()}", flush=True)
            rows = paged_probe(torch, args.seed, args.parent)
        except Exception:                 # noqa: BLE001 — report and fail
            traceback.print_exc()
            return 1
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))
        print(f"card: {card_line()}")
        return 0

    phase = "build"
    t0 = time.perf_counter()
    try:
        card = phase_build()["card"]
        phase = "analysis"
        t_analysis = time.perf_counter()
        analysis_launches = phase_analysis(torch, np, args.seed, card)
        analysis_s = time.perf_counter() - t_analysis
        phase = "kernels"
        errs = phase_kernels(torch, args.seed)
        phase = "control"
        phase_control(torch, np, args.seed)
        phase = "quantum"
        admit_report = phase_quantum(torch, np, args.seed, card)
        admit_report["launches_analysis_phase"] = analysis_launches
        phase = "planner"
        admit_report["launches_planner_phase"] = phase_planner(
            torch, np, args.seed, card)
        phase = "shard"
        admit_report["launches_shard_phase"] = phase_shard(
            torch, np, args.seed, card)
        phase = "serve"
        served = phase_serve(torch, np, args.seed, args.requests)
        phase_small_reference(torch, np, args.seed)
        phase = "profile"
        phase_profile(torch, np, args.seed, served)
        phase = "kernel report"
        report = kernel_report(torch, args.seed, served, errs)
        report.append(admit_report)
        served.clear()                    # free Qwen3-8B for the next phase
        phase = "families"
        t_families = time.perf_counter()
        report.extend(phase_families(torch, np, args.seed))
        phase = "train"
        t_train = time.perf_counter()
        train_launches = phase_train(torch, np, args.seed, card)
        for row in report[:2]:            # flash and paged on (d)'s path
            row["launches_train_phase"] = train_launches[row["name"]]
        phase = "model_shard"
        t_shard = time.perf_counter()
        rows, f_seconds = phase_model_shard(torch, np, args.seed, card)
        report.extend(rows)
        card = card_line()
        now = time.perf_counter()
        print(f"seconds: {now - t0:.1f} in all, of them analysis "
              f"{analysis_s:.1f}, families "
              f"{t_train - t_families:.1f}, train {t_shard - t_train:.1f}, "
              f"model_shard {now - t_shard:.1f} (its (f) "
              f"{f_seconds:.1f})")
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
