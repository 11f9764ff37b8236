#!/usr/bin/env python3
"""Check and time the flash prefill kernels on one card, outside the
smoke run.

    python3 flash_probe.py [--parent OLD.cu] [--seed 0]

Run from a checkout on a machine with one CUDA card and ``nvcc``.  It
builds ``src/repro_torch/kernels/csrc/flash_attention.cu`` and prints
the registers and spill bytes ``ptxas`` gives each tensor-core instance;
holds every route (``wgmma`` at dh 64, 128 and 256, ``scalar``) against
the plain version over ragged lengths, windows and a softcap, within the
bf16 tolerance and, at dh 256, within ``TOL_FAMILIES``; then times the
four dh 256 shapes the served models run (gemma2-9b at S 512 and 4,608,
recurrentgemma-2b at S 2,600 and one tp-2 rank of it at S 2,447) on the
tensor-core route beside the scalar route and SDPA, each windowed shape
also run with its window 64 tokens off, which must fail the limit.
With ``--parent``, another version of the same source (for example
``git show <rev>:src/repro_torch/kernels/csrc/flash_attention.cu``) is
built beside it and its tensor-core route is timed against this one's
at dh 64 and 128 in turns (parent, this, this, parent).  It exits 1 on
any failed check, and takes about a minute on an H100, builds included.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: (name, heads, KV heads, S, window, softcap) of the served dh 256 shapes
SHAPES = (("flash_prefill_dh256_s512", 16, 8, 512, 4096, 50.0),
          ("flash_prefill_dh256_s4608", 16, 8, 4608, 4096, 50.0),
          ("flash_prefill_dh256_g10_s2600", 10, 1, 2600, 2048, None),
          ("flash_prefill_rg_tp2", 5, 1, 2447, 2048, None))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("flash_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import (
        flash_attention, reference_attention)
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs.card_line()}", flush=True)

    parent = None
    if args.parent is not None:
        out = ROOT / "build" / "kernels" / "libflash_probe_parent.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out),
             str(args.parent)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    build.library("flash_attention")
    if args.parent is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"flash_probe: nvcc failed for {args.parent}:\n{log}",
                  file=sys.stderr)
            return 1
        parent = ctypes.CDLL(str(out)).flash_prefill_bf16_wgmma
        parent.argtypes = fa._ARGTYPES
    log = build.BUILD_LOG.get("flash_attention", (0.0, ""))[1]
    for dh in (64, 128, 256):
        found = cs.ptxas_kernel(log, f"flash_prefill_wgmma_kernelILi{dh}E")
        print(f"ptxas flash_prefill_wgmma_kernel<{dh}>: "
              + (f"{found[0]} registers, {found[1]} spill bytes" if found
                 else "not rebuilt in this process"))

    g = torch.Generator(device="cuda").manual_seed(args.seed)
    bf16 = torch.bfloat16
    fails = []

    def inputs(H, Hkv, S, dh):
        # (B, H, S, dh) views of (B, S, H, dh) tensors, as the models pass
        return [torch.randn(1, S, h, dh, device="cuda", generator=g)
                .to(bf16).transpose(1, 2) for h in (H, Hkv, Hkv)]

    worst = {}
    for dh, kernel in ((64, None), (128, None), (256, None),
                       (256, "scalar")):
        for S in (1, 3, 37, 63, 64, 65, 128, 130, 191, 300, 512):
            for window, cap in ((None, None), (40, None), (64, None),
                                (None, 50.0), (40, 50.0)):
                q, k, v = inputs(32, 8, S, dh)
                out = flash_attention(q, k, v, window=window, softcap=cap,
                                      kernel=kernel)
                torch.cuda.synchronize()
                ref = reference_attention(q, k, v, window=window,
                                          softcap=cap)
                err, ok = cs.max_err(torch, out, ref, "bfloat16")
                ratio = cs.limit_ratio(out, ref, *cs.TOL_FAMILIES)
                w = worst.setdefault(f"dh {dh} {kernel or fa.route(bf16, dh)}",
                                     [0.0, 0.0])
                w[0], w[1] = max(w[0], err), max(w[1], ratio)
                if not ok or (dh == 256 and ratio > 1):
                    fails.append((dh, kernel, S, window, cap, err, ratio))
    print("ragged cases (max |err|, largest reading of TOL_FAMILIES): "
          + "; ".join(f"{k} {v[0]:.3g}, {v[1]:.3g}"
                      for k, v in worst.items()))

    def call(fn, q, k, v, o):
        st = fa._STRIDES(*fa._strides(q), *fa._strides(k),
                         *fa._strides(v), *fa._strides(o))
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 1, q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                 q.shape[3], st, 1, 0, 0.0, 1.0 / math.sqrt(q.shape[3]),
                 torch.cuda.current_stream().cuda_stream)
        build.check(err, "parent flash")

    timer = cs.Timer(torch)
    slow = cs.Timer(torch, iters=10)
    for name, H, Hkv, S, W, cap in SHAPES:
        q, k, v = inputs(H, Hkv, S, 256)
        o = torch.empty_like(q)
        ref = reference_attention(q, k, v, window=W, softcap=cap)
        ratio = cs.limit_ratio(flash_attention(q, k, v, window=W,
                                               softcap=cap), ref,
                               *cs.TOL_FAMILIES)
        off = [cs.limit_ratio(flash_attention(q, k, v, window=W + d,
                                              softcap=cap), ref,
                              *cs.TOL_FAMILIES) for d in (-64, 64)]
        del ref
        if ratio > 1 or (S > W and min(off) <= 1):
            fails.append((name, ratio, off))
        i = torch.arange(S, device="cuda")
        mask = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < W)
        bound = 1e3 * 4.0 * H * 256 * int(mask.sum()) / cs.PEAK_FLOPS[
            "bfloat16"]
        t = slow if S > 512 else timer
        ms = t.ms(lambda: flash_attention(q, k, v, window=W, softcap=cap,
                                          out=o))
        scalar = slow.ms(lambda: flash_attention(
            q, k, v, window=W, softcap=cap, out=o, kernel="scalar"))
        sdpa = t.ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, enable_gqa=True))
        print(f"{name}: wgmma {ms:.5g} ms, scalar {scalar:.5g} ms "
              f"({scalar / ms:.3g}x), SDPA {sdpa:.5g} ms ({sdpa / ms:.3g}x), "
              f"operation bound {bound:.4g} ms; {ratio:.3g} of "
              f"TOL_FAMILIES, window off by 64 {min(off):.3g}"
              + (" (window past S: not checked)" if S <= W else ""),
              flush=True)

    if parent is not None:
        for H, Hkv, S, dh in ((32, 8, 498, 128), (32, 8, 2048, 128),
                              (12, 12, 1500, 64)):
            q, k, v = inputs(H, Hkv, S, dh)
            o = torch.empty_like(q)
            ts = [timer.ms(lambda: call(parent, q, k, v, o)),
                  timer.ms(lambda: flash_attention(q, k, v, out=o)),
                  timer.ms(lambda: flash_attention(q, k, v, out=o)),
                  timer.ms(lambda: call(parent, q, k, v, o))]
            print(f"wgmma dh {dh}, {H}/{Hkv} heads, S {S}, causal: parent, "
                  f"this, this, parent ms {[round(x, 5) for x in ts]}")
    print(f"card: {cs.card_line()}")
    if fails:
        print(f"flash_probe: failed {fails}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
