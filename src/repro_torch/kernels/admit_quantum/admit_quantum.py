"""Batched quantum admission: CUDA kernel for Hopper and its plain
version.

Replaces ``repro/core/vectorized.py::admit_quantum`` — there a jitted
``lax.fori_loop`` that XLA fuses into one device loop, not a Pallas
kernel.  The kernel (``csrc/admit_quantum.cu``, whose header says what
bounds it on the H100 and how the design answers) replays the §4.3
admission pipeline over one scheduling quantum in arrival order, each
request seeing the state the earlier ones left: one CTA gathers each
request's row-static inputs in parallel, one thread walks the serial
chain.

:func:`admit_scan` dispatches on the device of its inputs: CPU tensors
take :func:`reference_admit_scan`, CUDA tensors launch the kernel or
raise.  ``admit_scan.launches`` counts kernel launches.

Inputs (N entitlement rows, M requests):
  class_code int32 [N], bound bool [N], baseline_kv f32 [N],
  baseline_conc f32 [N], weights f32 [N] (Eq. 1), bucket_level f32 [N],
  in_flight int32 [N] (resident sequences), kv_in_use f32 [N];
  req_ent int32 [M] (row of each request, in range), req_tokens f32 [M],
  req_kv f32 [M], req_live bool [M] (False = padding);
  host scalars: pool_in_flight (int), pool_resident, pool_conc_cap,
  running_min (f32 values) and slack_factor (``1 - slack`` rounded to
  f32).
Outputs: admitted bool [M], reason int32 [M] (0 admitted, 1 not bound,
2 concurrency, 3 token budget or KV, 4 low priority) and the requests'
weights f32 [M], on the inputs' device.  No input is written.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

SPOT = 3                                 # CLASS_CODES[ServiceClass.SPOT]
#: per class code (dedicated, guaranteed, elastic, spot, preemptible)
PROTECTED = np.array([True, True, False, False, False])
BURSTOK = np.array([True, False, True, True, True])
_ARGTYPES = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 4 + [ctypes.c_void_p])
_ROWS = (("class_code", torch.int32), ("bound", torch.bool),
         ("baseline_kv", torch.float32), ("baseline_conc", torch.float32),
         ("weights", torch.float32), ("bucket_level", torch.float32),
         ("in_flight", torch.int32), ("kv_in_use", torch.float32))
_REQS = (("req_ent", torch.int32), ("req_tokens", torch.float32),
         ("req_kv", torch.float32), ("req_live", torch.bool))


def reference_admit_scan(class_code, bound, baseline_kv, baseline_conc,
                         weights, bucket_level, in_flight, kv_in_use,
                         req_ent, req_tokens, req_kv, req_live, *,
                         pool_in_flight: int, pool_resident, pool_conc_cap,
                         running_min, slack_factor):
    """Plain version: the row-static checks as numpy gathers, then the
    serial chain as a loop whose arithmetic is numpy float32 scalars
    (float64 would flip ties).  int32 against float32 compares convert
    the int to float32 first, as the reference does."""
    f32 = np.float32
    e = req_ent.numpy().astype(np.int64)
    cc = class_code.numpy()[e]
    ok_bound = bound.numpy()[e]
    cap = f32(pool_conc_cap)
    r_lim = baseline_conc.numpy()[e]
    r_eff = np.where((r_lim <= 0) & (cc == SPOT), cap, r_lim)
    infl = in_flight.numpy()[e].astype(np.float32)
    conc = (r_eff <= 0) | (infl < r_eff)
    burst_ok = BURSTOK[cc]
    shielded = PROTECTED[cc]
    chi = baseline_kv.numpy()[e]
    w = weights.numpy()[e]
    tok = req_tokens.numpy()
    kvn = req_kv.numpy()
    live = req_live.numpy()
    bucket = bucket_level.numpy().copy()
    kv = kv_in_use.numpy().copy()
    free_slots = f32(pool_resident) < cap
    sf = f32(slack_factor)
    pool_infl = int(pool_in_flight)
    run_min = f32(running_min)
    m = e.shape[0]
    admitted = np.zeros(m, bool)
    reason = np.zeros(m, np.int32)
    for i in range(m):
        r = e[i]
        b = bucket[r]
        kv_new = kv[r] + kvn[i]
        contended = f32(pool_infl) > cap
        ok_conc = conc[i] or (burst_ok[i] and free_slots and not contended)
        ok_budget = b >= tok[i]
        ok_kv = chi[i] <= 0 or kv_new <= chi[i]
        ok_prio = shielded[i] or not contended or w[i] > run_min * sf
        if not ok_bound[i]:
            reason[i] = 1
        elif not ok_conc:
            reason[i] = 2
        elif not (ok_budget and ok_kv):
            reason[i] = 3
        elif not ok_prio:
            reason[i] = 4
        elif live[i]:
            admitted[i] = True
            bucket[r] = b + (-tok[i])
            kv[r] = kv_new
            pool_infl += 1
            run_min = min(run_min, w[i])
    dev = req_ent.device
    return (torch.from_numpy(admitted).to(dev),
            torch.from_numpy(reason).to(dev),
            torch.from_numpy(w.astype(np.float32)).to(dev))


def _check(rows: dict, reqs: dict) -> None:
    n, m = rows["class_code"].shape[0], reqs["req_ent"].shape[0]
    for (name, dtype), t in zip(_ROWS + _REQS,
                                list(rows.values()) + list(reqs.values())):
        want = n if name in rows else m
        if (not t.is_cuda or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != (want,)):
            raise ValueError(f"admit_quantum: {name} must be a contiguous "
                             f"CUDA {dtype} tensor of shape ({want},), got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")


def admit_scan(class_code, bound, baseline_kv, baseline_conc, weights,
               bucket_level, in_flight, kv_in_use, req_ent, req_tokens,
               req_kv, req_live, *, pool_in_flight: int, pool_resident,
               pool_conc_cap, running_min, slack_factor):
    """(admitted, reason, weights of the requests) for one quantum; see
    the module docstring."""
    args = (class_code, bound, baseline_kv, baseline_conc, weights,
            bucket_level, in_flight, kv_in_use, req_ent, req_tokens, req_kv,
            req_live)
    scalars = dict(pool_in_flight=pool_in_flight,
                   pool_resident=pool_resident, pool_conc_cap=pool_conc_cap,
                   running_min=running_min, slack_factor=slack_factor)
    if not req_ent.is_cuda:
        return reference_admit_scan(*args, **scalars)
    rows = dict(zip((k for k, _ in _ROWS), args[:8]))
    reqs = dict(zip((k for k, _ in _REQS), args[8:]))
    _check(rows, reqs)
    n, m = class_code.shape[0], req_ent.shape[0]
    dev = req_ent.device
    admitted = torch.empty(m, dtype=torch.bool, device=dev)
    reason = torch.empty(m, dtype=torch.int32, device=dev)
    prio = torch.empty(m, dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        if m:
            raise ValueError("admit_quantum: requests against no rows")
        return admitted, reason, prio
    in_smem = build.function("admit_quantum", "admit_quantum_state_in_smem",
                             [ctypes.c_int])(n)
    scratch = None if in_smem else torch.empty(2 * n, dtype=torch.float32,
                                               device=dev)
    fn = build.function("admit_quantum", "admit_quantum_launch", _ARGTYPES)
    err = fn(*(t.data_ptr() for t in args), admitted.data_ptr(),
             reason.data_ptr(), prio.data_ptr(),
             None if scratch is None else scratch.data_ptr(), n, m,
             int(pool_in_flight), float(np.float32(pool_resident)),
             float(np.float32(pool_conc_cap)),
             float(np.float32(running_min)),
             float(np.float32(slack_factor)),
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "admit_quantum")
    admit_scan.launches += 1
    return admitted, reason, prio


admit_scan.launches = 0
