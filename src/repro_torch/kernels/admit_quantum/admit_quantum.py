"""Batched quantum admission: CUDA kernel for Hopper and its plain
version.

Replaces ``repro/core/vectorized.py::admit_quantum`` — there a jitted
``lax.fori_loop`` that XLA fuses into one device loop, not a Pallas
kernel.  The kernel (``csrc/admit_quantum.cu``, whose header says what
bounds it on the H100 and how the design answers) replays the §4.3
admission pipeline over one scheduling quantum in arrival order, each
request seeing the state the earlier ones left.  It has two routes,
picked by :func:`route` from the quantum's length: ``rounds`` groups
the requests by row and walks every row's chain in parallel with the
pool state frozen, committing the prefix that saw the true state, round
after round (:func:`reference_admit_rounds` is its CPU mirror, for the
tests); ``walk`` is one warp's serial walk, for short quanta and for the
tail that the rounds hand over.

:func:`admit_scan` dispatches on the device of its inputs: CPU tensors
take :func:`reference_admit_scan`, CUDA tensors launch the kernel or
raise.  ``admit_scan.launches`` counts kernel launches,
``admit_scan.route_launches`` counts them by route, and
``admit_scan.last_stats`` holds the last rounds or walk launch's round
count and where its serial walk started.

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
#: the ``rounds`` route hands the rest of a quantum to the serial walk
#: after MAX_ROUNDS rounds, or after a round that committed fewer than
#: MIN_COMMIT requests; quanta of fewer than WALK_BELOW requests take
#: the ``walk`` route from the start (``csrc/admit_quantum.cu`` says how
#: these were chosen)
MAX_ROUNDS = 32
MIN_COMMIT = 512
WALK_BELOW = 256
_ARGTYPES = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
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


def reference_admit_rounds(class_code, bound, baseline_kv, baseline_conc,
                           weights, bucket_level, in_flight, kv_in_use,
                           req_ent, req_tokens, req_kv, req_live, *,
                           pool_in_flight: int, pool_resident,
                           pool_conc_cap, running_min, slack_factor,
                           max_rounds: int = MAX_ROUNDS,
                           min_commit: int = MIN_COMMIT):
    """CPU mirror of the ``rounds`` route's algorithm, for the tests:
    (admitted, reason, weights, rounds, fallback_at), the decisions
    equal to :func:`reference_admit_scan`'s.

    The requests are grouped by row in arrival order (a stable sort).
    A round starts at the committed request ``s`` with the exact pool
    state.  Each row walks its requests from ``s`` on with that state
    frozen (only the row's bucket and KV move), then the commit point
    ``c`` is found: uncontended, one past the admit that makes the pool
    contended; contended, one past the first admit whose weight is below
    the running minimum; else the end.  Requests before ``c`` saw the
    true state, so their decisions and the rows' state after them are
    final (kept here from the walk; the kernel replays the admits).  After ``max_rounds`` rounds, or a round that committed fewer
    than ``min_commit`` requests, the rest is walked serially from the
    committed state (``fallback_at`` is where; -1 if never).
    ``max_rounds=0`` is the ``walk`` route: the serial walk alone."""
    f32 = np.float32
    n, m = class_code.shape[0], req_ent.shape[0]
    e = np.clip(req_ent.numpy().astype(np.int64), 0, max(n - 1, 0))
    cc = class_code.numpy()
    cap = f32(pool_conc_cap)
    sf = f32(slack_factor)
    r_lim = baseline_conc.numpy()
    r_eff = np.where((r_lim <= 0) & (cc == SPOT), cap, r_lim)
    conc = (r_eff <= 0) | (in_flight.numpy().astype(np.float32) < r_eff)
    burst_ok, shielded = BURSTOK[cc], PROTECTED[cc]
    ok_bound = bound.numpy()
    chi = baseline_kv.numpy()
    w = weights.numpy()
    tok, kvn, live = req_tokens.numpy(), req_kv.numpy(), req_live.numpy()
    free_slots = f32(pool_resident) < cap
    bucket = bucket_level.numpy().copy()
    kv = kv_in_use.numpy().copy()
    admitted = np.zeros(m, bool)
    reason = np.zeros(m, np.int32)
    # grouping: each row's requests contiguous, in arrival order
    order = np.argsort(e, kind="stable")
    start = np.searchsorted(e[order], np.arange(n + 1))
    ptr = start[:-1].copy()
    pool_infl = int(pool_in_flight)
    contended = bool(f32(pool_infl) > cap)
    run_min = f32(running_min)
    s, rounds, fallback_at = 0, 0, -1
    while s < m:
        if rounds == max_rounds or (rounds and s - last_s < min_commit):
            fallback_at = s
            break
        rounds += 1
        last_s = s
        # the row-level checks under the frozen pool state
        row_ok = ok_bound & (conc | (burst_ok & free_slots & (not contended)))
        row_prio = shielded | (not contended) | (w > run_min * sf)
        row_why = np.where(~ok_bound, 1, np.where(~row_ok, 2, 0))
        # speculative pass: the k-th request of every row at step k,
        # each row's bucket and KV after each position kept
        b, k_v = bucket.copy(), kv.copy()
        post_b = np.zeros(m, np.float32)
        post_kv = np.zeros(m, np.float32)
        lens = start[1:] - ptr
        for k in range(int(lens.max()) if n else 0):
            rows = np.flatnonzero(lens > k)
            p = ptr[rows] + k
            i = order[p]
            kv_new = k_v[rows] + kvn[i]
            fits = (b[rows] >= tok[i]) & ((chi[rows] <= 0)
                                          | (kv_new <= chi[rows]))
            why = np.where(row_why[rows] != 0, row_why[rows],
                           np.where(~fits, 3,
                                    np.where(~row_prio[rows], 4, 0)))
            admit = (why == 0) & live[i]
            reason[i] = why
            admitted[i] = admit
            b[rows] = np.where(admit, b[rows] + (-tok[i]), b[rows])
            k_v[rows] = np.where(admit, kv_new, k_v[rows])
            post_b[p], post_kv[p] = b[rows], k_v[rows]
        # the commit point
        rest = np.arange(s, m)
        took = admitted[s:]
        if not contended:
            count = np.cumsum(took, dtype=np.int64)
            flip = np.flatnonzero(
                (pool_infl + count).astype(np.float32) > cap)
            c = int(rest[flip[0]]) + 1 if flip.size else m
            ws = w[e[s:c]][took[:c - s]]
            for x in ws:                       # the serial min's order
                run_min = x if x < run_min else run_min
            pool_infl += int(took[:c - s].sum())
            contended = bool(flip.size)
        else:
            low = np.flatnonzero(took & (w[e[s:]] < run_min))
            c = int(rest[low[0]]) + 1 if low.size else m
            if low.size:
                run_min = w[e[c - 1]]
            pool_infl += int(took[:c - s].sum())
        # commit: each row's prefix before c, its state after it
        # (within a row the request indices rise, so it is a prefix)
        before = np.concatenate([[0], np.cumsum(order < c)])
        q = ptr + before[start[1:]] - before[ptr]
        moved = q > ptr
        bucket[moved] = post_b[q[moved] - 1]
        kv[moved] = post_kv[q[moved] - 1]
        ptr = q
        s = c
    # the serial walk of the rest (the fallback, or the walk route)
    for i in range(s, m):
        r = e[i]
        contended = contended or bool(f32(pool_infl) > cap)
        kv_new = kv[r] + kvn[i]
        ok_conc = conc[r] or (burst_ok[r] and free_slots and not contended)
        fits = bucket[r] >= tok[i] and (chi[r] <= 0 or kv_new <= chi[r])
        ok_prio = shielded[r] or not contended or w[r] > run_min * sf
        why = (1 if not ok_bound[r] else 2 if not ok_conc else
               3 if not fits else 4 if not ok_prio else 0)
        reason[i] = why
        admitted[i] = why == 0 and live[i]
        if admitted[i]:
            bucket[r] = bucket[r] + (-tok[i])
            kv[r] = kv_new
            pool_infl += 1
            run_min = w[r] if w[r] < run_min else run_min
    dev = req_ent.device
    return (torch.from_numpy(admitted).to(dev),
            torch.from_numpy(reason).to(dev),
            torch.from_numpy(w[e].astype(np.float32)).to(dev),
            rounds, fallback_at)


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


def route(m: int) -> str:
    """The route of a quantum of ``m`` requests on the card: the serial
    ``walk`` below ``WALK_BELOW`` requests, else ``rounds``."""
    return "walk" if m < WALK_BELOW else "rounds"


def admit_scan(class_code, bound, baseline_kv, baseline_conc, weights,
               bucket_level, in_flight, kv_in_use, req_ent, req_tokens,
               req_kv, req_live, *, pool_in_flight: int, pool_resident,
               pool_conc_cap, running_min, slack_factor, kernel=None):
    """(admitted, reason, weights of the requests) for one quantum; see
    the module docstring.  ``kernel`` forces a route on the card,
    ``"rounds"`` or ``"walk"``; by default :func:`route` picks it."""
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
    how = kernel or route(m)
    if how not in admit_scan.route_launches:
        raise ValueError(f"admit_quantum: unknown route {how!r}")
    ptrs = [t.data_ptr() for t in (*args, admitted, reason, prio)]
    pool = (int(pool_in_flight), float(np.float32(pool_resident)),
            float(np.float32(pool_conc_cap)), float(np.float32(running_min)),
            float(np.float32(slack_factor)))
    stream = torch.cuda.current_stream(dev).cuda_stream
    nbytes = build.function("admit_quantum", "admit_quantum_scratch_bytes",
                            [ctypes.c_int, ctypes.c_int],
                            restype=ctypes.c_longlong)(n, m)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    stats = torch.empty(5, dtype=torch.int32, device=dev)
    fn = build.function("admit_quantum", "admit_quantum_launch", _ARGTYPES)
    err = fn(*ptrs, scratch.data_ptr(), stats.data_ptr(), n, m, *pool,
             0 if how == "rounds" else 1, MAX_ROUNDS, MIN_COMMIT, stream)
    admit_scan.last_stats = stats
    build.check(err, "admit_quantum")
    admit_scan.launches += 1
    admit_scan.route_launches[how] += 1
    return admitted, reason, prio


#: kernel launches in total and by route
admit_scan.launches = 0
admit_scan.route_launches = {"rounds": 0, "walk": 0}
#: int32 [5] on the card, written by the last rounds or walk launch: the
#: rounds it ran, the request its serial walk started at (-1: none), and
#: SM clock cycles from the kernel's start to the end of the grouping, of
#: the rounds and of the serial walk (0 where a phase did not run)
admit_scan.last_stats = None
