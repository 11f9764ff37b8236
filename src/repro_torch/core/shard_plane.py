"""Sharded control plane — the row axis of the tick, the admission
quantum and the fleet plan split over the ranks of a
``torch.distributed`` process group.

Counterpart of ``repro/core/shard_plane.py``.  The reference is one
controller that ``shard_map``s the kernels over a device list; here
every rank runs the same program (SPMD) and holds one contiguous pow2
block of the rows (rank r holds block r), so one code path serves CPU
ranks, several ranks sharing one card, and ranks on separate cards:

* every per-row quantity (burst EWMA, Eq. 1 weights, debt gap, the
  water-filling want/take vectors) is computed on the rank that owns
  the row block — elementwise math shards embarrassingly;
* only the pool-level aggregates the math couples cross the ranks: the
  protected reserved floor, the water-filling round totals, the demand
  remainder.  Each tree reduction's block root goes to the host, is
  all-gathered over the group (gloo, on the CPU: S scalars a combine)
  and paired on up in rank order — :func:`control_plane.tree_sum` with
  ``mesh=``.  ``all_gather`` keeps every bit of a root (a ``-0.0``
  stays ``-0.0``), so the top of the tree is the single-device tree;
* decisions are BIT-IDENTICAL to the single-device kernels: the tick
  runs the SAME ``_tick_impl`` body (its explicit FMAs included), and
  the positional trees decompose exactly over equal pow2 blocks.

Admission (:func:`shard_admit_quantum`) splits into the part that
scales with rows and the part that scales with requests: the per-request
row gathers run on the ranks as one-hot sums (one ``all_reduce``: each
element has exactly one owner, so the sum is the gather — and turns a
``-0.0`` into ``+0.0``, as the reference's ``psum`` does), then every
rank replays the quantum on a COMPACTED state (each request's row
remapped to a dense id in request space) through the unmodified
``admit_quantum`` — the CUDA kernel on the card.

The collectives ride the CPU: NCCL refuses two ranks on one card and
gloo's CUDA tensors lack ``all_gather``, while what crosses the ranks is
a root or a request vector, never a row array.  ``row_mesh`` and every
collective here are called by all ranks in the same order.
:func:`launch_ranks` starts such a group of local ranks.
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.control_plane import (
    ControlState,
    _tick_impl,
    bucket_width,
    priority_rows,
)
from repro_torch.core.markers import device_kernel
from repro_torch.core.types import PriorityCoefficients
from repro_torch.core.vectorized import admit_quantum

#: the one mesh axis of the control plane — entitlement rows.
AXIS = "rows"


class RowMesh:
    """This rank's view of a 1-D mesh of ``size`` ranks over the row
    axis: ``group`` is the process group of the mesh, ``rank`` this
    process's place in it, which is also the row block it holds.
    ``combines`` counts the cross-rank combines made through it."""

    def __init__(self, group, size: int, rank: int) -> None:
        self.group = group
        self.size = size
        self.rank = rank
        self.combines = 0

    def block(self, n_rows: int) -> tuple[int, int]:
        """[lo, hi) of the rows this rank holds at width ``n_rows``."""
        b = n_rows // self.size
        return self.rank * b, (self.rank + 1) * b

    def _gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        self.combines += 1
        host = x.detach().cpu().contiguous()
        out = [torch.empty_like(host) for _ in range(self.size)]
        dist.all_gather(out, host, group=self.group)
        return out

    def gather_roots(self, *roots: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's copy of each root stacked on a new trailing axis
        in rank order, on the root's device: the leaves of the top
        trees.  The roots travel together as float64, which holds every
        f32, int32 and bool value exactly (a ``-0.0`` included)."""
        flat = torch.cat([r.reshape(-1).double() for r in roots])
        ranks = torch.stack(self._gather(flat), dim=-1)
        out, k = [], 0
        for r in roots:
            n = r.numel()
            out.append(ranks[k:k + n].reshape(*r.shape, self.size)
                       .to(device=r.device, dtype=r.dtype))
            k += n
        return out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise sum of ``x`` over the ranks, on ``x``'s device."""
        self.combines += 1
        host = x.detach().cpu().contiguous()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
        return host.to(x.device)


#: mesh cache, one per size: ``row_mesh`` makes process groups, which
#: every rank must do together, so each size is built once.
_MESH_CACHE: dict[int, RowMesh] = {}


def _pow2_floor(n: int) -> int:
    return 1 << (max(1, n).bit_length() - 1)


def row_mesh(n_devices: Optional[int] = None) -> RowMesh:
    """The cached ``rows`` mesh of ``n_devices`` ranks (default: the
    largest power of two the initialised group offers).  A mesh smaller
    than the group splits it into replicas of consecutive ranks, each a
    mesh of its own (``new_subgroups``), so every rank is in one."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("row_mesh needs an initialised "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if n_devices is None:
        n_devices = _pow2_floor(world)
    if n_devices > world:
        raise ValueError(
            f"row_mesh({n_devices}) exceeds the group's {world} ranks")
    if n_devices < 1 or n_devices & (n_devices - 1):
        raise ValueError(f"mesh size must be a power of two, got "
                         f"{n_devices}")
    mesh = _MESH_CACHE.get(n_devices)
    if mesh is None:
        if n_devices == world:
            group = dist.group.WORLD
        else:
            group, _ = dist.new_subgroups(group_size=n_devices)
        mesh = RowMesh(group, n_devices, dist.get_rank() % n_devices)
        _MESH_CACHE[n_devices] = mesh
    return mesh


def shard_width(n_rows: int, mesh: RowMesh) -> int:
    """Row pad width for a sharded dispatch: the pow2 bucket_width,
    floored at the mesh size so every rank owns an equal (pow2) block.
    Equal pow2 blocks are what make the tree reductions decompose
    exactly."""
    return max(bucket_width(n_rows), mesh.size)


def store_mesh(store) -> Optional[RowMesh]:
    """The mesh a resident store's rows are spread over, or None to
    stay on one device: requires a ``ShardedResidentStore`` and an
    initialised group of ≥ 2 ranks; the mesh never exceeds the store's
    shard count, so rank blocks align with free-list shards."""
    shards = getattr(store, "n_shards", 0)
    if shards < 2 or not (dist.is_available() and dist.is_initialized()):
        return None
    size = min(_pow2_floor(dist.get_world_size()), shards)
    if size < 2:
        return None
    return row_mesh(size)


def pool_mesh(pool) -> Optional[RowMesh]:
    """The mesh a pool's tick/admission should dispatch on, or None
    (see :func:`store_mesh`)."""
    return store_mesh(pool.store)


def gather_rows(mesh: RowMesh, *blocks: torch.Tensor) -> list[np.ndarray]:
    """Full rows as host arrays from every rank's blocks, in rank
    order — for the host truth that reads all rows (the pool's
    columns, its tick record)."""
    return [torch.cat(mesh._gather(b)).numpy() for b in blocks]


# -- the sharded tick ---------------------------------------------------------

@device_kernel(oracle="repro.core.control_plane.control_tick")
@torch.no_grad()
def shard_tick(state: ControlState, capacity_tps: torch.Tensor,
               measured_tps: torch.Tensor, used_kv: torch.Tensor,
               used_conc: torch.Tensor, demand_tps: torch.Tensor,
               avg_slo_ms: torch.Tensor,
               coeff: PriorityCoefficients = PriorityCoefficients(),
               *, mesh: RowMesh,
               ) -> tuple[ControlState, torch.Tensor, torch.Tensor]:
    """:func:`control_plane.control_tick` on this rank's row block:
    ``state`` and the row arguments are block r of a width that is a
    multiple of the mesh size (use :func:`shard_width`), the pool
    scalars are the same on every rank.  Returns this rank's block of
    the new state, allocations and weights; decisions are bit-identical
    to the single-device kernel."""
    n = state.n_rows
    if n < 1 or n & (n - 1):
        # a padded odd block would pair differently from the global tree
        raise ValueError(f"a rank's block must be a power of two rows, "
                         f"got {n}")
    return _tick_impl(state, capacity_tps, measured_tps, used_kv,
                      used_conc, demand_tps, avg_slo_ms, coeff, mesh=mesh)


# -- the sharded admission quantum --------------------------------------------

def _gather_block(mesh: RowMesh, state: ControlState, bucket, infl, kv,
                  w_rows, ents) -> list[torch.Tensor]:
    """Dense per-request gathers of every row quantity the sequential
    replay reads: each rank contributes the requests whose row it owns
    and zeros elsewhere, and one sum over the ranks is the gather.  The
    columns travel as one float64 stack (exact for f32, int32 and
    bool, and the sum of one value with zeros rounds nothing)."""
    n_local = state.n_rows
    loc = ents.long() - mesh.rank * n_local
    own = (loc >= 0) & (loc < n_local)
    li = loc.clamp(0, n_local - 1)
    cols = (w_rows, state.bound, state.class_code, state.baseline_conc,
            state.baseline_kv, bucket, infl, kv)
    stacked = torch.stack([torch.where(own, c[li].double(), 0.0)
                           for c in cols])
    summed = mesh.psum(stacked)
    return [summed[k].to(c.dtype) for k, c in enumerate(cols)]


@device_kernel(oracle="repro.core.vectorized.admit_quantum")
@torch.no_grad()
def shard_admit_quantum(arr: ControlState,
                        bucket_level: torch.Tensor,   # f32 [N/S]
                        in_flight: torch.Tensor,      # i32 [N/S]
                        kv_in_use: torch.Tensor,      # f32 [N/S]
                        pool_in_flight: int,
                        pool_conc_cap: float,
                        running_min_priority: float,
                        pool_avg_slo: float,
                        req_ent: torch.Tensor,        # i32 [M] global row
                        req_tokens: torch.Tensor,     # f32 [M]
                        req_kv: torch.Tensor,         # f32 [M]
                        pool_resident: Optional[int] = None,
                        req_live: Optional[torch.Tensor] = None,
                        weights: Optional[torch.Tensor] = None,  # [N/S]
                        coeff: PriorityCoefficients = PriorityCoefficients(),
                        slack: float = 0.0,
                        *, mesh: RowMesh,
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`vectorized.admit_quantum` with the row axis sharded: the
    row arguments (and ``weights``) are this rank's block, the request
    arguments are the whole quantum on every rank.

    The O(N) half — Eq. 1 weights (when not passed) and the per-request
    row gathers — runs on the blocks; the O(M) sequential replay then
    runs on every rank on a request-space COMPACTION of the touched
    rows: ``req_ent`` is remapped to dense ids (``torch.unique``, sorted,
    as the reference's ``jnp.unique``), the gathered row state is
    scattered into [M]-wide arrays, and the unmodified
    :func:`admit_quantum` replays the quantum on them.  Every value the
    replay reads and every f32 update it applies is the single-device
    kernel's, in the same order — decisions, deny reasons and returned
    priorities are bit-identical."""
    m = req_ent.shape[0]
    if weights is None:
        weights = priority_rows(
            arr, torch.tensor(pool_avg_slo, dtype=torch.float32,
                              device=arr.slo_ms.device), coeff)
    (req_w, bound_g, class_g, bconc_g, bkv_g,
     bucket_g, infl_g, kv_g) = _gather_block(
        mesh, arr, bucket_level, in_flight, kv_in_use, weights, req_ent)

    # at most M distinct rows appear in a quantum, so the replay never
    # touches an [N] array: its width is the (padded) quantum width
    _, inverse = torch.unique(req_ent, sorted=True, return_inverse=True)
    cids = inverse.to(torch.int32)

    def scatter(vals):
        # duplicate ids write identical values — deterministic
        return torch.zeros(m, dtype=vals.dtype,
                           device=vals.device).index_put_(
            (inverse,), vals)

    zeros_f = torch.zeros(m, dtype=torch.float32, device=req_ent.device)
    arr_c = ControlState(
        class_code=scatter(class_g),
        bound=scatter(bound_g),
        baseline_tps=zeros_f,
        baseline_kv=scatter(bkv_g),
        baseline_conc=scatter(bconc_g),
        slo_ms=torch.ones_like(zeros_f),
        burst=zeros_f,
        debt=zeros_f,
    )
    return admit_quantum(
        arr_c, scatter(bucket_g), scatter(infl_g), scatter(kv_g),
        pool_in_flight, pool_conc_cap, running_min_priority,
        pool_avg_slo, cids, req_tokens, req_kv,
        pool_resident=pool_resident, req_live=req_live,
        weights=scatter(req_w), coeff=coeff, slack=slack)


# -- the sharded fleet plan ---------------------------------------------------

@device_kernel(oracle="repro.core.fleet.plan_fleet")
@torch.no_grad()
def shard_plan_fleet(current: torch.Tensor, lo: torch.Tensor,
                     hi: torch.Tensor, per_tps: torch.Tensor,
                     per_kv: torch.Tensor, per_conc: torch.Tensor,
                     res_tps: torch.Tensor, res_kv: torch.Tensor,
                     res_conc: torch.Tensor, demand_tps: torch.Tensor,
                     ewma_prev: torch.Tensor, seeded: torch.Tensor,
                     low_ticks: torch.Tensor, config=None,
                     *, mesh: RowMesh,
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor, torch.Tensor]:
    """:func:`fleet.plan_fleet` with the POOL axis sharded: every
    argument is this rank's block of the pools, and so is every
    return.  The scale policy is per-pool elementwise (no cross-pool
    reduction, no collective), so each rank plans its block alone —
    trivially bit-identical; the rebalancer's cross-pool matching stays
    host-side."""
    # deferred: fleet → autoscaler → pool → resident → shard_plane
    # would cycle at import time
    from repro_torch.core.fleet import FleetPlannerConfig, plan_fleet
    if config is None:
        config = FleetPlannerConfig()
    return plan_fleet(current, lo, hi, per_tps, per_kv, per_conc,
                      res_tps, res_kv, res_conc, demand_tps, ewma_prev,
                      seeded, low_ticks, config=config)


# -- local ranks ---------------------------------------------------------------

def _rank_entry(fn, rank: int, size: int, tmp: str, results) -> None:
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)       # written by launch_ranks, this run
    dist.init_process_group("gloo", init_method="file://"
                            + os.path.join(tmp, "init"),
                            rank=rank, world_size=size)
    try:
        results.put((rank, True, fn(*args)))
        dist.barrier()          # no rank leaves while another still reads
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        dist.destroy_process_group()


def launch_ranks(fn, size: int, *args, timeout: float = 600.0) -> list:
    """Run ``fn(*args)`` on ``size`` local ranks of a new gloo group and
    return each rank's result, in rank order.  The ranks are processes
    of the ``spawn`` context (safe under a parent that holds a CUDA
    context), one thread each; ``fn`` must be importable.  A rank that
    fails raises here with its traceback; ranks that have not all
    reported within ``timeout`` seconds (a hang at a collective) raise
    ``TimeoutError``.  No rank outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    # the gloo file store deletes its file as the last rank leaves, which
    # can race the directory's removal
    with tempfile.TemporaryDirectory(ignore_cleanup_errors=True) as tmp:
        # arguments go by file: a spawn start writes what it pickles to
        # a pipe the child reads only after its imports, so large
        # arguments would start the ranks one after another
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f)
        procs = [ctx.Process(target=_rank_entry, daemon=True,
                             args=(fn, r, size, tmp, results))
                 for r in range(size)]
        for p in procs:
            p.start()
        try:
            out: dict[int, object] = {}
            deadline = time.monotonic() + timeout
            while len(out) < size:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{size - len(out)} of {size} ranks did not "
                        f"finish within {timeout:.0f} s")
                try:
                    rank, ok, val = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"ranks exited before "
                                           f"reporting: {dead}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {size} failed:\n"
                                       f"{val}")
                out[rank] = val
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
    return [out[r] for r in range(size)]
