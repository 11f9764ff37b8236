"""Collectives over the axes of a :class:`~repro_torch.launch.mesh.ModelMesh`:
the port's explicit stand-in for what GSPMD inserts into the
reference's sharded programs.

Each is a ``torch.autograd.Function`` with the backward its use needs:

* :func:`all_reduce` — sum over the axis; backward the identity (what
  follows is replicated over the axis, so each rank's gradient of the
  sum is already the whole gradient: Megatron's row-parallel exit);
* :func:`replicate` — the identity; backward sums over the axis (a
  replicated tensor entering work split over the axis: Megatron's
  column-parallel entry);
* :func:`all_gather` ↔ :func:`reduce_scatter`, each the other's
  backward (what follows a gather is split over the axis, as the
  sequence- and data-split work is);
* :func:`all_to_all` — its backward the inverse exchange.

On an axis of one rank each is the identity.  On a bound mesh the data
travel through gloo on the CPU: a CUDA tensor is copied to the host,
reduced there and copied back (NCCL refuses two ranks on one card and
gloo's CUDA tensors lack ``all_gather``), and a failure raises.  A sum
of half-precision partials is taken in float32 and rounded once.  A
reduce-scatter is an all-reduce and a slice on the host (gloo's own is
not in every torch build); the tally counts it as the reduce-scatter it
stands for.  On an abstract mesh nothing is communicated: each
collective returns a tensor of the right shape (``meta`` tensors
included) and the mesh's ``tally`` records it.  The tally holds each
kind's result bytes a device, as the reference's dry-run reads them
from the HLO (``all-reduce``, ``all-gather``, ``reduce-scatter``,
``all-to-all``), their counts, and on a bound mesh the host seconds.
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import AxisEntry, ModelMesh


def _count(mesh: ModelMesh, kind: str, out: torch.Tensor,
           seconds: float = 0.0) -> None:
    t = mesh.tally
    t["bytes_by_kind"][kind] = (t["bytes_by_kind"].get(kind, 0)
                                + out.numel() * out.element_size())
    t["counts"][kind] = t["counts"].get(kind, 0) + 1
    t["seconds"] += seconds


def _host(x: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """``x`` on the host; ``wide``: a half-precision ``x`` in float32, so
    that a sum of the ranks' partials is rounded once."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    h = x.detach().to("cpu").contiguous()
    return h.float() if wide and x.element_size() < 4 and \
        x.is_floating_point() else h


def _reduce(x: torch.Tensor, mesh: ModelMesh, axes: AxisEntry,
            op=dist.ReduceOp.SUM) -> torch.Tensor:
    if mesh.axis_size(axes) == 1:
        return x
    if not mesh.bound:
        out = x.clone()
        _count(mesh, "all-reduce", out)
        return out
    t = time.perf_counter()
    h = _host(x, wide=True)
    dist.all_reduce(h, op=op, group=mesh.group(axes))
    out = h.to(device=x.device, dtype=x.dtype)
    _count(mesh, "all-reduce", out, time.perf_counter() - t)
    return out


def _gather(x: torch.Tensor, mesh: ModelMesh, axes: AxisEntry,
            dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    shape = list(x.shape)
    shape[dim] *= n
    if not mesh.bound:
        out = x.new_empty(shape)
        _count(mesh, "all-gather", out)
        return out
    t = time.perf_counter()
    h = _host(x)
    parts = [torch.empty_like(h) for _ in range(n)]
    dist.all_gather(parts, h, group=mesh.group(axes))
    out = torch.cat(parts, dim=dim).to(x.device)
    _count(mesh, "all-gather", out, time.perf_counter() - t)
    return out


def _scatter(x: torch.Tensor, mesh: ModelMesh, axes: AxisEntry,
             dim: int) -> torch.Tensor:
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    b = x.shape[dim] // n
    if not mesh.bound:
        out = x.narrow(dim, 0, b).clone()
        _count(mesh, "reduce-scatter", out)
        return out
    t = time.perf_counter()
    h = _host(x, wide=True)
    dist.all_reduce(h, group=mesh.group(axes))
    out = h.narrow(dim, mesh.axis_index(axes) * b, b).to(device=x.device,
                                                          dtype=x.dtype)
    _count(mesh, "reduce-scatter", out, time.perf_counter() - t)
    return out


def _exchange(x: torch.Tensor, mesh: ModelMesh, axes: AxisEntry,
              split: int, concat: int) -> torch.Tensor:
    """Block j of ``x`` along ``split`` goes to rank j of the axis; the
    blocks received are concatenated along ``concat`` in rank order
    (``jax.lax.all_to_all(..., tiled=True)``)."""
    n = mesh.axis_size(axes)
    if n == 1:
        return x
    if x.shape[split] % n:
        raise ValueError(f"all_to_all: dim {split} of {tuple(x.shape)} does "
                         f"not split over {n} ranks")
    shape = list(x.shape)
    shape[split] //= n
    shape[concat] *= n
    if not mesh.bound:
        out = x.new_empty(shape)
        _count(mesh, "all-to-all", out)
        return out
    t = time.perf_counter()
    h = _host(x)
    send = torch.stack(h.chunk(n, dim=split)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group(axes))
    out = torch.cat(list(recv.unbind(0)), dim=concat).to(x.device)
    _count(mesh, "all-to-all", out, time.perf_counter() - t)
    return out


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Replicate(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes), None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _scatter(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, split, concat):
        ctx.mesh, ctx.axes, ctx.split, ctx.concat = mesh, axes, split, concat
        return _exchange(x, mesh, axes, split, concat)

    @staticmethod
    def backward(ctx, g):
        return (_exchange(g, ctx.mesh, ctx.axes, ctx.concat, ctx.split),
                None, None, None, None)


def all_reduce(x: torch.Tensor, mesh: ModelMesh,
               axes: AxisEntry) -> torch.Tensor:
    """Sum over ``axes``; the gradient passes through unchanged."""
    return _AllReduce.apply(x, mesh, axes)


def replicate(x: torch.Tensor, mesh: ModelMesh,
              axes: AxisEntry) -> torch.Tensor:
    """``x`` itself; its gradient is summed over ``axes``."""
    return _Replicate.apply(x, mesh, axes)


def all_gather(x: torch.Tensor, mesh: ModelMesh, axes: AxisEntry,
               dim: int) -> torch.Tensor:
    """The blocks of every rank along ``axes``, concatenated on ``dim``
    in rank order; backward :func:`reduce_scatter`."""
    return _AllGather.apply(x, mesh, axes, dim)


def reduce_scatter(x: torch.Tensor, mesh: ModelMesh, axes: AxisEntry,
                   dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over ``axes``;
    backward :func:`all_gather`."""
    return _ReduceScatter.apply(x, mesh, axes, dim)


def all_to_all(x: torch.Tensor, mesh: ModelMesh, axes: AxisEntry,
               split: int, concat: int) -> torch.Tensor:
    """Block j along ``split`` to rank j of ``axes``, the received
    blocks concatenated along ``concat``; backward the inverse."""
    return _AllToAll.apply(x, mesh, axes, split, concat)


def all_max(x: torch.Tensor, mesh: ModelMesh,
            axes: AxisEntry) -> torch.Tensor:
    """Elementwise max over ``axes`` (no gradient)."""
    return _reduce(x.detach(), mesh, axes, dist.ReduceOp.MAX)
