"""The port's collectives (``repro_torch.distributed.collectives``) and
the mesh they run over, on 4 CPU gloo ranks laid out as a 2×2 mesh.

One launch of ranks computes every case: rank r draws its input x_r
and a cotangent w_r from seed r, applies each collective over each axis
(``data``, ``model`` and both), and returns the output and the gradient
of Σ out·w.  The parent holds each against the collective's plain
definition over the inputs of the ranks of that axis's group: sums,
concatenations and blocks in rank order, and for the backward the
adjoint the docstring names (identity, sum, reduce-scatter, gather,
inverse exchange).  An abstract mesh's collectives communicate nothing,
return meta tensors of the right shape and tally their result bytes.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.core.shard_plane import launch_ranks
from repro_torch.distributed import collectives as C
from repro_torch.launch.mesh import ModelMesh, make_test_mesh

SHAPE = {"data": 2, "model": 2}
AXES = ("data", "model", ("data", "model"))
X_SHAPE = (4, 6)
KINDS = ("all_reduce", "replicate", "all_gather0", "all_gather1",
         "reduce_scatter", "all_to_all", "all_max")


def draw(rank: int):
    g = torch.Generator().manual_seed(rank)
    return (torch.randn(X_SHAPE, generator=g),
            torch.randn(16, 24, generator=g))


def apply(kind, x, mesh, axes):
    if kind == "all_reduce":
        return C.all_reduce(x, mesh, axes)
    if kind == "replicate":
        return C.replicate(x, mesh, axes)
    if kind.startswith("all_gather"):
        return C.all_gather(x, mesh, axes, int(kind[-1]))
    if kind == "reduce_scatter":
        return C.reduce_scatter(x, mesh, axes, 0)
    if kind == "all_to_all":
        return C.all_to_all(x, mesh, axes, 0, 1)
    return C.all_max(x, mesh, axes)


def rank_cases() -> dict:
    mesh = ModelMesh(SHAPE).bind()
    x0, w0 = draw(mesh.rank)
    out = {"coords": dict(mesh.coords), "rank": mesh.rank}
    for axes, kind in itertools.product(AXES, KINDS):
        x = x0.clone().requires_grad_(kind != "all_max")
        y = apply(kind, x, mesh, axes)
        w = w0[:y.shape[0], :y.shape[1]]
        res = {"out": y.detach().numpy()}
        if kind != "all_max":
            (g,) = torch.autograd.grad((y * w).sum(), x)
            res["grad"] = g.numpy()
        out[(str(axes), kind)] = res
    out["tally"] = {k: dict(v) if isinstance(v, dict) else v
                    for k, v in mesh.tally.items()}
    return out


@pytest.fixture(scope="module")
def ranks():
    return launch_ranks(rank_cases, 4, timeout=180.0)


def group(ranks, r, axes):
    """Rank r's group along ``axes``, in group order."""
    names = (axes,) if isinstance(axes, str) else axes
    others = [a for a in SHAPE if a not in names]
    mine = ranks[r]["coords"]
    members = [q for q in range(4)
               if all(ranks[q]["coords"][a] == mine[a] for a in others)]
    return sorted(members, key=lambda q: [ranks[q]["coords"][a]
                                          for a in names])


def expected(kind, xs, ws, i, n):
    """The plain definition for the member at place i of a group whose
    inputs are ``xs`` and cotangents ``ws`` (in group order)."""
    xsum = sum(xs)
    if kind == "all_reduce":
        return xsum, ws[i][:4, :6]
    if kind == "replicate":
        return xs[i], sum(w[:4, :6] for w in ws)
    if kind.startswith("all_gather"):
        dim = int(kind[-1])
        out = np.concatenate(xs, axis=dim)
        grads = [w[:out.shape[0], :out.shape[1]] for w in ws]
        return out, np.split(sum(grads), n, axis=dim)[i]
    if kind == "reduce_scatter":
        out = np.split(xsum, n, axis=0)[i]
        return out, np.concatenate([w[:out.shape[0], :out.shape[1]]
                                    for w in ws], axis=0)
    if kind == "all_to_all":
        blocks = [np.split(x, n, axis=0) for x in xs]
        out = np.concatenate([blocks[j][i] for j in range(n)], axis=1)
        wb = [np.split(w[:out.shape[0], :out.shape[1]], n, axis=1)
              for w in ws]
        return out, np.concatenate([wb[j][i] for j in range(n)], axis=0)
    return np.maximum.reduce(xs), None


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("axes", AXES, ids=str)
def test_collective_and_backward(ranks, axes, kind):
    for r in range(4):
        members = group(ranks, r, axes)
        xs, ws = zip(*(tuple(t.numpy() for t in draw(q)) for q in members))
        want, want_grad = expected(kind, list(xs), list(ws),
                                   members.index(r), len(members))
        got = ranks[r][(str(axes), kind)]
        np.testing.assert_allclose(got["out"], want, rtol=1e-6, atol=1e-6)
        if want_grad is not None:
            np.testing.assert_allclose(got["grad"], want_grad, rtol=1e-6,
                                       atol=1e-6)


def test_mesh_lays_ranks_out_row_major(ranks):
    for r, res in enumerate(ranks):
        assert res["rank"] == r
        assert res["coords"] == {"data": r // 2, "model": r % 2}
    # every collective over 2 or 4 ranks was tallied, with host time
    t = ranks[0]["tally"]
    assert t["counts"]["all-reduce"] > 0 and t["seconds"] > 0.0


def test_abstract_mesh_records_without_communicating():
    mesh = make_test_mesh(2, 4)
    x = torch.empty(8, 16, device="meta")
    assert C.all_gather(x, mesh, "model", 1).shape == (8, 64)
    assert C.reduce_scatter(x, mesh, ("data", "model"), 0).shape == (1, 16)
    assert C.all_to_all(x, mesh, "model", 0, 1).shape == (2, 64)
    assert C.all_reduce(x, mesh, "data").shape == (8, 16)
    assert C.all_reduce(x, mesh, None).shape == (8, 16)  # one rank: no tally
    t = mesh.tally
    assert t["bytes_by_kind"] == {"all-gather": 8 * 64 * 4,
                                  "reduce-scatter": 16 * 4,
                                  "all-to-all": 2 * 64 * 4,
                                  "all-reduce": 8 * 16 * 4}
    assert t["counts"] == {"all-gather": 1, "reduce-scatter": 1,
                           "all-to-all": 1, "all-reduce": 1}
    assert t["seconds"] == 0.0
    with pytest.raises(ValueError, match="does not split"):
        C.reduce_scatter(torch.empty(3, 2, device="meta"), mesh, "model", 0)
