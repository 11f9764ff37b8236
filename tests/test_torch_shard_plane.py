"""The port's sharded control plane (``repro_torch.core.shard_plane``)
against the JAX package's single-device kernels, on CPU gloo ranks.

For each mesh size S in {2, 4, 8}, one module-scoped launch of S local
ranks (``shard_plane.launch_ranks``) computes every case: each rank
holds its block of the rows, runs the sharded tick, admission quantum
and fleet plan with the cross-rank combines over the gloo group, and
returns what it got.  The ranks import no JAX.  The parent holds every
case against the reference (``repro.core.control_plane.control_tick``,
``repro.core.vectorized.admit_quantum``, ``repro.core.fleet.plan_fleet``
and the tree reductions), computed live — never frozen constants,
since whether XLA fuses the tick's multiply-adds is its choice (fault
C1).  No tolerance anywhere: float words are compared as raw bits.
Each rank also runs every case on a mesh of one rank, which must equal
the port's flat kernels.
"""
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import control_plane as TC
from repro_torch.core import shard_plane as SP
from repro_torch.core import vectorized as TV
from repro_torch.core.types import PriorityCoefficients

SIZES = (2, 4, 8)
#: every case is padded to the widest mesh's width, so one reference
#: result serves every mesh size
MAX_MESH = 8
TREE_NS = (1, 3, 16, 37, 256)
#: request width of every admission case
QUANTUM = 32
TICK_CASES = [(seed, scarcity) for seed in range(4)
              for scarcity in (0.2, 1.0, 5.0)]
ADMIT_CASES = [(seed, explicit) for seed in range(6)
               for explicit in (False, True)]
PLAN_SEEDS = range(4)
FIELDS = ("class_code", "bound", "baseline_tps", "baseline_kv",
          "baseline_conc", "slo_ms", "burst", "debt")
TICK_INS = ("measured_tps", "used_kv", "used_conc", "demand_tps")
PLAN_ARGS = ("current", "lo", "hi", "per_tps", "per_kv", "per_conc",
             "res_tps", "res_kv", "res_conc", "demand_tps", "ewma_prev",
             "seeded", "low_ticks")
ROW_KW = ("bucket_level", "in_flight", "kv_in_use")
REQ_KW = ("req_ent", "req_tokens", "req_kv", "req_live")
#: rank launch limit (they finish in seconds; a hang fails the test)
TIMEOUT_S = 180.0


def width(n: int) -> int:
    """The port's mesh-aligned pad width for the widest mesh."""
    return SP.shard_width(n, SP.RowMesh(None, MAX_MESH, 0))


def pad(x: np.ndarray, w: int) -> np.ndarray:
    out = np.zeros(w, x.dtype)
    out[:len(x)] = x
    return out


def random_state(rng, n: int) -> dict:
    """Mixed-class rows (the reference tests' ``random_rows`` draw):
    state columns and the tick's measurements, as numpy."""
    code = rng.randint(0, 5, n).astype(np.int32)
    base = np.where(code >= 3, 0.0, rng.uniform(5, 100, n))
    return dict(
        class_code=code,
        bound=rng.rand(n) > 0.1,
        baseline_tps=base.astype(np.float32),
        baseline_kv=rng.choice([0.0, 1 << 20], n).astype(np.float32),
        baseline_conc=rng.choice([0.0, 4.0, 16.0], n).astype(np.float32),
        slo_ms=rng.uniform(100, 30000, n).astype(np.float32),
        burst=rng.uniform(0, 2.0, n).astype(np.float32),
        debt=rng.uniform(-0.15, 1.0, n).astype(np.float32),
        measured_tps=rng.uniform(0, 150, n).astype(np.float32),
        used_kv=rng.uniform(0, 1 << 20, n).astype(np.float32),
        used_conc=rng.randint(0, 8, n).astype(np.float32),
        demand_tps=rng.uniform(0, 200, n).astype(np.float32))


def tick_case(seed: int, scarcity: float) -> dict:
    rng = np.random.RandomState(seed)
    n = int(rng.randint(3, 60))
    rows = random_state(rng, n)
    demand = float(np.sum(np.minimum(rows["baseline_tps"],
                                     rows["demand_tps"])[rows["bound"]]))
    w = width(n)
    return dict(rows={k: pad(v, w) for k, v in rows.items()},
                cap=np.float32(max(10.0, scarcity * demand)),
                slo=np.float32(10_000.0))


def admit_case(seed: int, explicit: bool) -> dict:
    rng = np.random.RandomState(seed)
    n, m = int(rng.randint(2, 50)), int(rng.randint(1, 33))
    rows = random_state(rng, n)
    w = width(n)
    live = dict(
        bucket_level=(rng.rand(n) * 120).astype(np.float32),
        in_flight=rng.randint(0, 5, n).astype(np.int32),
        kv_in_use=(rng.rand(n) * 50).astype(np.float32))
    scalars = dict(
        pool_in_flight=int(rng.randint(0, 12)),
        pool_conc_cap=float(rng.choice([8.0, 64.0, 1e9])),
        running_min_priority=float(np.float32(
            np.inf if rng.rand() < 0.5 else rng.rand() * 4)),
        pool_avg_slo=float(np.float32(rng.uniform(200, 20000))),
        pool_resident=int(rng.randint(0, 40)))
    # the quantum padded to one width (as the gateway pads it): the
    # padding requests are not live
    reqs = dict(
        req_ent=pad(rng.randint(0, n, m).astype(np.int32), QUANTUM),
        req_tokens=pad((rng.rand(m) * 40 + 1).astype(np.float32), QUANTUM),
        req_kv=pad((rng.rand(m) * 20).astype(np.float32), QUANTUM),
        req_live=pad(rng.rand(m) < 0.9, QUANTUM))
    weights = (pad((rng.rand(n) * 3).astype(np.float32), w)
               if explicit else None)
    return dict(rows={k: pad(v, w) for k, v in {**rows, **live}.items()},
                scalars=scalars, reqs=reqs, weights=weights,
                slack=float(rng.choice([0.0, 0.1])))


def fleet_case(seed: int, p: int = 16) -> dict:
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return dict(
        current=rng.randint(1, 5, p).astype(np.int32),
        lo=np.ones(p, np.int32),
        hi=np.full(p, 8, np.int32),
        per_tps=(rng.rand(p) * 100 + 10).astype(f32),
        per_kv=(rng.rand(p) * 200 + 20).astype(f32),
        per_conc=(rng.rand(p) * 8 + 1).astype(f32),
        res_tps=(rng.rand(p) * 80).astype(f32),
        res_kv=(rng.rand(p) * 100).astype(f32),
        res_conc=(rng.rand(p) * 4).astype(f32),
        demand_tps=(rng.rand(p) * 150).astype(f32),
        ewma_prev=(rng.rand(p) * 100).astype(f32),
        seeded=rng.rand(p) < 0.7,
        low_ticks=rng.randint(0, 4, p).astype(np.int32))


def tree_case(n: int) -> dict:
    rng = np.random.RandomState(n)
    w = width(n)
    return dict(x=pad((rng.rand(n) * 1000).astype(np.float32), w),
                mask=pad(rng.rand(n) < 0.3, w))


CASES = dict(
    tree=[tree_case(n) for n in TREE_NS],
    tick=[tick_case(*c) for c in TICK_CASES],
    admit=[admit_case(*c) for c in ADMIT_CASES],
    fleet=[fleet_case(s) for s in PLAN_SEEDS])


# -- the ranks (no JAX) ---------------------------------------------------------

def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(xs) -> list:
    return [x.numpy() for x in xs]


def _run_tick(case, mesh, flat: bool = False):
    """The tick on ``mesh`` over this rank's block (or the port's flat
    ``control_tick`` over all rows), as full host rows."""
    rows = case["rows"]
    lo, hi = (0, len(rows["bound"])) if flat else mesh.block(
        len(rows["bound"]))
    state = TC.ControlState(**{k: _t(rows[k][lo:hi]) for k in FIELDS})
    args = (state, torch.tensor(case["cap"]),
            *(_t(rows[k][lo:hi]) for k in TICK_INS),
            torch.tensor(case["slo"]))
    if flat:
        new, alloc, w = TC.control_tick(*args)
        return _np([getattr(new, k) for k in FIELDS] + [alloc, w])
    new, alloc, w = SP.shard_tick(*args, mesh=mesh)
    return SP.gather_rows(mesh, *(getattr(new, k) for k in FIELDS),
                          alloc, w)


def _run_admit(case, mesh, flat: bool = False):
    rows = case["rows"]
    lo, hi = (0, len(rows["bound"])) if flat else mesh.block(
        len(rows["bound"]))
    state = TC.ControlState(**{k: _t(rows[k][lo:hi]) for k in FIELDS})
    w = case["weights"]
    kw = dict(
        **{k: _t(rows[k][lo:hi]) for k in ROW_KW}, **case["scalars"],
        **{k: _t(v) for k, v in case["reqs"].items()},
        weights=None if w is None else _t(w[lo:hi]), slack=case["slack"])
    if flat:
        return _np(TV.admit_quantum(state, **kw))
    return _np(SP.shard_admit_quantum(state, **kw, mesh=mesh))


def _run_fleet(case, mesh, flat: bool = False):
    from repro_torch.core.fleet import plan_fleet
    p = len(case["current"])
    lo, hi = (0, p) if flat else mesh.block(p)
    args = [_t(case[k][lo:hi]) for k in PLAN_ARGS]
    if flat:
        return _np(plan_fleet(*args))
    return SP.gather_rows(mesh, *SP.shard_plan_fleet(*args, mesh=mesh))


def _run_tree(case, mesh):
    lo, hi = mesh.block(len(case["x"]))
    x, mask = _t(case["x"][lo:hi]), _t(case["mask"][lo:hi])
    return _np([TC.tree_sum(x, mesh), TC.tree_any(mask, mesh),
                TC.tree_count(mask, mesh)])


def _rank(cases: dict) -> dict:
    mesh = SP.row_mesh()
    one = SP.row_mesh(1)
    out = {
        "mesh": (mesh.size, mesh.rank),
        "tree": [_run_tree(c, mesh) for c in cases["tree"]],
        "tick": [_run_tick(c, mesh) for c in cases["tick"]],
        "admit": [_run_admit(c, mesh) for c in cases["admit"]],
        "fleet": [_run_fleet(c, mesh) for c in cases["fleet"]],
    }
    for kind, run in (("tick", _run_tick), ("admit", _run_admit),
                      ("fleet", _run_fleet)):
        out[f"{kind}_one"] = [run(c, one) for c in cases[kind]]
        out[f"{kind}_flat"] = [run(c, one, flat=True) for c in cases[kind]]
    out["jax_imported"] = any(m == "jax" or m.startswith("jax.")
                              for m in sys.modules)
    return out


# -- the parent -----------------------------------------------------------------

@pytest.fixture(scope="module", params=SIZES)
def ranks(request):
    """Every rank's results for one mesh size (one launch a size)."""
    return request.param, SP.launch_ranks(_rank, request.param, CASES,
                                          timeout=TIMEOUT_S)


@pytest.fixture(scope="module")
def ref():
    """The JAX package's single-device results for every case."""
    import jax.numpy as jnp
    from repro.core import control_plane as JC
    from repro.core import vectorized as JV
    from repro.core.fleet import plan_fleet

    def tick(c):
        rows = c["rows"]
        st = JC.ControlState(**{k: jnp.asarray(rows[k]) for k in FIELDS})
        new, alloc, w = JC.control_tick(
            st, jnp.float32(c["cap"]),
            *(jnp.asarray(rows[k]) for k in TICK_INS),
            jnp.float32(c["slo"]), coeff=PriorityCoefficients())
        return [np.asarray(getattr(new, k)) for k in FIELDS] + [
            np.asarray(alloc), np.asarray(w)]

    def admit(c):
        rows, s = c["rows"], c["scalars"]
        st = JC.ControlState(**{k: jnp.asarray(rows[k]) for k in FIELDS})
        w = None if c["weights"] is None else jnp.asarray(c["weights"])
        out = JV.admit_quantum(
            st, *(jnp.asarray(rows[k]) for k in ROW_KW),
            pool_in_flight=jnp.int32(s["pool_in_flight"]),
            pool_conc_cap=jnp.float32(s["pool_conc_cap"]),
            running_min_priority=jnp.float32(s["running_min_priority"]),
            pool_avg_slo=jnp.float32(s["pool_avg_slo"]),
            **{k: jnp.asarray(c["reqs"][k]) for k in REQ_KW},
            pool_resident=jnp.int32(s["pool_resident"]),
            weights=w, slack=c["slack"])
        return [np.asarray(x) for x in out]

    def fleet(c):
        return [np.asarray(x) for x in plan_fleet(
            *(jnp.asarray(c[k]) for k in PLAN_ARGS))]

    def tree(c):
        x, mask = jnp.asarray(c["x"]), jnp.asarray(c["mask"])
        return [np.asarray(JC.tree_sum(x)), np.asarray(JC.tree_any(mask)),
                np.asarray(JC.tree_count(mask))]

    return dict(tree=[tree(c) for c in CASES["tree"]],
                tick=[tick(c) for c in CASES["tick"]],
                admit=[admit(c) for c in CASES["admit"]],
                fleet=[fleet(c) for c in CASES["fleet"]])


def assert_bitwise(ref_arrays, got_arrays, what):
    assert len(ref_arrays) == len(got_arrays), what
    for k, (a, b) in enumerate(zip(ref_arrays, got_arrays)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (
            what, k, a.shape, b.shape, a.dtype, b.dtype)
        if a.dtype == np.float32:
            a, b = a.view(np.uint32), b.view(np.uint32)
        bad = np.flatnonzero(a.reshape(-1) != b.reshape(-1))
        assert bad.size == 0, (f"{what} output {k}: {bad.size} of {a.size} "
                               f"differ, first at {bad[0]}")


def test_ranks_form_the_mesh_without_jax(ranks):
    size, results = ranks
    assert [r["mesh"] for r in results] == [(size, k) for k in range(size)]
    assert not any(r["jax_imported"] for r in results)


@pytest.mark.parametrize("case", range(len(TREE_NS)),
                         ids=[f"n{n}" for n in TREE_NS])
def test_tree_reductions(ranks, ref, case):
    """Per-rank subtrees + the top tree over the gathered roots equal
    the reference's single-device tree_sum / tree_any / tree_count."""
    size, results = ranks
    for r, res in enumerate(results):
        assert_bitwise(ref["tree"][case], res["tree"][case],
                       f"tree n={TREE_NS[case]} S={size} rank {r}")


@pytest.mark.parametrize("case", range(len(TICK_CASES)),
                         ids=[f"seed{s}-x{c}" for s, c in TICK_CASES])
def test_shard_tick_equals_control_tick(ranks, ref, case):
    """State, allocations and weights bitwise equal to the JAX
    ``control_tick``, as gathered on every rank."""
    size, results = ranks
    for r, res in enumerate(results):
        assert_bitwise(ref["tick"][case], res["tick"][case],
                       f"tick {TICK_CASES[case]} S={size} rank {r}")


@pytest.mark.parametrize("case", range(len(ADMIT_CASES)),
                         ids=[f"seed{s}-{'w' if e else 'nw'}"
                              for s, e in ADMIT_CASES])
def test_shard_admit_quantum_equals_admit_quantum(ranks, ref, case):
    """Admit bits, deny reasons and priorities equal to the JAX
    ``admit_quantum``, on every rank (the replay is replicated)."""
    size, results = ranks
    for r, res in enumerate(results):
        assert_bitwise(ref["admit"][case], res["admit"][case],
                       f"admit {ADMIT_CASES[case]} S={size} rank {r}")


@pytest.mark.parametrize("case", range(len(PLAN_SEEDS)))
def test_shard_plan_fleet_equals_plan_fleet(ranks, ref, case):
    size, results = ranks
    for r, res in enumerate(results):
        assert_bitwise(ref["fleet"][case], res["fleet"][case],
                       f"fleet seed {case} S={size} rank {r}")


@pytest.mark.parametrize("kind", ("tick", "admit", "fleet"))
def test_mesh_of_one_equals_flat_kernels(ranks, kind):
    """``row_mesh(1)`` (each rank alone) gives the port's flat
    ``control_tick`` / ``admit_quantum`` / ``plan_fleet`` bit for bit."""
    size, results = ranks
    for r, res in enumerate(results):
        for k, (one, flat) in enumerate(zip(res[f"{kind}_one"],
                                            res[f"{kind}_flat"])):
            assert_bitwise(flat, one, f"{kind} case {k} mesh 1 in S={size} "
                                      f"rank {r}")
