"""The ``rounds`` route of the port's ``admit_quantum`` kernel, through
its CPU mirror ``reference_admit_rounds``, against the reference's
``repro.core.vectorized.admit_quantum`` (the jitted ``fori_loop``) on
the CPU.

The kernel groups a quantum's requests by row, walks every row's chain
with the pool state frozen and commits the prefix that saw the true
state, round after round, handing the rest to a serial walk after
``MAX_ROUNDS`` rounds or a round that committed fewer than
``MIN_COMMIT`` requests.  Its decisions must be the reference's bit for
bit — admit bits, reason codes and priority words — in every regime
that changes the round structure: contended from the start, a pool that
fills during the quantum, an adversarial draw whose admits keep lowering
the running minimum (the fallback must run), one hot row, padding,
N = 1, M = 1, int-to-float promotion at 2^24 + 1 and ties at the
threshold.  Each case also runs with the rounds unbounded and with the
serial walk alone (``max_rounds=0``, the ``walk`` route).  The reference
is run live on the same numpy inputs; nothing is a frozen constant.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core import control_plane as JC
from repro.core import vectorized as JV
from repro_torch.kernels.admit_quantum import admit_quantum as aq

N, M = 512, 8192


def draw(seed: int, n: int = N, m: int = M, **over):
    """Columns, row state, requests and pool scalars of one quantum: the
    distribution of ``chip_smoke.py``'s kernel draw (random classes,
    Eq. 1 weights from random SLOs, 128-token requests, tight buckets,
    3 % unbound rows, 10 % of rows at a concurrency limit of 1, KV
    ceilings, a contended pool); ``over`` replaces any entry."""
    r = np.random.RandomState(seed)
    d = dict(
        class_code=r.randint(0, 5, n).astype(np.int32),
        bound=r.random_sample(n) < 0.97,
        baseline_tps=r.uniform(10, 100, n).astype(np.float32),
        baseline_kv=np.where(r.random_sample(n) < 0.2, 3 * 128 * 1000.0,
                             0.0).astype(np.float32),
        baseline_conc=np.where(r.random_sample(n) < 0.1, 1.0,
                               64.0).astype(np.float32),
        slo_ms=r.uniform(100, 30000, n).astype(np.float32),
        burst=np.zeros(n, np.float32), debt=np.zeros(n, np.float32),
        bucket_level=r.uniform(0, 2000, n).astype(np.float32),
        in_flight=r.randint(0, 3, n).astype(np.int32),
        kv_in_use=np.zeros(n, np.float32),
        req_ent=r.randint(0, n, m).astype(np.int32),
        req_tokens=np.full(m, 128.0, np.float32),
        req_kv=np.where(r.random_sample(m) < 0.3, 128 * 1000.0,
                        0.0).astype(np.float32),
        req_live=np.ones(m, bool),
        pool_in_flight=5000, pool_resident=4096, pool_conc_cap=4096.0,
        running_min=5.0, slack=0.0)
    d.update(over)
    return d


COLS = ("class_code", "bound", "baseline_tps", "baseline_kv",
        "baseline_conc", "slo_ms", "burst", "debt")
ROWS = ("bucket_level", "in_flight", "kv_in_use")
REQS = ("req_ent", "req_tokens", "req_kv", "req_live")


def weights_of(d) -> np.ndarray:
    st = JC.ControlState(**{k: jnp.asarray(d[k]) for k in COLS})
    return np.array(JC.priority_rows(st, jnp.float32(1000.0),
                                     J.PriorityCoefficients()))


def jax_admit(d):
    st = JC.ControlState(**{k: jnp.asarray(d[k]) for k in COLS})
    out = JV.admit_quantum(
        st, *(jnp.asarray(d[k]) for k in ROWS),
        pool_in_flight=jnp.int32(d["pool_in_flight"]),
        pool_conc_cap=jnp.float32(d["pool_conc_cap"]),
        running_min_priority=jnp.float32(d["running_min"]),
        pool_avg_slo=jnp.float32(1000.0),
        **{k: jnp.asarray(d[k]) for k in REQS},
        pool_resident=jnp.int32(d["pool_resident"]),
        weights=jnp.asarray(weights_of(d)), slack=d["slack"])
    return [np.asarray(x) for x in out]


def port_args(d):
    t = {k: torch.from_numpy(np.asarray(d[k]).copy())
         for k in COLS + ROWS + REQS}
    args = (t["class_code"], t["bound"], t["baseline_kv"],
            t["baseline_conc"], torch.from_numpy(weights_of(d)),
            t["bucket_level"], t["in_flight"], t["kv_in_use"],
            t["req_ent"], t["req_tokens"], t["req_kv"], t["req_live"])
    scal = dict(pool_in_flight=int(d["pool_in_flight"]),
                pool_resident=np.float32(d["pool_resident"]),
                pool_conc_cap=np.float32(d["pool_conc_cap"]),
                running_min=np.float32(d["running_min"]),
                slack_factor=np.float32(1.0 - d["slack"]))
    return args, scal


def falling(n: int = N, m: int = M):
    """Shielded (guaranteed) rows with room for everything, the pool
    contended, the requests in blocks of one row each in strictly
    falling weight: every block's first admit lowers the running
    minimum and ends a round."""
    d = draw(7, n, m, class_code=np.full(n, 1, np.int32),
             bound=np.ones(n, bool), baseline_conc=np.zeros(n, np.float32),
             baseline_kv=np.zeros(n, np.float32),
             bucket_level=np.full(n, 1e9, np.float32),
             running_min=np.inf)
    by_weight = np.argsort(-weights_of(d), kind="stable")
    d["req_ent"] = np.repeat(by_weight, m // n).astype(np.int32)
    return d


def hot_row():
    d = draw(11)
    r = np.random.RandomState(12)
    d["req_ent"] = np.where(r.random_sample(M) < 0.5, 7,
                            d["req_ent"]).astype(np.int32)
    return d


def ties(slack: float):
    """Requests whose own row sets the running minimum: strict > denies
    them without slack, slack admits them."""
    n = 64
    d = draw(29, n, 50, class_code=np.full(n, 3, np.int32),
             bound=np.ones(n, bool),
             baseline_conc=np.full(n, 64.0, np.float32),
             bucket_level=np.full(n, 1e6, np.float32),
             baseline_kv=np.zeros(n, np.float32),
             req_ent=np.full(50, 7, np.int32), slack=slack)
    d["running_min"] = float(weights_of(d)[7])
    return d


CASES = {
    **{f"draw seed {s}": functools.partial(draw, s) for s in range(4)},
    "draw, 64 rows": functools.partial(draw, 4, 64, 4096),
    **{f"filling pool, slack {sl}": functools.partial(
        draw, 5, pool_in_flight=0, pool_conc_cap=1024.0,
        running_min=np.inf, slack=sl) for sl in (0.0, 0.1)},
    "falling weights": falling,
    "hot row": hot_row,
    "padding": functools.partial(draw, 13, 64, 300,
                                 req_live=np.arange(300) % 3 == 0),
    "one row": functools.partial(draw, 14, 1, 300),
    "one request": functools.partial(draw, 15, 64, 1),
    "int to float promotion": functools.partial(
        draw, 16, 64, 200, baseline_conc=np.full(64, 16777216.0,
                                                 np.float32),
        in_flight=np.full(64, 16777217, np.int32),
        pool_in_flight=16777217, pool_conc_cap=16777216.0,
        running_min=1e9),
    "int to float promotion, filling": functools.partial(
        draw, 17, 64, 200, pool_in_flight=16777215,
        pool_conc_cap=16777216.0, running_min=np.inf),
    **{f"threshold tie, slack {sl}": functools.partial(ties, sl)
       for sl in (0.0, 0.5)},
}
#: (max_rounds, min_commit): the kernel's defaults, rounds unbounded,
#: the serial walk alone
SETTINGS = {"defaults": (aq.MAX_ROUNDS, aq.MIN_COMMIT),
            "unbounded": (10 ** 9, 1), "walk": (0, 1)}


@functools.lru_cache(maxsize=None)
def reference(case: str):
    d = CASES[case]()
    return d, jax_admit(d)


def rounds_of(case: str, setting: str):
    d, ref = reference(case)
    args, scal = port_args(d)
    max_rounds, min_commit = SETTINGS[setting]
    out = aq.reference_admit_rounds(*args, **scal, max_rounds=max_rounds,
                                    min_commit=min_commit)
    return ref, out


def assert_same(ref, port):
    for name, a, b in zip(("admitted", "reason", "priority"), ref, port):
        b = b.numpy()
        assert a.shape == b.shape, name
        if a.dtype == np.float32:
            bad = np.flatnonzero(a.view(np.uint32) != b.view(np.uint32))
        else:
            bad = np.flatnonzero(a != b)
        assert bad.size == 0, (f"{name}: {bad.size} of {a.size} differ, "
                               f"first at {bad[0]}: {a[bad[0]]} vs "
                               f"{b[bad[0]]}")


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("case", list(CASES))
def test_rounds_equal_admit_quantum(case, setting):
    ref, out = rounds_of(case, setting)
    assert_same(ref, out[:3])
    rounds, fallback_at = out[3], out[4]
    m = ref[0].shape[0]
    if setting == "walk":
        assert (rounds, fallback_at) == (0, 0)
    elif setting == "unbounded":
        assert rounds >= 1 and fallback_at == -1
    else:
        assert 1 <= rounds <= aq.MAX_ROUNDS
        assert fallback_at == -1 or 0 < fallback_at < m


def test_draw_reaches_every_reason():
    ref, out = rounds_of("draw seed 0", "defaults")
    assert set(np.unique(ref[1]).tolist()) == {0, 1, 2, 3, 4}
    # contended from the start, no admit below the minimum: one round
    assert out[3:] == (1, -1)


@pytest.mark.parametrize("slack", [0.0, 0.1])
def test_filling_pool_takes_a_second_round(slack):
    """The pool turns contended once, inside the quantum: the first round
    commits up to the admit that fills it, the second goes on from
    there with the running minimum of what the first admitted."""
    ref, out = rounds_of(f"filling pool, slack {slack}", "defaults")
    assert out[3] >= 2
    flip = np.flatnonzero(ref[0])[1024]            # the 1,025th admit
    assert out[4] == -1 or out[4] > flip


def test_falling_weights_take_the_fallback():
    ref, out = rounds_of("falling weights", "defaults")
    # the first admit lowers the minimum (it was inf): round 1 commits
    # one request, fewer than MIN_COMMIT, and the serial walk does the rest
    assert out[3:] == (1, 1)
    assert ref[0].all()
    _, unbounded = rounds_of("falling weights", "unbounded")
    # a round per row's block, each ending at its first admit, and one
    # for the last block's rest
    assert unbounded[3] == N + 1


def test_route_by_quantum_length():
    """On the card a quantum shorter than WALK_BELOW takes the serial
    walk, a longer one the rounds; on the CPU every route is the plain
    version, and no kernel launch is counted."""
    assert aq.route(1) == "walk"
    assert aq.route(aq.WALK_BELOW - 1) == "walk"
    assert aq.route(aq.WALK_BELOW) == "rounds"
    assert aq.route(M) == ("rounds" if M >= aq.WALK_BELOW else "walk")
    d, ref = reference("padding")
    args, scal = port_args(d)
    before = (aq.admit_scan.launches, dict(aq.admit_scan.route_launches))
    for kernel in (None, "rounds", "walk"):
        assert_same(ref, aq.admit_scan(*args, **scal, kernel=kernel))
    assert (aq.admit_scan.launches,
            dict(aq.admit_scan.route_launches)) == before
