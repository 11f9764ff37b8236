"""The traffic generator: one seed gives one schedule, the length laws'
clips hold, and seeds change the order of the work, not its amount."""
import json

import numpy as np
import pytest

import bench_tiny_cells as tiny
from harness import traffic

MIXES = sorted((tiny.BENCH / "traffic").glob("*.json"))


def load(path):
    with open(path) as f:
        return json.load(f)


def flat(s):
    return ([(q.due, q.tenant, q.index, q.prompt_len, q.output_len)
             for q in s.open],
            [(w.tenant, w.index, w.start, w.prompt_lens.tolist(),
              w.output_lens.tolist()) for w in s.workers])


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_same_seed_same_schedule(path):
    mix = load(path)
    a = traffic.schedule(mix, 2**31 + 17, 30.0)
    b = traffic.schedule(mix, 2**31 + 17, 30.0)
    assert flat(a) == flat(b)
    assert traffic.prompt_ids(2**31 + 17, 0, 3, 50, 151936) == \
        traffic.prompt_ids(2**31 + 17, 0, 3, 50, 151936)
    c = traffic.schedule(mix, 5, 30.0)
    assert flat(a) != flat(c)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_seeds_permute_the_same_work(path):
    mix = load(path)
    a = traffic.schedule(mix, 1, 40.0)
    b = traffic.schedule(mix, 2, 40.0)
    for key in ("prompt_len", "output_len"):
        assert sorted(getattr(q, key) for q in a.open) == \
            sorted(getattr(q, key) for q in b.open)
    assert sorted(np.concatenate([w.prompt_lens for w in a.workers]
                                 or [np.zeros(0)]).tolist()) == \
        sorted(np.concatenate([w.prompt_lens for w in b.workers]
                              or [np.zeros(0)]).tolist())


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_clips_and_rates(path):
    mix = load(path)
    s = traffic.schedule(mix, 99, 45.0)
    laws = mix["lengths"]
    for q in s.open:
        assert laws["prompt"]["min"] <= q.prompt_len <= laws["prompt"]["max"]
        assert laws["output"]["min"] <= q.output_len <= laws["output"]["max"]
        assert 0.0 <= q.due < 45.0
    for w in s.workers:
        assert w.prompt_lens.min() >= laws["prompt"]["min"]
        assert w.prompt_lens.max() <= laws["prompt"]["max"]
    for t, ten in enumerate(mix["tenants"]):
        if ten["arrivals"] == "poisson":
            n = sum(q.tenant == t for q in s.open)
            assert abs(n - ten["rate_rps"] * 45.0) <= 1.0


def test_law_values_quantiles():
    law = {"law": "lognormal", "median": 100, "sigma": 1.0, "min": 10,
           "max": 400}
    v = traffic.law_values(law, 1001)
    assert v[500] == 100                       # the median sits in the middle
    assert v.min() == 10 and v.max() == 400    # both clips bind
    assert (np.diff(v) >= 0).all()
    with pytest.raises(ValueError):
        traffic.law_values(dict(law, law="uniform"), 4)


def test_poisson_gaps_mean():
    g = traffic.poisson_gaps(4.0, 4000)
    assert abs(g.mean() - 0.25) < 0.01
    assert (np.diff(g) > 0).all()


def test_order_is_a_seeded_permutation():
    """Each seed orders the same gaps and lengths at random: runs of
    long prompts and of short gaps occur as in a random draw (no
    stratified rounds), and two seeds give two orders."""
    mix = {"lengths": {"prompt": {"law": "lognormal", "median": 100,
                                  "sigma": 1.0, "min": 1, "max": 10**6},
                       "output": {"law": "lognormal", "median": 10,
                                  "sigma": 0.5, "min": 1, "max": 100}},
           "tenants": [{"name": "t", "class": "guaranteed",
                        "arrivals": "poisson", "rate_rps": 10.0}]}
    runs = []
    for seed in (1, 2, 3):
        s = traffic.schedule(mix, seed, 100.0)
        p = np.array([q.prompt_len for q in s.open])
        runs.append(p.tolist())
        long = p > np.median(p)
        # the longest run of above-median prompts: about log2(1000) in a
        # random order, never more than 1-2 under rounds of strata
        best = cur = 0
        for x in long:
            cur = cur + 1 if x else 0
            best = max(best, cur)
        assert best >= 5
    assert runs[0] != runs[1] and sorted(runs[0]) == sorted(runs[1])
