"""Traffic from a mix file and the seed.

One general generator reads every mix file under ``bench/traffic/``.
A tenant is either an open loop (``"arrivals": "poisson"``: independent
users sending at ``rate_rps`` whatever happens to earlier requests) or a
closed loop (``"arrivals": "closed"``: ``workers`` clients, each sending
its next request when its previous one finished or, after a 429, once
the ``Retry-After`` has passed).

The seed changes the order of the work and not its amount.  Every
length law and every set of Poisson gaps is taken at the same
stratified quantiles, (i + 0.5) / n, and the seed draws a uniformly
random permutation of each (independently for gaps, prompt lengths and
output lengths) and the token ids.  So two seeds send the same multiset
of prompt and output lengths at the same multiset of exponential gaps,
and within a run the arrivals are those of a Poisson process with
lengths drawn independently of them: long prompts and short gaps
cluster as they would in a random draw.
"""
from __future__ import annotations

import dataclasses
from statistics import NormalDist
from typing import Optional

import numpy as np

#: lengths in each closed-loop worker's cycle
CYCLE = 64



def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for one stream of the run, from the seed (any whole
    number) and the stream's ids."""
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


def law_values(law: dict, n: int) -> np.ndarray:
    """``n`` lengths of a length law at the quantiles (i + 0.5) / n,
    rounded and clipped to [min, max].  ``lognormal``: median and sigma
    of the log."""
    if law["law"] != "lognormal":
        raise ValueError(f"unknown length law {law['law']!r}")
    inv = NormalDist().inv_cdf
    z = np.array([inv((i + 0.5) / n) for i in range(n)])
    v = float(law["median"]) * np.exp(float(law["sigma"]) * z)
    return np.clip(np.rint(v), law["min"], law["max"]).astype(np.int64)


def poisson_gaps(rate: float, n: int) -> np.ndarray:
    """The n gaps of a Poisson process at ``rate``, at the exponential
    law's quantiles (i + 0.5) / n, in rising order."""
    p = (np.arange(n) + 0.5) / n
    return -np.log1p(-p) / rate


@dataclasses.dataclass(frozen=True)
class OpenRequest:
    due: float            # seconds after the window opens
    tenant: int           # index into the mix's tenants
    index: int            # the request's number within its tenant
    prompt_len: int
    output_len: int


@dataclasses.dataclass
class Worker:
    tenant: int
    index: int            # the worker's number within its tenant
    start: float
    prompt_lens: np.ndarray
    output_lens: np.ndarray
    sent: int = 0
    #: when it sends next (None: its request is in flight)
    ready: Optional[float] = None

    def next_lengths(self) -> tuple[int, int]:
        j = self.sent % len(self.prompt_lens)
        return int(self.prompt_lens[j]), int(self.output_lens[j])


@dataclasses.dataclass
class Schedule:
    open: list[OpenRequest]
    workers: list[Worker]


def schedule(mix: dict, seed: int, seconds: float) -> Schedule:
    """Every open-loop arrival due in a window of ``seconds`` and every
    closed-loop worker, for the mix and the seed."""
    laws = mix["lengths"]
    opened: list[OpenRequest] = []
    workers: list[Worker] = []
    for t, ten in enumerate(mix["tenants"]):
        r = rng(seed, t, 0)
        if ten["arrivals"] == "poisson":
            rate = float(ten["rate_rps"])
            n = max(1, int(round(rate * seconds)))
            gaps = r.permutation(poisson_gaps(rate, n))
            due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
            prompts = r.permutation(law_values(laws["prompt"], n))
            outs = r.permutation(law_values(laws["output"], n))
            opened += [OpenRequest(float(d), t, k, int(p), int(o))
                       for k, (d, p, o) in enumerate(zip(due, prompts, outs))
                       if d < seconds]
        elif ten["arrivals"] == "closed":
            w = int(ten["workers"])
            prompts = r.permutation(law_values(laws["prompt"], w * CYCLE))
            outs = r.permutation(law_values(laws["output"], w * CYCLE))
            stagger = float(ten.get("stagger_s", 1.0))
            starts = r.permutation((np.arange(w) + 0.5) / w * stagger)
            workers += [Worker(t, i, float(starts[i]),
                               prompts[i * CYCLE:(i + 1) * CYCLE],
                               outs[i * CYCLE:(i + 1) * CYCLE])
                        for i in range(w)]
        else:
            raise ValueError(f"unknown arrivals {ten['arrivals']!r}")
    opened.sort(key=lambda q: (q.due, q.tenant, q.index))
    return Schedule(opened, workers)


def prompt_ids(seed: int, tenant: int, index: int, length: int,
               vocab: int) -> list[int]:
    """The token ids of one prompt: request ``index`` of open-loop
    tenant ``tenant``, or of a closed-loop worker's stream."""
    return rng(seed, tenant, 1, index).integers(
        0, vocab, length).tolist()


def mean_charged_tokens(mix: dict, n: int = 4096) -> float:
    """Mean prompt + output tokens of the mix's length laws (the tokens
    admission charges a request)."""
    laws = mix["lengths"]
    return float(law_values(laws["prompt"], n).mean()
                 + law_values(laws["output"], n).mean())
