"""Deterministic synthetic LM data pipeline, shard-aware.

The port's own copy of ``repro/data/pipeline.py`` (numpy only): the
same seeds give the same batches, row for row, so a run of either
package trains on the same tokens.

Produces structured pseudo-text (Markov-chain token streams with
repeated n-gram motifs) rather than uniform noise, so a ~100M model
trained for a few hundred steps shows a clearly falling loss — the
end-to-end example's acceptance signal.

Sharding model: the pipeline is *host-local* like a real multi-host
loader — ``shard(host_index, host_count)`` yields only this host's rows
of the global batch, derived from a counter-based PRNG so any host can
deterministically regenerate any step (elastic restart: a resumed job
re-derives batch ``k`` without replaying the stream; straggler
mitigation: a backup host can generate another host's shard).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_motifs: int = 64
    motif_len: int = 12
    branch: int = 4          # Markov branching factor


class SyntheticLMData:
    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        root = np.random.RandomState(cfg.seed)
        # fixed Markov table: each token has `branch` likely successors
        self._next = root.randint(
            0, cfg.vocab_size, size=(cfg.vocab_size, cfg.branch))
        # n-gram motifs injected at random offsets
        self._motifs = root.randint(
            0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len))

    def _gen_row(self, rng: np.random.RandomState) -> np.ndarray:
        cfg = self.cfg
        seq = np.empty(cfg.seq_len + 1, np.int32)
        tok = rng.randint(cfg.vocab_size)
        i = 0
        while i < cfg.seq_len + 1:
            if rng.rand() < 0.1:               # drop in a motif
                m = self._motifs[rng.randint(cfg.n_motifs)]
                take = min(len(m), cfg.seq_len + 1 - i)
                seq[i:i + take] = m[:take]
                i += take
                tok = int(seq[i - 1])
            else:
                tok = int(self._next[tok, rng.randint(cfg.branch)])
                seq[i] = tok
                i += 1
        return seq

    def global_batch_at(self, step: int) -> dict:
        """The full global batch for ``step`` (counter-based, stateless)."""
        cfg = self.cfg
        rows = []
        for b in range(cfg.global_batch):
            rng = np.random.RandomState(
                (cfg.seed * 1_000_003 + step) * 65_537 + b)
            rows.append(self._gen_row(rng))
        arr = np.stack(rows)                   # (B, S+1)
        return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}

    def shard_at(self, step: int, host_index: int, host_count: int) -> dict:
        """This host's rows of the global batch (contiguous row split)."""
        cfg = self.cfg
        assert cfg.global_batch % host_count == 0
        per = cfg.global_batch // host_count
        lo = host_index * per
        rows = []
        for b in range(lo, lo + per):
            rng = np.random.RandomState(
                (cfg.seed * 1_000_003 + step) * 65_537 + b)
            rows.append(self._gen_row(rng))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "targets": arr[:, 1:]}
