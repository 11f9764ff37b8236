"""The engine's prompt prefill, captured in CUDA graphs by prompt length.

An eager prefill of a 24-layer model enqueues some seventy kernels a
layer, about 1,700 a prompt, and for any prompt shorter than a few
thousand tokens the card finishes the work before the host has finished
enqueueing it.  :class:`PrefillGraph` captures the whole prefill —
embedding, every layer with its page writes and its flash launch, the
final norm and the logits — once for each prompt-length bucket
:func:`buckets` names, and replays, for each prompt, the graph of the
smallest bucket that holds it.  Every kernel is the one the eager
prefill launches, on the same dtypes and in the same order, at the
bucket's length.

Buckets run four to an octave, each a multiple of the page: at 16-token
pages 16, 32, …, 256, 320, 384, 448, 512, 640, …, 7,168, 8,192, capped at
``max_seq`` (rounded up to a page).  A prompt pads at most a quarter of
its length, or less than a page.

The graphs read static inputs: tokens ``(1, largest bucket)`` int64, one
block-table row ``(1, max_pages)`` int32 and the last real position
``(1,)`` int64.  A prompt of n tokens fills the first n; its padded
positions hold token 0 and the table's unused entries (-1) hold the
scratch page, one page past those the ``KVBlockManager`` hands out.  So
a padded position writes its K/V either into the prompt's own last page,
in a slot past the prompt, which decode writes before it reads it
(decode at position p writes slot p and attends over p + 1 keys), or into
the scratch page.  The attention is causal and the rest of a layer of
attention and a dense MLP works row by row, so the real rows compute
what the unpadded prefill computes, up to the matmul algorithm cuBLAS
picks for the padded row count; the logits are taken at the last real
position (``transformer.prefill``'s ``last``) and returned in a tensor of
their own.

A bucket is captured on its first call, on a side stream, with one eager
run of the padded step there before the first capture only; the graphs
share a memory pool of their own.  They fix the addresses of the
parameters, the cache's pools and the static inputs, so they belong to
one engine's ``params`` and ``cache``; a call with other ones, an
``extra_embed``, more than one prompt, another table width or a prompt
longer than the largest bucket raises.  The engine takes this path
exactly where it takes the decode graphs (``decode_graph.graphable``).

The kernels' launch counters count what a replay launches, as for the
decode graphs: the warm-up and the capture leave them as they were, and
each replay adds the launches its capture recorded.
"""
from __future__ import annotations

import bisect

import torch

from repro_torch.models.runtime import LOCAL, Runtime
from repro_torch.models.transformer import prefill
from repro_torch.serving.decode_graph import StepGraphs

#: buckets an octave: base·(4, 5, 6, 7)/4 for each power of two base
STEPS_PER_OCTAVE = 4


def buckets(max_seq: int, page: int) -> list[int]:
    """The prompt lengths a :class:`PrefillGraph` captures: four an
    octave, each rounded up to a multiple of ``page``, from one page to
    ``max_seq`` rounded up to a page."""
    top = -(-max_seq // page) * page
    sizes, base = {top}, 1
    while base < top:
        for k in range(STEPS_PER_OCTAVE):
            b = -(-base * (STEPS_PER_OCTAVE + k)
                  // (STEPS_PER_OCTAVE * page)) * page
            if b < top:
                sizes.add(b)
        base *= 2
    return sorted(sizes)


class PrefillGraph(StepGraphs):
    """``prefill(params, tokens, cache, block_tables, lanes, rt)`` of one
    prompt through a CUDA graph per length bucket (see the module
    docstring).  ``scratch`` is the page padded positions write past the
    prompt's pages."""

    def __init__(self, params, cache, max_seq: int, page_tokens: int,
                 max_pages: int, scratch: int) -> None:
        super().__init__(params, cache)
        dev = params.device
        self.sizes = buckets(max_seq, page_tokens)
        if self.sizes[-1] > max_pages * page_tokens:
            raise ValueError(f"PrefillGraph: a table of {max_pages} pages "
                             f"does not hold {self.sizes[-1]} tokens")
        self.scratch = scratch
        self.tokens = torch.zeros((1, self.sizes[-1]), dtype=torch.long,
                                  device=dev)
        self.table = torch.zeros((1, max_pages), dtype=torch.int32,
                                 device=dev)
        self.last = torch.zeros((1,), dtype=torch.long, device=dev)

    def bucket_for(self, n: int) -> int:
        """The smallest bucket that holds a prompt of ``n`` tokens."""
        if not 1 <= n <= self.sizes[-1]:
            raise ValueError(f"PrefillGraph: a prompt of {n} tokens, the "
                             f"graphs hold 1 to {self.sizes[-1]}")
        return self.sizes[bisect.bisect_left(self.sizes, n)]

    def load(self, tokens, block_tables, bucket: int) -> None:
        """The prompt into the first positions, token 0 into the rest up
        to ``bucket``; the table with the scratch page for each -1."""
        n = tokens.shape[1]
        self.tokens[:, :n].copy_(tokens)
        self.tokens[:, n:bucket].zero_()
        self.table.copy_(block_tables)
        self.table.masked_fill_(self.table < 0, self.scratch)
        self.last.fill_(n - 1)

    def step(self, bucket: int) -> torch.Tensor:
        """The padded prefill at ``bucket`` tokens, (1, 1, V) logits at
        the last real position: what the graph of that bucket holds."""
        return prefill(self.params, self.tokens[:, :bucket], self.cache,
                       self.table, last=self.last)

    def __call__(self, params, tokens: torch.Tensor, cache,
                 block_tables: torch.Tensor, lanes=None,
                 extra_embed=None, rt: Runtime = LOCAL) -> torch.Tensor:
        """(1, 1, V) logits at the prompt's last position.  ``lanes`` and
        ``rt`` are the engine's, which ``graphable`` judged when it chose
        this path; the graphs do not read them."""
        self.check(params, cache)
        if extra_embed is not None:
            raise ValueError("PrefillGraph: a prompt with extra_embed "
                             "prefills eagerly")
        if tokens.shape[0] != 1:
            raise ValueError(f"PrefillGraph: {tokens.shape[0]} prompts, the "
                             "graphs hold one")
        if tuple(block_tables.shape) != tuple(self.table.shape):
            raise ValueError(f"PrefillGraph: a block table of shape "
                             f"{tuple(block_tables.shape)}, the graphs' is "
                             f"{tuple(self.table.shape)}")
        bucket = self.bucket_for(tokens.shape[1])
        self.load(tokens, block_tables, bucket)
        return self.replay(bucket).clone()
