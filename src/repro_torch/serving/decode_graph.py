"""The engine's batched decode step, captured in CUDA graphs.

An eager decode step of a 24-layer model enqueues about a thousand
kernels, each through PyTorch's dispatcher or a ``ctypes`` launch, and
the host's enqueue, not the card, sets the step's pace.
:class:`DecodeGraph` captures the whole step — embedding, every layer
with its K/V slot write and its paged-attention launch, the final norm
and the logits — once for each of the row counts :func:`row_counts`
names, and replays, on each decode step, the graph of the fewest rows
that holds the step's lanes.  Every kernel is the one the eager step
launches, on the same dtypes and in the same order.

The graphs read one set of static inputs, a graph of r rows its first
r: tokens ``(slots, 1)`` int64, positions ``(slots,)`` int32 and block
tables ``(slots, max_pages)`` int32.  A call's lanes fill the rows from
the top in the caller's order: the rows of a dense attention step do
not interact, and a lane's cache is reached through its block table
alone.  An idle row (past the call's lanes, up to the graph's row
count) holds token 0 at position 0 with a table whose first entry is
the scratch page, one page past those the ``KVBlockManager`` hands out,
so its K/V write lands there and never on a live page; its attention is
over that one key, and its logits are dropped.  The paged kernel's grid
is fixed at capture, so it still launches a CTA for every chunk of an
idle row's table, each leaving at once.  At a few active lanes of 32
those would be most of the kernel's time, so every row count up to 8
has a graph of its own (no idle row), and above 8 there is a graph
every 4 rows (at most 3 idle rows, under a quarter).  A call
returns the logits of its lanes in a tensor of their own.

A row count is captured on its first call, on a side stream; before the
first capture one eager run of the padded step there makes what a
capture may not (the stream's cuBLAS handle and workspace, the kernel
modules), so later row counts capture at once.  All the graphs share one memory pool: they
replay one at a time on one stream, and each replay's logits are copied
out before the next, so one graph's temporaries may lie where another's
were.  The graphs fix the addresses of the parameters, the cache's
pools and the static inputs, so they belong to one engine's ``params``
and ``cache``; a call with other ones, another table width or more rows
than lanes raises.

Which engines take it (:func:`graphable`, which also chooses the
prefill graphs of ``prefill_graph``): parameters on CUDA, an unsharded
runtime, the library's own ``prefill`` and ``decode_step``, and every
layer an attention layer with a dense MLP.  A MoE layer's expert capacity
depends on the number of rows (fault C9), so a padded row would take
capacity from live ones; a recurrent layer gathers its lanes' state
rows; a sharded step runs host-staged collectives.  Those decode
eagerly over the active lanes.

The kernels' launch counters (``repro_torch.kernels.launch_counts``)
count what a replay launches: the warm-up and the capture leave them as
they were, and each replay adds the launches its capture recorded.
"""
from __future__ import annotations

import bisect

import torch

from repro_torch.kernels import (add_launches, launch_counts,
                                 launches_between, set_launch_counts)
from repro_torch.models.runtime import LOCAL, Runtime
from repro_torch.models.transformer import ATTN_KINDS, decode_step, prefill


def graphable(model, params, rt: Runtime) -> bool:
    """Whether an engine serving ``model`` over ``params`` under ``rt``
    decodes through a :class:`DecodeGraph` and prefills through a
    ``prefill_graph.PrefillGraph``."""
    return (params.device.type == "cuda" and not rt.sharded
            and model.decode_step is decode_step
            and model.prefill is prefill
            and all(layer.kind in ATTN_KINDS and not layer.is_moe
                    for layer in params.layers))


#: every row count up to this one has a graph of its own; above it, one
#: every ``ROW_STEP`` rows
EXACT_ROWS, ROW_STEP = 8, 4


def row_counts(slots: int) -> list[int]:
    """The row counts a :class:`DecodeGraph` over ``slots`` lanes
    captures: each up to ``EXACT_ROWS``, then each multiple of
    ``ROW_STEP``, and ``slots``."""
    sizes = list(range(1, min(slots, EXACT_ROWS) + 1))
    sizes += range(EXACT_ROWS + ROW_STEP, slots, ROW_STEP)
    return sizes + [slots] if sizes[-1] < slots else sizes


class StepGraphs:
    """CUDA graphs of one step, one for each of its sizes, in one memory
    pool and captured on one side stream; a subclass loads the static
    inputs and names the step of a size (:meth:`step`)."""

    def __init__(self, params, cache) -> None:
        self.params, self.cache = params, cache
        #: by size: the graph, its output, its launches a replay
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.logits: dict[int, torch.Tensor] = {}
        self.launches: dict[int, dict] = {}
        #: the graphs' shared memory pool and capture stream (at the
        #: first capture)
        self.pool = self.stream = None
        self.captures = self.replays = 0

    def step(self, size: int) -> torch.Tensor:
        raise NotImplementedError

    def check(self, params, cache) -> None:
        if params is not self.params or cache is not self.cache:
            raise ValueError(f"{type(self).__name__}: the graphs read the "
                             "parameters and the cache they were built over")

    def capture(self, size: int) -> None:
        """Capture :meth:`step` on the side stream (warmed up there
        first, the first time)."""
        saved = launch_counts()
        dev = self.params.device
        stream = self.stream
        if stream is None:
            self.pool = torch.cuda.graph_pool_handle()
            stream = self.stream = torch.cuda.Stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                self.step(size)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        # capture_begin/end without ``torch.cuda.graph``'s synchronise
        # and emptying of the allocator's caches before every capture,
        # which a set-up of many captures in a row would pay each time
        with torch.cuda.stream(stream):
            graph.capture_begin(pool=self.pool)
            try:
                before = launch_counts()
                self.logits[size] = self.step(size)
                after = launch_counts()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.launches[size] = launches_between(before, after)
        set_launch_counts(saved)
        self.graphs[size] = graph
        self.captures += 1

    def replay(self, size: int) -> torch.Tensor:
        """Replay the graph of ``size`` (captured first, on its first
        use) over the static inputs as loaded; its output, which the
        next replay overwrites."""
        if size not in self.graphs:
            self.capture(size)
        self.graphs[size].replay()
        self.replays += 1
        add_launches(self.launches[size])
        return self.logits[size]


class DecodeGraph(StepGraphs):
    """``decode_step(params, tokens, cache, block_tables, positions,
    lanes, rt)`` through a CUDA graph per row count over ``slots``
    lanes (see the module docstring).  ``scratch`` is the page idle rows
    write."""

    def __init__(self, params, cache, slots: int, max_pages: int,
                 scratch: int) -> None:
        super().__init__(params, cache)
        dev = params.device
        self.sizes = row_counts(slots)
        self.tokens = torch.zeros((slots, 1), dtype=torch.long, device=dev)
        self.positions = torch.zeros((slots,), dtype=torch.int32, device=dev)
        self.idle_table = torch.full((max_pages,), -1, dtype=torch.int32,
                                     device=dev)
        self.idle_table[0] = scratch
        self.tables = self.idle_table.repeat(slots, 1)

    def rows_for(self, n: int) -> int:
        """The fewest rows of a graph that holds ``n`` lanes."""
        if not 1 <= n <= self.sizes[-1]:
            raise ValueError(f"DecodeGraph: {n} rows, the graphs hold "
                             f"1 to {self.sizes[-1]}")
        return self.sizes[bisect.bisect_left(self.sizes, n)]

    def load(self, tokens, block_tables, positions, rows: int) -> None:
        """The call's lanes into the first rows, the idle pattern into
        the rest up to ``rows``."""
        n = tokens.shape[0]
        self.tokens[:n].copy_(tokens)
        self.tokens[n:rows].zero_()
        self.positions[:n].copy_(positions)
        self.positions[n:rows].zero_()
        self.tables[:n].copy_(block_tables)
        self.tables[n:rows].copy_(self.idle_table.expand(rows - n, -1))

    def step(self, rows: int) -> torch.Tensor:
        """The padded step of ``rows`` rows, (rows, 1, V) logits: what
        the graph of that row count holds."""
        return decode_step(self.params, self.tokens[:rows], self.cache,
                           self.tables[:rows], self.positions[:rows])

    def __call__(self, params, tokens: torch.Tensor, cache,
                 block_tables: torch.Tensor, positions: torch.Tensor,
                 lanes=None, rt: Runtime = LOCAL) -> torch.Tensor:
        """(B, 1, V) logits of the call's B lanes, in their order.
        ``lanes`` and ``rt`` are the engine's, which :func:`graphable`
        judged when it chose this path; the rows do not read them."""
        self.check(params, cache)
        if block_tables.shape[1] != self.tables.shape[1]:
            raise ValueError(f"DecodeGraph: block tables of "
                             f"{block_tables.shape[1]} pages, the graphs' "
                             f"are {self.tables.shape[1]} wide")
        n = tokens.shape[0]
        rows = self.rows_for(n)
        self.load(tokens, block_tables, positions, rows)
        return self.replay(rows)[:n].clone()
