"""The engine's decode graphs (``serving/decode_graph.py``).

On the CPU: the padded step — exactly what a graph holds — at the
fewest rows that hold the lanes and at all 32, against today's
active-lane ``decode_step`` at one lane, nine lanes, all lanes and
lanes with holes, on a dense Llama-like and a gemma2-like config
(window, softcaps, post-norms, scaled embeddings); the idle rows' K/V
writes land on the scratch page only; the row counts; the path choice;
a call that does not fit the graphs; the launch counters a replay adds.

On a CUDA card (``-m cuda``; skipped without one): an engine serving 32
lanes for 72 decode steps, requests finishing and starting between
replays, against the same engine on the eager path — identical greedy
tokens, one capture, a replay a step, the same kernel launches by route
— the same as its lanes drain, through the graph of each row count;
and one replay with holes against the eager step within bf16's
tolerance.
"""
import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import (add_launches, launch_counts,
                                 launches_between, set_launch_counts)
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import Runtime, build_model
from repro_torch.models import transformer
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.decode_graph import (DecodeGraph, graphable,
                                              row_counts)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

SLOTS, PAGE = 32, 16
#: the occupancies: one lane, every lane, lanes with holes, and nine
#: lanes (a graph of 12 rows, 3 of them idle)
OCCUPANCY = {"one": [3], "all": list(range(SLOTS)), "holes": [0, 5, 6, 31],
             "nine": [1, 4, 6, 9, 13, 17, 22, 27, 30]}
#: float32 logits of the padded step against the active-lane step, as a
#: share of their largest magnitude (a one-row product takes another
#: summation order than a 32-row one on the CPU)
RTOL = 1e-5


def small(arch: str, dtype: str = "float32", **over):
    cfg = get_config(arch).reduced(dtype=dtype, vocab_size=512,
                                   max_seq_len=96, **over)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(1), "cpu")


@pytest.fixture(scope="module", params=["tinyllama-1.1b", "gemma2-2b"])
def dense(request):
    return small(request.param)


def lane_inputs(cfg, lanes, max_pages: int, seed: int):
    """Tokens, block tables, positions and lane ids of the active lanes:
    lane l owns pages l·max_pages onwards, at a seeded position."""
    r = np.random.default_rng(seed)
    n = len(lanes)
    pos = r.integers(1, cfg.max_seq_len - 1, n)
    tables = np.full((n, max_pages), -1, np.int32)
    for i, lane in enumerate(lanes):
        used = pos[i] // PAGE + 1
        tables[i, :used] = lane * max_pages + np.arange(used)
    return (torch.tensor(r.integers(0, cfg.vocab_size, (n, 1))),
            torch.from_numpy(tables), torch.tensor(pos, dtype=torch.int32),
            torch.tensor(lanes))


@pytest.mark.parametrize("occupancy", sorted(OCCUPANCY))
def test_padded_step_equals_the_active_lane_step(dense, occupancy):
    cfg, model, params = dense
    lanes = OCCUPANCY[occupancy]
    max_pages = cfg.max_seq_len // PAGE + 1
    scratch = SLOTS * max_pages
    rt = Runtime(kv_cache_dtype="float32")
    before = model.init_cache(scratch + 1, PAGE, rt, "cpu", lanes=SLOTS)
    g = torch.Generator().manual_seed(2)
    for pool in before.k + before.v:
        pool.normal_(generator=g)
    tokens, tables, positions, ids = lane_inputs(cfg, lanes, max_pages,
                                                 len(lanes))
    eager = copy.deepcopy(before)
    ref = transformer.decode_step(params, tokens, eager, tables, positions,
                                  lanes=ids)
    # the slots the active lanes write this step, and everything else
    pos = positions.long()
    pages = tables.gather(1, (pos // PAGE)[:, None])[:, 0].long()
    new = torch.zeros(scratch + 1, PAGE, dtype=torch.bool)
    new[pages, pos % PAGE] = True
    live = ~new
    live[scratch] = False
    graph = DecodeGraph(params, before, SLOTS, max_pages, scratch)
    # the graph the call takes, and the one of every lane
    for rows in sorted({graph.rows_for(len(lanes)), SLOTS}):
        graph.cache = copy.deepcopy(before)
        graph.load(tokens, tables, positions, rows)
        out = graph.step(rows)[:len(lanes)]

        assert out.shape == ref.shape == (len(lanes), 1, cfg.padded_vocab)
        assert torch.equal(out.argmax(-1), ref.argmax(-1))
        scale = float(ref.abs().max())
        assert float((out - ref).abs().max()) <= RTOL * scale
        idle = len(lanes) < rows
        for old, mine, theirs in zip(before.k + before.v,
                                     graph.cache.k + graph.cache.v,
                                     eager.k + eager.v):
            # idle rows write no live page: outside the new slots every
            # page is byte-equal to the eager run's, which wrote only
            # those slots
            assert torch.equal(mine[live], old[live])
            assert torch.equal(theirs[live], old[live])
            assert float((mine[new] - theirs[new]).abs().max()) <= \
                RTOL * float(theirs[new].abs().max())
            # the idle rows' token-0 K/V went to the scratch page's slot 0
            assert torch.equal(theirs[scratch], old[scratch])
            assert torch.equal(mine[scratch, 1:], old[scratch, 1:])
            assert torch.equal(mine[scratch, 0], old[scratch, 0]) != idle


@pytest.mark.parametrize("slots,sizes", [
    (1, [1]), (4, [1, 2, 3, 4]), (8, list(range(1, 9))),
    (13, list(range(1, 9)) + [12, 13]),
    (32, list(range(1, 9)) + [12, 16, 20, 24, 28, 32])])
def test_row_counts(slots, sizes):
    assert row_counts(slots) == sizes
    graph = DecodeGraph.__new__(DecodeGraph)
    graph.sizes = sizes
    # each lane count takes the fewest rows that hold it
    assert [graph.rows_for(n) for n in range(1, slots + 1)] == [
        min(r for r in sizes if r >= n) for n in range(1, slots + 1)]
    for n in (0, slots + 1):
        with pytest.raises(ValueError):
            graph.rows_for(n)


def fake_cuda(params):
    """``params`` as the path choice sees them, on a CUDA device."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 layers=params.layers)


@pytest.mark.parametrize("arch,graphed", [
    ("tinyllama-1.1b", True), ("gemma2-2b", True), ("internvl2-2b", True),
    ("qwen3-moe-30b-a3b", False), ("recurrentgemma-2b", False),
    ("xlstm-350m", False)])
def test_path_choice_by_layer_kind(arch, graphed):
    _, model, params = small(arch)
    assert graphable(model, fake_cuda(params), Runtime()) is graphed
    # on the CPU every model decodes eagerly
    assert not graphable(model, params, Runtime())


def test_path_choice_sharded_or_wrapped_is_eager():
    _, model, params = small("tinyllama-1.1b")
    assert not graphable(model, fake_cuda(params), Runtime(mesh=object()))
    wrapped = dataclasses.replace(
        model, decode_step=lambda *a, **k: model.decode_step(*a, **k))
    assert not graphable(wrapped, fake_cuda(params), Runtime())


def test_a_cpu_engine_decodes_eagerly_with_no_scratch_page():
    cfg, model, params = small("tinyllama-1.1b")
    eng = InferenceEngine(model, params, slots=4, max_seq=cfg.max_seq_len)
    assert eng.decode_graph is None
    assert eng.model.decode_step is transformer.decode_step
    assert eng.cache.k[0].shape[0] == eng.kv_pages.total_pages


@pytest.mark.parametrize("misfit", ["params", "cache", "table width",
                                    "rows"])
def test_a_call_that_does_not_fit_raises(misfit):
    cfg, model, params = small("tinyllama-1.1b")
    max_pages = cfg.max_seq_len // PAGE + 1
    cache = model.init_cache(SLOTS * max_pages + 1, PAGE, Runtime(), "cpu",
                             lanes=SLOTS)
    graph = DecodeGraph(params, cache, SLOTS, max_pages, SLOTS * max_pages)
    lanes = list(range(SLOTS + 1)) if misfit == "rows" else [1, 2]
    tokens, tables, positions, ids = lane_inputs(cfg, lanes, max_pages, 0)
    call = {"params": params, "tokens": tokens, "cache": cache,
            "block_tables": tables, "positions": positions}
    if misfit == "params":
        call["params"] = copy.deepcopy(params)
    elif misfit == "cache":
        call["cache"] = copy.deepcopy(cache)
    elif misfit == "table width":
        call["block_tables"] = tables[:, :-1]
    with pytest.raises(ValueError):
        graph(**call, lanes=ids)
    assert (graph.replays, graph.captures) == (0, 0)
    assert not graph.graphs


def test_a_replay_adds_the_captured_launches():
    """The deltas are applied to the counters as they are at replay
    time, so a caller that swaps a counter's dict still counts; a
    capture's counts go back as they were."""
    saved = launch_counts()
    try:
        before = launch_counts()
        paged_attention.launches += 24
        paged_attention.route_launches["split"] += 24
        delta = launches_between(before, launch_counts())
        assert delta["paged_attention"]["launches"] == 24
        assert delta["paged_attention"]["route_launches"]["split"] == 24
        assert delta["flash_attention"]["launches"] == 0
        set_launch_counts(before)
        assert launch_counts() == before
        paged_attention.launches = 1
        paged_attention.route_launches = dict.fromkeys(
            saved["paged_attention"]["route_launches"], 0)
        add_launches(delta)
        add_launches(delta)
        assert paged_attention.launches == 49
        assert paged_attention.route_launches["split"] == 48
        assert paged_attention.route_launches["group"] == 0
    finally:
        paged_attention.route_launches = dict(
            saved["paged_attention"]["route_launches"])
        set_launch_counts(saved)


def test_every_kernel_entry_point_has_its_counters():
    counts = launch_counts()
    assert set(counts) == {"admit_quantum", "flash_attention",
                           "paged_attention"}
    for kernel, counters in counts.items():
        assert isinstance(counters["launches"], int), kernel
        assert isinstance(counters["route_launches"], dict), kernel
    assert "windowed_launches" in counts["paged_attention"]


# -- on a CUDA card -------------------------------------------------------------
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured there")


#: a SmolLM2-like attention (32/32 heads of 64: the split route) and a
#: gemma2-like one (G 2 at dh 64 with a window: the group route)
CUDA_CONFIGS = {"llama": ("tinyllama-1.1b", dict(num_heads=4, num_kv_heads=4,
                                                  head_dim=64, d_model=256,
                                                  d_ff=512)),
                "gemma2": ("gemma2-2b", dict(num_heads=4, num_kv_heads=2,
                                             head_dim=64, d_model=256,
                                             d_ff=512))}


def cuda_model(name: str):
    arch, over = CUDA_CONFIGS[name]
    cfg = get_config(arch).reduced(dtype="bfloat16", vocab_size=512,
                                   max_seq_len=256, **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(3),
                        "cuda")
    return cfg, model, params


def serve_steps(eng, cfg, steps=None):
    """Keep every lane busy for ``steps`` decode steps: requests of 3–24
    tokens, so that some finish and new ones start between steps.  With
    ``steps`` None, 40 requests run to their end: every lane busy, then
    the lanes draining one by one.  Returns the requests' tokens and
    each decode step's lane count."""
    r = np.random.default_rng(4)
    n = 40 * SLOTS if steps else 40
    reqs = [Request(f"r{i}", "t", r.integers(
        0, cfg.vocab_size, int(r.integers(4, 40))).tolist(),
        int(r.integers(3, 25)), 0.0) for i in range(n)]
    for q in reqs:
        eng.submit(q, 0.0)
    lanes = []
    if steps:
        for _ in range(steps):
            lanes.append(eng.step(0.0))
        # a step fills its free lanes from the queue before it decodes,
        # so with requests still queued every step decoded all the lanes
        assert eng.queue
    else:
        while eng.queue or any(l.request for l in eng.lanes):
            lanes.append(eng.step(0.0))
    torch.cuda.synchronize()
    return [list(q.output_tokens) for q in reqs], lanes


def serve_both_paths(name: str, steps=None):
    """The same requests served through the graphs and on the eager
    path: the same tokens, launches by route and lanes a step.  Returns
    the engine's decode graph and each step's lane count."""
    cfg, model, params = cuda_model(name)
    eager_model = dataclasses.replace(
        model, decode_step=lambda *a, **k: model.decode_step(*a, **k))
    out, launches, graphs, lanes = {}, {}, {}, {}
    for path, m in (("graph", model), ("eager", eager_model)):
        eng = InferenceEngine(m, params, slots=SLOTS,
                              max_seq=cfg.max_seq_len, page_tokens=PAGE)
        assert (eng.decode_graph is None) == (path == "eager")
        paged_attention.launches = 0
        paged_attention.route_launches = dict.fromkeys(
            paged_attention.route_launches, 0)
        paged_attention.windowed_launches = 0
        out[path], lanes[path] = serve_steps(eng, cfg, steps)
        launches[path] = (paged_attention.launches,
                          dict(paged_attention.route_launches),
                          paged_attention.windowed_launches)
        graphs[path] = eng.decode_graph
    assert out["graph"] == out["eager"]
    assert launches["graph"] == launches["eager"]
    assert launches["graph"][0] > 0
    assert lanes["graph"] == lanes["eager"]
    return graphs["graph"], lanes["graph"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CONFIGS))
def test_cuda_graph_serves_as_the_eager_path(name):
    card()
    g, lanes = serve_both_paths(name, 72)
    assert lanes == [SLOTS] * 72
    assert (g.captures, g.replays, set(g.graphs)) == (1, 72, {SLOTS})


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CONFIGS))
def test_cuda_graphs_by_row_count_serve_as_the_eager_path(name):
    """As the lanes drain, each step takes the graph of the fewest rows
    that holds its lanes, captured once."""
    card()
    g, lanes = serve_both_paths(name)
    steps = [n for n in lanes if n]
    assert set(g.graphs) == {g.rows_for(n) for n in steps}
    assert g.captures == len(g.graphs) >= 3
    assert g.replays == len(steps)


@pytest.mark.cuda
@pytest.mark.parametrize("occupancy", sorted(OCCUPANCY))
def test_cuda_replay_with_holes_within_bf16(occupancy):
    card()
    cfg, model, params = cuda_model("gemma2")
    lanes = OCCUPANCY[occupancy]
    max_pages = cfg.max_seq_len // PAGE + 1
    scratch = SLOTS * max_pages
    cache = model.init_cache(scratch + 1, PAGE, Runtime(), "cuda",
                             lanes=SLOTS)
    g = torch.Generator(device="cuda").manual_seed(5)
    for pool in cache.k + cache.v:
        pool.normal_(generator=g)
    tokens, tables, positions, ids = (
        t.cuda() for t in lane_inputs(cfg, lanes, max_pages, 6))
    eager = copy.deepcopy(cache)
    ref = transformer.decode_step(params, tokens, eager, tables, positions,
                                  lanes=ids)
    graph = DecodeGraph(params, cache, SLOTS, max_pages, scratch)
    for _ in range(2):                  # the capture's call, then a replay
        out = graph(params, tokens, cache, tables, positions, lanes=ids)
    torch.cuda.synchronize()
    assert (graph.captures, graph.replays) == (1, 2)
    assert set(graph.graphs) == {graph.rows_for(len(lanes))}
    err = (out.float() - ref.float()).abs()
    assert bool((err <= 2e-2 + 2e-2 * ref.float().abs()).all())
