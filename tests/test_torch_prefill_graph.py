"""The engine's prefill graphs (``serving/prefill_graph.py``).

On the CPU: the padded prefill — exactly what a graph holds — against
today's unpadded ``transformer.prefill`` on a dense Llama-like and a
gemma2-like config (window, softcaps, post-norms), at prompt lengths on,
just over and just under bucket edges: the last position's logits and
the K/V of every real slot; padded positions write only the scratch page
or the prompt's own last page past its end, never the pool's last page
(which a -1 in the table would index); the bucket ladder and its padding
bound; the path choice, which is the decode graphs' (by layer kind in
``tests/test_torch_decode_graph.py``), with a wrapped prefill or a
sharded runtime eager; misfit calls; the launch counters a replay adds;
``last`` at S - 1 is the default.

On a CUDA card (``-m cuda``; skipped without one): prompts across
several buckets prefilled through an engine's graphs against the eager
prefill, logits and pages within bf16's tolerance, one capture a bucket
and one replay a prefill; and an engine served through both graph paths
against the same engine eager, the same launches by route.
"""
import copy
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import launch_counts, set_launch_counts
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import Runtime, build_model
from repro_torch.models import transformer
from repro_torch.serving import InferenceEngine, Request
from repro_torch.serving.decode_graph import graphable
from repro_torch.serving.prefill_graph import PrefillGraph, buckets
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

PAGE, SLOTS = 16, 4
#: prompt lengths at, just over and just under the edges of the buckets
#: 16, 32, …, 128, 160 (max_seq 160); from 129 the padding passes the
#: prompt's last page
LENGTHS = [1, 15, 16, 17, 47, 48, 49, 96, 97, 127, 128, 129, 130, 145,
           159, 160]
#: float32 logits and K/V of the padded prefill against the unpadded
#: one, as a share of their largest magnitude (a product of more rows
#: may take another summation order on the CPU)
RTOL = 1e-5


def small(arch: str, dtype: str = "float32", **over):
    cfg = get_config(arch).reduced(dtype=dtype, vocab_size=512,
                                   max_seq_len=160, **over)
    model = build_model(cfg)
    return cfg, model, model.init(torch.Generator().manual_seed(1), "cpu")


@pytest.fixture(scope="module", params=["tinyllama-1.1b", "gemma2-2b"])
def dense(request):
    return small(request.param)


def prompt_inputs(cfg, n: int, max_pages: int, lane: int, seed: int):
    """A prompt of ``n`` tokens and its table: the pages of lane
    ``lane``, -1 past the ``ceil(n / PAGE)`` it holds."""
    r = np.random.default_rng(seed)
    table = np.full((1, max_pages), -1, np.int32)
    used = -(-n // PAGE)
    table[0, :used] = lane * max_pages + np.arange(used)
    return (torch.tensor(r.integers(0, cfg.vocab_size, (1, n))),
            torch.from_numpy(table))


def graph_over(params, cache, cfg, max_pages: int, scratch: int):
    return PrefillGraph(params, cache, cfg.max_seq_len, PAGE, max_pages,
                        scratch)


@pytest.mark.parametrize("n", LENGTHS)
def test_padded_prefill_equals_the_prefill(dense, n):
    cfg, model, params = dense
    max_pages = cfg.max_seq_len // PAGE + 1
    # the scratch page is not the pool's last: a -1 left in the table
    # would write the last page, which must stay as it was
    scratch = SLOTS * max_pages
    rt = Runtime(kv_cache_dtype="float32")
    before = model.init_cache(scratch + 2, PAGE, rt, "cpu", lanes=SLOTS)
    g = torch.Generator().manual_seed(2)
    for pool in before.k + before.v:
        pool.normal_(generator=g)
    tokens, table = prompt_inputs(cfg, n, max_pages, 2, n)
    eager = copy.deepcopy(before)
    ref = transformer.prefill(params, tokens, eager, table)

    graph = graph_over(params, copy.deepcopy(before), cfg, max_pages,
                       scratch)
    bucket = graph.bucket_for(n)
    assert bucket >= n and bucket - n < max(PAGE, n / 4)
    graph.load(tokens, table, bucket)
    out = graph.step(bucket)
    assert out.shape == ref.shape == (1, 1, cfg.padded_vocab)
    assert torch.equal(out.argmax(-1), ref.argmax(-1))
    assert float((out - ref).abs().max()) <= RTOL * float(ref.abs().max())

    # the slots the prompt writes; its own last page past the prompt;
    # the scratch page; everything else
    pages = table[0, :-(-n // PAGE)].long()
    real = torch.zeros(scratch + 2, PAGE, dtype=torch.bool)
    real.view(-1)[(pages[:, None] * PAGE
                   + torch.arange(PAGE)).view(-1)[:n]] = True
    own = torch.zeros_like(real)
    own[pages] = True
    own &= ~real
    live = ~(real | own)
    live[scratch] = False
    padded = bucket > n
    for old, mine, theirs in zip(before.k + before.v,
                                 graph.cache.k + graph.cache.v,
                                 eager.k + eager.v):
        assert torch.equal(theirs[~real], old[~real])
        assert float((mine[real] - theirs[real]).abs().max()) <= \
            RTOL * float(theirs[real].abs().max())
        # padded positions write no page but the scratch page and the
        # prompt's own last page past its end
        assert torch.equal(mine[live], old[live])
        assert torch.equal(mine[-1], old[-1])
        wrote = not torch.equal(mine[scratch], old[scratch]) or \
            not torch.equal(mine[own], old[own])
        assert wrote == padded


def test_last_at_the_end_is_the_default(dense):
    cfg, model, params = dense
    max_pages = cfg.max_seq_len // PAGE + 1
    tokens, table = prompt_inputs(cfg, 37, max_pages, 0, 3)
    cache = model.init_cache(SLOTS * max_pages, PAGE, Runtime(), "cpu",
                             lanes=SLOTS)
    ref = transformer.prefill(params, tokens, cache, table)
    out = transformer.prefill(params, tokens, cache, table,
                              last=torch.tensor([36]))
    assert torch.equal(out, ref)


#: the cells' ladder from 256 on (max_seq 8,192, 16-token pages)
CELL_LADDER = [256, 320, 384, 448, 512, 640, 768, 896, 1024, 1280, 1536,
               1792, 2048, 2560, 3072, 3584, 4096, 5120, 6144, 7168, 8192]


@pytest.mark.parametrize("max_seq,page,low", [
    (8192, 16, [16, 32, 48, 64, 80, 96, 112, 128, 160, 192, 224]),
    (96, 16, [16, 32, 48, 64, 80, 96]),
    (100, 16, [16, 32, 48, 64, 80, 96, 112]),
    (4736, 64, [64, 128, 192, 256, 320, 384, 448, 512]),
    (8, 16, [16])])
def test_buckets(max_seq, page, low):
    sizes = buckets(max_seq, page)
    assert sizes[:len(low)] == low
    if max_seq == 8192:
        assert sizes[len(low):] == CELL_LADDER
    assert sizes == sorted(set(sizes))
    assert all(b % page == 0 for b in sizes)
    # capped at max_seq, rounded up to a page
    assert sizes[-1] == -(-max_seq // page) * page
    graph = PrefillGraph.__new__(PrefillGraph)
    graph.sizes = sizes
    for n in range(1, sizes[-1] + 1):
        b = graph.bucket_for(n)
        assert b == min(s for s in sizes if s >= n)
        # a quarter of the prompt at most, or less than a page
        assert b - n <= max(n / 4, page - 1)
    for n in (0, sizes[-1] + 1):
        with pytest.raises(ValueError):
            graph.bucket_for(n)


def fake_cuda(params):
    """``params`` as the path choice sees them, on a CUDA device."""
    return types.SimpleNamespace(device=torch.device("cuda"),
                                 layers=params.layers)


def test_path_choice_sharded_or_wrapped_prefill_is_eager():
    _, model, params = small("tinyllama-1.1b")
    assert not graphable(model, fake_cuda(params), Runtime(mesh=object()))
    wrapped = dataclasses.replace(
        model, prefill=lambda *a, **k: model.prefill(*a, **k))
    assert not graphable(wrapped, fake_cuda(params), Runtime())


def test_a_cpu_engine_prefills_eagerly():
    cfg, model, params = small("tinyllama-1.1b")
    eng = InferenceEngine(model, params, slots=SLOTS,
                          max_seq=cfg.max_seq_len)
    assert eng.prefill_graph is None
    assert eng.model.prefill is transformer.prefill


@pytest.mark.parametrize("misfit", ["params", "cache", "extra_embed",
                                    "two prompts", "table width",
                                    "too long"])
def test_a_call_that_does_not_fit_raises(misfit):
    cfg, model, params = small("tinyllama-1.1b")
    max_pages = cfg.max_seq_len // PAGE + 1
    cache = model.init_cache(SLOTS * max_pages + 1, PAGE, Runtime(), "cpu",
                             lanes=SLOTS)
    graph = graph_over(params, cache, cfg, max_pages, SLOTS * max_pages)
    n = graph.sizes[-1] + 1 if misfit == "too long" else 20
    tokens, table = prompt_inputs(cfg, min(n, max_pages * PAGE), max_pages,
                                  0, 0)
    call = {"params": params, "tokens": tokens, "cache": cache,
            "block_tables": table}
    if misfit == "params":
        call["params"] = copy.deepcopy(params)
    elif misfit == "cache":
        call["cache"] = copy.deepcopy(cache)
    elif misfit == "extra_embed":
        call["extra_embed"] = torch.zeros(1, 2, cfg.d_model)
    elif misfit == "two prompts":
        call["tokens"] = tokens.repeat(2, 1)
        call["block_tables"] = table.repeat(2, 1)
    elif misfit == "table width":
        call["block_tables"] = table[:, :-1]
    with pytest.raises(ValueError):
        graph(**call, lanes=torch.tensor([0]))
    assert (graph.replays, graph.captures) == (0, 0)
    assert not graph.graphs


class FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_a_replay_adds_the_captured_launches():
    """A call replays its bucket's graph once, adds the launches its
    capture recorded to the counters as they stand, and returns logits
    of its own."""
    cfg, model, params = small("tinyllama-1.1b")
    max_pages = cfg.max_seq_len // PAGE + 1
    cache = model.init_cache(SLOTS * max_pages + 1, PAGE, Runtime(), "cpu",
                             lanes=SLOTS)
    graph = graph_over(params, cache, cfg, max_pages, SLOTS * max_pages)
    tokens, table = prompt_inputs(cfg, 40, max_pages, 1, 0)
    bucket = graph.bucket_for(40)
    fake, layers = FakeGraph(), cfg.num_layers
    graph.graphs[bucket] = fake
    graph.logits[bucket] = torch.ones(1, 1, cfg.padded_vocab)
    graph.launches[bucket] = {
        "flash_attention": {"launches": layers,
                            "route_launches": {"wgmma": layers}},
        "paged_attention": {"launches": 0}}
    saved = launch_counts()
    try:
        for k in (1, 2):
            out = graph(params, tokens, cache, table,
                        lanes=torch.tensor([1]))
            assert fake.replays == graph.replays == k
            assert flash_attention.launches == \
                saved["flash_attention"]["launches"] + k * layers
            assert flash_attention.route_launches["wgmma"] == \
                saved["flash_attention"]["route_launches"]["wgmma"] \
                + k * layers
            assert paged_attention.launches == \
                saved["paged_attention"]["launches"]
        assert graph.captures == 0
        assert out.data_ptr() != graph.logits[bucket].data_ptr()
        assert torch.equal(out, graph.logits[bucket])
        # the static inputs as the graph reads them
        assert torch.equal(graph.tokens[:, :40], tokens)
        assert not graph.tokens[:, 40:bucket].any()
        assert int(graph.last) == 39
        assert int(graph.table.min()) >= 0
        assert torch.equal(graph.table[0, :3], table[0, :3])
        assert bool((graph.table[0, 3:] == SLOTS * max_pages).all())
    finally:
        set_launch_counts(saved)


# -- on a CUDA card -------------------------------------------------------------
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the graph is captured there")


#: a SmolLM2-like attention (32/32 heads of 64 in miniature) and a
#: gemma2-like one (G 2 at dh 64 with a window)
CUDA_CONFIGS = {"llama": ("tinyllama-1.1b", dict(num_heads=4, num_kv_heads=4,
                                                  head_dim=64, d_model=256,
                                                  d_ff=512)),
                "gemma2": ("gemma2-2b", dict(num_heads=4, num_kv_heads=2,
                                             head_dim=64, d_model=256,
                                             d_ff=512))}
#: prompt lengths in seven buckets of the ladder to 512, some twice
CUDA_LENGTHS = [17, 100, 128, 129, 200, 256, 257, 300, 311, 500, 96]
#: bf16, as the decode graphs' CUDA tests hold a replay
ATOL = RTOL_BF16 = 2e-2


def cuda_model(name: str):
    arch, over = CUDA_CONFIGS[name]
    cfg = get_config(arch).reduced(dtype="bfloat16", vocab_size=512,
                                   max_seq_len=512, **over)
    model = build_model(cfg)
    params = model.init(torch.Generator(device="cuda").manual_seed(3),
                        "cuda")
    return cfg, model, params


def within_bf16(out, ref) -> bool:
    err = (out.float() - ref.float()).abs()
    return bool((err <= ATOL + RTOL_BF16 * ref.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CONFIGS))
def test_cuda_prefill_graph_as_the_eager_prefill(name):
    card()
    cfg, model, params = cuda_model(name)
    eng = InferenceEngine(model, params, slots=SLOTS,
                          max_seq=cfg.max_seq_len, page_tokens=PAGE)
    graph = eng.prefill_graph
    assert graph is not None and eng.model.prefill is graph
    kv = eng.kv_pages
    g = torch.Generator(device="cuda").manual_seed(4)
    for i, n in enumerate(CUDA_LENGTHS):
        rid = f"p{i}"
        kv.allocate(rid, n)
        table = torch.from_numpy(
            kv.block_table(rid, eng.max_pages)[None]).cuda()
        tokens = torch.randint(0, cfg.vocab_size, (1, n), device="cuda",
                               generator=g)
        eager = copy.deepcopy(eng.cache)
        ref = transformer.prefill(params, tokens, eager, table)
        out = eng.model.prefill(params, tokens, eng.cache, table,
                                lanes=torch.tensor([0], device="cuda"))
        torch.cuda.synchronize()
        assert within_bf16(out, ref), (name, n)
        pages = table[0, :-(-n // PAGE)].long()
        for mine, theirs in zip(eng.cache.k + eng.cache.v,
                                eager.k + eager.v):
            real = lambda t: t[pages].flatten(0, 1)[:n]  # noqa: E731
            assert within_bf16(real(mine), real(theirs)), (name, n)
        kv.free(rid)
    want = {graph.bucket_for(n) for n in CUDA_LENGTHS}
    assert set(graph.graphs) == want
    assert graph.captures == len(want) < len(CUDA_LENGTHS)
    assert graph.replays == len(CUDA_LENGTHS)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CUDA_CONFIGS))
def test_cuda_engine_on_the_graphs_launches_as_the_eager_engine(name):
    """Requests of 20–480 prompt tokens served through both graph paths
    and through the same engine with its entry points wrapped (eager):
    the same kernel launches by route, a replay a prefill."""
    card()
    cfg, model, params = cuda_model(name)
    eager_model = dataclasses.replace(
        model, prefill=lambda *a, **k: model.prefill(*a, **k),
        decode_step=lambda *a, **k: model.decode_step(*a, **k))
    r = np.random.default_rng(5)
    prompts = [r.integers(0, cfg.vocab_size, int(n)).tolist()
               for n in r.integers(20, 480, 24)]
    lens = [len(p) for p in prompts]
    launches, engines = {}, {}
    for path, m in (("graph", model), ("eager", eager_model)):
        eng = InferenceEngine(m, params, slots=SLOTS,
                              max_seq=cfg.max_seq_len, page_tokens=PAGE)
        assert (eng.prefill_graph is None) == (path == "eager")
        for fn in (flash_attention, paged_attention):
            fn.launches = 0
            fn.route_launches = dict.fromkeys(fn.route_launches, 0)
        for i, prompt in enumerate(prompts):
            eng.submit(Request(f"r{i}", "t", prompt, 1 + i % 5, 0.0), 0.0)
        eng.run_until_drained()
        torch.cuda.synchronize()
        assert len(eng.finished) == len(lens)
        launches[path] = [(fn.launches, dict(fn.route_launches))
                          for fn in (flash_attention, paged_attention)]
        engines[path] = eng
    assert launches["graph"] == launches["eager"]
    assert launches["graph"][0][0] == len(lens) * cfg.num_layers
    graph = engines["graph"].prefill_graph
    assert graph.replays == len(lens)
    assert graph.captures == len(graph.graphs) == \
        len({graph.bucket_for(n) for n in lens})
