"""The model families beside the paper's dense model, on the CPU:
``deepseek-7b``, ``tinyllama-1.1b``, ``gemma2-2b``, ``gemma2-9b``
(sliding-window layers, post norms, both softcaps, geglu),
``qwen3-moe-30b-a3b``, ``qwen3-moe-235b-a22b`` (MoE MLPs),
``recurrentgemma-2b`` (RG-LRU layers and local attention, MQA),
``xlstm-350m`` (mLSTM and sLSTM cells, no attention) and
``internvl2-2b`` (the VLM backbone, served as text), each on its
``reduced()`` config.

The JAX model's random-init parameters go to the port through
``params_from_jax``; the same numpy-seeded tokens go through both.

* Prefill and decode logits: two prompts of 40 tokens (past gemma2's
  reduced window of 32), then 24 decode steps crossing page boundaries.
  Tolerances as in ``tests/test_torch_models.py``: 1e-4 × max|logits|
  in float32 with a float32 KV cache, 2e-2 with a bfloat16 cache.
  xlstm-350m has no KV cache, so its bfloat16-cache cases are held to
  the float32 bound.
* The VLM prefix: internvl2-2b's prefill with 8 patch embeddings in
  front of the prompt, then decode from position S + 8.
* The bfloat16 cache, against the reference's own rounding.  Both
  sides round K/V into the cache; the reference's dense decode
  (``repro/models/attention.py::attend``) also rounds the softmax
  weights to the cache dtype and so returns its attention output in
  it, while the port, like the Pallas kernel it ports, keeps both in
  float32.  So the bfloat16 case is checked twice: the port with a
  decode that rounds as the reference does (``decode_as_reference``,
  the port's own page gather and masks) at 2e-2 on every step, and the
  port as it is no further from the reference's bfloat16-cache logits
  than those are from the reference's float32-cache logits on the same
  tokens (its own rounding drift).  Seeds 2-4 repeat the bfloat16 case
  on the six global/local/MoE archs (``-s`` prints each run's three
  distances).
* The engine: TokenPool → Gateway → InferenceEngine in both packages,
  float32, identical greedy tokens, states and timestamps.  Dense and
  recurrent models take seeded arrivals (lanes go idle and come back,
  a recurrent lane with a fresh state); MoE models
  take full waves, so that every decode step has every lane active —
  the only case where the two engines agree for MoE (fault C9 below).
* Fault C9 (in the reference): the JAX engine decodes every lane, idle
  ones included with their stale token and position; for MoE the
  capacity ``C`` depends on the token count and the stable sort serves
  lower lanes first, so a finished request's stale lane takes expert
  capacity from a live lane above it.  The port decodes the active
  lanes only.  The test shows both sides of it.
"""
import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.gateway as JG
import repro.serving as JS
import repro_torch.core as T
import repro_torch.gateway as TG
import repro_torch.serving as TS
from repro.configs import get_config as jax_get_config
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import Runtime, build_model, param_count, \
    params_from_jax
from repro_torch.serving.kv_manager import KVBlockManager

attention_mod = importlib.import_module("repro_torch.models.attention")
_paged = importlib.import_module(
    "repro_torch.kernels.paged_attention.paged_attention")

ARCHS = ["deepseek-7b", "tinyllama-1.1b", "gemma2-2b", "gemma2-9b",
         "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b", "recurrentgemma-2b",
         "xlstm-350m", "internvl2-2b"]
MOE = ("qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b")
CASES = {("float32", "float32"): 1e-4, ("float32", "bfloat16"): 2e-2}
PAGE = 16


@functools.lru_cache(maxsize=None)
def models(arch: str, **over):
    """Both models of ``arch.reduced(dtype="float32", **over)``, built
    once per test process (read-only: the KV caches live outside)."""
    jcfg = jax_get_config(arch).reduced(dtype="float32", **over)
    cfg = get_config(arch).reduced(dtype="float32", **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    port = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jmodel, jparams, build_model(cfg), port


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_logits_close(port, ref, tol: float, what: str) -> None:
    a, b = as_np(port), as_np(ref)
    assert a.shape == b.shape, what
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= tol * scale, (f"{what}: max |diff| {err} > {tol} x "
                                f"max |logit| {scale}")


@pytest.fixture(autouse=True)
def no_launches():
    yield
    assert flash_attention.launches == 0 and paged_attention.launches == 0


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax(arch):
    """Every leaf comes across (count, and one stacked leaf of each
    kind unstacked); the port's own init builds the same tree."""
    cfg, _, jparams, model, port = models(arch)
    assert len(port.layers) == cfg.num_layers
    assert param_count(port) == sum(x.size for x in jax.tree.leaves(jparams))
    layer = port.layers[1]
    if cfg.is_moe:
        assert layer.is_moe and not hasattr(layer, "mlp")
        assert layer.moe["router"].dtype == torch.float32
        np.testing.assert_array_equal(
            layer.moe["w_up"].numpy(),
            np.asarray(jparams["periods"]["k0"]["moe"]["w_up"][1]))
    elif layer.kind in ("global", "local"):
        assert not layer.is_moe
    assert [b.kind for b in port.layers] == \
        list(cfg.pattern) * cfg.n_periods + list(cfg.tail_kinds)
    k1 = jparams["periods"]["k1"] if len(cfg.pattern) > 1 else None
    if arch == "recurrentgemma-2b":
        np.testing.assert_array_equal(
            layer.rec["lambda"].numpy(), np.asarray(k1["rec"]["lambda"][0]))
        np.testing.assert_array_equal(
            port.layers[-1].rec["conv_w"].numpy(),
            np.asarray(jparams["tail1"]["rec"]["conv_w"]))
    if arch == "xlstm-350m":
        np.testing.assert_array_equal(layer.cell["r_z"].numpy(),
                                      np.asarray(k1["cell"]["r_z"][0]))
    if cfg.num_vision_tokens:
        np.testing.assert_array_equal(port.vision_proj.numpy(),
                                      np.asarray(jparams["vision_proj"]))
    fresh = model.init(torch.Generator().manual_seed(0), "cpu")
    assert {n: (p.shape, p.dtype) for n, p in fresh.named_parameters()} == \
        {n: (p.shape, p.dtype) for n, p in port.named_parameters()}


def decode_as_reference(q, k_pages, v_pages, block_tables, context_lens,
                        *, softcap=None, window=None):
    """The plain paged decode with the reference dense decode's rounding:
    softmax weights rounded to the cache dtype, the output in it."""
    k, v, mask = _paged._dense(q, k_pages, v_pages, block_tables,
                               context_lens, window)
    s = torch.where(mask[:, None, :], _paged._scores(q, k, softcap),
                    _paged.NEG_INF)
    p = torch.softmax(s, dim=-1).to(k_pages.dtype).float()
    out = torch.einsum("bhk,bkhd->bhd", p, v).to(k_pages.dtype)
    return out.to(q.dtype)


def jax_logits(arch, kv_dtype, tokens, steps, fed=None):
    """The JAX model's prefill and decode logits; each step is fed the
    greedy token of the step before, or ``fed``.  Returns (logits per
    step, the tokens fed)."""
    _, jmodel, jparams, _, _ = models(arch)
    B, S = tokens.shape
    jrt = JaxRuntime(kv_cache_dtype=kv_dtype)
    jdecode = jax.jit(lambda p, tok, c, i: jmodel.decode_step(p, tok, c, i,
                                                              jrt))
    jcache = jmodel.init_cache(B, S + steps + 1, jrt)
    jlog, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), jcache, jrt)
    out, fed = [as_np(jlog)], list(fed or [])
    for t in range(steps):
        if len(fed) == t:
            fed.append(np.array(jnp.argmax(jlog[:, -1], axis=-1),
                                np.int32)[:, None])
        jlog, jcache = jdecode(jparams, jnp.asarray(fed[t]), jcache,
                               jnp.int32(S + t))
        out.append(as_np(jlog))
    return out, fed


def port_logits(arch, kv_dtype, tokens, fed):
    """The port's prefill and decode logits through a paged cache of
    16-token pages, fed the same tokens."""
    cfg, _, _, model, port = models(arch)
    B, S = tokens.shape
    max_pages = (S + len(fed)) // PAGE + 1
    kv = KVBlockManager(total_pages=B * max_pages, page_tokens=PAGE)
    cache = model.init_cache(kv.total_pages, PAGE,
                             Runtime(kv_cache_dtype=kv_dtype), "cpu",
                             lanes=B)
    for b in range(B):
        kv.allocate(f"s{b}", S)

    def tables():
        return torch.from_numpy(np.stack([kv.block_table(f"s{b}", max_pages)
                                          for b in range(B)]))

    out = [as_np(model.prefill(port, torch.from_numpy(tokens).long(), cache,
                               tables()))]
    for t, nxt in enumerate(fed):
        pos = S + t
        for b in range(B):
            kv.extend(f"s{b}", pos + 1)
        out.append(as_np(model.decode_step(
            port, torch.from_numpy(nxt).long(), cache, tables(),
            torch.full((B,), pos, dtype=torch.int32))))
    return out


def distance(a, b) -> float:
    """Largest max|a − b| / max|b| over the steps."""
    return max(float(np.abs(x - y).max() / np.abs(y).max())
               for x, y in zip(a, b))


def check_logits(arch, kv_dtype, seed, monkeypatch) -> None:
    """B=2 prompts of 40 tokens, then 24 decode steps (contexts 41-64,
    past gemma2's window of 32 and across three 16-token pages)."""
    tol = CASES[("float32", kv_dtype)]
    cfg = models(arch)[0]
    B, S, steps = 2, 40, 24
    tokens = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    ref, fed = jax_logits(arch, kv_dtype, tokens, steps)
    port = port_logits(arch, kv_dtype, tokens, fed)
    if kv_dtype == "float32" or not cfg.kv_bytes_per_token:
        tol = CASES[("float32", "float32")]
        for t, (a, b) in enumerate(zip(port, ref)):
            assert_logits_close(a, b, tol, f"{arch} step {t} (0 = prefill)")
        return
    drift = distance(jax_logits(arch, "float32", tokens, steps, fed)[0],
                     ref)
    gap = distance(port, ref)
    with monkeypatch.context() as m:
        m.setattr(attention_mod, "paged_decode_attention",
                  decode_as_reference)
        rounded = port_logits(arch, kv_dtype, tokens, fed)
    print(f"{arch} seed {seed} bfloat16 cache: port {gap:.3g}, port "
          f"rounding as the reference {distance(rounded, ref):.3g}, "
          f"reference float32 cache {drift:.3g} (x max|logit|)")
    for t, (a, b) in enumerate(zip(rounded, ref)):
        assert_logits_close(a, b, tol, f"{arch} rounding as the reference, "
                                       f"step {t} (0 = prefill)")
    assert gap <= drift, (f"{arch}: the port is {gap:.3g} from the "
                          f"reference's bfloat16-cache logits, beyond the "
                          f"reference's own drift {drift:.3g}")


@pytest.mark.parametrize("kv_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_logits(arch, kv_dtype, monkeypatch):
    check_logits(arch, kv_dtype, 1, monkeypatch)


@pytest.mark.parametrize("seed", [2, 3, 4])
@pytest.mark.parametrize("arch", ARCHS[:6])
def test_bfloat16_cache_over_seeds(arch, seed, monkeypatch):
    check_logits(arch, "bfloat16", seed, monkeypatch)


def test_vlm_prefix_then_decode():
    """internvl2-2b: two prompts of 16 tokens behind 8 seeded patch
    embeddings (positions 0-23), then 12 decode steps from position 24,
    float32 cache."""
    arch = "internvl2-2b"
    cfg, jmodel, jparams, model, port = models(arch)
    B, S, N, steps = 2, 16, cfg.num_vision_tokens, 12
    r = np.random.default_rng(5)
    tokens = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = r.standard_normal((B, N, cfg.d_model)).astype(np.float32)
    jrt = JaxRuntime(kv_cache_dtype="float32")
    jdecode = jax.jit(lambda p, tok, c, i: jmodel.decode_step(p, tok, c, i,
                                                              jrt))
    jcache = jmodel.init_cache(B, N + S + steps + 1, jrt)
    jlog, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), jcache, jrt,
                                  extra_embed=jnp.asarray(patches))
    max_pages = (N + S + steps) // PAGE + 1
    kv = KVBlockManager(total_pages=B * max_pages, page_tokens=PAGE)
    cache = model.init_cache(kv.total_pages, PAGE,
                             Runtime(kv_cache_dtype="float32"), "cpu")
    for b in range(B):
        kv.allocate(f"s{b}", N + S)

    def tables():
        return torch.from_numpy(np.stack([kv.block_table(f"s{b}", max_pages)
                                          for b in range(B)]))

    log = model.prefill(port, torch.from_numpy(tokens).long(), cache,
                        tables(), extra_embed=torch.from_numpy(patches))
    assert_logits_close(log, jlog, 1e-4, "prefill with the patch prefix")
    for t in range(steps):
        nxt = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
        pos = N + S + t
        for b in range(B):
            kv.extend(f"s{b}", pos + 1)
        jlog, jcache = jdecode(jparams, jnp.asarray(nxt), jcache,
                               jnp.int32(pos))
        log = model.decode_step(port, torch.from_numpy(nxt).long(), cache,
                                tables(),
                                torch.full((B,), pos, dtype=torch.int32))
        assert_logits_close(log, jlog, 1e-4, f"decode step {t}")


# -- the engine ----------------------------------------------------------------
SLOTS, MAX_TOKENS = 3, 10


def gateway(core, gw_mod, cfg, tps: float = 3000.0):
    kw = {"device": "cpu"} if core is T else {}
    spec = core.PoolSpec(name=cfg.name, model=cfg.name,
                         scaling=core.ScalingBounds(1, 1),
                         per_replica=core.Resources(tps, float(1 << 30),
                                                    float(SLOTS)),
                         default_max_tokens=MAX_TOKENS)
    pool = core.TokenPool(spec, **kw)
    for name, cls, base in (("prod", core.ServiceClass.GUARANTEED, tps / 2),
                            ("batch", core.ServiceClass.SPOT, 0.0)):
        pool.add_entitlement(core.EntitlementSpec(
            name=name, tenant_id=name, pool=cfg.name,
            qos=core.QoS(cls, 200.0 if name == "prod" else 30000.0),
            baseline=core.Resources(base, 0.0,
                                    float(SLOTS) if base else 0.0)))
    pool.ledger.set_rate("batch", tps, 0.0)
    pool.ledger.bucket("batch").level = tps
    gw = gw_mod.Gateway(pool)
    gw.register_key("k-prod", "prod")
    gw.register_key("k-batch", "batch")
    return pool, gw


def engine(side: str, arch: str, slots: int):
    """The reference engine gets its model with ``prefill`` jitted, as
    its decode step is: each prompt length then compiles once, where the
    eager prefill compiles every op of it (RG-LRU's associative scan,
    the xLSTM scans) anew for each length."""
    cfg, jmodel, jparams, model, port = models(arch)
    if side == "jax":
        pool, gw = gateway(J, JG, cfg)
        jmodel = dataclasses.replace(
            jmodel, prefill=jax.jit(jmodel.prefill, static_argnums=3))
        return pool, JS.InferenceEngine(
            jmodel, jparams, slots=slots, max_seq=cfg.max_seq_len,
            gateway=gw, rt=JaxRuntime(kv_cache_dtype="float32"))
    pool, gw = gateway(T, TG, cfg)
    return pool, TS.InferenceEngine(
        model, port, slots=slots, max_seq=cfg.max_seq_len, gateway=gw,
        rt=Runtime(kv_cache_dtype="float32"))


def serve(side: str, arch: str, seed: int, waves: bool):
    """Seeded prompts of 3-60 tokens.  ``waves``: 2·SLOTS requests at
    t = 0 with equal ``max_tokens`` (full waves, no idle lane during a
    decode); else seeded arrivals and lengths (lanes go idle)."""
    cfg = models(arch)[0]
    serving = JS if side == "jax" else TS
    r = np.random.default_rng(seed)
    pool, eng = engine(side, arch, SLOTS)
    reqs, now, t_arr = [], 0.0, 0.0
    for i in range(2 * SLOTS if waves else 8):
        tenant = "prod" if r.random() < 0.5 else "batch"
        req = serving.Request(
            request_id=f"r{i}", entitlement=tenant,
            prompt_tokens=r.integers(0, cfg.vocab_size,
                                     int(r.integers(3, 61))).tolist(),
            max_tokens=MAX_TOKENS if waves else int(r.integers(2, 13)),
            arrival_s=t_arr, api_key=f"k-{tenant}")
        reqs.append(req)
        if not waves:
            t_arr += float(r.random() * 0.3)
    k = 0
    for step in range(200):
        while k < len(reqs) and reqs[k].arrival_s <= now:
            eng.submit(reqs[k], now=reqs[k].arrival_s)
            k += 1
        eng.step(now)
        if int(now + 0.05) > int(now):
            pool.tick(float(int(now + 0.05)))
        now += 0.05
        if k == len(reqs) and not eng.queue \
                and not any(l.request for l in eng.lanes):
            break
    return {"requests": [(q.request_id, q.state.value, q.admitted_s,
                          q.first_token_s, q.finished_s,
                          list(q.output_tokens)) for q in reqs],
            "finish_order": [q.request_id for q in eng.finished],
            "tokens_total": {n: s.tokens_total
                             for n, s in pool.status.items()},
            "free_pages": eng.kv_pages.free_pages}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_reference(arch):
    waves = arch in MOE
    ref = serve("jax", arch, 3, waves)
    port = serve("torch", arch, 3, waves)
    for a, b in zip(ref["requests"], port["requests"]):
        assert a == b, (arch, a[0])
    assert ref == port
    assert all(q[1] == "finished" for q in ref["requests"])


def test_c9_idle_lane_takes_expert_capacity_in_the_reference():
    """Two lanes: r0 (lane 0, 3 tokens) and r1 (lane 1, 14 tokens).
    While both are live the engines agree token for token.  After r0
    finishes, r1 alone continued from its lane's KV (the JAX model at
    B=1) is what the port's engine gives; the JAX engine, which still
    decodes r0's stale lane ahead of r1 (C = 1 slot per expert at
    T = 2), gives other tokens."""
    arch = "qwen3-moe-30b-a3b"
    cfg, jmodel, jparams, _, _ = models(arch)
    prompts = np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 9))
    out = {}
    for side in ("jax", "torch"):
        serving = JS if side == "jax" else TS
        pool, eng = engine(side, arch, 2)
        reqs = [serving.Request(request_id=f"r{i}", entitlement="prod",
                                prompt_tokens=prompts[i].tolist(),
                                max_tokens=(3, 14)[i], arrival_s=0.0,
                                api_key="k-prod") for i in range(2)]
        for q in reqs:
            eng.submit(q, now=0.0)
        now = 0.0
        while reqs[0].state.value != "finished":
            eng.step(now)
            now += 0.05
        if side == "jax":       # r1's lane, continued alone
            lane = eng.lanes[1]
            one = {"periods": jax.tree.map(lambda x: x[:, 1:2],
                                           eng.cache["periods"])}
            tok, pos, alone = reqs[1].output_tokens[-1], lane.position, []
            dec = jax.jit(lambda p, t, c, i: jmodel.decode_step(p, t, c, i))
            for _ in range(lane.remaining):
                logits, one = dec(jparams, jnp.asarray([[tok]], jnp.int32),
                                  one, jnp.asarray([pos], jnp.int32))
                tok = int(jnp.argmax(logits[0, 0]))
                alone.append(tok)
                pos += 1
            n_shared = len(reqs[1].output_tokens)
        eng.run_until_drained(now)
        out[side] = [list(q.output_tokens) for q in reqs]
    assert out["jax"][0] == out["torch"][0]
    assert out["jax"][1][:n_shared] == out["torch"][1][:n_shared]
    assert out["torch"][1][n_shared:] == alone
    assert out["jax"][1][n_shared:] != alone
