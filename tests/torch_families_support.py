"""Shared by the port's model-family tests (``tests/test_torch_families*.py``,
one file a part so that ``--dist loadfile`` spreads them): the reduced
configs of both packages built once a process (``models``), the
prefill-then-decode comparison of the logits (``check_logits``), the
engines of both packages over one pool (``serve``), and the autouse
fixture that no attention kernel launches on the CPU (a test module
imports ``no_launches`` to have it)."""
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
from repro_torch.models import Runtime, build_model, params_from_jax
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


@functools.lru_cache(maxsize=None)
def jax_decode(arch: str, kv_dtype: str):
    """The JAX model's decode step, jitted once per process and cache
    dtype (every run of the arch reuses the compiled step)."""
    _, jmodel, _, _, _ = models(arch)
    jrt = JaxRuntime(kv_cache_dtype=kv_dtype)
    return jax.jit(lambda p, tok, c, i: jmodel.decode_step(p, tok, c, i,
                                                           jrt))


def jax_logits(arch, kv_dtype, tokens, steps, fed=None):
    """The JAX model's prefill and decode logits; each step is fed the
    greedy token of the step before, or ``fed``.  Returns (logits per
    step, the tokens fed)."""
    _, jmodel, jparams, _, _ = models(arch)
    B, S = tokens.shape
    jrt = JaxRuntime(kv_cache_dtype=kv_dtype)
    jdecode = jax_decode(arch, kv_dtype)
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


# -- the engine ---------------------------------------------------------
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
