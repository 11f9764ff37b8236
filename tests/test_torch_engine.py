"""The slice as a whole: TokenPool → Gateway → InferenceEngine in the
port against the same chain in the JAX package, on the CPU.

Both engines serve the same two-tenant workload on
``qwen3-8b.reduced()`` with the JAX model's parameters (handed to the
port through ``params_from_jax``), in float32 with a float32 KV cache
so that no greedy tie can flip.  The port keeps its KV in pages and
attends through the flash-prefill and paged-decode kernels' plain
versions; the reference decodes on its dense per-lane cache.  Denied
requests, every request's greedy output tokens, the finish order and
every timestamp must be identical, and so must the pool's settled
token counts.  That ``repro_torch.launch.serve`` prints what
``repro.launch.serve`` prints is held in
``tests/test_torch_serve_launcher.py`` and
``tests/test_torch_serve_launcher_more.py`` (one half of the archs
each, so that ``--dist loadfile`` runs them on two workers).
"""
import jax
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
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

SLOTS, MAX_TOKENS = 3, 12


@pytest.fixture(scope="module")
def models():
    overrides = dict(dtype="float32", vocab_size=512, max_seq_len=64)
    jcfg = jax_get_config("qwen3-8b").reduced(**overrides)
    cfg = get_config("qwen3-8b").reduced(**overrides)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    port = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return (jcfg, jmodel, jparams), (cfg, build_model(cfg), port)


def gateway(core, gw_mod, cfg, tps: float):
    kw = {"device": "cpu"} if core is T else {}
    spec = core.PoolSpec(name=cfg.name, model=cfg.name,
                         scaling=core.ScalingBounds(1, 1),
                         per_replica=core.Resources(tps, float(1 << 30),
                                                    float(SLOTS)),
                         default_max_tokens=MAX_TOKENS)
    pool = core.TokenPool(spec, **kw)
    pool.add_entitlement(core.EntitlementSpec(
        name="prod", tenant_id="prod", pool=cfg.name,
        qos=core.QoS(core.ServiceClass.GUARANTEED, 200.0),
        baseline=core.Resources(tps / 2, 0.0, float(SLOTS))))
    pool.add_entitlement(core.EntitlementSpec(
        name="batch", tenant_id="batch", pool=cfg.name,
        qos=core.QoS(core.ServiceClass.SPOT, 30000.0),
        baseline=core.Resources(0.0, 0.0, 0.0)))
    pool.ledger.set_rate("batch", tps, 0.0)
    pool.ledger.bucket("batch").level = tps
    gw = gw_mod.Gateway(pool)
    gw.register_key("k-prod", "prod")
    gw.register_key("k-batch", "batch")
    return pool, gw


def serve(side, serving, core, gw_mod, seed: int, tps: float,
          evict: bool):
    """Seeded arrivals of mixed prompt lengths, a control tick once per
    simulated second, optionally one mid-stream eviction; returns the
    observed outcome.  A small ``tps`` starves the budgets, so the
    gateway denies."""
    cfg, model, params = side
    r = np.random.default_rng(seed)
    pool, gw = gateway(core, gw_mod, cfg, tps)
    if core is T:
        eng = serving.InferenceEngine(model, params, slots=SLOTS,
                                      max_seq=cfg.max_seq_len, gateway=gw,
                                      rt=Runtime(kv_cache_dtype="float32"))
    else:
        eng = serving.InferenceEngine(
            model, params, slots=SLOTS, max_seq=cfg.max_seq_len,
            gateway=gw, rt=JaxRuntime(kv_cache_dtype="float32"))
    reqs, now, t_arr, i = [], 0.0, 0.0, 0
    for step in range(60):
        while t_arr <= now and i < 12:
            tenant = "prod" if r.random() < 0.5 else "batch"
            n = int(r.integers(3, 40))
            req = serving.Request(
                request_id=f"r{i}", entitlement=tenant,
                prompt_tokens=r.integers(0, cfg.vocab_size, n).tolist(),
                max_tokens=int(r.integers(2, MAX_TOKENS + 1)),
                arrival_s=t_arr, api_key=f"k-{tenant}")
            reqs.append(req)
            eng.submit(req, now=t_arr)
            t_arr += float(r.random() * 0.3)
            i += 1
        if evict and step == 6:
            live = [l.request.request_id for l in eng.lanes if l.request]
            if live:
                eng.evict(live[0], now)
        eng.step(now)
        if int(now + 0.05) > int(now):
            pool.tick(float(int(now + 0.05)))
        now += 0.05
    now = eng.run_until_drained(now)
    return {
        "requests": [(q.request_id, q.state.value, q.deny_reason,
                      q.retry_after_s, q.priority, q.admitted_s,
                      q.first_token_s, q.finished_s, list(q.output_tokens))
                     for q in reqs],
        "finish_order": [q.request_id for q in eng.finished],
        "tokens_total": {n: s.tokens_total for n, s in pool.status.items()},
        "levels": {n: pool.ledger.bucket(n).level for n in pool.entitlements},
        "free_pages": eng.kv_pages.free_pages,
        "end": now,
    }


@pytest.mark.parametrize("seed,tps,evict", [(0, 3000.0, False),
                                             (1, 3000.0, True),
                                             (2, 60.0, False)])
def test_engine_matches_reference(models, seed, tps, evict):
    ref = serve(models[0], JS, J, JG, seed, tps, evict)
    port = serve(models[1], TS, T, TG, seed, tps, evict)
    for a, b in zip(ref["requests"], port["requests"]):
        assert a == b, a[0]
    assert ref == port
    states = {q[1] for q in ref["requests"]}
    assert "finished" in states
    assert ("evicted" in states) == evict
    if tps < 100:
        assert "denied" in states
    assert flash_attention.launches == 0 and paged_attention.launches == 0


def test_engine_runs_on_the_params_device(models):
    cfg, model, params = models[1]
    pool, gw = gateway(T, TG, cfg, 3000.0)
    eng = TS.InferenceEngine(model, params, slots=2, max_seq=cfg.max_seq_len,
                             gateway=gw)
    assert eng.device == torch.device("cpu")
    assert all(k.device.type == "cpu" for k in eng.cache.k)
    assert eng.cache.k[0].shape == (eng.kv_pages.total_pages, 16,
                                    cfg.num_kv_heads, cfg.head_dim)
