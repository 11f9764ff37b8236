"""The port's transformer (paged KV cache, flash prefill, paged decode)
against the JAX transformer (dense KV cache) on ``qwen3-8b.reduced()``.

The JAX model's random-init parameters go to the port through
``params_from_jax``; the same numpy-seeded tokens go through both.
Prefill logits and the logits of every following decode step are
compared.  On the CPU the port's attention runs the kernels' plain
versions.

Tolerances are relative to the logits' scale: the largest difference
must stay within ``tol · max|logits|`` (random-init logits reach ~30,
so an absolute bound would test float32's last bits on the large ones
and nothing on the small).  ``tol`` is 1e-4 in float32 with a float32
KV cache (the sums run in another order) and 2e-2 with the default
bfloat16 cache, where both sides round K/V to bfloat16 and the
reference also rounds the attention weights.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro.serving.engine import cache_insert
from repro_torch.configs import get_config
from repro_torch.models import Runtime, build_model, param_count, \
    params_from_jax
from repro_torch.serving.kv_manager import KVBlockManager

CASES = {
    # (model dtype, KV cache dtype) → tolerance
    ("float32", "float32"): 1e-4,
    ("float32", "bfloat16"): 2e-2,
}
PAGE = 16


@functools.lru_cache(maxsize=None)
def models(dtype: str):
    """Both models of one dtype, built once per test process (read-only:
    the KV caches live outside them)."""
    jcfg = jax_get_config("qwen3-8b").reduced(dtype=dtype)
    cfg = get_config("qwen3-8b").reduced(dtype=dtype)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    return cfg, jmodel, jparams, build_model(cfg), \
        params_from_jax(cfg, np_params, "cpu")


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_logits_close(port, ref, tol: float, what: str = "") -> None:
    a, b = as_np(port), as_np(ref)
    assert a.shape == b.shape, what
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= tol * scale, (f"{what}: max |diff| {err} > {tol} x "
                                f"max |logit| {scale}")


def test_params_from_jax_unstacks_every_layer():
    cfg, _, jparams, _, port = models("float32")
    assert len(port.layers) == cfg.num_layers
    n_jax = sum(x.size for x in jax.tree.leaves(jparams))
    assert param_count(port) == n_jax
    np.testing.assert_array_equal(
        port.layers[1].attn["wq"].numpy(),
        np.asarray(jparams["periods"]["k0"]["attn"]["wq"][1]))
    np.testing.assert_array_equal(
        port.layers[0].mlp["w_down"].numpy(),
        np.asarray(jparams["periods"]["k0"]["mlp"]["w_down"][0]))


@pytest.mark.parametrize("dtype,kv_dtype", list(CASES))
def test_prefill_then_decode_logits(dtype, kv_dtype):
    """B=2 prompts of 14 tokens, then 20 decode steps that cross two
    page boundaries (16-token pages)."""
    tol = CASES[(dtype, kv_dtype)]
    cfg, jmodel, jparams, model, port = models(dtype)
    B, S, steps = 2, 14, 20
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)

    jrt = JaxRuntime(kv_cache_dtype=kv_dtype)
    jdecode = jax.jit(lambda p, tok, c, i: jmodel.decode_step(p, tok, c, i,
                                                              jrt))
    jcache = jmodel.init_cache(B, S + steps + 1, jrt)
    jlog, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), jcache, jrt)

    max_pages = (S + steps) // PAGE + 1
    kv = KVBlockManager(total_pages=B * max_pages, page_tokens=PAGE)
    cache = model.init_cache(kv.total_pages, PAGE,
                             Runtime(kv_cache_dtype=kv_dtype), "cpu")
    for b in range(B):
        kv.allocate(f"s{b}", S)

    def tables():
        return torch.from_numpy(np.stack([kv.block_table(f"s{b}", max_pages)
                                          for b in range(B)]))

    log = model.prefill(port, torch.from_numpy(tokens).long(), cache,
                        tables())
    assert_logits_close(log, jlog, tol, "prefill")

    for t in range(steps):
        nxt = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
        pos = S + t
        for b in range(B):
            kv.extend(f"s{b}", pos + 1)
        jlog, jcache = jdecode(jparams, jnp.asarray(nxt), jcache,
                               jnp.int32(pos))
        log = model.decode_step(port, torch.from_numpy(nxt).long(), cache,
                                tables(),
                                torch.full((B,), pos, dtype=torch.int32))
        assert_logits_close(log, jlog, tol, f"decode step {t}")


def test_ragged_lanes_decode_at_their_own_positions():
    """Prompts of 5 and 19 tokens prefilled one at a time (as the engine
    does), then decoded together with per-lane positions: the JAX side
    scatters each B=1 cache into its lane, the port writes each
    sequence's pages."""
    cfg, jmodel, jparams, model, port = models("float32")
    jrt = JaxRuntime(kv_cache_dtype="float32")
    rt = Runtime(kv_cache_dtype="float32")
    jdecode = jax.jit(lambda p, tok, c, i: jmodel.decode_step(p, tok, c, i,
                                                              jrt))
    r = np.random.default_rng(1)
    prompts = [r.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19)]
    max_seq, max_pages = 48, 48 // PAGE + 1
    jcache = jmodel.init_cache(2, max_seq, jrt)
    kv = KVBlockManager(total_pages=2 * max_pages, page_tokens=PAGE)
    cache = model.init_cache(kv.total_pages, PAGE, rt, "cpu")
    nxt = np.zeros((2, 1), np.int32)
    for b, p in enumerate(prompts):
        one = jmodel.init_cache(1, max_seq, jrt)
        jlog, one = jmodel.prefill(jparams, jnp.asarray(p[None]), one, jrt)
        jcache = cache_insert(jcache, one, b)
        kv.allocate(f"s{b}", len(p))
        log = model.prefill(
            port, torch.from_numpy(p[None]).long(), cache,
            torch.from_numpy(kv.block_table(f"s{b}", max_pages)[None]))
        assert_logits_close(log, jlog, 1e-4, f"prefill {b}")
        nxt[b, 0] = int(jnp.argmax(jlog[0, -1]))
    pos = np.asarray([len(p) for p in prompts], np.int32)
    for t in range(16):
        for b in range(2):
            kv.extend(f"s{b}", int(pos[b]) + 1)
        jlog, jcache = jdecode(jparams, jnp.asarray(nxt), jcache,
                               jnp.asarray(pos))
        bt = np.stack([kv.block_table(f"s{b}", max_pages) for b in range(2)])
        log = model.decode_step(port, torch.from_numpy(nxt).long(), cache,
                                torch.from_numpy(bt), torch.from_numpy(pos))
        assert_logits_close(log, jlog, 1e-4, f"decode step {t}")
        nxt = np.array(jnp.argmax(jlog[:, 0], axis=-1), np.int32)[:, None]
        pos = pos + 1


def test_unported_families_raise():
    """Every family is ported now: each config of the reference builds
    (reduced), with the module its family takes, and only a layer kind
    neither package knows raises."""
    import dataclasses
    from repro.configs import all_configs
    from repro_torch.models import EncoderDecoder, Transformer
    for name in all_configs():
        cfg = get_config(name).reduced()
        params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                       "cpu")
        assert isinstance(params, EncoderDecoder if cfg.is_encoder_decoder
                          else Transformer), name
    with pytest.raises(ValueError, match="unknown layer kind"):
        build_model(dataclasses.replace(get_config("qwen3-8b").reduced(),
                                        pattern=("conv",)))
