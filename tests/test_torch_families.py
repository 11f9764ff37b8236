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

The tests, one file a part (``--dist loadfile`` runs each file on one
worker), the shared code in ``tests/torch_families_support.py``:
``test_params_from_jax``, the float32-cache half of
``test_prefill_then_decode_logits`` and the VLM prefix here; its
bfloat16-cache half in ``test_torch_families_bf16.py``;
``test_bfloat16_cache_over_seeds`` in ``test_torch_families_seeds.py``
(tinyllama-1.1b and both MoE configs) and
``test_torch_families_seeds_dense.py`` (deepseek-7b and both gemma2);
the engine and C9 in ``test_torch_families_engine.py``.

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
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import Runtime as JaxRuntime
from repro_torch.models import Runtime, param_count
from repro_torch.serving.kv_manager import KVBlockManager
from torch_families_support import ARCHS, PAGE, assert_logits_close, \
    check_logits, models, no_launches  # noqa: F401 (an autouse fixture)
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)


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


@pytest.mark.parametrize("kv_dtype", ["float32"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_logits(arch, kv_dtype, monkeypatch):
    check_logits(arch, kv_dtype, 1, monkeypatch)


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
