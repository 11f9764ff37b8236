"""The port's encoder-decoder (``repro_torch.models.encdec``, whisper)
against the JAX package's (``repro.models.encdec``), on the CPU, on
``whisper-small.reduced()`` in float32 (2 encoder and 2 decoder layers,
d 64, 4/2 heads).

The JAX model's random-init parameters go to the port through
``params_from_jax``; the same numpy-seeded frames and tokens go through
both.  Tolerance: 1e-4 of the reference's largest magnitude for the
encoder's output, the cross K/V and the logits, as
``tests/test_torch_models.py`` holds logits in float32.

The reference serves whisper only through these entry points: its
engine calls prefill without frames (fault C10), and the port's engine
refuses the model with that reason.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as JS
import repro_torch.serving as TS
from repro.configs import get_config as jax_get_config
from repro.models import Runtime as JaxRuntime
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import EncoderDecoder, Runtime, build_model, \
    encdec, param_count, params_from_jax
from repro_torch.serving.kv_manager import KVBlockManager

TOL = 1e-4
PAGE, S_ENC = 16, 24


@functools.lru_cache(maxsize=None)
def models():
    jcfg = jax_get_config("whisper-small").reduced(dtype="float32")
    cfg = get_config("whisper-small").reduced(dtype="float32")
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    port = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jmodel, jparams, build_model(cfg), port


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def assert_close(out, want, what: str = "") -> None:
    a, b = as_np(out), as_np(want)
    assert a.shape == b.shape, what
    err, scale = np.abs(a - b).max(), np.abs(b).max()
    assert err <= TOL * scale, f"{what}: {err} > {TOL} x {scale}"


def frames(seed: int, B: int) -> np.ndarray:
    cfg = models()[0]
    return np.random.default_rng(seed).standard_normal(
        (B, S_ENC, cfg.d_model)).astype(np.float32)


@pytest.fixture(autouse=True)
def no_launches():
    yield
    assert flash_attention.launches == 0 and paged_attention.launches == 0


def test_params_from_jax_and_init():
    cfg, _, jparams, model, port = models()
    assert isinstance(port, EncoderDecoder)
    assert len(port.enc_layers) == cfg.encoder_layers
    assert len(port.dec_layers) == cfg.num_layers
    assert param_count(port) == sum(x.size for x in jax.tree.leaves(jparams))
    np.testing.assert_array_equal(
        port.dec_layers[1].cross_attn["wk"].numpy(),
        np.asarray(jparams["dec_layers"]["cross_attn"]["wk"][1]))
    fresh = model.init(torch.Generator().manual_seed(0), "cpu")
    assert {n: (p.shape, p.dtype) for n, p in fresh.named_parameters()} == \
        {n: (p.shape, p.dtype) for n, p in port.named_parameters()}


def test_encode_and_cross_kv():
    cfg, _, jparams, _, port = models()
    x = frames(1, 2)
    jenc = jax.jit(lambda p, f: jax_encdec.encode(p, f, cfg))(
        jparams, jnp.asarray(x))
    enc = encdec.encode(port, torch.from_numpy(x))
    assert_close(enc, jenc, "encoder output")
    jkv = jax_encdec.cross_kv(jparams, jenc)
    kv = encdec.cross_kv(port, enc)
    for n in ("k", "v"):
        assert_close(kv[n], jkv[n], f"cross {n}")


def port_cache(B: int, pages: int):
    cfg, _, _, model, _ = models()
    kv = KVBlockManager(total_pages=B * pages, page_tokens=PAGE)
    cache = model.init_cache(kv.total_pages, PAGE,
                             Runtime(kv_cache_dtype="float32"), "cpu",
                             lanes=B)
    return kv, cache


def test_prefill_then_decode_logits():
    """B=2 prompts of 12 tokens over 24 frames each, then 24 decode steps
    fed the reference's greedy tokens (contexts 13-36, across pages)."""
    cfg, jmodel, jparams, model, port = models()
    B, S, steps = 2, 12, 24
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    x = frames(3, B)
    jrt = JaxRuntime(kv_cache_dtype="float32")
    jcache = jmodel.init_cache(B, S + steps + 1, jrt)
    jlog, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), jcache, jrt,
                                  extra_embed=jnp.asarray(x))
    jdecode = jax.jit(lambda p, t, c, i: jmodel.decode_step(p, t, c, i, jrt))
    max_pages = (S + steps) // PAGE + 1
    kv, cache = port_cache(B, max_pages)
    for b in range(B):
        kv.allocate(f"s{b}", S)

    def tables():
        return torch.from_numpy(np.stack([kv.block_table(f"s{b}", max_pages)
                                          for b in range(B)]))

    log = model.prefill(port, torch.from_numpy(tokens).long(), cache,
                        tables(), extra_embed=torch.from_numpy(x))
    assert_close(log, jlog, "prefill")
    for t in range(steps):
        nxt = np.array(jnp.argmax(jlog[:, -1], axis=-1), np.int32)[:, None]
        for b in range(B):
            kv.extend(f"s{b}", S + t + 1)
        jlog, jcache = jdecode(jparams, jnp.asarray(nxt), jcache,
                               jnp.int32(S + t))
        log = model.decode_step(port, torch.from_numpy(nxt).long(), cache,
                                tables(),
                                torch.full((B,), S + t, dtype=torch.int32))
        assert_close(log, jlog, f"decode step {t}")


def test_ragged_lanes():
    """Prompts of 5 and 11 tokens prefilled one at a time into lanes 1
    and 0 of the cache, then decoded together, lane 0 first, at their
    own positions; the reference runs each sequence alone (B=1)."""
    cfg, jmodel, jparams, model, port = models()
    jrt = JaxRuntime(kv_cache_dtype="float32")
    jdecode = jax.jit(lambda p, t, c, i: jmodel.decode_step(p, t, c, i, jrt))
    r = np.random.default_rng(4)
    prompts = [r.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 11)]
    x = frames(5, 2)
    steps, max_pages = 8, 2
    kv, cache = port_cache(2, max_pages)
    ref, nxt = [], []
    for s, lane in ((0, 1), (1, 0)):
        jcache = jmodel.init_cache(1, 32, jrt)
        jlog, jcache = jmodel.prefill(jparams, jnp.asarray(prompts[s][None]),
                                      jcache, jrt,
                                      extra_embed=jnp.asarray(x[s:s + 1]))
        logs = [jlog]
        for t in range(steps):
            tok = jnp.argmax(logs[-1][:, -1], axis=-1)[:, None]
            jlog, jcache = jdecode(jparams, tok.astype(jnp.int32), jcache,
                                   jnp.int32(len(prompts[s]) + t))
            logs.append(jlog)
        ref.append(logs)
        kv.allocate(f"s{s}", len(prompts[s]))
        log = model.prefill(
            port, torch.from_numpy(prompts[s][None]).long(), cache,
            torch.from_numpy(kv.block_table(f"s{s}", max_pages)[None]),
            lanes=torch.tensor([lane]),
            extra_embed=torch.from_numpy(x[s:s + 1]))
        assert_close(log, logs[0], f"prefill {s}")
        nxt.append(int(np.argmax(as_np(logs[0])[0, -1])))
    order = [1, 0]                       # lane 0 holds sequence 1
    pos = np.array([len(prompts[s]) for s in order], np.int32)
    tok = np.array([[nxt[s]] for s in order])
    for t in range(steps):
        for s in order:
            kv.extend(f"s{s}", len(prompts[s]) + t + 1)
        bt = np.stack([kv.block_table(f"s{s}", max_pages) for s in order])
        log = model.decode_step(port, torch.from_numpy(tok).long(), cache,
                                torch.from_numpy(bt), torch.from_numpy(pos),
                                lanes=torch.tensor([0, 1]))
        for row, s in enumerate(order):
            assert_close(log[row:row + 1], ref[s][t + 1],
                         f"sequence {s} step {t}")
        tok = np.array([[int(np.argmax(as_np(ref[s][t + 1])[0, -1]))]
                        for s in order])
        pos = pos + 1


def test_engines_cannot_serve_whisper():
    """Fault C10: the reference engine's prefill passes no frames, so its
    encoder fails on ``None``; the port's engine refuses the model with
    that reason instead of inventing a frames path."""
    cfg, jmodel, jparams, model, port = models()
    eng = JS.InferenceEngine(jmodel, jparams, slots=2,
                             max_seq=cfg.max_seq_len,
                             rt=JaxRuntime(kv_cache_dtype="float32"))
    eng.submit(JS.Request(request_id="r0", entitlement="prod",
                          prompt_tokens=[2, 3, 5], max_tokens=4,
                          arrival_s=0.0), now=0.0)
    with pytest.raises(AttributeError, match="NoneType"):
        eng.step(0.0)
    with pytest.raises(ValueError, match="C10"):
        TS.InferenceEngine(model, port, slots=2, max_seq=cfg.max_seq_len)
    with pytest.raises(ValueError, match="frames"):
        kv, cache = port_cache(1, 1)
        model.prefill(port, torch.tensor([[2, 3, 5]]), cache,
                      torch.zeros((1, 1), dtype=torch.int32))
