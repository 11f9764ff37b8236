"""The port's training substrate against the reference's, on the CPU:
the LM loss, the lr schedule, clipping, AdamW, the weight-decay mask,
gradient compression with error feedback, its wire bytes, and the
synthetic data pipeline.  Both packages get the same numpy-seeded
inputs.

* AdamW is held against the reference's update **jitted**, as its train
  step runs it: XLA contracts the two moment EWMAs, the decay
  ``u + wd·p`` and the step ``p − lr·u`` into fused multiply-adds
  (fault C1's pattern; eager JAX differs from its jitted self on ~20 %
  of the moments), and the port's explicit ``fma`` at those four sites
  gives the jitted update bit for bit (float32 and bfloat16 params)
  when the clip does not scale.  When it does, the clip scale is
  ``max_norm / norm``, and the port's norm (torch's pairwise sums per
  tensor) and XLA's (its own reduction order) differ by up to ~2e-6
  relative — a summation order, not a fused site — so the scaled
  gradients, and with them the moments and params, are held within
  ``CLIP_RTOL`` = 1e-5 of each leaf's largest entry (bfloat16 params
  also within one bfloat16 ulp of each entry, where the scale moves a
  value across a rounding boundary), and the norm itself within 1e-5
  relative.
* Compression is held per reference leaf: the reduced model's
  gradients as the port holds them (one tensor per layer) stacked over
  the periods, as the reference's leaves are, so the int8 scale and
  top-k's k are the reference's.  Values are compared after the round
  trip (top-k's indices may order ties among zeros differently),
  float32 within 1e-6 relative of each leaf's largest entry; two steps,
  so the error feedback of the first feeds the second.  ``int8`` is held
  against the reference jitted (XLA folds ``/ 127`` into a product with
  the reciprocal and fuses the error ``corrected − q·scale``; the port
  does both), ``topk`` against the reference eager: under ``jax.jit``
  its ``_topk_decompress`` raises (fault C12), so the reference's own
  jitted train step cannot take it.
* The data pipeline: the same batches row for row; and, as in the
  reference, any seed but 0 raises, because ``(seed·1,000,003 + step)
  · 65,537 + row`` passes numpy's 2³² seed limit (fault C13).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMData as JaxData
from repro.models import build_model as jax_build_model
from repro.training import grad_compress as jgc
from repro.training import optimizer as jopt
from repro.training.loss import lm_loss as jax_lm_loss
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models import param_tree, params_from_jax
from repro_torch.training import (
    AdamWState,
    OptimizerConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    lm_loss,
    lr_schedule,
)
from repro_torch.training.grad_compress import (
    CompressorConfig,
    compress_grads,
    compressed_bytes,
    init_error_state,
)
from repro_torch.training.optimizer import _decay_mask, global_norm

CLIP_RTOL = 1e-5


# -- helpers --------------------------------------------------------------------
def jax_leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_leaves(tree) -> dict:
    return {T.key_of(p): T.stacked(leaf).float().numpy()
            for p, leaf in T.leaves_with_paths(tree)}


def as_port(like, arrays: dict, dtype=None):
    """A tree of ``like``'s structure (groups included) holding the
    reference-shaped ``arrays`` by key."""
    def leaf(path, x):
        t = torch.from_numpy(np.asarray(arrays[T.key_of(path)], np.float32))
        return T.unstacked(t.to(dtype or T.tensors(x)[0].dtype), x)
    return T.map_leaves(leaf, like, with_path=True)


def reduced_model(arch="tinyllama-1.1b", dtype="float32"):
    jcfg = jax_get_config(arch).reduced(dtype=dtype)
    cfg = get_config(arch).reduced(dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    port = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    return jparams, port


def random_like(r, jparams, scale=1.0, positive=False) -> dict:
    out = {}
    for k, x in jax_leaves(jparams).items():
        v = r.standard_normal(x.shape).astype(np.float32) * scale
        out[k] = np.abs(v) if positive else v
    return out


# -- loss ------------------------------------------------------------------------
@pytest.mark.parametrize("masked", [False, True])
def test_lm_loss_matches_reference(masked):
    r = np.random.default_rng(0)
    logits = (r.standard_normal((3, 7, 40)) * 4).astype(np.float32)
    logits[..., 33:] = -1e9                      # a padded vocabulary
    targets = r.integers(0, 33, (3, 7)).astype(np.int32)
    # a few positions predicted right, so accuracy is not 0
    targets[0, :3] = logits[0, :3, :33].argmax(-1)
    mask = (r.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    jl, jm = jax_lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                         None if mask is None else jnp.asarray(mask))
    tl, tm = lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                     None if mask is None else torch.from_numpy(mask))
    assert tl.item() == pytest.approx(float(jl), rel=1e-6)
    assert tm["accuracy"].item() == float(jm["accuracy"]) > 0
    assert tm["tokens"].item() == float(jm["tokens"])


def test_lm_loss_reference_cases():
    V = 16
    targets = torch.tensor([[1, 2, 3]])
    logits = torch.nn.functional.one_hot(targets, V).float() * 100.0
    loss, m = lm_loss(logits, targets)
    assert loss.item() < 1e-3 and m["accuracy"].item() == 1.0
    targets = torch.tensor([[1, 2]])
    logits = torch.zeros((1, 2, V))
    logits[0, 0, 1] = 100.0
    logits[0, 1, 0] = 100.0
    full, _ = lm_loss(logits, targets)
    masked, _ = lm_loss(logits, targets, mask=torch.tensor([[1.0, 0.0]]))
    assert masked.item() < full.item()


# -- schedule and clip -------------------------------------------------------------
@pytest.mark.parametrize("step", [0, 1, 9, 10, 37, 55, 99, 150])
def test_lr_schedule_matches_jitted_reference(step):
    """Warmup (0-9), the cosine (10-99) and past the end (150), bit for
    bit with the reference's schedule under jit."""
    cfg = OptimizerConfig(lr=3e-3, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    ref = np.float32(jax.jit(lambda s: jopt.lr_schedule(s, jcfg))(
        jnp.asarray(step, jnp.int32)))
    got = lr_schedule(torch.tensor(step, dtype=torch.int32), cfg)
    assert got.dtype == torch.float32
    assert got.item() == float(ref)


def test_lr_schedule_reference_cases():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    assert lr_schedule(torch.tensor(0), cfg).item() == pytest.approx(0.1)
    assert lr_schedule(torch.tensor(9), cfg).item() == pytest.approx(1.0)
    assert lr_schedule(torch.tensor(99), cfg).item() == pytest.approx(
        0.1, abs=0.02)


def assert_leaves_close(got: dict, ref: dict, rtol: float, what: str):
    """Within ``rtol`` of each leaf's largest entry; a bfloat16 leaf
    also one bfloat16 ulp (2^-7·|x|) of each entry: a value the scale
    moves across a rounding boundary."""
    assert list(got) == list(ref), what
    for k, r in ref.items():
        ulp = 2.0 ** -7 if r.dtype.name == "bfloat16" else 0.0
        r = r.astype(np.float32)
        err = np.abs(got[k] - r) - ulp * np.abs(r)
        assert err.max() <= rtol * np.abs(r).max(), f"{what} {k}: {err.max()}"


@pytest.mark.parametrize("max_norm", [1.0, 1e6])
def test_clip_by_global_norm_matches_reference(max_norm):
    jparams, port = reduced_model()
    g = random_like(np.random.default_rng(1), jparams, scale=0.05)
    jclipped, jnorm = jax.jit(lambda g: jopt.clip_by_global_norm(
        g, max_norm))(_as_jax_tree(jparams, g))
    clipped, norm = clip_by_global_norm(as_port(param_tree(port), g),
                                        max_norm)
    assert norm.item() == pytest.approx(float(jnorm), rel=CLIP_RTOL)
    assert_leaves_close(port_leaves(clipped), jax_leaves(jclipped),
                        CLIP_RTOL, "clip")
    if max_norm > 1e3:                           # scale 1: untouched
        for k, v in port_leaves(clipped).items():
            np.testing.assert_array_equal(v, g[k])


def test_clip_reference_case():
    clipped, norm = clip_by_global_norm({"a": torch.full((4,), 3.0)}, 1.0)
    assert norm.item() == pytest.approx(6.0)
    assert torch.linalg.norm(clipped["a"]).item() == pytest.approx(1.0)


def _as_jax_tree(like, arrays: dict, dtype=None):
    """The reference-structured tree of ``like`` holding ``arrays`` (in
    ``like``'s dtypes, or ``dtype``)."""
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    keys = ["/".join(str(getattr(k, "key", k)) for k in p) for p, _ in leaves]
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(arrays[k]).astype(dtype or x.dtype)
                  for k, (_, x) in zip(keys, leaves)])


# -- AdamW --------------------------------------------------------------------------
def adamw_case(dtype: str, max_norm: float, seed: int = 0):
    jparams, port = reduced_model(dtype=dtype)
    r = np.random.default_rng(seed)
    grads = random_like(r, jparams, scale=0.02)
    mu = random_like(r, jparams, scale=0.01)
    nu = random_like(r, jparams, scale=1e-3, positive=True)
    cfg = OptimizerConfig(lr=0.05, warmup_steps=3, total_steps=40,
                          grad_clip=max_norm)
    jcfg = jopt.OptimizerConfig(**dataclasses.asdict(cfg))
    jstate = jopt.AdamWState(step=jnp.asarray(5, jnp.int32),
                             mu=_as_jax_tree(jparams, mu, jnp.float32),
                             nu=_as_jax_tree(jparams, nu, jnp.float32))
    jnew, jst, jm = jax.jit(lambda p, g, s: jopt.adamw_update(p, g, s, jcfg))(
        jparams, _as_jax_tree(jparams, grads), jstate)
    tree = param_tree(port)
    state = AdamWState(step=torch.tensor(5, dtype=torch.int32),
                       mu=as_port(tree, mu, torch.float32),
                       nu=as_port(tree, nu, torch.float32))
    new, st, m = adamw_update(tree, as_port(tree, grads), state, cfg)
    return (jnew, jst, jm), (new, st, m), port


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_bit_for_bit_with_jitted_reference(dtype):
    """Clip inactive: every param and moment bit for bit."""
    (jnew, jst, jm), (new, st, m), _ = adamw_case(dtype, 1e6)
    assert st.step.item() == int(jst.step) == 6
    assert m["lr"].item() == float(jm["lr"])
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]),
                                                  rel=CLIP_RTOL)
    for got, ref in ((new, jnew), (st.mu, jst.mu), (st.nu, jst.nu)):
        ref, got = jax_leaves(ref), port_leaves(got)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k].astype(np.float32),
                                          err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_clipped_matches_jitted_reference(dtype):
    """Clip active: the norm's summation order shows (``CLIP_RTOL``).  A
    bfloat16 model rounds the clipped gradients to bfloat16, so there a
    gradient may differ by one bfloat16 ulp, and the moments by
    ``(1 − b1)`` of that: 2^-7·0.1 of the leaf's largest entry."""
    rtol = CLIP_RTOL if dtype == "float32" else 2.0 ** -7 * 0.1
    (jnew, jst, jm), (new, st, m), _ = adamw_case(dtype, 1.0, seed=1)
    assert float(jm["grad_norm"]) > 1.0             # the clip scales
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]),
                                                  rel=CLIP_RTOL)
    for got, ref, what in ((new, jnew, "params"), (st.mu, jst.mu, "mu"),
                           (st.nu, jst.nu, "nu")):
        assert_leaves_close(port_leaves(got), jax_leaves(ref), rtol, what)


def test_adamw_inputs_untouched():
    (_, _, _), (new, st, _), port = adamw_case("float32", 1.0)
    before = {k: v.copy() for k, v in port_leaves(param_tree(port)).items()}
    assert all(np.array_equal(before[k], v) for k, v in
               port_leaves(param_tree(port)).items())
    assert not any(np.array_equal(before[k], v) for k, v in
                   port_leaves(new).items() if "scale" not in k)


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    cfg = OptimizerConfig(lr=0.1, warmup_steps=0, total_steps=1000,
                          weight_decay=0.0, grad_clip=100.0)
    st = adamw_init(params)
    for _ in range(200):
        params, st, _ = adamw_update(params, {"w": 2 * params["w"]}, st, cfg)
    assert params["w"].abs().max().item() < 0.05


def test_no_decay_on_norm_scales():
    params = {"layers": {"scale": torch.ones(4), "w_up": torch.ones(4, 4)}}
    cfg = OptimizerConfig(lr=0.1, weight_decay=1.0, warmup_steps=0)
    zero = T.map_tensors(torch.zeros_like, params)
    new, _, _ = adamw_update(params, zero, adamw_init(params), cfg)
    assert new["layers"]["scale"][0].item() == pytest.approx(1.0)
    assert new["layers"]["w_up"][0, 0].item() < 1.0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "gemma2-2b",
                                  "qwen3-moe-30b-a3b", "recurrentgemma-2b",
                                  "xlstm-350m", "internvl2-2b",
                                  "whisper-small"])
def test_decay_mask_leaf_by_leaf(arch):
    """The mask on the port's view (the reference's key paths, a norm's
    ``scale`` included) equals the reference's ``_decay_mask`` on its
    own paths; the port's bare names would decay ``final_norm``."""
    jparams = jax.eval_shape(jax_build_model(
        jax_get_config(arch).reduced()).init, jax.random.PRNGKey(0))
    ref = [jopt._decay_mask(p) for p, _ in
           jax.tree_util.tree_flatten_with_path(jparams)[0]]
    port = params_from_jax(get_config(arch).reduced(), jax.tree.map(
        lambda x: np.zeros(x.shape, np.float32), jparams), "cpu")
    got = [_decay_mask(p) for p, _ in T.leaves_with_paths(param_tree(port))]
    assert got == ref
    assert not _decay_mask(("final_norm", "scale")) and \
        _decay_mask(("final_norm",))


# -- gradient compression -------------------------------------------------------------
@pytest.mark.parametrize("kind", ["none", "int8", "topk"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "recurrentgemma-2b"])
def test_compress_grads_on_stacked_leaves(kind, arch):
    jparams, port = reduced_model(arch)
    tree = param_tree(port)
    cfg = CompressorConfig(kind=kind, topk_ratio=0.1)
    jcfg = jgc.CompressorConfig(kind=kind, topk_ratio=0.1)
    jerr = jgc.init_error_state(jparams)
    err = init_error_state(tree)
    assert {k: v.shape for k, v in port_leaves(err).items()} == \
        {k: v.shape for k, v in jax_leaves(jerr).items()}
    r = np.random.default_rng(2)
    for step in range(2):
        g = random_like(r, jparams, scale=0.1)
        for k in g:              # exact zeros, as unused embedding rows
            g[k][..., :3] = 0.0
        ref_step = functools.partial(jgc.compress_grads, cfg=jcfg)
        if kind != "topk":       # topk cannot be jitted (fault C12)
            ref_step = jax.jit(ref_step)
        jg, jerr = ref_step(_as_jax_tree(jparams, g), jerr)
        pg, err = compress_grads(as_port(tree, g), err, cfg)
        for got, ref in ((port_leaves(pg), jax_leaves(jg)),
                         (port_leaves(err) if kind != "none" else {},
                          jax_leaves(jerr) if kind != "none" else {})):
            for k in ref:
                scale = np.abs(ref[k]).max()
                assert np.abs(got[k] - ref[k]).max() <= 1e-6 * scale, \
                    (kind, step, k)
        if kind == "topk":       # 10 % of each stacked leaf survives
            for k, v in port_leaves(pg).items():
                assert np.count_nonzero(v) <= max(1, int(v.size * 0.1)), k


def test_compress_reference_cases():
    g = {"w": torch.from_numpy(np.random.RandomState(0).randn(256)
                               .astype(np.float32))}
    out, _ = compress_grads(g, init_error_state(g),
                            CompressorConfig(kind="int8"))
    np.testing.assert_allclose(out["w"].numpy(), g["w"].numpy(), atol=0.05)
    g = {"w": torch.tensor([0.1, -5.0, 0.2, 4.0])}
    out, _ = compress_grads(g, init_error_state(g),
                            CompressorConfig(kind="topk", topk_ratio=0.5))
    assert out["w"].tolist() == [0.0, -5.0, 0.0, 4.0]
    # error feedback conserves signal over many steps
    g = {"w": torch.tensor([0.1, 1.0])}
    cfg = CompressorConfig(kind="topk", topk_ratio=0.5)
    e, sent = init_error_state(g), np.zeros(2)
    for _ in range(200):
        out, e = compress_grads(g, e, cfg)
        sent += out["w"].numpy()
    assert sent[0] == pytest.approx(20.0, rel=0.25)
    assert sent[1] == pytest.approx(200.0, rel=0.25)
    assert e["w"].abs().max().item() < 3.0


@pytest.mark.parametrize("kind,ratio", [("none", 0.01), ("topk", 0.01),
                                        ("topk", 0.1), ("int8", 0.01)])
def test_compressed_bytes_equal(kind, ratio):
    for arch in ("tinyllama-1.1b", "recurrentgemma-2b", "whisper-small"):
        jparams, port = reduced_model(arch)
        assert compressed_bytes(param_tree(port), CompressorConfig(
            kind, ratio)) == jgc.compressed_bytes(
            jparams, jgc.CompressorConfig(kind, ratio))
    assert compressed_bytes({"w": torch.zeros(1000)},
                            CompressorConfig("int8")) == 1004.0


# -- data -------------------------------------------------------------------------------
@pytest.mark.parametrize("vocab,seq,batch", [(256, 32, 4), (32000, 256, 8)])
def test_synthetic_batches_identical(vocab, seq, batch):
    ref = JaxData(JaxDataConfig(vocab_size=vocab, seq_len=seq,
                                global_batch=batch))
    port = SyntheticLMData(DataConfig(vocab_size=vocab, seq_len=seq,
                                      global_batch=batch))
    for step in (0, 1, 7):
        a, b = port.global_batch_at(step), ref.global_batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(port.shard_at(step, 1, 2)["tokens"],
                                      ref.shard_at(step, 1, 2)["tokens"])
    parts = [port.shard_at(3, i, batch // 2) for i in range(batch // 2)]
    np.testing.assert_array_equal(
        np.concatenate([p["tokens"] for p in parts]),
        port.global_batch_at(3)["tokens"])


def test_c13_a_seed_but_0_raises_in_both():
    for data in (JaxData(JaxDataConfig(vocab_size=64, seq_len=8,
                                       global_batch=2, seed=1)),
                 SyntheticLMData(DataConfig(vocab_size=64, seq_len=8,
                                            global_batch=2, seed=1))):
        with pytest.raises(ValueError, match="Seed must be between"):
            data.global_batch_at(0)


def test_c12_reference_topk_cannot_be_jitted():
    """The reference's jitted train step cannot compress by top-k; the
    port's step can (``tests/test_torch_train_loop.py``)."""
    g = {"w": jnp.arange(8.0)}
    cfg = jgc.CompressorConfig(kind="topk", topk_ratio=0.5)
    with pytest.raises(jax.errors.ConcretizationTypeError):
        jax.jit(lambda g, e: jgc.compress_grads(g, e, cfg))(
            g, jgc.init_error_state(g))


def test_global_norm_sums_every_tensor():
    tree = {"a": [torch.full((2,), 3.0), torch.full((2,), 4.0)],
            "b": torch.tensor([0.0])}
    assert global_norm(tree).item() == pytest.approx(np.sqrt(50.0))
