"""``forward_train`` and its gradients in the port against
``jax.value_and_grad`` of the reference, on the CPU, for the families
whose layers differ: gemma2-2b (sliding-window layers, attention and
final softcaps, post norms), qwen3-moe-30b-a3b (the MoE MLP, with the
capacity dropping assignments), recurrentgemma-2b (RG-LRU layers and
the tail layers outside the periods), xlstm-350m (mLSTM and sLSTM
cells), internvl2-2b (an image prefix of patch embeddings) and
whisper-small (the encoder over frames, cross attention).

Each family's ``reduced()`` config in float32; the reference's random
init goes to the port through ``params_from_jax``; the same
numpy-seeded tokens, targets, patches and frames go through both.  The
loss is ``lm_loss`` of each package on the last S positions, as the
train step takes it; the reference's step is jitted, as its train
step is.

Tolerances (float32): the logits within 1e-4 × max|logit| and the loss
within 1e-5 relative (the two packages sum and contract in other
orders); every gradient leaf, in the reference's stacked shape, within
``GRAD_TOL`` × its largest |entry|, that entry taken as at least
``GRAD_FLOOR`` of the largest entry of any leaf.  ``GRAD_TOL`` is 1e-4,
and 1e-3 for whisper-small: its reduced encoder's attention is sharp,
and the reference's float32 gradients and the port's are each 1e-4 to
3e-4 (relative) from the port's run in float64.  The floor is for a
leaf whose gradient cancels to rounding noise, as xlstm-350m's sLSTM
input-gate bias does (~1e-8 of the largest: the stabiliser makes
``i_eff`` 1 wherever the input gate wins).  ``remat="full"`` (each
period of layers recomputed in backward) must give the very gradients
of ``"none"``.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.training.loss import lm_loss as jax_lm_loss
from repro_torch import tree as T
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.models import build_model, param_tree, params_from_jax
from repro_torch.training.loss import lm_loss
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

moe_mod = importlib.import_module("repro_torch.models.moe")

ARCHS = ["gemma2-2b", "qwen3-moe-30b-a3b", "recurrentgemma-2b",
         "xlstm-350m", "internvl2-2b", "whisper-small"]
B, S, S_ENC = 2, 40, 24           # S past gemma2's reduced window of 32
LOGIT_TOL, LOSS_TOL = 1e-4, 1e-5
GRAD_TOL, GRAD_FLOOR = {"whisper-small": 1e-3}, 1e-3


def setup(arch: str, seed: int = 0, **over):
    jcfg = jax_get_config(arch).reduced(dtype="float32", **over)
    cfg = get_config(arch).reduced(dtype="float32", **over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    port = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")
    r = np.random.default_rng(seed)
    tokens = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    targets = r.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    extra = None
    if cfg.is_encoder_decoder:
        extra = r.standard_normal((B, S_ENC, cfg.d_model)).astype(np.float32)
    elif cfg.num_vision_tokens:
        extra = r.standard_normal(
            (B, cfg.num_vision_tokens, cfg.d_model)).astype(np.float32)
    return cfg, jmodel, jparams, port, tokens, targets, extra


def jax_loss_and_grads(jmodel, jparams, tokens, targets, extra):
    def loss_fn(p):
        logits = jmodel.forward_train(
            p, jnp.asarray(tokens),
            extra_embed=None if extra is None else jnp.asarray(extra))
        loss, _ = jax_lm_loss(logits[:, -targets.shape[1]:, :],
                              jnp.asarray(targets))
        return loss, logits

    (loss, logits), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(jparams)
    return float(loss), np.asarray(logits), grads


def port_loss_and_grads(cfg, port, tokens, targets, extra, remat="none"):
    tree = param_tree(port)
    flat = T.tensors(tree)
    for t in flat:
        t.requires_grad_(True)
    logits = build_model(cfg).forward_train(
        port, torch.from_numpy(tokens),
        extra_embed=None if extra is None else torch.from_numpy(extra),
        remat=remat)
    loss, _ = lm_loss(logits[:, -targets.shape[1]:, :],
                      torch.from_numpy(targets))
    grads = torch.autograd.grad(loss, flat, allow_unused=True,
                                materialize_grads=True)
    for t in flat:
        t.requires_grad_(False)
    grads = T.unflatten_tensors(tree, list(grads))
    return loss.item(), logits.detach().numpy(), grads


def stacked_leaves(tree) -> dict:
    return {T.key_of(p): T.stacked(leaf).numpy()
            for p, leaf in T.leaves_with_paths(tree)}


def jax_leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(autouse=True)
def no_kernel_launches():
    """Training never reaches the attention kernels' wrappers."""
    before = (flash_attention.launches, paged_attention.launches)
    yield
    assert (flash_attention.launches, paged_attention.launches) == before


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_and_grads_match_reference(arch, monkeypatch):
    cfg, jmodel, jparams, port, tokens, targets, extra = setup(arch)
    dropped = []
    dispatch = moe_mod._dispatch_indices

    def counting(expert_ids, E, C):
        perm, dst, keep = dispatch(expert_ids, E, C)
        dropped.append(int((~keep).sum()))
        return perm, dst, keep

    monkeypatch.setattr(moe_mod, "_dispatch_indices", counting)
    jloss, jlogits, jgrads = jax_loss_and_grads(jmodel, jparams, tokens,
                                                targets, extra)
    loss, logits, grads = port_loss_and_grads(cfg, port, tokens, targets,
                                              extra)
    assert logits.shape == jlogits.shape
    err = np.abs(logits - jlogits).max()
    assert err <= LOGIT_TOL * np.abs(jlogits).max(), err
    assert loss == pytest.approx(jloss, rel=LOSS_TOL)

    ref = jax_leaves(jgrads)
    got = stacked_leaves(grads)
    assert list(got) == list(ref)          # every leaf, in the same order
    tol = GRAD_TOL.get(arch, 1e-4)
    floor = GRAD_FLOOR * max(np.abs(g).max() for g in ref.values())
    for key, g in ref.items():
        assert got[key].shape == g.shape, key
        scale = max(np.abs(g).max(), floor)
        err = np.abs(got[key] - g).max()
        assert err <= tol * scale, \
            f"{arch} grad {key}: max |diff| {err} > {tol} x {scale}"
    if cfg.is_moe:
        assert dropped and max(dropped) > 0, "no assignment was dropped"


def test_padded_vocab_masked_in_place_under_autograd():
    """``unembed`` masks the padded ids in place (a vocab of 500 padded
    to 512): under autograd their logits stay -1e9, their rows of the
    table get only the embedding's gradient (none: no token reaches
    them), as in the reference."""
    cfg, jmodel, jparams, port, tokens, targets, extra = setup(
        "tinyllama-1.1b", vocab_size=500)
    assert cfg.padded_vocab == 512
    jloss, jlogits, jgrads = jax_loss_and_grads(jmodel, jparams, tokens,
                                                targets, extra)
    loss, logits, grads = port_loss_and_grads(cfg, port, tokens, targets,
                                              extra)
    assert (logits[..., 500:] == -1e9).all() and \
        (jlogits[..., 500:] == -1e9).all()
    assert loss == pytest.approx(jloss, rel=LOSS_TOL)
    ref, got = jax_leaves(jgrads), stacked_leaves(grads)
    assert not ref["embed/table"][500:].any()
    assert not got["embed/table"][500:].any()
    for key, g in ref.items():
        scale = np.abs(g).max()
        assert np.abs(got[key] - g).max() <= 1e-4 * scale, key


@pytest.mark.parametrize("arch", ["gemma2-2b", "recurrentgemma-2b"])
def test_remat_full_gives_the_same_gradients(arch):
    """Each period recomputed in backward (recurrentgemma-2b's reduced
    config also has a tail layer, which runs outside the periods)."""
    cfg, _, _, port, tokens, targets, extra = setup(arch, seed=1)
    loss0, _, g0 = port_loss_and_grads(cfg, port, tokens, targets, extra)
    loss1, _, g1 = port_loss_and_grads(cfg, port, tokens, targets, extra,
                                       remat="full")
    assert loss0 == loss1
    for a, b in zip(T.tensors(g0), T.tensors(g1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_remat_policy_checked():
    from repro_torch.models import Runtime
    assert Runtime(remat="full").remat == "full"
    with pytest.raises(ValueError, match="remat"):
        Runtime(remat="dots")


def test_whisper_forward_train_needs_frames():
    cfg, _, _, port, tokens, _, _ = setup("whisper-small")
    with pytest.raises(ValueError, match="C11"):
        build_model(cfg).forward_train(port, torch.from_numpy(tokens))


def test_param_tree_is_the_reference_pytree():
    """Key paths and stacked shapes of every config equal the
    reference's flattening, and the view's tensors are the module's own
    parameters (every one, once)."""
    for arch in ["deepseek-7b", "tinyllama-1.1b", "gemma2-9b",
                 "qwen3-moe-235b-a22b", "qwen3-8b"] + ARCHS:
        jcfg = jax_get_config(arch).reduced()
        cfg = get_config(arch).reduced()
        jparams = jax.eval_shape(jax_build_model(jcfg).init,
                                 jax.random.PRNGKey(0))
        port = build_model(cfg).init(torch.Generator().manual_seed(0), "cpu")
        ref = [("/".join(str(getattr(k, "key", k)) for k in path),
                tuple(x.shape)) for path, x in
               jax.tree_util.tree_flatten_with_path(jparams)[0]]
        tree = param_tree(port)
        assert [(T.key_of(p), T.leaf_shape(leaf)) for p, leaf in
                T.leaves_with_paths(tree)] == ref, arch
        ids = [id(t) for t in T.tensors(tree)]
        assert sorted(ids) == sorted(id(p) for p in port.parameters()), arch
