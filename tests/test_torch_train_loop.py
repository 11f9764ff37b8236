"""The port's train step and ``TrainLoop`` against the reference's, on
the CPU, on reduced ``tinyllama-1.1b`` (2 layers, vocab 256, sequences
of 32 tokens, batches of 4 — the reference's own train-loop tests) in
float32 and in bfloat16, both starting from the reference's
``PRNGKey(0)`` init (``params_from_jax``).

Tolerances:

* One step, float32: loss and grad norm within 1e-5 relative; the
  moments (``mu`` is 0.1 × the clipped gradient after one step) within
  1e-4 of each leaf's largest entry (the gradient tolerance of
  ``tests/test_torch_train_families.py``; 3e-5 here).  New params
  within 1e-5 of each leaf's largest entry wherever the reference's
  gradient is at least ``G_BIG`` = 1e-3 of the leaf's largest, and
  within 2·lr everywhere: Adam's first step is ``lr·g/|g|``, so a
  gradient at rounding noise (XLA and torch sum in other orders) may
  flip that step's sign.
* One step, bfloat16: loss and grad norm at ``TOL_FAMILIES``' form,
  |err| ≤ 2e-3 + 2e-2·|ref|.  The gradient is held to the reference's
  own bfloat16 rounding: the port's is at most half as far from the
  reference's bfloat16 gradient as that is from the reference's
  float32 gradient at the same weights (leaf by leaf, against the
  leaf's largest entry: 1-5 % against 13-51 % on these inputs).  New
  params at ``TOL_FAMILIES`` where the gradient is at least
  ``G_BIG_BF16`` = 5e-2 of the leaf's largest, within 2·lr and the
  two sides' rounding to bf16 (2^-7 of the larger) everywhere.
* 8 ``TrainLoop`` steps: float32 losses within ``LOSS_RTOL_F32`` = 1e-4
  relative (the first step's flipped signs grow to ~2e-5 by step 7),
  1e-3 with int8 compression (a quantisation boundary crossed by a
  rounding difference moves a whole int8 step); bfloat16 losses at
  ``TOL_FAMILIES``.  Accuracy is compared in float32 only: in bfloat16
  it counts 0-3 right tokens of 128, where one token is 0.8 %.
* Crash and resume within the port: ``rel=1e-5``, the reference's own
  bound for its bit-exact resume (on the CPU the port resumes bit for
  bit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import latest_step as jax_latest_step
from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticLMData as JaxData
from repro.models import build_model as jax_build_model
from repro.training import grad_compress as jgc
from repro.training import optimizer as jopt
from repro.training import train_loop as jtl
from repro_torch import tree as T
from repro_torch.checkpointing import latest_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticLMData
from repro_torch.models import build_model, param_tree, params_from_jax
from repro_torch.training.grad_compress import CompressorConfig
from repro_torch.training.optimizer import OptimizerConfig, adamw_init
from repro_torch.training.train_loop import TrainConfig, TrainLoop, \
    make_train_step
from torch_threads import one_thread  # noqa: F401 (an autouse fixture)

TOL_FAMILIES = (2e-3, 2e-2)
LOSS_RTOL_F32, LOSS_RTOL_INT8 = 1e-4, 1e-3
G_BIG, G_BIG_BF16 = 1e-3, 5e-2


def setup(dtype="float32", compressor="none", steps=8, ckpt=None,
          lr=1e-2):
    over = dict(num_layers=2, vocab_size=256, dtype=dtype)
    jcfg = jax_get_config("tinyllama-1.1b").reduced(**over)
    cfg = get_config("tinyllama-1.1b").reduced(**over)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    opt = dict(lr=lr, warmup_steps=2, total_steps=steps)
    comp = dict(kind=compressor, topk_ratio=0.1)
    jt = jtl.TrainConfig(steps=steps, checkpoint_every=4,
                         checkpoint_dir=ckpt,
                         optimizer=jopt.OptimizerConfig(**opt),
                         compressor=jgc.CompressorConfig(**comp),
                         log_every=1)
    tc = TrainConfig(steps=steps, checkpoint_every=4, checkpoint_dir=ckpt,
                     optimizer=OptimizerConfig(**opt),
                     compressor=CompressorConfig(**comp), log_every=1)
    jdata = JaxData(JaxDataConfig(vocab_size=256, seq_len=32,
                                  global_batch=4))
    data = SyntheticLMData(DataConfig(vocab_size=256, seq_len=32,
                                      global_batch=4))
    return (jcfg, jmodel, jparams, jt, jdata), (cfg, build_model(cfg), tc,
                                                data)


def port_params(cfg, jparams):
    return params_from_jax(cfg, jax.tree.map(np.asarray, jparams), "cpu")


def port_loop(port, jparams, tc=None, **kw):
    cfg, model, tc0, data = port
    return TrainLoop(model, data, tc or tc0, params=port_params(cfg, jparams),
                     device="cpu", **kw)


def within(got, ref, dtype, rtol=1e-5) -> bool:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if dtype == "bfloat16":
        atol, rtol = TOL_FAMILIES
        return bool((np.abs(got - ref) <= atol + rtol * np.abs(ref)).all())
    return bool((np.abs(got - ref) <= rtol * np.abs(ref).max()).all())


def leaves(tree) -> dict:
    return {T.key_of(p): T.stacked(leaf).detach().float().numpy()
            for p, leaf in T.leaves_with_paths(tree)}


def jax_leaves(tree) -> dict:
    return {"/".join(str(getattr(k, "key", k)) for k in p):
            np.asarray(x).astype(np.float32)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def one_step(dtype: str, model_dtype=None):
    """The reference's jitted step and the port's from the same weights
    on batch 0 (the reference's model in ``model_dtype``, default
    ``dtype``, its weights cast from the same init)."""
    (jcfg, jmodel, jparams, jt, jdata), port = setup(dtype)
    cfg, model, tc, data = port
    batch = jdata.global_batch_at(0)
    if model_dtype:
        jmodel = jax_build_model(dataclasses.replace(jcfg, dtype=model_dtype))
        jparams = jax.tree.map(lambda x: jnp.array(
            x, dtype=jnp.float32 if x.dtype == jnp.bfloat16 else x.dtype),
            jparams)
    jold = jax_leaves(jparams)
    jnew, jo, _, jm = jtl.make_train_step(jmodel, jt)(
        jax.tree.map(lambda x: x.copy(), jparams), jopt.adamw_init(jparams),
        {"_": 0}, {k: jnp.asarray(v) for k, v in batch.items()})
    if model_dtype:
        return jax_leaves(jo.mu)
    params = port_params(cfg, jparams)
    tree = param_tree(params)
    _, opt, _, m = make_train_step(model, tc)(
        params, adamw_init(tree), None,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    return (jold, jax_leaves(jnew), jax_leaves(jo.mu), jm), \
        (leaves(tree), leaves(opt.mu), opt, m)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_train_step_matches_jitted_reference(dtype):
    (jold, jnew, jmu, jm), (new, mu, opt, m) = one_step(dtype)
    assert m["skipped"].item() == float(jm["skipped"]) == 0.0
    assert opt.step.item() == 1
    assert within(m["loss"].item(), float(jm["loss"]), dtype)
    assert within(m["grad_norm"].item(), float(jm["grad_norm"]), dtype)
    lr = m["lr"].item()
    assert lr == float(jm["lr"])
    assert list(new) == list(jnew) and list(mu) == list(jmu)
    if dtype == "float32":
        for k in jmu:
            assert within(mu[k], jmu[k], dtype, 1e-4), k
    else:
        jmu32 = one_step(dtype, model_dtype="float32")
        for k in jmu:
            scale = np.abs(jmu32[k]).max()
            own = np.abs(jmu[k] - jmu32[k]).max() / scale
            assert np.abs(mu[k] - jmu[k]).max() / scale <= 0.5 * own, k
    g_big = G_BIG if dtype == "float32" else G_BIG_BF16
    ulp = 0.0 if dtype == "float32" else 2.0 ** -7
    for k in jnew:
        big = np.abs(jmu[k]) >= g_big * np.abs(jmu[k]).max()
        assert within(new[k][big], jnew[k][big], dtype), k
        assert (np.abs(new[k] - jnew[k]) <= 2 * lr * (1 + 1e-5) + ulp
                * np.maximum(np.abs(new[k]), np.abs(jnew[k]))).all(), k
        assert not np.array_equal(new[k], jold[k]), k       # it moved


def run_both(dtype, compressor="none", steps=8, lr=1e-2):
    ref, port = setup(dtype, compressor, steps, lr=lr)
    jcfg, jmodel, jparams, jt, jdata = ref
    jlogs = jtl.TrainLoop(jmodel, jdata, jt).run(steps=steps)
    logs = port_loop(port, jparams).run(steps=steps)
    return jlogs, logs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loop_losses_match_reference(dtype):
    jlogs, logs = run_both(dtype)
    assert [e["step"] for e in logs] == list(range(8))
    for e, j in zip(logs, jlogs):
        assert e["skipped"] == j["skipped"] == 0.0
        assert e["lr"] == pytest.approx(j["lr"], rel=1.2e-7)   # 1 ulp
        assert within(e["loss"], j["loss"], dtype, LOSS_RTOL_F32), (e, j)
        if dtype == "float32":
            assert e["accuracy"] == j["accuracy"], (e, j)
    assert logs[-1]["loss"] < logs[0]["loss"]


def test_crash_and_resume(tmp_path):
    ref, port = setup(ckpt=str(tmp_path))
    cfg, model, tc, data = port
    jparams = ref[2]
    plain = dataclasses.replace(tc, checkpoint_dir=None, checkpoint_every=100)
    ref_logs = port_loop(port, jparams, plain).run(steps=8)

    loop = port_loop(port, jparams)
    with pytest.raises(RuntimeError, match="injected crash"):
        loop.run(steps=8, crash_after_step=4)
    assert latest_step(str(tmp_path)) == 4

    # a NEW loop (fresh process semantics) resumes from step 4; its
    # starting params are overwritten by the checkpoint's
    loop2 = TrainLoop(model, data, tc, gen=torch.Generator().manual_seed(9),
                      device="cpu")
    assert loop2.start_step == 4 and loop2.history[0] == {"resumed_from": 4}
    logs2 = loop2.run(steps=8)
    assert [e["step"] for e in logs2] == [4, 5, 6, 7]
    for e, r in zip(logs2, ref_logs[4:]):
        assert e["loss"] == pytest.approx(r["loss"], rel=1e-5)
    assert latest_step(str(tmp_path)) == 8


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_resumes_a_jax_checkpoint(tmp_path, dtype):
    """The reference's TrainLoop crashes after step 4 (checkpoint at
    step 4); the port resumes it, and its steps 4-7 match the
    reference's uninterrupted run."""
    ref, port = setup(dtype, ckpt=str(tmp_path))
    jcfg, jmodel, jparams, jt, jdata = ref
    cfg, model, tc, data = port
    uninterrupted = jtl.TrainLoop(jmodel, jdata, dataclasses.replace(
        jt, checkpoint_dir=None)).run(steps=8)
    with pytest.raises(RuntimeError, match="injected crash"):
        jtl.TrainLoop(jmodel, jdata, jt).run(steps=8, crash_after_step=4)
    assert jax_latest_step(str(tmp_path)) == 4
    loop = TrainLoop(model, data, tc, device="cpu")
    assert loop.start_step == 4
    assert loop.opt_state.step.item() == 4
    logs = loop.run(steps=8)
    assert [e["step"] for e in logs] == [4, 5, 6, 7]
    for e, j in zip(logs, uninterrupted[4:]):
        assert within(e["loss"], j["loss"], dtype, LOSS_RTOL_F32), (e, j)


def test_int8_compressed_training_matches_reference_and_learns():
    jlogs, logs = run_both("float32", "int8")
    for e, j in zip(logs, jlogs):
        assert within(e["loss"], j["loss"], "float32", LOSS_RTOL_INT8), (e, j)
    _, port = setup(compressor="int8", steps=24, lr=2e-2)
    ref = setup(steps=24)[0]
    logs = port_loop(port, ref[2]).run(steps=24)
    assert logs[-1]["loss"] < logs[0]["loss"]
    assert all(e["skipped"] == 0.0 for e in logs)


def test_topk_compressed_training_learns():
    """Port only: the reference's jitted step cannot take top-k (fault
    C12)."""
    ref, port = setup(compressor="topk", steps=24, lr=2e-2)
    loop = port_loop(port, ref[2])
    logs = loop.run(steps=24)
    assert logs[-1]["loss"] < logs[0]["loss"]
    err = leaves(loop.err_state)
    assert set(err) == set(jax_leaves(ref[2]))    # one per reference leaf
    assert all(np.abs(v).max() > 0 for v in err.values())


def test_poisoned_step_is_skipped_with_state_unchanged():
    """A NaN loss skips the update: params and the whole AdamW state —
    its step counter too — keep their bits, as the reference's
    ``jnp.where(ok, new, old)`` keeps them; the next step resumes with
    the old step counter (lr schedule not advanced)."""
    (jcfg, jmodel, jparams, jt, jdata), port = setup()
    cfg, model, tc, data = port
    loop = port_loop(port, jparams)
    loop.run(steps=2)
    tree = param_tree(loop.params)
    before = ({k: v.copy() for k, v in leaves(tree).items()},
              loop.opt_state.step.clone(),
              {k: v.copy() for k, v in leaves(loop.opt_state.mu).items()},
              {k: v.copy() for k, v in leaves(loop.opt_state.nu).items()})
    batch = {k: torch.from_numpy(v) for k, v in
             data.global_batch_at(2).items()}
    batch["mask"] = torch.ones(batch["targets"].shape)
    batch["mask"][0, 0] = float("nan")
    _, opt, _, m = loop.step_fn(loop.params, loop.opt_state, None, batch)
    assert m["skipped"].item() == 1.0
    assert not np.isfinite(m["loss"].item())
    after = (leaves(tree), opt.step, leaves(opt.mu), leaves(opt.nu))
    for a, b in ((before[0], after[0]), (before[2], after[2]),
                 (before[3], after[3])):
        for k in a:
            assert a[k].tobytes() == b[k].tobytes(), k
    assert opt.step.item() == before[1].item() == 2

    # the reference skips the same batch the same way
    jb = {k: jax.numpy.asarray(v.numpy()) for k, v in batch.items()}
    jstate = jopt.adamw_init(jparams)
    jstate = jopt.AdamWState(step=jax.numpy.asarray(2, jax.numpy.int32),
                             mu=jstate.mu, nu=jstate.nu)
    _, jopt_state, _, jm = jtl.make_train_step(jmodel, jt)(
        jparams, jstate, {"_": 0}, jb)
    assert float(jm["skipped"]) == 1.0 and int(jopt_state.step) == 2


def test_encoder_decoder_refused_naming_c11():
    """The synthetic pipeline gives no frames: the reference's TrainLoop
    fails inside ``encode`` (frames ``None``); the port's refuses the
    config up front, naming the fault."""
    jcfg = jax_get_config("whisper-small").reduced()
    data_cfg = dict(vocab_size=jcfg.vocab_size, seq_len=16, global_batch=2)
    jloop = jtl.TrainLoop(jax_build_model(jcfg), JaxData(JaxDataConfig(
        **data_cfg)), jtl.TrainConfig(steps=1, log_every=1))
    with pytest.raises(AttributeError, match="'NoneType' object has no "
                                             "attribute 'shape'"):
        jloop.run(steps=1)
    cfg = get_config("whisper-small").reduced()
    with pytest.raises(ValueError, match="C11"):
        TrainLoop(build_model(cfg), SyntheticLMData(DataConfig(**data_cfg)),
                  TrainConfig(steps=1), device="cpu")
