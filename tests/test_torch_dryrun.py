"""The port's dry-run (``repro_torch.launch.dryrun``) and roofline
(``repro_torch.launch.roofline``) against the JAX package's.

The reference lowers a cell with XLA; its argument bytes a device are
the sums of ``NamedSharding.shard_shape`` over ``build_step``'s
arguments (C4: XLA's memory analysis may elide an unused argument, so
the spec sums are the quantity compared).  Those sums run in-process
on a ``jax.sharding.AbstractMesh``.  The port runs rank 0's step on the
``meta`` device: its param, optimizer-state, batch and dense-cache
bytes a device must equal the reference's sums exactly, for the mini
cells of ``tests/test_distributed.py`` (reduced configs, 2×4) and for
production cells (16×16, 2×16×16); every mini cell runs (flops > 0),
and whisper's cross K/V, whole on every rank where the reference's spec
splits its positions, holds tp times the reference's spec bytes.
``model_flops`` must equal the
reference's for every assigned config and shape; the roofline's terms
follow the peaks it is given.
"""
import math

import jax
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs import ASSIGNED
from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import cache_pspecs as jax_cache_pspecs
from repro.distributed.sharding import make_plan as jax_make_plan
from repro.distributed.sharding import param_pspecs as jax_param_pspecs
from repro.launch.dryrun import batch_pspec as jax_batch_pspec
from repro.launch.dryrun import input_specs as jax_input_specs
from repro.launch.roofline import model_flops as jax_model_flops
from repro.models import SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro.training.optimizer import adamw_init as jax_adamw_init
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import ModelMesh
from repro_torch.models.config import SHAPES, ShapeSpec

MINI_ARCHS = ("tinyllama-1.1b", "gemma2-2b", "qwen3-moe-30b-a3b",
              "recurrentgemma-2b", "xlstm-350m", "whisper-small")
MINI = (("train", 32, 8), ("prefill", 64, 8), ("decode", 64, 8))
#: production cells: (arch, shape, multi-pod)
PRODUCTION = (("qwen3-8b", "decode_32k", False),
              ("tinyllama-1.1b", "train_4k", False),
              ("qwen3-moe-30b-a3b", "prefill_32k", True),
              ("gemma2-2b", "long_500k", True),
              ("internvl2-2b", "prefill_32k", False))


def mini(cfg):
    return cfg.reduced(d_model=128, num_heads=4, num_kv_heads=2,
                       head_dim=32, vocab_size=512,
                       d_ff=0 if cfg.d_ff == 0 else 256)


def shard_bytes(mesh, specs, shapes) -> int:
    """Σ shard_shape bytes over congruent trees of specs and
    ShapeDtypeStructs."""
    leaves = jax.tree.leaves(shapes)
    specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, PartitionSpec))
    return sum(math.prod(NamedSharding(mesh, s).shard_shape(x.shape))
               * x.dtype.itemsize for s, x in zip(specs, leaves))


def reference_sizes(jcfg, jmesh, shape) -> dict:
    """The reference's per-device argument bytes by part."""
    mode = "train" if shape.kind == "train" else "serve"
    plan = jax_make_plan(jcfg, jmesh, mode)
    model = jax_build_model(jcfg)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    p_spec = jax_param_pspecs(plan, params)
    specs = jax_input_specs(jcfg, shape)
    out = {"params": shard_bytes(jmesh, p_spec, params),
           "batch": shard_bytes(jmesh, jax_batch_pspec(plan, specs), specs)}
    if shape.kind == "train":
        opt = jax.eval_shape(jax_adamw_init, params)
        out["opt"] = (shard_bytes(jmesh, PartitionSpec(), opt.step)
                      + 2 * shard_bytes(jmesh, p_spec, opt.mu))
    else:
        cache = jax.eval_shape(lambda: model.init_cache(
            shape.global_batch, shape.seq_len))
        out["cache_dense"] = shard_bytes(
            jmesh, jax_cache_pspecs(plan, cache), cache)
    return out


def port_sizes(art) -> dict:
    out = {"params": art["param_bytes"], "batch": art["batch_bytes"]}
    if art["kind"] == "train":
        out["opt"] = art["opt_bytes"]
    else:
        out["cache_dense"] = art["cache_bytes_dense"]
    return out


@pytest.mark.parametrize("arch", MINI_ARCHS)
def test_mini_cells_bytes_equal_reference(arch):
    jcfg, cfg = mini(jax_get_config(arch)), mini(get_config(arch))
    jmesh = AbstractMesh((2, 4), ("data", "model"))
    for kind, S, B in MINI:
        art = dryrun.run_cell(arch, "mini", False, verbose=False,
                              mesh=ModelMesh({"data": 2, "model": 4}),
                              cfg=cfg, shape=ShapeSpec("mini", S, B, kind))
        assert port_sizes(art) == reference_sizes(
            jcfg, jmesh, JaxShapeSpec("mini", S, B, kind)), (arch, kind)
        assert art["status"] == "ok" and art["flops"] > 0
        if cfg.is_encoder_decoder and kind != "train":
            # H_kv 2 does not split over tp 4: the reference's spec puts
            # the cross K/V's positions over tp, the port keeps it whole
            jcache = jax.eval_shape(lambda: jax_build_model(jcfg).init_cache(
                B, S))
            xkv = jax_cache_pspecs(jax_make_plan(jcfg, jmesh, "serve"),
                                   jcache)["xkv"]
            assert art["cross_bytes"] == 4 * shard_bytes(jmesh, xkv,
                                                         jcache["xkv"])
        coll = art["collectives"]
        assert coll["total_bytes"] == sum(coll["bytes_by_kind"].values())
        assert art["argument_size_in_bytes"] == (
            art["param_bytes"] + art["opt_bytes"] + art["cache_bytes"]
            + art["batch_bytes"])
        if kind == "train":
            # FSDP: the gathers before use, the gradients reduce-scattered
            assert coll["counts"]["all-gather"] > 0
            assert coll["counts"]["reduce-scatter"] > 0
        if cfg.is_moe:
            assert coll["counts"]["all-to-all"] > 0


@pytest.mark.parametrize("arch,shape,multi_pod", PRODUCTION)
def test_production_cells_bytes_equal_reference(arch, shape, multi_pod):
    art = dryrun.run_cell(arch, shape, multi_pod, verbose=False)
    assert art["status"] == "ok" and art["chips"] == (512 if multi_pod
                                                      else 256)
    jmesh = (AbstractMesh((2, 16, 16), ("pod", "data", "model"))
             if multi_pod else AbstractMesh((16, 16), ("data", "model")))
    assert port_sizes(art) == reference_sizes(jax_get_config(arch), jmesh,
                                              JAX_SHAPES[shape])


def test_long_context_applicability():
    art = dryrun.run_cell("qwen3-8b", "long_500k", False, verbose=False)
    assert art["status"] == "skip" and "524288" in art["reason"]


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_equal_reference(arch):
    for name, shape in SHAPES.items():
        assert roofline.model_flops(get_config(arch), shape) == \
            jax_model_flops(jax_get_config(arch), JAX_SHAPES[name]), name


def test_roofline_arithmetic_under_given_peaks():
    art = {"status": "ok", "arch": "qwen3-8b", "shape": "decode_32k",
           "mesh": "16x16", "chips": 256, "flops": 2.0e12,
           "argument_size_in_bytes": 3.0e9,
           "collectives": {"bytes_by_kind": {"all-reduce": 1.0e8,
                                             "all-gather": 5.0e7}}}
    r = roofline.analyze(art, peak_flops=1.0e15, hbm_bw=2.0e12,
                         link_bw=1.0e11)
    assert r.compute_s == pytest.approx(2.0e-3)
    assert r.memory_s == pytest.approx(1.5e-3)
    assert r.collective_s == pytest.approx((2 * 1.0e8 + 5.0e7) / 1.0e11)
    assert r.dominant == "collective"
    mf = roofline.model_flops(get_config("qwen3-8b"), SHAPES["decode_32k"])
    assert r.model_flops == mf
    assert r.useful_ratio == pytest.approx(mf / (2.0e12 * 256))
    assert roofline.analyze({"status": "skip"}, peak_flops=1.0,
                            hbm_bw=1.0, link_bw=1.0) is None


def test_xla_only_options_are_refused(capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--opt", "int8_kv"])
    assert "XLA-only" in capsys.readouterr().err
