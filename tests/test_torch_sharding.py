"""The port's sharding rules (``repro_torch.distributed.sharding``) and
the dry-run's batch specs against the JAX package's, spec for spec.

The reference's ``param_pspecs`` / ``cache_pspecs`` run in-process on
a ``jax.sharding.AbstractMesh``, so the production meshes (16×16 and
2×16×16) need no devices; the port's run on an abstract ``ModelMesh``
of the same axes.  The port's params are built on the ``meta`` device
(full width and depth, no storage), the reference's by
``jax.eval_shape``.  Every config, train and serve mode; the caches and
batches of every ``SHAPES`` cell and of the mini cells of
``tests/test_distributed.py``.
"""
import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import get_config as jax_get_config
from repro.distributed.sharding import cache_pspecs as jax_cache_pspecs
from repro.distributed.sharding import make_plan as jax_make_plan
from repro.distributed.sharding import param_pspecs as jax_param_pspecs
from repro.launch.dryrun import batch_pspec as jax_batch_pspec
from repro.launch.dryrun import input_specs as jax_input_specs
from repro.models import build_model as jax_build_model
from repro.models.config import ShapeSpec as JaxShapeSpec
from repro_torch.configs import get_config
from repro_torch.distributed import (
    cache_pspecs,
    dense_cache_shapes,
    make_plan,
    param_pspecs,
)
from repro_torch.launch.dryrun import batch_pspec, input_specs
from repro_torch.launch.mesh import ModelMesh, make_production_mesh, \
    make_test_mesh
from repro_torch.models import build_model, param_tree
from repro_torch.models.config import SHAPES, ShapeSpec
from repro_torch.tree import leaves_with_paths

ARCHS = ("gemma2-9b", "deepseek-7b", "tinyllama-1.1b", "gemma2-2b",
         "xlstm-350m", "qwen3-moe-30b-a3b", "qwen3-moe-235b-a22b",
         "internvl2-2b", "recurrentgemma-2b", "whisper-small", "qwen3-8b")
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
#: the mini cells of tests/test_distributed.py: (kind, S, B)
MINI = (("train", 32, 8), ("prefill", 64, 8), ("decode", 64, 8))


def meshes(name):
    shape, axes = MESHES[name]
    return AbstractMesh(shape, axes), ModelMesh(dict(zip(axes, shape)))


def is_spec(x):
    return isinstance(x, PartitionSpec)


def jax_leaves(tree):
    """(key path, spec as a tuple) of every leaf, in flattening order."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_spec)[0]
    return [("/".join(str(getattr(k, "key", getattr(k, "name", k)))
                      for k in path), tuple(spec)) for path, spec in flat]


def port_leaves(tree):
    return [("/".join(path), spec) for path, spec in leaves_with_paths(tree)]


def cells():
    """Every SHAPES cell and the mini cells, as (name, B, S, kind)."""
    out = [(n, s.global_batch, s.seq_len, s.kind) for n, s in SHAPES.items()]
    return out + [(f"mini_{k}", B, S, k) for k, S, B in MINI]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspecs_equal_reference(arch, mesh):
    jmesh, pmesh = meshes(mesh)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jparams = jax.eval_shape(jax_build_model(jcfg).init,
                             jax.random.PRNGKey(0))
    model = build_model(cfg).init(torch.Generator().manual_seed(0), "meta")
    for mode in ("train", "serve"):
        ref = jax_leaves(jax_param_pspecs(jax_make_plan(jcfg, jmesh, mode),
                                          jparams))
        got = port_leaves(param_pspecs(make_plan(cfg, pmesh, mode),
                                       param_tree(model)))
        assert got == ref, f"{arch} {mode} on {mesh}"


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_batch_pspecs_equal_reference(arch, mesh):
    jmesh, pmesh = meshes(mesh)
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jmodel = jax_build_model(jcfg)
    for name, B, S, kind in cells():
        mode = "train" if kind == "train" else "serve"
        jplan = jax_make_plan(jcfg, jmesh, mode)
        plan = make_plan(cfg, pmesh, mode)
        jcache = jax.eval_shape(lambda: jmodel.init_cache(B, S))
        shapes = dense_cache_shapes(cfg, B, S)
        assert [s for _, s in leaves_with_paths(shapes)] == [
            tuple(x.shape) for x in jax.tree.leaves(jcache)], (arch, name)
        assert port_leaves(cache_pspecs(plan, shapes)) == jax_leaves(
            jax_cache_pspecs(jplan, jcache)), f"{arch} {name} on {mesh}"
        ref = jax_batch_pspec(jplan, jax_input_specs(
            jcfg, JaxShapeSpec(name, S, B, kind)))
        got = batch_pspec(plan, input_specs(cfg, ShapeSpec(name, S, B, kind)))
        assert {k: tuple(v) for k, v in ref.items()} == got, (arch, name)
        # the inputs themselves: the same names, shapes and dtypes
        jin = jax_input_specs(jcfg, JaxShapeSpec(name, S, B, kind))
        pin = input_specs(cfg, ShapeSpec(name, S, B, kind))
        assert {k: (tuple(v.shape), str(v.dtype)) for k, v in jin.items()} \
            == {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
                for k, v in pin.items()}


def test_meshes():
    """The production and test meshes' axes, and an abstract mesh's
    place (coordinate 0 of every axis)."""
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).shape == {
        "pod": 2, "data": 16, "model": 16}
    m = make_test_mesh(2, 4)
    assert m.size == 8 and not m.bound
    assert m.axis_size(("data", "model")) == 8 and m.axis_size(None) == 1
    assert m.axis_index("model") == 0
    with pytest.raises(RuntimeError, match="no process group"):
        m.group("data")
