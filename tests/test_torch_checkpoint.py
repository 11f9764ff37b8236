"""The port's checkpoints, in the reference's on-disk format, on the CPU:
the reference's own cases (roundtrip, a torn save is invisible, async
saves with garbage collection, a shape mismatch raises), and
checkpoints that cross between the packages in both directions — a
reduced model's params (bfloat16 and float32 leaves, the reference's
stacked leaves as the port's groups) and an AdamW state — restored
leaf for leaf, bit for bit."""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpointing import restore as jax_restore
from repro.checkpointing import save as jax_save
from repro.configs import get_config as jax_get_config
from repro.models import build_model as jax_build_model
from repro.training import optimizer as jopt
from repro_torch import tree as T
from repro_torch.checkpointing import AsyncCheckpointer, latest_step, \
    restore, save
from repro_torch.configs import get_config
from repro_torch.models import param_tree, params_from_jax
from repro_torch.training import AdamWState


def meta(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def test_save_restore_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2], dtype=torch.int32)},
            "g": [torch.ones(2, dtype=torch.bfloat16) * 1.5,
                  torch.full((2,), -3.25, dtype=torch.bfloat16)]}
    save(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    out = restore(str(tmp_path), 7, T.map_tensors(meta, tree))
    for p, leaf in T.leaves_with_paths(tree):
        got = dict(T.leaves_with_paths(out))[p]
        assert T.is_group(got) == T.is_group(leaf)
        for a, b in zip(T.tensors(got), T.tensors(leaf)):
            assert a.dtype == b.dtype and a.device.type == "cpu"
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    manifest = json.load(open(tmp_path / "step_00000007" / "manifest.json"))
    assert [(l["key"], l["shape"], l["dtype"]) for l in manifest["leaves"]] \
        == [("a", [2, 3], "float32"), ("b/c", [2], "int32"),
            ("g", [2, 2], "bfloat16")]


def test_torn_save_invisible(tmp_path):
    save(str(tmp_path), 1, {"a": torch.ones(2)})
    os.makedirs(tmp_path / "step_00000002")      # no COMMIT
    assert latest_step(str(tmp_path)) == 1


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    for s in [1, 2, 3]:
        ck.save(s, {"x": torch.full((4,), float(s))})
    ck.wait()
    assert latest_step(str(tmp_path)) == 3
    assert ck.saved == [1, 2, 3]
    kept = [d for d in os.listdir(tmp_path) if d.startswith("step_")]
    assert len(kept) == 2
    out = restore(str(tmp_path), 3, {"x": meta(torch.zeros(4))})
    assert out["x"].tolist() == [3.0] * 4


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The live tensors may change as soon as ``save`` returns."""
    x = torch.zeros(4)
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, {"x": x})
    x.fill_(9.0)
    ck.wait()
    assert restore(str(tmp_path), 1, {"x": meta(x)})["x"].tolist() == [0.0] * 4


def test_shape_mismatch_raises(tmp_path):
    save(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError):
        restore(str(tmp_path), 1, {"a": torch.empty(3, device="meta")})
    with pytest.raises(KeyError):
        restore(str(tmp_path), 1, {"b": torch.empty(2, device="meta")})


def train_state(arch: str, dtype: str):
    """A reduced model's params and a non-trivial AdamW state in both
    packages (the same values)."""
    jcfg = jax_get_config(arch).reduced(dtype=dtype)
    jparams = jax_build_model(jcfg).init(jax.random.PRNGKey(3))
    r = np.random.default_rng(3)
    mu = jax.tree.map(lambda x: jnp.asarray(
        r.standard_normal(x.shape).astype(np.float32)), jparams)
    nu = jax.tree.map(lambda x: jnp.asarray(
        r.random(x.shape).astype(np.float32)), jparams)
    jstate = {"params": jparams, "opt": jopt.AdamWState(
        step=jnp.asarray(17, jnp.int32), mu=mu, nu=nu)}
    port = params_from_jax(get_config(arch).reduced(dtype=dtype),
                           jax.tree.map(np.asarray, jparams), "cpu")
    tree = param_tree(port)

    def like_params(ref):
        arrays = leaves_np(ref, True)
        return T.map_leaves(lambda path, leaf: T.unstacked(
            torch.from_numpy(arrays[T.key_of(path)]), leaf), tree,
            with_path=True)

    opt = AdamWState(step=torch.tensor(17, dtype=torch.int32),
                     mu=like_params(mu), nu=like_params(nu))
    return jstate, {"params": tree, "opt": opt}


def leaves_np(tree, jax_tree: bool) -> dict:
    if jax_tree:
        return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                         for k in p): np.asarray(x).astype(np.float32)
                for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}
    return {T.key_of(p): T.stacked(leaf).float().numpy()
            for p, leaf in T.leaves_with_paths(tree)}


@pytest.mark.parametrize("arch,dtype", [("tinyllama-1.1b", "bfloat16"),
                                        ("recurrentgemma-2b", "float32"),
                                        ("whisper-small", "bfloat16")])
def test_jax_checkpoint_restores_in_the_port(tmp_path, arch, dtype):
    jstate, state = train_state(arch, dtype)
    jax_save(str(tmp_path), 17, jstate)
    out = restore(str(tmp_path), 17, T.map_tensors(meta, state))
    assert out["opt"].step.item() == 17
    assert out["opt"].step.dtype == torch.int32
    ref, got = leaves_np(jstate, True), leaves_np(out, False)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    # groups come back as groups, in the params' own dtypes
    for (p, a), (_, b) in zip(T.leaves_with_paths(out["params"]),
                              T.leaves_with_paths(state["params"])):
        assert T.is_group(a) == T.is_group(b)
        assert T.tensors(a)[0].dtype == T.tensors(b)[0].dtype, p


@pytest.mark.parametrize("arch,dtype", [("tinyllama-1.1b", "bfloat16"),
                                        ("qwen3-moe-30b-a3b", "float32")])
def test_port_checkpoint_restores_in_jax(tmp_path, arch, dtype):
    jstate, state = train_state(arch, dtype)
    save(str(tmp_path), 17, state)
    manifest = json.load(open(tmp_path / "step_00000017" / "manifest.json"))
    jax_save(str(tmp_path / "ref"), 17, jstate)
    ref_manifest = json.load(open(tmp_path / "ref" / "step_00000017"
                                  / "manifest.json"))
    assert manifest == ref_manifest          # keys, names, shapes, dtypes
    target = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype),
                          jstate)
    out = jax_restore(str(tmp_path), 17, target)
    assert int(out["opt"].step) == 17
    for (p, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(out)[0],
            jax.tree_util.tree_flatten_with_path(jstate)[0]):
        assert a.dtype == b.dtype, p
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    if dtype == "bfloat16":
        assert out["params"]["embed"]["table"].dtype == ml_dtypes.bfloat16
