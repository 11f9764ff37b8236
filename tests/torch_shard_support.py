"""Shared by the port's model-sharding tests: the reduced configs and
the subprocess that runs the JAX package's sharded programs
(``tests/torch_shard_reference.py``).  Imports no JAX, as the test
modules that spawn ranks must not (each rank imports its module)."""
import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import Runtime, build_model, params_from_jax
from repro_torch.tree import key_of, leaves_with_paths, stacked

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
#: the three meshes of the model-sharding tests, (data, model)
MESHES = ((1, 2), (2, 2), (2, 4))
ARCHS = ("tinyllama-1.1b", "gemma2-2b", "qwen3-moe-30b-a3b", "internvl2-2b")
#: the global grad norm sums its squares in another order on a mesh
#: (1.4e-5 seen); a leaf counted on every rank would be off by √2 or more
NORM_RTOL = 1e-4
#: the float32 update p_new − p_old of each leaf, held to the other
#: step's within this share of its norm.  AdamW's first step moves each
#: element by about lr·sign(g), 3e-6 at the default warmup and far under
#: the params' 1e-5: a lost update is off by 1, gradient blocks on
#: another rank by about √2, while the signs of a few near-zero gradients
#: that sum in another order flip (6e-5 of a leaf's elements, 1.1e-2 of
#: its norm seen)
STEP_SHARE = 5e-2
#: each leaf's first moment µ = (1 − β1)·g, element by element, within
#: this share of the leaf's largest |µ| (4.3e-4 seen); under int8
#: compression one quantisation level of the leaf (1/127 of its max) may
#: differ where a gradient lies at a rounding boundary
MU_SHARE = 2e-3
INT8_MU_SHARE = 1.5 / 127


def reduced(arch: str, **over):
    """The port's copy of the reduced config of tests/test_distributed.py
    (d 128, 4/2 heads, dh 32, vocab 512, d_ff 256)."""
    base = get_config(arch)
    return base.reduced(d_model=128, num_heads=4, num_kv_heads=2,
                        head_dim=32, vocab_size=512,
                        d_ff=0 if base.d_ff == 0 else 256, **over)


def run_reference(jobs: dict, devices: int = 8, timeout: float = 600.0
                  ) -> dict:
    """Run ``jobs`` through tests/torch_shard_reference.py on ``devices``
    host devices; their results by key."""
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "jobs.pkl"), os.path.join(tmp, "out.pkl")
        with open(src, "wb") as f:
            pickle.dump(jobs, f)
        res = subprocess.run(
            [sys.executable, os.path.join(HERE, "torch_shard_reference.py"),
             src, dst], capture_output=True, text=True, timeout=timeout,
            env=env, cwd=REPO)
        assert res.returncode == 0, f"reference failed:\n{res.stderr[-3000:]}"
        with open(dst, "rb") as f:
            return pickle.load(f)        # written by the reference just now


def run_serve(model, params, tokens, fed, extra, cache, tables, rt):
    """Prefill logits, then one logits column a decode step fed ``fed``
    (``extra``: a VLM's patch embeddings before the prompt, or an
    encoder-decoder's frames)."""
    t = torch.from_numpy
    ex = None if extra is None else t(extra)
    n0 = tokens.shape[1] + (0 if extra is None or model.cfg.is_encoder_decoder
                            else extra.shape[1])
    out = [model.prefill(params, t(tokens).long(), cache, tables,
                         extra_embed=ex, rt=rt)]
    for s in range(fed.shape[1]):
        out.append(model.decode_step(
            params, t(fed[:, s:s + 1]).long(), cache, tables,
            torch.full((tokens.shape[0],), n0 + s, dtype=torch.int32),
            rt=rt))
    return out


def serve_one_device(cfg, weights, tokens, fed, extra, max_seq: int) -> list:
    """The port on one device (its own paged cache of 16-token pages,
    ``LOCAL``) from the reference's params ``weights``: the logits of
    :func:`run_serve` as numpy."""
    model = build_model(cfg)
    params = params_from_jax(cfg, weights, "cpu")
    b, T = tokens.shape[0], 16
    mp = max_seq // T
    rt = Runtime(kv_cache_dtype="float32")
    cache = model.init_cache(b * mp, T, rt, "cpu", lanes=b)
    tables = torch.arange(b * mp, dtype=torch.int32).reshape(b, mp)
    return [x.numpy() for x in run_serve(model, params, tokens, fed, extra,
                                         cache, tables, rt)]


def leaves(tree) -> list:
    """A param (or moment) tree's leaves as float32 numpy arrays, each
    group stacked."""
    return [stacked(leaf).detach().float().numpy() for _, leaf in
            leaves_with_paths(tree)]


def leaf_keys(tree) -> list:
    """The keys of :func:`leaves`' leaves, in the same order."""
    return [key_of(path) for path, _ in leaves_with_paths(tree)]


def assert_update_matches(got: dict, want: dict, init: list,
                          mu_share: float = MU_SHARE, keys: list = (),
                          frozen: frozenset = frozenset(),
                          noise: frozenset = frozenset()) -> None:
    """The new params within 1e-5; each leaf's update within
    ``STEP_SHARE`` of its norm and its first moment within ``mu_share``
    of its largest element.  ``keys`` name the leaves (as
    :func:`leaf_keys`).  A leaf named in ``frozen`` must have an update
    that rounds away in ``want`` (under half an ulp of every element:
    the RG-LRU's Λ, whose gradients are ~1e-9) and keep its params bit
    for bit in ``got``.  The leaves named in ``noise`` (whose gradient
    the one-device step itself does not reproduce when only its order
    of summation changes) are held by the params bound alone.  Every
    other leaf must move."""
    assert len(got["leaves"]) == len(want["leaves"]) == len(init)
    keys = list(keys) or [None] * len(init)
    assert len(keys) == len(init)
    assert set(frozen) | set(noise) <= set(keys)
    for key, a, b, p0 in zip(keys, got["leaves"], want["leaves"], init):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
        step = b - p0
        if key in noise:
            continue
        if key in frozen:
            assert not np.abs(step).any(), key
            np.testing.assert_array_equal(a, p0)
            continue
        assert np.abs(step).max() > 0, key
        assert (np.linalg.norm((a - p0) - step)
                <= STEP_SHARE * np.linalg.norm(step)), key
    assert len(got["mu"]) == len(want["mu"])
    for key, a, b in zip(keys, got["mu"], want["mu"]):
        if key not in noise:
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=mu_share * np.abs(b).max())
