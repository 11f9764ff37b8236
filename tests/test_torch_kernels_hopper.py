"""The arithmetic of the port's Hopper attention kernels, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them
against their plain versions there).  What their design changes in the
arithmetic is mirrored by plain PyTorch functions beside the plain
versions, and those mirrors are held here against the JAX Pallas
kernels in interpret mode, on inputs made from numpy with a seed:

* the split-K paged kernel computes a partial (m, l, acc) per chunk of
  64 tokens and merges them — :func:`reference_paged_attention_split`;
* the tensor-core flash kernel walks 64-key tiles and rounds P to
  bfloat16 before P·V — :func:`reference_attention_bf16_p`.

The Pallas flash kernel needs ``S % block == 0``; ragged lengths are
zero-padded at the end for it, which leaves the causal rows below the
length unchanged.  Tolerances: 2e-5 for float32 and 2e-2 for bfloat16,
as in ``tests/test_kernels.py``.

Also here: the explicit choice of the flash route, the split size, and
the build's cache key and entry-point binding.
"""
import ctypes
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (
    flash_attention,
    reference_attention,
    reference_attention_bf16_p,
)
from repro_torch.kernels.flash_attention.flash_attention import route
from repro_torch.kernels.paged_attention import (
    paged_attention,
    reference_paged_attention,
    reference_paged_attention_split,
)
from repro_torch.kernels.paged_attention.paged_attention import (
    pages_per_split,
)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def both(x: np.ndarray, dtype: str):
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors never reach a CUDA kernel on any route."""
    yield
    assert flash_attention.launches == 0
    assert paged_attention.launches == 0
    assert not any(flash_attention.route_launches.values())
    assert not any(paged_attention.route_launches.values())


# -- paged decode: per-chunk partials and their merge --------------------------
B, H, HKV, DH, T, MAX_PAGES = 2, 8, 2, 32, 16, 128


def paged_case(seed: int, ctxs, dead_pages=()):
    """Random pages, distinct page ids per sequence up to each context
    and -1 after it; ``dead_pages`` (table columns) set to -1 too."""
    r = np.random.default_rng(seed)
    b = len(ctxs)
    P = b * MAX_PAGES
    q = r.standard_normal((b, H, DH)).astype(np.float32)
    kp = r.standard_normal((P, T, HKV, DH)).astype(np.float32)
    vp = r.standard_normal((P, T, HKV, DH)).astype(np.float32)
    bt = r.permutation(P).astype(np.int32).reshape(b, MAX_PAGES)
    for i, c in enumerate(ctxs):
        bt[i, -(-c // T):] = -1
    bt[:, list(dead_pages)] = -1
    return q, kp, vp, bt, np.asarray(ctxs, np.int32)


def check_paged(q, kp, vp, bt, cl, dtype):
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in (q, kp, vp))
    want = jax_paged(jq, jk, jv, jnp.asarray(bt), jnp.asarray(cl),
                     interpret=True)
    args = (tq, tk, tv, torch.from_numpy(bt), torch.from_numpy(cl))
    for fn in (reference_paged_attention_split, reference_paged_attention):
        out = fn(*args)
        assert out.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(as_np(out), as_np(want), **TOL[dtype])
    for i, c in enumerate(cl):
        if c == 0:
            assert not as_np(want)[i].any()
            assert not as_np(reference_paged_attention_split(*args))[i].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ctx", [0, 1, 63, 64, 65, 128, 2047])
def test_paged_split_boundaries(ctx, dtype):
    """Contexts on both sides of a 64-token split, empty to full."""
    check_paged(*paged_case(ctx, [ctx, ctx]), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_split_mixed_contexts_and_dead_split(dtype):
    """Mixed contexts in one batch, and a split (table columns 4-7,
    tokens 64-127) whose pages are all -1: its partial carries no mass
    and the merge ignores it."""
    q, kp, vp, bt, cl = paged_case(11, [300, 0, 65, 2047, 1, 128],
                                   dead_pages=range(4, 8))
    check_paged(q, kp, vp, bt, cl, dtype)


def test_paged_all_pages_dead_gives_zeros():
    """A live context whose every page is -1 has no key: zeros, as the
    Pallas kernel gives."""
    q, kp, vp, bt, cl = paged_case(12, [200, 90])
    bt[0] = -1
    check_paged(q, kp, vp, bt, cl, "float32")


@pytest.mark.parametrize("page_tokens,pages", [(8, 8), (16, 4), (32, 2),
                                               (64, 1), (128, 1)])
def test_pages_per_split(page_tokens, pages):
    """64 tokens a split, or one page when pages are longer."""
    assert pages_per_split(page_tokens) == pages


def test_paged_split_longer_pages():
    """Pages of 32 tokens (two a split) and a softcap, against Pallas."""
    r = np.random.default_rng(13)
    q = r.standard_normal((3, 4, 64)).astype(np.float32) * 4
    kp = r.standard_normal((24, 32, 2, 64)).astype(np.float32)
    vp = r.standard_normal((24, 32, 2, 64)).astype(np.float32)
    bt = r.permutation(24).astype(np.int32)[:15].reshape(3, 5)
    bt[1, 3:] = -1
    cl = np.asarray([150, 70, 33], np.int32)
    want = jax_paged(*(jnp.asarray(x) for x in (q, kp, vp, bt, cl)),
                     softcap=50.0, interpret=True)
    out = reference_paged_attention_split(
        *(torch.from_numpy(x) for x in (q, kp, vp, bt, cl)), softcap=50.0)
    np.testing.assert_allclose(as_np(out), as_np(want), rtol=5e-5,
                               atol=5e-5)


# -- flash prefill: 64-key tiles, P in bf16 --------------------------------------
def jax_flash_padded(q, k, v, window=None, block=64, softcap=None):
    """The Pallas kernel (interpret mode) on inputs zero-padded to a
    multiple of ``block``; causal rows below S do not see the padding."""
    S = q.shape[2]
    q, k, v = (jnp.pad(x, ((0, 0), (0, 0), (0, -S % block), (0, 0)))
               for x in (q, k, v))
    out = jax_flash(q, k, v, causal=True, window=window, softcap=softcap,
                    block_q=block, block_k=block, interpret=True)
    return out[:, :, :S]


#: (S, window, dh, heads, kv heads, softcap): dh 64 at ragged lengths;
#: dh 256 at gemma2's shape (G 2, softcap 50) and recurrentgemma's (G 10)
FLASH_MIRROR_CASES = [
    pytest.param(S, window, 64, 4, 2, None, id=f"{S}-{window}")
    for S, window in ((1, None), (63, None), (64, None), (65, None),
                      (130, None), (130, 40))
] + [
    pytest.param(S, 40, 256, h, hkv, cap, id=f"dh256-{name}-{S}")
    for name, h, hkv, cap in (("gemma2", 4, 2, 50.0),
                              ("recurrentgemma", 10, 1, None))
    for S in (63, 65, 130)
]


@pytest.mark.parametrize("S,window,dh,H,Hkv,softcap", FLASH_MIRROR_CASES)
def test_flash_bf16_p_mirror(S, window, dh, H, Hkv, softcap):
    """The tensor-core route's arithmetic against the Pallas kernel at
    ragged lengths around the 64-row tile, a window (40) that starts
    inside a key tile, and at dh 256 with GQA and gemma2's softcap
    (queries scaled by 4 so that the cap bends the logits)."""
    r = np.random.default_rng(S if dh == 64 else [S, dh, H])
    arrs = [r.standard_normal((1, h, S, dh)).astype(np.float32)
            for h in (H, Hkv, Hkv)]
    if softcap:
        arrs[0] *= 4
    (jq, tq), (jk, tk), (jv, tv) = (both(x, "bfloat16") for x in arrs)
    want = jax_flash_padded(jq, jk, jv, window=window, softcap=softcap)
    out = reference_attention_bf16_p(tq, tk, tv, causal=True, window=window,
                                     softcap=softcap)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(as_np(out), as_np(want), **TOL["bfloat16"])


def test_flash_bf16_p_mirror_matches_plain_in_f32():
    """With nothing to round (float32 inputs whose P is exact in bf16:
    a single key per row), the mirror equals the plain version."""
    r = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(r.standard_normal((1, 2, 70, 32))
                                .astype(np.float32)) for _ in range(3))
    out = reference_attention_bf16_p(q, k, v, causal=True, window=1)
    ref = reference_attention(q, k, v, causal=True, window=1)
    np.testing.assert_allclose(as_np(out), as_np(ref), **TOL["float32"])


def test_flash_split_p_keeps_the_families_margin(monkeypatch):
    """At dh 256 the tensor-core route feeds P to P·V as two bf16 parts:
    on gemma2-9b's heads (16/8, softcap 50) its mirror reads under half
    of the families' limit |err| <= 2e-3 + 2e-2·|ref| against the plain
    version, where one rounding of P reads more than twice as much."""
    fa = importlib.import_module(
        "repro_torch.kernels.flash_attention.flash_attention")
    assert 256 in fa.SPLIT_P_HEAD_DIMS
    r = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(r.standard_normal((1, h, 130, 256))
                                .astype(np.float32)).to(torch.bfloat16)
               for h in (16, 8, 8))
    ref = reference_attention(q, k, v, softcap=50.0).float()

    def reading(out):
        return float(((out.float() - ref).abs()
                      / (2e-3 + 2e-2 * ref.abs())).max())

    split = reading(reference_attention_bf16_p(q, k, v, softcap=50.0))
    monkeypatch.setattr(fa, "SPLIT_P_HEAD_DIMS", ())
    once = reading(reference_attention_bf16_p(q, k, v, softcap=50.0))
    assert split <= 0.5
    assert once > 2 * split


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 96, "scalar"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 32, "scalar"),
    (torch.float32, 128, "scalar"), (torch.float32, 64, "scalar"),
])
def test_flash_route(dtype, dh, want):
    """bf16 at widths 64, 128 and 256 takes the tensor cores; float32
    (TF32 would break its tolerance) and other widths the scalar
    kernel."""
    assert route(dtype, dh) == want


# -- build ---------------------------------------------------------------------------
def test_build_key_covers_every_csrc_file(tmp_path, monkeypatch):
    """An edited header, a new file, or other flags give a new library
    name, so nothing stale is loaded."""
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    first = build._target("k")
    assert build._target("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = build._target("k")
    assert second != first
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "extra.cuh").write_text("\n")
    third = build._target("k")
    assert third != second
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-G",))
    assert build._target("k") != third


def test_entry_points_bound_once(monkeypatch):
    """Argument types are set when an entry is first asked for; later
    calls get the same bound function."""
    libc = ctypes.CDLL(None)
    monkeypatch.setitem(build._LIBS, "fake", libc)
    monkeypatch.setattr(build, "_FNS", {})
    fn = build.function("fake", "abs", [ctypes.c_int])
    assert fn.argtypes == [ctypes.c_int] and fn.restype is ctypes.c_int
    fn.argtypes = [ctypes.c_long]          # a later bind would undo this
    assert build.function("fake", "abs", [ctypes.c_int]) is fn
    assert fn.argtypes == [ctypes.c_long]
    assert fn(-7) == 7
