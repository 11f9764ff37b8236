"""The port's attention kernels' plain versions against the JAX Pallas
kernels.

Inputs come from numpy with a seed and go to both packages.  The JAX
side runs as ``tests/test_kernels.py`` runs it on the CPU: the Pallas
kernel in interpret mode, and the pure-jnp oracle in ``ref.py``.  On
the CPU the port's wrappers take their plain versions (the CUDA kernels
are held against those on the card by ``chip_smoke.py``), and their
launch counters stay at 0.

Tolerances: 2e-5 for float32 and 2e-2 for bfloat16, as in
``tests/test_kernels.py``; the softcap cases use the 5e-5 that file
uses for them (tanh is computed by different libraries on each side).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import (
    flash_attention as jax_flash,
    flash_attention_bshd as jax_flash_bshd,
    reference_attention as jax_ref_attention,
)
from repro.kernels.paged_attention import (
    paged_attention as jax_paged,
    reference_paged_attention as jax_ref_paged,
)
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bshd,
    reference_attention,
)
from repro_torch.kernels.paged_attention import (
    paged_attention,
    paged_decode_attention,
    reference_paged_attention,
)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SOFTCAP_TOL = dict(rtol=5e-5, atol=5e-5)


def normal(seed: int, *shapes, scale: float = 1.0):
    r = np.random.default_rng(seed)
    return [(scale * r.standard_normal(s)).astype(np.float32)
            for s in shapes]


def both(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``
    (bf16 rounding is round-to-nearest-even on both sides)."""
    return (jnp.asarray(x).astype(dtype),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors never reach a CUDA kernel: the counters stay at 0."""
    f0, p0 = flash_attention.launches, paged_attention.launches
    yield
    assert flash_attention.launches == f0 == 0
    assert paged_attention.launches == p0 == 0


class TestFlashAttention:
    @pytest.mark.parametrize("B,H,Hkv,S,dh,bq,bk", [
        (1, 4, 4, 128, 64, 64, 64),      # MHA
        (2, 8, 2, 256, 64, 128, 128),    # GQA 4:1
        (1, 4, 1, 128, 128, 64, 64),     # MQA, 128-wide head
        (1, 2, 2, 192, 32, 64, 64),      # non-pow2 sequence
    ])
    def test_causal_sweep(self, B, H, Hkv, S, dh, bq, bk):
        q, k, v = normal(0, (B, H, S, dh), (B, Hkv, S, dh), (B, Hkv, S, dh))
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, block_q=bq, block_k=bk, interpret=True)
        out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True)
        np.testing.assert_allclose(as_np(out), as_np(ref), **TOL["float32"])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dtypes(self, dtype):
        arrs = normal(1, (1, 2, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64))
        (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in arrs)
        ref = jax_flash(jq, jk, jv, block_q=64, block_k=64, interpret=True)
        out = flash_attention(tq, tk, tv)
        assert out.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(as_np(out), as_np(ref), **TOL[dtype])

    def test_sliding_window(self):
        q, k, v = normal(2, *[(1, 2, 256, 32)] * 3)
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, window=64, block_q=64, block_k=64,
                        interpret=True)
        out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, window=64)
        np.testing.assert_allclose(as_np(out), as_np(ref), **TOL["float32"])

    def test_softcap(self):
        q, k = normal(3, (1, 2, 128, 32), (1, 2, 128, 32), scale=4.0)
        (v,) = normal(4, (1, 2, 128, 32))
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=True, softcap=50.0, block_q=64, block_k=64,
                        interpret=True)
        out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, softcap=50.0)
        np.testing.assert_allclose(as_np(out), as_np(ref), **SOFTCAP_TOL)

    def test_noncausal(self):
        q, k, v = normal(5, *[(1, 2, 128, 32)] * 3)
        ref = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=False, block_q=64, block_k=64, interpret=True)
        out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=False)
        np.testing.assert_allclose(as_np(out), as_np(ref), **TOL["float32"])

    @pytest.mark.parametrize("S", [1, 3, 37, 100])
    @pytest.mark.parametrize("window", [None, 16])
    def test_ragged_lengths(self, S, window):
        """Prompt lengths that are no multiple of any block: the Pallas
        kernel asserts ``S % block == 0``, so these hold against its
        oracle ``reference_attention`` only."""
        q, k, v = normal(6 + S, (1, 8, S, 32), (1, 2, S, 32), (1, 2, S, 32))
        ref = jax_ref_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window)
        out = flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, window=window)
        np.testing.assert_allclose(as_np(out), as_np(ref), **TOL["float32"])

    def test_bshd_layout_entry_point(self):
        """``flash_attention_bshd`` (the model's layout) against the
        reference's jitted wrapper of the same name."""
        q, k, v = normal(7, (2, 128, 4, 32), (2, 128, 2, 32),
                         (2, 128, 2, 32))
        ref = jax_flash_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True)
        out = flash_attention_bshd(*(torch.from_numpy(x)
                                     for x in (q, k, v)), causal=True)
        assert out.shape == q.shape
        np.testing.assert_allclose(as_np(out), as_np(ref), **TOL["float32"])

    def test_plain_version_is_ref_transcription(self):
        """The plain version equals ``ref.py`` causal, with a one-token
        window, and non-causal with a softcap."""
        q, k, v = normal(8, (1, 4, 64, 16), (1, 2, 64, 16), (1, 2, 64, 16))
        for kw in (dict(causal=True), dict(causal=True, window=1),
                   dict(causal=False, softcap=30.0)):
            ref = jax_ref_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), **kw)
            out = reference_attention(*(torch.from_numpy(x)
                                        for x in (q, k, v)), **kw)
            np.testing.assert_allclose(as_np(out), as_np(ref),
                                       **SOFTCAP_TOL)


def paged_inputs(seed, B, H, Hkv, dh, P, T, mp, min_ctx=1):
    """Random pages, distinct page ids per sequence padded with -1, and
    context lengths inside the pages each sequence holds."""
    r = np.random.default_rng(seed)
    q, kp, vp = normal(seed, (B, H, dh), (P, T, Hkv, dh), (P, T, Hkv, dh))
    bt = np.full((B, mp), -1, np.int32)
    cl = np.zeros((B,), np.int32)
    for b in range(B):
        n = int(r.integers(1, mp + 1))
        bt[b, :n] = r.choice(P, size=n, replace=False)
        cl[b] = int(r.integers(min_ctx, n * T + 1))
    return q, kp, vp, bt, cl


def run_paged(q, kp, vp, bt, cl, dtype="float32", softcap=None):
    (jq, tq), (jk, tk), (jv, tv) = (both(x, dtype) for x in (q, kp, vp))
    jax_out = jax_paged(jq, jk, jv, jnp.asarray(bt), jnp.asarray(cl),
                        softcap=softcap, interpret=True)
    out = paged_decode_attention(tq, tk, tv, torch.from_numpy(bt),
                                 torch.from_numpy(cl), softcap=softcap)
    return out, jax_out, (jq, jk, jv)


class TestPagedAttention:
    @pytest.mark.parametrize("B,H,Hkv,dh,P,T,mp", [
        (2, 4, 4, 64, 8, 16, 3),        # MHA
        (3, 8, 2, 64, 16, 16, 4),       # GQA
        (1, 8, 1, 128, 8, 32, 2),       # MQA, 128-wide head
        (4, 4, 2, 32, 32, 64, 5),       # larger pages
    ])
    def test_sweep(self, B, H, Hkv, dh, P, T, mp):
        q, kp, vp, bt, cl = paged_inputs(0, B, H, Hkv, dh, P, T, mp)
        out, jax_out, (jq, jk, jv) = run_paged(q, kp, vp, bt, cl)
        np.testing.assert_allclose(as_np(out), as_np(jax_out),
                                   **TOL["float32"])
        ref = jax_ref_paged(jq, jk, jv, jnp.asarray(bt), jnp.asarray(cl))
        np.testing.assert_allclose(as_np(out), as_np(ref), **TOL["float32"])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_dtypes(self, dtype):
        q, kp, vp = normal(5, (2, 4, 64), (8, 16, 2, 64), (8, 16, 2, 64))
        bt = np.asarray([[0, 1, -1], [2, -1, -1]], np.int32)
        cl = np.asarray([20, 10], np.int32)
        out, jax_out, _ = run_paged(q, kp, vp, bt, cl, dtype)
        assert out.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(as_np(out), as_np(jax_out), **TOL[dtype])

    def test_softcap(self):
        q, kp = normal(6, (1, 4, 32), (4, 16, 2, 32), scale=4.0)
        (vp,) = normal(7, (4, 16, 2, 32))
        bt = np.asarray([[1, 3]], np.int32)
        cl = np.asarray([30], np.int32)
        out, jax_out, _ = run_paged(q, kp, vp, bt, cl, softcap=50.0)
        np.testing.assert_allclose(as_np(out), as_np(jax_out), **SOFTCAP_TOL)

    def test_zero_context_gives_zeros(self):
        """``context_lens == 0`` is pinned to the Pallas kernel, which
        outputs 0; ``ref.py`` would average V over the masked slots."""
        q, kp, vp, bt, cl = paged_inputs(9, 3, 8, 2, 32, 12, 16, 3)
        cl[1] = 0
        out, jax_out, _ = run_paged(q, kp, vp, bt, cl)
        assert not as_np(jax_out)[1].any()
        assert not as_np(out)[1].any()
        np.testing.assert_allclose(as_np(out), as_np(jax_out),
                                   **TOL["float32"])

    @pytest.mark.parametrize("ctx", [1, 15, 16, 17, 40])
    def test_context_edges_and_skipped_pages(self, ctx):
        """Contexts at and around page boundaries, with a -1 entry in
        the middle of the table (the page is skipped, its tokens
        masked)."""
        q, kp, vp = normal(10 + ctx, (2, 8, 32), (16, 16, 2, 32),
                           (16, 16, 2, 32))
        bt = np.asarray([[4, 9, 2, 7], [11, -1, 3, -1]], np.int32)
        cl = np.full((2,), ctx, np.int32)
        out, jax_out, _ = run_paged(q, kp, vp, bt, cl)
        np.testing.assert_allclose(as_np(out), as_np(jax_out),
                                   **TOL["float32"])

    def test_plain_version_matches_ref_for_live_contexts(self):
        q, kp, vp, bt, cl = paged_inputs(12, 4, 8, 2, 32, 20, 16, 4)
        ref = jax_ref_paged(*(jnp.asarray(x) for x in (q, kp, vp, bt, cl)))
        out = reference_paged_attention(*(torch.from_numpy(x)
                                          for x in (q, kp, vp, bt, cl)))
        np.testing.assert_allclose(as_np(out), as_np(ref), **TOL["float32"])
