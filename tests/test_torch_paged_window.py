"""The paged decode's new coverage, on the CPU: head width 256, every
group size up to 16, and a sliding window.

The CUDA kernel runs only on the card (``chip_smoke.py``'s ``families``
phase holds it against its plain version there); here the plain
version and the plain mirror of the split kernel are held against the
JAX package on inputs made from numpy with a seed:

* without a window, against the Pallas kernel in interpret mode at the
  shapes of gemma2 (dh 256, G 2), recurrentgemma-2b (dh 256, G 10) and
  qwen3-moe-235b-a22b (dh 128, G 16);
* with a window, against the Pallas kernel on a block table whose pages
  behind the window are −1 (the window's first token on a page
  boundary, so the two mask the same tokens), and the split mirror
  against the plain version where the window starts inside a page, a
  split, or before the context;
* at the model layer, against the JAX dense ``decode_attention`` of a
  ``local`` layer on its ring-buffer cache of ``window`` slots, with
  contexts up to three windows long.

Tolerances: 2e-5 for float32 and 2e-2 for bfloat16, as in
``tests/test_kernels.py``; 5e-5 with a softcap (tanh is computed by
different libraries on each side); 1e-4 relative to the largest output
at the model layer, as in ``tests/test_torch_models.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.kernels.paged_attention import paged_attention as jax_paged
from repro.models import attention as jax_attn
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import (
    paged_attention,
    paged_decode_attention,
    reference_paged_attention,
    reference_paged_attention_split,
)
from repro_torch.kernels.paged_attention.paged_attention import (
    GROUP_HEAD_DIMS,
    GROUP_MIN,
    HEAD_DIMS,
    MAX_GROUP,
    route,
)
from repro_torch.models import attention as attn

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SOFTCAP_TOL = dict(rtol=5e-5, atol=5e-5)
T = 16


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors never reach the CUDA kernel."""
    yield
    assert paged_attention.launches == 0
    assert not any(paged_attention.route_launches.values())


def as_np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def case(seed: int, ctxs, H: int, Hkv: int, dh: int, max_pages: int,
         scale: float = 1.0):
    """Random q and pages, distinct page ids per sequence up to each
    context and −1 after it."""
    r = np.random.default_rng(seed)
    b = len(ctxs)
    P = b * max_pages
    q = (scale * r.standard_normal((b, H, dh))).astype(np.float32)
    kp = r.standard_normal((P, T, Hkv, dh)).astype(np.float32)
    vp = r.standard_normal((P, T, Hkv, dh)).astype(np.float32)
    bt = r.permutation(P).astype(np.int32).reshape(b, max_pages)
    for i, c in enumerate(ctxs):
        bt[i, -(-c // T):] = -1
    return q, kp, vp, bt, np.asarray(ctxs, np.int32)


def torch_args(q, kp, vp, bt, cl, dtype="float32"):
    d = getattr(torch, dtype)
    return (torch.from_numpy(q).to(d), torch.from_numpy(kp).to(d),
            torch.from_numpy(vp).to(d), torch.from_numpy(bt),
            torch.from_numpy(cl))


def pallas(q, kp, vp, bt, cl, dtype="float32", softcap=None):
    return jax_paged(*(jnp.asarray(x).astype(dtype) for x in (q, kp, vp)),
                     jnp.asarray(bt), jnp.asarray(cl), softcap=softcap,
                     interpret=True)


def test_kernel_coverage_constants():
    """The shapes the card's kernel takes: every config of the reference
    with attention layers falls inside them; in bf16 every one but the
    G 1 configs (deepseek-7b, whisper-small) takes the group route's
    widths and groups."""
    assert HEAD_DIMS == (16, 32, 64, 128, 256) and MAX_GROUP == 16
    assert GROUP_HEAD_DIMS == (64, 128, 256) and GROUP_MIN == 2
    assert set(GROUP_HEAD_DIMS) <= set(HEAD_DIMS)
    for name in ("gemma2-2b", "gemma2-9b", "recurrentgemma-2b",
                 "qwen3-moe-235b-a22b", "qwen3-moe-30b-a3b", "qwen3-8b",
                 "deepseek-7b", "tinyllama-1.1b", "internvl2-2b",
                 "whisper-small"):
        cfg = jax_get_config(name)
        group = cfg.num_heads // cfg.num_kv_heads
        assert cfg.head_dim in HEAD_DIMS, name
        assert 1 <= group <= MAX_GROUP, name
        want = "split" if name in ("deepseek-7b", "whisper-small") \
            else "group"
        assert route(torch.bfloat16, cfg.head_dim, group) == want, name
        assert route(torch.float32, cfg.head_dim, group) == "split", name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,H,Hkv", [(256, 4, 2), (256, 20, 2),
                                      (128, 32, 2), (64, 3, 1)],
                         ids=["dh256-G2", "dh256-G10", "dh128-G16",
                              "dh64-G3"])
def test_new_shapes_against_pallas(dh, H, Hkv, dtype):
    """Head width 256 and groups 10, 16 and 3 (tiles of 2, 8 and 1 on
    the card), contexts empty to full across the 64-token splits."""
    args = case(dh + H, [0, 1, 63, 64, 65, 200], H, Hkv, dh, 16)
    want = pallas(*args, dtype=dtype)
    for fn in (reference_paged_attention, reference_paged_attention_split):
        out = fn(*torch_args(*args, dtype))
        np.testing.assert_allclose(as_np(out), as_np(want), **TOL[dtype])
    assert not as_np(want)[0].any()


def window_table(bt, cl, window):
    """The block table with every page wholly behind the window set to
    −1 (what the Pallas kernel, which has no window, should see)."""
    bt = bt.copy()
    for i, c in enumerate(cl):
        lo = max(0, int(c) - window)
        bt[i, :lo // T] = -1
    return bt


@pytest.mark.parametrize("window", [16, 32, 64, 128])
def test_window_on_page_boundaries_against_pallas(window):
    """gemma2's shape (dh 256, G 2, softcap 50): where the window's first
    token starts a page, windowing equals −1 pages behind it."""
    ctxs = [window + T * j for j in (0, 1, 3, 7)] + [window - T, 1]
    args = case(window, ctxs, 4, 2, 256, 16, scale=4.0)
    q, kp, vp, bt, cl = args
    want = pallas(q, kp, vp, window_table(bt, cl, window), cl,
                  softcap=50.0)
    for fn in (reference_paged_attention, reference_paged_attention_split):
        out = fn(*torch_args(*args), softcap=50.0, window=window)
        np.testing.assert_allclose(as_np(out), as_np(want), **SOFTCAP_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [1, 5, 63, 64, 65, 100, 1000])
def test_window_split_mirror_matches_plain(window, dtype):
    """The split kernel's arithmetic with a window starting inside a
    page, on a split boundary, inside a split, or before the context;
    whole splits behind the window carry no mass."""
    ctxs = [0, 1, 63, 64, 65, 128, 200, 255]
    args = torch_args(*case(window, ctxs, 20, 2, 256, 16), dtype)
    want = reference_paged_attention(*args, window=window)
    out = reference_paged_attention_split(*args, window=window)
    np.testing.assert_allclose(as_np(out), as_np(want), **TOL[dtype])
    assert not as_np(out)[0].any()
    # a window as long as every context changes nothing
    np.testing.assert_array_equal(
        as_np(reference_paged_attention(*args, window=256)),
        as_np(reference_paged_attention(*args)))


def test_window_of_one_is_the_newest_value():
    """With window 1 only the newest token is live: its V row."""
    q, kp, vp, bt, cl = case(3, [5, 40], 4, 2, 16, 4)
    out = paged_decode_attention(*torch_args(q, kp, vp, bt, cl), window=1)
    for b, c in enumerate(cl):
        page, slot = bt[b, (c - 1) // T], (c - 1) % T
        want = np.repeat(vp[page, slot], 2, axis=0)          # (H, dh)
        np.testing.assert_allclose(as_np(out)[b], want, rtol=1e-6,
                                   atol=1e-6)


# -- the model layer: paged local attention vs the reference's ring buffer -----
@pytest.mark.parametrize("heads", [(4, 2), (10, 1)], ids=["G2", "G10"])
def test_local_decode_matches_ring_buffer(heads):
    """A local layer of gemma2-2b.reduced() (softcap 50, window 32; its
    own G 2, and recurrentgemma-2b's G 10): prefill of 12 tokens and 84
    decode steps (past three windows) through the port's pages against
    the JAX layer's prefill and decode on its ring buffer, float32."""
    over = dict(dtype="float32", num_heads=heads[0], num_kv_heads=heads[1])
    jcfg = jax_get_config("gemma2-2b").reduced(**over)
    cfg = get_config("gemma2-2b").reduced(**over)
    assert cfg.window_size == 32 and cfg.attn_logit_softcap == 50.0
    r = np.random.default_rng(7)
    jp = jax_attn.init_attention(jax.random.PRNGKey(1), jcfg, jnp.float32)
    params = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    B, S, steps, d = 2, 12, 84, cfg.d_model
    xs = r.standard_normal((B, S + steps, d)).astype(np.float32)

    max_seq = S + steps + 1
    jcache = jax_attn.init_kv_cache(B, max_seq, jcfg, jnp.float32, "local")
    assert jcache["k"].shape[1] == 32                     # ring of window
    max_pages = max_seq // T + 1
    shape = (B * max_pages, T, cfg.num_kv_heads, cfg.head_dim)
    kp, vp = torch.zeros(shape), torch.zeros(shape)
    bt = torch.arange(B * max_pages, dtype=torch.int32).reshape(B, max_pages)
    pos = jnp.arange(S)[None]
    # the reference prefills one batch; the ring keeps the last 32
    jy, jcache = jax_attn.prefill_attention(jp, jnp.asarray(xs[:, :S]),
                                            jcfg, "local", pos, jcache)
    y = attn.prefill_attention(params, torch.from_numpy(xs[:, :S]), cfg,
                               "local", kp, vp, bt)
    scale = float(np.abs(np.asarray(jy)).max())
    np.testing.assert_allclose(as_np(y), np.asarray(jy), rtol=0,
                               atol=1e-4 * scale)
    for t in range(steps):
        p = S + t
        x = xs[:, p:p + 1]
        jy, jcache = jax_attn.decode_attention(jp, jnp.asarray(x), jcfg,
                                               "local", jcache, jnp.int32(p))
        y = attn.decode_attention(params, torch.from_numpy(x), cfg,
                                  "local", kp, vp, bt,
                                  torch.full((B,), p, dtype=torch.int32))
        scale = float(np.abs(np.asarray(jy)).max())
        np.testing.assert_allclose(as_np(y), np.asarray(jy), rtol=0,
                                   atol=1e-4 * scale,
                                   err_msg=f"decode at {p}")
