"""The paged decode's group route, on the CPU: its plain mirror (the
kernel's arithmetic: 64-token chunks for the whole GQA group, P entering
P·V as two bfloat16 parts) and its partial form, against the JAX
package, and the route choice.

The CUDA kernel runs only on the card (``chip_smoke.py``'s ``kernels``
and ``families`` phases hold it against its plain version and this
mirror there); here the mirror is held against the Pallas kernel in
interpret mode on inputs made from numpy with a seed, at the groups the
route was built for (G 8 at dh 64 and 128, G 10 at dh 256, G 16 at dh
128 with narrow heads):

* contexts empty, 1, 63, 64, 65 and ragged, a −1 page inside a
  context, a softcap, and a window whose first token starts a page
  inside a 64-token chunk (the Pallas kernel, which has no window, sees
  the pages behind it as −1);
* the partial form over two ranks' blocks of the same table, merged by
  ``merge_partials``, against the whole sequence;
* at recurrentgemma-2b's G 10 and dh 256 with its 2,048 window, the
  split of P keeps the families' limit with room, where one bfloat16
  rounding of P does not.

Tolerances: 2e-5 for float32 and 2e-2 for bfloat16, as in
``tests/test_kernels.py``; 5e-5 with a softcap (tanh is computed by
different libraries on each side); the families' |err| <= 2e-3 +
2e-2·|ref| (``chip_smoke.TOL_FAMILIES``) for the margin.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as jax_paged
from repro_torch.kernels.paged_attention import (
    merge_partials,
    paged_attention,
    reference_paged_attention,
    reference_paged_attention_group,
    route,
)

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SOFTCAP_TOL = dict(rtol=5e-5, atol=5e-5)
TOL_FAMILIES = (2e-3, 2e-2)
T = 16
#: (dh, H, H_kv): G 8 at dh 64 and 128, G 10 at dh 256, G 16 at dh 128
SHAPES = [(64, 16, 2), (128, 8, 1), (256, 10, 1), (128, 16, 1)]
SHAPE_IDS = ["dh64-G8", "dh128-G8", "dh256-G10", "dh128-G16"]
CTXS = [0, 1, 63, 64, 65, 200]


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh,H,Hkv", SHAPES, ids=SHAPE_IDS)
def test_group_mirror_against_pallas(dh, H, Hkv, dtype):
    """Contexts empty to ragged across the 64-token chunks, and a −1
    page inside the longest context (tokens 64-79: the second chunk's
    first page)."""
    q, kp, vp, bt, cl = case(dh + H, CTXS, H, Hkv, dh, 16)
    bt[-1, 4] = -1
    want = pallas(q, kp, vp, bt, cl, dtype=dtype)
    out = reference_paged_attention_group(
        *torch_args(q, kp, vp, bt, cl, dtype))
    np.testing.assert_allclose(as_np(out), as_np(want), **TOL[dtype])
    assert not as_np(out)[0].any()


@pytest.mark.parametrize("dh,H,Hkv", SHAPES, ids=SHAPE_IDS)
def test_group_mirror_softcap_against_pallas(dh, H, Hkv):
    """gemma2's logit softcap of 50 on sharp scores (q scaled by 4)."""
    args = case(dh, CTXS, H, Hkv, dh, 16, scale=4.0)
    want = pallas(*args, softcap=50.0)
    out = reference_paged_attention_group(*torch_args(*args), softcap=50.0)
    np.testing.assert_allclose(as_np(out), as_np(want), **SOFTCAP_TOL)


def window_table(bt, cl, window):
    """The block table with every page wholly behind the window set to
    −1 (what the Pallas kernel, which has no window, should see)."""
    bt = bt.copy()
    for i, c in enumerate(cl):
        lo = max(0, int(c) - window)
        bt[i, :lo // T] = -1
    return bt


@pytest.mark.parametrize("window", [16, 48, 80])
@pytest.mark.parametrize("dh,H,Hkv", SHAPES, ids=SHAPE_IDS)
def test_group_mirror_window_inside_a_chunk_against_pallas(dh, H, Hkv,
                                                           window):
    """The window's first token starts a page inside a 64-token chunk
    (contexts a multiple of 64 plus 0 or 32), so the chunk holds live
    and dead tokens."""
    ctxs = [window + 64 * j + s for j, s in ((0, 0), (1, 32), (3, 0))]
    ctxs = [c - c % T for c in ctxs] + [T, 1]
    q, kp, vp, bt, cl = case(window + dh, ctxs, H, Hkv, dh, 24)
    want = pallas(q, kp, vp, window_table(bt, cl, window), cl)
    out = reference_paged_attention_group(*torch_args(q, kp, vp, bt, cl),
                                          window=window)
    np.testing.assert_allclose(as_np(out), as_np(want), **TOL["float32"])


@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("dh,H,Hkv", [(64, 16, 2), (256, 10, 1)],
                         ids=["dh64-G8", "dh256-G10"])
def test_group_partial_two_ranks_against_pallas(dh, H, Hkv, window):
    """Two ranks' blocks of 8 pages (128 positions) of one table, each
    through the partial form with its key offset, merged as the ranks
    merge them, against the Pallas kernel over the whole sequence (with
    a window, the pages behind it −1 there: contexts a multiple of the
    page)."""
    ctxs = [0, 1, 64, 112, 128, 144, 208, 256]
    q, kp, vp, bt, cl = case(dh + 7, ctxs, H, Hkv, dh, 16)
    args = torch_args(q, kp, vp, bt, cl)
    parts = []
    for r in range(2):
        bt_r = args[3][:, 8 * r:8 * (r + 1)].contiguous()
        koff = torch.full((len(ctxs),), 128 * r, dtype=torch.int32)
        parts.append(reference_paged_attention_group(
            args[0], args[1], args[2], bt_r, args[4], window=window,
            key_offset=koff))
    out = merge_partials(torch.stack([o for o, _ in parts]),
                         torch.stack([s for _, s in parts]))
    table = bt if window is None else window_table(bt, cl, window)
    want = pallas(q, kp, vp, table, cl)
    np.testing.assert_allclose(as_np(out), as_np(want), **TOL["float32"])
    assert not as_np(out)[0].any()
    # the rank whose block holds no live token: o 0, lse −inf
    o1, lse1 = parts[1]
    assert not as_np(o1)[:4].any() and bool(torch.isinf(lse1[:4]).all())


def test_group_split_p_keeps_the_families_margin(monkeypatch):
    """At recurrentgemma-2b's G 10, dh 256 and window 2,048 (sharp
    scores, ragged contexts past the window), the mirror of the route in
    bfloat16 reads under half of the families' limit |err| <= 2e-3 +
    2e-2·|ref| against the plain version, where one bfloat16 rounding of
    P reads more than twice as much."""
    pa = importlib.import_module(
        "repro_torch.kernels.paged_attention.paged_attention")
    assert pa.GROUP_P_PARTS == 2
    ctxs = [2600, 2100, 700, 65]
    q, kp, vp, bt, cl = torch_args(*case(1, ctxs, 10, 1, 256, 163,
                                         scale=4.0), "bfloat16")
    ref = reference_paged_attention(q.float(), kp, vp, bt, cl,
                                    window=2048).float()

    def reading(out):
        return float(((out.float() - ref).abs()
                      / (TOL_FAMILIES[0] + TOL_FAMILIES[1]
                         * ref.abs())).max())

    split = reading(reference_paged_attention_group(q, kp, vp, bt, cl,
                                                    window=2048))
    monkeypatch.setattr(pa, "GROUP_P_PARTS", 1)
    once = reading(reference_paged_attention_group(q, kp, vp, bt, cl,
                                                   window=2048))
    assert split <= 0.5
    assert once > 2 * split


@pytest.mark.parametrize("dtype,dh,G,want", [
    (torch.bfloat16, 128, 8, "group"), (torch.bfloat16, 256, 10, "group"),
    (torch.bfloat16, 128, 16, "group"), (torch.bfloat16, 64, 8, "group"),
    (torch.bfloat16, 256, 2, "group"), (torch.bfloat16, 128, 4, "group"),
    (torch.bfloat16, 128, 1, "split"), (torch.bfloat16, 64, 1, "split"),
    (torch.bfloat16, 32, 8, "split"), (torch.bfloat16, 16, 2, "split"),
    (torch.float32, 128, 8, "split"), (torch.float32, 256, 10, "split"),
    (torch.float32, 128, 16, "split"),
])
def test_paged_route(dtype, dh, G, want):
    """bf16 at widths 64, 128 and 256 and groups from ``GROUP_MIN`` (2)
    up takes the group route; float32 queries (a bf16 product would
    break their 2e-5 tolerance), other widths and G 1 the split route."""
    assert route(dtype, dh, G) == want


def test_forced_route_on_cpu_is_the_plain_version():
    """``kernel=`` only picks a CUDA route: CPU tensors take the plain
    version whatever it says."""
    args = torch_args(*case(5, [0, 70, 130], 16, 2, 64, 16), "bfloat16")
    want = reference_paged_attention(*args)
    for kernel in ("group", "split", None):
        out = paged_attention(*args, kernel=kernel)
        np.testing.assert_array_equal(as_np(out), as_np(want))
