"""The FLOP and byte counts behind mfu and the kernels' roofline shares,
against counts made by hand at small shapes.  The weights a token meets
in a layer are the architecture's ``layer_params``, read through its
``dims``."""
import pytest

from bench_tiny_cells import HAND
from harness import arch
from reference import flops

LLAMA = arch.load(HAND).harness
DENSE = LLAMA.dims(HAND)
MHA = LLAMA.dims(dict(HAND, num_key_value_heads=4, intermediate_size=3))


def test_active_params_by_hand():
    # attention: wq 8x8, wk 8x4, wv 8x4, wo 8x8 = 192; mlp 3 x 8 x 16 = 384
    assert flops.active_params(DENSE) == 2 * (192 + 384)
    # full heads: wq, wk, wv, wo 8x8 = 256; mlp 3 x 8 x 3 = 72
    assert flops.active_params(MHA) == 2 * (256 + 72)


def test_prefill_and_decode_flops_by_hand():
    S = 3
    n = flops.active_params(DENSE)
    # pairs visible under the causal mask: 1 + 2 + 3 = 6; 4 flops per
    # pair per head-dim entry per head, per layer
    attn = 4 * 4 * 2 * 6 * 2
    assert flops.prefill_flops(DENSE, S) == 2 * n * S + attn + 2 * 8 * 10
    ctx = [5, 1]
    attn = 4 * 4 * 2 * 6 * 2
    assert flops.decode_flops(DENSE, ctx) == 2 * n * 2 + attn + 2 * 8 * 10 * 2


def test_flash_bound_by_hand():
    m = dict(DENSE, heads=32, kv_heads=8, head_dim=128)
    S = 4096
    f = 4.0 * 32 * 128 * S * (S + 1) / 2
    b = 2 * S * 128 * (2 * 32 + 2 * 8)
    assert flops.flash_bound_s(m, S) == pytest.approx(
        max(f / 989e12, b / 3.35e12))
    assert f / 989e12 > b / 3.35e12            # a long prompt is compute-bound


def test_paged_bound_by_hand():
    m = dict(DENSE, heads=32, kv_heads=8, head_dim=128)
    ctx = [16, 17]
    keys = 33
    b = 2 * (2 * 8 * 128 * keys + 2 * 2 * 32 * 128) + 4 * (1 + 2)
    assert flops.paged_bound_s(m, ctx) == pytest.approx(b / 3.35e12)
