"""FLOP and byte counts behind ``mfu`` and the kernels' roofline shares,
and the H100's published peaks.

Sources.  The whole-step counts follow the formulas of the program's
``launch/roofline.py`` (``MODEL_FLOPS``: 2·N·D for a prefill of D
tokens plus causal attention, 2·N·B plus the reads of the KV history
for a decode step of B sequences), frozen here, with two changes: attention is counted in every attention
layer (that module's formula scales it by attention layers over all
layers, so it counts one layer's worth), and the logits against the
vocabulary are counted where they are computed (the last position of a
prefill, every decoded token).  The kernels' bounds follow
``chip_smoke.py``'s arithmetic: the least time is the larger of the
operations over the peak rate and the bytes over the HBM bandwidth,
each input byte read once and each output byte written once.

Peaks (NVIDIA's H100 SXM data sheet, dense, no sparsity, at 700 W):
989e12 bf16 FLOP/s and 3.35e12 bytes/s of HBM.
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def active_params(m: dict) -> float:
    """N: non-embedding weights a token meets, over all layers
    (``layer_params`` is the architecture's count for one layer:
    ``bench/archs/<model_type>.py``'s ``dims``)."""
    return m["layers"] * m["layer_params"]


def attention_flops(m: dict, queries_keys: float) -> float:
    """Both products of attention, every layer, for ``queries_keys``
    (query, key) pairs."""
    return 4.0 * m["heads"] * m["head_dim"] * queries_keys * m["layers"]


def prefill_flops(m: dict, S: int) -> float:
    """One prompt of S tokens: 2·N·S, causal attention, and the
    last position's logits."""
    return (2.0 * active_params(m) * S
            + attention_flops(m, S * (S + 1) / 2.0)
            + 2.0 * m["d_model"] * m["vocab"])


def decode_flops(m: dict, contexts: list) -> float:
    """One decode step whose sequences attend over ``contexts`` keys
    each (the new token included)."""
    B = len(contexts)
    return (2.0 * active_params(m) * B
            + attention_flops(m, float(sum(contexts)))
            + 2.0 * m["d_model"] * m["vocab"] * B)


def flash_bound_s(m: dict, S: int) -> float:
    """Least time of one causal flash-prefill launch (one layer) over a
    prompt of S tokens: q, k, v read once and o written once, both
    products over the S(S+1)/2 visible pairs."""
    H, G, dh = m["heads"], m["kv_heads"], m["head_dim"]
    flops = 4.0 * H * dh * S * (S + 1) / 2.0
    nbytes = BF16 * S * dh * (2 * H + 2 * G)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def paged_bound_s(m: dict, contexts: list, page_tokens: int = 16) -> float:
    """Least time of one paged-decode call (one layer, both passes) over
    sequences with ``contexts`` keys: each live K and V byte read once,
    q read and o written once, each used block-table entry read once."""
    H, G, dh = m["heads"], m["kv_heads"], m["head_dim"]
    keys = float(sum(contexts))
    B = len(contexts)
    pages = sum(-(-c // page_tokens) for c in contexts)
    flops = 4.0 * H * dh * keys
    nbytes = BF16 * (2 * G * dh * keys + 2 * B * H * dh) + 4 * pages
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
