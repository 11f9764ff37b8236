"""Gradient compression for cross-pod data parallelism, with error
feedback (compression error accumulates locally and is re-applied next
step):

  - ``topk``: keep the k largest-magnitude entries per tensor
    (sparsification); the all-reduce then moves k values + indices.
  - ``int8``: per-tensor symmetric quantisation to int8 with an fp32
    scale (8× byte reduction).

Counterpart of ``repro/training/grad_compress.py``, matching its int8
path as the jitted train step computes it: XLA folds ``max|g| / 127``
into a product with the float32 reciprocal and contracts the error
``corrected − q·scale`` into a fused multiply-add (fault C1's pattern).
The reference's top-k path cannot run under ``jax.jit`` at all (fault
C12: ``_topk_decompress`` calls ``int()`` on a traced value), so its
eager form is the one held.  "Per tensor" is
per reference leaf: the reference stacks each pattern position's
parameters over the periods of layers, and its int8 scale ``max|g|/127``
and its ``k = ratio·size`` are taken over that stacked leaf.  So the
compressor works on ``tree.stacked`` of each leaf (the port's per-layer
gradients stacked) and splits the result back; the error state is kept
stacked, one f32 tensor per reference leaf.  Per layer it would keep
other entries at other scales, and compressed training would drift
from the reference's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.training.optimizer import fma
from repro_torch.tree import leaf_shape, leaves_with_paths, map_leaves, \
    stacked, tensors, unstacked


@dataclasses.dataclass(frozen=True)
class CompressorConfig:
    kind: str = "none"            # none | topk | int8
    topk_ratio: float = 0.01      # fraction of entries kept


def _topk_compress(g: torch.Tensor, ratio: float
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    flat = g.reshape(-1).float()
    k = max(1, int(flat.shape[0] * ratio))
    idx = torch.topk(flat.abs(), k, sorted=False).indices
    return flat[idx], idx


def _topk_decompress(kept: torch.Tensor, idx: torch.Tensor, shape
                     ) -> torch.Tensor:
    flat = torch.zeros(math.prod(shape), dtype=torch.float32,
                       device=kept.device)
    flat[idx] = kept
    return flat.reshape(shape)


def _int8_compress(g: torch.Tensor, reduce_max=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    amax = gf.abs().max()
    if reduce_max is not None:          # g is one rank's block of the leaf
        amax = reduce_max(amax)
    # XLA folds the reference's ``/ 127.0`` into a product with the
    # float32 reciprocal
    scale = amax.clamp_min(1e-12) * (1.0 / 127.0)
    q = torch.round(gf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def _int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(params: Any) -> Any:
    """One f32 zero tensor per reference leaf, in its stacked shape."""
    return map_leaves(lambda p: torch.zeros(
        leaf_shape(p), dtype=torch.float32, device=tensors(p)[0].device),
        params)


def compress_grads(grads: Any, error: Any, cfg: CompressorConfig,
                   reduce_max=None) -> tuple[Any, Any]:
    """Returns (decompressed grads after the lossy round-trip, new error
    state).  The round-trip models exactly what the cross-pod wire
    carries, leaf by stacked leaf.  Where each rank holds a block of
    every leaf, ``reduce_max`` takes a block's max|g| to the whole
    leaf's (int8 only: top-k's k of a whole leaf has no sharded form —
    fault C12 — and is refused)."""
    if cfg.kind == "none":
        return grads, error
    if cfg.kind not in ("topk", "int8"):
        raise ValueError(cfg.kind)
    if cfg.kind == "topk" and reduce_max is not None:
        raise NotImplementedError(
            "top-k compression of sharded gradients: the reference's "
            "jitted step cannot run top-k at all (fault C12)")

    def one(g, e):
        s = stacked(g)
        corrected = s.float() + e
        if cfg.kind == "topk":
            kept, idx = _topk_compress(corrected, cfg.topk_ratio)
            approx = _topk_decompress(kept, idx, s.shape)
            new_e = corrected - approx
        else:
            q, scale = _int8_compress(corrected, reduce_max)
            approx = _int8_decompress(q, scale)
            # corrected − q·scale, contracted as XLA contracts it
            new_e = fma(-q.float(), scale, corrected)
        return unstacked(approx.to(s.dtype), g), new_e

    out = map_leaves(one, grads, error)
    return (map_leaves(lambda pair: pair[0], out),
            map_leaves(lambda pair: pair[1], out))


def compressed_bytes(params: Any, cfg: CompressorConfig) -> float:
    """Wire bytes per step for the cross-pod reduction (for §Roofline):
    the int8 form's one f32 scale per reference leaf."""
    leaves = [leaf for _, leaf in leaves_with_paths(params)]
    n = sum(math.prod(leaf_shape(leaf)) for leaf in leaves)
    if cfg.kind == "none":
        return n * 4.0
    if cfg.kind == "topk":
        k = n * cfg.topk_ratio
        return k * (4.0 + 4.0)        # value + index
    if cfg.kind == "int8":
        return n * 1.0 + 4.0 * len(leaves)
    raise ValueError(cfg.kind)
