"""Weights drawn on the device from the seed: what every architecture's
``draw_model`` and ``published_*`` (``bench/archs/<model_type>.py``)
share.  The architecture's module says which leaves a layer has, in
which order they are drawn, and how the program's layout maps to the
source's model.

Each layer is drawn by a generator of its own, seeded from the run's
seed and the layer's number, in one ``normal_`` call over one flat
buffer in the served dtype (plus one float32 buffer for the norm
scales), then scaled leaf by leaf in place.  So any layer can be drawn
again, alone and bit for bit, by the reference after the program's
state is freed.  The table and the final norm are drawn the same way
under the layer number -1; an architecture that draws more for its
head (an untied output matrix) takes another number below that.

Scales of the published model: every matrix has standard deviation
1/sqrt(fan-in); the norm weights are 1 + 0.1 times a standard normal;
the table has standard deviation 1.28/sqrt(d), so that logits against
it have a standard deviation near 1.28 at any width and the token a
random model picks depends on its context rather than echoing its input
token.  Leaves that write into the residual stream may be drawn
``residual_scale`` times larger, for an architecture whose program
layout scales the stream (``archs/llama.py``).
"""
from __future__ import annotations

import math

import torch

EMBED_LOGIT_STD = 1.28
NORM_STD = 0.1


def layer_seed(seed: int, layer: int) -> int:
    """The generator seed of layer ``layer`` (-1: the embedding and the
    final norm)."""
    return (int(seed) * 1_000_003 + layer + 2) % (1 << 63)


def _fill(tree: dict, leaves: list, buf: torch.Tensor, c: float,
          residual_out) -> None:
    at = 0
    for path, shape, fan_in in leaves:
        n = math.prod(shape)
        t = buf[at:at + n].view(shape)
        if fan_in is None:
            t.mul_(NORM_STD)
        else:
            t.mul_((c if path in residual_out else 1.0) / math.sqrt(fan_in))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
        at += n


def served_dtype(m: dict) -> torch.dtype:
    return getattr(torch, m["dtype"])


def draw_layer(m: dict, seed: int, layer: int, shapes: tuple, device,
               residual_out) -> dict:
    """Layer ``layer``'s leaves as a tree keyed by their paths.
    ``shapes`` is (served-dtype leaves, float32 leaves), each a list of
    (path, shape, fan-in) in drawing order, the fan-in None for a norm
    scale s (drawn as 0.1 times a standard normal); the leaves named in
    ``residual_out`` are drawn ``m["residual_scale"]`` times larger."""
    gen = torch.Generator(device=device).manual_seed(layer_seed(seed, layer))
    low, high = shapes
    buf = torch.empty(sum(math.prod(s) for _, s, _ in low),
                      dtype=served_dtype(m), device=device).normal_(
                          generator=gen)
    fbuf = torch.empty(sum(math.prod(s) for _, s, _ in high),
                       dtype=torch.float32, device=device).normal_(
                           generator=gen)
    tree: dict = {}
    _fill(tree, low, buf, m["residual_scale"], residual_out)
    _fill(tree, high, fbuf, 1.0, residual_out)
    return tree


def draw_table(m: dict, seed: int, device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(table (padded vocab, d) in the served dtype, ``residual_scale``
    times the published one; the published final norm weight - 1,
    float32)."""
    gen = torch.Generator(device=device).manual_seed(layer_seed(seed, -1))
    d = m["d_model"]
    table = torch.empty((m["padded_vocab"], d), dtype=served_dtype(m),
                        device=device).normal_(generator=gen)
    table.mul_(m["residual_scale"] * EMBED_LOGIT_STD / math.sqrt(d))
    dev = torch.empty(d, dtype=torch.float32, device=device).normal_(
        generator=gen).mul_(NORM_STD)
    return table, dev
