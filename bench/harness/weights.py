"""The model's weights, drawn on the device from the seed.

Each layer is drawn by a generator of its own, seeded from the run's
seed and the layer's number, in one ``normal_`` call over one flat
buffer in the served dtype (plus one float32 buffer for the norm
scales), then scaled leaf by leaf in place.  So any layer can be drawn
again, alone and bit for bit, by the reference after the program's
state is freed.

Two views of one draw.  ``draw_model`` gives the program's layout:
``ln1``, ``attn`` (wq (d, H, dh), wk/wv (d, H_kv, dh), wo (H, dh, d)),
``ln2``, ``mlp`` (w_gate/w_up (d, f), w_down (f, d)), the table and the
final norm, its norm scales ``s`` applied as (1 + s) with the program's
epsilon.  ``published_layer`` and ``published_embed`` give the weights
of the source's model that the program then computes, in float32: each
norm weight g = 1 + s, and, where the program's epsilon differs from
the source's, the residual stream is c = ``residual_scale`` times the
source's in the program (table, wo and w_down drawn c times larger,
the final norm's g divided by c), since RMSNorm(c·x) with epsilon
c²·eps is RMSNorm(x) with eps; so the published view divides them by
c again.  The tied table meets the final norm's 1/c, so the logits
are the source's.

Scales of the published model: every matrix has standard deviation
1/sqrt(fan-in); the norm weights are 1 + 0.1 times a standard normal;
the tied table has standard deviation 1.28/sqrt(d), so that logits
against it have a standard deviation near 1.28 at any width and the
token a random model picks depends on its context rather than echoing
its input token.
"""
from __future__ import annotations

import math

import torch

EMBED_LOGIT_STD = 1.28
NORM_STD = 0.1
#: leaves that write into the residual stream, drawn c times larger
RESIDUAL_OUT = (("attn", "wo"), ("mlp", "w_down"))


def layer_seed(seed: int, layer: int) -> int:
    """The generator seed of layer ``layer`` (-1: the embedding and the
    final norm)."""
    return (int(seed) * 1_000_003 + layer + 2) % (1 << 63)


def _shapes(m: dict) -> tuple[list, list]:
    """(served-dtype leaves, float32 leaves) of one layer: (path, shape,
    fan-in) in drawing order."""
    d, H, G, dh, f = (m["d_model"], m["heads"], m["kv_heads"],
                      m["head_dim"], m["d_ff"])
    low = [(("attn", "wq"), (d, H, dh), d), (("attn", "wk"), (d, G, dh), d),
           (("attn", "wv"), (d, G, dh), d), (("attn", "wo"), (H, dh, d), H * dh),
           (("mlp", "w_gate"), (d, f), d), (("mlp", "w_up"), (d, f), d),
           (("mlp", "w_down"), (f, d), f)]
    high = [(("ln1",), (d,), None), (("ln2",), (d,), None)]
    return low, high


def _fill(tree: dict, leaves: list, buf: torch.Tensor, c: float) -> None:
    at = 0
    for path, shape, fan_in in leaves:
        n = math.prod(shape)
        t = buf[at:at + n].view(shape)
        if fan_in is None:
            t.mul_(NORM_STD)
        else:
            t.mul_((c if path in RESIDUAL_OUT else 1.0) / math.sqrt(fan_in))
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
        at += n


def served_dtype(m: dict) -> torch.dtype:
    return getattr(torch, m["dtype"])


def draw_layer(m: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer``'s weights as the program's layer dict, the
    matrices in the served dtype."""
    gen = torch.Generator(device=device).manual_seed(layer_seed(seed, layer))
    low, high = _shapes(m)
    buf = torch.empty(sum(math.prod(s) for _, s, _ in low),
                      dtype=served_dtype(m), device=device).normal_(
                          generator=gen)
    fbuf = torch.empty(sum(math.prod(s) for _, s, _ in high),
                       dtype=torch.float32, device=device).normal_(
                           generator=gen)
    tree: dict = {}
    _fill(tree, low, buf, m["residual_scale"])
    _fill(tree, high, fbuf, 1.0)
    return tree


def _embed_draw(m: dict, seed: int, device
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(table (padded vocab, d) in the served dtype, c times the
    published one; the published final norm weight - 1, float32)."""
    gen = torch.Generator(device=device).manual_seed(layer_seed(seed, -1))
    d = m["d_model"]
    table = torch.empty((m["padded_vocab"], d), dtype=served_dtype(m),
                        device=device).normal_(generator=gen)
    table.mul_(m["residual_scale"] * EMBED_LOGIT_STD / math.sqrt(d))
    dev = torch.empty(d, dtype=torch.float32, device=device).normal_(
        generator=gen).mul_(NORM_STD)
    return table, dev


def draw_embed(m: dict, seed: int, device
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """The program's (embedding table, final norm scale s)."""
    table, dev = _embed_draw(m, seed, device)
    return table, (1.0 + dev) / m["residual_scale"] - 1.0


def draw_model(m: dict, seed: int, device) -> dict:
    """Every weight, as the program's ``Transformer`` takes them."""
    table, norm = draw_embed(m, seed, device)
    return {"embed": table, "final_norm": norm,
            "layers": [draw_layer(m, seed, i, device)
                       for i in range(m["layers"])]}


def published_layer(m: dict, seed: int, layer: int, device) -> dict:
    """Layer ``layer`` of the source's model, float32: ``ln1``/``ln2``
    the RMSNorm weights, ``attn`` and ``mlp`` as in the program's
    layout."""
    w = draw_layer(m, seed, layer, device)
    c = m["residual_scale"]
    out = {"ln1": 1.0 + w["ln1"], "ln2": 1.0 + w["ln2"],
           "attn": {k: v.float() for k, v in w["attn"].items()},
           "mlp": {k: v.float() for k, v in w["mlp"].items()}}
    for group, key in RESIDUAL_OUT:
        out[group][key] = out[group][key] / c
    return out


def published_embed(m: dict, seed: int, device
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """The source's (tied table over the true vocabulary, final RMSNorm
    weight), float32."""
    table, dev = _embed_draw(m, seed, device)
    return table[:m["vocab"]].float() / m["residual_scale"], 1.0 + dev
