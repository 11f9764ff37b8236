"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

Counterpart of ``repro/models/rglru.py``.  The temporal-mixing block:
LN → two linear branches to ``d_rnn``; branch A → causal depthwise conv
(width 4) → RG-LRU; branch B → GeLU (tanh form); merge (A ⊙ B) →
down-proj → residual.

RG-LRU recurrence (per channel, f32):

  r_t = σ(W_r x_t + b_r)                 recurrence gate
  i_t = σ(W_i x_t + b_i)                 input gate
  log a_t = −c · r_t · softplus(Λ)       (a = σ(Λ)^(c·r), c = 8)
  h_t = a_t · h_{t−1} + √(1 − a_t²) · (i_t ⊙ x_t)

The reference runs the affine recurrence through
``lax.associative_scan``.  Here :func:`linear_scan` is a doubling scan:
⌈log₂ S⌉ passes of whole-tensor ops, each combining every step with
the one ``2^k`` before it, so a 2,600-token prefill is 12 passes and
not 2,600 steps.  The two scans combine in different trees, so they
agree to rounding, not bit for bit.  Decode carries (h, conv buffer):
O(1) state per sequence.

Under a mesh-ful runtime whose tp splits the channels (the sharding
rules put ``w_a``/``w_b``, the conv, Λ, ``b_r``/``b_i`` and the state
over tp by blocks of dr), a rank runs its block of the channels: both
branches column-parallel, the conv and the scan on its block (the
recurrence is per channel, so it needs no collective), ``w_down``
row-parallel with its float32 partials summed over tp.  ``w_r`` and
``w_i`` are split on their output channels only and contract over all
of them, so the gates read the conv output gathered over tp
(:func:`gather_dr`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, partial_product, \
    rmsnorm, softplus
from repro_torch.models.runtime import LOCAL

_C_EXP = 8.0


def init_rglru_block(gen: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    dr = cfg.rnn_width or d
    f32 = torch.float32
    # Λ so that a^c spreads over (0.9, 0.999), as Griffin initialises it
    u = torch.empty(dr, dtype=f32, device=device).uniform_(
        0.9, 0.999, generator=gen)
    root = u ** (1.0 / _C_EXP)
    return {
        "ln": torch.zeros(d, device=device),
        "w_a": dense_init(gen, (d, dr), dtype, device),
        "w_b": dense_init(gen, (d, dr), dtype, device),
        "conv_w": dense_init(gen, (cfg.conv_width, dr), f32, device,
                             scale=0.5),
        "conv_b": torch.zeros(dr, device=device),
        "w_r": dense_init(gen, (dr, dr), f32, device, scale=0.01),
        "b_r": torch.zeros(dr, device=device),
        "w_i": dense_init(gen, (dr, dr), f32, device, scale=0.01),
        "b_i": torch.zeros(dr, device=device),
        "lambda": torch.log(root / (1 - root)),
        "w_down": dense_init(gen, (dr, d), dtype, device),
    }


def rglru_state(batch: int, cfg, device, dtype=torch.float32,
                width: int | None = None) -> dict[str, torch.Tensor]:
    """Zero state of ``width`` channels (default all dr; a tp rank's
    block under a layout that splits them)."""
    dr = width or cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, dr), dtype=dtype, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, dr), dtype=dtype,
                            device=device),
    }


def split(params, rt) -> bool:
    """Whether ``rt`` splits the channels over tp (dr is ``w_r``'s rows,
    which no rule splits), so that the params are a rank's block."""
    return rt.tp_splits(params["w_r"].shape[0])


def gather_dr(rt, x: torch.Tensor) -> torch.Tensor:
    """The tp ranks' channel blocks of x (..., dr/tp) as (..., dr)."""
    return rt.gather_tp(x, -1)


def _gates(params, x: torch.Tensor, rt=LOCAL):
    """x (..., dr) f32 → (a, β·i·x) of the linear recurrence
    h_t = a·h + b; x a tp rank's channel block when the params are
    (the gate products then read all channels)."""
    xw = gather_dr(rt, x) if split(params, rt) else x
    r = torch.sigmoid(xw @ params["w_r"] + params["b_r"])
    i = torch.sigmoid(xw @ params["w_i"] + params["b_i"])
    log_a = -_C_EXP * r * softplus(params["lambda"])
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12))
    return a, beta * (i * x)


def _causal_conv(params, x: torch.Tensor,
                 carry: torch.Tensor | None) -> torch.Tensor:
    """Depthwise causal conv of width W.  x (B,S,dr); carry (B,W-1,dr)
    of trailing context (decode) or None (a fresh sequence: zeros)."""
    w = params["conv_w"]
    W = w.shape[0]
    if carry is None:
        carry = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    xp = torch.cat([carry, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i].to(x.dtype) for i in range(W))
    return out + params["conv_b"].to(x.dtype)


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Every h_t = a_t·h_{t−1} + b_t along axis 1, h_{−1} = 0, by
    doubling: after the pass at offset d each (a_t, b_t) is the
    composition of steps t−2d+1..t, ``(a_t a_{t−d}, a_t b_{t−d} + b_t)``,
    so ⌈log₂ S⌉ passes leave b_t = h_t."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < S:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_sequence(params, x: torch.Tensor, h0: torch.Tensor,
                   rt=LOCAL) -> tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,dr) f32 → (h (B,S,dr), h_last), starting from h0."""
    a, b = _gates(params, x, rt)
    # fold h0 into the first step: b_0 ← a_0 h0 + b_0
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    return h, h[:, -1, :]


def _branches(params, x: torch.Tensor, rt):
    """The normed input's two branches (B,S,dr) in f32: under a channel
    split, this rank's columns (the input replicated into tp work)."""
    y = rmsnorm(params["ln"], x)
    if split(params, rt):
        y = rt.replicate_tp(y)
    return (y @ params["w_a"]).float(), (y @ params["w_b"]).float()


def _down(params, merged: torch.Tensor, rt) -> torch.Tensor:
    """merged · w_down; under a channel split the ranks' float32
    partials summed over tp and rounded once."""
    if split(params, rt):
        return rt.reduce_tp(partial_product(merged, params["w_down"])).to(
            merged.dtype)
    return merged @ params["w_down"]


def rglru_block(params, x: torch.Tensor, state: dict, rt=LOCAL
                ) -> tuple[torch.Tensor, dict]:
    """The residual temporal-mixing block over a sequence.  The conv
    runs from zeros (a fresh sequence, as in the reference); the new
    conv state is the last W−1 pre-conv rows, with the old state in
    front when the prompt is shorter than that."""
    xa, xb = _branches(params, x, rt)
    conv_out = _causal_conv(params, xa, None)
    h, h_last = rglru_sequence(params, conv_out, state["h"], rt)
    merged = (h * F.gelu(xb, approximate="tanh")).to(x.dtype)
    out = _down(params, merged, rt)
    keep = params["conv_w"].shape[0] - 1
    if xa.shape[1] < keep:
        xa = torch.cat([state["conv"], xa], dim=1)
    return x + out, {"h": h_last, "conv": xa[:, -keep:, :]}


def rglru_decode_step(params, x: torch.Tensor, state: dict, rt=LOCAL
                      ) -> tuple[torch.Tensor, dict]:
    """One token: x (B,1,d); carries (h, conv buffer)."""
    xa, xb = _branches(params, x, rt)
    conv_out = _causal_conv(params, xa, state["conv"])       # (B,1,dr)
    a, b = _gates(params, conv_out[:, 0, :], rt)
    h_new = a * state["h"] + b
    merged = (h_new[:, None, :]
              * F.gelu(xb, approximate="tanh")).to(x.dtype)
    out = _down(params, merged, rt)
    conv = torch.cat([state["conv"], xa], dim=1)[:, 1:, :]
    return x + out, {"h": h_new, "conv": conv}
