"""The shared pieces of the plain float32 forward, and ``replay``, which
runs an architecture's layers (``reference/<model_type>.py``) over what
the timed path served.

``replay`` computes every layer for every fed position of the given
sequences at once (teacher forcing: a sequence is its prompt followed by
the tokens the program served, less the last), layer by layer, so that
only one layer's weights and the hidden states are held.  The
architecture's module gives ``layer(x, w, m, mm, segments)``, one
decoder layer over the concatenated sequences, and ``logits(rows,
head, m, mm)``, the judged rows' logits over the true vocabulary; the
embedding is a lookup in the head's ``embed`` table.  It is given the
source's weights (``published_layer``/``published_head`` of
``bench/archs/<model_type>.py``), never the program's layout.

``precision="fp8"`` rounds both inputs of every matrix product to
float8 e4m3 (each row of the left input and each column of the right
one scaled to the format's largest value) and accumulates in float32:
the control, one precision below the configuration's bfloat16.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

#: query rows per block of the causal attention
ATTN_BLOCK = 1024
#: rows per block of the MLP
MLP_BLOCK = 4096
FP8_MAX = 448.0


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _q8_tensor(t: torch.Tensor) -> torch.Tensor:
    return _q8(t.reshape(*t.shape[:-2], -1), -1).reshape(t.shape) \
        if t.dim() >= 2 else _q8(t, -1)


def matmul_for(precision: str) -> Callable:
    """``fp32``; ``fp8``: each row of the left input and each column of
    the right one scaled to e4m3's largest value; ``fp8-tensor``: each
    matrix (each head's) scaled as a whole."""
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return lambda a, b: torch.matmul(_q8(a, -1), _q8(b, -2))
    if precision == "fp8-tensor":
        return lambda a, b: torch.matmul(_q8_tensor(a), _q8_tensor(b))
    raise ValueError(f"unknown precision {precision!r}")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float
            ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * weight


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, heads, dh) at positions 0..n-1."""
    n, _, dh = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                         device=x.device) / dh)
    ang = torch.arange(n, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q, k, v, mm) -> torch.Tensor:
    """q (n, H, dh), k/v (n, G, dh) → (n, H, dh), each query over the
    keys at or before it."""
    n, H, dh = q.shape
    G = k.shape[1]
    qg = q.reshape(n, G, H // G, dh).permute(1, 2, 0, 3)      # G, r, n, dh
    kt = k.permute(1, 2, 0)[:, None]                           # G, 1, dh, n
    vg = v.permute(1, 0, 2)[:, None]                           # G, 1, n, dh
    out = torch.empty_like(qg)
    scale = dh ** -0.5
    keys = torch.arange(n, device=q.device)
    for s in range(0, n, ATTN_BLOCK):
        e = min(n, s + ATTN_BLOCK)
        logits = mm(qg[:, :, s:e], kt[..., :e]) * scale
        mask = keys[None, :e] > torch.arange(s, e, device=q.device)[:, None]
        p = torch.softmax(logits.masked_fill(mask, float("-inf")), dim=-1)
        out[:, :, s:e] = mm(p, vg[:, :, :e])
    return out.permute(2, 0, 1, 3).reshape(n, H, dh)


def mlp(y, w, mm) -> torch.Tensor:
    out = torch.empty_like(y)
    for s in range(0, y.shape[0], MLP_BLOCK):
        part = y[s:s + MLP_BLOCK]
        h = F.silu(mm(part, w["w_gate"])) * mm(part, w["w_up"])
        out[s:s + MLP_BLOCK] = mm(h, w["w_down"])
    return out


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           theta: float, mm, segments: list) -> torch.Tensor:
    """q (N, H, dh), k/v (N, G, dh) over the concatenated sequences →
    (N, H·dh): RoPE at each sequence's own positions and causal
    attention within it.  ``segments`` holds each sequence's (slice,
    length)."""
    N, H, dh = q.shape
    o = q.new_empty(N, H * dh)
    for s, n in segments:
        o[s] = causal_attention(rope(q[s], theta), rope(k[s], theta), v[s],
                                mm).reshape(n, H * dh)
    return o


def replay(arch, m: dict, seqs: dict, judged: dict, layer_weights: Callable,
           head: Callable, precision: str = "fp32") -> dict:
    """Logits (n_positions, vocab) at ``judged[rid]`` positions of each
    judged sequence.

    ``arch`` is the architecture's reference module; ``seqs`` maps a
    request id to its fed tokens (a LongTensor); ``layer_weights(i)``
    gives layer i's published weights and ``head()`` the published head
    (``embed``, ``final_norm`` and whatever else ``arch.logits`` reads),
    float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm = matmul_for(precision)
    offset, segments, at = {}, [], 0
    for r, t in seqs.items():
        n = int(t.numel())
        offset[r] = at
        segments.append((slice(at, at + n), n))
        at += n
    table = head()["embed"]
    dev = table.device
    x = table[torch.cat(list(seqs.values())).to(dev)]
    del table
    for i in range(m["layers"]):
        x = arch.layer(x, layer_weights(i), m, mm, segments)
    h = head()
    out = {}
    for r, positions in judged.items():
        rows = x[offset[r] + torch.as_tensor(positions, device=dev)]
        out[r] = arch.logits(rows, h, m, mm)
    return out


def gaps(ref: dict, picked: dict) -> dict:
    """Per judged position, the gap by which the picked token's
    reference logit lies below the reference's best."""
    out = {}
    for r, logits in ref.items():
        tok = torch.as_tensor(picked[r], device=logits.device)
        out[r] = (logits.max(dim=-1).values
                  - logits.gather(1, tok[:, None])[:, 0]).cpu()
    return out
