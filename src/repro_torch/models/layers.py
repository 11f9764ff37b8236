"""Shared neural building blocks as plain functions on tensors.

Counterpart of ``repro/models/layers.py``.  Norm statistics are
computed in fp32 regardless of the parameter dtype; matmuls run in the
configured dtype (bf16 target).  Random init draws from an explicit
``torch.Generator`` (on the device it fills).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


# -- init -----------------------------------------------------------------------
def dense_init(gen: torch.Generator, shape, dtype, device,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (±2σ), drawn in f32 then cast."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                generator=gen)
    return w.to(dtype)


def embed_init(gen: torch.Generator, shape, dtype, device) -> torch.Tensor:
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(generator=gen)
    return w.to(dtype)


# -- norms -----------------------------------------------------------------------
def rmsnorm(scale: torch.Tensor, x: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: ``x / rms(x) · (1 + scale)``, stats in f32."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)


# -- positional -------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, dh); positions: broadcastable to (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                   # (dh/2,)
    angles = positions[..., :, None].float() * freqs          # (...,S,dh/2)
    sin = torch.sin(angles)[..., :, None, :]                  # (...,S,1,dh/2)
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Whisper-style sinusoidal embeddings (f32) of ``positions`` (any
    shape) → (..., d_model): sin on the even columns, cos on the odd."""
    dim = torch.arange(0, d_model, 2, dtype=torch.float32,
                       device=positions.device)
    angle = positions[..., None].float() / torch.pow(10000.0, dim / d_model)
    emb = torch.empty(positions.shape + (d_model,), dtype=torch.float32,
                      device=positions.device)
    emb[..., 0::2] = torch.sin(angle)
    emb[..., 1::2] = torch.cos(angle)
    return emb


# -- gates -------------------------------------------------------------------------
def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^x)`` as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)``, at every x (``F.softplus`` returns x itself
    above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# -- soft capping (gemma2) ----------------------------------------------------------
def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x.float() / cap)


# -- MLPs -----------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype, device) -> dict:
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
            "w_down": dense_init(gen, (d_ff, d_model), dtype, device),
        }
    return {
        "w_up": dense_init(gen, (d_model, d_ff), dtype, device),
        "w_down": dense_init(gen, (d_ff, d_model), dtype, device),
    }


def mlp(params, x: torch.Tensor, kind: str,
        partial: bool = False) -> torch.Tensor:
    """The MLP; with ``partial`` the down-projection of a tp rank's block
    of the hidden units, in float32 (see :func:`partial_product`)."""
    if kind == "swiglu":
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        h = F.silu(g.float()).to(x.dtype) * u
    elif kind == "geglu":
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * u
    else:  # gelu
        u = x @ params["w_up"]
        h = F.gelu(u.float(), approximate="tanh").to(x.dtype)
    if partial:
        return partial_product(h, params["w_down"])
    return h @ params["w_down"]


def partial_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32: one tp rank's partial of a product whose
    contraction dim is split over tp, kept unrounded until the sum over
    the ranks rounds it once (a half-precision partial rounded on each
    rank would add one rounding a rank to the single-device product)."""
    return a.float() @ b.float()


# -- embeddings ----------------------------------------------------------------------
def embed(table: torch.Tensor, tokens: torch.Tensor,
          scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    out = table[tokens]
    if scale_by_sqrt_dim:
        # a host scalar in the table's dtype: no copy to the device, so
        # the step stays capturable in a CUDA graph
        out = out * torch.tensor(math.sqrt(out.shape[-1]), dtype=out.dtype)
    return out


def unembed(table: torch.Tensor, x: torch.Tensor, vocab_size: int,
            cap: float | None = None) -> torch.Tensor:
    """Logits against the (tied) embedding table; padded ids masked."""
    logits = softcap(x @ table.t(), cap)
    padded = logits.shape[-1]
    if padded > vocab_size:
        logits[..., vocab_size:] = -1e9
    return logits
