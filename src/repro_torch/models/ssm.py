"""xLSTM cells (arXiv:2405.04517): mLSTM (matrix memory) and sLSTM
(scalar memory) — the ``[ssm]`` family.

Counterpart of ``repro/models/ssm.py``.  Both are exact recurrences
with exponential gating and the paper's max-stabiliser m_t.  The
reference scans them over time with ``lax.scan``; here a sequence is a
Python loop over the same step, after the time-independent products
(mLSTM's q/k/v and gate pre-activations, sLSTM's input products) are
taken for the whole sequence at once.  The chunked-parallel mLSTM form
is a follow-up in the reference too.  Decode is one step with O(1)
carried state.

The reference's dtypes are kept: q/k/v are products in the model dtype
cast to f32, sLSTM's input products cast the weights to f32 first, the
recurrences run in f32, ``mlstm_sequence`` returns the input dtype, and
m starts at −1e30.

State shapes (per layer):
  mLSTM: C (B,H,dh,dh), n (B,H,dh), m (B,H)
  sLSTM: c,n,h (B,H,dh), m (B,H,dh)

Under a mesh-ful runtime the sharding rules split the cells' input
products on their contracted dim (mLSTM's ``inner``: ``wq``/``wk``/
``wv``, ``w_i``/``w_f``; sLSTM's ``d``: ``w_z``/``w_o``) and keep the
recurrent matrices and the states whole.  So each rank's products are
tp partials, summed in float32 over tp and rounded once (as
``layers.partial_product``), and every tp rank runs the same recurrence
on the whole q, k, v and gates: the steps, and the stabilised updates
of C1's kind in them (``f·C + i·v kᵀ``, ``f·n + i·k``, ``f·c + i·z``),
are the one-device code on the same values.  mLSTM's up-projections
and ``w_down`` are column- and row-parallel over ``inner``; sLSTM's
``w_ff_up`` is gathered whole in the compute view (its two halves would
straddle the ranks' blocks) and ``w_ff_down`` is row-parallel where
its rows split.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, partial_product, \
    rmsnorm, softplus
from repro_torch.models.runtime import LOCAL

#: the stabiliser's start: no step has been seen
M_INIT = -1e30


# =========================== mLSTM ============================================
def init_mlstm_block(gen: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    inner = int(cfg.mlstm_proj_factor * d)
    dh = inner // H
    f32 = torch.float32
    return {
        "ln": torch.zeros(d, device=device),
        "w_up": dense_init(gen, (d, inner), dtype, device),
        "w_gate_branch": dense_init(gen, (d, inner), dtype, device),
        "wq": dense_init(gen, (inner, H, dh), dtype, device),
        "wk": dense_init(gen, (inner, H, dh), dtype, device),
        "wv": dense_init(gen, (inner, H, dh), dtype, device),
        # scalar gate pre-activations per head
        "w_i": dense_init(gen, (inner, H), f32, device, scale=0.01),
        "w_f": dense_init(gen, (inner, H), f32, device, scale=0.01),
        "b_i": torch.zeros(H, device=device),
        # forget bias positive: long memory at init
        "b_f": torch.full((H,), 3.0, device=device),
        "w_down": dense_init(gen, (inner, d), dtype, device),
        "out_ln": torch.zeros(inner, device=device),
    }


def mlstm_state(batch: int, cfg, device,
                dtype=torch.float32) -> dict[str, torch.Tensor]:
    H = cfg.num_heads
    dh = int(cfg.mlstm_proj_factor * cfg.d_model) // H
    return {
        "C": torch.zeros((batch, H, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, H, dh), dtype=dtype, device=device),
        "m": torch.full((batch, H), M_INIT, dtype=dtype, device=device),
    }


def _mlstm_step(state: dict, q, k, v, i_pre, log_f) -> tuple[dict,
                                                              torch.Tensor]:
    """One stabilised mLSTM step (all f32).  q,k,v (B,H,dh); i_pre and
    the log forget gate ``log_f = −softplus(−f̃)`` (B,H)."""
    C, n, m = state["C"], state["n"], state["m"]
    k = k / math.sqrt(q.shape[-1])
    m_new = torch.maximum(log_f + m, i_pre)
    f_eff = torch.exp(log_f + m - m_new)                   # (B,H)
    i_eff = torch.exp(i_pre - m_new)
    C_new = (f_eff[..., None, None] * C
             + i_eff[..., None, None] * v[..., :, None] * k[..., None, :])
    n_new = f_eff[..., None] * n + i_eff[..., None] * k
    num = (C_new @ q[..., None])[..., 0]
    den = torch.abs((n_new * q).sum(dim=-1))
    den = torch.maximum(den, torch.exp(-m_new))[..., None]
    return {"C": C_new, "n": n_new, "m": m_new}, num / den


def mlstm_sequence(params, x_inner: torch.Tensor, state: dict, rt=LOCAL
                   ) -> tuple[torch.Tensor, dict]:
    """x_inner (B,S,inner) → (h (B,S,inner) in x_inner's dtype, final
    state).  Exact: one step per token.  x_inner may be a tp rank's
    block of ``inner`` (the params then are too): the q/k/v and gate
    products are then its float32 partials, summed over tp."""
    B, S, m = x_inner.shape
    _, H, dh = params["wq"].shape
    xf = x_inner.float()
    if rt.tp_splits(H * dh):
        prods = [partial_product(x_inner, params[w].reshape(m, H * dh))
                 for w in ("wq", "wk", "wv")]
        prods += [xf @ params["w_i"], xf @ params["w_f"]]
        # one sum over tp for all five
        whole = rt.reduce_tp(torch.cat(prods, dim=-1)).split(
            [H * dh] * 3 + [H] * 2, dim=-1)
        q, k, v = (t.to(x_inner.dtype).view(B, S, H, dh).float()
                   for t in whole[:3])
        i_raw, f_raw = whole[3:]
    else:
        q, k, v = ((x_inner @ params[w].reshape(m, H * dh)).view(
            B, S, H, dh).float() for w in ("wq", "wk", "wv"))
        i_raw, f_raw = xf @ params["w_i"], xf @ params["w_f"]
    i_pre = i_raw + params["b_i"]                           # (B,S,H)
    log_f = -softplus(-(f_raw + params["b_f"]))
    hs = []
    for t in range(S):
        state, h = _mlstm_step(state, q[:, t], k[:, t], v[:, t],
                               i_pre[:, t], log_f[:, t])
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, H * dh)
    return h.to(x_inner.dtype), state


def _block_of(rt, x: torch.Tensor, m: int) -> torch.Tensor:
    """This tp rank's block of m columns of the replicated x, entering
    work split over tp."""
    i = rt.tp_index
    return rt.replicate_tp(x)[..., i * m:(i + 1) * m]


def mlstm_block(params, x: torch.Tensor, state: dict, rt=LOCAL
                ) -> tuple[torch.Tensor, dict]:
    """LN → up-proj (two branches) → cell → SiLU-gated merge →
    down-proj → residual."""
    y = rmsnorm(params["ln"], x)
    m = params["w_up"].shape[1]
    split = rt.tp_splits(params["out_ln"].shape[0])   # inner, whole
    if split:
        y = rt.replicate_tp(y)
    up = y @ params["w_up"]
    gate = y @ params["w_gate_branch"]
    h, state = mlstm_sequence(params, up, state, rt)
    h = rmsnorm(params["out_ln"], h)
    if split:
        h = _block_of(rt, h, m)
    h = h * F.silu(gate.float()).to(h.dtype)
    if split:
        return x + rt.reduce_tp(partial_product(h, params["w_down"])).to(
            x.dtype), state
    return x + h @ params["w_down"], state


# =========================== sLSTM ============================================
def init_slstm_block(gen: torch.Generator, cfg, dtype, device) -> dict:
    d = cfg.d_model
    H = cfg.num_heads
    dh = d // H
    f_inner = int(cfg.slstm_proj_factor * d)
    f32 = torch.float32
    return {
        "ln": torch.zeros(d, device=device),
        # input projections per gate
        "w_z": dense_init(gen, (d, H, dh), dtype, device),
        "w_i": dense_init(gen, (d, H, dh), f32, device, scale=0.01),
        "w_f": dense_init(gen, (d, H, dh), f32, device, scale=0.01),
        "w_o": dense_init(gen, (d, H, dh), dtype, device),
        # block-diagonal (per-head) recurrent matrices
        "r_z": dense_init(gen, (H, dh, dh), f32, device),
        "r_i": dense_init(gen, (H, dh, dh), f32, device, scale=0.01),
        "r_f": dense_init(gen, (H, dh, dh), f32, device, scale=0.01),
        "r_o": dense_init(gen, (H, dh, dh), f32, device),
        "b_z": torch.zeros((H, dh), device=device),
        "b_i": torch.zeros((H, dh), device=device),
        "b_f": torch.full((H, dh), 3.0, device=device),
        "b_o": torch.zeros((H, dh), device=device),
        "out_ln": torch.zeros(d, device=device),
        # post-cell gated FFN (proj factor 4/3)
        "w_ff_up": dense_init(gen, (d, 2 * f_inner), dtype, device),
        "w_ff_down": dense_init(gen, (f_inner, d), dtype, device),
    }


def slstm_state(batch: int, cfg, device,
                dtype=torch.float32) -> dict[str, torch.Tensor]:
    H = cfg.num_heads
    dh = cfg.d_model // H
    shape = (batch, H, dh)
    return {
        "c": torch.zeros(shape, dtype=dtype, device=device),
        "n": torch.zeros(shape, dtype=dtype, device=device),
        "h": torch.zeros(shape, dtype=dtype, device=device),
        "m": torch.full(shape, M_INIT, dtype=dtype, device=device),
    }


def _slstm_step(params, state: dict, inp: dict) -> tuple[dict,
                                                        torch.Tensor]:
    """``inp[g]`` (B,H,dh): gate g's input product at this step →
    h (B,H,dh).  Stabilised sLSTM with per-head block-diagonal
    recurrent matrices."""
    c, n, h_prev, m = state["c"], state["n"], state["h"], state["m"]

    def pre(g):
        rec = torch.einsum("bhk,hkj->bhj", h_prev, params[f"r_{g}"])
        return inp[g] + rec + params[f"b_{g}"]

    z = torch.tanh(pre("z"))
    o = torch.sigmoid(pre("o"))
    i_pre = pre("i")
    log_f = -softplus(-pre("f"))
    m_new = torch.maximum(log_f + m, i_pre)
    f_eff = torch.exp(log_f + m - m_new)
    i_eff = torch.exp(i_pre - m_new)
    c_new = f_eff * c + i_eff * z
    n_new = f_eff * n + i_eff
    h_new = o * c_new / torch.clamp_min(n_new, 1e-6)
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}, h_new


def slstm_block(params, x: torch.Tensor, state: dict, rt=LOCAL
                ) -> tuple[torch.Tensor, dict]:
    """sLSTM residual block and its gated FFN (the xLSTM paper's
    structure).  As in the reference, ``out_ln`` normalises both the
    cell's output and the FFN's input."""
    B, S, d = x.shape
    y = rmsnorm(params["ln"], x).float()
    m = params["w_z"].shape[0]
    inputs = {g: (y @ params[f"w_{g}"].float().reshape(d, -1))
              .view(B, S, *params[f"w_{g}"].shape[1:]) for g in ("i", "f")}
    if rt.tp_splits(d):                # w_z, w_o split on d over tp
        ys = _block_of(rt, y, m)
        zo = rt.reduce_tp(torch.cat([ys @ params[f"w_{g}"].float().reshape(
            m, -1) for g in ("z", "o")], dim=-1))
        for g, t in zip(("z", "o"), zo.chunk(2, dim=-1)):
            inputs[g] = t.view(B, S, *params[f"w_{g}"].shape[1:])
    else:
        inputs.update({g: (y @ params[f"w_{g}"].float().reshape(d, -1))
                       .view(B, S, *params[f"w_{g}"].shape[1:])
                       for g in ("z", "o")})
    hs = []
    for t in range(S):
        state, h = _slstm_step(params, state,
                               {g: v[:, t] for g, v in inputs.items()})
        hs.append(h)
    h = torch.stack(hs, dim=1).reshape(B, S, d).to(x.dtype)
    x = x + rmsnorm(params["out_ln"], h)
    y2 = rmsnorm(params["out_ln"], x)
    a, b = (y2 @ params["w_ff_up"]).chunk(2, dim=-1)
    hff = F.gelu(a.float(), approximate="tanh").to(x.dtype) * b
    m = params["w_ff_down"].shape[0]
    if rt.tp_splits(hff.shape[-1]):    # w_ff_down's rows split over tp
        return x + rt.reduce_tp(partial_product(
            _block_of(rt, hff, m), params["w_ff_down"])).to(x.dtype), state
    return x + hff @ params["w_ff_down"], state
