"""Mixture-of-Experts MLP (qwen3-style: top-k routing over E experts,
softmax gate, renormalised top-k probabilities).

Counterpart of ``repro/models/moe.py``, with its static-shape,
sort-based dispatch:

  1. router logits (f32) → softmax → top-k (gates, expert ids) per token;
  2. flatten the (T·k) assignments, stable-sort them by expert id;
  3. rank within an expert from an exclusive cumsum of the expert
     counts; assignments ranked at or beyond the capacity C are dropped
     (their gate is zero, the residual carries the token);
  4. scatter the kept tokens into a dense (E, C, d) buffer → batched
     expert products (E,C,d)×(E,d,f) with ``torch.bmm`` (the reference
     leaves them to XLA, outside any Pallas kernel);
  5. combine back to (T, d), each kept assignment weighted by its gate.

Where the reference's semantics rest on JAX's own ordering, the port
spells it out: ``jax.lax.top_k`` puts the lower expert id first among
equal probabilities (``torch.topk`` promises no order, so a stable
descending sort is used), and the combine's scatter-add runs over the
assignments in sorted order (XLA's serial scatter), so each token's k
contributions are added in that order (in bf16 the order changes the
rounding; ``index_add_`` on the card would add them in any order).

:func:`moe_mlp_ep` is the reference's expert-parallel ``shard_map`` body
on one rank of a mesh-ful ``Runtime``: experts split over the EP axes
(the data axes), the expert ffn dim over tp,

  tokens (T_loc, d) → local dispatch (E, C, d) —all_to_all(EP)→ the
  local experts' slots (E_loc, n_ep·C, d) → expert products (f split
  over tp, the partial down-projection summed over tp) —all_to_all(EP)→
  back to the source rank → local combine,

with the capacity C taken from the *local* T, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_moe(gen: torch.Generator, cfg, dtype, device) -> dict:
    """Router in float32 (as the reference keeps it), experts in
    ``dtype``."""
    E, d, f = cfg.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, (d, E), torch.float32, device),
        "w_gate": dense_init(gen, (E, d, f), dtype, device),
        "w_up": dense_init(gen, (E, d, f), dtype, device),
        "w_down": dense_init(gen, (E, f, d), dtype, device),
    }


def expert_capacity(T: int, cfg) -> int:
    """Slots per expert: the reference's ``max(1, int(T·k/E·cf))``, the
    same Python float expression."""
    return max(1, int(T * cfg.experts_per_token / cfg.num_experts
                      * cfg.moe_capacity_factor))


def route(router_w: torch.Tensor, x: torch.Tensor, cfg
          ) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T,d) → (gates (T,k) f32, expert ids (T,k) int64); among equal
    probabilities the lower expert id comes first, as in
    ``jax.lax.top_k``."""
    logits = x.float() @ router_w
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, idx = gates[:, :k], idx[:, :k]
    if cfg.norm_topk_prob:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, idx


def _dispatch_indices(expert_ids: torch.Tensor, E: int, C: int
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sort-based dispatch bookkeeping.

    expert_ids: (N,) flattened token→expert assignments.
    Returns (perm, dst_slot, keep): ``perm`` sorts assignments by expert
    (stable); ``dst_slot`` is the (E·C)-buffer slot of each *sorted*
    assignment (a dropped one points at its expert's last slot, as in
    the reference); ``keep`` masks assignments within capacity.
    """
    N = expert_ids.shape[0]
    perm = torch.argsort(expert_ids, stable=True)
    sorted_e = expert_ids[perm]
    # the counts by a scatter-add: bincount on the card reads the
    # largest id back to the host first
    counts = torch.zeros(E, dtype=expert_ids.dtype,
                         device=expert_ids.device)
    counts.index_add_(0, expert_ids, torch.ones_like(expert_ids))
    offsets = torch.cumsum(counts, 0) - counts             # exclusive
    rank = torch.arange(N, device=expert_ids.device) - offsets[sorted_e]
    keep = rank < C
    dst = sorted_e * C + rank.clamp_max(C - 1)
    return perm, dst, keep


def _dispatch(params, x: torch.Tensor, cfg):
    """Route x (T, d) and fill the (E, C, d) dispatch buffer: (buffer,
    (dst, src_gate, perm) for :func:`_combine`)."""
    T, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    C = expert_capacity(T, cfg)
    gates, idx = route(params["router"], x, cfg)

    flat_e = idx.reshape(T * k)
    flat_g = gates.reshape(T * k)
    flat_t = torch.arange(T, device=x.device)[:, None].expand(T, k) \
        .reshape(T * k)
    perm, dst, keep = _dispatch_indices(flat_e, E, C)
    src_tok = flat_t[perm]
    src_gate = torch.where(keep, flat_g[perm], 0.0)

    # each kept assignment owns its slot (a dropped one would add zeros
    # to its expert's last slot): the dropped ones go to a spare row,
    # with no boolean indexing, which would read a count back to the host
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[torch.where(keep, dst, E * C)] = x[src_tok]
    return buf[:E * C].view(E, C, d), (dst, src_gate, perm)


def _experts(params, disp: torch.Tensor, partial: bool = False
             ) -> torch.Tensor:
    """SwiGLU experts on their slots: (E, C, d) → (E, C, d); with
    ``partial`` the down-projection of a tp rank's block of the expert
    ffn, in float32 (``layers.partial_product``)."""
    g = torch.bmm(disp, params["w_gate"])
    u = torch.bmm(disp, params["w_up"])
    h = F.silu(g.float()).to(disp.dtype) * u
    if partial:
        return torch.bmm(h.float(), params["w_down"].float())
    return torch.bmm(h, params["w_down"])


def _combine(y: torch.Tensor, how, T: int, k: int) -> torch.Tensor:
    """Each token's k contributions (gate · y[slot], 0 when dropped),
    added in the sorted order of its assignments: (E·C, d) → (T, d)."""
    dst, src_gate, perm = how
    contrib = y[dst] * src_gate[:, None].to(y.dtype)      # sorted order
    where = torch.empty_like(perm)
    where[perm] = torch.arange(T * k, device=y.device)
    at = where.view(T, k).sort(dim=1).values                # (T, k)
    c = contrib[at]                                         # (T, k, d)
    out = c[:, 0]
    for j in range(1, k):
        out = out + c[:, j]
    return out


def moe_mlp(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """MoE MLP: x (T, d) → (T, d), SwiGLU experts."""
    T, d = x.shape
    disp, how = _dispatch(params, x, cfg)
    y = _experts(params, disp).reshape(-1, d)
    return _combine(y, how, T, cfg.experts_per_token)


def moe_mlp_ep(params, x: torch.Tensor, cfg, rt) -> torch.Tensor:
    """This rank's MoE MLP under the mesh of ``rt``: x (T_loc, d), the
    rank's tokens; ``params`` the rank's experts (E_loc, d, f_loc), the
    router whole.  Each all-to-all's bytes go to the mesh's tally."""
    # deferred: distributed/__init__ → sharding → models (this package)
    from repro_torch.distributed.collectives import all_to_all
    T, d = x.shape
    E = cfg.num_experts
    mesh, ep = rt.mesh, rt.dp_axes                 # experts over data
    if E % mesh.axis_size(ep):
        raise ValueError(f"{cfg.name}: {E} experts over {ep} "
                         f"({mesh.axis_size(ep)} ranks)")
    send, how = _dispatch(params, x, cfg)
    # (E, C, d) → (E_loc, n_ep·C, d), slots grouped by source rank
    recv = rt.replicate_tp(all_to_all(send, mesh, ep, 0, 1))
    split = params["w_down"].shape[1] < cfg.d_ff            # f over tp
    y = _experts(params, recv, split)
    if split:
        y = rt.reduce_tp(y).to(x.dtype)
    back = all_to_all(y, mesh, ep, 1, 0).reshape(-1, d)     # (E·C, d)
    return _combine(back, how, T, cfg.experts_per_token)


def moe_dense_reference(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """Oracle: every expert computed for every token, gate-weighted sum.
    Equal to :func:`moe_mlp` when the capacity admits every token."""
    gates, idx = route(params["router"], x, cfg)           # (T, k)
    g = torch.einsum("td,edf->tef", x, params["w_gate"])
    u = torch.einsum("td,edf->tef", x, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    y = torch.einsum("tef,efd->ted", h, params["w_down"])  # (T, E, d)
    T, E = x.shape[0], cfg.num_experts
    dense_gate = torch.zeros((T, E), dtype=torch.float32, device=x.device)
    dense_gate.scatter_add_(1, idx, gates)
    return torch.einsum("te,ted->td", dense_gate.to(y.dtype), y)
