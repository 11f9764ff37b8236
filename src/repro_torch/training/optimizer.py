"""AdamW with decoupled weight decay, global-norm clipping and a
warmup+cosine schedule, as the reference computes it — not as
``torch.optim.AdamW``: the decay is scaled by the lr inside the update
``u``, and the f32 update is rounded to the param dtype once.

Counterpart of ``repro/training/optimizer.py``.  Params, grads and the
moments are congruent pytrees (``repro_torch.tree``), the model's view
as the reference's leaves; every operation here is elementwise or a
sum, so it runs per tensor, the members of a stacked leaf one by one.
Moments are kept in fp32 even for bf16 params.

XLA contracts four multiply-adds of the reference's jitted update into
fused multiply-adds (fault C1's pattern); :func:`fma` reproduces them,
so on the CPU an update is bit for bit the jitted reference's:

  * the moment EWMAs ``b1·m + (1−b1)·g`` and ``b2·v + (1−b2)·g²``;
  * the decay ``u + wd·p`` and the step ``p − lr·u``.

and :func:`sqrt_rn` takes the square root correctly rounded, as XLA
does (torch's vectorised CPU ``sqrt`` is an ulp off on ~0.6 % of
float32 inputs); :func:`lr_schedule` is written in the form XLA's
simplifier rewrites the reference's into.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch.tree import map_tensors, tensors


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


@dataclasses.dataclass
class AdamWState:
    """``step`` an int32 scalar tensor; ``mu`` and ``nu`` f32 trees
    congruent with the params."""
    step: torch.Tensor
    mu: Any
    nu: Any


def _f32(x: float) -> float:
    """``x`` rounded to f32 (a Python float that holds it exactly)."""
    return float(np.float32(x))


def fma(a, b, c) -> torch.Tensor:
    """f32 ``a·b + c`` with the product unrounded, as XLA emits it: the
    f32·f32 product is exact in f64, so only the sum rounds (then once
    more to f32)."""
    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (x.double() if isinstance(x, torch.Tensor)
               else torch.tensor(x, dtype=torch.float32,
                                 device=ref.device).double()
               for x in (a, b, c))
    return (a * b + c).float()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root: on the CPU through f64 (whose
    root rounds to the right f32); CUDA's ``sqrtf`` already is."""
    return x.sqrt() if x.is_cuda else x.double().sqrt().float()


def adamw_init(params: Any) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tensors(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=map_tensors(zeros, params),
                      nu=map_tensors(zeros, params))


def lr_schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """The f32 learning rate at ``step`` (an int32 tensor): linear warmup
    to ``lr``, then a cosine down to ``min_lr_ratio·lr``.  Written in the
    form XLA's simplifier gives the reference's schedule under jit: each
    division by a constant a product with its f32 reciprocal,
    ``0.5·(1 − floor)`` one constant, ``lr·warm`` taken first and the
    ``+ floor`` fused."""
    floor = cfg.min_lr_ratio
    warm = ((step + 1).float()
            * _f32(1.0 / max(cfg.warmup_steps, 1))).clamp_max(1.0)
    progress = ((step - cfg.warmup_steps).float()
                * _f32(1.0 / max(cfg.total_steps - cfg.warmup_steps, 1))
                ).clamp(0.0, 1.0)
    cosine = torch.cos(progress * _f32(math.pi)) + 1.0
    half = float(np.float32(1.0 - floor)) * 0.5     # exact in f32
    return (warm * cfg.lr) * fma(cosine, half, floor)


def global_norm(tree: Any) -> torch.Tensor:
    """The f32 norm over every tensor of the tree."""
    sums = [t.float().square().sum() for t in tensors(tree)]
    return torch.stack(sums).sum().sqrt()


def clip_by_global_norm(grads: Any, max_norm: float, norm=None
                        ) -> tuple[Any, torch.Tensor]:
    """``grads`` scaled to a global norm of at most ``max_norm``; ``norm``
    is that norm where the caller has it (a sharded step sums over its
    ranks), else :func:`global_norm` of ``grads``."""
    if norm is None:
        norm = global_norm(grads)
    scale = (max_norm / norm.clamp_min(1e-9)).clamp_max(1.0)
    return map_tensors(lambda g: (g.float() * scale).to(g.dtype),
                       grads), norm


def _decay_mask(path) -> bool:
    """No weight decay on norms / biases / 1-d params: the last key of
    the reference's path (a norm's is ``scale``)."""
    name = str(path[-1]) if path else ""
    return not any(s in name for s in
                   ("scale", "bias", "b_", "lambda", "ln"))


def adamw_update(params: Any, grads: Any, state: AdamWState,
                 cfg: OptimizerConfig, grad_norm=None
                 ) -> tuple[Any, AdamWState, dict]:
    """One AdamW step: (new params, new state, {"lr", "grad_norm",
    "step"}), all new tensors (the inputs are left as they are).
    ``grad_norm`` is the gradients' global norm where the caller holds
    only its shards of them (see :func:`clip_by_global_norm`)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, grad_norm)
    step = state.step + 1
    lr = lr_schedule(state.step, cfg)
    b1, b2 = cfg.b1, cfg.b2

    mu = map_tensors(lambda m, g: fma(b1, m, (1 - b1) * g.float()),
                     state.mu, grads)
    nu = map_tensors(lambda v, g: fma(b2, v, (1 - b2) * g.float().square()),
                     state.nu, grads)
    mu_hat_scale = 1.0 / (1 - b1 ** step.float())
    nu_hat_scale = 1.0 / (1 - b2 ** step.float())

    def upd(path, p, m, v):
        u = (m * mu_hat_scale) / (sqrt_rn(v * nu_hat_scale) + cfg.eps)
        if _decay_mask(path):
            u = fma(cfg.weight_decay, p.float(), u)
        return fma(-lr, u, p.float()).to(p.dtype)

    new_params = map_tensors(upd, params, mu, nu, with_path=True)
    metrics = {"lr": lr, "grad_norm": gnorm, "step": step}
    return new_params, AdamWState(step=step, mu=mu, nu=nu), metrics
