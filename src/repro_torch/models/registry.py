"""Model registry: one uniform interface over the ported families.

``build_model(cfg)`` returns a ``Model`` whose methods are the contract
the engine programs against:

    init(gen, device)                                  → Transformer
    prefill(params, tokens, cache, block_tables)       → logits
    decode_step(params, tok, cache, block_tables, pos) → logits
    init_cache(total_pages, page_tokens, rt, device)   → PagedKVCache

``params`` is the :class:`~repro_torch.models.transformer.Transformer`
module that ``init`` or ``params_from_jax`` returns; :func:`param_count`
counts every weight, the MoE layers' router and all their experts
included (not the active parameters of a token).

Counterpart of ``repro/models/registry.py``, with a paged cache in
place of the dense per-lane one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.runtime import LOCAL


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., torch.nn.Module]
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def build_model(cfg: ArchConfig) -> Model:
    cfg.validate()
    transformer.check_supported(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen, device="cuda":
            transformer.init_params(gen, cfg, device),
        prefill=transformer.prefill,
        decode_step=transformer.decode_step,
        init_cache=lambda total_pages, page_tokens, rt=LOCAL, device="cuda":
            transformer.init_cache(cfg, total_pages, page_tokens, rt,
                                   device),
    )


def param_count(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
