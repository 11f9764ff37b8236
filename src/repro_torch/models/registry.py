"""Model registry: one uniform interface over every family.

``build_model(cfg)`` returns a ``Model`` whose methods are the contract
the engine programs against:

    init(gen, device)                                        → params
    forward_train(params, tokens, extra_embed=None,
                  remat="none")                              → logits
    prefill(params, tokens, cache, block_tables, lanes=None,
            extra_embed=None)                                → logits
    decode_step(params, tok, cache, block_tables, pos,
                lanes=None)                                  → logits
    init_cache(total_pages, page_tokens, rt, device, lanes=1,
               layout=None)                                  → cache

``params`` is the module that ``init`` or :func:`params_from_jax`
returns: a :class:`~repro_torch.models.transformer.Transformer`, or an
:class:`~repro_torch.models.encdec.EncoderDecoder` for an
encoder-decoder config, whose prefill takes the encoder's frames as
``extra_embed``.  ``lanes`` names the cache rows of each sequence's
per-sequence state (recurrent state, cross K/V).  ``forward_train``
gives the logits at every position under autograd (the encoder-decoder
takes its frames as ``extra_embed``); :func:`param_tree` views
``params`` as the reference's pytree.  :func:`param_count`
counts every weight, the MoE layers' router and all their experts
included (not the active parameters of a token).

Counterpart of ``repro/models/registry.py``, with a paged cache in
place of the dense per-lane one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.models import encdec, transformer
from repro_torch.models.config import ArchConfig
from repro_torch.models.runtime import LOCAL


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    init: Callable[..., torch.nn.Module]
    forward_train: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def build_model(cfg: ArchConfig) -> Model:
    cfg.validate()
    transformer.check_supported(cfg)
    lib = encdec if cfg.is_encoder_decoder else transformer
    return Model(
        cfg=cfg,
        init=lambda gen, device="cuda": lib.init_params(gen, cfg, device),
        forward_train=lib.forward_train,
        prefill=lib.prefill,
        decode_step=lib.decode_step,
        init_cache=lambda total_pages, page_tokens, rt=LOCAL, device="cuda",
        lanes=1, layout=None: lib.init_cache(cfg, total_pages, page_tokens,
                                             rt, device, lanes, layout),
    )


def params_from_jax(cfg: ArchConfig, np_params: dict,
                    device) -> torch.nn.Module:
    """The reference's param pytree (numpy leaves) → the port's module
    for ``cfg``."""
    lib = encdec if cfg.is_encoder_decoder else transformer
    return lib.params_from_jax(cfg, np_params, device)


def module_from_tree(cfg: ArchConfig, tree: dict) -> torch.nn.Module:
    """The module for ``cfg`` whose parameters are the param tree's
    tensors (the inverse of :func:`param_tree`)."""
    lib = encdec if cfg.is_encoder_decoder else transformer
    return lib.module_from_tree(cfg, tree)


def param_tree(params: torch.nn.Module) -> dict:
    """``params`` as the reference's param pytree (see
    :func:`repro_torch.models.transformer.param_tree`)."""
    lib = encdec if params.cfg.is_encoder_decoder else transformer
    return lib.param_tree(params)


def param_count(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())
