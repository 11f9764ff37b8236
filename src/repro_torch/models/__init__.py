"""Model stack of the port: every family of the reference (dense, MoE,
RG-LRU hybrid, xLSTM, VLM, encoder-decoder) on a paged KV cache
(counterpart of ``repro.models``)."""
from repro_torch.models.config import ArchConfig
from repro_torch.models.encdec import EncDecCache, EncoderDecoder
from repro_torch.models.registry import (
    Model,
    build_model,
    param_count,
    param_tree,
    params_from_jax,
)
from repro_torch.models.runtime import LOCAL, Runtime
from repro_torch.models.transformer import PagedKVCache, Transformer

__all__ = ["ArchConfig", "EncDecCache", "EncoderDecoder", "LOCAL", "Model",
           "PagedKVCache", "Runtime", "Transformer", "build_model",
           "param_count", "param_tree", "params_from_jax"]
