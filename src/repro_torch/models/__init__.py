"""Model stack of the port: the attention families (dense and MoE) on a
paged KV cache (counterpart of ``repro.models``)."""
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import Model, build_model, param_count
from repro_torch.models.runtime import LOCAL, Runtime
from repro_torch.models.transformer import (
    PagedKVCache,
    Transformer,
    params_from_jax,
)

__all__ = ["ArchConfig", "LOCAL", "Model", "PagedKVCache", "Runtime",
           "Transformer", "build_model", "param_count", "params_from_jax"]
