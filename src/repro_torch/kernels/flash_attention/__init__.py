from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention,
    reference_attention,
    reference_attention_bf16_p,
)
from repro_torch.kernels.flash_attention.ops import flash_attention_bshd

__all__ = ["flash_attention", "flash_attention_bshd",
           "reference_attention", "reference_attention_bf16_p"]
