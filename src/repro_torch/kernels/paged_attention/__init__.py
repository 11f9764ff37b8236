from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention,
    paged_attention_serial,
    reference_paged_attention,
    reference_paged_attention_split,
)

__all__ = ["paged_attention", "paged_attention_serial",
           "paged_decode_attention", "reference_paged_attention",
           "reference_paged_attention_split"]
