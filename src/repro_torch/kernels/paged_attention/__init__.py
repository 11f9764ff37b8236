from repro_torch.kernels.paged_attention.ops import paged_decode_attention
from repro_torch.kernels.paged_attention.paged_attention import (
    merge_partials,
    paged_attention,
    paged_attention_partial,
    reference_paged_attention,
    reference_paged_attention_partial,
    reference_paged_attention_group,
    reference_paged_attention_split,
    route,
)

__all__ = ["merge_partials", "paged_attention", "paged_attention_partial",
           "paged_decode_attention", "reference_paged_attention",
           "reference_paged_attention_group",
           "reference_paged_attention_partial",
           "reference_paged_attention_split", "route"]
