"""Public entry point for paged decode attention (the reference's
``paged_decode_attention``)."""
from __future__ import annotations

from repro_torch.kernels.paged_attention.paged_attention import (
    paged_attention,
)


def paged_decode_attention(q, k_pages, v_pages, block_tables,
                           context_lens, *, softcap=None, window=None):
    return paged_attention(q, k_pages, v_pages, block_tables,
                           context_lens, softcap=softcap, window=window)
