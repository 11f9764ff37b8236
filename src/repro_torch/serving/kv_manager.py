"""Paged KV-cache block manager (vLLM-style).

Physical KV memory is divided into fixed-size pages of ``page_tokens``
token slots; each sequence owns an ordered block table of page ids.
The manager does allocation/free/extension bookkeeping and exposes the
χ (KV bytes) accounting that token-pool admission charges against.

The engine keeps each layer's K and V in ``(P, page_tokens, H_kv, dh)``
page pools indexed by these block tables, and the paged decode kernel
(``repro_torch.kernels.paged_attention``) walks them directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


class OutOfPages(RuntimeError):
    pass


class DoubleFree(RuntimeError):
    """A sequence's pages were returned twice — the second free would
    corrupt the free list (pages handed to two owners)."""


@dataclasses.dataclass
class SequenceAlloc:
    seq_id: str
    pages: list[int]
    tokens_used: int


class KVBlockManager:
    def __init__(self, total_pages: int, page_tokens: int = 128,
                 bytes_per_token: float = 0.0) -> None:
        assert page_tokens % 128 == 0 or page_tokens in (16, 32, 64), \
            "page size should be 16/32/64 or a multiple of 128 tokens"
        self.total_pages = total_pages
        self.page_tokens = page_tokens
        self.bytes_per_token = bytes_per_token
        self._free: list[int] = list(range(total_pages - 1, -1, -1))
        self._seqs: dict[str, SequenceAlloc] = {}
        #: seq ids already freed once — a second ``free`` is rejected
        #: (cleared when the id is legitimately re-allocated)
        self._freed: set[str] = set()
        #: observability: rejected double frees / frees of ids never
        #: allocated (both are lifecycle bugs upstream; neither touches
        #: the free list)
        self.double_free_rejections = 0
        self.unknown_frees = 0

    # -- capacity queries ------------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.total_pages - self.free_pages

    def pages_needed(self, tokens: int) -> int:
        return -(-tokens // self.page_tokens)

    def can_allocate(self, tokens: int) -> bool:
        return self.pages_needed(tokens) <= self.free_pages

    def kv_bytes_in_use(self) -> float:
        return self.used_pages * self.page_tokens * self.bytes_per_token

    # -- allocation --------------------------------------------------------------
    def allocate(self, seq_id: str, tokens: int) -> SequenceAlloc:
        need = self.pages_needed(max(tokens, 1))
        if need > self.free_pages:
            raise OutOfPages(
                f"{seq_id}: need {need} pages, {self.free_pages} free")
        pages = [self._free.pop() for _ in range(need)]
        alloc = SequenceAlloc(seq_id=seq_id, pages=pages,
                              tokens_used=tokens)
        self._seqs[seq_id] = alloc
        self._freed.discard(seq_id)
        return alloc

    def extend(self, seq_id: str, new_total_tokens: int) -> SequenceAlloc:
        """Grow a sequence (decode appends); allocates pages on crossing
        a page boundary."""
        alloc = self._seqs[seq_id]
        need = self.pages_needed(new_total_tokens)
        while len(alloc.pages) < need:
            if not self._free:
                raise OutOfPages(f"{seq_id}: extension needs a page")
            alloc.pages.append(self._free.pop())
        alloc.tokens_used = new_total_tokens
        return alloc

    def free(self, seq_id: str, strict: bool = False) -> int:
        """Return a sequence's pages to the free list.  A double free
        is REJECTED — counted, raised under ``strict`` — because
        re-extending the free list would hand the same pages to two
        owners.  Freeing an id that was never allocated stays a
        counted no-op (late duplicate completions)."""
        alloc = self._seqs.pop(seq_id, None)
        if alloc is None:
            if seq_id in self._freed:
                self.double_free_rejections += 1
                if strict:
                    raise DoubleFree(seq_id)
            else:
                self.unknown_frees += 1
            return 0
        self._free.extend(reversed(alloc.pages))
        self._freed.add(seq_id)
        return len(alloc.pages)

    def block_table(self, seq_id: str, max_pages: int) -> np.ndarray:
        """Padded block table row for the paged-attention kernel."""
        alloc = self._seqs[seq_id]
        row = np.full((max_pages,), -1, np.int32)
        row[:len(alloc.pages)] = alloc.pages
        return row

    def sequences(self) -> list[str]:
        return sorted(self._seqs)
