"""Request lifecycle + latency metrics (TTFT / TPOT / E2E)."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np


class RequestState(str, enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    DENIED = "denied"
    EVICTED = "evicted"
    FAILED = "failed"


@dataclasses.dataclass
class Request:
    request_id: str
    entitlement: str
    prompt_tokens: list[int]
    max_tokens: int
    arrival_s: float
    api_key: str = ""
    priority: float = 0.0

    state: RequestState = RequestState.QUEUED
    output_tokens: list[int] = dataclasses.field(default_factory=list)
    admitted_s: Optional[float] = None
    first_token_s: Optional[float] = None
    finished_s: Optional[float] = None
    deny_reason: Optional[str] = None
    retry_after_s: Optional[float] = None
    replica: Optional[str] = None
    #: pool that admitted the request (multi-pool routing)
    pool: Optional[str] = None
    #: legs denied before the admitting pool (0 = preferred pool)
    spill_hops: int = 0

    @property
    def input_len(self) -> int:
        return len(self.prompt_tokens)

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def e2e(self) -> Optional[float]:
        if self.finished_s is None:
            return None
        return self.finished_s - self.arrival_s

    @property
    def tpot(self) -> Optional[float]:
        """Time per output token (decode phase)."""
        if (self.finished_s is None or self.first_token_s is None
                or len(self.output_tokens) <= 1):
            return None
        return ((self.finished_s - self.first_token_s)
                / (len(self.output_tokens) - 1))


def percentile(values: list[float], p: float) -> float:
    if not values:
        return float("nan")
    return float(np.percentile(np.asarray(values), p))


def latency_summary(requests: list[Request]) -> dict:
    ttfts = [r.ttft for r in requests if r.ttft is not None]
    e2es = [r.e2e for r in requests if r.e2e is not None]
    return {
        "count": len(requests),
        "finished": sum(r.state == RequestState.FINISHED
                        for r in requests),
        "denied": sum(r.state == RequestState.DENIED for r in requests),
        "ttft_p50": percentile(ttfts, 50),
        "ttft_p99": percentile(ttfts, 99),
        "e2e_p50": percentile(e2es, 50),
        "e2e_p99": percentile(e2es, 99),
    }
