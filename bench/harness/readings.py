"""Readings that more than one metric's reader takes, from the records
``cell.records`` builds (times in seconds after the window opened)."""
from __future__ import annotations

import numpy as np

#: classes whose latency is the guaranteed tail
GUARANTEED = ("guaranteed", "dedicated")


def guaranteed_ttft_s(rec) -> list[float]:
    """Due time → first token of every guaranteed-class request due in
    the window; a refused request, or one with no first token when the
    run stopped, counts with the time until the run stopped."""
    out = []
    for r in rec["requests"]:
        if r["klass"] not in GUARANTEED or r["due"] >= rec["seconds"]:
            continue
        first = r["token_times"][0] if r["admitted"] and r["token_times"] \
            else rec["end"]
        out.append(first - r["due"])
    return out


def guaranteed_ttft_ms(rec, q: float):
    """The ``q``-th percentile of ``guaranteed_ttft_s``, in ms."""
    vals = guaranteed_ttft_s(rec)
    return 1e3 * float(np.percentile(vals, q)) if vals else None


def served_tok_s(rec):
    """Prompt tokens whose prefill completed inside the window plus
    output tokens emitted inside it, over all tenants, per second of
    the window."""
    end = rec["seconds"]
    total = 0
    for r in rec["requests"]:
        t = r["token_times"]
        if t and t[0] <= end:
            total += r["prompt_len"]
        total += sum(1 for x in t if x <= end)
    return total / end if total else None
