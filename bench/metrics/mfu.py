"""Model FLOPs of every prefill and decode step in the traced slice of
the window, over the slice's seconds times the H100's bf16 peak."""
from reference import flops


def read(rec):
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    m = rec["dims"]
    work = sum(flops.prefill_flops(m, s) for s in tr["prefill_tokens"])
    work += sum(flops.decode_flops(m, c) for c in tr["decode_contexts"])
    if not work:
        return None
    return 100.0 * work / (tr["window_s"] * flops.PEAK_BF16_FLOPS)
