"""Time-weighted share of the roofline over the paged-decode calls of
the traced slice: each call's least time (one layer, each byte of the
live KV once, ``reference.flops.paged_bound_s``) summed, over the device
time of both passes of every paged kernel by name."""
from reference import flops


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    t = sum(s for n, s in tr["kernel_s"].items() if "paged_" in n)
    if t <= 0 or not tr["decode_contexts"]:
        return None
    m = rec["dims"]
    bound = m["layers"] * sum(flops.paged_bound_s(m, c, rec["page_tokens"])
                              for c in tr["decode_contexts"])
    return 100.0 * bound / t
