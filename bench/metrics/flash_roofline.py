"""Time-weighted share of the roofline over the flash-prefill launches
of the traced slice: each launch's least time (one layer over its
prompt, ``reference.flops.flash_bound_s``) summed, over the launches'
device time by kernel name."""
from reference import flops


def read(rec):
    tr = rec["trace"]
    if not tr:
        return None
    t = sum(s for n, s in tr["kernel_s"].items() if "flash_prefill" in n)
    if t <= 0 or not tr["prefill_tokens"]:
        return None
    m = rec["dims"]
    bound = m["layers"] * sum(flops.flash_bound_s(m, s)
                              for s in tr["prefill_tokens"])
    return 100.0 * bound / t
