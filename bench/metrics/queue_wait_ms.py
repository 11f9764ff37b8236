"""Mean time from a request's admission to the start of its prefill,
over the admitted requests whose prefill started."""


def read(rec):
    w = [r["prefill_start"] - r["sent"] for r in rec["requests"]
         if r["admitted"] and r["prefill_start"] is not None]
    return 1e3 * sum(w) / len(w) if w else None
