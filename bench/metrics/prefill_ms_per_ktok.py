"""Synchronised wall time of ``Model.prefill``, summed over the run's
prefills, per thousand prompt tokens."""


def read(rec):
    s = rec["spans"].get("model.prefill") or []
    tokens = sum(n for _, n in s)
    return 1e6 * sum(t for t, _ in s) / tokens if tokens else None
