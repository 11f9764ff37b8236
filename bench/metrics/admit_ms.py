"""Mean host time of one ``Gateway.handle`` call (a harness span)."""


def read(rec):
    s = rec["spans"].get("gateway.handle") or []
    return 1e3 * sum(s) / len(s) if s else None
