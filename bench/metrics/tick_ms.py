"""Mean host time of one ``TokenPool.tick``, ending in a synchronise."""


def read(rec):
    s = rec["spans"].get("pool.tick") or []
    return 1e3 * sum(s) / len(s) if s else None
