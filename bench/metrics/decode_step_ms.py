"""Mean synchronised wall time of one ``Model.decode_step``."""


def read(rec):
    s = rec["spans"].get("model.decode_step") or []
    return 1e3 * sum(t for t, _ in s) / len(s) if s else None
