"""Mean share of the engine's lanes that a decode step in the window
carried."""


def read(rec):
    rows = [n for _, end, n in rec["decode_steps"] if end <= rec["seconds"]]
    return 100.0 * sum(rows) / (len(rows) * rec["lanes"]) if rows else None
