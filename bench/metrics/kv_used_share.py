"""Mean over decode steps of the KV the pages hold over the KV that
admission charged for the requests the engine holds (the program's
``kv_used_bytes`` and ``kv_reserved_bytes`` counters), skipping steps
with nothing charged."""
from harness import program


def read(rec):
    prog = program.complete(rec)
    if not prog:
        return None
    shares = [u / r for u, r in zip(program.counter(prog, "kv_used_bytes"),
                                    program.counter(prog, "kv_reserved_bytes"))
              if r > 0]
    return 100.0 * sum(shares) / len(shares) if shares else None
