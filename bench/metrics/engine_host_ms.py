"""Mean host time, per ``engine.decode`` span, of the engine's own
Python around the model call: its ``engine.tables`` (block tables and
the step's input tensors) and ``engine.bookkeeping`` (KV extension,
finishes, completions) children."""
from harness import program


def read(rec):
    prog = program.complete(rec)
    if not prog:
        return None
    n = len(program.spans(prog, "engine.decode"))
    own = sum(x.end - x.start for name in ("engine.tables",
                                           "engine.bookkeeping")
              for x in program.spans(prog, name))
    return 1e3 * own / n if n else None
