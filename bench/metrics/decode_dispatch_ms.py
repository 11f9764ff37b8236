"""Mean host time of the program's ``model.decode_step`` spans: the
enqueue of one decode step, the span ending when the call returns and
before the harness's synchronise."""
from harness import program


def read(rec):
    prog = program.complete(rec)
    s = program.spans(prog, "model.decode_step") if prog else []
    return 1e3 * sum(x.end - x.start for x in s) / len(s) if s else None
