"""Share of the program's traced ``engine.prefill`` spans whose prompt
was prefilled by a graph replay (the span's ``graphed`` arg): that the
prefill graphs engaged.  A run whose program records no such arg (a
program without the graphs) reads nothing."""
from harness import program


def read(rec):
    prog = program.complete(rec)
    s = [x for x in program.spans(prog, "engine.prefill")
         if "graphed" in x.args] if prog else []
    return 100.0 * sum(bool(x.args["graphed"]) for x in s) / len(s) \
        if s else None
