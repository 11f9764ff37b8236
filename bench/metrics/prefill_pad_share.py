"""The padding the prefill graphs add: the sum of the program's traced
``engine.prefill`` spans' ``padded_tokens`` (bucket less prompt) over the
sum of their ``prompt_tokens``.  A run whose program records no such arg
reads nothing."""
from harness import program


def read(rec):
    prog = program.complete(rec)
    s = [x for x in program.spans(prog, "engine.prefill")
         if "padded_tokens" in x.args] if prog else []
    tokens = sum(x.args["prompt_tokens"] for x in s)
    return 100.0 * sum(x.args["padded_tokens"] for x in s) / tokens \
        if tokens else None
