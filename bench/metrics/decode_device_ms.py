"""Mean device interval of the program's ``model.decode_step`` spans:
what the card took for one decode step, between two CUDA events the
span recorded (None where the spans carry none, as on the CPU)."""
from harness import program


def read(rec):
    prog = program.complete(rec)
    s = [x for x in program.spans(prog, "model.decode_step")
         if x.device_start is not None] if prog else []
    return 1e3 * sum(x.device_end - x.device_start for x in s) / len(s) \
        if s else None
