"""Share of the traced slice of the window in which the device was idle
while the program was inside a ``model.prefill`` or
``model.decode_step`` span: idle that a captured or fused step would
remove (the trace's ``idle_by_span``, each gap charged to the innermost
program span open at its midpoint)."""
from harness import program

MODEL_SPANS = ("model.prefill", "model.decode_step")


def read(rec):
    tr = rec["trace"]
    if not program.complete(rec) or not tr or tr["window_s"] <= 0 \
            or tr.get("idle_by_span") is None:
        return None
    idle = tr["idle_by_span"]
    return 100.0 * sum(idle.get(n, 0.0) for n in MODEL_SPANS) / tr["window_s"]
