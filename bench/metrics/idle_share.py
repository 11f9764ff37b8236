"""Share of the traced slice of the window in which no operation ran on
the device (``torch.profiler``, CUDA activity)."""


def read(rec):
    tr = rec["trace"]
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
