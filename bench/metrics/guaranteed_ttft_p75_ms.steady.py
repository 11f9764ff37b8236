"""75th percentile, over every guaranteed-class request due in the
window, of the time from its due time to the first token the harness
saw; a refused request, or one with no first token when the run
stopped, counts with the time until the run stopped.  Below the knee
it swings with the host's pace from run to run more than any bound
holds, so it is read per layer."""
from harness.readings import guaranteed_ttft_ms


def read(rec):
    return guaranteed_ttft_ms(rec, 75)
