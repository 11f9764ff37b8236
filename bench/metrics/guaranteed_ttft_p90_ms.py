"""90th percentile of the guaranteed first-token times that
``guaranteed_ttft_p75_ms.steady`` reads: below the knee its spread from
run to run is wider than any bound holds, so it is read per layer."""
from harness.readings import guaranteed_ttft_ms


def read(rec):
    return guaranteed_ttft_ms(rec, 90)
