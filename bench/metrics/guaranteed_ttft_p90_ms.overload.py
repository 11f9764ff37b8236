"""``guaranteed_ttft_p90_ms`` read in a cell above the knee, where a
tail swings with the order of the arrivals and is not held to a bound:
the guaranteed tenants' queueing for lanes that spot work holds."""
from harness.readings import guaranteed_ttft_ms


def read(rec):
    return guaranteed_ttft_ms(rec, 90)
