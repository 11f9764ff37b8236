"""95th percentile of the gaps between consecutive output tokens of
every request, over the gaps whose later token came inside the window
(tokens seen in one step count as arriving together)."""
import numpy as np


def read(rec):
    gaps = []
    for r in rec["requests"]:
        t = [x for x in r["token_times"] if x <= rec["seconds"]]
        gaps += [b - a for a, b in zip(t, t[1:])]
    return 1e3 * float(np.percentile(gaps, 95)) if gaps else None
