"""The 90th percentile of the window's request latencies, from when each was due to
when it returned (closed loop: due when the last returned)."""

import statistics


def read(run):
    lat = [r.done - r.due for r in run.requests if r.proofs]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=10, method="inclusive")[-1]
