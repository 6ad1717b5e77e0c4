"""solve_p95_s: the 95th percentile of every request's latency in the
window (nearest rank)."""

import math


def value(run):
    lat = sorted(run["window"].latencies)
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)]
