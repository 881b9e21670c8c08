"""ttft_p90_ms: the 90th percentile (nearest rank) over every request of
the window of the time from its batch's start to its first token on the
host, in ms."""
import math


def value(run):
    reqs = run.get("requests")
    if not reqs:
        return None
    xs = sorted(r["ttft_s"] for r in reqs)
    return xs[math.ceil(0.9 * len(xs)) - 1] * 1e3
