"""p95_ms: the 95th percentile (nearest rank) of the latency of every
request due in the window, timed by the client from its due time; a
request refused, failed or never answered counts past any limit."""

import math


def read(obs):
    lat = obs.get("latencies_ms")
    if not lat:
        return None
    s = sorted(lat)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]
