"""The 95th percentile of every window frame's latency, from the
loop's request to the image on the host (the nearest rank)."""

import math


def read(ctx):
    lat = sorted(ctx["latency_s"])
    return lat[math.ceil(0.95 * len(lat)) - 1] * 1e3
