"""frame_ms_p90: the 90th percentile (nearest rank) of every frame's time
in the window, each from its call to its synchronise."""

import math


def p90(values):
    if not values:
        return None
    s = sorted(values)
    return s[max(math.ceil(0.9 * len(s)) - 1, 0)]


def read(r):
    v = p90(r.call_s)
    return None if v is None else v * 1e3
