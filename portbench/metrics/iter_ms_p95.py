"""The 95th percentile (nearest rank) of the wall time of every
iteration of the window, in ms."""

import math


def p95(values):
    s = sorted(values)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def read(ctx):
    if not ctx.iter_s:
        return None
    return 1e3 * p95(ctx.iter_s)
