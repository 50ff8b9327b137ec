"""100 less the share of the traced window in which some device
operation ran (the union of their intervals)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_us() / ctx.trace.window_us)
