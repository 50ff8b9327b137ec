"""Device kernels (no memsets or copies) in the traced window, over the
traced iterations: the launches the host issues an iteration."""


def read(ctx):
    if ctx.trace is None or not ctx.traced_iters:
        return None
    return len(ctx.trace.kernels()) / ctx.traced_iters
