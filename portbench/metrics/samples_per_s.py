"""Pixel samples completed in the window over the window's time: every
iteration that ended (synchronized) inside the loop, width x height x
spp samples each, over the time from the window's start to the end of
the last one."""


def read(ctx):
    if not ctx.iter_s or ctx.window_s <= 0:
        return None
    return len(ctx.iter_s) * ctx.samples_per_iter / ctx.window_s
