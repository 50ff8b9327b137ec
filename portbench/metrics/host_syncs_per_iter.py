"""Blocking host-device calls of the program an iteration: the increments
of the port's sync.<site> counters (cse168_raytracer_tpu_torch/utils/
profiling.py) over the traced window, over the traced iterations. A
site counts where the host waits on the card: a number copied to the
card, a nonzero, a bincount, an .item().

install() here opens the tracer's sink that every reader of the
program's spans and counters reads (sink())."""


def install(ctx):
    """Open the port's sink for the traced window (ctx.undo() closes
    it), once for all its readers; it drops what arrives while
    ctx.probing is set. A port without a sink gets none."""
    from cse168_raytracer_tpu_torch.utils import profiling
    if "sink" in ctx.calls or not hasattr(profiling, "Sink"):
        return
    ctx.calls["sink"] = profiling.Sink(paused=lambda: ctx.probing)
    ctx.patch(profiling, "SINK", ctx.calls["sink"])


def sink(ctx):
    """The traced window's sink, or None where there is none to read."""
    if not ctx.traced_iters:
        return None
    return ctx.calls.get("sink")


def read(ctx):
    s = sink(ctx)
    if s is None:
        return None
    syncs = sum(n for k, n in s.counts.items() if k.startswith("sync."))
    return syncs / ctx.traced_iters
