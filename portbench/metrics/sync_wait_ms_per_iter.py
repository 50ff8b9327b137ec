"""Host milliseconds an iteration spent inside the port's sync.<site>
spans in the traced window: the time the host blocked on the card at
the calls host_syncs_per_iter counts (each span wraps its call alone)."""

from portbench.metrics.host_syncs_per_iter import install, sink  # noqa: F401


def read(ctx):
    s = sink(ctx)
    if s is None:
        return None
    ns = sum(r.end_ns - r.start_ns for r in s.spans
             if r.name.startswith("sync."))
    return ns / 1e6 / ctx.traced_iters
