"""Useful over attempted walks of the traversal kernels in the traced
window, in %: 100 x the live rays that the port's integrate counts
(RenderStats' primary, secondary and shadow rays, which it hands the
sink as device tensors, read after the window) over the lanes the
traversal kernels were handed (the port's bvh.lanes counter). A
level's pool launches every lane, the dead ones too (tmax < tmin)."""

from portbench.metrics.host_syncs_per_iter import install, sink  # noqa: F401


def read(ctx):
    s = sink(ctx)
    if s is None:
        return None
    lanes = s.counts.get("bvh.lanes", 0)
    stats = s.records.get("render_stats", [])
    if not lanes or not stats:
        return None
    live = sum(int(n) for rays in stats for n in rays)
    return 100.0 * live / lanes
