"""The traversal kernels' share of their roofline: the least time of
every traversal call of the traced window (portbench/roofline.py,
traverse_call: live rays in, answers out, the scene's triangles once;
no visit counts, so a better tree cannot move the yardstick) over the
union of the device time of the kernels whose names hold "traverse".

The live rays (tmax >= tmin) of each call are counted in the probe
iteration before the window, where a count's synchronize costs the
window nothing; every iteration of the window makes the same calls on
the same rays (the traffic draws no rays, or draws them all live), so
each window iteration's least time is the probe's. Where the window's
calls do not repeat the probe's, the metric reads nothing."""

from portbench import roofline
from portbench.trace import union_us


def install(ctx):
    from cse168_raytracer_tpu_torch.ops import wide_bvh
    probe = ctx.calls.setdefault("traverse_probe", [])
    window = ctx.calls.setdefault("traverse", [])
    for name, closest in (("closest_hit_triangles", True),
                          ("any_hit_triangles", False)):
        real = getattr(wide_bvh, name)

        def wrapped(bvh, o, d, tmin, tmax, *a, _real=real, _closest=closest,
                    **k):
            if ctx.probing:
                probe.append((_closest, live(o.shape[0], tmin, tmax)))
            else:
                window.append(_closest)
            return _real(bvh, o, d, tmin, tmax, *a, **k)
        ctx.patch(wide_bvh, name, wrapped)


def live(n, tmin, tmax):
    """Rays of a call with tmax >= tmin (the traversal skips the rest)."""
    import torch
    if not isinstance(tmax, torch.Tensor) and not isinstance(tmin,
                                                             torch.Tensor):
        return n if tmax >= tmin else 0
    tmax = torch.as_tensor(tmax).expand(n)
    tmin = torch.as_tensor(tmin, device=tmax.device).expand(n)
    return int((tmax >= tmin).sum())


def read(ctx):
    probe = ctx.calls.get("traverse_probe")
    window = ctx.calls.get("traverse")
    if ctx.trace is None or not probe or \
            window != [c for c, _ in probe] * ctx.traced_iters:
        return None
    spans = [(s, e) for n, s, e in ctx.trace.kernels()
             if "traverse" in n.lower()]
    if not spans:
        return None
    least = sum(roofline.least_seconds(*roofline.traverse_call(
        n, ctx.n_tris, closest))[0] for closest, n in probe)
    return 100.0 * least * ctx.traced_iters / (union_us(spans) / 1e6)
