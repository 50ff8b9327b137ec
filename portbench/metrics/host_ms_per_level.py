"""Mean host wall time, in ms, of the port's integrate.level spans in the
traced window: one wavefront level of render/integrator.integrate
(closest hit, shading, the photon estimate, the lane-order adds, the
children), from the host's start of the level to its end."""

from portbench.metrics.host_syncs_per_iter import install, sink  # noqa: F401


def read(ctx):
    s = sink(ctx)
    levels = [r.end_ns - r.start_ns for r in (s.spans if s else ())
              if r.name == "integrate.level"]
    if not levels:
        return None
    return sum(levels) / len(levels) / 1e6
