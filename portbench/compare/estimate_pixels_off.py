"""Share of the frame's pixels ("hdr", (H, W, 3)) with a channel off by
more than RTOL |ref| + ATOL max |ref| (NaN is off), the frame being the
direct light plus the photon maps' estimate at every diffuse hit.

The tolerance is pixels_off's: the reference gathers over grids it
builds from the port's photons, at gather points it finds as the port
does, so the estimate agrees to float rounding but where a camera ray
meets the diagonal of a quad of the glass sphere, whose two triangles
both take it within EPSILON and the two tracers may pick either (two
pixels a frame in the calibration, PERF.md section 2). A miss there is
large: where photons are dense the gather's disc moves by a whole step
of its 12 halvings when the k-th photon's distance crosses one."""

RTOL = 1e-3
ATOL = 1e-6


def read(got, want):
    a, b = got["hdr"].float(), want["hdr"].float()
    if a.shape != b.shape:
        return 1.0
    tol = RTOL * b.abs() + ATOL * float(b.abs().max())
    ok = ((a - b).abs() <= tol).all(-1)
    return float(1.0 - ok.float().mean())
