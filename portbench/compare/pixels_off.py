"""Share of the checked pixels ("hdr": (H, W, 3) or (K, 3)) with a
channel off by more than RTOL |ref| + ATOL max |ref| (NaN is off)."""

RTOL = 1e-3
ATOL = 1e-6


def read(got, want):
    a, b = got["hdr"].float(), want["hdr"].float()
    if a.shape != b.shape:
        return 1.0
    tol = RTOL * b.abs() + ATOL * float(b.abs().max())
    ok = ((a - b).abs() <= tol).all(-1)
    return float(1.0 - ok.float().mean())
