"""Largest share, over the maps (global, caustic) and the two sides, of a
side's stored photons ("photons_<map>", (N, 9): position, incoming
direction, power over the photons emitted) that the other side lacks: a
row is matched where the other side has one within POS of the map's
extent in position (each coordinate), DIR in direction and POW of its
largest channel in power. A map on one side only reads 1.

The two sides trace the same draws (the reference replays the build's
generator), and the reference rounds as the port documents its float32
arithmetic, so rows match to the bit but where a photon's path met the
diagonal of a quad, whose two triangles both take the ray within
EPSILON and each tracer may pick either: that photon's later rows part,
and the rows past the map's target shift by as many. The tolerances
only absorb a last bit; a photon stored where its ray began, or with its
direction turned, is a row the other side lacks. The frames' check
cannot see such faults: it gathers over grids of the port's photons on
both sides, and the stored power is unchanged."""

import math

import torch

from portbench.reference.photon import cell_key, near

POS = 1e-5          # of the map's diagonal, each coordinate
DIR = 1e-5
POW = 1e-5          # of the row's largest channel
MAPS = ("global", "caustic")
_BUDGET = 1 << 22   # candidate rows a chunk compares


def unmatched(a: torch.Tensor, b: torch.Tensor, tol: float) -> int:
    """Rows of `a` (N, 9) with no row of `b` (M, 9) within the
    tolerances, `tol` the position's: b's rows sorted by their cell of
    side tol, each row of a tested against the rows of the 27 cells
    around its own."""
    if a.shape[0] == 0 or b.shape[0] == 0:
        return int(a.shape[0])

    def cells(x):
        return torch.floor(x[:, :3].nan_to_num() / tol).to(torch.int64)
    keys, order = torch.sort(cell_key(cells(b)))
    b = b[order]
    per = int(torch.unique_consecutive(keys, return_counts=True)[1].max())
    chunk = max(1, _BUDGET // (27 * per))
    miss = 0
    for c0 in range(0, a.shape[0], chunk):
        x = a[c0:c0 + chunk]
        idx, ok = near(keys, cells(x), per)
        y = b[idx]
        d = (y - x[:, None, :]).abs()
        close = ((d[..., 0:3].amax(-1) <= tol)
                 & (d[..., 3:6].amax(-1) <= DIR)
                 & (d[..., 6:9].amax(-1) <= POW * y[..., 6:9].abs().amax(-1)))
        miss += int((~(ok & close).any(-1)).sum())
    return miss


def read(got, want):
    worst = 0.0
    for name in MAPS:
        key = "photons_" + name
        if key not in got or key not in want:
            return float("inf")
        a, b = got[key], want[key]
        if a is None or b is None:
            if (a is None) != (b is None):
                worst = 1.0
            continue
        a, b = a.float(), b.float().to(a.device)
        ext = b[:, :3].amax(0) - b[:, :3].amin(0) if b.shape[0] else b[:0]
        diag = float(torch.linalg.norm(ext)) if b.shape[0] else 0.0
        tol = POS * (diag if math.isfinite(diag) and diag > 0 else 1.0)
        for x, y in ((a, b), (b, a)):
            if x.shape[0]:
                worst = max(worst, unmatched(x, y, tol) / x.shape[0])
    return worst
