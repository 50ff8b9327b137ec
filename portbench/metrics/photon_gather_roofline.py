"""The photon gather's share of its roofline: the least time of every
grid_irradiance call of the traced window over their device time.

Each call hands the port's tracer sink a "photon_gather" record
(ops/photon.py): its points ("p", (N, 3)), the grid it gathered from,
and a pair of CUDA events around the call. The least bytes of a call
(gather_bytes) are each point's position and normal read and its
irradiance written, and each photon within the fine level's radius of
the point read once for it (position, direction, power and weight);
where the photons within that radius weigh less than k, the coarse
level's photons within its radius too. Any gather, however written,
reads those to find the k-th photon and to decide on the coarse level;
it need not read the coarse level elsewhere. The counts are made here
(within), from the points and the grid's photons that carry weight,
by their own cells and distances, not by the code under test. Bytes
bound the call (a photon's distance is a handful of operations); the
time is the events' sum. Off the card, or where the port hands no such
record, it reads nothing."""

import torch

from portbench import roofline
from portbench.metrics.host_syncs_per_iter import install, sink  # noqa: F401
from portbench.reference.photon import cell_key, near

POINT_BYTES = 3 * 3 * roofline.F32      # p and n in, the irradiance out
PHOTON_BYTES = 10 * roofline.F32        # position, direction, power, weight
_BUDGET = 1 << 22                       # candidate photons a chunk tests


def gather_bytes(points: int, photons: int) -> float:
    """Least bytes of one gather call of `points` points that must read
    `photons` photons, summed over the points."""
    return points * POINT_BYTES + photons * PHOTON_BYTES


def within(p, pos, weight, radius: float):
    """(photons (N,) int64, their weight (N,)) within `radius` of each
    point of p (N, 3), of the photons at pos (M, 3) whose weight is
    positive: the photons sorted by their cell of side radius, each point
    testing the 27 cells around its own, d^2 < radius^2 in float32."""
    keep = weight > 0
    pos, weight = pos[keep].float(), weight[keep].float()
    n = p.shape[0]
    if n == 0 or pos.shape[0] == 0:
        return (torch.zeros(n, dtype=torch.int64, device=p.device),
                torch.zeros(n, device=p.device))
    r = torch.tensor(radius, dtype=torch.float32, device=p.device)

    def cells(x):
        return torch.floor(x / r).to(torch.int64)
    keys, order = torch.sort(cell_key(cells(pos)))
    pos, weight = pos[order], weight[order]
    per = int(torch.unique_consecutive(keys, return_counts=True)[1].max())
    chunk = max(1, _BUDGET // (27 * per))
    count = torch.empty(n, dtype=torch.int64, device=p.device)
    wsum = torch.empty(n, device=p.device)
    for c0 in range(0, n, chunk):
        x = p[c0:c0 + chunk].float()
        idx, ok = near(keys, cells(x), per)
        d = pos[idx] - x[:, None, :]
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) \
            + d[..., 2] * d[..., 2]
        inside = ok & (d2 < r * r)
        count[c0:c0 + chunk] = inside.sum(-1)
        wsum[c0:c0 + chunk] = torch.where(inside, weight[idx], 0.0).sum(-1)
    return count, wsum


def least_photons(p, grid) -> int:
    """Photons a gather at points p over `grid` (a PhotonGrid, with its
    coarse level) must read, summed over the points."""
    count, wsum = within(p, grid.pos, grid.weight, float(grid.radius))
    total = int(count.sum())
    if grid.coarse is not None:
        need = wsum < grid.knn
        c = grid.coarse
        total += int(within(p[need], c.pos, c.weight, float(c.radius))[0]
                     .sum())
    return total


def read(ctx):
    s = sink(ctx)
    recs = s.records.get("photon_gather") if s is not None else None
    if not recs or any("p" not in r or "grid" not in r for r in recs):
        return None
    from cse168_raytracer_tpu_torch.utils.profiling import device_ms
    ms = [device_ms(r) for r in recs]
    if None in ms or sum(ms) <= 0:
        return None
    with torch.no_grad():
        least = sum(gather_bytes(r["points"], least_photons(r["p"], r["grid"]))
                    for r in recs) / roofline.HBM_BYTES_S
    return 100.0 * least / (sum(ms) / 1e3)
