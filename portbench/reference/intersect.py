"""Closest hit of rays against triangles, by brute force over clusters.

The triangles are put in Morton order of their centroids and cut into
clusters of CLUSTER; a ray tests every triangle of every cluster whose
box (widened a little, so that the cull can only keep too much) it
passes within its [tmin, tmax]. The test is Moeller and Trumbore's:
a hit is any t in [tmin, tmax] with barycentrics u, v >= 0 and
u + v <= 1 on a triangle of non-zero determinant. The closest t wins;
among equal t the smallest triangle index. Nothing here depends on a
tree, so the answer is the same whatever tree a renderer builds.
"""

from __future__ import annotations

import numpy as np
import torch

CLUSTER = 128
BIG = float("inf")


def _morton(q: np.ndarray) -> np.ndarray:
    """30-bit Morton codes of (N, 3) integers in [0, 1024)."""
    def spread(x):
        x = x.astype(np.int64) & 0x3FF
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x
    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


class Clusters:
    """Triangles in Morton-ordered clusters with their boxes."""

    def __init__(self, v0, e1, e2, device, dtype=torch.float32):
        """v0, e1, e2: (T, 3) float32 numpy arrays."""
        a = v0.astype(np.float64)
        pts = np.stack([a, a + e1, a + e2], 1)            # (T, 3, 3)
        cen = pts.mean(1)
        lo, hi = cen.min(0), cen.max(0)
        q = np.clip((cen - lo) / np.maximum(hi - lo, 1e-30) * 1023, 0, 1023)
        order = np.argsort(_morton(q), kind="stable")
        n = order.shape[0]
        c = -(-n // CLUSTER)
        idx = np.full(c * CLUSTER, -1, np.int64)
        idx[:n] = order
        idx = idx.reshape(c, CLUSTER)
        safe = np.where(idx >= 0, idx, order[0])
        blo = pts.min(1)[safe].min(1)
        bhi = pts.max(1)[safe].max(1)
        pad = 1e-4 * max(1.0, float(np.abs(pts).max()))
        self.lo = torch.as_tensor(blo - pad, device=device).to(dtype)
        self.hi = torch.as_tensor(bhi + pad, device=device).to(dtype)
        self.ids = torch.as_tensor(idx, device=device)          # (C, S)
        g = lambda x: torch.as_tensor(x[safe], device=device).to(dtype)
        self.v0, self.e1, self.e2 = g(v0), g(e1), g(e2)         # (C, S, 3)
        self.dtype = dtype

    @property
    def num_clusters(self) -> int:
        return self.ids.shape[0]


def _pairs(cl: Clusters, o, d, tmin, tmax, chunk: int):
    """(ray, cluster) index pairs whose box the ray passes."""
    inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
    rays, clus = [], []
    for r0 in range(0, o.shape[0], chunk):
        oo, ii = o[r0:r0 + chunk, None], inv[r0:r0 + chunk, None]
        t0 = (cl.lo[None] - oo) * ii
        t1 = (cl.hi[None] - oo) * ii
        near = torch.minimum(t0, t1).amax(-1)
        far = torch.maximum(t0, t1).amin(-1)
        ok = ((near <= far) & (far >= tmin[r0:r0 + chunk, None])
              & (near <= tmax[r0:r0 + chunk, None]))
        r, c = torch.nonzero(ok, as_tuple=True)
        rays.append(r + r0)
        clus.append(c)
    return torch.cat(rays), torch.cat(clus)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _dot(a, b):
    return (a * b).sum(-1)


@torch.no_grad()
def closest_hit(cl: Clusters, o, d, tmin, tmax, pair_chunk: int = 1 << 15,
                ray_chunk: int = 1 << 13):
    """(t (N,), BIG on a miss; triangle (N,) int64, -1 on a miss; u, v
    (N,) barycentrics of the hit) of rays o, d (N, 3) in [tmin, tmax]."""
    dt = cl.dtype
    o, d = o.detach().to(dt), d.detach().to(dt)
    n = o.shape[0]
    tmin = torch.as_tensor(tmin, device=o.device).to(dt).expand(n)
    tmax = torch.as_tensor(tmax, device=o.device).to(dt).expand(n)
    best = torch.full((n,), BIG, dtype=dt, device=o.device)
    tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    bu = torch.zeros((n,), dtype=dt, device=o.device)
    bv = torch.zeros_like(bu)
    if n == 0:
        return best, tri, bu, bv
    ray, clu = _pairs(cl, o, d, tmin, tmax, ray_chunk)
    for p0 in range(0, ray.shape[0], pair_chunk):
        r, c = ray[p0:p0 + pair_chunk], clu[p0:p0 + pair_chunk]
        ro, rd = o[r][:, None], d[r][:, None]                  # (P, 1, 3)
        v0, e1, e2 = cl.v0[c], cl.e1[c], cl.e2[c]              # (P, S, 3)
        pvec = _cross(rd, e2)
        det = _dot(e1, pvec)
        sdet = torch.where(det == 0, torch.ones_like(det), det)
        tvec = ro - v0
        u = _dot(tvec, pvec) / sdet
        qvec = _cross(tvec, e1)
        v = _dot(rd, qvec) / sdet
        t = _dot(e2, qvec) / sdet
        ok = ((det != 0) & (u >= 0) & (v >= 0) & (u + v <= 1)
              & (t >= tmin[r, None]) & (t <= tmax[r, None])
              & (cl.ids[c] >= 0))
        t = torch.where(ok, t, torch.full_like(t, BIG))
        pt, lane = t.min(1)                                    # (P,)
        pid = cl.ids[c].gather(1, lane[:, None])[:, 0]
        # each ray's least t so far, then the least triangle at that t
        prev = best
        best = best.scatter_reduce(0, r, pt, "amin")
        win = (pt == best[r]) & (pt < BIG)
        big = torch.iinfo(torch.int64).max
        cand = torch.full_like(tri, big).scatter_reduce(
            0, r, torch.where(win, pid, big), "amin")
        tie = (cand != big) & (best == prev)
        tri = torch.where(best < prev, cand,
                          torch.where(tie, torch.minimum(tri, cand), tri))
        keep_u = u.gather(1, lane[:, None])[:, 0]
        keep_v = v.gather(1, lane[:, None])[:, 0]
        mine = win & (pid == tri[r])
        bu = bu.index_put((r[mine],), keep_u[mine])
        bv = bv.index_put((r[mine],), keep_v[mine])
    tri = torch.where(best < BIG, tri, torch.full_like(tri, -1))
    return best, tri, bu, bv
