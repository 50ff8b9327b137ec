"""The plain reference of photon mapping: photon tracing, the global and
caustic maps, the irradiance estimate, and the estimate's share of a
frame (photon_term), which the Whitted frame of reference/render.py
takes as its direct term's addition at diffuse hits.

Semantics (the reference C++ tracer's Scene::tracePhotons,
traceCausticPhotons and tracePhoton, Scene.cpp:351-655, and its
PhotonMap, with the grid that the port documents in place of the
kd-tree, its RenderConfig's photon keys giving the sizes):
- emission: only directional-area lights emit, from a uniform point of
  the light's disc (radius sqrt(u0), angle 2 pi u1, in the frame of
  Utility.h's getTangents of its normal), along the normal, with power
  color * wattage * pi r^2, a tenth of it for a caustic photon;
- a batch of n photons (65,536 on the card, 10,000 on the CPU) takes its
  uniforms from one torch.Generator, in this order: the disc point
  (n, 2), the direction (n, 2, unused by this light), then for the
  depth + 1 levels the roulette (L, n), the diffuse bounce (L, n, 2)
  and the Fresnel draw (L, n);
- per level a closest hit from the photon's position moved EPSILON
  along its direction; Russian roulette over avg(kd), + avg(ks), +
  avg(kt); a diffuse hit is stored (the hit point, the incoming
  direction, the power) from the second level on; a caustic photon
  dies on a diffuse first bounce, a global one on a specular first
  bounce; a diffuse bounce leaves cosine-distributed about the shading
  normal (polar angle asin(sqrt(u0)), azimuth 2 pi u1, through
  alignHemisphereToVector's unnormalized tangents, Utility.h:34-50)
  with power kd * power / avg(kd); a specular one mirrors (Ray.h:160)
  or refracts (Ray.h:202-243) unless the Fresnel draw is below Rs
  (Ray.h:168-200);
- a map takes batches from each light until it has stored its target
  or spent photon_max_batches, keeps its first target photons (level by
  level within a batch, photons in order) and divides their power by
  the photons emitted;
- the gather radius r: the median, over min(n, 4000) photons drawn by
  numpy's RandomState(0), of the distance to the round(k m / n)-th
  nearest of them, clipped to [1e-4, 0.1] of the photons' diagonal;
- the grid: a photon's cell is floor(p / r) in float32; the cell's
  bucket ((x H1) ^ (y H2) ^ (z H3)) mod the table (the power of two at
  or above 4 n), in uint32 arithmetic; the photons in a stable order of
  their bucket; a bucket of c > max_per_cell = m photons keeps m of
  them, drawn by one numpy RandomState(0xC5E168) across the buckets in
  bucket order (choice(c, m, replace=False), sorted), each of weight
  c / m and its power rescaled per channel so that the bucket's total
  is kept; a coarse level is the same over every photon with the cell
  coarse_factor * r;
- the estimate at a point p with unit normal n, per level: the photons
  within the level's radius r of p; the k-th weighted distance, the
  squared distance at which their weights reach k; the disc r'^2 that
  12 halvings of [0, r^2] leave above it (each keeps the half whose
  midpoint lies past it; r^2 where the weights never reach k), the
  resolution the port documents for its gather; the power of the
  photons nearer than r'^2 that face the normal (dir . n < 0) over
  pi r'^2; the coarse level's estimate where the fine level holds less
  than k within r and the coarse level k; the maps' estimates added.

Departures from the port's code, none from these semantics:
- the k-th weighted distance is found by a sort of the distances, and
  the halvings run against that one number; the port counts the
  photons within each midpoint. The halvings are kept, not the k-th
  distance itself as the disc: the coarse level's cell is 8 r, so its
  12-halving grid is r^2 / 64 apart, and a weight of hundreds of photons
  a stored one puts a photon or two into that gap at many points (read
  on the CPU: estimates off by up to 2x where the coarse level serves).
- photons are found by their own cell among the 27 cells around p, not
  by hashed buckets, where two cells may share one. Within r of p both
  find the same photons: a photon within r lies in one of the 27 cells,
  and a bucket's photons past its first m carry no weight.
- the check builds the grids of the frames from the port's photons
  (Level, PhotonMap) and compares this tracer's own (trace_maps) with
  the port's only by their power (portbench/iterations/photon.py). The
  fold draws from one numpy stream bucket after bucket, so one photon a
  cell away shifts every later draw; at full size two independent traces
  part within the first few thousand photons (where both halves of a
  quad take a ray, below), and frames over such grids differ by their
  sampling noise.
- the hit points and normals where photon_term gathers are the port's
  to the bit: a small move there crosses a step of the halvings where
  photons are dense. So the tracer rounds as the port documents its
  float32 arithmetic (core/vecmath.py): each product and sum one IEEE
  operation in the C++ formulas' order; square roots correctly rounded
  on both devices (numpy's root on the CPU, whose torch root is not); a
  division by a constant as the product with its float32 reciprocal;
  the hit point from barycentrics against the face normal as
  Triangle.cpp:160-162 computes it, its interpolated normal normalized
  where the hit is made and again where a bounce or the gather reads
  it; the transcendentals over whole batches, since the CPU's vector and
  scalar kernels round differently. The closest hit is Triangle.cpp's
  test over intersect.py's clusters, not the port's traversal, whose
  Pluecker form rounds otherwise: where both halves of a quad accept a
  ray within EPSILON of their diagonal, the port takes the first its
  tree visits and this the lower index.
Everything runs in the reference's dtype but the host's hashing and
fold (float32 positions, float64 powers); in the control's bfloat16 the
photons, the grids and the gather points come out otherwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.intersect import BIG, _pairs
from portbench.reference.render import _cross
from portbench.reference.scene import EPSILON, TMAX, RefScene

PI = math.pi
HASH = (73856093, 19349663, 83492791)
FOLD_SEED = 0xC5E168
U32 = 0xFFFFFFFF
KEY_BITS = 21                 # bits a coordinate of a cell key holds


def batch_size(device) -> int:
    """Photons a batch emits: 65,536 on the card, 10,000 on the CPU."""
    return 65536 if torch.device(device).type == "cuda" else 10000


def _root(x):
    """The correctly rounded square root of a float32 tensor."""
    if x.is_cuda or x.dtype != torch.float32:
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def _dot(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def _normalize(a):
    return a * (1.0 / _root(torch.clamp(_dot(a, a), min=1e-30)))[..., None]


def _third(x):
    """avg() of a colour, (x0 + x1) + x2 times float32(1 / 3)."""
    return ((x[..., 0] + x[..., 1]) + x[..., 2]) * float(
        np.float32(1.0) / np.float32(3.0))


def _tangents(n):
    """Utility.h:25-31: t1 = z x n, or y x n where that is degenerate;
    t2 = t1 x n; neither normalized."""
    z = torch.zeros(3, dtype=n.dtype, device=n.device)
    y = z.clone()
    z[2], y[1] = 1.0, 1.0
    t1 = _cross(z.expand(n.shape), n)
    t1 = torch.where((_dot(t1, t1) < 1e-6)[..., None],
                     _cross(y.expand(n.shape), n), t1)
    return t1, _cross(t1, n)


def _fresnel_refract(d, n, ior):
    """(Rs with 1 past the critical angle, the refracted direction with
    the mirror's on total internal reflection, the mirror direction), as
    Ray.h:160-243 computes them, the n2 factor of the root missing from
    Rs as there."""
    entering = _dot(d, n) < 0.0
    one = torch.ones_like(ior)
    n1 = torch.where(entering, one, ior)
    n2 = torch.where(entering, ior, one)
    n_or = torch.where(entering[:, None], n, -n)
    cos_t = torch.clamp(_dot(-d, n_or), -1.0, 1.0)
    sin2 = (n1 / n2) ** 2 * (1.0 - cos_t ** 2)
    s2 = torch.clamp(1.0 - sin2, min=0.0)
    root = torch.where(s2 > 0, _root(torch.where(s2 > 0, s2, 1.0)), 0.0)
    den = n1 * cos_t + root
    rs = ((n1 * cos_t - root)
          / torch.where(den.abs() < 1e-20, 1e-20, den)) ** 2
    rs = torch.where(sin2 > 1.0, 1.0, rs)
    mirror = d - 2.0 * _dot(n, d)[:, None] * n
    dn = _dot(d, n_or)
    energy = 1.0 - (n1 ** 2) * (1.0 - dn ** 2) / (n2 ** 2)
    e = torch.clamp(energy, min=0.0)
    root_e = torch.where(e > 0, _root(torch.where(e > 0, e, 1.0)), 0.0)
    refr = (n1[:, None] * (d - n_or * dn[:, None]) / n2[:, None]
            - n_or * root_e[:, None])
    return rs, torch.where((energy < 0.0)[:, None], mirror, refr), mirror


@torch.no_grad()
def closest_hit(cl, o, d, pair_chunk: int = 1 << 14,
                ray_chunk: int = 1 << 13):
    """Triangle (N,) int64 of the closest hit of rays o, d, -1 on a
    miss, by Triangle.cpp:148-158's test: Cramer's barycentrics against
    the face normal e1 x e2, accepted within EPSILON outside each edge
    (beta, gamma >= -EPSILON, beta + gamma <= 1 + EPSILON), t in
    [0, TMAX]; the least t wins, the least triangle among equal t. The
    clusters of intersect.Clusters cull the pairs."""
    n = o.shape[0]
    best = torch.full((n,), BIG, dtype=o.dtype, device=o.device)
    tri = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    if n == 0:
        return tri
    zero = torch.zeros((), dtype=o.dtype, device=o.device)
    ray, clu = _pairs(cl, o, d, zero.expand(n),
                      torch.full_like(zero, TMAX).expand(n), ray_chunk)
    big = torch.iinfo(torch.int64).max
    for p0 in range(0, ray.shape[0], pair_chunk):
        r, c = ray[p0:p0 + pair_chunk], clu[p0:p0 + pair_chunk]
        ro, rd = o[r][:, None], d[r][:, None]                  # (P, 1, 3)
        v0, e1, e2 = cl.v0[c], cl.e1[c], cl.e2[c]              # (P, S, 3)
        ng = _cross(e1, e2)
        den = _dot(-rd, ng)
        tiny = den.abs() < 1e-30
        den = torch.where(tiny, 1.0, den)
        oa = ro - v0
        beta = _dot(-rd, _cross(oa, e2)) / den
        gamma = _dot(-rd, _cross(e1, oa)) / den
        t = _dot(oa, ng) / den
        ok = ((beta >= -EPSILON) & (gamma >= -EPSILON)
              & (beta + gamma <= 1.0 + EPSILON) & (t >= 0) & (t <= TMAX)
              & ~tiny & (cl.ids[c] >= 0))
        t = torch.where(ok, t, BIG)
        pt, lane = t.min(1)
        pid = cl.ids[c].gather(1, lane[:, None])[:, 0]
        prev = best
        best = best.scatter_reduce(0, r, pt, "amin")
        win = (pt == best[r]) & (pt < BIG)
        cand = torch.full_like(tri, big).scatter_reduce(
            0, r, torch.where(win, pid, big), "amin")
        tie = (cand != big) & (best == prev)
        tri = torch.where(best < prev, cand,
                          torch.where(tie, torch.minimum(tri, cand), tri))
    return torch.where(best < BIG, tri, -1)


class Tracer:
    """Photon tracing through one raw scene's triangles."""

    def __init__(self, raw: dict, scene: RefScene, clusters, device,
                 dtype=torch.float32):
        self.s, self.cl = scene, clusters
        self.device, self.dtype = device, dtype
        # the face normal e1 x e2 of the float32 edges, in float32
        self.ng = _cross(scene.e1, scene.e2)
        self.lights = []
        for light in raw["lights"]:
            if light["kind"] != "directional_area":
                continue
            nrm = np.asarray(light["normal"], np.float64)
            f = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                          device=device).to(dtype)
            self.lights.append(dict(
                position=f(light["position"]),
                normal=f(nrm / np.linalg.norm(nrm)),
                radius=f(light["radius"]), wattage=f(light["wattage"]),
                color=f(light.get("color", (1.0, 1.0, 1.0)))))

    def _surface(self, o, d, tri):
        """The hit point and the unit shading normal of rays o, d on
        triangles tri (Triangle.cpp:160-162)."""
        s = self.s
        v0, e1, e2 = s.v0[tri], s.e1[tri], s.e2[tri]
        den = _dot(-d, self.ng[tri])
        den = torch.where(den.abs() < 1e-30, 1.0, den)
        oa = o - v0
        beta = _dot(-d, _cross(oa, e2)) / den
        gamma = _dot(-d, _cross(e1, oa)) / den
        p = v0 + beta[:, None] * e1 + gamma[:, None] * e2
        n = ((1.0 - beta - gamma)[:, None] * s.n0[tri]
             + beta[:, None] * s.n1[tri] + gamma[:, None] * s.n2[tri])
        return p, _normalize(n)

    def batch(self, light: dict, caustic: bool, depth: int, n: int,
              gen: torch.Generator):
        """One batch of n photons from `light`: its stored photons
        (position, incoming direction, power), level by level, photons
        in order, and the uniforms drawn as the docstring lists them."""
        dev, dt = self.device, self.dtype
        draw = lambda *shape: torch.rand(shape, generator=gen,
                                         device=gen.device).to(dev)
        u_disc, _ = draw(n, 2), draw(n, 2)
        lv = depth + 1
        roulette, bounce, fresnel = draw(lv, n), draw(lv, n, 2), draw(lv, n)
        u_disc, roulette, bounce, fresnel = (
            x.to(dt) for x in (u_disc, roulette, bounce, fresnel))
        t1, t2 = (_normalize(t) for t in _tangents(light["normal"]))
        r = light["radius"] * _root(u_disc[:, 0])
        th = 2.0 * PI * u_disc[:, 1]
        pos = (light["position"] + (r * torch.cos(th))[:, None] * t1
               + (r * torch.sin(th))[:, None] * t2)
        d = light["normal"].expand(n, 3)
        area = PI * (light["radius"] * light["radius"])
        p0 = light["color"] * light["wattage"] * area
        if caustic:
            p0 = p0 * float(np.float32(1.0) / np.float32(10.0))
        power = p0.expand(n, 3)
        ids = torch.arange(n, device=dev)         # the photons alive
        s = self.s
        stored = []
        for level in range(lv):
            # the cosine bounce's angles, over the whole batch
            u = bounce[level]
            phi = torch.asin(_root(u[:, 0]))
            theta = 2.0 * PI * u[:, 1]
            sin_phi, cos_phi = torch.sin(phi), torch.cos(phi)
            cos_th, sin_th = torch.cos(theta), torch.sin(theta)
            o = pos + EPSILON * d
            tri = closest_hit(self.cl, o, d)
            hit = tri >= 0
            ids, o, d, power, tri = (x[hit] for x in (ids, o, d, power,
                                                       tri))
            p, nrm = self._surface(o, d, tri)
            mat = s.mat[tri]
            kd = s.kd[mat]
            p_diff = _third(kd)
            p_refl = p_diff + _third(s.ks[mat])
            p_refr = p_refl + _third(s.kt[mat])
            rnd = roulette[level][ids]
            diff = rnd < p_diff
            refl = (rnd >= p_diff) & (rnd < p_refl)
            refr = (rnd >= p_refl) & (rnd < p_refr)
            if level >= 1:
                stored.append((p[diff], d[diff], power[diff]))
            elif caustic:
                diff = torch.zeros_like(diff)
            else:
                refl = refr = torch.zeros_like(refl)
            # continuations (the normal read once more, normalized)
            nrm = _normalize(nrm)
            t_a, t_b = _tangents(nrm)
            sp = sin_phi[ids][:, None]
            cos_d = _normalize(sp * cos_th[ids][:, None] * t_a
                               + sp * sin_th[ids][:, None] * t_b
                               + cos_phi[ids][:, None] * nrm)
            rs, refr_d, mirror = _fresnel_refract(d, nrm, s.ior[mat])
            mirror = _normalize(mirror)
            refr_d = torch.where((fresnel[level][ids] < rs)[:, None],
                                 mirror, _normalize(refr_d))
            d = torch.where(diff[:, None], cos_d,
                            torch.where(refl[:, None], mirror, refr_d))
            power = torch.where(
                diff[:, None],
                kd * power / torch.clamp(p_diff, min=1e-12)[:, None], power)
            alive = diff | refl | refr
            ids, pos, d, power = ids[alive], p[alive], d[alive], power[alive]
        if not stored:
            empty = torch.zeros((0, 3), dtype=dt, device=dev)
            return empty, empty, empty
        return tuple(torch.cat([x[i] for x in stored]) for i in range(3))

    def map_photons(self, caustic: bool, target: int, depth: int,
                    max_batches: int, gen: torch.Generator):
        """A map's photons as numpy float32 (position, direction, power
        over the photons emitted), or None where none was stored."""
        n = batch_size(self.device)
        pos, dirs, pows = [], [], []
        emitted = 0
        for light in self.lights:
            stored, it = 0, 0
            while stored < target and it < max_batches:
                p, d, pw = self.batch(light, caustic, depth, n, gen)
                for out, x in ((pos, p), (dirs, d), (pows, pw)):
                    out.append(x.float().cpu().numpy())
                stored += p.shape[0]
                emitted += n
                it += 1
        keep = target * len(self.lights)
        pos = np.concatenate(pos)[:keep]
        if pos.shape[0] == 0:
            return None
        pows = np.concatenate(pows)[:keep] / max(emitted, 1)
        return pos, np.concatenate(dirs)[:keep], pows


def gather_radius(pos: np.ndarray, k: int) -> float:
    """The map's radius, as the module's docstring defines it."""
    n = pos.shape[0]
    if n < 8:
        return 1.0
    m = min(n, 4000)
    sub = pos[np.random.RandomState(0).choice(n, m, replace=False)]
    sub = sub.astype(np.float64)
    j = min(max(1, int(round(k * m / n))), m - 1)
    kth = np.empty(m)
    for r0 in range(0, m, 500):
        diff = sub[r0:r0 + 500, None, :] - sub[None, :, :]
        d2 = (diff[..., 0] ** 2 + diff[..., 1] ** 2) + diff[..., 2] ** 2
        kth[r0:r0 + 500] = np.sort(d2, axis=1)[:, j]
    kth = np.sort(np.sqrt(kth))
    r = (kth[(m - 1) // 2] + kth[m // 2]) / 2
    ext = pos.max(0) - pos.min(0)
    diag = float(np.sqrt(np.dot(ext, ext))) or 1.0
    return float(min(max(r, 1e-4 * diag), 0.1 * diag))


def cell_key(cells):
    """One integer a cell (..., 3) int64, its coordinates offset into
    KEY_BITS bits each."""
    c = cells + (1 << (KEY_BITS - 1))
    return (c[..., 0] << (2 * KEY_BITS)) | (c[..., 1] << KEY_BITS) | c[..., 2]


def near(keys, cells, per: int):
    """The rows of a table sorted by cell key (`keys`, (M,)) that lie in
    the 27 cells around each of `cells` (C, 3) int64, at most `per` a
    cell: (idx (C, 27 per), ok (C, 27 per)), idx 0 where not ok."""
    r = torch.arange(-1, 2, device=cells.device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       -1).reshape(27, 3)
    key = cell_key(cells[:, None, :] + offs)                   # (C, 27)
    lo = torch.searchsorted(keys, key)
    hi = torch.searchsorted(keys, key, right=True)
    idx = lo[..., None] + torch.arange(per, device=cells.device)
    ok = (idx < hi[..., None]).reshape(cells.shape[0], -1)
    return torch.where(ok, idx.reshape(cells.shape[0], -1), 0), ok


class Level:
    """One grid level as the gather reads it: the photons that carry
    weight, sorted by their cell."""

    def __init__(self, pos, dirs, pows, radius: float, max_per_cell: int,
                 device, dtype):
        n = pos.shape[0]
        cells = np.floor(pos / np.float32(radius)).astype(np.int64)
        table = 1 << max(int(np.ceil(np.log2(max(4 * n, 16)))), 4)
        u = cells & U32
        bucket = (((u[:, 0] * HASH[0]) & U32) ^ ((u[:, 1] * HASH[1]) & U32)
                  ^ ((u[:, 2] * HASH[2]) & U32)) % table
        order = np.argsort(bucket, kind="stable")
        b = bucket[order]
        first = np.flatnonzero(np.r_[True, b[1:] != b[:-1]])
        count = np.diff(np.r_[first, n])
        keep = np.ones(n, bool)
        weight = np.ones(n)
        power = pows[order].astype(np.float64)
        rng = np.random.RandomState(FOLD_SEED)
        m = max_per_cell
        for s, c in zip(first[count > m], count[count > m]):
            pick = s + np.sort(rng.choice(c, m, replace=False))
            keep[s:s + c] = False
            keep[pick] = True
            weight[pick] = c / m
            total, kept = power[s:s + c].sum(0), power[pick].sum(0)
            scale = np.where(kept > 0, total / np.where(kept > 0, kept, 1),
                             0.0)
            power[pick] = np.where(kept > 0, power[pick] * scale,
                                   np.where(total != 0, total / m, 0.0))
        sel = order[keep]
        cells = cells[sel]
        key = cell_key(cells)
        by = np.argsort(key, kind="stable")
        t = lambda x: torch.as_tensor(np.ascontiguousarray(x),
                                      device=device)
        self.key = t(key[by])
        self.pos = t(pos[sel][by].astype(np.float32)).to(dtype)
        self.dir = t(dirs[sel][by].astype(np.float32)).to(dtype)
        self.power = t(power[keep][by].astype(np.float32)).to(dtype)
        self.weight = t(weight[keep][by].astype(np.float32)).to(dtype)
        self.radius = t(np.float32(radius)).to(dtype)
        self.per_cell = int(np.max(np.unique(key, return_counts=True)[1]))

    def estimate(self, p, n, k: int, chunk: int = 8192):
        """(estimate (N, 3), weight within the radius (N,)) at points p
        with unit normals n."""
        r2 = self.radius * self.radius
        est, cnt = [], []
        for c0 in range(0, p.shape[0], chunk):
            pc, nc = p[c0:c0 + chunk], n[c0:c0 + chunk]
            base = torch.floor(pc / self.radius).to(torch.int64)
            idx, ok = near(self.key, base, self.per_cell)
            dd = self.pos[idx] - pc[:, None, :]
            d2 = (dd[..., 0] * dd[..., 0] + dd[..., 1] * dd[..., 1]) \
                + dd[..., 2] * dd[..., 2]
            inside = ok & (d2 < r2)
            w = torch.where(inside, self.weight[idx], 0.0)
            total = w.sum(-1)
            # the k-th weighted distance: distances in order, weights
            # accumulated, the first that reaches k (none: infinite)
            d2s, order = torch.sort(torch.where(inside, d2, math.inf), -1)
            reach = torch.cumsum(w.gather(1, order), -1) >= k
            at = reach.int().argmax(-1)
            kth = torch.where(reach.any(-1), d2s.gather(1, at[:, None])[:, 0],
                              math.inf)
            # the disc: 12 halvings of [0, r^2], each keeping the half
            # whose midpoint is past the k-th distance
            lo, hi = torch.zeros_like(kth), r2.expand(kth.shape).clone()
            for _ in range(12):
                mid = 0.5 * (lo + hi)
                past = mid > kth
                hi, lo = torch.where(past, mid, hi), torch.where(past, lo, mid)
            face = _dot(self.dir[idx], nc[:, None, :]) < 0.0
            take = inside & (d2 < hi[:, None]) & face
            pw = torch.where(take[..., None], self.power[idx], 0.0).sum(1)
            est.append(pw / (PI * hi)[:, None])
            cnt.append(total)
        if not est:
            return p.new_zeros((0, 3)), p.new_zeros((0,))
        return torch.cat(est), torch.cat(cnt)


class PhotonMap:
    """A map's two grid levels over its photons (position, direction,
    power)."""

    def __init__(self, photons, photon_conf: dict, device, dtype):
        pos, dirs, pows = photons
        k = int(photon_conf["photon_samples"])
        m = int(photon_conf["photon_grid_max_per_cell"])
        radius = gather_radius(pos, k)
        self.k = k
        self.fine = Level(pos, dirs, pows, radius, m, device, dtype)
        factor = float(photon_conf.get("photon_coarse_factor", 8.0))
        self.coarse = (Level(pos, dirs, pows, radius * factor, m, device,
                             dtype) if factor > 0 else None)

    def irradiance(self, p, n):
        e, cnt = self.fine.estimate(p, n, self.k)
        if self.coarse is not None:
            e_c, cnt_c = self.coarse.estimate(p, n, self.k)
            use = (cnt < self.k) & (cnt_c >= self.k)
            e = torch.where(use[:, None], e_c, e)
        return e


MAPS = ("global", "caustic")


def trace_maps(tracer: Tracer, photon_conf: dict, gen_state: torch.Tensor,
               gen_device) -> dict:
    """{"global", "caustic": (position, direction, power) numpy float32,
    or None}: each map's photons, the build's draws replayed from a
    generator of `gen_device` set to `gen_state`, the global map's
    batches first."""
    gen = torch.Generator(device=gen_device)
    gen.set_state(gen_state)
    depth = int(photon_conf["trace_depth_photons"])
    batches = int(photon_conf["photon_max_batches"])
    out = {}
    for name, key in zip(MAPS, ("photons_per_light",
                                "caustic_photons_per_light")):
        target = int(photon_conf[key])
        out[name] = (tracer.map_photons(name == "caustic", target, depth,
                                        batches, gen) if target > 0
                     else None)
    return out


def map_numbers(photons: dict) -> dict:
    """{"map_power": (2, 3) float64, each map's photon power summed
    (global, caustic; zeros for a map without photons), "map_stored":
    (2,) its photons}."""
    power = torch.zeros((2, 3), dtype=torch.float64)
    stored = torch.zeros(2, dtype=torch.int64)
    for i, name in enumerate(MAPS):
        if photons.get(name) is not None:
            pows = photons[name][2]
            power[i] = torch.as_tensor(pows.astype(np.float64).sum(0))
            stored[i] = pows.shape[0]
    return {"map_power": power, "map_stored": stored}


def camera_rays(cam: dict, xs, ys, width: int, height: int, device,
                dtype=torch.float32):
    """Origins and unit directions of the rays through pixel centres
    (xs, ys), Camera.cpp:103-127: w = -view, u = up x w, v = w x u, the
    image plane's half-height tan(fov / 2) (taken on the host in float32),
    u and v of a pixel left + (right - left) (x + 0.5) / width, in the
    port's float32 conventions."""
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    eye = f(cam["eye"])
    view = _normalize(f(cam["look_at"]) - eye)
    w = _normalize(-view)
    u_dir = _normalize(_cross(f(cam.get("up", (0.0, 1.0, 0.0))), w))
    v_dir = _cross(w, u_dir)
    half = PI / 180.0 / 2.0
    top = torch.tan(torch.tensor(float(cam["fov"])) * half).to(device)
    right = width / height * top
    left, bottom = -right, -top
    inv_w = float(np.float32(1.0) / np.float32(width))
    inv_h = float(np.float32(1.0) / np.float32(height))
    u = left + (right - left) * ((xs.to(torch.float32) + 0.5) * inv_w)
    v = bottom + (top - bottom) * ((ys.to(torch.float32) + 0.5) * inv_h)
    d = _normalize(u[:, None] * u_dir + v[:, None] * v_dir - w)
    o = eye.expand(d.shape)
    return o.to(dtype), d.to(dtype)


def photon_term(tracer: Tracer, maps: dict, o, d, depth: int):
    """(N, 3): what the maps add to each camera ray's radiance, the
    irradiance estimate at every hit on a diffuse material (kd > 0 in a
    channel) along the ray's specular tree, times the weight that reaches
    it (Scene.cpp:270-346, the estimate added to the direct term at
    Scene.cpp:286-299). The tree is the Whitted integrator's: every hit
    spawns a mirror child of weight ks + kt Rs [Rs > 0.01] and a
    refracted one of weight kt (1 - Rs), each offset EPSILON along its
    direction; a level keeps its children in order, mirror children
    first, up to twice the camera rays (the scene is refractive), for
    trace depth + 1 levels. The hit points and normals are the photon
    tracer's (Tracer._surface), so a gather point is where the port's
    is: the estimate is steep in it where photons are dense."""
    s = tracer.s
    maps = [m for m in maps.values() if m is not None]
    n0 = o.shape[0]
    capacity = 2 * n0
    lane = torch.arange(n0, device=o.device)
    weight = torch.ones_like(o)
    term = torch.zeros_like(o)
    for _ in range(depth + 1):
        if o.shape[0] == 0:
            break
        tri = closest_hit(tracer.cl, o, d)
        hit = tri >= 0
        o, d, weight, lane, tri = (x[hit] for x in (o, d, weight, lane,
                                                    tri))
        p, n = tracer._surface(o, d, tri)
        mat = s.mat[tri]
        diffuse = torch.nonzero((s.kd[mat] > 0).any(-1))[:, 0]
        if diffuse.numel():
            pd, nd = p[diffuse], _normalize(n[diffuse])
            irr = torch.zeros_like(pd)
            for m in maps:
                irr = irr + m.irradiance(pd, nd).to(irr.dtype)
            term = term.index_add(0, lane[diffuse], weight[diffuse] * irr)
        ks, kt = s.ks[mat], s.kt[mat]
        rs, refr, mirror = _fresnel_refract(d, n, s.ior[mat])
        zero = torch.zeros_like(ks)
        mw = (torch.where((ks > 0).any(-1)[:, None], ks, zero)
              + torch.where(((kt > 0).any(-1) & (rs > 0.01))[:, None],
                            kt * rs[:, None], zero))
        tw = torch.where((kt > 0).any(-1)[:, None], kt * (1.0 - rs[:, None]),
                         zero)
        dirs = torch.cat([_normalize(mirror), _normalize(refr)])
        ws = torch.cat([weight * mw, weight * tw])
        keep = torch.nonzero((ws > 0).any(-1))[:, 0][:capacity]
        d, weight = dirs[keep], ws[keep]
        o = torch.cat([p, p])[keep] + d * EPSILON
        lane = torch.cat([lane, lane])[keep]
    return term
