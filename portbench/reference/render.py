"""A plain Whitted and sampled renderer, the benchmark's reference.

Semantics (the reference C++ tracer's, as the port documents them):
- camera (Camera.cpp:103-161): w = -view, u = up x w, v = w x u, image
  plane at distance 1 with half-height tan(fov / 2); a ray through
  (x + 0.5, y + 0.5), or a jittered point of the pixel; the thin lens
  moves the eye to a uniform point of the aperture disc and re-aims at
  the focus plane; row 0 is the bottom scanline;
- shading (Phong.cpp:44-161): per light a shadow ray from P + l eps;
  point lights fall off as 1 / (4 pi^2 r^2), a directional-area light
  shines along its normal with falloff 1 / pi on the points inside its
  disc's beam; diffuse term color * max(0, n.l falloff W) * kd * kd
  (the texture colour of a constant material is kd), plus the highlight
  max(0, min(1, e.r))^500 falloff W on every channel when the shininess
  is finite; in a scene with refractive materials a shadow ray's
  closest occluder, when refractive and facing the light, dims by n.l
  instead of blocking;
- recursion (Scene.cpp:270-346): every hit spawns a mirror child of
  weight ks + kt Rs [Rs > 0.01] and a refracted child of weight
  kt (1 - Rs) (total internal reflection: the mirror direction),
  offset by eps along their directions, trace depth + 1 levels; the
  children of a level are kept in order, mirror children first, up to
  a pool of the primary rays' count (twice that with refraction); a
  miss adds the background.
Gradients reach kd and the triangles' first vertices through the hit
point o + t d, t = (v0 - o).n / d.n (the hit triangle fixed); the
shading normal is the normalized interpolation of the vertex normals.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.intersect import BIG, Clusters, closest_hit
from portbench.reference.scene import (EPSILON, SHININESS_INF, TMAX,
                                       RefScene)

PI = math.pi


def block_order(width: int, height: int):
    """Pixel (x, y) of each ray, rays in 16 x 8 pixel blocks: blocks row
    by row, and inside a block row by row."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    order = np.lexsort((xs % 16, ys % 8, xs // 16, ys // 8))
    return xs[order], ys[order]


def _dot(a, b):
    return (a * b).sum(-1)


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _unit(a):
    return a / torch.sqrt(torch.clamp(_dot(a, a), min=1e-30))[..., None]


class Camera:
    def __init__(self, cam: dict, width: int, height: int, device, dtype):
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                      device=device).to(dtype)
        self.eye = t(cam["eye"])
        self.view = _unit(t(cam["look_at"]) - self.eye)
        up = t(cam.get("up", (0.0, 1.0, 0.0)))
        self.w = _unit(-self.view)
        self.u = _unit(_cross(up, self.w))
        self.v = _cross(self.w, self.u)
        self.top = math.tan(math.radians(cam["fov"]) / 2)
        self.right = width / height * self.top
        self.width, self.height = width, height

    def rays(self, xs, ys, jitter=None, lens=None, aperture=0.0,
             focus=0.0):
        """Origins and unit directions of rays through pixels (xs, ys)."""
        dt = self.eye.dtype
        xf, yf = xs.to(dt), ys.to(dt)
        jx, jy = (0.5, 0.5) if jitter is None else (jitter[:, 0].to(dt),
                                                    jitter[:, 1].to(dt))
        uc = -self.right + 2 * self.right * ((xf + jx) / self.width)
        vc = -self.top + 2 * self.top * ((yf + jy) / self.height)
        if aperture > 0:
            lens = lens.to(dt)
            r = aperture * torch.sqrt(lens[:, 0])
            th = 2 * PI * lens[:, 1]
            o = (self.eye + (r * torch.cos(th))[:, None] * self.u
                 + (r * torch.sin(th))[:, None] * self.v)
            w = _unit(o - (self.eye + self.view * focus))
        else:
            o = self.eye.expand(xs.shape[0], 3)
            w = self.w
        d = _unit(uc[:, None] * self.u + vc[:, None] * self.v - w)
        return o, d


def _fresnel_refract(d, n, ior):
    """(Rs, refracted direction with the mirror on total internal
    reflection), Ray.h:168-243 with its missing n2 factor."""
    dn = _dot(d, n)
    entering = dn < 0
    one = torch.ones_like(ior)
    n1 = torch.where(entering, one, ior)
    n2 = torch.where(entering, ior, one)
    n_or = torch.where(entering[:, None], n, -n)
    cos_t = torch.clamp(-_dot(d, n_or), -1.0, 1.0)
    ps = (n1 / n2) ** 2 * (1 - cos_t ** 2)
    sq = torch.sqrt(torch.clamp(1 - ps, min=0.0))
    den = n1 * cos_t + sq
    den = torch.where(den.abs() < 1e-20, torch.full_like(den, 1e-20), den)
    rs = torch.where(ps > 1, torch.ones_like(ps),
                     ((n1 * cos_t - sq) / den) ** 2)
    ddn = _dot(d, n_or)
    energy = 1 - n1 ** 2 * (1 - ddn ** 2) / n2 ** 2
    root = torch.sqrt(torch.clamp(energy, min=0.0))
    refr = (n1[:, None] * (d - n_or * ddn[:, None]) / n2[:, None]
            - n_or * root[:, None])
    mirror = d - 2 * _dot(n, d)[:, None] * n
    return rs, torch.where((energy < 0)[:, None], mirror, refr), mirror


class Renderer:
    """The reference renderer of one raw scene."""

    def __init__(self, scene: RefScene, device, dtype=torch.float32):
        self.s = scene
        self.cl = Clusters(scene.v0_host, scene.e1_host, scene.e2_host,
                           device, dtype)
        self.dtype = dtype
        self.device = device

    def _normal(self, tri, u, v):
        s = self.s
        n = ((1 - u - v)[:, None] * s.n0[tri] + u[:, None] * s.n1[tri]
             + v[:, None] * s.n2[tri])
        return _unit(n)

    def _hit(self, cache, key, o, d, tmin, tmax):
        """closest_hit, or its answer for `key` kept in `cache` (the rays
        of a key are the same in every call that passes the cache)."""
        if cache is not None and key in cache:
            return cache[key]
        out = closest_hit(self.cl, o, d, tmin, tmax)
        if cache is not None:
            cache[key] = out
        return out

    def _direct(self, p, n, mat, d, kd, cache=None, level=0):
        s = self.s
        kd_m = kd[mat]
        shin = s.shininess[mat]
        total = torch.zeros_like(p)
        for li, light in enumerate(s.lights):
            pos = torch.as_tensor(np.asarray(light["position"], np.float32),
                                  device=p.device).to(p.dtype)
            w = float(light["wattage"])
            col = torch.as_tensor(np.asarray(light.get("color", (1, 1, 1)),
                                             np.float32),
                                  device=p.device).to(p.dtype)
            if light["kind"] == "point":
                lvec = pos - p
                f2 = torch.clamp(_dot(lvec, lvec), min=1e-30)
                dist = torch.sqrt(f2)
                l = lvec / dist[:, None]
                falloff = 1.0 / (f2 * 4 * PI * PI)
                in_beam = torch.ones_like(dist, dtype=torch.bool)
            elif light["kind"] == "directional_area":
                nrm = np.asarray(light["normal"], np.float64)
                nrm = torch.as_tensor((nrm / np.linalg.norm(nrm))
                                      .astype(np.float32),
                                      device=p.device).to(p.dtype)
                l = (-nrm).expand(p.shape)
                dist = torch.ones_like(p[:, 0])
                falloff = torch.full_like(dist, 1.0 / PI)
                tb = -_dot(nrm, pos - p)
                beam = p - tb[:, None] * nrm - pos
                in_beam = _dot(beam, beam) <= float(light["radius"]) ** 2
            else:
                raise ValueError(f"unknown light kind {light['kind']!r}")
            ndl = _dot(n, l)
            live = ((ndl > 0) | (shin < SHININESS_INF)) & in_beam
            so = (p + l * EPSILON).detach()
            tmax = torch.where(live, dist.detach(), torch.full_like(dist, -1))
            t, tri, bu, bv = self._hit(cache, ("shadow", level, li), so,
                                       l.detach(), 0.0, tmax)
            occluded = t < BIG
            intensity = torch.ones_like(dist)
            if s.any_refractive:
                ot = torch.where(occluded, tri, torch.zeros_like(tri))
                refr = (s.kt[s.mat[ot]] > 0).any(-1)
                ondl = _dot(self._normal(ot, bu, bv), l)
                through = occluded & refr & (ondl >= EPSILON)
                intensity = torch.where(through, ondl, intensity)
                occluded = occluded & ~through
            visible = ~occluded & in_beam
            diff = torch.clamp(ndl * falloff * w, min=0.0)
            c = col * diff[:, None] * kd_m * kd_m * intensity[:, None]
            r = -l + 2 * _dot(l, n)[:, None] * n
            hl = torch.clamp(torch.clamp(_dot(-d, r), 0.0, 1.0) ** 500
                             * falloff * w, min=0.0)
            c = c + torch.where(shin < SHININESS_INF, hl,
                                torch.zeros_like(hl))[:, None]
            total = total + torch.where(visible[:, None], c,
                                        torch.zeros_like(c))
        return total

    def trace(self, o, d, kd, v0, depth: int, cache=None):
        """Radiance (N, 3) of each primary ray o, d (N, 3); kd (M, 3) and
        v0 (T, 3) may require grad. `cache` (a dict) keeps the hits of
        each level for the next call with the same rays and geometry:
        kd changes no ray."""
        s = self.s
        n0 = o.shape[0]
        capacity = n0 * (2 if s.any_refractive else 1)
        rad = torch.zeros((n0, 3), dtype=o.dtype, device=o.device)
        lane = torch.arange(n0, device=o.device)
        weight = torch.ones((n0, 3), dtype=o.dtype, device=o.device)
        bg = torch.zeros(3, dtype=o.dtype, device=o.device)
        for level in range(depth + 1 if s.can_spawn else 1):
            if o.shape[0] == 0:
                break
            t, tri, bu, bv = self._hit(cache, ("closest", level), o, d, 0.0,
                                       TMAX)
            hit = tri >= 0
            h = torch.nonzero(hit)[:, 0]
            miss = torch.nonzero(~hit)[:, 0]
            rad = rad.index_add(0, lane[miss], weight[miss] * bg)
            tri_h = tri[h]
            oh, dh = o[h], d[h]
            ng = _cross(s.e1[tri_h], s.e2[tri_h])
            tp = _dot(v0[tri_h] - oh, ng) / _dot(dh, ng)
            p = oh + tp[:, None] * dh
            n = self._normal(tri_h, bu[h], bv[h])
            mat = s.mat[tri_h]
            direct = self._direct(p, n, mat, dh, kd, cache, level)
            rad = rad.index_add(0, lane[h], weight[h] * direct)
            if not s.can_spawn:
                break
            ks, kt, ior = s.ks[mat], s.kt[mat], s.ior[mat]
            rs, refr_d, mirror_d = _fresnel_refract(dh, n, ior)
            zero = torch.zeros_like(ks)
            mw = (torch.where((ks > 0).any(-1)[:, None], ks, zero)
                  + torch.where(((kt > 0).any(-1) & (rs > 0.01))[:, None],
                                kt * rs[:, None], zero))
            tw = torch.where((kt > 0).any(-1)[:, None],
                             kt * (1 - rs[:, None]), zero)
            dirs = torch.cat([_unit(mirror_d), _unit(refr_d)])
            ws = torch.cat([weight[h] * mw, weight[h] * tw])
            keep = torch.nonzero((ws > 0).any(-1))[:, 0][:capacity]
            dirs, ws = dirs[keep], ws[keep]
            o = torch.cat([p, p])[keep] + dirs * EPSILON
            d, weight = dirs, ws
            lane = torch.cat([lane[h], lane[h]])[keep]
        return rad
