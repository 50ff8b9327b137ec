"""Batched ray-primitive intersection by brute force.

Counterpart of cse168_raytracer_tpu/ops/intersect.py. Triangles are
tested in the Pluecker form of models/geometry.py under the acceptance
rule of Triangle.cpp:158:

    reject if beta < -eps or gamma < -eps or beta+gamma > 1+eps
              or t < tMin or t > tMax or |den| < _DEN_TINY

(signed division by den = dot(-d, n), so back faces hit, as in the
reference). Spheres follow Sphere.cpp:27-69 (strict t bounds), planes
Plane.cpp:32-48. The winner selection is discrete and detached: its
continuous quantities are recomputed differentiably in ops/surface.py.
This module is the oracle for the BVH traversal in ops/wide_bvh.py.
"""

from __future__ import annotations

import dataclasses

import torch

from cse168_raytracer_tpu_torch.config import EPSILON, MIRO_TMAX
from cse168_raytracer_tpu_torch.core.vecmath import cross, dot
from cse168_raytracer_tpu_torch.models.geometry import (PlanePool, SpherePool,
                                                        TrianglePack,
                                                        plucker_operands)

PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPHERE = 2
PRIM_PLANE = 3

_BIG = 3.0e37
_DEN_TINY = 1e-30


@dataclasses.dataclass
class Hit:
    """Wavefront hit record (SoA HitInfo, Ray.h:21-38)."""
    t: torch.Tensor          # (N,) float32, _BIG on a miss
    prim_type: torch.Tensor  # (N,) int32
    prim_id: torch.Tensor    # (N,) int32
    hit: torch.Tensor        # (N,) bool


def _bounds(tmin, tmax, o):
    n = o.shape[0]
    as_t = lambda x: torch.as_tensor(x, dtype=o.dtype, device=o.device)
    return as_t(tmin).expand(n), as_t(tmax).expand(n)


def _hit(t, ids, prim_type) -> Hit:
    hit = t < _BIG
    kind = torch.where(hit, prim_type, PRIM_NONE).to(torch.int32)
    return Hit(t=t, prim_type=kind, prim_id=ids.to(torch.int32), hit=hit)


@torch.no_grad()
def intersect_triangles(pack: TrianglePack, o, d, tmin, tmax,
                        tri_block: int = 2048) -> Hit:
    """Closest hit of N rays against every triangle of `pack`, scanning
    blocks of `tri_block` triangles with a running (t, id) minimum."""
    n = o.shape[0]
    t_total = pack.num_tris
    if t_total % 128:
        raise ValueError("TrianglePack must be padded to 128")
    tb = min(tri_block, t_total)
    while t_total % tb:
        tb -= 128
    tmin, tmax = _bounds(tmin, tmax, o)
    if pack.w6 is None:
        w6, w4 = plucker_operands(pack.v0, pack.e1, pack.e2)
    else:
        w6, w4 = pack.w6, pack.w4
    r6 = torch.cat([d, cross(o, d)], -1)   # (N, 6)
    r4 = torch.cat([o, torch.ones_like(o[:, :1])], -1)          # (N, 4)
    best_t = torch.full((n,), _BIG, device=o.device)
    best_id = torch.zeros((n,), dtype=torch.int64, device=o.device)
    for base in range(0, t_total, tb):
        nums = (r6 @ w6[:, base:base + tb].reshape(6, tb * 3)).reshape(
            n, tb, 3)
        t_num = r4 @ w4[:, base:base + tb]
        den = nums[:, :, 2]
        safe = torch.where(den.abs() < _DEN_TINY, 1.0, den)
        inv = 1.0 / safe
        beta = nums[:, :, 0] * inv
        gamma = nums[:, :, 1] * inv
        t = t_num * inv
        ok = ((beta >= -EPSILON) & (gamma >= -EPSILON)
              & (beta + gamma <= 1.0 + EPSILON)
              & (t >= tmin[:, None]) & (t <= tmax[:, None])
              & (den.abs() >= _DEN_TINY) & pack.valid[None, base:base + tb])
        bmin, barg = torch.where(ok, t, _BIG).min(1)
        better = bmin < best_t
        best_t = torch.where(better, bmin, best_t)
        best_id = torch.where(better, barg + base, best_id)
    return _hit(best_t, best_id, PRIM_TRI)


@torch.no_grad()
def intersect_spheres(pool: SpherePool, o, d, tmin, tmax) -> Hit:
    """Quadratic-formula sphere intersection (Sphere.cpp:27-69)."""
    tmin, tmax = _bounds(tmin, tmax, o)
    tmin, tmax = tmin[:, None], tmax[:, None]
    to_o = o[:, None, :] - pool.center[None, :, :]        # (N, S, 3)
    a = dot(d, d)[:, None]
    b = 2.0 * dot(d[:, None, :], to_o)
    c = dot(to_o, to_o) - pool.radius[None, :] ** 2
    disc = b * b - 4.0 * a * c
    has_real = disc >= 0.0
    sq = torch.sqrt(torch.where(has_real, disc, 0.0))
    t0 = (-b - sq) / (2.0 * a)
    t1 = (-b + sq) / (2.0 * a)
    ok0 = (t0 > tmin) & (t0 < tmax)
    ok1 = (t1 > tmin) & (t1 < tmax)
    t = torch.where(ok0, t0, t1)
    ok = has_real & (ok0 | ok1) & pool.valid[None, :]
    best_t, best_id = torch.where(ok, t, _BIG).min(1)
    return _hit(best_t, best_id, PRIM_SPHERE)


@torch.no_grad()
def intersect_planes(pool: PlanePool, o, d, tmin, tmax) -> Hit:
    """Infinite-plane intersection (Plane.cpp:32-48)."""
    tmin, tmax = _bounds(tmin, tmax, o)
    tmin, tmax = tmin[:, None], tmax[:, None]
    ndotd = dot(d[:, None, :], pool.normal[None, :, :])
    safe = torch.where(ndotd.abs() < 1e-6, 1.0, ndotd)
    num = dot(pool.normal[None, :, :], pool.origin[None, :, :] - o[:, None, :])
    t = num / safe
    ok = ((ndotd.abs() >= 1e-6) & (t >= tmin) & (t <= tmax)
          & pool.valid[None, :])
    best_t, best_id = torch.where(ok, t, _BIG).min(1)
    return _hit(best_t, best_id, PRIM_PLANE)


def _merge(a: Hit, b: Hit) -> Hit:
    """Keep the closer hit (Scene.cpp:224: strict <, first wins ties)."""
    b_better = b.hit & (~a.hit | (b.t < a.t))
    return Hit(t=torch.where(b_better, b.t, a.t),
               prim_type=torch.where(b_better, b.prim_type, a.prim_type),
               prim_id=torch.where(b_better, b.prim_id, a.prim_id),
               hit=a.hit | b.hit)


def closest_hit(tris: TrianglePack, spheres: SpherePool, planes: PlanePool,
                o, d, tmin=0.0, tmax=MIRO_TMAX) -> Hit:
    """Scene::trace by brute force (Scene.cpp:214-231): triangles, then
    spheres, then the unbounded plane list. A pack with no valid
    triangle is skipped."""
    if tris.n_valid:
        h = intersect_triangles(tris, o, d, tmin, tmax)
        h = _merge(h, intersect_spheres(spheres, o, d, tmin, tmax))
    else:
        h = intersect_spheres(spheres, o, d, tmin, tmax)
    return _merge(h, intersect_planes(planes, o, d, tmin, tmax))
