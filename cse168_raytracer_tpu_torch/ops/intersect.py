"""Batched ray-primitive intersection by brute force.

Counterpart of cse168_raytracer_tpu/ops/intersect.py. Triangles are
tested in the Pluecker form of models/geometry.py under the acceptance
rule of Triangle.cpp:158:

    reject if beta < -eps or gamma < -eps or beta+gamma > 1+eps
              or t < tMin or t > tMax or |den| < _DEN_TINY

(signed division by den = dot(-d, n), so back faces hit, as in the
reference). Spheres follow Sphere.cpp:27-69 (strict t bounds), planes
Plane.cpp:32-48, bilinear patches JAX ops/intersect.py:206-294 (the
reference's BLPatch is a stub). The winner selection is discrete and
detached: its continuous quantities are recomputed differentiably in
ops/surface.py. Only the patch t keeps its gradient, as in the JAX
package, whose patch intersection is plain array code.
This module is the oracle for the BVH traversal in ops/wide_bvh.py.
"""

from __future__ import annotations

import dataclasses

import torch

from cse168_raytracer_tpu_torch.config import EPSILON, MIRO_TMAX
from cse168_raytracer_tpu_torch.core.vecmath import cross, dot, sqrt_rn
from cse168_raytracer_tpu_torch.models.geometry import (BLPatchPool,
                                                        PlanePool, SpherePool,
                                                        TrianglePack,
                                                        plucker_operands)
from cse168_raytracer_tpu_torch.utils import profiling

PRIM_NONE = 0
PRIM_TRI = 1
PRIM_SPHERE = 2
PRIM_PLANE = 3
PRIM_BLPATCH = 4

_BIG = 3.0e37
_DEN_TINY = 1e-30


@dataclasses.dataclass
class Hit:
    """Wavefront hit record (SoA HitInfo, Ray.h:21-38)."""
    t: torch.Tensor          # (N,) float32, _BIG on a miss
    prim_type: torch.Tensor  # (N,) int32
    prim_id: torch.Tensor    # (N,) int32
    hit: torch.Tensor        # (N,) bool


def ray_bounds(o, *bounds) -> tuple:
    """Each of `bounds` (a ray interval's tmin or tmax: a number, a 0-d
    or an (N,) tensor) as a contiguous (N,) float32 tensor on o's device,
    N = o.shape[0]. A number is filled on the device, so nothing is
    copied from the host, which would block it; a tensor is broadcast,
    and copied only where it lives on another device (counted as the
    sync site ray_bounds)."""
    n = o.shape[0]

    def one(x):
        if not isinstance(x, torch.Tensor):
            return torch.full((n,), x, dtype=torch.float32, device=o.device)
        with profiling.sync("ray_bounds", o, n=int(x.device != o.device)):
            return torch.as_tensor(x, dtype=torch.float32,
                                   device=o.device).expand(n).contiguous()
    return tuple(one(x) for x in bounds)


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
    tmin, tmax = ray_bounds(o, tmin, tmax)
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
def detach_tri_hit(impl, pack, o, d, tmin, tmax, *extra):
    """Run a triangle closest-hit `impl` with no gradient (JAX
    ops/intersect.py:146 detach_tri_hit, its stop_gradient): a hit is a
    discrete choice, and ops/surface.py recomputes the winner's surface
    differentiably, so the traversal never enters autograd."""
    with torch.no_grad():
        return impl(pack, o.detach(), d.detach(), tmin, tmax, *extra)


def intersect_spheres(pool: SpherePool, o, d, tmin, tmax) -> Hit:
    """Quadratic-formula sphere intersection (Sphere.cpp:27-69)."""
    tmin, tmax = ray_bounds(o, tmin, tmax)
    tmin, tmax = tmin[:, None], tmax[:, None]
    to_o = o[:, None, :] - pool.center[None, :, :]        # (N, S, 3)
    a = dot(d, d)[:, None]
    b = 2.0 * dot(d[:, None, :], to_o)
    c = dot(to_o, to_o) - pool.radius[None, :] ** 2
    disc = b * b - 4.0 * a * c
    has_real = disc >= 0.0
    sq = sqrt_rn(torch.where(has_real, disc, 0.0))
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
    tmin, tmax = ray_bounds(o, tmin, tmax)
    tmin, tmax = tmin[:, None], tmax[:, None]
    ndotd = dot(d[:, None, :], pool.normal[None, :, :])
    safe = torch.where(ndotd.abs() < 1e-6, 1.0, ndotd)
    num = dot(pool.normal[None, :, :], pool.origin[None, :, :] - o[:, None, :])
    t = num / safe
    ok = ((ndotd.abs() >= 1e-6) & (t >= tmin) & (t <= tmax)
          & pool.valid[None, :])
    best_t, best_id = torch.where(ok, t, _BIG).min(1)
    return _hit(best_t, best_id, PRIM_PLANE)


def intersect_blpatches(pool: BLPatchPool, o, d, tmin, tmax) -> Hit:
    """Closest bilinear-patch hit of N rays against B patches (JAX
    ops/intersect.py:206-294, step for step). With S(u,v) = uv A + u B +
    v C + E (A = p11-p10-p01+p00, B = p10-p00, C = p01-p00, E = p00),
    cross(S - o, d) = 0 gives per component uv Ax + u Bx + v Cx + Qx = 0
    (X = cross(X3, d), Q = cross(E - o, d)); the two components off the
    largest |d| axis give a quadratic in v (linear where |qa| < 1e-12,
    with -1 as the second root), u from the better-conditioned of its
    two denominators, t from the largest |d| component. Both roots are
    tried; u and v within [-1e-5, 1 + 1e-5], t within [tmin, tmax]; the
    first patch wins a tie. The discriminant's root is sqrt_rn: where
    |qa| is small, one ulp of it moves the cancelling root's t by up to
    1e-3 relative, and PyTorch's float32 sqrt differs by an ulp between
    the card and the CPU.

    Dense over (N, B), as in the JAX package: about 5 N B 3 floats are
    alive at once (A, B, C, Q and a root's surface point), 240 MiB for
    262,144 rays and 16 patches, more under autograd, which keeps the
    intermediates for the gradient of t."""
    n = o.shape[0]
    tmin, tmax = ray_bounds(o, tmin, tmax)
    tmin, tmax = tmin[:, None], tmax[:, None]
    a3 = pool.p11 - pool.p10 - pool.p01 + pool.p00    # (B, 3)
    b3 = pool.p10 - pool.p00
    c3 = pool.p01 - pool.p00
    e3 = pool.p00
    nb = a3.shape[0]
    dN = d[:, None, :]
    A = cross(a3.expand(n, nb, 3), dN)
    B = cross(b3.expand(n, nb, 3), dN)
    C = cross(c3.expand(n, nb, 3), dN)
    Q = cross(e3[None] - o[:, None, :], dN)

    # the two components off the largest |d| axis
    k = torch.argmax(d.abs(), dim=-1)                  # (N,)
    i_idx = (k + 1) % 3
    j_idx = (k + 2) % 3

    def take(M, idx):
        return torch.gather(M, 2, idx[:, None, None].expand(n, nb, 1))[..., 0]

    Ai, Aj = take(A, i_idx), take(A, j_idx)
    Bi, Bj = take(B, i_idx), take(B, j_idx)
    Ci, Cj = take(C, i_idx), take(C, j_idx)
    Qi, Qj = take(Q, i_idx), take(Q, j_idx)

    qa = Ci * Aj - Cj * Ai
    qb = Ci * Bj + Qi * Aj - Cj * Bi - Qj * Ai
    qc = Qi * Bj - Qj * Bi

    disc = qb * qb - 4.0 * qa * qc
    has_real = disc >= 0.0
    sq = sqrt_rn(torch.where(has_real, disc, 0.0))
    lin = qa.abs() < 1e-12
    safe_qa = torch.where(lin, 1.0, qa)
    safe_qb = torch.where(qb.abs() < 1e-20, 1.0, qb)
    v_lin = -qc / safe_qb
    roots = [torch.where(lin, v_lin, (-qb - sq) / (2.0 * safe_qa)),
             torch.where(lin, torch.full_like(v_lin, -1.0),
                         (-qb + sq) / (2.0 * safe_qa))]

    eps = 1e-5
    best_t = torch.full((n, nb), _BIG, dtype=o.dtype, device=o.device)
    dk = torch.gather(d, 1, k[:, None])                # (N, 1)
    safe_dk = torch.where(dk.abs() < 1e-20, 1.0, dk)
    ok_pool = pool.valid[None, :]
    for v in roots:
        denom_u = v * Ai + Bi
        alt_den = v * Aj + Bj
        alt = alt_den.abs() > denom_u.abs()
        u = torch.where(
            alt, -(v * Cj + Qj) / torch.where(alt_den.abs() < 1e-20, 1.0,
                                              alt_den),
            -(v * Ci + Qi) / torch.where(denom_u.abs() < 1e-20, 1.0,
                                         denom_u))
        s = ((u * v)[..., None] * a3 + u[..., None] * b3
             + v[..., None] * c3 + e3)
        sk = take(s - o[:, None, :], k)
        t = sk / safe_dk
        ok = ((has_real | lin) & (u >= -eps) & (u <= 1 + eps)
              & (v >= -eps) & (v <= 1 + eps)
              & (t >= tmin) & (t <= tmax) & ok_pool)
        best_t = torch.where(ok & (t < best_t), t, best_t)

    bmin, barg = best_t.min(1)
    return _hit(bmin, barg, PRIM_BLPATCH)


def _merge(a: Hit, b: Hit) -> Hit:
    """Keep the closer hit (Scene.cpp:224: strict <, first wins ties)."""
    b_better = b.hit & (~a.hit | (b.t < a.t))
    return Hit(t=torch.where(b_better, b.t, a.t),
               prim_type=torch.where(b_better, b.prim_type, a.prim_type),
               prim_id=torch.where(b_better, b.prim_id, a.prim_id),
               hit=a.hit | b.hit)


def _miss(o) -> Hit:
    """The hit record of rays that hit nothing."""
    n = o.shape[0]
    zero = lambda dtype: torch.zeros((n,), dtype=dtype, device=o.device)
    return Hit(t=torch.full((n,), _BIG, dtype=o.dtype, device=o.device),
               prim_type=zero(torch.int32), prim_id=zero(torch.int32),
               hit=zero(torch.bool))


def _pool_passes(spheres: SpherePool, planes: PlanePool):
    """The (pool, intersect) passes a ray cast runs over the sphere and
    plane pools, in that order. A pool known to hold no valid primitive
    (n_valid == 0) cannot be hit, so its pass is skipped; the counters
    pool.skipped.<kind> / pool.scanned.<kind> count the passes."""
    passes = []
    for kind, pool, fn in (("spheres", spheres, intersect_spheres),
                           ("planes", planes, intersect_planes)):
        if pool.n_valid == 0:
            profiling.count("pool.skipped." + kind)
        else:
            profiling.count("pool.scanned." + kind)
            passes.append((pool, fn))
    return passes


def _then_pools(h: Hit | None, spheres, planes, o, d, tmin, tmax,
                blpatches=None) -> Hit:
    """The triangle hit h merged with the spheres, the plane list and
    the bilinear patches, in that order (Scene.cpp:214-231); h None
    starts from the first pool's hit."""
    for pool, fn in _pool_passes(spheres, planes):
        ph = fn(pool, o, d, tmin, tmax)
        h = ph if h is None else _merge(h, ph)
    if h is None:
        h = _miss(o)
    if blpatches is not None:
        h = _merge(h, intersect_blpatches(blpatches, o, d, tmin, tmax))
    return h


def _occluded_by_pools(occ, spheres, planes, o, d, tmin, tmax,
                       blpatches=None):
    """The triangles' occlusion occ or any sphere, plane or bilinear
    patch hit (the patches without a gradient)."""
    for pool, fn in _pool_passes(spheres, planes):
        occ = occ | fn(pool, o, d, tmin, tmax).hit
    if blpatches is not None:
        with torch.no_grad():
            occ = occ | intersect_blpatches(blpatches, o, d, tmin, tmax).hit
    return occ


def closest_hit(tris: TrianglePack, spheres: SpherePool, planes: PlanePool,
                o, d, tmin=0.0, tmax=MIRO_TMAX,
                blpatches: BLPatchPool | None = None) -> Hit:
    """Scene::trace by brute force (Scene.cpp:214-231): triangles, then
    spheres, then the unbounded plane list, then the bilinear patches
    (JAX ops/intersect.py:308-315). A pack or pool with no valid
    primitive is skipped."""
    h = intersect_triangles(tris, o, d, tmin, tmax) if tris.n_valid else None
    return _then_pools(h, spheres, planes, o, d, tmin, tmax, blpatches)
