"""Hit to shading surface (differentiable).

Counterpart of cse168_raytracer_tpu/ops/surface.py. Given the detached
winner (prim_type, prim_id), the primitive's continuous quantities are
recomputed so that gradients reach its data while the selection stays
discrete:
- triangle P = A + beta*e1 + gamma*e2 with the UNNORMALIZED interpolated
  normal (Triangle.cpp:160-162), UV by Cramer's rule with the
  reference's signed axis choice and >= 0 clamps (Triangle.cpp:172-222);
- sphere P = o + t*d, N = normalize(P - center) (Sphere.cpp:63-66),
  spherical UV (Sphere.cpp:83-95);
- plane N = plane normal, UV = (x, z) of P (Plane.cpp:50-60);
- bilinear patch (u, v) by 4 Newton steps from (0.5, 0.5), clipped,
  N = Su x Sv, and P re-derived on the tangent plane at S(u, v) (JAX
  ops/surface.py:200-240).

Triangle attributes come as the (N, 32) rows the traversal gathered
(ops/wide_bvh.py). `ReattachRows` gives them the gradient of the gather
they replace.
"""

from __future__ import annotations

import dataclasses

import torch

from cse168_raytracer_tpu_torch.config import PI
from cse168_raytracer_tpu_torch.core.fastgather import (select_component,
                                                        take_rows)
from cse168_raytracer_tpu_torch.core.vecmath import (cross, div_scalar, dot,
                                                     safe_normalize, sqrt_rn,
                                                     unit_axis)
from cse168_raytracer_tpu_torch.models.geometry import (BLPatchPool,
                                                        PlanePool, SpherePool,
                                                        TrianglePack)
from cse168_raytracer_tpu_torch.ops.intersect import (PRIM_BLPATCH,
                                                      PRIM_PLANE, PRIM_SPHERE,
                                                      PRIM_TRI, Hit)
from cse168_raytracer_tpu_torch.ops.segment_sum import segment_sum
from cse168_raytracer_tpu_torch.utils import profiling


@dataclasses.dataclass
class Surface:
    """Wavefront shading-point record."""
    p: torch.Tensor            # (N, 3) hit point
    n: torch.Tensor            # (N, 3) shading normal (normalized by shading)
    geo_n: torch.Tensor        # (N, 3) geometric normal (unnormalized)
    uv: torch.Tensor           # (N, 2)
    material_id: torch.Tensor  # (N,) int32
    hit: torch.Tensor          # (N,) bool


_FIELDS = ("v0", "e1", "e2", "n_geo", "n0", "n1", "n2", "t0", "t1", "t2")


def pack_attr_rows(pack: TrianglePack) -> torch.Tensor:
    """The (T, 29) attribute table: v0 e1 e2 n_geo n0 n1 n2 t0 t1 t2
    has_uv material_id."""
    return torch.cat([getattr(pack, f) for f in _FIELDS]
                     + [pack.has_uv[:, None].to(torch.float32),
                        pack.material_id[:, None].to(torch.float32)], 1)


class ReattachRows(torch.autograd.Function):
    """Gradient re-attachment for traversal-gathered attribute rows
    (cse168_raytracer_tpu/ops/surface.py _reattach_rows).

    Forward: the rows pass through. Backward: the VJP that
    `pack_attr_rows(pack)[ids]` would have, the row cotangents summed by
    triangle into an (n_rows, 29) table (ops/segment_sum.py: one fixed
    order on every device, no atomics) sliced back into the per-field
    gradients of v0 e1 e2 n_geo n0 n1 n2 t0 t1 t2."""

    @staticmethod
    def forward(ctx, rows, ids, n_rows, *fields):
        ctx.save_for_backward(ids)
        ctx.n_rows = n_rows
        return rows.clone()

    @staticmethod
    @profiling.traced("backward.reattach_rows")
    def backward(ctx, g):
        (ids,) = ctx.saved_tensors
        tab = segment_sum(g[:, :29], ids.long(), ctx.n_rows)
        widths = (3, 3, 3, 3, 3, 3, 3, 2, 2, 2)
        grads, c = [], 0
        for w in widths:
            grads.append(tab[:, c:c + w])
            c += w
        rows_grad = torch.zeros_like(g) if ctx.needs_input_grad[0] else None
        return (rows_grad, None, None, *grads)


def reattach_rows(pack: TrianglePack, rows, ids):
    return ReattachRows.apply(rows, ids, pack.num_tris,
                              *(getattr(pack, f) for f in _FIELDS))


def _tri_surface(pack: TrianglePack, o, d, tri_id, rows=None):
    if rows is not None:
        g = reattach_rows(pack, rows, tri_id)
    else:
        g = pack_attr_rows(pack)[tri_id.long()]      # (N, 29)
    v0, e1, e2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    n_geo = g[:, 9:12]
    n0, n1, n2 = g[:, 12:15], g[:, 15:18], g[:, 18:21]
    t0, t1, t2 = g[:, 21:23], g[:, 23:25], g[:, 25:27]
    has_uv = g[:, 27] > 0.5
    mat_id = torch.round(g[:, 28]).to(torch.int32)

    den = dot(-d, n_geo)
    safe_den = torch.where(den.abs() < 1e-30, 1.0, den)
    om_a = o - v0
    beta = dot(-d, cross(om_a, e2)) / safe_den
    gamma = dot(-d, cross(e1, om_a)) / safe_den
    p = v0 + beta[:, None] * e1 + gamma[:, None] * e2    # Triangle.cpp:160
    n = ((1.0 - beta - gamma)[:, None] * n0 + beta[:, None] * n1
         + gamma[:, None] * n2)                          # Triangle.cpp:162

    # UV (Triangle.cpp:190-221): discard the "largest" normal axis with
    # the reference's choice: i=0, j=1; if (n.x > n.z) i=2; else if
    # (n.y > n.z) j=2
    x_gt_z = n_geo[:, 0] > n_geo[:, 2]
    i_idx = torch.where(x_gt_z, 2, 0)
    j_idx = torch.where(x_gt_z, 1, torch.where(n_geo[:, 1] > n_geo[:, 2],
                                               2, 1))
    pv = p - v0
    take = select_component
    p_i, p_j = take(pv, i_idx), take(pv, j_idx)
    b_i, b_j = take(e1, i_idx), take(e1, j_idx)
    c_i, c_j = take(e2, i_idx), take(e2, j_idx)
    det_pc = p_i * c_j - c_i * p_j
    det_bp = b_i * p_j - p_i * b_j
    det_bc = b_i * c_j - c_i * b_j
    safe_bc = torch.where(det_bc.abs() < 1e-30, 1.0, det_bc)
    ub = torch.clamp(det_pc / safe_bc, min=0.0)
    ug = torch.clamp(det_bp / safe_bc, min=0.0)
    ua = torch.clamp(1.0 - (ub + ug), min=0.0)
    uv = ua[:, None] * t0 + ub[:, None] * t1 + ug[:, None] * t2
    # meshes without texcoords return (0,0) (Triangle.cpp:174-175)
    uv = torch.where(has_uv[:, None], uv, 0.0)
    return p, n, n_geo, uv, mat_id


def _sphere_surface(pool: SpherePool, o, d, t, sph_id):
    # the traversal's t is detached: recompute it from the quadratic so
    # d(P)/d(ray, center, radius) is exact, taking the root nearest t
    c = take_rows(pool.center, sph_id)
    r = take_rows(pool.radius, sph_id)
    oc = o - c
    a = dot(d, d)
    b = 2.0 * dot(d, oc)
    cc = dot(oc, oc) - r ** 2
    disc = b * b - 4.0 * a * cc
    root = torch.where(disc > 0,
                       sqrt_rn(torch.where(disc > 0, disc, 1.0)), 0.0)
    t0 = (-b - root) / (2.0 * a)
    t1 = (-b + root) / (2.0 * a)
    td = t.detach()
    t_re = torch.where((t0 - td).abs() <= (t1 - td).abs(), t0, t1)
    t_use = torch.where(disc > 0, t_re, t)
    p = o + t_use[:, None] * d
    n = p - c
    n_unit = safe_normalize(n)
    u = div_scalar(torch.atan2(n_unit[:, 0], n_unit[:, 2]), 2.0 * PI) + 0.5
    v = div_scalar(torch.clamp(torch.asin(torch.clamp(n_unit[:, 1], -1.0,
                                                      1.0)), -PI / 2, PI / 2),
                   PI) + 0.5
    return (p, n_unit, n, torch.stack([u, v], -1),
            take_rows(pool.material_id, sph_id))


def _plane_surface(pool: PlanePool, o, d, t, pl_id):
    nrm = take_rows(pool.normal, pl_id)
    org = take_rows(pool.origin, pl_id)
    ndotd = dot(nrm, d)
    safe = torch.where(ndotd.abs() < 1e-6, 1.0, ndotd)
    t_re = dot(nrm, org - o) / safe
    t_use = torch.where(ndotd.abs() >= 1e-6, t_re, t)
    p = o + t_use[:, None] * d
    uv = torch.stack([p[:, 0], p[:, 2]], -1)            # Plane.cpp:50-60
    return p, nrm, nrm, uv, take_rows(pool.material_id, pl_id)


def _blpatch_surface(pool: BLPatchPool, o, d, t, bp_id):
    """Shading data of the winning patch at the recorded t (JAX
    ops/surface.py:200-240): (u, v) of P = o + t d by 4 Newton steps on
    the bilinear system from the patch centre (2x2 normal equations of
    the Jacobian [Su, Sv]), clipped to [0, 1]; N = Su x Sv; P re-derived
    by projecting the ray onto the tangent plane at S(u, v), which
    restores dP/d(ray, corners) to first order."""
    p00 = take_rows(pool.p00, bp_id)
    p10 = take_rows(pool.p10, bp_id)
    p01 = take_rows(pool.p01, bp_id)
    a3 = take_rows(pool.p11, bp_id) - p10 - p01 + p00
    b3 = p10 - p00
    c3 = p01 - p00
    rhs = o + t[:, None] * d - p00
    u = torch.full_like(t, 0.5)
    v = torch.full_like(t, 0.5)
    for _ in range(4):
        su = v[:, None] * a3 + b3
        sv = u[:, None] * a3 + c3
        r = (u * v)[:, None] * a3 + u[:, None] * b3 + v[:, None] * c3 - rhs
        a11 = dot(su, su)
        a12 = dot(su, sv)
        a22 = dot(sv, sv)
        g1 = dot(su, r)
        g2 = dot(sv, r)
        det = a11 * a22 - a12 * a12
        det = torch.where(det.abs() < 1e-20, 1.0, det)
        u = u - (a22 * g1 - a12 * g2) / det
        v = v - (a11 * g2 - a12 * g1) / det
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    n = cross(v[:, None] * a3 + b3, u[:, None] * a3 + c3)
    s_uv = (u * v)[:, None] * a3 + u[:, None] * b3 + v[:, None] * c3 + p00
    ndotd = dot(n, d)
    safe = torch.where(ndotd.abs() < 1e-12, 1.0, ndotd)
    t_re = dot(n, (s_uv - o)) / safe
    t_use = torch.where(ndotd.abs() >= 1e-12, t_re, t)
    p = o + t_use[:, None] * d
    return (p, n, n, torch.stack([u, v], -1),
            take_rows(pool.material_id, bp_id))


def _pick(mask, a, b):
    """Per lane, the surface values (p, n, geo_n, uv, material id) of a
    where mask holds, else those of b."""
    m = mask[:, None]
    return (*(torch.where(m, x, y) for x, y in zip(a[:4], b[:4])),
            torch.where(mask, a[4], b[4]))


def make_surface(tris: TrianglePack, spheres: SpherePool, planes: PlanePool,
                 o, d, hit: Hit, tri_attr=None,
                 blpatches: BLPatchPool | None = None) -> Surface:
    """The Surface record of a wavefront, branch-free over primitive
    type. tri_attr: the traversal's (N, 32) rows, or None to gather
    from the pack; blpatches: the scene's patches, or None."""
    is_tri = hit.prim_type == PRIM_TRI
    tri_id = torch.where(is_tri, hit.prim_id, 0)
    # miss lanes carry t = _BIG: o + t*d would overflow, and inf forward
    # values NaN the backward pass even where masked
    t_safe = torch.where(hit.hit, hit.t, 1.0)

    tri = _tri_surface(tris, o, d, tri_id, rows=tri_attr)
    # a pool with no valid primitive (n_valid == 0) has no lane to
    # shade, so its branch is left out; the lanes that fall through to
    # the end are misses, pinned below, and carry the material id of
    # the plane pool's first row whether or not the planes are shaded
    if spheres.n_valid != 0:
        is_sph = hit.prim_type == PRIM_SPHERE
        sph = _sphere_surface(spheres, o, d, t_safe,
                              torch.where(is_sph, hit.prim_id, 0))
    if planes.n_valid != 0:
        pl_id = torch.where(hit.prim_type == PRIM_PLANE, hit.prim_id, 0)
        rest = _plane_surface(planes, o, d, t_safe, pl_id)
    else:
        rest = (0.0, 0.0, 0.0, 0.0, planes.material_id[0])
    if spheres.n_valid != 0:
        rest = _pick(is_sph, sph, rest)
    p, n, gn, uv, mat = _pick(is_tri, tri, rest)
    if blpatches is not None:
        is_bp = hit.prim_type == PRIM_BLPATCH
        bp_id = torch.where(is_bp, hit.prim_id, 0)
        p, n, gn, uv, mat = _pick(
            is_bp, _blpatch_surface(blpatches, o, d, t_safe, bp_id),
            (p, n, gn, uv, mat))
    # pin missed lanes to benign values (their garbage would NaN
    # gradients through later masked math)
    ok = hit.hit[:, None]
    up = unit_axis(1, p.dtype, p.device)
    return Surface(p=torch.where(ok, p, 0.0), n=torch.where(ok, n, up),
                   geo_n=torch.where(ok, gn, up),
                   uv=torch.where(ok, uv, 0.0),
                   material_id=mat.to(torch.int32), hit=hit.hit)
