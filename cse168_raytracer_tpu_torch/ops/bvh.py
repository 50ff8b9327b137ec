"""Implicit LBVH with a per-ray ordered walk (attach_accel kind "bvh").

Counterpart of cse168_raytracer_tpu/ops/bvh.py (BVH.cpp:60-339 build,
438-658 ordered traversal). The host build (`_leaf_boxes`, `_build_cbox`,
`build_bvh`) is the JAX package's numpy code, copied, so the arrays are
byte-equal: an implicit complete binary tree over the Morton-ordered
leaves of `leaf_size` triangles, internal node i with children 2i+1 and
2i+2, every internal node storing both children's boxes (cbox (P-1, 12)),
and each leaf's raw [v0 | e1 | e2] rows (leaf_tri (L, LEAF*9)).

The walk is plain PyTorch, as the JAX package computes it outside any
Pallas kernel: a wavefront of rays, each with a stack of (node, entry
t), every active ray popping one entry per step; an entry whose t lies
past the ray's best is dropped, an internal node pushes its children
far then near, a leaf tests its triangles from the raw vertices with
cross products (core/vecmath's single-op helpers, so card and CPU
agree). collect_stats counts internal-node visits and triangle tests
over the wavefront. Inputs are detached: hits are discrete selections.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import EPSILON, MIRO_TMAX
from cse168_raytracer_tpu_torch.core.vecmath import cross, dot
from cse168_raytracer_tpu_torch.models.geometry import (TrianglePack,
                                                        pack_host_arrays)
from cse168_raytracer_tpu_torch.ops.intersect import (PRIM_TRI, _BIG,
                                                      _DEN_TINY, Hit, _hit,
                                                      _occluded_by_pools,
                                                      _then_pools, ray_bounds)

_FAR = 1.0e30  # degenerate AABB placed at infinity: slab always fails


@dataclasses.dataclass
class BVHAccel:
    """Flattened implicit BVH over the Morton-ordered leaf blocks."""
    cbox: torch.Tensor      # (max(P-1,1), 12) f32: [lo_L, hi_L, lo_R, hi_R]
    leaf_tri: torch.Tensor  # (L, LEAF*9) f32: [v0 | e1 | e2] per triangle
    n_internal: int         # P - 1
    n_leaves: int           # L (node id = n_internal + leaf)
    leaf_size: int
    stack_depth: int


class TraversalStats(NamedTuple):
    node_visits: torch.Tensor  # () int64 internal-node visits
    tri_tests: torch.Tensor    # () int64 ray-triangle tests


def _leaf_boxes(pack: TrianglePack, leaf_size: int):
    """Per-leaf AABBs of a Morton-ordered pack; padding triangles are
    excluded, empty leaves get a degenerate box at _FAR."""
    a = pack_host_arrays(pack)
    v0 = a["v0"].astype(np.float64)
    e1 = a["e1"].astype(np.float64)
    e2 = a["e2"].astype(np.float64)
    valid = a["valid"]
    t = v0.shape[0]
    if t % leaf_size:
        raise ValueError(f"pack of {t} rows is not a multiple of the "
                         f"leaf size {leaf_size}")
    n_leaves = t // leaf_size
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)           # (T, 3, 3)
    lo_t = np.where(valid[:, None], pts.min(axis=1), _FAR)
    hi_t = np.where(valid[:, None], pts.max(axis=1), -_FAR)
    leaf_lo = lo_t.reshape(n_leaves, leaf_size, 3).min(axis=1)
    leaf_hi = hi_t.reshape(n_leaves, leaf_size, 3).max(axis=1)
    empty = ~valid.reshape(n_leaves, leaf_size).any(axis=1)
    leaf_lo = np.where(empty[:, None], _FAR, leaf_lo)
    leaf_hi = np.where(empty[:, None], _FAR, leaf_hi)
    return leaf_lo, leaf_hi, n_leaves


def _build_cbox(leaf_lo: np.ndarray, leaf_hi: np.ndarray):
    """Bottom-up AABB fit of the implicit complete tree. Returns
    (cbox (max(P-1,1), 12), n_internal, stack_depth)."""
    n_leaves = leaf_lo.shape[0]
    p = 1 << max(0, (n_leaves - 1).bit_length())             # next pow2
    n_internal = p - 1
    # box[n] over all 2P-1 nodes; leaves occupy [P-1, 2P-2]
    box_lo = np.full((2 * p - 1, 3), _FAR)
    box_hi = np.full((2 * p - 1, 3), _FAR)
    box_lo[p - 1:p - 1 + n_leaves] = leaf_lo
    box_hi[p - 1:p - 1 + n_leaves] = leaf_hi
    level_start = p - 1
    while level_start > 0:
        parent_start = (level_start - 1) // 2
        n_par = level_start - parent_start
        li = level_start + 2 * np.arange(n_par)
        lo_l, lo_r = box_lo[li], box_lo[li + 1]
        hi_l, hi_r = box_hi[li], box_hi[li + 1]
        both_empty = (lo_l[:, 0] >= _FAR) & (lo_r[:, 0] >= _FAR)
        # an empty child's hi = _FAR would raise the max: mask it first
        hi_l = np.where(lo_l[:, 0:1] >= _FAR, -_FAR, hi_l)
        hi_r = np.where(lo_r[:, 0:1] >= _FAR, -_FAR, hi_r)
        plo = np.minimum(lo_l, lo_r)
        phi = np.maximum(hi_l, hi_r)
        plo = np.where(both_empty[:, None], _FAR, plo)
        phi = np.where(both_empty[:, None], _FAR, phi)
        box_lo[parent_start:level_start] = plo
        box_hi[parent_start:level_start] = phi
        level_start = parent_start
    if n_internal > 0:
        ii = np.arange(n_internal)
        cbox = np.concatenate([
            box_lo[2 * ii + 1], box_hi[2 * ii + 1],
            box_lo[2 * ii + 2], box_hi[2 * ii + 2]], axis=1)  # (P-1, 12)
    else:
        cbox = np.full((1, 12), _FAR)
    return cbox, n_internal, max(2, p.bit_length() + 1)


def build_bvh(pack: TrianglePack, leaf_size: int = 8) -> BVHAccel:
    """The implicit LBVH of a Morton-ORDERED pack, on the pack's device.
    Padding triangles sort last and give degenerate leaves at _FAR."""
    leaf_lo, leaf_hi, n_leaves = _leaf_boxes(pack, leaf_size)
    cbox, n_internal, stack_depth = _build_cbox(leaf_lo, leaf_hi)
    a = pack_host_arrays(pack)
    leaf_tri = np.concatenate([
        a[k].astype(np.float64).reshape(n_leaves, leaf_size * 3)
        for k in ("v0", "e1", "e2")], axis=1)                 # (L, LEAF*9)
    dev = pack.v0.device
    return BVHAccel(
        cbox=torch.as_tensor(np.asarray(cbox, np.float32), device=dev),
        leaf_tri=torch.as_tensor(np.asarray(leaf_tri, np.float32),
                                 device=dev),
        n_internal=int(n_internal), n_leaves=int(n_leaves),
        leaf_size=int(leaf_size), stack_depth=int(stack_depth))


def _slab_enter(o, rcp, lo, hi, tmin, tmax):
    """Entry t and pass of the slab test (BVH.cpp:513-584 semantics;
    NaN from 0*inf leaves that axis unconstrained) of rays (..., 3)
    against boxes (..., 3)."""
    t0 = (lo - o) * rcp
    t1 = (hi - o) * rcp
    tn = torch.minimum(t0, t1)
    tf = torch.maximum(t0, t1)
    tn = torch.where(torch.isnan(tn), -torch.inf, tn)
    tf = torch.where(torch.isnan(tf), torch.inf, tf)
    enter = torch.maximum(tn.amax(-1), tmin)
    exit_ = torch.minimum(tf.amin(-1), tmax)
    return enter, enter <= exit_


def _leaf_intersect(rows, o, d, m, tmin, tmax, k):
    """The nearest accepted triangle of each ray's gathered leaf rows
    (R, k*9), from the raw vertices (Triangle.cpp:152-158). Returns
    (t (R,), _BIG when none; lane (R,))."""
    r = rows.shape[0]
    v0 = rows[:, 0:3 * k].reshape(r, k, 3)
    e1 = rows[:, 3 * k:6 * k].reshape(r, k, 3)
    e2 = rows[:, 6 * k:9 * k].reshape(r, k, 3)
    n_geo = cross(e1, e2)
    dn, mn = d[:, None, :], m[:, None, :]
    den = -dot(dn, n_geo)
    beta_num = dot(mn, e2) + dot(dn, cross(v0, e2))
    gamma_num = -dot(mn, e1) + dot(dn, cross(e1, v0))
    t_num = dot(o[:, None, :] - v0, n_geo)
    tiny = den.abs() < _DEN_TINY
    inv = 1.0 / torch.where(tiny, 1.0, den)
    beta, gamma, tt = beta_num * inv, gamma_num * inv, t_num * inv
    ok = ((beta >= -EPSILON) & (gamma >= -EPSILON)
          & (beta + gamma <= 1.0 + EPSILON)
          & (tt >= tmin[:, None]) & (tt <= tmax[:, None]) & ~tiny)
    return torch.where(ok, tt, _BIG).min(1)


@torch.no_grad()
def bvh_closest_hit_triangles(accel: BVHAccel, o, d, tmin, tmax,
                              collect_stats: bool = False,
                              any_hit: bool = False):
    """Ordered stack walk of a wavefront of rays. Returns (t (N,), _BIG on
    a miss; id (N,) int32 = Morton pack row); with any_hit the walk of a
    ray ends at its first accepted triangle. collect_stats appends
    TraversalStats over the wavefront."""
    o, d = o.detach(), d.detach()
    tmin, tmax = ray_bounds(o, tmin, tmax)
    n, s, dev = o.shape[0], accel.stack_depth, o.device
    ni, k = accel.n_internal, accel.leaf_size
    rcp = 1.0 / d
    m = cross(o, d)
    stack_i = torch.zeros((n, s), dtype=torch.int64, device=dev)  # root 0
    stack_t = torch.zeros((n, s), dtype=torch.float32, device=dev)
    sp = (tmax >= tmin).to(torch.int64)
    best = torch.full((n,), _BIG, device=dev)
    best_id = torch.zeros((n,), dtype=torch.int64, device=dev)
    nv = torch.zeros((), dtype=torch.int64, device=dev)
    tt = torch.zeros((), dtype=torch.int64, device=dev)
    while True:
        act = torch.nonzero(sp > 0)[:, 0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack_i[act, sp[act]]
        ten = stack_t[act, sp[act]]
        cur = torch.minimum(tmax[act], best[act])
        proc = ten <= cur
        inner = proc & (node < ni)
        outer = proc & (node >= ni)
        if collect_stats:
            nv += inner.sum()
            tt += outer.sum() * k

        ia = act[inner]
        if ia.numel():
            nodes = node[inner]
            cb = accel.cbox[nodes]                          # (M, 12)
            oo, rr, lo, hi = o[ia], rcp[ia], tmin[ia], cur[inner]
            t_l, h_l = _slab_enter(oo, rr, cb[:, 0:3], cb[:, 3:6], lo, hi)
            t_r, h_r = _slab_enter(oo, rr, cb[:, 6:9], cb[:, 9:12], lo, hi)
            l_near = t_l <= t_r
            near_i = torch.where(l_near, 2 * nodes + 1, 2 * nodes + 2)
            far_i = torch.where(l_near, 2 * nodes + 2, 2 * nodes + 1)
            near_t = torch.where(l_near, t_l, t_r)
            far_t = torch.where(l_near, t_r, t_l)
            near_h = torch.where(l_near, h_l, h_r)
            far_h = torch.where(l_near, h_r, h_l)
            base = sp[ia]
            if bool(((base + far_h.long() + near_h.long()) > s).any()):
                raise RuntimeError("bvh walk: stack overflow")
            for idx, tv, h, at in ((far_i, far_t, far_h, base),
                                   (near_i, near_t, near_h,
                                    base + far_h.long())):
                stack_i[ia[h], at[h]] = idx[h]
                stack_t[ia[h], at[h]] = tv[h]
            sp[ia] = base + far_h.long() + near_h.long()

        la = act[outer]
        if la.numel():
            leaf = (node[outer] - ni).clamp(0, accel.n_leaves - 1)
            lt, lj = _leaf_intersect(accel.leaf_tri[leaf], o[la], d[la],
                                     m[la], tmin[la], cur[outer], k)
            better = lt < best[la]
            best[la] = torch.where(better, lt, best[la])
            best_id[la] = torch.where(better, leaf * k + lj, best_id[la])
            if any_hit:
                # the first accepted hit occludes (Phong.cpp:97)
                sp[la[better]] = 0
    out = (best, best_id.to(torch.int32))
    if collect_stats:
        return out + (TraversalStats(node_visits=nv, tri_tests=tt),)
    return out


def bvh_closest_hit(accel: BVHAccel, tris, spheres, planes, o, d,
                    tmin=0.0, tmax=MIRO_TMAX, blpatches=None) -> Hit:
    """Scene::trace through the hierarchical accelerator's walk, then
    spheres, planes and the bilinear patches (JAX ops/bvh.py:342
    bvh_closest_hit). `tris` is the pack `accel` was built from."""
    t, ids = bvh_closest_hit_triangles(accel, o, d, tmin, tmax)
    return _then_pools(_hit(t, ids, PRIM_TRI), spheres, planes, o, d, tmin,
                       tmax, blpatches)


def bvh_any_hit(accel: BVHAccel, tris, spheres, planes, o, d,
                tmin=0.0, tmax=MIRO_TMAX, blpatches=None) -> torch.Tensor:
    """(N,) bool shadow occlusion through the BVH walk and every other
    pool, with no gradient (JAX ops/bvh.py:358 bvh_any_hit)."""
    with torch.no_grad():
        t = bvh_closest_hit_triangles(accel, o, d, tmin, tmax,
                                      any_hit=True)[0]
        return _occluded_by_pools(t < _BIG, spheres, planes, o, d, tmin,
                                  tmax, blpatches)
