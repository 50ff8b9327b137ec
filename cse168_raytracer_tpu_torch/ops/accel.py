"""Accelerator attachment and scene-level hit queries.

Counterpart of cse168_raytracer_tpu/ops/accel.py:133,237,247,414. The
port has one accelerator, the wide SAH BVH of ops/wide_bvh.py. "auto"
builds it 4 wide up to 300k triangles and 8 wide above (as the JAX
package picks its VMEM and HBM tiers at ops/accel.py:181); a scene with
no valid triangle gets no tree and traces only its spheres and planes.
The JAX package's A/B kinds (block, bvh, packet, pallas_sah, forest,
pallas) are ROADMAP item A17 and raise here.
"""

from __future__ import annotations

from cse168_raytracer_tpu_torch.config import MIRO_TMAX
from cse168_raytracer_tpu_torch.ops.intersect import (PRIM_TRI, _BIG, _hit,
                                                      _merge,
                                                      intersect_planes,
                                                      intersect_spheres)
from cse168_raytracer_tpu_torch.ops.wide_bvh import (WideBVH,
                                                     any_hit_triangles,
                                                     build_bvh4_sah,
                                                     closest_hit_triangles)

MAX_W4_TRIS = 300_000


def attach_accel(scene, kind: str = "auto"):
    """SAH-build the scene's triangles into a wide BVH on the scene's
    device and return the updated Scene (its pack re-ordered into leaf
    blocks)."""
    if kind != "auto":
        raise NotImplementedError(
            f"accel kind {kind!r}: only 'auto' (the wide SAH BVH) is "
            "ported; the A/B kinds are ROADMAP item A17")
    n_tris = scene.tris.n_valid
    if n_tris == 0:
        return scene.replace(accel=None)
    width = 4 if n_tris <= MAX_W4_TRIS else 8
    new_pack, bvh = build_bvh4_sah(scene.tris, width=width)
    return scene.replace(tris=new_pack, accel=bvh)


def supports_kernel_attr(accel) -> bool:
    """True when the traversal returns the winners' attribute rows."""
    return isinstance(accel, WideBVH)


def _check_accel(accel):
    if not isinstance(accel, WideBVH):
        raise NotImplementedError(
            f"accelerator {type(accel).__name__}: only WideBVH is ported")


def scene_closest_hit(accel, spheres, planes, o, d, tmin=0.0,
                      tmax=MIRO_TMAX, with_stats: bool = False):
    """Scene::trace with the tree (Scene.cpp:214-231): triangles through
    the traversal, then spheres and planes. Returns (Hit, attr), attr
    being the (N, 32) rows of the triangle winners; with_stats appends
    the traversal's per-ray box and triangle tests (N,) int32 (JAX
    ops/accel.py:247-283: spheres and planes are not counted)."""
    _check_accel(accel)
    t, ids, attr, *tests = closest_hit_triangles(accel, o, d, tmin, tmax,
                                                 with_stats)
    h = _hit(t, ids, PRIM_TRI)
    h = _merge(h, intersect_spheres(spheres, o, d, tmin, tmax))
    h = _merge(h, intersect_planes(planes, o, d, tmin, tmax))
    return (h, attr, *tests)


def scene_any_hit(accel, spheres, planes, o, d, tmin=0.0, tmax=MIRO_TMAX,
                  with_stats: bool = False):
    """Boolean shadow occlusion across all primitive pools; with_stats
    (occluded, box tests, triangle tests) as scene_closest_hit counts
    them (JAX ops/accel.py:414-449)."""
    _check_accel(accel)
    if with_stats:
        t, box, tri = any_hit_triangles(accel, o, d, tmin, tmax, True)
    else:
        t = any_hit_triangles(accel, o, d, tmin, tmax)
    occ = t < _BIG
    occ = occ | intersect_spheres(spheres, o, d, tmin, tmax).hit
    occ = occ | intersect_planes(planes, o, d, tmin, tmax).hit
    return (occ, box, tri) if with_stats else occ
