"""Scene geometry as structure-of-arrays dataclasses.

Counterpart of cse168_raytracer_tpu/models/geometry.py. The host-side
packing (`pack_triangles`, `build_pack_from_arrays`, `plucker_operands`)
is the same numpy code, so the packed arrays are byte-equal to the JAX
package's; the results become float32 tensors on the requested device.

For ray (o, d) with moment m = cross(o, d) and triangle
(A, e1 = B-A, e2 = C-A, n = cross(e1, e2)):
    den       = dot(-d, n)                         (Triangle.cpp:152)
    t * den   = dot(o, n) - dot(A, n)              (Triangle.cpp:154)
    beta*den  = dot(m, e2) + dot(d, cross(A, e2))  (Triangle.cpp:155)
    gamma*den = -dot(m, e1) + dot(d, cross(e1, A)) (Triangle.cpp:156)
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import resolve_device
from cse168_raytracer_tpu_torch.utils import profiling


class Mesh(NamedTuple):
    """Loaded OBJ mesh arrays in TriangleMesh.h's structure-of-arrays
    layout (JAX models/geometry.py:20 Mesh). models/obj.load_obj returns
    the same fields as a dict of numpy arrays."""
    vertices: torch.Tensor   # (V, 3) float32
    normals: torch.Tensor    # (N, 3) float32
    texcoords: torch.Tensor  # (TC, 2) float32 (may be empty)
    tri_vidx: torch.Tensor   # (T, 3) int32
    tri_nidx: torch.Tensor   # (T, 3) int32
    tri_tidx: torch.Tensor   # (T, 3) int32, -1 when absent


@dataclasses.dataclass
class TrianglePack:
    """All scene triangles padded to a block multiple; (T, ...) tensors."""
    v0: torch.Tensor           # (T, 3)
    e1: torch.Tensor           # (T, 3)
    e2: torch.Tensor           # (T, 3)
    n_geo: torch.Tensor        # (T, 3) unnormalized cross(e1, e2)
    n0: torch.Tensor           # (T, 3) corner shading normals
    n1: torch.Tensor
    n2: torch.Tensor
    t0: torch.Tensor           # (T, 2) corner texcoords (0 when absent)
    t1: torch.Tensor
    t2: torch.Tensor
    has_uv: torch.Tensor       # (T,) bool
    material_id: torch.Tensor  # (T,) int32
    w6: Optional[torch.Tensor]  # (6, T, 3) beta | gamma | den numerators
    w4: Optional[torch.Tensor]  # (4, T) t numerator
    valid: torch.Tensor        # (T,) bool, False for padding
    n_valid: int               # host-known count of valid triangles

    @property
    def num_tris(self) -> int:
        return self.v0.shape[0]

    def replace(self, **kw) -> "TrianglePack":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class SpherePool:
    """All spheres (Sphere.h/.cpp). n_valid: the host-known count of
    valid spheres; 0 lets ray casts skip the pool, None (unknown) scans
    it."""
    center: torch.Tensor       # (S, 3)
    radius: torch.Tensor       # (S,)
    material_id: torch.Tensor  # (S,) int32
    valid: torch.Tensor        # (S,) bool
    n_valid: Optional[int] = None


@dataclasses.dataclass
class PlanePool:
    """Infinite planes (Plane.h/.cpp), scanned outside the accelerator
    (Scene.cpp:219-230); n_valid as SpherePool's."""
    origin: torch.Tensor       # (P, 3)
    normal: torch.Tensor       # (P, 3)
    material_id: torch.Tensor  # (P,) int32
    valid: torch.Tensor        # (P,) bool
    n_valid: Optional[int] = None


@dataclasses.dataclass
class BLPatchPool:
    """Bilinear patches (JAX models/geometry.py:84-97; the reference's
    BLPatch intersect is a stub, BLPatch.cpp:19-24, and both packages
    implement it: ops/intersect.py:intersect_blpatches). Corners:
    S(u,v) = (1-u)(1-v) p00 + u(1-v) p10 + (1-u)v p01 + uv p11."""
    p00: torch.Tensor          # (B, 3)
    p10: torch.Tensor          # (B, 3)
    p01: torch.Tensor          # (B, 3)
    p11: torch.Tensor          # (B, 3)
    material_id: torch.Tensor  # (B,) int32
    valid: torch.Tensor        # (B,) bool

    def replace(self, **kw) -> "BLPatchPool":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "BLPatchPool":
        return BLPatchPool(**{f.name: getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)})


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    return np.concatenate([x, np.zeros((pad,) + x.shape[1:], x.dtype)], axis=0)


@profiling.phase("scene.build")
def pack_triangles(meshes: list[tuple[dict, int]], block: int = 128,
                   reorder: Optional[np.ndarray] = None,
                   device=None) -> TrianglePack:
    """TrianglePack from [(obj_dict, material_id), ...], concatenated,
    optionally reordered, and padded to a multiple of `block` with
    degenerate triangles (n_geo = 0, never hit)."""
    device = resolve_device(device)
    v0s, e1s, e2s, n0s, n1s, n2s, t0s, t1s, t2s, uvs, mats = \
        [], [], [], [], [], [], [], [], [], [], []
    for obj, mat_id in meshes:
        v = obj["vertices"].astype(np.float64)
        n = obj["normals"].astype(np.float64)
        tc = obj["texcoords"]
        vi = obj["tri_vidx"]
        ni = obj["tri_nidx"]
        ti = obj["tri_tidx"]
        a, b, c = v[vi[:, 0]], v[vi[:, 1]], v[vi[:, 2]]
        v0s.append(a)
        e1s.append(b - a)
        e2s.append(c - a)
        n0s.append(n[ni[:, 0]])
        n1s.append(n[ni[:, 1]])
        n2s.append(n[ni[:, 2]])
        uvs.append(ti[:, 0] >= 0)
        if tc.shape[0] > 0:
            tis = np.where(ti >= 0, ti, 0)
            t0s.append(tc[tis[:, 0]])
            t1s.append(tc[tis[:, 1]])
            t2s.append(tc[tis[:, 2]])
        else:
            z = np.zeros((vi.shape[0], 2), np.float32)
            t0s.append(z)
            t1s.append(z)
            t2s.append(z)
        mats.append(np.full((vi.shape[0],), mat_id, np.int32))

    v0 = np.concatenate(v0s)
    e1 = np.concatenate(e1s)
    e2 = np.concatenate(e2s)
    n0 = np.concatenate(n0s)
    n1 = np.concatenate(n1s)
    n2 = np.concatenate(n2s)
    t0 = np.concatenate(t0s).astype(np.float32)
    t1 = np.concatenate(t1s).astype(np.float32)
    t2 = np.concatenate(t2s).astype(np.float32)
    has_uv = np.concatenate(uvs)
    mat = np.concatenate(mats)

    t_count = v0.shape[0]
    if reorder is not None:
        perm = np.asarray(reorder)
        v0, e1, e2 = v0[perm], e1[perm], e2[perm]
        n0, n1, n2 = n0[perm], n1[perm], n2[perm]
        t0, t1, t2 = t0[perm], t1[perm], t2[perm]
        has_uv, mat = has_uv[perm], mat[perm]

    padded = ((t_count + block - 1) // block) * block
    arrs = [_pad_to(x, padded) for x in
            (v0, e1, e2, n0, n1, n2, t0, t1, t2, has_uv, mat)]
    valid = np.arange(padded) < t_count
    return build_pack_from_arrays(*arrs, valid, device=device)


def _cross(a, b):
    if isinstance(a, torch.Tensor):
        return torch.linalg.cross(a, b, dim=-1)
    return np.cross(a, b)


def plucker_operands(v0, e1, e2, n_geo=None):
    """The brute-force intersector's operands from raw triangle data:
    w6 (6, T, 3) rows [d(0:3), m(3:6)], columns [beta, gamma, den];
    w4 (4, T) for the t numerator. Takes numpy arrays or tensors."""
    xp = torch if isinstance(v0, torch.Tensor) else np
    if n_geo is None:
        n_geo = _cross(e1, e2)
    a_x_e2 = _cross(v0, e2)
    e1_x_a = _cross(e1, v0)
    zero = xp.zeros_like(e1[:, 0])
    w6 = xp.stack([
        xp.stack([a_x_e2[:, 0], e1_x_a[:, 0], -n_geo[:, 0]], -1),
        xp.stack([a_x_e2[:, 1], e1_x_a[:, 1], -n_geo[:, 1]], -1),
        xp.stack([a_x_e2[:, 2], e1_x_a[:, 2], -n_geo[:, 2]], -1),
        xp.stack([e2[:, 0], -e1[:, 0], zero], -1),
        xp.stack([e2[:, 1], -e1[:, 1], zero], -1),
        xp.stack([e2[:, 2], -e1[:, 2], zero], -1),
    ], 0)  # (6, T, 3)
    w4 = xp.stack([n_geo[:, 0], n_geo[:, 1], n_geo[:, 2],
                   -(v0 * n_geo).sum(-1)], 0)  # (4, T)
    return w6, w4


def build_pack_from_arrays(v0, e1, e2, n0, n1, n2, t0, t1, t2,
                           has_uv, mat, valid, device=None,
                           with_plucker: bool = True) -> TrianglePack:
    """Assemble a TrianglePack from host numpy arrays. n_geo and the
    Pluecker operands are computed in the inputs' precision and stored
    as float32, as in the JAX package. with_plucker=False leaves w6/w4
    out: the wide-BVH tables carry them instead."""
    device = resolve_device(device)
    n_geo = np.cross(e1, e2)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    w6 = w4 = None
    if with_plucker:
        w6n, w4n = plucker_operands(v0, e1, e2, n_geo=n_geo)
        w6, w4 = f32(w6n), f32(w4n)
    valid = np.asarray(valid, bool)
    return TrianglePack(
        v0=f32(v0), e1=f32(e1), e2=f32(e2), n_geo=f32(n_geo),
        n0=f32(n0), n1=f32(n1), n2=f32(n2),
        t0=f32(t0), t1=f32(t1), t2=f32(t2),
        has_uv=torch.as_tensor(np.asarray(has_uv, bool), device=device),
        material_id=torch.as_tensor(np.asarray(mat, np.int32),
                                    device=device),
        w6=w6, w4=w4,
        valid=torch.as_tensor(valid, device=device),
        n_valid=int(valid.sum()))


def pack_host_arrays(pack: TrianglePack) -> dict:
    """The pack's fields as host numpy arrays (for the host-side builds)."""
    return {f.name: getattr(pack, f.name).cpu().numpy()
            for f in dataclasses.fields(pack)
            if isinstance(getattr(pack, f.name), torch.Tensor)}


def make_sphere_pool(centers, radii, material_ids, device=None) -> SpherePool:
    device = resolve_device(device)
    centers = np.atleast_2d(np.asarray(centers, np.float32))
    radii = np.atleast_1d(np.asarray(radii, np.float32))
    mids = np.atleast_1d(np.asarray(material_ids, np.int32))
    t = lambda x: torch.as_tensor(x, device=device)
    return SpherePool(center=t(centers), radius=t(radii),
                      material_id=t(mids),
                      valid=torch.ones(len(radii), dtype=torch.bool,
                                       device=device),
                      n_valid=len(radii))


def make_plane_pool(origins, normals, material_ids, device=None) -> PlanePool:
    device = resolve_device(device)
    origins = np.atleast_2d(np.asarray(origins, np.float32))
    normals = np.atleast_2d(np.asarray(normals, np.float32))
    mids = np.atleast_1d(np.asarray(material_ids, np.int32))
    t = lambda x: torch.as_tensor(x, device=device)
    return PlanePool(origin=t(origins), normal=t(normals),
                     material_id=t(mids),
                     valid=torch.ones(origins.shape[0], dtype=torch.bool,
                                      device=device),
                     n_valid=origins.shape[0])


def make_blpatch_pool(p00, p10, p01, p11, material_ids,
                      device=None) -> BLPatchPool:
    """BLPatchPool of one patch per corner row (JAX models/geometry.py:
    269-274)."""
    device = resolve_device(device)
    f = lambda x: torch.as_tensor(np.atleast_2d(np.asarray(x, np.float32)),
                                  device=device)
    mids = np.atleast_1d(np.asarray(material_ids, np.int32))
    return BLPatchPool(p00=f(p00), p10=f(p10), p01=f(p01), p11=f(p11),
                       material_id=torch.as_tensor(mids, device=device),
                       valid=torch.ones(len(mids), dtype=torch.bool,
                                        device=device))


def empty_blpatch_pool(device=None) -> BLPatchPool:
    """One invalid patch (JAX models/geometry.py:277-282)."""
    pool = make_blpatch_pool(*([(0.0, 0.0, 0.0)] * 4), [0], device)
    pool.valid.zero_()
    return pool


def empty_sphere_pool(device=None) -> SpherePool:
    device = resolve_device(device)
    pool = make_sphere_pool([(0.0, 0.0, 0.0)], [1.0], [0], device)
    pool.valid.zero_()
    pool.n_valid = 0
    return pool


def empty_plane_pool(device=None) -> PlanePool:
    device = resolve_device(device)
    pool = make_plane_pool([(0.0, 0.0, 0.0)], [(0.0, 1.0, 0.0)], [0], device)
    pool.valid.zero_()
    pool.n_valid = 0
    return pool


def empty_triangle_pack(block: int = 128, device=None) -> TrianglePack:
    device = resolve_device(device)
    z3 = np.zeros((block, 3), np.float32)
    z2 = np.zeros((block, 2), np.float32)
    return build_pack_from_arrays(
        z3, z3, z3, z3, z3, z3, z2, z2, z2,
        np.zeros((block,), bool), np.zeros((block,), np.int32),
        np.zeros((block,), bool), device=device)
