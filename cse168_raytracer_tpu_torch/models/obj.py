"""Wavefront OBJ loader with the reference's normal semantics.

Counterpart of cse168_raytracer_tpu/models/obj.py:27-233
(TriangleMeshLoad.cpp:114-311):
- vertices transformed by the CTM at load (TriangleMeshLoad.cpp:211);
- `vn` normals transformed by the CTM's inverse transpose and
  normalized (TriangleMeshLoad.cpp:176-190);
- faces read as triangles from their first three vertex tokens (the
  reference's `sscanf %s %s %s`, TriangleMeshLoad.cpp:222), indices as
  atoi reads them (a negative index is not resolved);
- a face without normal indices gets its face normal cross(e1, e2) on
  each corner, flagged as generated (TriangleMeshLoad.cpp:252-281);
- each vertex then averages all its neighbour normals, starting from
  the reference's default Vector3 (0, 1, 2) (Vector3.h:26-27), and the
  average replaces the generated ones only (TriangleMeshLoad.cpp:
  287-308).

`load_obj` runs the native parser, csrc/objloader.cpp, from the port's
own build of the library (ops/sah.load_native, which raises when the
build fails; the JAX package's csrc/libminiro.so is never loaded).
`load_obj_plain` is the same parser in Python, the plain version the
tests hold the native one against: it computes in double in the native
parser's order, so the two give the same bytes.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from cse168_raytracer_tpu_torch.ops import sah

_BOUND = set()   # ids of native libraries whose obj_* signatures are set


def _native():
    """The port's native library with the OBJ parser's signatures."""
    lib = sah.load_native()
    if id(lib) not in _BOUND:
        lib.obj_parse.restype = ctypes.c_void_p
        lib.obj_parse.argtypes = [ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_double)]
        for f in ("obj_num_vertices", "obj_num_normals",
                  "obj_num_texcoords", "obj_num_tris"):
            getattr(lib, f).restype = ctypes.c_int
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.obj_copy.restype = None
        lib.obj_copy.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
        lib.obj_free.restype = None
        lib.obj_free.argtypes = [ctypes.c_void_p]
        _BOUND.add(id(lib))
    return lib


def _ctms(ctm):
    ctm = np.eye(4) if ctm is None else np.asarray(ctm, np.float64)
    # normal transform: inverse transpose (TriangleMeshLoad.cpp:176-178)
    return (np.ascontiguousarray(ctm, np.float64),
            np.ascontiguousarray(np.linalg.inv(ctm).T, np.float64))


def load_obj(path: str, ctm: np.ndarray | None = None) -> dict:
    """Load an OBJ file through the native parser. Returns numpy arrays:
    vertices (V,3) f32, normals (N,3) f32, texcoords (TC,2) f32,
    tri_vidx / tri_nidx / tri_tidx (T,3) i32 (tidx -1 where absent).
    Raises FileNotFoundError naming a file that cannot be opened."""
    lib = _native()
    c, n = _ctms(ctm)
    dptr = ctypes.POINTER(ctypes.c_double)
    h = lib.obj_parse(path.encode(), c.ctypes.data_as(dptr),
                      n.ctypes.data_as(dptr))
    if not h:
        raise FileNotFoundError(path)
    try:
        nv, nn, nt, ntri = (getattr(lib, f"obj_num_{k}")(h) for k in
                            ("vertices", "normals", "texcoords", "tris"))
        out = {"vertices": np.empty((max(nv, 1), 3), np.float32),
               "normals": np.empty((max(nn, 1), 3), np.float32),
               "texcoords": np.empty((max(nt, 1), 2), np.float32),
               "tri_vidx": np.empty((max(ntri, 1), 3), np.int32),
               "tri_nidx": np.empty((max(ntri, 1), 3), np.int32),
               "tri_tidx": np.empty((max(ntri, 1), 3), np.int32)}
        lib.obj_copy(h, *(a.ctypes.data for a in out.values()))
    finally:
        lib.obj_free(h)
    counts = {"vertices": nv, "normals": nn, "texcoords": nt}
    return {k: a[:counts.get(k, ntri)] for k, a in out.items()}


def _face_token(tok: str) -> tuple[int, int, int]:
    """'v/t/n' -> (v, t, n), 0 where missing (atoi semantics,
    TriangleMeshLoad.cpp:82-111)."""
    parts = tok.split("/")
    get = lambda i: int(parts[i]) if len(parts) > i and parts[i] else 0
    return get(0), get(1), get(2)


def _xform(m, x, y, z, point: bool):
    """Rows of the 4x4 m (nested lists) times (x, y, z, point), each
    summed as the native parser sums it: m0 x + m1 y + m2 z (+ m3 for a
    point), left to right, in double."""
    return tuple((m[r][0] * x + m[r][1] * y + m[r][2] * z + m[r][3])
                 if point else (m[r][0] * x + m[r][1] * y + m[r][2] * z)
                 for r in range(3))


def _normalize(x, y, z):
    ln = math.sqrt(x * x + y * y + z * z)
    return (x / ln, y / ln, z / ln) if ln > 0 else (x, y, z)


def load_obj_plain(path: str, ctm: np.ndarray | None = None) -> dict:
    """load_obj's parser in Python (the plain version)."""
    c, nctm = (m.tolist() for m in _ctms(ctm))
    verts, normals, texcoords, fix = [], [], [], []
    tri_v, tri_n, tri_t = [], [], []
    neighbours: dict[int, list[int]] = {}
    with open(path, "r", errors="replace") as f:
        for line in f:
            toks = line.split()
            if line.startswith("vn"):
                normals.append(_normalize(*_xform(
                    nctm, *map(float, toks[1:4]), False)))
                fix.append(False)
            elif line.startswith("vt"):
                texcoords.append(tuple(map(float, toks[1:3])))
            elif line[:2] in ("v ", "v\t"):
                verts.append(_xform(c, *map(float, toks[1:4]), True))
            elif line.startswith("f") and len(toks) >= 4:
                vtn = [_face_token(t) for t in toks[1:4]]
                vi = [x[0] - 1 for x in vtn]
                tri_v.append(vi)
                tri_t.append([x[1] - 1 for x in vtn] if vtn[0][1]
                             else [-1, -1, -1])
                if vtn[2][2]:  # the reference checks the last token's n
                    ni = [x[2] - 1 for x in vtn]
                else:          # the face normal on each corner
                    a, b, d = (verts[i] for i in vi)
                    e1 = [b[k] - a[k] for k in range(3)]
                    e2 = [d[k] - a[k] for k in range(3)]
                    fn = _normalize(e1[1] * e2[2] - e1[2] * e2[1],
                                    e1[2] * e2[0] - e1[0] * e2[2],
                                    e1[0] * e2[1] - e1[1] * e2[0])
                    ni = [len(normals) + k for k in range(3)]
                    normals += [fn] * 3
                    fix += [True] * 3
                tri_n.append(ni)
                for k in range(3):
                    neighbours.setdefault(vi[k], []).append(ni[k])
    # the averaging pass, from (0, 1, 2) as the reference's accumulator
    for lst in neighbours.values():
        ax, ay, az = 0.0, 1.0, 2.0
        for i in lst:
            ax, ay, az = ax + normals[i][0], ay + normals[i][1], \
                az + normals[i][2]
        avg = _normalize(ax, ay, az)
        for i in lst:
            if fix[i]:
                normals[i] = avg
    f32 = lambda x, w: np.asarray(x, np.float64).astype(np.float32).reshape(
        -1, w)
    i32 = lambda x: np.asarray(x, np.int32).reshape(-1, 3)
    return {"vertices": f32(verts, 3), "normals": f32(normals, 3),
            "texcoords": f32(texcoords, 2), "tri_vidx": i32(tri_v),
            "tri_nidx": i32(tri_n), "tri_tidx": i32(tri_t)}


def make_ctm(translate=(0.0, 0.0, 0.0), rot_y: float = 0.0,
             scale=(1.0, 1.0, 1.0)) -> np.ndarray:
    """CTM = translate @ rotateY(rot_y radians) @ scale, as addModel
    builds it (Utility.cpp:14-20, column-vector Matrix4x4 ctor)."""
    if np.isscalar(scale):
        scale = (scale, scale, scale)
    s = np.diag([scale[0], scale[1], scale[2], 1.0])
    a = float(rot_y)
    r = np.array([[np.cos(a), 0, np.sin(a), 0],
                  [0, 1, 0, 0],
                  [-np.sin(a), 0, np.cos(a), 0],
                  [0, 0, 0, 1.0]])
    t = np.eye(4)
    t[:3, 3] = translate
    return t @ r @ s
