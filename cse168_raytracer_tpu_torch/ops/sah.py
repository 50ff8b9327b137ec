"""Binned-SAH BVH build on the host.

Counterpart of cse168_raytracer_tpu/ops/sah.py:33-191: a ctypes bridge
to the native builder in the repository's shared csrc/bvh_builder.cpp,
plus the numpy builder with the same output contract.

The port builds its own copy of the library, from csrc's sources with
csrc/Makefile's flags, into _build/miniro-<hash>/libminiro.so. It does
not load csrc/libminiro.so: the JAX package's OBJ loader writes that
file from objloader.cpp alone when it is absent, and a process that has
once loaded a file at some path gets that same handle back from every
later load of the path, even after the file was rebuilt. A private path
keyed on the sources is loaded once and never rewritten. Output:

  * a re-ordered pack whose rows are leaf blocks of `leaf_cap`
    contiguous triangles, short leaves padded with degenerate rows;
  * nodes (Nn, 14) f32 [loL(3) hiL(3) loR(3) hiR(3) childL childR], a
    link >= 0 naming an internal node and a link < 0 the leaf ~link.

The numpy builder is a fallback only where the caller allows it: a
build for a CUDA scene requires the native builder and raises without
it, so a silent fallback cannot change a benchmark's tree.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import sys

import numpy as np

from cse168_raytracer_tpu_torch.models.geometry import (TrianglePack,
                                                        build_pack_from_arrays,
                                                        pack_host_arrays)
from cse168_raytracer_tpu_torch.utils import profiling

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_CSRC = os.path.join(_REPO, "csrc")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_SOURCES = ("objloader.cpp", "bvh_builder.cpp")
_CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None


def native_library_path() -> str:
    """Build csrc's sources into the port's own libminiro.so (once per
    content) and return its path. Raises OSError or CalledProcessError
    when the build fails."""
    digest = hashlib.sha256(" ".join(_CXXFLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as f:
            digest.update(f.read())
    out_dir = os.path.join(_BUILD, "miniro-" + digest.hexdigest()[:16])
    so = os.path.join(out_dir, "libminiro.so")
    os.makedirs(out_dir, exist_ok=True)
    # one builder at a time: test workers may all arrive here at once
    with open(os.path.join(out_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = so + f".{os.getpid()}.tmp"
            subprocess.run(["g++", *_CXXFLAGS,
                            *(os.path.join(_CSRC, s) for s in _SOURCES),
                            "-o", tmp], check=True, capture_output=True)
            os.replace(tmp, so)
    return so


def load_native():
    """Load the native SAH builder, building it first when absent.
    Raises OSError or CalledProcessError when that fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(native_library_path())
    lib.bvh_build.restype = ctypes.c_void_p
    lib.bvh_build.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int32] * 2
    for name in ("bvh_num_nodes", "bvh_num_leaves", "bvh_max_depth"):
        getattr(lib, name).restype = ctypes.c_int32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.bvh_export.restype = None
    lib.bvh_export.argtypes = [ctypes.c_void_p] * 3
    lib.bvh_free.restype = None
    lib.bvh_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _sah_native(lib, lo, hi, cent, leaf_cap):
    n = lo.shape[0]
    lo = np.ascontiguousarray(lo, np.float32)
    hi = np.ascontiguousarray(hi, np.float32)
    cent = np.ascontiguousarray(cent, np.float32)
    h = lib.bvh_build(lo.ctypes.data_as(ctypes.c_void_p),
                      hi.ctypes.data_as(ctypes.c_void_p),
                      cent.ctypes.data_as(ctypes.c_void_p),
                      np.int32(n), np.int32(leaf_cap))
    try:
        nn = lib.bvh_num_nodes(h)
        nl = lib.bvh_num_leaves(h)
        depth = lib.bvh_max_depth(h)
        nodes = np.empty((nn, 14), np.float32)
        leaf_tris = np.empty((nl * leaf_cap,), np.int32)
        lib.bvh_export(h, nodes.ctypes.data_as(ctypes.c_void_p),
                       leaf_tris.ctypes.data_as(ctypes.c_void_p))
    finally:
        lib.bvh_free(h)
    return nodes, leaf_tris.reshape(nl, leaf_cap), depth


def _sah_numpy(lo, hi, cent, leaf_cap):
    """Recursive median-split builder (same output contract)."""
    n = lo.shape[0]
    nodes = []
    leaves = []
    old = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old, 10000))
    max_depth = [0]

    def build(idx, depth):
        max_depth[0] = max(max_depth[0], depth)
        if idx.shape[0] <= leaf_cap:
            leaf_id = len(leaves)
            pad = np.full(leaf_cap, -1, np.int32)
            pad[:idx.shape[0]] = idx
            leaves.append(pad)
            return ~leaf_id
        c = cent[idx]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        mid = idx.shape[0] // 2
        part = np.argpartition(c[:, axis], mid)
        li, ri = idx[part[:mid]], idx[part[mid:]]
        node_id = len(nodes)
        nodes.append(None)
        cl = build(li, depth + 1)
        cr = build(ri, depth + 1)
        row = np.empty(14, np.float32)
        row[0:3] = lo[li].min(0)
        row[3:6] = hi[li].max(0)
        row[6:9] = lo[ri].min(0)
        row[9:12] = hi[ri].max(0)
        row[12] = cl
        row[13] = cr
        nodes[node_id] = row
        return node_id

    try:
        if n == 0:
            leaves.append(np.full(leaf_cap, -1, np.int32))
            row = np.full(14, 1e30, np.float32)
            row[12] = row[13] = float(~0)
            nodes.append(row)
        else:
            r = build(np.arange(n, dtype=np.int32), 0)
            if r < 0:
                row = np.full(14, 1e30, np.float32)
                row[0:3] = lo.min(0)
                row[3:6] = hi.max(0)
                row[12] = r
                leaves.append(np.full(leaf_cap, -1, np.int32))
                row[13] = float(~(len(leaves) - 1))
                nodes = [row]
    finally:
        sys.setrecursionlimit(old)
    return np.stack(nodes), np.stack(leaves), max_depth[0]


@profiling.phase("accel.sah")
def sah_build_and_reorder(pack: TrianglePack, leaf_cap: int = 32,
                          require_native: bool = True,
                          with_plucker: bool = True):
    """Build the SAH tree of `pack` and re-order the pack into leaf
    blocks. Returns (new_pack, nodes (Nn, 14) f32, n_leaves, max_depth).
    Padding rows are all-zero (den = 0, never hit) and valid=False.

    require_native=False allows the numpy builder when the native one
    cannot be built or loaded."""
    a = pack_host_arrays(pack)
    valid = a["valid"]
    v0 = a["v0"].astype(np.float64)[valid]
    e1 = a["e1"].astype(np.float64)[valid]
    e2 = a["e2"].astype(np.float64)[valid]
    orig_idx = np.nonzero(valid)[0]
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    lo = pts.min(axis=1).astype(np.float32)
    hi = pts.max(axis=1).astype(np.float32)
    cent = pts.mean(axis=1).astype(np.float32)

    try:
        lib = load_native()
    except (OSError, subprocess.CalledProcessError):
        if require_native:
            raise
        lib = None
    if lib is not None:
        nodes, leaf_tris, depth = _sah_native(lib, lo, hi, cent, leaf_cap)
    else:
        nodes, leaf_tris, depth = _sah_numpy(lo, hi, cent, leaf_cap)

    flat = leaf_tris.reshape(-1)
    pad = flat < 0
    src = orig_idx[np.clip(flat, 0, None)]

    def g3(name):
        x = a[name][src]
        x[pad] = 0
        return x

    new_pack = build_pack_from_arrays(
        g3("v0"), g3("e1"), g3("e2"), g3("n0"), g3("n1"), g3("n2"),
        g3("t0"), g3("t1"), g3("t2"),
        np.where(pad, False, a["has_uv"][src]),
        np.where(pad, 0, a["material_id"][src]),
        ~pad, device=pack.v0.device, with_plucker=with_plucker)
    return new_pack, nodes, leaf_tris.shape[0], depth
