"""Binary SAH BVH (attach_accel kind "pallas_sah"): host build, CUDA walk
(kernel K5), plain version.

Counterpart of the PallasBVH half of cse168_raytracer_tpu/ops/
pallas_bvh.py: `BinaryBVH` is its PallasBVH (:143), `build_binary_bvh_sah`
its build_pallas_bvh_sah (:211) and `build_binary_bvh` its implicit-LBVH
build_pallas_bvh (:231), with the same numpy code so the arrays are
byte-equal: cbox (Nn, 16) f32 [loL hiL loR hiR childL childR pad2], a
child link >= 0 naming an internal node and < 0 the leaf ~link, and the
leaf table of ops/wide_bvh.py.

Traversal (`closest_hit_triangles`, `any_hit_triangles`, each with
`with_stats`) runs the hand-written CUDA kernel csrc/traverse_binary.cu
on CUDA tensors; it replaces the Pallas kernel `_traverse_one`
(pallas_bvh.py:276) in its closest-hit, any-hit and with_stats modes. On
CPU tensors the same entry points run `walk_binary_plain`, the kernel's
walk vectorized over rays. For a CUDA tensor a wrapper launches the
kernel or raises; it never falls back to the plain version.

The walk is the Pallas kernel's ordered descent for one ray (each
thread walks its own ray, where the TPU walks a 256-ray tile): stack
entries carry the child's entry t and are dropped when popped past the
ray's best, the far child is pushed first, and boxes are widened by
BOX_PAD as in ops/wide_bvh.py. The kernel is the card walk of
ops/wide_bvh.py for the binary tree: the warp tests the leaves its lanes
reach together, and each thread's stack of (link, entry t) slots lives in
shared memory (`_stack_smem_bytes`). Counts are each ray's own walk: box
tests = 2 x internal visits, triangle tests = K x leaf visits
(pallas_bvh.py:570-574). Inputs are detached: hits are discrete
selections.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.core.vecmath import cross
from cse168_raytracer_tpu_torch.models.geometry import (TrianglePack,
                                                        pack_host_arrays,
                                                        plucker_operands)
from cse168_raytracer_tpu_torch.ops import cuda_build
from cse168_raytracer_tpu_torch.ops.bvh import _build_cbox, _leaf_boxes
from cse168_raytracer_tpu_torch.ops.intersect import _BIG, ray_bounds
from cse168_raytracer_tpu_torch.ops.wide_bvh import (K, _after_launch,
                                                     _error_word, _leaf_test,
                                                     _leafW_from_pack,
                                                     _padded_entry, _route,
                                                     check_launch)
from cse168_raytracer_tpu_torch.utils import profiling

# the counters of kernel launches by mode, launch.binary.<mode>, counted
# where the wrapper launches the kernel
LAUNCH = "launch.binary"
profiling.declare(LAUNCH, ("closest", "any", "stats_closest", "stats_any"))


@dataclasses.dataclass
class BinaryBVH:
    """A binary BVH in the Pallas kernel's layout."""
    cbox: torch.Tensor   # (Nn, 16) f32 [loL hiL loR hiR childL childR pad2]
    leafW: torch.Tensor  # (L, 16, 4K) f32 Pluecker operands, planar groups
    n_nodes: int
    n_leaves: int
    stack_depth: int


def _leafW(pack: TrianglePack, n_leaves: int) -> np.ndarray:
    a = pack_host_arrays(pack)
    if pack.w6 is not None:
        w6, w4 = a["w6"], a["w4"]
    else:
        w6, w4 = plucker_operands(a["v0"], a["e1"], a["e2"],
                                  n_geo=a["n_geo"])
    return _leafW_from_pack(np.asarray(w6, np.float32),
                            np.asarray(w4, np.float32), n_leaves)


def build_binary_bvh_sah(pack: TrianglePack,
                         require_native: bool | None = None):
    """SAH build (ops/sah.py): returns (leaf-ordered pack without w6/w4,
    BinaryBVH) on the pack's device. require_native defaults to True for
    a CUDA pack (see ops/sah.py)."""
    from cse168_raytracer_tpu_torch.ops.sah import sah_build_and_reorder
    device = pack.v0.device
    if require_native is None:
        require_native = device.type == "cuda"
    new_pack, nodes14, n_leaves, depth = sah_build_and_reorder(
        pack, K, require_native=require_native, with_plucker=False)
    cbox = np.zeros((nodes14.shape[0], 16), np.float32)
    cbox[:, :14] = nodes14
    t = lambda x: torch.as_tensor(x, device=device)
    return new_pack, BinaryBVH(cbox=t(cbox), leafW=t(_leafW(new_pack,
                                                            n_leaves)),
                               n_nodes=int(nodes14.shape[0]),
                               n_leaves=int(n_leaves),
                               stack_depth=int(max(4, depth + 3)))


def build_binary_bvh(pack: TrianglePack) -> BinaryBVH:
    """Implicit-LBVH build for a Morton-ORDERED pack (the A/B baseline of
    the SAH tree; links from the complete tree's indexing)."""
    leaf_lo, leaf_hi, n_leaves = _leaf_boxes(pack, K)
    cbox12, n_internal, stack_depth = _build_cbox(leaf_lo, leaf_hi)
    nn = cbox12.shape[0]
    cbox = np.zeros((nn, 16), np.float32)
    cbox[:, :12] = cbox12
    ii = np.arange(nn)
    for col, child in ((12, 2 * ii + 1), (13, 2 * ii + 2)):
        is_leaf = child >= n_internal
        link = np.where(is_leaf, ~(child - n_internal), child)
        cbox[:, col] = link.astype(np.float32)
    if n_internal == 0:
        # degenerate single-leaf tree: root row points at leaf 0 twice
        cbox[0, 12] = cbox[0, 13] = float(~0)
    t = lambda x: torch.as_tensor(x, device=pack.v0.device)
    return BinaryBVH(cbox=t(cbox), leafW=t(_leafW(pack, n_leaves)),
                     n_nodes=int(nn), n_leaves=int(n_leaves),
                     stack_depth=int(stack_depth))


# ---------------------------------------------------------------------------
# Traversal: the CUDA kernel and its plain version
# ---------------------------------------------------------------------------

@torch.no_grad()
def walk_binary_plain(bvh: BinaryBVH, o, d, tmin, tmax,
                      any_hit: bool = False):
    """The kernel's walk in plain PyTorch, one stack of (node, entry t)
    per ray, every ray advanced by one pop per step: the root first with
    entry tmin; an entry past min(tmax, best) dropped; an internal node
    slab-tests both children (BOX_PAD-widened) and pushes the hit ones
    far first by entry t (left on ties); a leaf tested with the kernel's
    arithmetic; an any-hit ray stopped at its first accepted leaf.
    Returns (t (N,) f32, _BIG on a miss; id (N,) int32; internal-node
    visits (N,) int32; leaf visits (N,) int32). Dead rays (tmax < tmin)
    visit nothing."""
    tmin, tmax = ray_bounds(o, tmin, tmax)
    o, d = o.detach(), d.detach()
    n, s, dev = o.shape[0], bvh.stack_depth, o.device
    rcp = 1.0 / d
    m = cross(o, d)
    best = torch.full((n,), _BIG, device=dev)
    best_id = torch.zeros((n,), dtype=torch.int64, device=dev)
    n_int = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_leaf = torch.zeros((n,), dtype=torch.int32, device=dev)
    stack_i = torch.zeros((n, s), dtype=torch.int64, device=dev)
    stack_t = tmin[:, None].repeat(1, s)                  # root: entry tmin
    sp = (tmax >= tmin).to(torch.int64)
    while True:
        act = torch.nonzero(sp > 0)[:, 0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack_i[act, sp[act]]
        ten = stack_t[act, sp[act]]
        cur = torch.minimum(tmax[act], best[act])
        live = ten <= cur
        inner = live & (node >= 0)
        outer = live & (node < 0)

        ia, nodes = act[inner], node[inner]
        if ia.numel():
            n_int[ia] += 1
            cb = bvh.cbox[nodes]                                # (M, 16)
            oo, rr, lo, hi = o[ia], rcp[ia], tmin[ia], cur[inner]
            ent_l, ext_l = _padded_entry(cb[:, 0:3], cb[:, 3:6], oo, rr, lo,
                                         hi)
            ent_r, ext_r = _padded_entry(cb[:, 6:9], cb[:, 9:12], oo, rr, lo,
                                         hi)
            h_l, h_r = ent_l <= ext_l, ent_r <= ext_r
            t_l = torch.where(h_l, ent_l, torch.inf)
            t_r = torch.where(h_r, ent_r, torch.inf)
            c_l, c_r = cb[:, 12].long(), cb[:, 13].long()
            l_near = t_l <= t_r
            far = (torch.where(l_near, c_r, c_l), torch.where(l_near, t_r, t_l),
                   torch.where(l_near, h_r, h_l))
            near = (torch.where(l_near, c_l, c_r),
                    torch.where(l_near, t_l, t_r),
                    torch.where(l_near, h_l, h_r))
            base = sp[ia]
            top = base + far[2].long() + near[2].long()
            if bool((top > s).any()):
                raise RuntimeError("walk_binary_plain: stack overflow")
            for (idx, tv, h), at in ((far, base), (near, base + far[2].long())):
                stack_i[ia[h], at[h]] = idx[h]
                stack_t[ia[h], at[h]] = tv[h]
            sp[ia] = top

        la, leaves = act[outer], -node[outer] - 1
        if la.numel():
            n_leaf[la] += 1
            lt, lane = _leaf_test(bvh, leaves, o[la], d[la], m[la], tmin[la],
                                  cur[outer])
            better = lt < best[la]
            best[la] = torch.where(better, lt, best[la])
            best_id[la] = torch.where(better, leaves * K + lane, best_id[la])
            if any_hit:
                sp[la[better]] = 0
    return best, best_id.to(torch.int32), n_int, n_leaf


def _tests(n_int, n_leaf):
    """Box and triangle tests from visit counts: 2 slab tests per
    internal visit, K triangle tests per leaf visit."""
    return 2 * n_int, K * n_leaf


def closest_hit_triangles_plain(bvh: BinaryBVH, o, d, tmin, tmax,
                                with_stats: bool = False):
    """Plain PyTorch version of the closest-hit kernel: (t, id), and
    (box tests, triangle tests) per ray with_stats."""
    t, ids, n_int, n_leaf = walk_binary_plain(bvh, o, d, tmin, tmax)
    return (t, ids, *_tests(n_int, n_leaf)) if with_stats else (t, ids)


def any_hit_triangles_plain(bvh: BinaryBVH, o, d, tmin, tmax,
                            with_stats: bool = False):
    """Plain PyTorch version of the any-hit kernel: t, < _BIG if
    occluded, and (box tests, triangle tests) per ray with_stats."""
    t, _, n_int, n_leaf = walk_binary_plain(bvh, o, d, tmin, tmax,
                                            any_hit=True)
    return (t, *_tests(n_int, n_leaf)) if with_stats else t


_lib = None


def _bind(lib):
    """Declare the C interface of a build of traverse_binary.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.traverse_binary.argtypes = [i, p, p, p, p, i, p, p, i, i, i, p, p,
                                    p, p, p, p]
    lib.traverse_binary.restype = i
    lib.traverse_binary_threads.restype = i
    lib.traverse_binary_max_smem.restype = i
    return lib


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load_library("traverse_binary.cu"))
    return _lib


def _stack_smem_bytes(lib, stack_depth: int) -> int:
    """Bytes of shared memory a block of the card walk takes for its
    threads' stacks of stack_depth two-word slots (a link and an entry
    t), with the block size and the limit that traverse_binary.cu (`lib`,
    its card or host build) exports. Raises ValueError where that is more
    than a block may use, or the tree has no stack."""
    threads = lib.traverse_binary_threads()
    max_smem = lib.traverse_binary_max_smem()
    nbytes = int(stack_depth) * threads * 8
    if stack_depth < 1 or nbytes > max_smem:
        raise ValueError(f"traverse_binary: a stack of {stack_depth} slots "
                         f"takes {nbytes} bytes of shared memory per block; "
                         f"a block may use 1 to {max_smem // threads // 8}"
                         " slots")
    return nbytes


def _check_inputs(bvh: BinaryBVH, o, d, tmin, tmax):
    check_launch(o, d, tmin, tmax, (("cbox", bvh.cbox, torch.float32),
                                    ("leafW", bvh.leafW, torch.float32)))
    if bvh.cbox.shape != (bvh.n_nodes, 16) \
            or bvh.leafW.shape != (bvh.n_leaves, 16, 4 * K):
        raise ValueError("BinaryBVH arrays do not match its counts")
    for name, x in (("cbox", bvh.cbox), ("leafW", bvh.leafW)):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the card walk reads it 16 bytes at a "
                             "time; need a 16-byte-aligned tensor")


def _launch(bvh: BinaryBVH, o, d, tmin, tmax, any_hit: bool,
            with_stats: bool):
    """One launch: (t, id, internal visits or None, leaf visits or None)."""
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    _check_inputs(bvh, o, d, tmin, tmax)
    n = o.shape[0]
    i32 = dict(dtype=torch.int32, device=o.device)
    out_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    out_id = torch.empty((n,), **i32)
    out_nv = torch.empty((n,), **i32) if with_stats else None
    out_lv = torch.empty((n,), **i32) if with_stats else None
    if n == 0:
        return out_t, out_id, out_nv, out_lv
    lib = _kernel_lib()
    _stack_smem_bytes(lib, bvh.stack_depth)
    err = _error_word(o.device, "traverse_binary")
    stream = torch.cuda.current_stream(o.device).cuda_stream
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    with profiling.span("bvh.launch"):
        rc = lib.traverse_binary(
            int(any_hit), ptr(o), ptr(d), ptr(tmin), ptr(tmax), n,
            ptr(bvh.cbox), ptr(bvh.leafW), bvh.n_nodes, bvh.n_leaves,
            bvh.stack_depth, ptr(out_t), ptr(out_id), ptr(out_nv),
            ptr(out_lv), ptr(err), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"traverse_binary launch failed: CUDA error {rc}")
    mode = "any" if any_hit else "closest"
    profiling.count(f"{LAUNCH}.{'stats_' if with_stats else ''}{mode}")
    profiling.count("bvh.lanes", n)
    _after_launch(err, "traverse_binary")
    return out_t, out_id, out_nv, out_lv


def closest_hit_triangles(bvh: BinaryBVH, o, d, tmin, tmax,
                          with_stats: bool = False):
    """Closest hit of N rays against the tree: (t (N,) f32, _BIG on a
    miss; id (N,) i32 = leaf*K + lane), and with_stats (box tests,
    triangle tests) (N,) i32 per ray."""
    if not _route(o):
        return closest_hit_triangles_plain(bvh, o, d, tmin, tmax, with_stats)
    tmin, tmax = ray_bounds(o, tmin, tmax)
    t, ids, n_int, n_leaf = _launch(bvh, o, d, tmin, tmax, False, with_stats)
    return (t, ids, *_tests(n_int, n_leaf)) if with_stats else (t, ids)


def any_hit_triangles(bvh: BinaryBVH, o, d, tmin, tmax,
                      with_stats: bool = False):
    """Occlusion of N rays: t (N,) f32, < _BIG where some triangle lies
    in [tmin, tmax]; with_stats (t, box tests, triangle tests)."""
    if not _route(o):
        return any_hit_triangles_plain(bvh, o, d, tmin, tmax, with_stats)
    tmin, tmax = ray_bounds(o, tmin, tmax)
    t, _, n_int, n_leaf = _launch(bvh, o, d, tmin, tmax, True, with_stats)
    return (t, *_tests(n_int, n_leaf)) if with_stats else t
