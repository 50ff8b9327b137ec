"""Wide (W = 4 or 8) SAH BVH: host build, CUDA traversal, plain twin.

Counterpart of cse168_raytracer_tpu/ops/pallas_bvh.py:162-208 and
780-1017. The host build (`_collapse_wide`, `_leafW_from_pack`,
`_attrA_from_pack`, `build_bvh4_sah`) is the JAX package's numpy code,
copied, so the tree arrays are byte-equal to the Pallas kernel's.

Traversal (`closest_hit_triangles`, `any_hit_triangles`) runs the
hand-written CUDA kernel csrc/traverse_wide.cu on CUDA tensors, the
card walk: each thread walks its ray, the warp tests the leaves its
lanes reach together, and the stacks live in shared memory. It
replaces the Pallas kernel `_traverse4_one` in its closest-hit-with-
attributes and any-hit modes, for both the W=4 tree and the W=8 tree of
scenes above 300k triangles, and in its with_stats mode (kernel K3:
`with_stats=True` also returns per-ray box and triangle tests, W times
the internal-node visits and K times the leaf visits, as
pallas_bvh.py:569-574 scales them). On CPU tensors the same entry
points run the kernel's plain version, `walk_plain`: the kernel's own
walk vectorized over rays, with its counts dropped when they are not
asked for. For a CUDA tensor a wrapper launches the kernel or raises;
it never falls back to the plain version. `_launch_per_ray` runs the
design the card walk replaced (one thread per ray, its stack in device
memory), for chip_smoke.py to time beside it; nothing else reaches it.
`brute_force_triangles`, a chunked brute force over the leaf table with
the same acceptance rule, first-lane ties and attribute gather, is an
oracle independent of the walk, for tests and chip_smoke.py; no entry
point runs it.

The counters differ from the TPU kernel's on purpose:
1. they are per ray: the TPU kernel counts the visits of a 256-ray tile
   and bills them to every ray of the tile, where here one thread walks
   one ray;
2. the walk widens each slot by BOX_PAD of its extent (the acceptance
   rule reaches 2*EPSILON past a triangle), which can add visits;
3. the TPU's any-hit retires a ray one internal visit late
   (pallas_bvh.py:1145-1153: the exit rides on the next internal
   visit's scalar sync), where this walk stops at the first accepted
   leaf.

Traversal inputs are detached: hits are discrete selections, and the
winner's continuous quantities are recomputed differentiably in
ops/surface.py.
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
from cse168_raytracer_tpu_torch.ops.intersect import _BIG
from cse168_raytracer_tpu_torch.ops.pluecker import triangle_t

K = 128          # triangles per leaf
_FAR = 1.0e30    # empty-slot box (a degenerate point the slab test rejects)
BOX_PAD = 1e-3   # slot widening, traverse_wide.cu's BOX_PAD

# kernel launches by mode, counted where the wrapper launches the kernel
LAUNCHES = {"closest": 0, "any": 0, "stats_closest": 0, "stats_any": 0}


@dataclasses.dataclass
class WideBVH:
    """A W-wide SAH BVH in the Pallas kernel's layout."""
    cbox: torch.Tensor   # (N, 8W) f32, plane-grouped slot boxes
    links: torch.Tensor  # (N*W,) i32: >= 0 internal node, < 0 leaf ~link
    leafW: torch.Tensor  # (L, 16, 4K) f32 Pluecker operands, planar groups
    attrA: torch.Tensor  # (L, 16, 2K) f32 winner-attribute blocks
    n_nodes: int
    n_leaves: int
    stack_depth: int
    width: int


def _leafW_from_pack(w6: np.ndarray, w4: np.ndarray,
                     n_leaves: int) -> np.ndarray:
    """Leaf operands with planar output columns [beta(K) | gamma(K) |
    den(K) | t(K)] from a leaf-ordered pack's w6 (6, T, 3) and w4 (4, T)."""
    leafW = np.zeros((n_leaves, 16, 4 * K), np.float32)
    w6l = w6.reshape(6, n_leaves, K, 3)
    # full-array reshape is a view; lane dim viewed as (group, K)
    leafW4 = leafW.reshape(n_leaves, 16, 4, K)
    leafW4[:, 0:6, 0:3, :] = w6l.transpose(1, 0, 3, 2)
    leafW4[:, 6:10, 3, :] = w4.reshape(4, n_leaves, K).transpose(1, 0, 2)
    return leafW


def _attrA_from_pack(a: dict, n_leaves: int) -> np.ndarray:
    """Per-leaf attribute blocks (L, 16, 2K) from a leaf-ordered pack's
    host arrays: the 29 ops/surface.pack_attr_rows columns padded to 32
    rows, rows 16..31 stored in lanes K..2K."""
    cols = [a["v0"], a["e1"], a["e2"], a["n_geo"], a["n0"], a["n1"],
            a["n2"], a["t0"], a["t1"], a["t2"],
            a["has_uv"][:, None].astype(np.float32),
            a["material_id"][:, None].astype(np.float32)]
    attr = np.zeros((n_leaves * K, 32), np.float32)
    attr[:, :29] = np.concatenate(cols, axis=1)
    a32 = attr.reshape(n_leaves, K, 32).transpose(0, 2, 1)  # (L, 32, K)
    return np.ascontiguousarray(
        np.concatenate([a32[:, :16, :], a32[:, 16:, :]], axis=2))


def _collapse_wide(nodes14: np.ndarray, W: int):
    """Collapse a binary child-box tree (sah.py layout) into W-wide
    nodes (W=4 default, W=8 via CSE168_NODE_W). Returns
    (cbox (N, 8W) f32, links (N, W) i32, depth).

    Row layout is PLANE-GROUPED for the kernel's slot-parallel slab
    test: cols [lo_x(slot0..W-1) lo_y(W) lo_z(W) | hi_x(W) hi_y(W)
    hi_z(W) | pad(2W)] — the kernel's (3W, T) lo/hi plane blocks slice
    into aligned (W, T) per-axis groups whose row i is slot i, and all
    W slots reduce together. Links live in a separate flat i32 array
    (SMEM-resident in the kernel).

    The binary->W-ary contraction is a DP that MINIMIZES the wide-node
    count (the per-visit scalar overhead — cond, vector->scalar sync,
    stack traffic — is width-independent, and box tests are near-free
    VPU rows, so fewer/fuller nodes is strictly better):
      g(v, s) = min wide-nodes to present v's subtree as s slots
      g(v, s>=2) = min over sa+sb=s of g(a, sa) + g(b, sb)
      g(v, 1)    = 1 + min over 2<=s<=W of g(v, s)
    A greedy top-down expansion was measured leaving ~2/3 of the nodes
    with just 2 occupied slots (leaf-pair leftovers); the DP emits
    near-full nodes (bunny1 W=8: 353 greedy -> 118 DP nodes)."""
    n_bin = nodes14.shape[0]
    ch = nodes14[:, 12:14].astype(np.int64)
    INF = np.int64(1) << 40
    g = np.full((n_bin, W + 1), INF, np.int64)      # cols 1..W used
    split = np.zeros((n_bin, W + 1), np.int64)
    leaf_row = np.full(W + 1, INF, np.int64)
    leaf_row[1] = 0
    order = []
    stack = [0]
    while stack:
        v = stack.pop()
        order.append(v)
        for c in ch[v]:
            if c >= 0:
                stack.append(int(c))
    for v in reversed(order):
        a, b = int(ch[v][0]), int(ch[v][1])
        ga = leaf_row if a < 0 else g[a]
        gb = leaf_row if b < 0 else g[b]
        for s in range(2, W + 1):
            costs = ga[1:s] + gb[s - 1:0:-1]        # sa = 1..s-1
            sa = int(np.argmin(costs)) + 1
            g[v, s] = costs[sa - 1]
            split[v, s] = sa
        s_best = int(np.argmin(g[v, 2:W + 1])) + 2
        g[v, 1] = 1 + g[v, s_best]
        split[v, 1] = s_best

    rows, linkrows = [], []
    new_id = {}

    def collect(v, s):
        """v's subtree as s slot entries [(lo, hi, raw_link)]."""
        r = nodes14[v]
        a, b = int(ch[v][0]), int(ch[v][1])
        if s == 1:
            return None     # unreachable: callers split s >= 2
        sa = int(split[v, s])
        out = []
        for c, box, sc in ((a, r[0:6], sa), (b, r[6:12], s - sa)):
            if sc == 1:
                out.append((box[0:3], box[3:6], c))
            else:
                out.extend(collect(c, sc))
        return out

    def emit(v):
        if v in new_id:
            return new_id[v]
        my = len(rows)
        new_id[v] = my
        rows.append(None)
        linkrows.append(None)
        slots = collect(v, int(split[v, 1]))
        row = np.empty(6 * W, np.float32)
        lrow = np.empty(W, np.int64)
        for i in range(W):
            if i < len(slots):
                lo, hi, link = slots[i]
                for a in range(3):
                    row[a * W + i] = lo[a]
                    row[3 * W + a * W + i] = hi[a]
                # internal slot: emit the child wide node (recursion
                # depth = wide-tree depth, ~log_W leaves)
                lrow[i] = emit(link) if link >= 0 else link
            else:
                # empty slot: a DEGENERATE POINT at +infinity (lo == hi
                # == _FAR): for almost any ray the per-axis entry t's
                # differ (or overflow to +inf on at most two axes), so
                # ent > ext and the slot never pushes. An INVERTED box
                # (hi < lo) would be wrong here — per-axis tn=min/
                # tf=max of the two plane t's spans (-inf, inf) for
                # straddling planes, so an inverted box ACCEPTS every
                # ray. The measure-zero escape (a ray aimed exactly at
                # the degenerate point makes ent == ext pass) is made
                # TERMINATING by linking the slot to leaf 0 (~0): a
                # spurious leaf visit tests real triangles against the
                # usual acceptance rules — redundant work, never a
                # wrong hit, never a loop (an internal link 0 would
                # re-push the root forever).
                for a in range(3):
                    row[a * W + i] = _FAR
                    row[3 * W + a * W + i] = _FAR
                lrow[i] = ~0
        rows[my] = row
        linkrows[my] = lrow
        return my

    import sys as _sys
    old_lim = _sys.getrecursionlimit()
    _sys.setrecursionlimit(max(old_lim, 100_000))
    try:
        emit(0)
    finally:
        _sys.setrecursionlimit(old_lim)
    n = len(rows)
    cbox = np.zeros((n, 8 * W), np.float32)
    cbox[:, :6 * W] = np.stack(rows)
    links = np.stack(linkrows).astype(np.int32)
    # depth of the collapsed tree (for stack sizing): BFS
    depth = 1
    frontier = {0}
    seen = set()
    while frontier:
        nxt = set()
        for j in frontier:
            seen.add(j)
            for i in range(W):
                link = int(links[j, i])
                if cbox[j, i] < _FAR and link >= 0 and link not in seen:
                    nxt.add(link)
        frontier = nxt
        if frontier:
            depth += 1
    if not len(seen) == n <= max(1, nodes14.shape[0]):
        raise RuntimeError("wide-node collapse lost or duplicated a node")
    return cbox, links, depth


def build_bvh4_sah(pack: TrianglePack, width: int = 4,
                   require_native: bool | None = None):
    """SAH build (ops/sah.py) collapsed to `width`-wide nodes. Returns
    (leaf-ordered pack without w6/w4, WideBVH) on the pack's device.
    require_native defaults to True for a CUDA pack (see ops/sah.py)."""
    from cse168_raytracer_tpu_torch.ops.sah import sah_build_and_reorder
    device = pack.v0.device
    if require_native is None:
        require_native = device.type == "cuda"
    new_pack, nodes14, n_leaves, _depth = sah_build_and_reorder(
        pack, K, require_native=require_native, with_plucker=False)
    cboxw, linksw, depthw = _collapse_wide(nodes14.astype(np.float32), width)
    a = pack_host_arrays(new_pack)
    w6, w4 = plucker_operands(a["v0"], a["e1"], a["e2"], n_geo=a["n_geo"])
    t = lambda x: torch.as_tensor(x, device=device)
    bvh = WideBVH(cbox=t(cboxw), links=t(linksw.reshape(-1)),
                  leafW=t(_leafW_from_pack(np.asarray(w6, np.float32),
                                           np.asarray(w4, np.float32),
                                           n_leaves)),
                  attrA=t(_attrA_from_pack(a, n_leaves)),
                  n_nodes=int(cboxw.shape[0]), n_leaves=int(n_leaves),
                  stack_depth=int((width - 1) * depthw + 8), width=width)
    return new_pack, bvh


# ---------------------------------------------------------------------------
# Traversal: the CUDA kernel, its plain version and a brute-force oracle
# ---------------------------------------------------------------------------

def _bounds(o, tmin, tmax):
    n = o.shape[0]
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                     device=o.device).expand(n).contiguous()
    return as_t(tmin), as_t(tmax)


def _chunk_sizes(n_leaves: int, device) -> tuple[int, int]:
    budget = (1 << 25) if device.type == "cuda" else (1 << 21)
    leaves = max(1, min(n_leaves, budget // (K * 256)))
    rays = max(1, budget // (K * leaves))
    return rays, leaves


def _lane_t(lw, r6, o3, tmin, tmax):
    """traverse_wide.cu's shade_leaf arithmetic for the K lanes of leaf
    operand rows lw (..., >= 10, 4K): t where the lane's triangle accepts
    the ray with t in [tmin, tmax], _BIG elsewhere. r6 (direction and
    moment) and o3 (origin) hold the ray's components, and tmin and tmax
    its bounds, each shaped to broadcast against lw[..., 0, :K]."""
    rows = lambda c, r0, r1: [lw[..., r, c:c + K] for r in range(r0, r1)]
    return triangle_t(rows(0, 0, 6), rows(K, 0, 6), rows(2 * K, 0, 6),
                      rows(3 * K, 6, 10), r6, o3, tmin, tmax)


@torch.no_grad()
def brute_force_triangles(bvh: WideBVH, o, d, tmin, tmax):
    """Brute force over every leaf: (t, _BIG on a miss; id (N,) int32;
    attr (N, 32)) of the nearest accepted triangle per ray under the
    kernel's acceptance rule, first (leaf, lane) on ties. Only live rays
    (tmax >= tmin) are tested. t < _BIG is also the any-hit answer."""
    tmin, tmax = _bounds(o, tmin, tmax)
    n = o.shape[0]
    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=o.device)
    best_id = torch.zeros((n,), dtype=torch.int64, device=o.device)
    live = torch.nonzero(tmax >= tmin)[:, 0]
    o, d, tmin, tmax = o[live], d[live], tmin[live], tmax[live]
    m = cross(o, d)    # the ray moment, rounded as the kernel rounds it
    r6 = [d[:, 0], d[:, 1], d[:, 2], m[:, 0], m[:, 1], m[:, 2]]
    lw = bvh.leafW
    n_leaves = bvh.n_leaves
    rays_c, leaves_c = _chunk_sizes(n_leaves, o.device)
    lt_all = torch.full((o.shape[0],), _BIG, device=o.device)
    lid_all = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
    for r0 in range(0, o.shape[0], rays_c):
        rs = slice(r0, r0 + rays_c)
        col = lambda x: x[rs][:, None, None]
        bt = torch.full((lt_all[rs].shape[0],), _BIG, device=o.device)
        bid = torch.zeros_like(bt, dtype=torch.int64)
        for l0 in range(0, n_leaves, leaves_c):
            blk = lw[None, l0:l0 + leaves_c]            # (1, Lc, 16, 4K)
            tm = _lane_t(blk, [col(x) for x in r6],     # (R, Lc, K)
                         [col(o[:, a]) for a in range(3)], col(tmin),
                         col(tmax))
            lt, lj = tm.reshape(tm.shape[0], -1).min(1)
            better = lt < bt
            bt = torch.where(better, lt, bt)
            bid = torch.where(better, lj + l0 * K, bid)
        lt_all[rs], lid_all[rs] = bt, bid
    best_t[live], best_id[live] = lt_all, lid_all
    return best_t, best_id.to(torch.int32), _gather_attr(bvh, best_t, best_id)


def _leaf_test(bvh: WideBVH, leaves, o, d, m, tmin, curmax):
    """Nearest accepted lane of each ray's own leaf with t in [tmin,
    curmax], as traverse_wide.cu's shade_leaf computes it (first lane on
    ties). Returns (t, _BIG when none; lane)."""
    lt = torch.empty_like(tmin)
    lane = torch.empty_like(leaves)
    budget = (1 << 26) if o.device.type == "cuda" else (1 << 22)
    step = max(1, budget // (10 * 4 * K))
    for c0 in range(0, leaves.shape[0], step):
        cs = slice(c0, c0 + step)
        col = lambda x: x[cs, None]
        tm = _lane_t(bvh.leafW[leaves[cs], :10],          # (R, K)
                     [col(d[:, a]) for a in range(3)]
                     + [col(m[:, a]) for a in range(3)],
                     [col(o[:, a]) for a in range(3)], col(tmin),
                     col(curmax))
        lt[cs], lane[cs] = tm.min(1)
    return lt, lane


def _padded_entry(lo, hi, o, rcp, tmin, curmax):
    """pluecker.cuh's padded_entry for many rays at once: boxes lo, hi
    (M, 3, ...) widened by BOX_PAD of their extent, rays o, rcp (M, 3,
    ...) broadcast against them, clipped to [tmin, curmax] (M, ...); NaN
    from 0*inf leaves that axis unconstrained. Returns (entry t, exit t);
    a box passes when entry <= exit."""
    pad = (hi - lo) * BOX_PAD
    ta = ((lo - pad) - o) * rcp
    tb = ((hi + pad) - o) * rcp
    nan_to = lambda x, v: torch.where(torch.isnan(x), v, x)
    near = torch.minimum(nan_to(ta, -torch.inf), nan_to(tb, -torch.inf))
    far = torch.maximum(nan_to(ta, torch.inf), nan_to(tb, torch.inf))
    ent, ext = tmin, curmax
    for a in range(3):
        ent = torch.maximum(ent, near[:, a])
        ext = torch.minimum(ext, far[:, a])
    return ent, ext


@torch.no_grad()
def walk_plain(bvh: WideBVH, o, d, tmin, tmax, any_hit: bool = False):
    """The kernel's walk in plain PyTorch, one stack per ray, every ray
    advanced by one pop per step: the root first, internal slots pushed
    in slot order when their BOX_PAD-widened slab test passes against
    [tmin, min(tmax, best)], pops last-in first-out, each leaf tested
    with the kernel's arithmetic, and an any-hit ray stopped at its
    first accepted leaf. Returns (t (N,) f32, _BIG on a miss; id (N,)
    int32; internal-node visits (N,) int32; leaf visits (N,) int32).
    Dead rays (tmax < tmin) visit nothing."""
    tmin, tmax = _bounds(o, tmin, tmax)
    o, d = o.detach(), d.detach()
    n, w, dev = o.shape[0], bvh.width, o.device
    rcp = 1.0 / d
    m = cross(o, d)
    lo_hi = bvh.cbox.view(bvh.n_nodes, 8, w)[:, :6]   # (N, 6, W) planes
    links = bvh.links.view(bvh.n_nodes, w).to(torch.int64)
    best = torch.full((n,), _BIG, device=dev)
    best_id = torch.zeros((n,), dtype=torch.int64, device=dev)
    n_int = torch.zeros((n,), dtype=torch.int32, device=dev)
    n_leaf = torch.zeros((n,), dtype=torch.int32, device=dev)
    stack = torch.zeros((n, bvh.stack_depth), dtype=torch.int64, device=dev)
    sp = (tmax >= tmin).to(torch.int64)
    while True:
        act = torch.nonzero(sp > 0)[:, 0]
        if act.numel() == 0:
            break
        sp[act] -= 1
        node = stack[act, sp[act]]
        inner = node >= 0

        ia, nodes = act[inner], node[inner]
        if ia.numel():
            n_int[ia] += 1
            ent, ext = _padded_entry(
                lo_hi[nodes, 0:3], lo_hi[nodes, 3:6],     # (M, 3, W)
                o[ia][:, :, None], rcp[ia][:, :, None], tmin[ia, None],
                torch.minimum(tmax[ia], best[ia])[:, None])
            push = ent <= ext                             # (M, W)
            k = push.to(torch.int64)
            top = sp[ia] + k.sum(1)
            if bool((top > bvh.stack_depth).any()):
                raise RuntimeError("walk_plain: stack overflow")
            slot = sp[ia, None] + torch.cumsum(k, 1) - k
            stack[ia[:, None].expand(-1, w)[push], slot[push]] = \
                links[nodes][push]
            sp[ia] = top

        la, leaves = act[~inner], -node[~inner] - 1
        if la.numel():
            n_leaf[la] += 1
            lt, lane = _leaf_test(bvh, leaves, o[la], d[la], m[la], tmin[la],
                                  torch.minimum(tmax[la], best[la]))
            better = lt < best[la]
            best[la] = torch.where(better, lt, best[la])
            best_id[la] = torch.where(better, leaves * K + lane, best_id[la])
            if any_hit:
                sp[la[better]] = 0
    return best, best_id.to(torch.int32), n_int, n_leaf


def _gather_attr(bvh: WideBVH, t, ids):
    """The winner's (N, 32) attribute rows from attrA, zeros on a miss."""
    leaf, lane = ids // K, ids % K
    lo = bvh.attrA[leaf, :, lane]                       # (N, 16)
    hi = bvh.attrA[leaf, :, lane + K]
    attr = torch.cat([lo, hi], 1)
    return torch.where((t < _BIG)[:, None], attr, 0.0)


def _tests(bvh: WideBVH, n_int, n_leaf):
    """Box and triangle tests from visit counts: W slab tests per
    internal visit, K triangle tests per leaf visit."""
    return bvh.width * n_int, K * n_leaf


def closest_hit_triangles_plain(bvh: WideBVH, o, d, tmin, tmax,
                                with_stats: bool = False):
    """Plain PyTorch version of the closest-hit kernel, by walk_plain:
    (t, id, attr), and (box tests, triangle tests) per ray with_stats."""
    t, ids, n_int, n_leaf = walk_plain(bvh, o, d, tmin, tmax)
    out = (t, ids, _gather_attr(bvh, t, ids.to(torch.int64)))
    return out + _tests(bvh, n_int, n_leaf) if with_stats else out


def any_hit_triangles_plain(bvh: WideBVH, o, d, tmin, tmax,
                            with_stats: bool = False):
    """Plain PyTorch version of the any-hit kernel, by walk_plain: t,
    < _BIG if occluded, and (box tests, triangle tests) per ray
    with_stats."""
    t, _, n_int, n_leaf = walk_plain(bvh, o, d, tmin, tmax, any_hit=True)
    return (t, *_tests(bvh, n_int, n_leaf)) if with_stats else t


_lib = None


def _stack_smem_bytes(lib, stack_depth: int) -> int:
    """Bytes of shared memory a block of the card walk takes for its
    threads' stacks of stack_depth int32 slots, with the block size and
    the limit that traverse_wide.cu (`lib`, its card or host build)
    exports. Raises ValueError where that is more than a block may use,
    or the tree has no stack."""
    threads = lib.traverse_wide_threads()
    max_smem = lib.traverse_wide_max_smem()
    nbytes = int(stack_depth) * threads * 4
    if stack_depth < 1 or nbytes > max_smem:
        raise ValueError(f"traverse_wide: a stack of {stack_depth} slots "
                         f"takes {nbytes} bytes of shared memory per block; "
                         f"a block may use 1 to {max_smem // threads // 4}"
                         " slots")
    return nbytes


def _bind(lib):
    """Declare the C interface of a build of traverse_wide.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    rays = [i, p, p, p, p, i, p, p, p]  # width, o, d, tmin, tmax, n, tree
    closest = rays + [p, i, i]          # attrA, n_nodes, n_leaves
    any_hit = rays + [i, i]
    for name, args, outs in (("traverse_closest_attr", closest, [p] * 5),
                             ("traverse_any", any_hit, [p] * 3)):
        for fn, stack in ((getattr(lib, name), []),
                          (getattr(lib, name + "_per_ray"), [p])):
            fn.argtypes = args + stack + [i] + outs + [p, p]
            fn.restype = i
    lib.traverse_wide_threads.restype = i
    lib.traverse_wide_max_smem.restype = i
    return lib


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load_library("traverse_wide.cu"))
    return _lib


def check_launch(o, d, tmin, tmax, tables):
    """What every kernel wrapper checks before a launch: rays o, d (N, 3)
    and tmin, tmax (N,), and the named tables [(name, tensor, dtype)],
    contiguous, of their dtype (float32 for the rays) and on one device;
    N below 2**31."""
    dev = o.device
    f32 = torch.float32
    for name, x, dt in [("o", o, f32), ("d", d, f32), ("tmin", tmin, f32),
                        ("tmax", tmax, f32)] + list(tables):
        if x.device != dev or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{name}: need a contiguous {dt} tensor on "
                             f"{dev}, got {x.dtype} on {x.device}")
    n = o.shape[0]
    if o.shape != (n, 3) or d.shape != (n, 3) or tmin.shape != (n,) \
            or tmax.shape != (n,):
        raise ValueError("rays: need o, d (N, 3) and tmin, tmax (N,)")
    if n >= 2 ** 31:
        raise ValueError("too many rays for one launch")


def _check_inputs(bvh: WideBVH, o, d, tmin, tmax):
    f32 = torch.float32
    check_launch(o, d, tmin, tmax, (("cbox", bvh.cbox, f32),
                                    ("links", bvh.links, torch.int32),
                                    ("leafW", bvh.leafW, f32),
                                    ("attrA", bvh.attrA, f32)))
    n, w = o.shape[0], bvh.width
    if w not in (4, 8) or bvh.cbox.shape != (bvh.n_nodes, 8 * w) \
            or bvh.links.shape != (bvh.n_nodes * w,) \
            or bvh.leafW.shape != (bvh.n_leaves, 16, 4 * K) \
            or bvh.attrA.shape != (bvh.n_leaves, 16, 2 * K):
        raise ValueError("WideBVH arrays do not match its width and counts")
    if bvh.leafW.data_ptr() % 16:
        raise ValueError("leafW: the card walk reads it 16 bytes at a time; "
                         "need a 16-byte-aligned tensor")


def _call(fn, stack, bvh: WideBVH, o, d, tmin, tmax, any_hit: bool,
          with_stats: bool):
    """Call `fn`, an entry point of traverse_wide.cu (traverse_any when
    any_hit, else traverse_closest_attr; or either's _per_ray twin, which
    takes the pointers `stack` before stack_depth). Returns the outputs
    (t, id, attr, internal visits, leaf visits), the entries a mode does
    not produce being None, and the (1,) error bits that the launch
    sets, None where there were no rays and nothing was launched."""
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    _check_inputs(bvh, o, d, tmin, tmax)
    n = o.shape[0]
    i32 = dict(dtype=torch.int32, device=o.device)
    out_t = torch.empty((n,), dtype=torch.float32, device=o.device)
    out_id = out_attr = None
    out_nv = torch.empty((n,), **i32) if with_stats else None
    out_lv = torch.empty((n,), **i32) if with_stats else None
    if n == 0:
        return (out_t, torch.empty((0,), **i32),
                torch.empty((0, 32), dtype=torch.float32, device=o.device),
                out_nv, out_lv), None
    err = torch.zeros((1,), dtype=torch.int32, device=o.device)
    stream = torch.cuda.current_stream(o.device).cuda_stream
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    common = [bvh.width, ptr(o), ptr(d), ptr(tmin), ptr(tmax), n,
              ptr(bvh.cbox), ptr(bvh.links), ptr(bvh.leafW)]
    if any_hit:
        rc = fn(*common, bvh.n_nodes, bvh.n_leaves, *stack, bvh.stack_depth,
                ptr(out_t), ptr(out_nv), ptr(out_lv), ptr(err),
                ctypes.c_void_p(stream))
    else:
        out_id = torch.empty((n,), **i32)
        out_attr = torch.empty((n, 32), dtype=torch.float32, device=o.device)
        rc = fn(*common, ptr(bvh.attrA), bvh.n_nodes, bvh.n_leaves, *stack,
                bvh.stack_depth, ptr(out_t), ptr(out_id), ptr(out_attr),
                ptr(out_nv), ptr(out_lv), ptr(err), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"traverse_wide launch failed: CUDA error {rc}")
    return (out_t, out_id, out_attr, out_nv, out_lv), err


def _raise_on(err):
    """The per-launch check: a stack overflow or a bad link raises."""
    bits = int(err.item())
    if bits:
        raise RuntimeError(f"traverse_wide: {'stack overflow ' if bits & 1 else ''}"
                           f"{'bad link' if bits & 2 else ''} (error bits {bits})")


def _launch(bvh: WideBVH, o, d, tmin, tmax, any_hit: bool,
            with_stats: bool = False):
    """One launch of the card walk; returns (t, id, attr, internal visits,
    leaf visits), the entries a mode does not produce being None."""
    lib = _kernel_lib()
    _stack_smem_bytes(lib, bvh.stack_depth)
    fn = lib.traverse_any if any_hit else lib.traverse_closest_attr
    out, err = _call(fn, [], bvh, o, d, tmin, tmax, any_hit, with_stats)
    if err is not None:
        mode = "any" if any_hit else "closest"
        LAUNCHES["stats_" + mode if with_stats else mode] += 1
        _raise_on(err)
    return out


def _launch_per_ray(bvh: WideBVH, o, d, tmin, tmax, any_hit: bool,
                    with_stats: bool = False):
    """_launch by the per-ray kernel (one thread walks one ray, its stack
    in (stack_depth, n) device scratch): the design the card walk
    replaced, kept as its yardstick so that chip_smoke.py can time both
    on one card. Nothing in the package calls it, and it counts no
    launch."""
    tmin, tmax = _bounds(o, tmin, tmax)
    if bvh.stack_depth * o.shape[0] >= 2 ** 62:
        raise ValueError("too many rays for one launch")
    lib = _kernel_lib()
    fn = (lib.traverse_any_per_ray if any_hit
          else lib.traverse_closest_attr_per_ray)
    scratch = torch.empty((bvh.stack_depth * o.shape[0],), dtype=torch.int32,
                          device=o.device)
    out, err = _call(fn, [ctypes.c_void_p(scratch.data_ptr())], bvh, o, d,
                     tmin, tmax, any_hit, with_stats)
    if err is not None:
        _raise_on(err)
    return out


def _route(o):
    if o.device.type == "cpu":
        return False
    if o.device.type == "cuda":
        return True
    raise ValueError(f"no traversal for tensors on {o.device}")


def closest_hit_triangles(bvh: WideBVH, o, d, tmin, tmax,
                          with_stats: bool = False):
    """Closest hit of N rays against the tree: (t (N,) f32, _BIG on a
    miss; id (N,) i32 = leaf*K + lane; attr (N, 32) f32 winner rows,
    zeros on a miss), and with_stats (box tests, triangle tests) (N,)
    i32 per ray."""
    if not _route(o):
        return closest_hit_triangles_plain(bvh, o, d, tmin, tmax, with_stats)
    tmin, tmax = _bounds(o, tmin, tmax)
    t, ids, attr, n_int, n_leaf = _launch(bvh, o, d, tmin, tmax,
                                          any_hit=False,
                                          with_stats=with_stats)
    if with_stats:
        return (t, ids, attr, *_tests(bvh, n_int, n_leaf))
    return t, ids, attr


def any_hit_triangles(bvh: WideBVH, o, d, tmin, tmax,
                      with_stats: bool = False):
    """Occlusion of N rays: t (N,) f32, < _BIG where some triangle lies
    in [tmin, tmax]; with_stats (t, box tests, triangle tests)."""
    if not _route(o):
        return any_hit_triangles_plain(bvh, o, d, tmin, tmax, with_stats)
    tmin, tmax = _bounds(o, tmin, tmax)
    t, _, _, n_int, n_leaf = _launch(bvh, o, d, tmin, tmax, any_hit=True,
                                     with_stats=with_stats)
    if with_stats:
        return (t, *_tests(bvh, n_int, n_leaf))
    return t
