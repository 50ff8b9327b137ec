"""Accelerator attachment and scene-level hit queries.

Counterpart of cse168_raytracer_tpu/ops/accel.py. `attach_accel` builds
one of the JAX package's accelerator kinds on the scene's device:

  "auto"          the wide SAH BVH, 4 wide up to 300k triangles and 8
                  wide above (the JAX package's VMEM and HBM tiers,
                  :167-181; its CPU fallback to "block" is a TPU-only
                  concession and is not copied); kernels K1-K4;
  "pallas_sah4"   the 4-wide tree at any size; "pallas_hbm" the 8-wide;
  "pallas_sah"    the binary SAH tree (ops/binary_bvh.py, kernel K5);
  "pallas_forest" Morton chunks of 4-wide trees (ops/forest.py, K1/K2;
                  chunk_tris=N);
  "pallas"        Morton-ordered 256-triangle blocks (ops/tri_blocks.py,
                  kernel K6);
  "bvh"           the implicit LBVH's per-ray walk (ops/bvh.py;
                  leaf_size=N);
  "packet"        the same tree walked by ray tiles (ops/packet.py;
                  leaf_size=N, tile=N);
  "block"         block and group boxes over the Morton-ordered pack,
                  walked by ray tiles (this module).
The last four are plain PyTorch, as in the JAX package, where they run
outside any Pallas kernel. "block", "bvh", "packet" and "pallas"
Morton-order the pack first (:216-219); the tree kinds reorder it into
their leaves. A scene with no valid triangle gets no accelerator and
traces only its spheres and planes.

The port's BlockAccel also keeps the ordered pack's Pluecker operands
and valid mask, since the port's scene_closest_hit takes no pack.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import MIRO_TMAX
from cse168_raytracer_tpu_torch.core.vecmath import cross
from cse168_raytracer_tpu_torch.models.geometry import (TrianglePack,
                                                        build_pack_from_arrays,
                                                        pack_host_arrays)
from cse168_raytracer_tpu_torch.ops import (binary_bvh, bvh, forest, packet,
                                            tri_blocks, wide_bvh)
from cse168_raytracer_tpu_torch.ops.intersect import (PRIM_TRI, _BIG, Hit,
                                                      _hit,
                                                      _occluded_by_pools,
                                                      _then_pools,
                                                      ray_bounds)
from cse168_raytracer_tpu_torch.ops.pluecker import triangle_t
from cse168_raytracer_tpu_torch.utils import profiling

MAX_W4_TRIS = 300_000
BLOCK = 128   # triangles per leaf block
GROUP = 16    # blocks per super-block
TILE = 8192   # rays per traversal tile
_FAR = 1.0e30

_KIND_KWARGS = {
    "pallas_forest": {"chunk_tris"},
    "bvh": {"leaf_size"},
    "packet": {"leaf_size", "tile"},
}
KINDS = ("auto", "block", "bvh", "packet", "pallas_sah", "pallas_sah4",
         "pallas_hbm", "pallas_forest", "pallas")


@dataclasses.dataclass
class BlockAccel:
    block_lo: torch.Tensor   # (NB, 3), NB padded to a multiple of GROUP
    block_hi: torch.Tensor   # (NB, 3)
    group_lo: torch.Tensor   # (NG, 3)
    group_hi: torch.Tensor   # (NG, 3)
    w6: torch.Tensor         # (6, T, 3) the ordered pack's operands
    w4: torch.Tensor         # (4, T)
    valid: torch.Tensor      # (T,) bool

    @property
    def num_blocks(self) -> int:
        return self.block_lo.shape[0]


def morton_order(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                 valid: np.ndarray) -> np.ndarray:
    """Permutation sorting valid triangles by the 30-bit Morton code of
    the centroid (GPU-LBVH ordering); invalid (padding) ones go last."""
    cent = v0 + (e1 + e2) / 3.0
    lo = cent[valid].min(axis=0) if valid.any() else np.zeros(3)
    hi = cent[valid].max(axis=0) if valid.any() else np.ones(3)
    q = ((cent - lo) / np.maximum(hi - lo, 1e-12) * 1023.0)
    q = np.clip(q, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) \
        | spread(q[:, 2])
    code = np.where(valid, code, np.uint64(0xFFFFFFFFFFFF))
    return np.argsort(code, kind="stable")


def reorder_pack(pack: TrianglePack, perm: np.ndarray) -> TrianglePack:
    """Permute every per-triangle array (and rebuild the Pluecker
    operands so they stay consistent), on the pack's device."""
    a = pack_host_arrays(pack)
    return build_pack_from_arrays(
        *(a[f][perm] for f in ("v0", "e1", "e2", "n0", "n1", "n2", "t0",
                               "t1", "t2", "has_uv", "material_id",
                               "valid")), device=pack.v0.device)


def build_accel(pack: TrianglePack) -> BlockAccel:
    """Block and group boxes of a Morton-ORDERED pack."""
    a = pack_host_arrays(pack)
    v0 = a["v0"].astype(np.float64)
    e1 = a["e1"].astype(np.float64)
    e2 = a["e2"].astype(np.float64)
    valid = a["valid"]
    t = v0.shape[0]
    if t % BLOCK:
        raise ValueError(f"pack of {t} rows is not a multiple of {BLOCK}")
    nb = t // BLOCK
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)        # (T, 3pts, 3)
    pts_lo = np.where(valid[:, None], pts.min(axis=1), _FAR)
    pts_hi = np.where(valid[:, None], pts.max(axis=1), _FAR)
    blo = pts_lo.reshape(nb, BLOCK, 3).min(axis=1)
    bhi = pts_hi.reshape(nb, BLOCK, 3).max(axis=1)
    # empty blocks: min=_FAR, but hi may be _FAR too — keep degenerate
    bhi = np.where(blo >= _FAR, _FAR, bhi)

    ng = -(-nb // GROUP)
    pad = ng * GROUP - nb
    if pad:
        blo_p = np.concatenate([blo, np.full((pad, 3), _FAR)])
        bhi_p = np.concatenate([bhi, np.full((pad, 3), _FAR)])
    else:
        blo_p, bhi_p = blo, bhi
    glo = blo_p.reshape(ng, GROUP, 3).min(axis=1)
    ghi = bhi_p.reshape(ng, GROUP, 3).max(axis=1)
    ghi = np.where(glo >= _FAR, _FAR, ghi)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                    device=pack.v0.device)
    return BlockAccel(block_lo=f32(blo_p), block_hi=f32(bhi_p),
                      group_lo=f32(glo), group_hi=f32(ghi), w6=pack.w6,
                      w4=pack.w4, valid=pack.valid)


@profiling.phase("accel.build")
def attach_accel(scene, kind: str = "auto", **kwargs):
    """Build the accelerator `kind` (see the module docstring) over the
    scene's triangles on the scene's device and return the updated
    Scene, its pack re-ordered as the kind needs. Unknown or
    kind-mismatched options raise TypeError, as in the JAX package."""
    if kind not in KINDS:
        raise ValueError(f"unknown accel kind {kind!r}; one of {KINDS}")
    pack = scene.tris
    if kind == "auto":
        kind = "pallas_sah4" if pack.n_valid <= MAX_W4_TRIS else "pallas_hbm"
    unknown = set(kwargs) - _KIND_KWARGS.get(kind, set())
    if unknown:
        raise TypeError(
            f"attach_accel(kind={kind!r}) got unsupported options "
            f"{sorted(unknown)}; this kind accepts "
            f"{sorted(_KIND_KWARGS.get(kind, set())) or 'no options'}")
    if pack.n_valid == 0:
        return scene.replace(accel=None)
    if kind in ("pallas_sah4", "pallas_hbm"):
        new_pack, accel = wide_bvh.build_bvh4_sah(
            pack, width=4 if kind == "pallas_sah4" else 8)
    elif kind == "pallas_sah":
        new_pack, accel = binary_bvh.build_binary_bvh_sah(pack)
    elif kind == "pallas_forest":
        new_pack, accel = forest.build_forest(pack, **kwargs)
    else:
        a = pack_host_arrays(pack)
        new_pack = reorder_pack(pack, morton_order(a["v0"], a["e1"],
                                                   a["e2"], a["valid"]))
        build = {"bvh": bvh.build_bvh, "packet": packet.build_packet_accel,
                 "pallas": tri_blocks.build_tri_blocks,
                 "block": build_accel}[kind]
        accel = build(new_pack, **kwargs)
    return scene.replace(tris=new_pack, accel=accel)


def supports_kernel_attr(accel) -> bool:
    """True when the traversal returns the winners' attribute rows."""
    return isinstance(accel, wide_bvh.WideBVH)


# ---------------------------------------------------------------------------
# the block traversal (plain PyTorch, as in the JAX package)
# ---------------------------------------------------------------------------

def _slab(o, rcp, lo, hi, tmin, tmax):
    """Ray-box slab test (BVH.cpp:513-584 semantics) of rays (..., 3)
    against a box (3,); NaN from 0*inf leaves that axis unconstrained."""
    return bvh._slab_enter(o, rcp, lo, hi, tmin, tmax)[1]


def _tile_rays(o, d, tmin, tmax):
    """Rays padded to whole tiles of min(TILE, N) (pad rays have an empty
    interval), as (NT, tile, ...) tensors, and the block-major operands."""
    n = o.shape[0]
    tile = min(TILE, n)
    nt = -(-n // tile)
    n_pad = nt * tile
    pad = lambda x, v: torch.cat([x, torch.full((n_pad - n,) + x.shape[1:],
                                                v, device=x.device)])
    o_t = pad(o, 0.0).reshape(nt, tile, 3)
    d_t = pad(d, 1.0).reshape(nt, tile, 3)
    tmin_t = pad(tmin, 0.0).reshape(nt, tile)
    tmax_t = pad(tmax, -1.0).reshape(nt, tile)
    return o_t, d_t, tmin_t, tmax_t


def _block_t(accel: BlockAccel, bi: int, o, d, m, tmin, tmax):
    """t of every ray (R, ...) against block bi's triangles (..., BLOCK),
    _BIG where not accepted; the sums in ops/pluecker.py's order."""
    rows = slice(bi * BLOCK, (bi + 1) * BLOCK)
    w6, w4 = accel.w6[:, rows], accel.w4[:, rows]
    tm = triangle_t([w6[r, :, 0] for r in range(6)],
                    [w6[r, :, 1] for r in range(6)],
                    [w6[r, :, 2] for r in range(6)],
                    [w4[r] for r in range(4)],
                    [d[..., a, None] for a in range(3)]
                    + [m[..., a, None] for a in range(3)],
                    [o[..., a, None] for a in range(3)], tmin[..., None],
                    tmax[..., None])
    return torch.where(accel.valid[rows], tm, _BIG)


def _blocks_of(accel: BlockAccel, live_tiles, o_t, rcp, tmin_t, cur_of):
    """For each group and each of its blocks, in order, the tiles (of
    live_tiles) that some ray of which passes the box: yields (block,
    tiles). cur_of(tiles) gives those tiles' current tmax."""
    real_nb = accel.w6.shape[1] // BLOCK
    for gi in range(accel.group_lo.shape[0]):
        gl, gh = accel.group_lo[gi], accel.group_hi[gi]
        tiles = live_tiles()
        if tiles.numel() == 0:
            return
        ghit = _slab(o_t[tiles], rcp[tiles], gl, gh, tmin_t[tiles],
                     cur_of(tiles)).any(-1)
        g_tiles = tiles[ghit]
        if g_tiles.numel() == 0:
            continue
        for bj in range(GROUP):
            bi = gi * GROUP + bj
            bhit = _slab(o_t[g_tiles], rcp[g_tiles], accel.block_lo[bi],
                         accel.block_hi[bi], tmin_t[g_tiles],
                         cur_of(g_tiles)).any(-1)
            b_tiles = g_tiles[bhit]
            if b_tiles.numel():
                yield min(bi, real_nb - 1), b_tiles


@torch.no_grad()
def accel_intersect_triangles(accel: BlockAccel, o, d, tmin, tmax):
    """Closest hit against the Morton-ordered blocks with group and block
    culling per ray tile (JAX ops/accel.py:504-626): a tile visits a
    group, then a block, when some ray of it passes the box against
    [tmin, min(tmax, best)]; a visited block tests every ray of the tile
    (first lane on ties), and a block's hit replaces the best only when
    strictly nearer. Returns (t (N,), _BIG on a miss; id (N,) int32)."""
    n = o.shape[0]
    tmin, tmax = ray_bounds(o, tmin, tmax)
    o_t, d_t, tmin_t, tmax_t = _tile_rays(o.detach(), d.detach(), tmin,
                                          tmax)
    nt, tile = tmin_t.shape
    rcp = 1.0 / d_t
    m_t = cross(o_t, d_t)
    best = torch.full((nt, tile), _BIG, device=o.device)
    best_id = torch.zeros((nt, tile), dtype=torch.int64, device=o.device)
    all_tiles = torch.arange(nt, device=o.device)
    cur_of = lambda tl: torch.minimum(tmax_t[tl], best[tl])
    for bi, tiles in _blocks_of(accel, lambda: all_tiles, o_t, rcp, tmin_t,
                                cur_of):
        tm = _block_t(accel, bi, o_t[tiles], d_t[tiles], m_t[tiles],
                      tmin_t[tiles], cur_of(tiles))
        bmin, barg = tm.min(-1)
        better = bmin < best[tiles]
        best[tiles] = torch.where(better, bmin, best[tiles])
        best_id[tiles] = torch.where(better, barg + bi * BLOCK,
                                     best_id[tiles])
    return best.reshape(-1)[:n], best_id.reshape(-1)[:n].to(torch.int32)


@torch.no_grad()
def accel_any_hit_triangles(accel: BlockAccel, o, d, tmin, tmax):
    """Occlusion against the blocks (JAX ops/accel.py:319-411): rays
    resolve at their first accepted triangle, and a tile skips groups
    and blocks that no unresolved ray of it passes. Returns (N,) bool."""
    n = o.shape[0]
    tmin, tmax = ray_bounds(o, tmin, tmax)
    o_t, d_t, tmin_t, tmax_t = _tile_rays(o.detach(), d.detach(), tmin,
                                          tmax)
    nt, tile = tmin_t.shape
    rcp = 1.0 / d_t
    m_t = cross(o_t, d_t)
    occ = torch.zeros((nt, tile), dtype=torch.bool, device=o.device)
    all_tiles = torch.arange(nt, device=o.device)
    # an occluded ray takes part in no further box test
    cur_of = lambda tl: torch.where(occ[tl], -torch.inf, tmax_t[tl])
    for bi, tiles in _blocks_of(accel, lambda: all_tiles, o_t, rcp, tmin_t,
                                cur_of):
        tm = _block_t(accel, bi, o_t[tiles], d_t[tiles], m_t[tiles],
                      tmin_t[tiles], tmax_t[tiles])
        occ[tiles] |= (tm < _BIG).any(-1)
    return occ.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# scene-level queries
# ---------------------------------------------------------------------------

def _zeros(o):
    z = torch.zeros(o.shape[:1], dtype=torch.int32, device=o.device)
    return z, z


def _triangles_closest(accel, o, d, tmin, tmax, with_stats: bool):
    """(t, id, attr or None) of the triangles through `accel`, and
    with_stats the per-ray (box tests, triangle tests): the traversal's
    own counters for the wide and binary trees, zeros for the kinds the
    JAX package gives zeros (JAX ops/accel.py:280-283)."""
    if isinstance(accel, wide_bvh.WideBVH):
        return wide_bvh.closest_hit_triangles(accel, o, d, tmin, tmax,
                                              with_stats)
    if isinstance(accel, binary_bvh.BinaryBVH):
        t, ids, *tests = binary_bvh.closest_hit_triangles(
            accel, o, d, tmin, tmax, with_stats)
        return (t, ids, None, *tests)
    if isinstance(accel, forest.Forest):
        t, ids = forest.forest_closest_hit_triangles(accel, o, d, tmin, tmax)
    elif isinstance(accel, tri_blocks.TriBlocks):
        t, ids = tri_blocks.closest_hit(accel, o, d, tmin, tmax)
    elif isinstance(accel, bvh.BVHAccel):
        t, ids = bvh.bvh_closest_hit_triangles(accel, o, d, tmin, tmax)
    elif isinstance(accel, packet.PacketAccel):
        t, ids = packet.packet_closest_hit_triangles(accel, o, d, tmin, tmax)
    elif isinstance(accel, BlockAccel):
        t, ids = accel_intersect_triangles(accel, o, d, tmin, tmax)
    else:
        raise TypeError(f"no traversal for {type(accel).__name__}")
    return (t, ids, None, *_zeros(o)) if with_stats else (t, ids, None)


def _triangles_occluded(accel, o, d, tmin, tmax, with_stats: bool):
    """(N,) bool occlusion by the triangles through `accel`; with_stats
    appends the per-ray (box tests, triangle tests) as
    _triangles_closest gives them (JAX ops/accel.py:446-449)."""
    tests = ()
    tree = {wide_bvh.WideBVH: wide_bvh,
            binary_bvh.BinaryBVH: binary_bvh}.get(type(accel))
    if tree is not None:
        res = tree.any_hit_triangles(accel, o, d, tmin, tmax, with_stats)
        t, *tests = res if with_stats else (res,)
    elif isinstance(accel, forest.Forest):
        t = forest.forest_closest_hit_triangles(accel, o, d, tmin, tmax,
                                                any_hit=True)[0]
    elif isinstance(accel, tri_blocks.TriBlocks):
        t = tri_blocks.any_hit(accel, o, d, tmin, tmax)
    elif isinstance(accel, bvh.BVHAccel):
        t = bvh.bvh_closest_hit_triangles(accel, o, d, tmin, tmax,
                                          any_hit=True)[0]
    elif isinstance(accel, packet.PacketAccel):
        t = packet.packet_closest_hit_triangles(accel, o, d, tmin, tmax,
                                                any_hit=True)[0]
    elif isinstance(accel, BlockAccel):
        t = torch.where(accel_any_hit_triangles(accel, o, d, tmin, tmax),
                        0.0, _BIG)
    else:
        raise TypeError(f"no traversal for {type(accel).__name__}")
    if with_stats and not tests:
        tests = _zeros(o)
    return (t < _BIG, *tests) if with_stats else (t < _BIG,)


def scene_closest_hit(accel, spheres, planes, o, d, tmin=0.0,
                      tmax=MIRO_TMAX, with_stats: bool = False,
                      blpatches=None):
    """Scene::trace with an accelerator (Scene.cpp:214-231): triangles
    through the traversal, then spheres, planes and the bilinear patches
    (JAX ops/accel.py:274-278, the patches last, so the first primitive
    wins a tie; the patch t keeps its gradient, JAX
    ops/pallas_bvh.py:581-592). Returns (Hit, attr), attr being the
    (N, 32) rows of the triangle winners where the traversal extracts
    them (supports_kernel_attr) and None elsewhere; with_stats appends
    the traversal's per-ray box and triangle tests (N,) int32 (JAX
    ops/accel.py:247-283: spheres, planes and patches are not
    counted)."""
    t, ids, attr, *tests = _triangles_closest(accel, o, d, tmin, tmax,
                                              with_stats)
    h = _then_pools(_hit(t, ids, PRIM_TRI), spheres, planes, o, d, tmin,
                    tmax, blpatches)
    return (h, attr, *tests)


def accel_closest_hit(accel: BlockAccel, tris: TrianglePack, spheres,
                      planes, o, d, tmin=0.0, tmax=MIRO_TMAX,
                      blpatches=None) -> Hit:
    """Scene::trace with the block accelerator (JAX ops/accel.py:629
    accel_closest_hit): its culled triangle pass, then spheres, planes
    and the bilinear patches. `tris` is the pack `accel` was built from
    (the accelerator holds its rows)."""
    return scene_closest_hit(accel, spheres, planes, o, d, tmin, tmax,
                             blpatches=blpatches)[0]


def scene_any_hit(accel, spheres, planes, o, d, tmin=0.0, tmax=MIRO_TMAX,
                  with_stats: bool = False, blpatches=None):
    """Boolean shadow occlusion across all primitive pools, the bilinear
    patches last and without a gradient (JAX ops/accel.py:414-449,
    ops/pallas_bvh.py:601-610); with_stats (occluded, box tests,
    triangle tests) as scene_closest_hit counts them."""
    occ, *tests = _triangles_occluded(accel, o, d, tmin, tmax, with_stats)
    occ = _occluded_by_pools(occ, spheres, planes, o, d, tmin, tmax,
                             blpatches)
    return (occ, *tests) if with_stats else occ
