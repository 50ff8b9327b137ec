"""Brute force over Morton-ordered 256-triangle blocks (attach_accel kind
"pallas"): host build, CUDA kernel (K6), plain version.

Counterpart of cse168_raytracer_tpu/ops/pallas_intersect.py: `TriBlocks`
is its PallasTriBlocks (:54) and `build_tri_blocks` its
build_pallas_blocks (:73), with the same layout, so the arrays are
byte-equal: w6 (NB, 6, 3*256) [beta | gamma | den] operand columns, w4
(NB, 4, 256) t-numerator columns, aabb (NB, 8) [lo hi pad2].

`closest_hit` runs the hand-written CUDA kernel csrc/tri_blocks.cu on
CUDA tensors (three launches: the tiles' cull, the tests of the passing
blocks shared by four CTAs a tile, the decoding of each ray's best); it
replaces the Pallas kernel `_kernel` (:105, called from
`_pallas_hit_impl` behind the zero-cotangent custom VJP `_pallas_hit`).
On CPU tensors it runs `closest_hit_plain`, the same algorithm in plain
PyTorch. For a CUDA tensor the wrapper launches the kernel or raises; it
never falls back to the plain version. Any-hit goes through the closest
hit, as in the JAX package (ops/accel.py:465-469).

The algorithm is the TPU kernel's: rays in tiles of 256 (padding rays
have tmax = -1); a tile tests a block only when some ray of the tile
passes the block's box with its fixed [tmin, tmax] (tmax does not shrink
with the best hit); each ray keeps the least (t, lane, block) over the
tested triangles, which is the TPU kernel's tie rule (earliest block
within a lane, then the smallest lane, :159-178). Inputs are detached.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.core.vecmath import cross
from cse168_raytracer_tpu_torch.models.geometry import (TrianglePack,
                                                        pack_host_arrays)
from cse168_raytracer_tpu_torch.ops import cuda_build
from cse168_raytracer_tpu_torch.ops.bvh import _slab_enter
from cse168_raytracer_tpu_torch.ops.intersect import _BIG, ray_bounds
from cse168_raytracer_tpu_torch.ops.pluecker import triangle_t
from cse168_raytracer_tpu_torch.ops.wide_bvh import _route, check_launch
from cse168_raytracer_tpu_torch.utils import profiling

BLOCK = 256
RAY_TILE = 256
_FAR = 1.0e30

# the counter of kernel launches, launch.blocks.closest, counted where
# the wrapper launches the kernel
LAUNCH = "launch.blocks"
profiling.declare(LAUNCH, ("closest",))


@dataclasses.dataclass
class TriBlocks:
    """Triangle blocks laid out for the kernel."""
    w6: torch.Tensor    # (NB, 6, 3*BLOCK) [beta | gamma | den] columns
    w4: torch.Tensor    # (NB, 4, BLOCK) t-numerator columns
    aabb: torch.Tensor  # (NB, 8) lo.xyz, hi.xyz, pad, pad

    @property
    def num_blocks(self) -> int:
        return self.w6.shape[0]


def build_tri_blocks(pack: TrianglePack) -> TriBlocks:
    """Repack a Morton-ordered pack (with its w6/w4) for the kernel, on
    the pack's device. Padding triangles have all-zero operands (den = 0,
    never accepted). The pack must be padded to a multiple of 256."""
    t = pack.num_tris
    if t % BLOCK:
        raise ValueError(f"kind 'pallas' needs the pack padded to a "
                         f"multiple of {BLOCK} triangles, got {t}")
    nb = t // BLOCK
    w6 = pack.w6.reshape(6, nb, BLOCK, 3).permute(1, 0, 3, 2)
    w4 = pack.w4.reshape(4, nb, BLOCK).permute(1, 0, 2)
    a = pack_host_arrays(pack)
    v0 = a["v0"].astype(np.float64)
    e1 = a["e1"].astype(np.float64)
    e2 = a["e2"].astype(np.float64)
    valid = a["valid"]
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1)
    lo = np.where(valid[:, None], pts.min(axis=1), _FAR)
    hi = np.where(valid[:, None], pts.max(axis=1), _FAR)
    blo = lo.reshape(nb, BLOCK, 3).min(axis=1)
    bhi = hi.reshape(nb, BLOCK, 3).max(axis=1)
    bhi = np.where(blo >= _FAR, _FAR, bhi)
    aabb = np.concatenate([blo, bhi, np.zeros((nb, 2))], axis=1)
    return TriBlocks(w6=w6.reshape(nb, 6, 3 * BLOCK).contiguous(),
                     w4=w4.contiguous(),
                     aabb=torch.as_tensor(np.asarray(aabb, np.float32),
                                          device=pack.v0.device))


def _tiles(o, d, tmin, tmax):
    """The rays padded to whole tiles, as the TPU kernel pads them."""
    n = o.shape[0]
    n_pad = -(-n // RAY_TILE) * RAY_TILE
    pad = lambda x, v: torch.cat([x, torch.full((n_pad - n,) + x.shape[1:],
                                                v, device=x.device)])
    return pad(o, 0.0), pad(d, 1.0), pad(tmin, 0.0), pad(tmax, -1.0)


@torch.no_grad()
def closest_hit_plain(blocks: TriBlocks, o, d, tmin, tmax,
                      count_pairs: bool = False):
    """Plain PyTorch version of the kernel: (t (N,) f32, _BIG on a miss;
    id (N,) int32 = block*256 + lane, 0 on a miss), and with count_pairs
    the number of (tile, block) pairs that passed the cull."""
    tmin, tmax = ray_bounds(o, tmin, tmax)
    n = o.shape[0]
    o, d, tmin, tmax = _tiles(o.detach(), d.detach(), tmin, tmax)
    rcp = 1.0 / d
    m = cross(o, d)
    bt = torch.full((o.shape[0],), _BIG, device=o.device)
    bl = torch.zeros((o.shape[0],), dtype=torch.int64, device=o.device)
    bb = torch.zeros_like(bl)
    lanes = torch.arange(RAY_TILE, device=o.device)
    step = max(1, ((1 << 24) if o.device.type == "cuda" else (1 << 20))
               // (BLOCK * RAY_TILE))
    pairs = 0
    for b in range(blocks.num_blocks):
        # tri_blocks.cu's slab: the same products, min and max are exact
        box = blocks.aabb[b]
        hit = _slab_enter(o, rcp, box[0:3], box[3:6], tmin, tmax)[1]
        tiles = torch.nonzero(hit.view(-1, RAY_TILE).any(1))[:, 0]
        pairs += tiles.numel()
        w6, w4 = blocks.w6[b], blocks.w4[b]
        rows = lambda c: [w6[r, c * BLOCK:(c + 1) * BLOCK] for r in range(6)]
        for c0 in range(0, tiles.numel(), step):
            idx = (tiles[c0:c0 + step, None] * RAY_TILE + lanes).reshape(-1)
            col = lambda x: x[idx, None]
            tm = triangle_t(rows(0), rows(1), rows(2),
                            [w4[r] for r in range(4)],
                            [col(d[:, a]) for a in range(3)]
                            + [col(m[:, a]) for a in range(3)],
                            [col(o[:, a]) for a in range(3)], col(tmin),
                            col(tmax))                    # (R, BLOCK)
            lt, lane = tm.min(1)                          # the first lane
            cur_t, cur_l = bt[idx], bl[idx]
            upd = (lt < cur_t) | ((lt == cur_t) & (lane < cur_l))
            bt[idx] = torch.where(upd, lt, cur_t)
            bl[idx] = torch.where(upd, lane, cur_l)
            bb[idx] = torch.where(upd, b, bb[idx])
    out = (bt[:n], (bb * BLOCK + bl)[:n].to(torch.int32))
    return out + (pairs,) if count_pairs else out


_lib = None


def _bind(lib):
    """Declare the C interface of a build of tri_blocks.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.tri_blocks_closest.argtypes = [p, p, p, i, p, p, p, p, i, p, p, p,
                                       p, p, p]
    lib.tri_blocks_closest.restype = i
    return lib


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load_library("tri_blocks.cu"))
    return _lib


def _launch(blocks: TriBlocks, o, d, tmin, tmax, count_pairs: bool = False):
    """One launch of the kernel: (t, id), and with count_pairs each
    256-ray tile's number of blocks that passed the cull, (tiles,)
    int32."""
    o = o.detach().contiguous()
    d = d.detach().contiguous()
    dev, n, nb = o.device, o.shape[0], blocks.num_blocks
    f32 = torch.float32
    tables = (("w6", blocks.w6, f32), ("w4", blocks.w4, f32),
              ("aabb", blocks.aabb, f32))
    check_launch(o, d, tmin, tmax, tables)
    if blocks.w6.shape != (nb, 6, 3 * BLOCK) \
            or blocks.w4.shape != (nb, 4, BLOCK) \
            or blocks.aabb.shape != (nb, 8):
        raise ValueError("TriBlocks arrays do not match their block count")
    if nb * BLOCK >= 2 ** 31:
        raise ValueError("too many triangles for one launch")
    for name, x, _ in tables:
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads it 16 bytes at a "
                             "time; need a 16-byte-aligned tensor")
    out_t = torch.empty((n,), dtype=torch.float32, device=dev)
    out_id = torch.empty((n,), dtype=torch.int32, device=dev)
    if n == 0:
        if count_pairs:
            return out_t, out_id, torch.zeros((0,), dtype=torch.int32,
                                              device=dev)
        return out_t, out_id
    tiles = -(-n // RAY_TILE)
    pairs = (torch.empty((tiles,), dtype=torch.int32, device=dev)
             if count_pairs else None)
    # scratch: each tile's bitmask of passing blocks, each ray's best key
    masks = torch.empty((tiles * -(-nb // 32),), dtype=torch.int32,
                        device=dev)
    keys = torch.empty((n,), dtype=torch.int64, device=dev)
    ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _kernel_lib()
    with profiling.span("bvh.launch"):
        rc = lib.tri_blocks_closest(
            ptr(blocks.aabb), ptr(blocks.w6), ptr(blocks.w4), nb, ptr(o),
            ptr(d), ptr(tmin), ptr(tmax), n, ptr(masks), ptr(keys),
            ptr(out_t), ptr(out_id), ptr(pairs), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"tri_blocks launch failed: CUDA error {rc}")
    profiling.count(f"{LAUNCH}.closest")
    profiling.count("bvh.lanes", n)
    return (out_t, out_id, pairs) if count_pairs else (out_t, out_id)


def closest_hit(blocks: TriBlocks, o, d, tmin, tmax):
    """Closest hit of N rays: (t (N,) f32, _BIG on a miss; id (N,) int32
    = block*256 + lane, the Morton pack row)."""
    if not _route(o):
        return closest_hit_plain(blocks, o, d, tmin, tmax)
    tmin, tmax = ray_bounds(o, tmin, tmax)
    return _launch(blocks, o, d, tmin, tmax)


def any_hit(blocks: TriBlocks, o, d, tmin, tmax):
    """Occlusion through the closest hit: t (N,), < _BIG if occluded."""
    return closest_hit(blocks, o, d, tmin, tmax)[0]
