"""Forest of wide BVHs over Morton chunks (attach_accel kind
"pallas_forest").

Counterpart of cse168_raytracer_tpu/ops/pallas_bvh.py:628-764. The
build is the JAX package's: the valid triangles in Morton order are cut
into chunks of about `chunk_tris`, each chunk SAH-built as a 4-wide tree
(ops/wide_bvh.build_bvh4_sah) and bisected while its leaf table exceeds
MAX_LEAVES_PER_CHUNK, and the chunks' leaf-ordered packs are
concatenated, chunk c's triangle ids starting at row starts[c]. The
constant is the JAX package's VMEM budget; it is kept because it sets
the chunk boundaries and so the triangle ids.

Traversal walks the chunks one after another on the host through the
wide-tree kernels (K1 closest hit, K2 any hit), each chunk's tmax shrunk
to the ray's best t so far (an any-hit ray already occluded gets tmax
-1); there is no kernel of its own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cse168_raytracer_tpu_torch.models.geometry import (
    TrianglePack, build_pack_from_arrays, pack_host_arrays)
from cse168_raytracer_tpu_torch.ops import wide_bvh
from cse168_raytracer_tpu_torch.ops.intersect import _BIG, ray_bounds
from cse168_raytracer_tpu_torch.ops.wide_bvh import K, WideBVH

# 80 MB of leaf table (16 * 4K * 4 bytes per leaf): the JAX package's
# VMEM budget for one chunk, pallas_bvh.py:648
MAX_LEAVES_PER_CHUNK = (80 * 1024 * 1024) // (16 * 4 * K * 4)

_PACK_FIELDS = ("v0", "e1", "e2", "n0", "n1", "n2", "t0", "t1", "t2",
                "has_uv", "material_id")


@dataclasses.dataclass
class Forest:
    chunks: tuple   # of WideBVH (W = 4)
    starts: tuple   # int row offsets of the chunks in the scene's pack


def build_forest(pack: TrianglePack, chunk_tris: int = 262_144,
                 require_native: bool | None = None):
    """Split `pack` into Morton-contiguous chunks, SAH-build each, and
    concatenate the leaf-ordered chunk packs into one pack on the pack's
    device. Returns (new_pack without w6/w4, Forest). require_native
    defaults to True for a CUDA pack (see ops/sah.py)."""
    from cse168_raytracer_tpu_torch.ops.accel import morton_order
    device = pack.v0.device
    if require_native is None:
        require_native = device.type == "cuda"
    a = pack_host_arrays(pack)
    valid = a["valid"]
    perm = morton_order(a["v0"], a["e1"], a["e2"], valid)
    perm = perm[valid[perm]]                       # valid rows, Morton order
    n = perm.shape[0]
    n_chunks = max(1, -(-n // chunk_tris))
    per = -(-n // n_chunks)

    def build_chunk(idx):
        sub = build_pack_from_arrays(*(a[f][idx] for f in _PACK_FIELDS),
                                     np.ones(idx.shape[0], bool),
                                     device="cpu")
        sub_pack, bvh = wide_bvh.build_bvh4_sah(
            sub, width=4, require_native=require_native)
        if bvh.n_leaves > MAX_LEAVES_PER_CHUNK and idx.shape[0] > K:
            mid = idx.shape[0] // 2
            return build_chunk(idx[:mid]) + build_chunk(idx[mid:])
        return [(sub_pack, bvh)]

    chunk_packs, chunks, starts = [], [], []
    row0 = 0
    for c in range(n_chunks):
        for sub_pack, bvh in build_chunk(perm[c * per:(c + 1) * per]):
            chunk_packs.append(pack_host_arrays(sub_pack))
            chunks.append(dataclasses.replace(
                bvh, **{f: getattr(bvh, f).to(device)
                        for f in ("cbox", "links", "leafW", "attrA")}))
            starts.append(row0)
            row0 += sub_pack.num_tris

    cat = lambda f: np.concatenate([p[f] for p in chunk_packs])
    new_pack = build_pack_from_arrays(*(cat(f) for f in _PACK_FIELDS),
                                      cat("valid"), device=device,
                                      with_plucker=False)
    return new_pack, Forest(chunks=tuple(chunks), starts=tuple(starts))


def forest_closest_hit_triangles(forest: Forest, o, d, tmin, tmax,
                                 any_hit: bool = False):
    """Closest hit (or occlusion) across the forest with cross-chunk tmax
    shrinking: (t (N,), _BIG on a miss; id (N,) int32 = pack row)."""
    n = o.shape[0]
    (tmax,) = ray_bounds(o, tmax)
    best_t = torch.full((n,), _BIG, device=o.device)
    best_id = torch.zeros((n,), dtype=torch.int32, device=o.device)
    for bvh, start in zip(forest.chunks, forest.starts):
        if any_hit:
            # occluded rays are done: an empty interval culls them
            cur = torch.where(best_t < _BIG, -1.0, tmax)
            t = wide_bvh.any_hit_triangles(bvh, o, d, tmin, cur)
            ids = torch.zeros_like(best_id)
        else:
            cur = torch.minimum(tmax, best_t)
            t, ids, _ = wide_bvh.closest_hit_triangles(bvh, o, d, tmin, cur)
        better = (t < _BIG) & (t < best_t)
        best_t = torch.where(better, t, best_t)
        best_id = torch.where(better, ids + start, best_id)
    return best_t, best_id


def forest_stats(forest: Forest, o, d, tmin, tmax):
    """Box and triangle tests of closest-hit rays summed over the chunks
    (kernel K3), with the traversal's tmax shrinking. Returns two () int64
    totals."""
    n = o.shape[0]
    (tmax,) = ray_bounds(o, tmax)
    best_t = torch.full((n,), _BIG, device=o.device)
    box = tri = torch.zeros((), dtype=torch.int64, device=o.device)
    for bvh in forest.chunks:
        t, _, _, b, c = wide_bvh.closest_hit_triangles(
            bvh, o, d, tmin, torch.minimum(tmax, best_t), with_stats=True)
        best_t = torch.minimum(best_t, t)
        box = box + b.sum(dtype=torch.int64)
        tri = tri + c.sum(dtype=torch.int64)
    return box, tri
