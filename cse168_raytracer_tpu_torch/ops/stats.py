"""Traversal statistics (the -DSTATS counters, Stats.{h,cpp}).

Counterpart of cse168_raytracer_tpu/ops/stats.py: mean ray-box and
ray-triangle tests per ray, the reference's A2 accounting
(writeup/A2/Readme.tex:90-107). `traversal_stats` reads them from the
counters inside the traversal itself where the accelerator has them:
the wide tree's (kernel K3 on the card, ops/wide_bvh.walk_plain on the
CPU; W box tests per internal visit, K triangle tests per leaf visit),
the binary tree's (kernel K5, ops/binary_bvh.walk_binary_plain; 2 box
tests per internal visit) and the forest's, summed over its chunks with
the traversal's tmax shrinking. The counts are per ray, where the TPU
kernels bill a 256-ray tile's visits to every ray of the tile. For the
block accelerator they come from `measure_traversal_stats`, the JAX
package's approximating pass (:32-68). The other kinds have no counters:
the JAX package sends them to that pass too, which fails on their
missing block boxes; the port raises TypeError and makes up no count.
Ray counts themselves are kept by the integrator (render/integrator.py
RenderStats).
"""

from __future__ import annotations

import dataclasses

import torch

from cse168_raytracer_tpu_torch.config import MIRO_TMAX
from cse168_raytracer_tpu_torch.ops import binary_bvh, forest, wide_bvh
from cse168_raytracer_tpu_torch.ops.accel import (BLOCK, GROUP, BlockAccel,
                                                  _slab)
from cse168_raytracer_tpu_torch.ops.intersect import ray_bounds


@dataclasses.dataclass
class TraversalStats:
    box_tests_per_ray: torch.Tensor   # () float64
    tri_tests_per_ray: torch.Tensor   # () float64
    rays: int


def _per_ray(box, tri, n) -> TraversalStats:
    mean = lambda x: x.sum(dtype=torch.int64).double() / max(n, 1)
    return TraversalStats(box_tests_per_ray=mean(box),
                          tri_tests_per_ray=mean(tri), rays=n)


@torch.no_grad()
def measure_traversal_stats(accel: BlockAccel, o, d, tmin=0.0,
                            tmax=MIRO_TMAX) -> TraversalStats:
    """Per-ray box and triangle tests of the block accelerator, counted
    by a separate pass over all the rays at once: every ray tests every
    group's box, and every block box of the groups some ray passes; a ray
    tests a block's BLOCK triangles when its own box test passes."""
    n = o.shape[0]
    tmin, tmax = ray_bounds(o, tmin, tmax)
    rcp = 1.0 / d
    box = torch.zeros((), dtype=torch.int64, device=o.device)
    tri = torch.zeros((), dtype=torch.int64, device=o.device)
    for gi in range(accel.group_lo.shape[0]):
        box += n                        # every ray slab-tests the group
        if not bool(_slab(o, rcp, accel.group_lo[gi], accel.group_hi[gi],
                          tmin, tmax).any()):
            continue
        for bj in range(GROUP):
            bi = gi * GROUP + bj
            box += n
            tri += _slab(o, rcp, accel.block_lo[bi], accel.block_hi[bi],
                         tmin, tmax).sum() * BLOCK
    return _per_ray(box, tri, n)


def traversal_stats(accel, o, d, tmin=0.0,
                    tmax=MIRO_TMAX) -> TraversalStats:
    """Mean box and triangle tests per ray of closest-hit rays (o, d)
    through `accel` (see the module docstring)."""
    n = o.shape[0]
    if isinstance(accel, (wide_bvh.WideBVH, binary_bvh.BinaryBVH)):
        tree = (wide_bvh if isinstance(accel, wide_bvh.WideBVH)
                else binary_bvh)
        *_, box, tri = tree.closest_hit_triangles(accel, o, d, tmin, tmax,
                                                  with_stats=True)
        return _per_ray(box, tri, n)
    if isinstance(accel, forest.Forest):
        return _per_ray(*forest.forest_stats(accel, o, d, tmin, tmax), n)
    if isinstance(accel, BlockAccel):
        return measure_traversal_stats(accel, o, d, tmin, tmax)
    raise TypeError(f"traversal_stats: the {type(accel).__name__} "
                    "accelerator has no traversal counters")
