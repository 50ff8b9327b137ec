"""Traversal statistics (the -DSTATS counters, Stats.{h,cpp}).

Counterpart of cse168_raytracer_tpu/ops/stats.py:71-105 for the port's
one accelerator: mean ray-box and ray-triangle tests per ray, read from
the counters inside the traversal itself (kernel K3 on the card,
ops/wide_bvh.walk_plain on the CPU), the reference's A2 accounting
(writeup/A2/Readme.tex:90-107). Box tests are W per internal-node visit
and triangle tests K per leaf visit; the counts are per ray, where the
TPU kernel bills a 256-ray tile's visits to every ray of the tile (see
ops/wide_bvh.py). The JAX package's separate approximating pass for its
block accelerator (`measure_traversal_stats`, :32-68) comes with that
accelerator, ROADMAP item A17. Ray counts themselves are kept by the
integrator (render/integrator.py RenderStats).
"""

from __future__ import annotations

import dataclasses

import torch

from cse168_raytracer_tpu_torch.config import MIRO_TMAX
from cse168_raytracer_tpu_torch.ops.wide_bvh import (WideBVH,
                                                     closest_hit_triangles)


@dataclasses.dataclass
class TraversalStats:
    box_tests_per_ray: torch.Tensor   # () float64
    tri_tests_per_ray: torch.Tensor   # () float64
    rays: int


def traversal_stats(accel: WideBVH, o, d, tmin=0.0,
                    tmax=MIRO_TMAX) -> TraversalStats:
    """Mean box and triangle tests per ray of closest-hit rays (o, d)
    through the tree, from its in-traversal counters."""
    if not isinstance(accel, WideBVH):
        raise NotImplementedError(
            f"accelerator {type(accel).__name__}: only WideBVH is ported")
    n = o.shape[0]
    _, _, _, box, tri = closest_hit_triangles(accel, o, d, tmin, tmax,
                                              with_stats=True)
    mean = lambda x: x.sum(dtype=torch.int64).double() / max(n, 1)
    return TraversalStats(box_tests_per_ray=mean(box),
                          tri_tests_per_ray=mean(tri), rays=n)
