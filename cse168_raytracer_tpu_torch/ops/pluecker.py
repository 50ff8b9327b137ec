"""The ray-triangle test of every traversal, in plain PyTorch.

The plain version of csrc/pluecker.cuh, shared by the kernels' plain
versions (ops/wide_bvh.py, ops/binary_bvh.py, ops/tri_blocks.py) and the
block and packet traversals (ops/accel.py, ops/packet.py): the Pluecker
numerators summed left to right, one IEEE operation at a time, then the
acceptance rule of cse168_raytracer_tpu/ops/pallas_bvh.py:1241-1244
(Triangle.cpp:158). PyTorch runs each operation as its own kernel, so
nothing is fused into a multiply-add, on the CPU or on the card, and the
results equal the CUDA kernels' bit for bit.
"""

from __future__ import annotations

import torch

from cse168_raytracer_tpu_torch.config import EPSILON
from cse168_raytracer_tpu_torch.ops.intersect import _BIG, _DEN_TINY


def sum_rows(rows, vals):
    """rows[0] * vals[0] + rows[1] * vals[1] + ..., left to right."""
    acc = rows[0] * vals[0]
    for w, v in zip(rows[1:], vals[1:]):
        acc = acc + w * v
    return acc


def accept_t(b, g, den, tn, tmin, tmax):
    """t where a triangle with numerators (b, g, den, tn) accepts the ray
    with t in [tmin, tmax], _BIG elsewhere."""
    tiny = den.abs() < _DEN_TINY
    inv = 1.0 / torch.where(tiny, 1.0, den)
    beta, gamma, tt = b * inv, g * inv, tn * inv
    ok = ((beta >= -EPSILON) & (gamma >= -EPSILON)
          & (beta + gamma <= 1.0 + EPSILON) & (tt >= tmin) & (tt <= tmax)
          & ~tiny)
    return torch.where(ok, tt, _BIG)


def triangle_t(w6b, w6g, w6den, w4, r6, o3, tmin, tmax):
    """accept_t of triangles given by their operand rows: six rows each
    for beta, gamma and den against r6 = [d, m], four for the t
    numerator against [o, 1]; the ray's components, r6 and o3, and its
    bounds broadcast against the rows."""
    tn = sum_rows(w4[:3], o3) + w4[3]
    return accept_t(sum_rows(w6b, r6), sum_rows(w6g, r6),
                    sum_rows(w6den, r6), tn, tmin, tmax)
