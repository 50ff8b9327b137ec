"""The yardstick of the kernels' roofline shares: the card's peaks and
the least bytes and operations each kernel's calls need, counted from
the calls' shapes (never from what a tree or a kernel happened to do).

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W limit):
3.35 TB/s of HBM, 67 TFLOP/s in float32 outside the tensor cores.
A share is the least time, the larger of bytes over the bandwidth and
operations over the float32 rate, over the measured device time.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
F32_FLOPS = 67e12

F32, I32, I64 = 4, 4, 8
RAY_IN = 8 * F32            # origin, direction, tmin, tmax
ATTR_ROW = 32 * F32         # the winner's attribute row
TRI_BYTES = 9 * F32         # a triangle's three vertices
OPS_PER_RAY = 12            # the ray's reciprocals and moment
OPS_PER_TRI = 53            # one ray-triangle test (the leaf test)


def least_seconds(nbytes: float, ops: float):
    """(seconds, "bytes" or "operations"): the roofline's least time and
    the term that bounds it."""
    tb, to = nbytes / HBM_BYTES_S, ops / F32_FLOPS
    return (tb, "bytes") if tb >= to else (to, "operations")


def traverse_call(live_rays: int, n_tris: int, closest: bool):
    """(bytes, operations) of one traversal call: each live ray read
    once and its answer written once (t and id, and the attribute row
    for a closest hit; t for an occlusion test), the scene's triangles
    read once; a ray's set-up and one triangle test a live ray."""
    out = (F32 + I32 + ATTR_ROW) if closest else F32
    nbytes = live_rays * (RAY_IN + out) + n_tris * TRI_BYTES
    return nbytes, live_rays * (OPS_PER_RAY + OPS_PER_TRI)


def segment_sum_call(terms: int, cols: int, n_rows: int):
    """(bytes, operations) of one segment sum: the terms and their int64
    row ids read once, the output rows written once; an addition a
    term and column."""
    return (terms * cols * F32 + terms * I64 + n_rows * cols * F32,
            terms * cols)
