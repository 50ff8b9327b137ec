"""Segmented sums in one fixed order on every device: the gradient
scatters of the port.

`segment_sum(values (N, C), ids (N,), n_rows)` returns (n_rows, C), row
r the sum of the values of the lanes i with ids[i] == r, added in this
order, the same on the card and on the CPU:
- the lanes are sorted by id, stably (torch.sort(stable=True) here, a
  radix sort of its own in the kernel); a stable sort's permutation is
  unique, so it is the same on every device, and within a row's run a
  term's rank is its place in lane order;
- round s, h = 2^s: the term at rank k with k % 2h == 0 adds the term at
  rank k + h, if k + h < the run's length L (the left term first);
- after ceil(log2 L) rounds rank 0 holds the row's sum;
- an empty row is +0.0.
Each add is one float32 addition rounded to nearest, so the order fixes
the bits. The backward of F.embedding (embedding_dense_backward) and
index_add_ add in the device's order instead: partial segment sums on
the card, lane order on the CPU, and on the card index_add_ adds by
float atomics, in any order, flushing subnormal sums to zero.

On CUDA tensors it runs the hand-written kernels of csrc/segment_sum.cu
(a kernel of the port alone; no Pallas kernel of the JAX package does
this) in one call: with n_rows > 1 a stable LSD radix sort of the ids
over their ceil(log2 n_rows) bits, an integer count of each row's terms
and a scan of the counts into the runs; a zero-fill of the rows; then
the sums over the runs only, short runs many to a warp (a lane streaming
a run and column through the same additions), longer runs in 1,024-rank
tiles and a pass over their partials. With one row there is no sort.
On CPU tensors it runs `segment_sum_plain`, the same rounds as PyTorch
ops. For a CUDA tensor it launches the kernel or raises; nothing gives
way to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from cse168_raytracer_tpu_torch.ops import cuda_build
from cse168_raytracer_tpu_torch.utils import profiling

# what a call of the kernel runs (segment_sum_launch's `parts`): the sort
# and the scan into runs, the sums, the zero-fill of the rows
SORT, SUMS, ZERO = 1, 2, 4

# the counters of the kernel's calls, launch.segment_sum.<mode>, counted
# where the wrapper launches them: "sums", every segment_sum on the card,
# and "sort", those calls and stable_order's that sort (n_rows > 1)
LAUNCH = "launch.segment_sum"
profiling.declare(LAUNCH, ("sums", "sort"))


def _runs(ids: torch.Tensor, n_rows: int):
    """(perm, row_start): the stable sort's permutation of ids (sorted as
    int32: half the radix passes of int64, the same permutation) and
    each row's first sorted position, (n_rows + 1,) int64, the last N."""
    keys, perm = torch.sort(ids.to(torch.int32), stable=True)
    bounds = torch.arange(n_rows + 1, dtype=keys.dtype, device=ids.device)
    return perm, torch.searchsorted(keys, bounds)


@torch.no_grad()
def segment_sum_plain(values: torch.Tensor, ids: torch.Tensor,
                      n_rows: int) -> torch.Tensor:
    """The plain PyTorch version: the rounds of the module docstring as
    whole-array ops on the sorted (N, C) terms."""
    n, cols = values.shape
    out = values.new_zeros((n_rows, cols))
    if n == 0:
        return out
    perm, row_start = _runs(ids.long(), n_rows)
    v = values[perm]
    keys = ids.long()[perm]
    rank = torch.arange(n, device=values.device) - row_start[keys]
    length = (row_start[keys + 1] - row_start[keys])
    h = 1
    while h < int(length.max()):
        take = torch.nonzero((rank % (2 * h) == 0) & (rank + h < length))[:, 0]
        v = v.index_put((take,), v[take] + v[take + h])
        h *= 2
    head = rank == 0
    return out.index_put((keys[head],), v[head])


_lib = None


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load_library("segment_sum.cu"))
    return _lib


def _bind(lib):
    """Declare the C interface of a build of segment_sum.cu."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segment_sum_scratch_bytes.argtypes = [ll, i, i]
    lib.segment_sum_scratch_bytes.restype = ll
    lib.segment_sum_launch.argtypes = [p, i, p, ll, i, p, p, p, i, p]
    lib.segment_sum_launch.restype = i
    return lib


def scratch_for(n: int, cols: int, n_rows: int, device) -> torch.Tensor:
    """The kernel's scratch for a call of n terms and cols columns on
    n_rows rows."""
    nbytes = _kernel_lib().segment_sum_scratch_bytes(n, cols, n_rows)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def run_parts(values, ids: torch.Tensor, n_rows: int, perm: torch.Tensor,
              scratch: torch.Tensor, out: torch.Tensor, parts: int) -> None:
    """One call of the kernel: `parts` of SORT | SUMS | ZERO on the given
    buffers (values may be None for SORT alone). Raises on a launch
    error."""
    n, cols = ids.shape[0], out.shape[1]
    ptr = lambda x: ctypes.c_void_p(0 if x is None else x.data_ptr())
    rc = _kernel_lib().segment_sum_launch(
        ptr(values), cols, ptr(ids), n, n_rows, ptr(perm), ptr(scratch),
        ptr(out), parts,
        ctypes.c_void_p(torch.cuda.current_stream(ids.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {rc}")


def _launch(values: torch.Tensor, ids: torch.Tensor,
            n_rows: int) -> torch.Tensor:
    """One call of the kernel, sort (n_rows > 1), zero-fill and sums."""
    n, cols = values.shape
    dev = values.device
    perm = torch.empty(n if n_rows > 1 else 0, dtype=torch.int32,
                       device=dev)
    out = torch.empty((n_rows, cols), dtype=values.dtype, device=dev)
    with profiling.span("segment_sum.launch"):
        run_parts(values, ids, n_rows, perm,
                  scratch_for(n, cols, n_rows, dev), out, SORT | SUMS | ZERO)
    profiling.count(LAUNCH + ".sums")
    if n_rows > 1:
        profiling.count(LAUNCH + ".sort")
    return out


def _sort_launch(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The kernel's sort alone (n_rows > 1): the permutation, int32."""
    perm = torch.empty(ids.shape[0], dtype=torch.int32, device=ids.device)
    out = torch.empty((n_rows, 1), device=ids.device)
    run_parts(None, ids, n_rows, perm,
              scratch_for(ids.shape[0], 1, n_rows, ids.device), out, SORT)
    profiling.count(LAUNCH + ".sort")
    return perm


def stable_order(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(N,) int32: the lanes sorted by id, stably (ids in [0, n_rows)).
    On the card the kernel's own radix sort over the ids' ceil(log2
    n_rows) bits alone (n_rows > 1), no sums; on the CPU torch.sort."""
    if ids.device.type == "cpu":
        return torch.sort(ids, stable=True)[1].to(torch.int32)
    if n_rows < 2 or ids.numel() == 0:
        raise ValueError("stable_order: need n_rows > 1 and some ids")
    return _sort_launch(ids.long().contiguous(), n_rows)


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """(n_rows, C): row r the sum, in the module docstring's order, of
    values[i] (values (N, C)) over the lanes with ids[i] == r; ids (N,)
    integers in [0, n_rows). Not differentiable itself: the backward
    functions of the port call it."""
    if values.dim() != 2 or ids.shape != values.shape[:1]:
        raise ValueError(f"segment_sum: need values (N, C) and ids (N,), "
                         f"got {tuple(values.shape)} and {tuple(ids.shape)}")
    profiling.record("segment_sum", (values.shape[0], values.shape[1],
                                     int(n_rows)))
    if values.device.type == "cpu":
        return segment_sum_plain(values, ids, n_rows)
    if values.device.type != "cuda":
        raise ValueError(f"segment_sum: no kernel for tensors on "
                         f"{values.device}")
    if values.dtype != torch.float32 or ids.device != values.device \
            or ids.dtype.is_floating_point:
        raise ValueError("segment_sum: need float32 values and integer ids "
                         "on one device")
    n, cols = values.shape
    if n >= 2 ** 31 or n_rows >= 2 ** 31 or cols < 1:
        raise ValueError("segment_sum: too many terms or rows, or no column")
    if n == 0 or n_rows == 0:
        return values.new_zeros((n_rows, cols))
    return _launch(values.detach().contiguous(), ids.long().contiguous(),
                   n_rows)
