"""Segmented sums in one fixed order on every device: the gradient
scatters of the port.

`segment_sum(values (N, C), ids (N,), n_rows)` returns (n_rows, C), row
r the sum of the values of the lanes i with ids[i] == r, added in this
order, the same on the card and on the CPU:
- the lanes are sorted by id with torch.sort(stable=True); a stable
  sort's permutation is unique, so it is the same on every device, and
  within a row's run a term's rank is its place in lane order;
- round s, h = 2^s: the term at rank k with k % 2h == 0 adds the term at
  rank k + h, if k + h < the run's length L (the left term first);
- after ceil(log2 L) rounds rank 0 holds the row's sum;
- an empty row is +0.0.
Each add is one float32 addition rounded to nearest, so the order fixes
the bits. The backward of F.embedding (embedding_dense_backward) and
index_add_ add in the device's order instead: partial segment sums on
the card, lane order on the CPU, and on the card index_add_ adds by
float atomics, in any order, flushing subnormal sums to zero.

On CUDA tensors it runs the hand-written kernel csrc/segment_sum.cu (a
kernel of the port alone; no Pallas kernel of the JAX package does
this): one warp a 1,024-rank tile of every run doing rounds 0-9, and one
warp a row over its tiles' partials for rounds 10 and up, two launches
after the sort. On CPU tensors it runs `segment_sum_plain`, the same
rounds as PyTorch ops. For a CUDA tensor it launches the kernel or
raises; nothing gives way to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from cse168_raytracer_tpu_torch.ops import cuda_build

TILE = 1024

# kernel launches (the pair of a segment_sum call), counted where the
# wrapper launches them
LAUNCHES = {"segment_sum": 0}


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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum_launch.argtypes = [p, i, p, p, i, ctypes.c_longlong, p,
                                       p, p]
    lib.segment_sum_launch.restype = i
    return lib


def _launch(values: torch.Tensor, ids: torch.Tensor,
            n_rows: int) -> torch.Tensor:
    """The sort, then the kernel's two launches."""
    n, cols = values.shape
    dev = values.device
    perm, row_start = _runs(ids, n_rows)
    # tile t of row r has the slot r + row_start[r] // 1024 + t
    slots = n_rows + n // TILE
    partial = torch.empty((slots, cols), dtype=values.dtype, device=dev)
    out = torch.empty((n_rows, cols), dtype=values.dtype, device=dev)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    rc = _kernel_lib().segment_sum_launch(
        ptr(values), cols, ptr(perm), ptr(row_start), n_rows, slots,
        ptr(partial), ptr(out),
        ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {rc}")
    LAUNCHES["segment_sum"] += 1
    return out


def segment_sum(values: torch.Tensor, ids: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """(n_rows, C): row r the sum, in the module docstring's order, of
    values[i] (values (N, C)) over the lanes with ids[i] == r; ids (N,)
    integers in [0, n_rows). Not differentiable itself: the backward
    functions of the port call it."""
    if values.dim() != 2 or ids.shape != values.shape[:1]:
        raise ValueError(f"segment_sum: need values (N, C) and ids (N,), "
                         f"got {tuple(values.shape)} and {tuple(ids.shape)}")
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
