"""The photon gather on the card: grid_irradiance's forward in one launch
of csrc/photon_gather.cu.

`gather(grid, p, n, power, coarse_power)` returns what ops/photon.py's
gather_levels returns for the same arguments, bit for bit: the
irradiance (N, 3), the fine level's r'^2 (N,), the coarse level's (N,)
and use_coarse (N,) bool; the coarse r'^2 only where use_coarse (0 where
the kernel did not gather the coarse level, which it does only where
the fine level weighs under knn within its radius; the backward reads
it nowhere else). A kernel of the port alone (the JAX package leaves the
gather to XLA); the kernel's source says how it keeps the twin's order.

The wrapper takes CUDA tensors alone: float32 points and normals (N, 3)
and powers, contiguous, and a grid of at most MAX_PER_CELL photons a
bucket whose coarse level has the same max_per_cell. Anything else
raises ValueError before the library is loaded. Each launch counts
`launch.photon_gather.forward`; zero points launch nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import PI
from cse168_raytracer_tpu_torch.ops import cuda_build
from cse168_raytracer_tpu_torch.utils import profiling

LAUNCH = "launch.photon_gather"
profiling.declare(LAUNCH, ("forward",))

# 27 * max_per_cell padded to at most 2,048 candidates a point
# (MAX_PER_CELL in the source)
MAX_PER_CELL = 2048 // 27

_lib = None


class _Level(ctypes.Structure):
    """LevelArgs of csrc/photon_gather.cu."""
    _fields_ = [(f, ctypes.c_void_p) for f in
                ("pos", "dir", "power", "weight", "cell_hash", "radius")] \
        + [(f, ctypes.c_longlong) for f in
           ("rows", "n_valid", "table_size", "max_per_cell")]


def _kernel_lib():
    global _lib
    if _lib is None:
        _lib = _bind(cuda_build.load_library("photon_gather.cu"))
    return _lib


def _bind(lib):
    """Declare the C interface of a build of photon_gather.cu."""
    p, ll, f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_float
    lv = ctypes.POINTER(_Level)
    lib.photon_gather_launch.argtypes = [p, p, ll, lv, lv, f, f, p, p, p, p,
                                         p]
    lib.photon_gather_launch.restype = ctypes.c_int
    return lib


def _need(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(f"photon gather kernel: {what}")


def _check_points(p: torch.Tensor, n: torch.Tensor) -> None:
    for name, x in (("points", p), ("normals", n)):
        _need(x.dtype == torch.float32 and x.dim() == 2 and x.shape[1] == 3,
              f"{name} must be float32 (N, 3), got {x.dtype} "
              f"{tuple(x.shape)}")
        _need(x.is_contiguous(), f"{name} must be contiguous")
    _need(p.shape == n.shape and p.device == n.device,
          "points and normals differ in shape or device")


def _check_level(level, power: torch.Tensor, device) -> None:
    rows = level.pos.shape[0]
    _need(1 <= level.max_per_cell <= MAX_PER_CELL,
          f"max_per_cell {level.max_per_cell} is beyond the kernel's "
          f"{MAX_PER_CELL}")
    for name, x, shape, dtype in (
            ("pos", level.pos, (rows, 3), torch.float32),
            ("dir", level.dir, (rows, 3), torch.float32),
            ("power", power, (rows, 3), torch.float32),
            ("weight", level.weight, (rows,), torch.float32),
            ("cell_hash", level.cell_hash, (rows,), torch.int32)):
        _need(x.dtype == dtype and tuple(x.shape) == shape,
              f"grid {name} must be {dtype} {shape}, got {x.dtype} "
              f"{tuple(x.shape)}")
        _need(x.is_contiguous(), f"grid {name} must be contiguous")
        _need(x.device == device, f"grid {name} is on {x.device}, the "
              f"points on {device}")
    _need(level.radius.dtype == torch.float32 and level.radius.numel() == 1
          and level.radius.device == device, "grid radius must be a float32 "
          "scalar on the points' device")
    _need(rows < 2 ** 31 and 0 <= level.n_valid <= rows
          and 1 <= level.table_size <= 2 ** 31,
          "grid sizes out of the kernel's int32 range")


def check(grid, p: torch.Tensor, n: torch.Tensor, power: torch.Tensor,
          coarse_power) -> None:
    """Raise ValueError on arguments the kernel does not take (loads
    nothing)."""
    _check_points(p, n)
    _check_level(grid, power, p.device)
    if grid.coarse is not None:
        _check_level(grid.coarse, coarse_power, p.device)
        _need(grid.coarse.max_per_cell == grid.max_per_cell,
              "the coarse level's max_per_cell differs from the fine one's")
    _need(p.device.type == "cuda", f"no kernel for tensors on {p.device}")


def _level(level, power: torch.Tensor) -> _Level:
    ptr = lambda x: x.data_ptr()
    return _Level(ptr(level.pos), ptr(level.dir), ptr(power.detach()),
                  ptr(level.weight), ptr(level.cell_hash), ptr(level.radius),
                  level.pos.shape[0], level.n_valid, level.table_size,
                  level.max_per_cell)


def _launch(grid, p: torch.Tensor, n: torch.Tensor, power: torch.Tensor,
            coarse_power):
    """One launch of the kernel on checked arguments; returns gather's
    four outputs."""
    nn = p.shape[0]
    irr = p.new_empty((nn, 3))
    r2 = p.new_empty((nn,))
    r2_c = p.new_empty((nn,))
    use_c = torch.empty(nn, dtype=torch.bool, device=p.device)
    fine = _level(grid, power)
    coarse = (None if grid.coarse is None
              else ctypes.byref(_level(grid.coarse, coarse_power)))
    rc = _kernel_lib().photon_gather_launch(
        p.data_ptr(), n.data_ptr(), nn, ctypes.byref(fine), coarse,
        float(np.float32(grid.knn)), float(np.float32(PI)), irr.data_ptr(),
        r2.data_ptr(), r2_c.data_ptr(), use_c.data_ptr(),
        ctypes.c_void_p(torch.cuda.current_stream(p.device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f"photon gather launch failed: CUDA error {rc}")
    profiling.count(LAUNCH + ".forward")
    return irr, r2, r2_c, use_c


def gather(grid, p: torch.Tensor, n: torch.Tensor, power: torch.Tensor,
           coarse_power):
    """(irradiance (N, 3), r'^2 (N,), coarse r'^2 (N,), use_coarse (N,)
    bool) of the points p with unit normals n over `grid` (a PhotonGrid),
    its stored powers `power` and its coarse level's `coarse_power`: one
    launch of the kernel (none for zero points)."""
    check(grid, p, n, power, coarse_power)
    if p.shape[0] == 0:
        empty = p.new_empty((0,))
        return (p.new_empty((0, 3)), empty, empty.clone(),
                torch.empty(0, dtype=torch.bool, device=p.device))
    return _launch(grid, p, n, power, coarse_power)
