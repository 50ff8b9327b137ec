"""Procedural noise: Perlin and Worley, as torch ops (differentiable).

Counterpart of cse168_raytracer_tpu/core/noise.py:27-246, with the same
tables and the same float32 steps:
- Perlin improved noise (lib/include/Perlin.h:13-54, permutation table
  lib/src/Perlin.cpp:3-38): same table, fade and gradient hash;
  perlin_turbulence's octave loop is a Python loop where the JAX package
  scans.
- Worley cellular noise (lib/src/Worley.cpp): the per-cube Knuth LCG
  (cube hash 702395077/915488749/2120969693, churn 1402024253 x +
  586950981), the Poisson count table and DENSITY_ADJUSTMENT = 0.398150;
  all 27 (3D) or 9 (2D) neighbour cubes with up to 5 masked points each.

The seeds are uint32 arithmetic that wraps mod 2^32. PyTorch has few
uint32 kernels on the card, so they ride in int64, masked with
0xFFFFFFFF after each multiply and add (every product stays below
2^63), and a negative cube index becomes its uint32 pattern by the same
mask. A masked int64 below 2^32 converts to float32 with one rounding to
nearest, as uint32 does. The F1..Fn selection keeps lax.top_k's order:
the smallest distances first and, among equal ones (the masked slots
all hold 999999.9), the lowest slot first, by a stable sort.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cse168_raytracer_tpu_torch.core.vecmath import sqrt_rn

# Ken Perlin's reference permutation (lib/src/Perlin.cpp:3-38), doubled.
_PERM = np.array([
    151, 160, 137, 91, 90, 15, 131, 13, 201, 95, 96, 53, 194, 233, 7, 225,
    140, 36, 103, 30, 69, 142, 8, 99, 37, 240, 21, 10, 23, 190, 6, 148,
    247, 120, 234, 75, 0, 26, 197, 62, 94, 252, 219, 203, 117, 35, 11, 32,
    57, 177, 33, 88, 237, 149, 56, 87, 174, 20, 125, 136, 171, 168, 68, 175,
    74, 165, 71, 134, 139, 48, 27, 166, 77, 146, 158, 231, 83, 111, 229, 122,
    60, 211, 133, 230, 220, 105, 92, 41, 55, 46, 245, 40, 244, 102, 143, 54,
    65, 25, 63, 161, 1, 216, 80, 73, 209, 76, 132, 187, 208, 89, 18, 169,
    200, 196, 135, 130, 116, 188, 159, 86, 164, 100, 109, 198, 173, 186, 3, 64,
    52, 217, 226, 250, 124, 123, 5, 202, 38, 147, 118, 126, 255, 82, 85, 212,
    207, 206, 59, 227, 47, 16, 58, 17, 182, 189, 28, 42, 223, 183, 170, 213,
    119, 248, 152, 2, 44, 154, 163, 70, 221, 153, 101, 155, 167, 43, 172, 9,
    129, 22, 39, 253, 19, 98, 108, 110, 79, 113, 224, 232, 178, 185, 112, 104,
    218, 246, 97, 228, 251, 34, 242, 193, 238, 210, 144, 12, 191, 179, 162, 241,
    81, 51, 145, 235, 249, 14, 239, 107, 49, 192, 214, 31, 181, 199, 106, 157,
    184, 84, 204, 176, 115, 121, 50, 45, 127, 4, 150, 254, 138, 236, 205, 93,
    222, 114, 67, 29, 24, 72, 243, 141, 128, 195, 78, 66, 215, 61, 156, 180,
], dtype=np.int32)
_PERM2 = np.concatenate([_PERM, _PERM])

# Worley per-cube point count lookup (Worley.cpp:14-23).
_POISSON_COUNT = np.array([
    4, 3, 1, 1, 1, 2, 4, 2, 2, 2, 5, 1, 0, 2, 1, 2, 2, 0, 4, 3, 2, 1, 2, 1, 3, 2, 2, 4, 2, 2, 5, 1, 2, 3, 2, 2, 2, 2, 2, 3,
    2, 4, 2, 5, 3, 2, 2, 2, 5, 3, 3, 5, 2, 1, 3, 3, 4, 4, 2, 3, 0, 4, 2, 2, 2, 1, 3, 2, 2, 2, 3, 3, 3, 1, 2, 0, 2, 1, 1, 2,
    2, 2, 2, 5, 3, 2, 3, 2, 3, 2, 2, 1, 0, 2, 1, 1, 2, 1, 2, 2, 1, 3, 4, 2, 2, 2, 5, 4, 2, 4, 2, 2, 5, 4, 3, 2, 2, 5, 4, 3,
    3, 3, 5, 2, 2, 2, 2, 2, 3, 1, 1, 4, 2, 1, 3, 3, 4, 3, 2, 4, 3, 3, 3, 4, 5, 1, 4, 2, 4, 3, 1, 2, 3, 5, 3, 2, 1, 3, 1, 3,
    3, 3, 2, 3, 1, 5, 5, 4, 2, 2, 4, 1, 3, 4, 1, 5, 3, 3, 5, 3, 4, 3, 2, 2, 1, 1, 1, 1, 1, 2, 4, 5, 4, 5, 4, 2, 1, 5, 1, 1,
    2, 3, 3, 3, 2, 5, 2, 3, 3, 2, 0, 2, 1, 1, 4, 2, 1, 3, 2, 1, 2, 2, 3, 2, 5, 5, 3, 4, 5, 5, 2, 4, 4, 5, 3, 2, 2, 2, 1, 4,
    2, 3, 3, 4, 2, 5, 4, 2, 4, 2, 2, 2, 4, 5, 3, 2,
], dtype=np.int32)


DENSITY_ADJUSTMENT = 0.398150  # Worley.cpp:27
_MAX_PTS_PER_CUBE = 5          # max of the Poisson table
_U32 = 0xFFFFFFFF
_MASKED_D2 = 999999.9          # a slot beyond its cube's point count
_CUBE_MUL = (702395077, 915488749, 2120969693)
_LCG_MUL = 1402024253
_LCG_ADD = 586950981


# neighbour cube offsets in the JAX package's order (slot order breaks ties)
_OFFSETS = {n: np.stack(np.meshgrid(*([[-1, 0, 1]] * n), indexing="ij"),
                        axis=-1).reshape(3 ** n, n) for n in (2, 3)}


@functools.lru_cache(maxsize=None)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """One of the module's integer tables as an int64 tensor on device,
    copied there once."""
    return torch.as_tensor({"perm": _PERM2, "poisson": _POISSON_COUNT,
                            "offs2": _OFFSETS[2], "offs3": _OFFSETS[3]}[name],
                           dtype=torch.int64, device=device)


def floor_i32(x: torch.Tensor) -> torch.Tensor:
    """floor(x) as XLA converts float32 to int32, saturating at the int32
    range (Perlin's high octaves reach 1e12), carried in int64. A plain
    conversion differs: PyTorch's CPU kernel gives INT_MIN there."""
    i = torch.clamp(torch.floor(x), -2.0 ** 31, 2.0 ** 31).to(torch.int64)
    return torch.clamp(i, -2 ** 31, 2 ** 31 - 1)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    """Perlin gradient hash (Perlin.h:46-52), branch-free."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def perlin(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Improved Perlin noise, elementwise (Perlin.h:16-40)."""
    perm = _table("perm", x.device)
    xi, yi, zi = (floor_i32(c) & 255 for c in (x, y, z))
    xf, yf, zf = x - torch.floor(x), y - torch.floor(y), z - torch.floor(z)
    u, v, w = _fade(xf), _fade(yf), _fade(zf)

    a = perm[xi] + yi
    aa = perm[a] + zi
    ab = perm[a + 1] + zi
    b = perm[xi + 1] + yi
    ba = perm[b] + zi
    bb = perm[b + 1] + zi

    def lerp(t, p, q):
        return p + t * (q - p)

    return lerp(w,
                lerp(v, lerp(u, _grad(perm[aa], xf, yf, zf),
                                _grad(perm[ba], xf - 1, yf, zf)),
                        lerp(u, _grad(perm[ab], xf, yf - 1, zf),
                                _grad(perm[bb], xf - 1, yf - 1, zf))),
                lerp(v, lerp(u, _grad(perm[aa + 1], xf, yf, zf - 1),
                                _grad(perm[ba + 1], xf - 1, yf, zf - 1)),
                        lerp(u, _grad(perm[ab + 1], xf, yf - 1, zf - 1),
                                _grad(perm[bb + 1], xf - 1, yf - 1, zf - 1))))


def perlin_turbulence(p: torch.Tensor, octaves: int = 4,
                      lacunarity: float = 2.0, gain: float = 0.5):
    """Sum of |perlin| octaves with float32 amplitudes and frequencies
    (the Stone/Cloud turbulence, Texture.cpp:358-440)."""
    amps = gain ** np.arange(octaves, dtype=np.float32)
    freqs = lacunarity ** np.arange(octaves, dtype=np.float32)
    out = torch.zeros(p.shape[:-1], dtype=p.dtype, device=p.device)
    for amp, freq in zip(amps.tolist(), freqs.tolist()):
        out = out + amp * torch.abs(perlin(p[..., 0] * freq, p[..., 1] * freq,
                                           p[..., 2] * freq))
    return out


# ---------------------------------------------------------------------------
# Worley cellular noise
# ---------------------------------------------------------------------------

def _churn(seed):
    return (seed * _LCG_MUL + _LCG_ADD) & _U32


def u32_to_float(seed: torch.Tensor) -> torch.Tensor:
    """(float(seed) + 0.5) / 2^32 of a uint32 carried in int64, with
    float(seed) rounded to nearest as the uint32 conversion rounds."""
    return (seed.to(torch.float32) + 0.5) * (1.0 / 4294967296.0)


def _cube_points(cube_idx):
    """Feature points of integer cubes (Worley.cpp addSamples), 2D or 3D
    by the last axis of cube_idx (..., n). Returns (count (...,), points
    (..., 5, n) in cube-local + cube coordinates, ids (..., 5) as uint32
    values in int64)."""
    n = cube_idx.shape[-1]
    seed = None
    for k in range(n):
        term = (_CUBE_MUL[k] * (cube_idx[..., k] & _U32)) & _U32
        seed = term if seed is None else (seed + term) & _U32
    count = _table("poisson", cube_idx.device)[seed >> 24]
    seed = _churn(seed)
    pts, ids = [], []
    for _ in range(_MAX_PTS_PER_CUBE):
        ids.append(seed)
        coords = []
        for _ in range(n):
            seed = _churn(seed)
            coords.append(u32_to_float(seed))
        seed = _churn(seed)
        pts.append(torch.stack(coords, dim=-1))
    pts = torch.stack(pts, dim=-2) + cube_idx.to(torch.float32)[..., None, :]
    return count, pts, torch.stack(ids, dim=-1)


def smallest_k(x: torch.Tensor, k: int):
    """(values, indices) of the k smallest entries along the last axis,
    ascending, equal values lowest index first: lax.top_k's order on -x."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _worley(at: torch.Tensor, max_order: int):
    n = at.shape[-1]
    p = DENSITY_ADJUSTMENT * at
    base = floor_i32(p)
    cubes = base[..., None, :] + _table(f"offs{n}", at.device)  # (..., C, n)
    count, pts, ids = _cube_points(cubes)             # (...,C) (...,C,5,n)
    delta = pts - p[..., None, None, :]
    sq = delta * delta
    d2 = sq[..., 0] + sq[..., 1]
    if n == 3:
        d2 = d2 + sq[..., 2]
    slot = torch.arange(_MAX_PTS_PER_CUBE, device=at.device)
    d2 = torch.where(slot < count[..., None], d2, _MASKED_D2)

    lead = d2.shape[:-2]
    flat_d2 = d2.reshape(*lead, -1)
    flat_delta = delta.reshape(*lead, -1, n)
    flat_ids = ids.reshape(*lead, -1)
    top, top_idx = smallest_k(flat_d2, max_order)
    f = sqrt_rn(top) * (1.0 / DENSITY_ADJUSTMENT)
    dsel = torch.take_along_dim(flat_delta, top_idx[..., None], dim=-2)
    dsel = dsel * (1.0 / DENSITY_ADJUSTMENT)
    isel = torch.take_along_dim(flat_ids, top_idx, dim=-1)
    return f, dsel, isel


def worley3(at: torch.Tensor, max_order: int = 2):
    """Worley F1..Fn of 3D points `at` (..., 3) over the 27 neighbour
    cubes. Returns (F (..., n), delta (..., n, 3), ids (..., n) uint32
    values in int64), F scaled so mean(F1) = 1 as the reference does
    (Worley.cpp:287-293)."""
    return _worley(at, max_order)


def worley2(at: torch.Tensor, max_order: int = 2):
    """Worley F1..Fn of 2D points `at` (..., 2) over the 9 neighbour
    cells; returns as worley3."""
    return _worley(at, max_order)
