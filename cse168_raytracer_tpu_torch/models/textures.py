"""Textures and the environment: procedural, cellular and image
textures, bump heights, and the environment lookup.

Counterpart of cse168_raytracer_tpu/models/textures.py:52-665, formula
for formula (constants and all):
- generateNoise: signed multi-octave Perlin over the total amplitude
  (Texture.h:20-37), and its per-point octave count (the stone bump's
  id%3+5, Texture.cpp:376) as a masked loop of 7 octaves.
- CheckerBoardTexture (Texture.h:125-132) with its negative shift.
- StoneTexture: Worley F1..F3, cell-id palette and turbulence, and its
  bump height (Texture.cpp:358-440).
- CloudTexture (Texture.h:152-164), StemTexture/LeafTexture
  (Texture.h:192-212), PetalTexture (Texture.cpp:447-505) and
  FlowerCenterTexture (Texture.h:261-276).
- CellularTexture2D (Texture.h:84-99, Texture.cpp:219-354): points in a
  wrapping grid of fixed-capacity cells, the 4 nearest toroidal
  distances over a static (2*halo+1)^2 window; differentiable in the
  point positions.
- LoadedTexture (Texture.cpp:23-185): truncate-then-wrap bilinear
  lookup with C's sign-keeping fmod in the weights, the HDR tonemap
  after interpolation, and the 24-pixel-wide Gaussian low-res copy with
  the reference's G/B swap for float images; a Radiance .hdr codec.
- The environment (Scene.cpp:657-688): an image map (its low-res copy
  for diffuse lookups), a procedural cloud, or a flat background. A
  cloud environment looks up black by default, as the reference does
  (Texture.h:152 hides rather than overrides lookup2D; testsphere.ppm
  has a black sky); quirk_cloud_env_black=False evaluates the clouds.

Every lookup is elementwise torch ops on the device of its inputs; the
host builds (cellular grid, image low-res copy, .hdr codec) are numpy
copies of the JAX package's.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Sequence

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import PI, resolve_device
from cse168_raytracer_tpu_torch.core.fastgather import take_rows
from cse168_raytracer_tpu_torch.core.noise import (perlin, smallest_k,
                                                   worley2)
from cse168_raytracer_tpu_torch.core.vecmath import (cross, div_scalar, dot,
                                                     sqrt_rn)
from cse168_raytracer_tpu_torch.models.materials import (MaterialTable,
                                                         TEX_CELLULAR,
                                                         TEX_CHECKER,
                                                         TEX_CLOUD,
                                                         TEX_CONSTANT,
                                                         TEX_FLOWER_CENTER,
                                                         TEX_IMAGE, TEX_LEAF,
                                                         TEX_PETAL, TEX_STEM,
                                                         TEX_STONE)


def sigmoid(x):
    """Utility.h sigmoid."""
    return 1.0 / (1.0 + torch.exp(-x))


def generate_noise(x, y, z, initial_frequency, frequency_increase,
                   amplitude_falloff, iterations: int):
    """Signed turbulence, Texture.h:20-37 (static iteration count)."""
    amp = 1.0
    freq = initial_frequency
    value = torch.zeros_like(x)
    max_val = 0.0
    for _ in range(iterations):
        value = value + amp * perlin(x * freq, y * freq, z * freq)
        max_val += amp
        freq = freq * frequency_increase
        amp *= amplitude_falloff
    return div_scalar(value, max_val)


def generate_noise_dynamic(x, y, z, initial_frequency, frequency_increase,
                           amplitude_falloff, iterations, max_iterations: int):
    """generateNoise with a per-point iteration count in
    [1, max_iterations]: a static loop with per-point masks."""
    amp = 1.0
    freq = initial_frequency
    value = torch.zeros_like(x)
    max_val = torch.zeros_like(x)
    for i in range(max_iterations):
        active = i < iterations
        value = value + torch.where(
            active, amp * perlin(x * freq, y * freq, z * freq), 0.0)
        max_val = max_val + torch.where(active, amp, 0.0)
        freq = freq * frequency_increase
        amp *= amplitude_falloff
    return value / torch.clamp(max_val, min=1e-12)


# ---------------------------------------------------------------------------
# Procedural textures: (N,) coordinates and the per-point parameter rows
# gathered from the material table.
# ---------------------------------------------------------------------------

def checker_lookup(u, v, scale, color1, color2):
    """CheckerBoardTexture::lookup2D (Texture.h:125-132)."""
    su = (scale * u).abs()
    sv = (scale * v).abs()
    su = torch.where(u < 0, su + scale, su)
    sv = torch.where(v < 0, sv + scale, sv)
    parity = (torch.trunc(su).to(torch.int64)
              + torch.trunc(sv).to(torch.int64)) % 2
    return torch.where((parity == 0)[..., None], color1, color2)


def _stone_worley(u, v):
    f, _delta, ids = worley2(torch.stack([u, v], dim=-1), max_order=3)
    return f[..., 0], f[..., 1], f[..., 2], ids[..., 0]


def stone_lookup(u, v, scale):
    """StoneTexture::lookup2D (Texture.cpp:396-440)."""
    u = u * scale
    v = v * scale
    f0, f1, f2, id0 = _stone_worley(u, v)
    f1f0 = (1.0 - torch.pow(torch.clamp(f1 - f0, min=1e-12), 0.8)) * 1.5
    base = torch.clamp(torch.pow(torch.clamp(f2 - f1 + f0, min=1e-12), 0.1)
                       - f1f0, 0.0, 0.5)
    id_mod10 = (id0 % 10).to(torch.float32)
    id_mod5 = (id0 % 5).to(torch.float32)
    base = base * (div_scalar(id_mod10, 20.0) + 0.5)
    turb = generate_noise(u, v, torch.zeros_like(u), 3.0, 2.0, 0.8, 5)
    base = torch.clamp(base, min=0.0) + 0.8 * turb.abs()
    edges = torch.clamp(f1f0 * f1f0 - 1.0, max=0.75) + 0.25 * turb.abs()
    red = base + div_scalar(id_mod10, 10.0)
    green = base + div_scalar(id_mod10, 10.0) * 0.5
    blue = base + div_scalar(id_mod5, 5.0) * 0.25
    is_edge = f1f0 > 1.1
    return torch.stack([torch.where(is_edge, edges, red),
                        torch.where(is_edge, edges, green),
                        torch.where(is_edge, edges, blue)], dim=-1)


def stone_bump(u, v, scale):
    """StoneTexture::bumpHeight2D (Texture.cpp:358-393)."""
    u = u * scale
    v = v * scale
    f0, f1, _f2, id0 = _stone_worley(u, v)
    height_factor = 0.3
    f1f0 = -(1.0 - torch.pow(torch.clamp(f1 - f0, min=1e-12), 0.8)) * 1.5
    height = 1.0 / (1.0 + torch.exp(-20.0 * (f1 - f0 - 0.3)))
    iters = id0 % 3 + 5
    z = torch.zeros_like(u)
    cellturb = div_scalar(generate_noise_dynamic(u, v, z, 0.5, 2.0, 0.5,
                                                 iters, 7), 5.0) + 0.5
    turb = div_scalar(generate_noise(u, v, z, 1.0, 2.0, 0.5, 3), 10.0) + 0.5
    return torch.where(f1f0 > -1.1,
                       0.8 * cellturb + height_factor * height,
                       1.0 * turb + height_factor * height)


def cloud_lookup(u, v, params):
    """CloudTexture formula (Texture.h:152-164). params rows: [scale,
    cloudSize, density, sharpness, ambient, shadowThreshold,
    shadowMagnitude, shadowSharpness]."""
    scale, csize, density, sharp, ambient, sth, smag, ssharp = \
        (params[..., i] for i in range(8))
    su = scale * u
    sv = scale * v
    val = generate_noise(su, sv, torch.zeros_like(su), 1.0 / csize, 2.0, 0.5,
                         15)
    cloud = torch.clamp(ambient + sigmoid(sharp * (val + density)), max=1.0)
    shadow = smag * sigmoid(ssharp * sharp * (val - sth))
    return (torch.stack([cloud, cloud, torch.ones_like(cloud)], dim=-1)
            - shadow[..., None])


def stem_leaf_lookup(u, v, scale):
    """StemTexture/LeafTexture lookup (Texture.h:192-212, identical
    bodies)."""
    u = u * scale
    v = v * scale
    f, _delta, _ids = worley2(torch.stack([u, v], dim=-1), max_order=2)
    cells = f[..., 0] - f[..., 1]
    noise = generate_noise(u, v, torch.zeros_like(u), 10.0, 1.5, 0.8, 10)
    g = 0.5 + 0.5 * (noise + 1.0) / 2.0 - 0.3 * cells
    z = torch.zeros_like(g)
    return torch.stack([z, g, z], dim=-1)


def _rgb(values, like):
    return like.new_tensor(values)


def petal_uv(p, pivot, radius):
    """PetalTexture::lookup3D's coordinates (Texture.cpp:447-480): (u, v)
    on the sphere about the pivot and the distance over the radius. u
    and v come from arccos, which may differ by an ulp from XLA's, and
    petal_color's 25-octave noise (frequency up to 4 * 3^24) turns an
    ulp of u into another value: hold petal_color on equal (u, v)."""
    position = p - pivot
    r = sqrt_rn(torch.clamp(dot(position, position), min=1e-30))
    north = _rgb([0.0, 1.0, 0.0], p)
    equator = _rgb([1.0, 0.0, 0.0], p)
    # the reference normalizes `position` in place (Vector3::normalize
    # mutates, Texture.cpp:476) before the acos dot products below
    posn = position / r[..., None]
    phi = torch.arccos(torch.clamp(-dot(north, posn), -1.0, 1.0))
    v = div_scalar(phi, PI)
    theta = div_scalar(torch.arccos(torch.clamp(dot(posn, equator), -1.0,
                                                1.0)), 2.0 * PI)
    north_x_eq = cross(north, equator)
    u = torch.where(dot(north_x_eq, posn) > 0, theta, 1.0 - theta)
    return u, v, r / radius


def petal_color(u, v, dist):
    """PetalTexture::lookup3D's colour (Texture.cpp:465-505) at petal_uv's
    coordinates."""
    dist = dist[..., None]
    mix = lambda base, tip: ((1 - dist) * _rgb(base, dist)
                             + dist * _rgb(tip, dist))
    diffuse = mix([0.1, 0.0, 0.6], [0.6, 0.3, 1.0])
    highlight = mix([0.2, 0.0, 0.8], [0.8, 0.5, 1.0])
    depression = mix([0.2, 0.0, 0.5], [0.3, 0.15, 0.75])
    z = torch.zeros_like(u)
    turb = generate_noise(u, v * 0.25, z, 4.0, 2.0, 0.9, 10).abs()
    high_turb = torch.clamp(torch.pow(div_scalar(turb, 0.1), 0.85) * 1.5,
                            max=1.0)[..., None]
    turb2 = generate_noise(u, v, z, 4.0, 3.0, 0.9, 25).abs()
    low_turb = torch.clamp(torch.pow(div_scalar(turb2, 0.1), 0.85) * 1.5,
                           max=1.0)[..., None]
    return (0.5 * (high_turb * diffuse + (1 - high_turb) * highlight)
            + 0.5 * (low_turb * diffuse + (1 - low_turb) * depression))


def petal_lookup(p, pivot, radius):
    """PetalTexture::lookup3D (Texture.cpp:447-505). p: (N, 3) world."""
    return petal_color(*petal_uv(p, pivot, radius))


def flower_center_lookup(p, pivot, radius):
    """FlowerCenterTexture::lookup3D (Texture.h:261-276)."""
    d = p - pivot
    dist = sqrt_rn(torch.clamp(dot(d, d), min=1e-30))
    fraction = torch.clamp(torch.pow(dist / radius, 30.0), 0.0, 1.0)
    max_red, max_green = 0.92, 0.71
    min_red, min_green = 0.31, 0.18
    red = torch.clamp((1 - fraction) * min_red + fraction * max_red, max=1.0)
    green = torch.clamp((1 - fraction) * min_green + fraction * max_green,
                        max=1.0)
    return torch.stack([red, green, torch.full_like(red, 0.1)], dim=-1)


# ---------------------------------------------------------------------------
# Cellular texture (point-set Voronoi)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellularTexture:
    """CellularTexture2D: points on the unit torus bucketed into a
    wrapping grid of fixed-capacity cells (padded, masked); `halo` is
    the static search radius in cells."""
    points: torch.Tensor   # (H, W, CAP, 2) f32 cell-bucketed uv points
    valid: torch.Tensor    # (H, W, CAP) bool slot occupancy
    halo: int = 1


def build_cellular_texture(n_points: int, grid_width: int, grid_height: int,
                           seed: int = 0,
                           points: Optional[np.ndarray] = None,
                           device=None) -> CellularTexture:
    """CellularTexture2D ctor + populateGrid (Texture.cpp:219-233):
    uniform random points on [0,1)^2, bucketed by Grid::addPoint. Pass
    `points` (n,2) to control the distribution (the populateGrid
    override hook)."""
    device = resolve_device(device)
    if points is None:
        rng = np.random.RandomState(seed)
        points = rng.random_sample((n_points, 2)).astype(np.float32)
    else:
        points = np.asarray(points, np.float32).reshape(-1, 2)
    ci = np.minimum((points[:, 1] * grid_height).astype(np.int64),
                    grid_height - 1)
    cj = np.minimum((points[:, 0] * grid_width).astype(np.int64),
                    grid_width - 1)
    counts = np.zeros((grid_height, grid_width), np.int64)
    np.add.at(counts, (ci, cj), 1)
    cap = max(int(counts.max()), 1)
    grid = np.zeros((grid_height, grid_width, cap, 2), np.float32)
    valid = np.zeros((grid_height, grid_width, cap), bool)
    fill = np.zeros((grid_height, grid_width), np.int64)
    for k in range(points.shape[0]):
        i, j = ci[k], cj[k]
        s = fill[i, j]
        grid[i, j, s] = points[k]
        valid[i, j, s] = True
        fill[i, j] = s + 1
    # static search radius: ~2.5x the mean 4th-nearest-neighbour distance
    # of a Poisson point set of this density, in cells (the reference's
    # adaptive expansion bound, Texture.cpp:320-345, made static)
    r4 = float(np.sqrt(4.0 / (np.pi * max(points.shape[0], 1))))
    halo = max(1, int(np.ceil(2.5 * r4 * max(grid_width, grid_height))))
    halo = min(halo, (min(grid_width, grid_height) - 1) // 2 + 1)
    return CellularTexture(points=torch.as_tensor(grid, device=device),
                           valid=torch.as_tensor(valid, device=device),
                           halo=halo)


def cellular_distances(tex: CellularTexture, u, v, n: int = 4):
    """getClosestDistances (Texture.cpp:252-354): the n smallest
    toroidal distances from (u, v) to the point set over the wrapped
    window of cells. Missing slots keep the reference's sentinel 2.0
    (> sqrt(2), the largest torus distance, Texture.cpp:271-272)."""
    gh, gw, cap = tex.valid.shape
    w = 2 * tex.halo + 1
    u = torch.remainder(u, 1.0)
    v = torch.remainder(v, 1.0)
    ci = torch.clamp((v * gh).to(torch.int64), 0, gh - 1)
    cj = torch.clamp((u * gw).to(torch.int64), 0, gw - 1)
    offs = torch.arange(-tex.halo, tex.halo + 1, device=u.device)
    ni = torch.remainder(ci[..., None] + offs, gh)             # (..., w)
    nj = torch.remainder(cj[..., None] + offs, gw)
    ii = ni[..., :, None].expand(ni.shape[:-1] + (w, w))
    jj = nj[..., None, :].expand(nj.shape[:-1] + (w, w))
    pts = tex.points[ii, jj]                                  # (..., w,w,CAP,2)
    ok = tex.valid[ii, jj]                                    # (..., w,w,CAP)
    du = (u[..., None, None, None] - pts[..., 0]).abs()
    dv = (v[..., None, None, None] - pts[..., 1]).abs()
    du = torch.minimum(du, 1.0 - du)  # toroidal wrap (Texture.cpp:295-297)
    dv = torch.minimum(dv, 1.0 - dv)
    d = sqrt_rn(du * du + dv * dv)
    d = torch.where(ok, d, 2.0)
    return smallest_k(d.reshape(d.shape[:-3] + (w * w * cap,)), n)[0]


def cellular_lookup(tex: CellularTexture, u, v):
    """CellularTexture2D::lookup2D (Texture.cpp:236-249):
    gray = exp(-(f1 - f0 + f2 - 0.8 f3) * 100)."""
    f = cellular_distances(tex, u, v, n=4)
    out = torch.exp(-(f[..., 1] - f[..., 0] + f[..., 2]
                      - 0.8 * f[..., 3]) * 100.0)
    return torch.stack([out, out, out], dim=-1)


# ---------------------------------------------------------------------------
# Image textures
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ImageTexture:
    """One loaded image and its Gaussian low-res copy (LoadedTexture)."""
    image: torch.Tensor          # (H, W, 3) f32, raw values (LDR already /255)
    lowres: torch.Tensor         # (h, w, 3) f32 (G/B swapped when is_hdr,
                                 # Texture.cpp:118-124)
    max_intensity: torch.Tensor  # () f32
    is_hdr: bool = False


LOWRES_WIDTH = 24  # Texture.h:297


def build_image_texture(pixels: np.ndarray, is_hdr: bool,
                        device=None) -> ImageTexture:
    """pixels: (H, W, 3) float32, bottom-up row order (FreeImage's
    convention; callers flip top-down formats)."""
    device = resolve_device(device)
    h, w = pixels.shape[:2]
    max_intensity = float(pixels.max())
    lrh = max(int(LOWRES_WIDTH * (h / w)), 1)
    lrw = LOWRES_WIDTH
    bh, bw = h // lrh, w // lrw
    lowres = np.zeros((lrh, lrw, 3), np.float32)
    # Gaussian-weighted block accumulation (Texture.cpp:63-91)
    yy, xx = np.meshgrid(np.arange(bh), np.arange(bw), indexing="ij")
    for i in range(lrh):
        for j in range(lrw):
            block = pixels[bh * i:bh * i + bh, bw * j:bw * j + bw]
            mid_x, mid_y = bw // 2, bh // 2
            g = (1.0 / (2.0 * np.pi)
                 * np.exp(-((xx[:block.shape[0], :block.shape[1]] - mid_x) ** 2
                            + (yy[:block.shape[0], :block.shape[1]] - mid_y) ** 2)
                          / 2.0))
            lowres[i, j] = (g[..., None] * block).sum(axis=(0, 1))
    if is_hdr:
        lowres = lowres[..., [0, 2, 1]]  # the reference's G/B swap
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                  device=device)
    return ImageTexture(image=t(pixels), lowres=t(lowres),
                        max_intensity=t(np.float32(max_intensity)),
                        is_hdr=bool(is_hdr))


def read_radiance_hdr(path: str) -> np.ndarray:
    """Radiance RGBE (.hdr) decoder -> (H, W, 3) float32, top-down rows:
    flat scanlines and new-style RLE (0x02 0x02 marker), float =
    mantissa/256 * 2^(e-128) (FreeImage's FIF_HDR, Texture.cpp:30-50)."""
    with open(path, "rb") as f:
        data = f.read()
    # the header ends at the first blank line; the next is the resolution
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    res = data[pos:eol].split()
    if res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"unsupported HDR orientation {res!r}")
    h, w = int(res[1]), int(res[3])
    pos = eol + 1
    rgbe = np.zeros((h, w, 4), np.uint8)
    buf = np.frombuffer(data, np.uint8)
    for y in range(h):
        if (w >= 8 and w < 32768 and pos + 4 <= len(data)
                and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == w):
            pos += 4                    # new-style RLE, per-channel runs
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[pos]
                    if cnt > 128:       # a run of one byte
                        rgbe[y, x:x + cnt - 128, c] = data[pos + 1]
                        x += cnt - 128
                        pos += 2
                    else:               # literal bytes
                        rgbe[y, x:x + cnt, c] = buf[pos + 1:pos + 1 + cnt]
                        x += cnt
                        pos += 1 + cnt
        else:                           # flat scanline
            rgbe[y] = buf[pos:pos + 4 * w].reshape(w, 4)
            pos += 4 * w
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136))  # 2^(e-128) / 256
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(
        np.float32)


def write_radiance_hdr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 as a flat (non-RLE) Radiance .hdr."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    m = img.max(axis=-1)
    nz = m > 1e-32
    # frexp: m = f * 2^e with f in [0.5, 1), so the mantissa of the
    # largest channel lands in [128, 256)
    _, e = np.frexp(np.where(nz, m, 1.0))
    scale = np.ldexp(1.0, -e + 8)       # mantissa = v * 2^(8-e)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.minimum(
        np.round(img * scale[..., None]), 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def load_image_texture(path: str, device=None) -> ImageTexture:
    """Load a Radiance .hdr (float) with this module's codec, or a
    PNG/JPG (LDR) through imageio, which raises ImportError naming the
    file where imageio is not installed."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.lower().endswith((".hdr", ".rgbe")):
        arr = read_radiance_hdr(path)
        is_hdr = True
    else:
        try:
            import imageio.v3 as iio
        except ImportError as e:
            raise ImportError(f"reading {path} needs imageio, which is not "
                              "installed") from e
        arr = np.asarray(iio.imread(path))
        is_hdr = arr.dtype in (np.float32, np.float64, np.float16)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    arr = arr[..., :3].astype(np.float32)
    if not is_hdr:
        arr = arr / 255.0
    # files load top-down; FreeImage scanlines are bottom-up and the
    # reference indexes with v*h directly: flip to bottom-up
    return build_image_texture(np.ascontiguousarray(arr[::-1]), is_hdr,
                               device)


def image_lookup(tex: ImageTexture, u, v, lowres: bool = False):
    """LoadedTexture::lookup (Texture.cpp:161-185): truncate-then-wrap
    bilinear, tonemapped after interpolation when HDR. As in the
    reference, x1 = (int)px is wrapped by C's sign-keeping %, and the
    bilinear weights are measured against that possibly negative x1, so
    coordinates outside [0, 1) extrapolate; the fetch indices wrap
    positively (the golden harness's FreeImage backend defines the
    reference's out-of-bounds fetch so)."""
    bm = tex.lowres if lowres else tex.image
    h, w = bm.shape[0], bm.shape[1]
    px = w * u
    py = h * v
    x1c = torch.trunc(px)
    x2c = x1c + 1.0
    x1m = torch.fmod(x1c, w)
    x2m = torch.fmod(x2c, w)
    x1e = px - x1m
    y1c = torch.trunc(py)
    y2c = y1c + 1.0
    y1m = torch.fmod(y1c, h)
    y2m = torch.fmod(y2c, h)
    y1e = py - y1m
    wrap = lambda a, m: torch.remainder(a.to(torch.int64), m)
    x1, x2 = wrap(x1m, w), wrap(x2m, w)
    y1, y2 = wrap(y1m, h), wrap(y2m, h)
    f = ((bm[y1, x1] * (1 - x1e)[..., None] + bm[y1, x2] * x1e[..., None])
         * (1 - y1e)[..., None]
         + (bm[y2, x1] * (1 - x1e)[..., None] + bm[y2, x2] * x1e[..., None])
         * y1e[..., None])
    if tex.is_hdr:
        f = torch.clamp(torch.pow(torch.clamp(f, min=0.0)
                                  / tex.max_intensity, 0.5) * 1.5, max=1.0)
    return f


# ---------------------------------------------------------------------------
# Environment map
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Environment:
    """Scene environment: image map, procedural cloud, or flat
    background."""
    image: Optional[ImageTexture]         # None: cloud or background
    cloud_params: Optional[torch.Tensor]  # (8,) CloudTexture params or None
    rotation: torch.Tensor                # (2,) phi / theta offsets
    bg_color: torch.Tensor                # (3,)
    quirk_cloud_env_black: bool = True


def make_environment(image: Optional[ImageTexture] = None, cloud_params=None,
                     rotation=(0.0, 0.0), bg_color=(0.0, 0.0, 0.0),
                     quirk_cloud_env_black: bool = True,
                     device=None) -> Environment:
    device = resolve_device(device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    return Environment(
        image=image,
        cloud_params=None if cloud_params is None else t(cloud_params),
        rotation=t(rotation), bg_color=t(bg_color),
        quirk_cloud_env_black=quirk_cloud_env_black)


def env_lookup(env: Environment, d: torch.Tensor,
               is_diffuse: torch.Tensor) -> torch.Tensor:
    """Scene::getEnvironmentMap (Scene.cpp:657-688). d: (N, 3) unit
    directions; is_diffuse: (N,) bool selects an image map's low-res
    copy."""
    shape = d.shape[:-1]
    if env.image is None and env.cloud_params is None:
        return env.bg_color.expand(shape + (3,))
    phi = torch.atan2(d[..., 0], d[..., 2]) + env.rotation[0] + PI
    theta = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) + env.rotation[1]
    over = theta > PI / 2.0
    phi = torch.where(over, phi + PI, phi)
    theta = torch.where(over, theta - 2.0 * (theta - PI / 2.0), theta)
    phi = torch.where(phi > 2.0 * PI, phi - 2.0 * PI, phi)
    u = div_scalar(phi, 2.0 * PI)
    v = div_scalar(theta, PI) + 0.5
    if env.image is not None:
        hi = image_lookup(env.image, u, v, lowres=False)
        lo = image_lookup(env.image, u, v, lowres=True)
        return torch.where(is_diffuse[..., None], lo, hi)
    if env.quirk_cloud_env_black:
        return torch.zeros(shape + (3,), dtype=torch.float32,
                           device=d.device)
    return cloud_lookup(u, v, env.cloud_params.expand(shape + (8,)))


# ---------------------------------------------------------------------------
# Per-wavefront dispatch: diffuse colour and bump height by material id
# ---------------------------------------------------------------------------

def active_kinds(mat: MaterialTable) -> tuple[int, ...]:
    """Host-side: the texture kinds the table uses (static)."""
    kinds = np.unique(mat.texture_kind.cpu().numpy())
    return tuple(int(k) for k in kinds)


def diffuse_color(mat: MaterialTable, images: Sequence[ImageTexture],
                  mid: torch.Tensor, uv: torch.Tensor, p: torch.Tensor,
                  kinds: Optional[tuple[int, ...]] = None,
                  cellulars: Sequence[CellularTexture] = ()) -> torch.Tensor:
    """Material::diffuse2D/diffuse3D dispatch (Phong.cpp:51-56) over the
    texture kinds the scene uses (`kinds`, a static tuple: pass
    active_kinds(mat); None means constant, checker and stone). mid:
    (N,) material ids; uv: (N, 2) object UVs; p: (N, 3) world hit points,
    the coordinates of the 3D textures."""
    if kinds is None:
        kinds = (TEX_CONSTANT, TEX_CHECKER, TEX_STONE)
    kind = take_rows(mat.texture_kind, mid)
    params = take_rows(mat.texture_params, mid)
    u, v = uv[..., 0], uv[..., 1]
    out = torch.zeros(mid.shape + (3,), dtype=torch.float32,
                      device=mid.device)

    def put(k, color, sel=None):
        sel = kind == k if sel is None else sel
        return torch.where(sel[..., None], color, out)

    if TEX_CONSTANT in kinds:
        out = put(TEX_CONSTANT, take_rows(mat.kd, mid))
    if TEX_CHECKER in kinds:
        out = put(TEX_CHECKER, checker_lookup(
            u, v, params[..., 0], take_rows(mat.kd, mid),
            take_rows(mat.texture_color2, mid)))
    if TEX_STONE in kinds:
        out = put(TEX_STONE, stone_lookup(u, v, params[..., 0]))
    if TEX_CLOUD in kinds:
        out = put(TEX_CLOUD, cloud_lookup(p[..., 0], p[..., 1],
                                          params[..., :8]))
    if TEX_STEM in kinds:
        out = put(TEX_STEM, stem_leaf_lookup(u, v, params[..., 0]))
    if TEX_LEAF in kinds:
        out = put(TEX_LEAF, stem_leaf_lookup(p[..., 0], p[..., 1],
                                             params[..., 0]))
    if TEX_PETAL in kinds:
        out = put(TEX_PETAL, petal_lookup(p, params[..., 1:4],
                                          params[..., 0]))
    if TEX_FLOWER_CENTER in kinds:
        out = put(TEX_FLOWER_CENTER, flower_center_lookup(
            p, params[..., 1:4], params[..., 0]))
    for k, texs, lookup in ((TEX_IMAGE, images, image_lookup),
                            (TEX_CELLULAR, cellulars, cellular_lookup)):
        if k in kinds:
            tex_id = take_rows(mat.image_id, mid)
            for i, tex in enumerate(texs):
                out = put(k, lookup(tex, u, v), (kind == k) & (tex_id == i))
    return out


def bump_height(mat: MaterialTable, mid: torch.Tensor, uv: torch.Tensor,
                kinds: Optional[tuple[int, ...]] = None) -> torch.Tensor:
    """Material::bumpHeight2D dispatch. Only StoneTexture has a nonzero
    bump in the reference (Texture.cpp:358-393)."""
    if kinds is None or TEX_STONE in kinds:
        kind = take_rows(mat.texture_kind, mid)
        scale = take_rows(mat.texture_params, mid)[..., 0]
        h = stone_bump(uv[..., 0], uv[..., 1], scale)
        return torch.where(kind == TEX_STONE, h, 0.0)
    return torch.zeros(mid.shape, dtype=torch.float32, device=mid.device)


def has_bump(mat: MaterialTable) -> bool:
    """Host-side: does any material have a bump map (static)."""
    return bool((mat.texture_kind == TEX_STONE).any())
