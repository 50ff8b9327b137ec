"""Photon mapping: wavefront photon tracing and the hashed-grid
irradiance gather.

Counterpart of cse168_raytracer_tpu/ops/photon.py:61-602 (the
reference's Scene::tracePhotons / traceCausticPhotons / tracePhoton,
Scene.cpp:351-655, and its kd-tree PhotonMap, PhotonMap.cpp).

*Tracing* (`trace_photon_batch`), the JAX function's semantics step by
step: only directional-area lights emit (Scene.cpp:368,430); power
color * wattage * pi r^2, a tenth of it for caustic photons; per level
a closest hit from pos + EPSILON * dir, Russian roulette over avg(tex),
+ avg(ks), + avg(kt); diffuse hits are stored after the first bounce
only; caustic photons die on a diffuse first bounce and global ones on
a specular first bounce; cosine, mirror and Fresnel-refract
continuations (Phong lobes about the last two when path tracing); a
dead photon is still traced, along (0, 0, 1), as there. The texture
colour is `diffuse_color` without cellular textures, as in the JAX
tracer. Its uniforms are explicit (`PhotonUniforms`), so a test feeds
both packages the same numbers; `draw_trace_photon_batch` draws them
from a torch.Generator.

*Gather* (`grid_irradiance`): photons hashed into a uniform grid of
cell size r; for each point the 27 neighbour cells (hashed, sorted,
de-duplicated), up to max_per_cell photons a cell, a 12-step bisection
of r'^2 on the candidates' fold weights to ~knn photons (Jensen's k-NN
estimate), the facing test, and sum(P) / (pi r'^2); where the fine
level holds fewer than knn photons within r and the coarse level
(cell 8r) reaches knn, the coarse estimate. The sums over a point's
candidates (the counts and the power) are vecmath.sum_fixed, one order
on every device. Only the stored powers get a gradient: distances feed
masks alone and r'^2 is detached, as in the JAX function.
`_Irradiance` is its autograd.Function: the forward runs without grad
and keeps per point only (p, n, r'^2, level). On CPU tensors the
forward is `gather_levels`, the plain PyTorch twin, a chunk of points at
a time; on CUDA tensors it is one launch of csrc/photon_gather.cu
(ops/photon_gather.py), which gives the twin's bits, or it raises. The
backward re-derives the accepted candidates, a fixed chunk of points at
a time, and sums grad / (pi r'^2) by photon into the powers of the
level that point used (ops/segment_sum.py, no atomics), so no (N, 27,
K) array outlives its chunk.
Each call counts `photon.gathers` and its points in `photon.points`
and runs in the span `photon.gather`; while a tracer sink is open it
also hands the sink a "photon_gather" record (utils/profiling.py
device_record): the number of points, the points themselves ("p", the
tensor the call was given, not copied), the grid, and on the card the
call's device time by CUDA events, read after the sink closes. The
record launches no device work of its own; with no sink open none of
it runs.

*Build* (`build_grid`, `_auto_radius`): host numpy copied from the JAX
package, giving the same bytes (stable sort, over-full cells folded
with RandomState(0xC5E168), RandomState(0)'s subsample, the coarse
level). `build_photon_maps` emits batches until each map's target is
stored, scales powers by 1 / emitted and builds the grids; the maps
keep the photons they were built from (`PhotonMaps.photons`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import (EPSILON, PI, RenderConfig,
                                              resolve_device)
from cse168_raytracer_tpu_torch.core.fastgather import take_rows
from cse168_raytracer_tpu_torch.core.noise import floor_i32
from cse168_raytracer_tpu_torch.core.sampling import (cosine_hemisphere,
                                                      fold_seed, phong_lobe,
                                                      stream, uniform)
from cse168_raytracer_tpu_torch.core.vecmath import (div_scalar, dot,
                                                     fresnel_rs, reflect,
                                                     refract, safe_normalize,
                                                     sum_fixed)
from cse168_raytracer_tpu_torch.models.lights import (LIGHT_DIRECTIONAL_AREA,
                                                      sample_origin,
                                                      sample_photon_direction)
from cse168_raytracer_tpu_torch.models.scene import Scene, SceneStatic
from cse168_raytracer_tpu_torch.models.textures import diffuse_color
from cse168_raytracer_tpu_torch.ops import photon_gather
from cse168_raytracer_tpu_torch.ops.segment_sum import segment_sum
from cse168_raytracer_tpu_torch.ops.shading import trace_closest
from cse168_raytracer_tpu_torch.utils import profiling

_H1, _H2, _H3 = 73856093, 19349663, 83492791  # classic spatial-hash primes
_U32 = 0xFFFFFFFF
_OFFS = np.stack(np.meshgrid([-1, 0, 1], [-1, 0, 1], [-1, 0, 1],
                             indexing="ij"), axis=-1).reshape(27, 3)
# candidates (points x 27 x max_per_cell) a chunk of the plain gather
# (gather_levels, the CPU's forward) holds: ~60 bytes each while the
# chunk is alive
_CHUNK_CANDIDATES = 1 << 20
# the backward's chunk, the same on every device: its chunks' sums are
# added one after another, so the chunk is part of the gradient's order
_BACKWARD_CANDIDATES = 1 << 24


@dataclasses.dataclass(frozen=True)
class PhotonGrid:
    """One photon map as a hashed uniform grid (CSR by sorted hash)."""
    pos: torch.Tensor        # (P, 3) photon positions, sorted by hash
    power: torch.Tensor      # (P, 3) photon powers (pre-scaled)
    dir: torch.Tensor        # (P, 3) incoming directions
    weight: torch.Tensor     # (P,) photons represented (fold weights)
    cell_hash: torch.Tensor  # (P,) int32 sorted hash of each photon
    radius: torch.Tensor     # () float32 gather radius (= cell size)
    n_valid: int
    table_size: int = 1 << 20
    max_per_cell: int = 64
    knn: int = 500
    # the sparse-region fallback level (cell coarse_factor * radius);
    # None on the coarse level itself
    coarse: Optional["PhotonGrid"] = None

    def replace(self, **kw) -> "PhotonGrid":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PhotonGrid":
        """This grid (and its coarse level) with its tensors on device."""
        return self.replace(
            coarse=None if self.coarse is None else self.coarse.to(device),
            **{f: getattr(self, f).to(device) for f in
               ("pos", "power", "dir", "weight", "cell_hash", "radius")})


@dataclasses.dataclass(frozen=True)
class PhotonMaps:
    global_map: Optional[PhotonGrid]
    caustic_map: Optional[PhotonGrid]
    # each map's photons as build_photon_maps stored them, before its
    # grid's fold: {"global", "caustic": (position, incoming direction,
    # power over the photons emitted) host float32 arrays, or None};
    # None where the maps came from elsewhere (a checkpoint, interop)
    photons: Optional[dict] = dataclasses.field(default=None,
                                                compare=False, repr=False)

    def replace(self, **kw) -> "PhotonMaps":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "PhotonMaps":
        return self.replace(**{
            f: None if g is None else g.to(device)
            for f, g in (("global_map", self.global_map),
                         ("caustic_map", self.caustic_map))})


def _hash_cells(cells: torch.Tensor, table_size: int) -> torch.Tensor:
    """The uint32 spatial hash of integer cells (..., 3), carried in
    int64: each coordinate wraps to uint32 as the int32 -> uint32 cast
    does (so a negative cell, or one past the int32 range by an offset,
    wraps as int32 arithmetic would), each product is masked to 32
    bits, then xor and % table_size. Returns int64 in [0, table_size)."""
    u = cells.to(torch.int64) & _U32
    ix = (u[..., 0] * _H1) & _U32
    iy = (u[..., 1] * _H2) & _U32
    iz = (u[..., 2] * _H3) & _U32
    return (ix ^ iy ^ iz) % table_size


def build_grid(pos: np.ndarray, power: np.ndarray, dirs: np.ndarray,
               radius: float, max_per_cell: int = 64, knn: int = 500,
               coarse_factor: Optional[float] = 8.0,
               device=None) -> PhotonGrid:
    """Host-side grid build (JAX ops/photon.py:93-175, the same numpy):
    hash, stable sort, fold each over-full cell into an unbiased random
    sample of max_per_cell photons that carries the cell's exact power
    and weight c / max_per_cell each, upload to `device` (None: the
    card). coarse_factor builds the sparse-region fallback level over
    the same photons with cell size coarse_factor * radius."""
    device = resolve_device(device)
    n = pos.shape[0]
    table_size = max(1 << int(np.ceil(np.log2(max(4 * n, 16)))), 16)
    cells = np.floor(pos / radius).astype(np.int64)
    h = ((cells[:, 0].astype(np.uint32) * np.uint32(_H1))
         ^ (cells[:, 1].astype(np.uint32) * np.uint32(_H2))
         ^ (cells[:, 2].astype(np.uint32) * np.uint32(_H3))) % table_size
    order = np.argsort(h, kind="stable")
    pos_s = pos[order].astype(np.float64)
    pow_s = power[order].astype(np.float64)
    dir_s = dirs[order].astype(np.float64)
    h_s = h[order]

    wgt = np.ones(n, np.float64)
    if n:
        starts = np.flatnonzero(np.r_[True, h_s[1:] != h_s[:-1]])
        counts = np.diff(np.r_[starts, n])
        rng = np.random.RandomState(0xC5E168)
        for s, c in zip(starts[counts > max_per_cell],
                        counts[counts > max_per_cell]):
            m = max_per_cell
            sel = s + np.sort(rng.choice(c, m, replace=False))
            tot = pow_s[s:s + c].sum(axis=0)
            pos_k = pos_s[sel].copy()
            pow_k = pow_s[sel].copy()
            dir_k = dir_s[sel].copy()
            ssum = pow_k.sum(axis=0)
            for ch in range(3):
                if ssum[ch] > 0:
                    pow_k[:, ch] *= tot[ch] / ssum[ch]
                elif tot[ch] != 0:
                    pow_k[:, ch] = tot[ch] / m
            pos_s[s:s + m] = pos_k
            pow_s[s:s + m] = pow_k
            dir_s[s:s + m] = dir_k
            pow_s[s + m:s + c] = 0.0   # beyond the gather cap: unreachable
            wgt[s:s + m] = c / m
            wgt[s + m:s + c] = 0.0

    coarse = None
    if coarse_factor is not None:
        coarse = build_grid(pos, power, dirs, radius * coarse_factor,
                            max_per_cell=max_per_cell, knn=knn,
                            coarse_factor=None, device=device)
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    return PhotonGrid(
        pos=f32(pos_s), power=f32(pow_s), dir=f32(dir_s), weight=f32(wgt),
        cell_hash=torch.as_tensor(h_s.astype(np.int32), device=device),
        radius=f32(radius), n_valid=int(n), table_size=int(table_size),
        max_per_cell=max_per_cell, knn=knn, coarse=coarse)


def _candidates(grid: PhotonGrid, p: torch.Tensor):
    """The photon rows each point may gather: up to max_per_cell of
    each distinct bucket of its 27 neighbour cells. Returns (idx (N, M)
    int64 clipped to the table, valid (N, M)), M = 27 * max_per_cell."""
    nn = p.shape[0]
    base = floor_i32(p / grid.radius)                          # (N, 3)
    with profiling.sync("photon_offsets", p):
        offs = torch.as_tensor(_OFFS, dtype=torch.int64, device=p.device)
    h = _hash_cells(base[:, None, :] + offs[None], grid.table_size)
    # neighbour cells can share a bucket; probing one twice would count
    # its run twice. Sort the 27 probes and keep one per bucket.
    h = torch.sort(h, dim=1).values.to(torch.int32).contiguous()
    uniq = torch.cat([torch.ones_like(h[:, :1], dtype=torch.bool),
                      h[:, 1:] != h[:, :-1]], dim=1)
    start = torch.searchsorted(grid.cell_hash, h)
    end = torch.searchsorted(grid.cell_hash, h, right=True)
    count = torch.where(uniq, torch.clamp(end - start, max=grid.max_per_cell),
                        0)
    k = torch.arange(grid.max_per_cell, device=p.device)
    idx = start[..., None] + k                                 # (N, 27, K)
    valid = (k < count[..., None]) & (idx < grid.n_valid)
    idx = torch.clamp(idx, 0, grid.pos.shape[0] - 1)
    return idx.reshape(nn, -1), valid.reshape(nn, -1)


def _in_range(grid: PhotonGrid, p: torch.Tensor, n: torch.Tensor):
    """(idx, d2, in_r, facing) of each point's candidates (N, M): the
    squared distance as (dx dx + dy dy) + dz dz in separate roundings,
    inside the level radius, and the photon's direction against the
    normal (PhotonMap.cpp:186)."""
    idx, valid = _candidates(grid, p)
    d = grid.pos[idx] - p[:, None, :]
    d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
    facing = dot(grid.dir[idx], n[:, None, :]) < 0.0
    r = grid.radius
    return idx, d2, valid & (d2 < r * r), facing


def _gather_level(grid: PhotonGrid, p: torch.Tensor, n: torch.Tensor,
                  power: torch.Tensor):
    """One level's density-adaptive gather, plain PyTorch (differentiable
    in `power` under autograd). Returns (irradiance (N, 3), weighted
    photon count within the level radius (N,), r'^2 (N,))."""
    idx, d2, in_r, facing = _in_range(grid, p, n)
    wts = torch.where(in_r, grid.weight[idx], 0.0)
    cnt_r = sum_fixed(wts, 1)
    k = float(grid.knn)
    r = grid.radius
    lo = torch.zeros(p.shape[0], dtype=torch.float32, device=p.device)
    hi = (r * r).expand(p.shape[0]).clone()
    for _ in range(12):
        mid = 0.5 * (lo + hi)
        cnt = sum_fixed(torch.where(d2 < mid[:, None], wts, 0.0), 1)
        ge = cnt >= k
        hi = torch.where(ge, mid, hi)
        lo = torch.where(ge, lo, mid)
    accept = in_r & (d2 < hi[:, None]) & facing
    total = sum_fixed(torch.where(accept[..., None], power[idx], 0.0), 1)
    return total / (PI * hi[:, None]), cnt_r, hi


def _accepted(grid: PhotonGrid, p: torch.Tensor, n: torch.Tensor,
              r2: torch.Tensor):
    """(idx, accept) (N, M) of the candidates a point summed at its r'^2."""
    idx, d2, in_r, facing = _in_range(grid, p, n)
    return idx, in_r & (d2 < r2[:, None]) & facing


def gather_chunk(grid: PhotonGrid) -> int:
    """Points a chunk of the plain gather (gather_levels) of `grid`
    holds: a fixed candidate budget. Neither the irradiance nor the
    gradient depends on it: each point's sums are its own, and the
    backward takes its own chunk (backward_chunk)."""
    return max(1, _CHUNK_CANDIDATES // (27 * grid.max_per_cell))


def backward_chunk(grid: PhotonGrid) -> int:
    """Points a backward chunk of `grid` holds, the same on every
    device."""
    return max(1, _BACKWARD_CANDIDATES // (27 * grid.max_per_cell))


def _chunks(nn: int, chunk: int):
    return [slice(c, min(c + chunk, nn)) for c in range(0, nn, chunk)]


def gather_levels(grid: PhotonGrid, p: torch.Tensor, n: torch.Tensor,
                  power: torch.Tensor, coarse_power: Optional[torch.Tensor],
                  chunk: int):
    """The forward of grid_irradiance in plain PyTorch (the kernel's
    twin, and the forward on the CPU), `chunk` points at a time, without
    grad. Returns (irradiance (N, 3), the fine level's r'^2 (N,), the
    coarse level's (N,; zeros without one), use_coarse (N,) bool)."""
    nn = p.shape[0]
    irr = p.new_zeros((nn, 3))
    r2 = p.new_zeros((nn,))
    r2_c = p.new_zeros((nn,))
    use_c = torch.zeros(nn, dtype=torch.bool, device=p.device)
    with torch.no_grad():
        for cs in _chunks(nn, chunk):
            e, cnt, r2[cs] = _gather_level(grid, p[cs], n[cs], power)
            if grid.coarse is not None:
                e_c, cnt_c, r2_c[cs] = _gather_level(grid.coarse, p[cs],
                                                     n[cs], coarse_power)
                use_c[cs] = (cnt < grid.knn) & (cnt_c >= grid.knn)
                e = torch.where(use_c[cs, None], e_c, e)
            irr[cs] = e
    return irr, r2, r2_c, use_c


class _Irradiance(torch.autograd.Function):
    """grid_irradiance with the gradient of the stored powers (fine
    level and coarse level) and nothing else. The forward is
    gather_levels on the CPU and the kernel (photon_gather.gather) on the
    card, with the same bits; the gradient is recomputed in the backward
    from the saved points, normals, r'^2 and level, backward_chunk
    points at a time: each chunk's accepted (point, candidate) terms
    grad / (pi r'^2), in point-major order, summed by photon with
    ops/segment_sum.py, and the chunks' sums added in chunk order. That
    order is the same on every device and at any forward chunk."""

    @staticmethod
    def forward(ctx, grid, chunk, p, n, power, coarse_power):
        if p.device.type == "cpu":
            irr, r2, r2_c, use_c = gather_levels(grid, p, n, power,
                                                 coarse_power, chunk)
        else:
            irr, r2, r2_c, use_c = photon_gather.gather(
                grid, p.contiguous(), n.contiguous(), power, coarse_power)
        ctx.grid = grid
        ctx.save_for_backward(p, n, r2, r2_c, use_c)
        return irr

    @staticmethod
    @profiling.traced("backward.irradiance")
    def backward(ctx, g):
        grid = ctx.grid
        p, n, r2, r2_c, use_c = ctx.saved_tensors
        levels = [(grid, r2, ~use_c, 4)]
        if grid.coarse is not None:
            levels.append((grid.coarse, r2_c, use_c, 5))
        grads = [None] * 6
        for level, l_r2, mine, slot in levels:
            if not ctx.needs_input_grad[slot]:
                continue
            gp = torch.zeros_like(level.power)
            for cs in _chunks(p.shape[0], backward_chunk(level)):
                idx, acc = _accepted(level, p[cs], n[cs], l_r2[cs])
                pt, cand = torch.nonzero(acc & mine[cs, None], as_tuple=True)
                w = g[cs] / (PI * l_r2[cs, None])
                gp = gp + segment_sum(w[pt], idx[pt, cand],
                                      level.power.shape[0])
            grads[slot] = gp
        return tuple(grads)


def grid_irradiance(grid: PhotonGrid, p: torch.Tensor, n: torch.Tensor,
                    chunk: Optional[int] = None) -> torch.Tensor:
    """Irradiance estimate (N, 3) at points p with unit normals n
    (JAX ops/photon.py:178-308): the fine level's density-adaptive
    gather, and the coarse level's where the fine one holds fewer than
    knn photons within its radius and the coarse one reaches knn.
    On the CPU points go `chunk` at a time (default: gather_chunk);
    `chunk` applies to the CPU alone: on the card one kernel launch
    takes them all. Neither the answer nor its gradient depends on it.
    Differentiable in grid.power and grid.coarse.power only. Counted,
    spanned and, while a sink is open, recorded as the module's
    docstring says."""
    if chunk is None and p.device.type == "cpu":
        chunk = gather_chunk(grid)
    coarse_power = None if grid.coarse is None else grid.coarse.power
    profiling.count("photon.gathers")
    profiling.count("photon.points", p.shape[0])
    with profiling.span("photon.gather"), \
            profiling.device_record("photon_gather", p) as rec:
        if rec is not None:
            rec.update(points=p.shape[0], p=p, grid=grid)
        return _Irradiance.apply(grid, chunk, p, n, grid.power,
                                 coarse_power)


def irradiance_estimate(maps: PhotonMaps, p: torch.Tensor,
                        n: torch.Tensor) -> torch.Tensor:
    """Global + caustic irradiance (Scene.cpp:294-298)."""
    n_unit = safe_normalize(n)
    out = torch.zeros_like(p)
    if maps.global_map is not None:
        out = out + grid_irradiance(maps.global_map, p, n_unit)
    if maps.caustic_map is not None:
        out = out + grid_irradiance(maps.caustic_map, p, n_unit)
    return out


# ---------------------------------------------------------------------------
# Photon tracing (wavefront)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PhotonUniforms:
    """Every uniform one batch of n photons takes, for depth_limit + 1
    levels: the emission origin and direction (N, 2), and per level the
    roulette (L, N), the cosine bounce (L, N, 2), the two Phong lobes
    (L, 2, N, 2; None unless path tracing) and the Fresnel roulette
    (L, N)."""
    origin: torch.Tensor
    direction: torch.Tensor
    roulette: torch.Tensor
    bounce: torch.Tensor
    lobes: Optional[torch.Tensor]
    fresnel: torch.Tensor


def draw_photon_uniforms(gen: torch.Generator, n_emit: int, depth_limit: int,
                         path_tracing: bool, device=None) -> PhotonUniforms:
    """PhotonUniforms drawn from gen, field by field in declaration
    order, placed on `device`."""
    lv = depth_limit + 1
    return PhotonUniforms(
        origin=uniform(gen, (n_emit, 2), device),
        direction=uniform(gen, (n_emit, 2), device),
        roulette=uniform(gen, (lv, n_emit), device),
        bounce=uniform(gen, (lv, n_emit, 2), device),
        lobes=(uniform(gen, (lv, 2, n_emit, 2), device) if path_tracing
               else None),
        fresnel=uniform(gen, (lv, n_emit), device))


@dataclasses.dataclass
class StoredBatch:
    pos: torch.Tensor      # (L, N, 3) per-level stored photon positions
    dir: torch.Tensor      # (L, N, 3)
    power: torch.Tensor    # (L, N, 3)
    mask: torch.Tensor     # (L, N) bool
    bounces: torch.Tensor  # (L,) int64 photons alive and hitting a level


def emitted_power(p0: torch.Tensor, area: torch.Tensor,
                  caustic: bool) -> torch.Tensor:
    """A directional-area light's photon power p0 * area, a tenth of it
    for caustic photons, divided as the jitted JAX tracer divides
    (vecmath.div_scalar; a global photon's is not divided at all)."""
    p0 = p0 * area
    return div_scalar(p0, 10.0) if caustic else p0


def _avg(x: torch.Tensor) -> torch.Tensor:
    """Mean over the last axis of 3, summed left to right and divided as
    jitted jnp.mean divides (vecmath.div_scalar)."""
    return div_scalar((x[..., 0] + x[..., 1]) + x[..., 2], 3.0)


@torch.no_grad()
def trace_photon_batch(scene: Scene, static: SceneStatic, light_i: int,
                       caustic: bool, path_tracing: bool,
                       u: PhotonUniforms) -> StoredBatch:
    """Emit and trace one batch of photons from light light_i on the
    uniforms u (n photons, depth_limit + 1 levels by their shapes), as
    JAX ops/photon.py:336-426 does. Returns the per-level stored
    photons (masked)."""
    lt = scene.lights
    mats = scene.materials
    dev = scene.device
    n_emit = u.origin.shape[0]
    pos = sample_origin(lt, light_i, u.origin)
    dirs = sample_photon_direction(lt, light_i, u.direction)
    # power = color * wattage * pi * r^2 (/10 caustic), Scene.cpp:380-385
    p0 = lt.color[light_i] * lt.wattage[light_i]
    if lt.kinds[light_i] == LIGHT_DIRECTIONAL_AREA:
        p0 = emitted_power(p0, PI * (lt.radius[light_i] * lt.radius[light_i]),
                           caustic)
    power = p0.expand(n_emit, 3)
    alive = torch.ones(n_emit, dtype=torch.bool, device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)

    levels = []
    for level in range(u.roulette.shape[0]):
        depth_after = level + 1
        o = pos + EPSILON * dirs                        # Scene.cpp:535
        hit, surf = trace_closest(scene, static, o, dirs)
        live = alive & hit.hit

        mid = surf.material_id
        tex = diffuse_color(mats, scene.images, mid, surf.uv, surf.p,
                            static.texture_kinds)
        p_diff = _avg(tex)                              # average()
        p_refl = p_diff + _avg(take_rows(mats.ks, mid))
        p_refr = p_refl + _avg(take_rows(mats.kt, mid))
        rnd = u.roulette[level]
        take_diff = live & (rnd < p_diff)
        take_refl = live & (rnd >= p_diff) & (rnd < p_refl)
        take_refr = live & (rnd >= p_refl) & (rnd < p_refr)
        # rnd >= p_refr: absorbed

        # store (diffuse, indirect only)
        store = take_diff & (depth_after > 1)
        levels.append((surf.p, dirs, power, store, live.sum()))

        # first-bounce gates (Scene.cpp:596-628)
        if depth_after == 1:
            if caustic:
                take_diff = torch.zeros_like(take_diff)  # die unstored
            else:
                take_refl = torch.zeros_like(take_refl)  # caustic-only
                take_refr = torch.zeros_like(take_refr)

        # continuations
        n_unit = safe_normalize(surf.n)
        cos_d, _ = cosine_hemisphere(u.bounce[level], n_unit)
        diff_power = tex * power / torch.clamp(p_diff, min=1e-12)[:, None]

        mirror = safe_normalize(reflect(dirs, n_unit))
        ior = take_rows(mats.ior, mid)
        rs = fresnel_rs(dirs, n_unit, ior)
        refr_d = safe_normalize(refract(dirs, n_unit, ior)[0])
        if path_tracing:
            shin = take_rows(mats.shininess, mid)
            mirror = phong_lobe(u.lobes[level, 0], mirror, shin)[0]
            refr_d = phong_lobe(u.lobes[level, 1], refr_d, shin)[0]
        fres_reflect = u.fresnel[level] < rs
        refr_dir = torch.where(fres_reflect[:, None], mirror, refr_d)

        new_dir = torch.where(take_diff[:, None], cos_d,
                              torch.where(take_refl[:, None], mirror,
                                          refr_dir))
        power = torch.where(take_diff[:, None], diff_power, power)
        alive = take_diff | take_refl | take_refr
        pos = surf.p
        dirs = torch.where(alive[:, None], new_dir, up)

    return StoredBatch(pos=torch.stack([lv[0] for lv in levels]),
                       dir=torch.stack([lv[1] for lv in levels]),
                       power=torch.stack([lv[2] for lv in levels]),
                       mask=torch.stack([lv[3] for lv in levels]),
                       bounces=torch.stack([lv[4] for lv in levels]))


def draw_trace_photon_batch(scene: Scene, static: SceneStatic, light_i: int,
                            n_emit: int, caustic: bool, depth_limit: int,
                            path_tracing: bool,
                            gen: torch.Generator) -> StoredBatch:
    """trace_photon_batch on uniforms drawn from gen."""
    u = draw_photon_uniforms(gen, n_emit, depth_limit, path_tracing,
                             scene.device)
    return trace_photon_batch(scene, static, light_i, caustic, path_tracing,
                              u)


def trace_photon_batch_sharded(scene: Scene, static: SceneStatic,
                               light_i: int, n_emit: int, caustic: bool,
                               depth_limit: int, path_tracing: bool,
                               seed: int, mesh) -> StoredBatch:
    """Photon emission sharded over a mesh (JAX ops/photon.py:429-466,
    the reference's OpenMP photon batches, Scene.cpp:372-394): shard s
    traces ceil(n_emit / shards) photons from a generator seeded with
    core/sampling.fold_seed(seed, s). The per-level arrays are
    concatenated along the photon axis in shard order, across the
    processes by an all-gather (every process holds the same number of
    shards, so each contributes equal (L, photons) slabs); the bounce
    counters are summed."""
    # parallel/__init__ imports the integrator, which imports this module
    from cse168_raytracer_tpu_torch.parallel.distributed import (
        all_gather_cat, all_reduce_sum)
    per = -(-n_emit // mesh.n_shards)
    outs = [draw_trace_photon_batch(scene, static, light_i, per, caustic,
                                    depth_limit, path_tracing,
                                    stream(seed, s, scene.device))
            for s in mesh.local_shards]
    cat = lambda f: all_gather_cat(torch.cat([getattr(o, f) for o in outs],
                                             1), mesh, 1)
    mask = all_gather_cat(torch.cat([o.mask for o in outs], 1).to(
        torch.uint8), mesh, 1).bool()
    return StoredBatch(pos=cat("pos"), dir=cat("dir"), power=cat("power"),
                       mask=mask, bounces=all_reduce_sum(
                           sum(o.bounces for o in outs), mesh))


def _auto_radius(pos: np.ndarray, k_target: int, max_per_cell: int) -> float:
    """The gather radius at which a typical disc holds about k_target
    photons (JAX ops/photon.py:466-495, the same numpy): each of m <=
    4000 subsampled photons' distance to its ceil(k m / n)-th nearest
    neighbour in the subsample, the median, clipped to [1e-4, 0.1] of
    the cloud's diagonal."""
    n = pos.shape[0]
    if n < 8:
        return 1.0
    k_eff = int(k_target)
    m = int(min(n, 4000))
    rng = np.random.RandomState(0)
    sub = pos[rng.choice(n, m, replace=False)].astype(np.float64)
    k_sub = max(1, int(round(k_eff * m / n)))
    k_sub = min(k_sub, m - 1)
    d2 = ((sub[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    kth = np.sqrt(np.partition(d2, k_sub, axis=1)[:, k_sub])
    r = float(np.median(kth))
    diag = float(np.linalg.norm(pos.max(0) - pos.min(0))) or 1.0
    return float(np.clip(r, 1e-4 * diag, 0.1 * diag))


@profiling.phase("photons.build")
def build_photon_maps(scene: Scene, static: SceneStatic, cfg: RenderConfig,
                      gen: torch.Generator,
                      path_tracing: Optional[bool] = None,
                      return_stats: bool = False, mesh=None):
    """Scene::tracePhotons + traceCausticPhotons (JAX ops/photon.py:
    498-602): per map, batches from each directional-area light until
    it has stored the target (or cfg.photon_max_batches), the stored
    photons truncated to target * emitters, powers scaled by
    1 / emitted, the auto radius, and the grids on the scene's device;
    the maps keep those photons (PhotonMaps.photons).
    Batches hold 65536 photons on the card and 10000 on the CPU. The
    maps are constants of the scene's parameters: photons come back to
    the host between batches, so no gradient flows through emission,
    while the gather is differentiable in the stored powers. None (and
    {} stats) when no light emits. return_stats adds each map's
    emitted, stored, bounces and stored_per_level counts. With `mesh`
    (parallel/distributed.Mesh) each batch is sharded over it
    (trace_photon_batch_sharded; the batch rounded up to a multiple of
    the shard count): batch b is seeded with fold_seed(base, b), base
    one draw from gen, so every process builds the same maps."""
    if path_tracing is None:
        path_tracing = cfg.path_tracing
    emitters = [i for i, k in enumerate(scene.lights.kinds)
                if k == LIGHT_DIRECTIONAL_AREA]
    if not emitters:
        return (None, {}) if return_stats else None
    dev = scene.device
    batch = 65536 if dev.type == "cuda" else 10000
    if mesh is not None:
        batch = -(-batch // mesh.n_shards) * mesh.n_shards
        base = int(torch.randint(1 << 62, (1,), generator=gen,
                                 device=gen.device))
    n_batches = 0
    maps = {}
    kept = {}
    stats = {}
    for caustic, target in ((False, cfg.photons_per_light),
                            (True, cfg.caustic_photons_per_light)):
        name = "caustic" if caustic else "global"
        stats[name] = dict(emitted=0, stored=0, bounces=0)
        kept[name] = None
        if target <= 0:
            maps[caustic] = None
            continue
        all_pos, all_dir, all_pow = [], [], []
        total_emitted = 0
        stored = 0
        for li in emitters:
            li_stored = 0
            it = 0
            while li_stored < target and it < cfg.photon_max_batches:
                if mesh is None:
                    out = draw_trace_photon_batch(
                        scene, static, li, batch, caustic,
                        cfg.trace_depth_photons, path_tracing, gen)
                else:
                    out = trace_photon_batch_sharded(
                        scene, static, li, batch, caustic,
                        cfg.trace_depth_photons, path_tracing,
                        fold_seed(base, n_batches), mesh)
                n_batches += 1
                m = out.mask.reshape(-1)
                all_pos.append(out.pos.reshape(-1, 3)[m].cpu().numpy())
                all_dir.append(out.dir.reshape(-1, 3)[m].cpu().numpy())
                all_pow.append(out.power.reshape(-1, 3)[m].cpu().numpy())
                li_stored += all_pos[-1].shape[0]
                total_emitted += batch
                stats[name]["bounces"] += int(out.bounces.sum())
                per_level = out.mask.sum(1).tolist()
                acc = stats[name].setdefault("stored_per_level",
                                             [0] * len(per_level))
                for d_, c_ in enumerate(per_level):
                    acc[d_] += c_
                it += 1
            stored += li_stored
        stats[name]["emitted"] = total_emitted
        stats[name]["stored"] = stored
        if stored == 0:
            maps[caustic] = None
            continue
        keep = target * len(emitters)
        pos = np.concatenate(all_pos)[:keep]
        dirs = np.concatenate(all_dir)[:keep]
        pows = np.concatenate(all_pow)[:keep] / max(total_emitted, 1)
        kept[name] = (pos, dirs, pows)
        radius = _auto_radius(pos, cfg.photon_samples,
                              cfg.photon_grid_max_per_cell)
        maps[caustic] = build_grid(
            pos, pows, dirs, radius, cfg.photon_grid_max_per_cell,
            knn=cfg.photon_samples,
            coarse_factor=(cfg.photon_coarse_factor
                           if cfg.photon_coarse_factor > 0 else None),
            device=dev)
    pm = PhotonMaps(global_map=maps[False], caustic_map=maps[True],
                    photons=kept)
    return (pm, stats) if return_stats else pm
