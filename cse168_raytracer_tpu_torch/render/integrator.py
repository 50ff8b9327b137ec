"""Wavefront Whitted integrator.

Counterpart of cse168_raytracer_tpu/render/integrator.py:52-464. Each
recursion level of Scene::traceScene (Scene.cpp:270-346) is a
fixed-capacity wavefront:

  per level: closest hit -> direct lighting with shadow rays -> the
  environment on a miss, accumulated per primary ray; then each ray
  spawns up to two children:
    mirror child  w *= ks + kt*Rs*[Rs > 0.01]  (the reference's
      reflection and Fresnel-reflection rays share a direction here)
    refract child w *= kt*(1 - Rs)  (TIR falls back to the mirror
      direction inside refract(), Ray.h:224-227)
  and the children are stream-compacted into the next level's pool.

Path tracing (-DPATH_TRACING) perturbs both children about their axes
with the glossy Phong lobe of the surface's shininess (Ray.h:149-158,
235-242); there is no diffuse bounce for camera rays in either mode
(diffuse interreflection is the photon map's, Scene.cpp:286-299). With
scene.photons, each level adds the maps' irradiance estimate to the
direct term at every live hit on a diffuse material (kd > 0,
JAX integrator.py:189-193); the gather runs on those lanes alone,
which gives every lane the value and gradient that evaluating the
whole pool and masking gives. A scene with nothing reflective or
refractive runs one level, as the reference's recursion stops after
Phong::shade.

The sampled render (path tracing or -DDOF) traces trace_samples
jittered (or thin-lens) primary wavefronts and averages them. All
randomness comes from one torch.Generator on the render's device,
seeded from cfg.seed, drawn in a fixed order: per sample and row band,
the pixel jitter, then the lens, then per level the square-light NEE
origins (light by light, sample by sample) and the two lobes. PyTorch
cannot replay the JAX package's key splits, so renders compare with it
statistically. Every draw is detached: the render stays differentiable
in the material table for a fixed generator state.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from cse168_raytracer_tpu_torch.config import (EPSILON, MIRO_TMAX,
                                               RenderConfig)
from cse168_raytracer_tpu_torch.core.fastgather import take_rows
from cse168_raytracer_tpu_torch.core.sampling import draw_phong_lobe
from cse168_raytracer_tpu_torch.core.vecmath import (div_scalar, fresnel_rs,
                                                     reflect, refract,
                                                     safe_normalize,
                                                     unit_axis)
from cse168_raytracer_tpu_torch.models.materials import is_diffuse
from cse168_raytracer_tpu_torch.models.scene import Scene, SceneStatic
from cse168_raytracer_tpu_torch.models.textures import env_lookup
from cse168_raytracer_tpu_torch.ops.photon import irradiance_estimate
from cse168_raytracer_tpu_torch.ops.shading import shade_direct, trace_closest
from cse168_raytracer_tpu_torch.ops.wide_bvh import frame_errors
from cse168_raytracer_tpu_torch.render.camera import (Camera, camera_basis,
                                                      draw_eye_rays, eye_rays)
from cse168_raytracer_tpu_torch.utils import profiling


@dataclasses.dataclass
class Wavefront:
    o: torch.Tensor       # (C, 3)
    d: torch.Tensor       # (C, 3)
    weight: torch.Tensor  # (C, 3)
    pixel: torch.Tensor   # (C,) int64
    alive: torch.Tensor   # (C,) bool


@dataclasses.dataclass
class RenderStats:
    """Counters of a render (Stats.h equivalents), int64 0-d tensors on
    the render's device. box_tests / tri_tests are the traversal's
    in-kernel counters (kernel K3) summed over every ray the render
    traced, closest-hit, shadow and secondary alike; zero unless
    cfg.collect_stats and the scene has a tree. The JAX package sums
    them as float32 because int32 overflows; int64 does not."""
    primary_rays: torch.Tensor
    secondary_rays: torch.Tensor
    shadow_rays: torch.Tensor
    dropped_rays: torch.Tensor   # pool-overflow children
    box_tests: torch.Tensor
    tri_tests: torch.Tensor


_COUNTERS = ("secondary_rays", "shadow_rays", "dropped_rays", "box_tests",
             "tri_tests")


def _total_stats(parts, primary_rays: int, device) -> RenderStats:
    """The stats of several wavefronts of one render, summed."""
    primary = torch.full((), primary_rays, dtype=torch.int64, device=device)
    return RenderStats(primary_rays=primary,
                       **{f: sum(getattr(p, f) for p in parts)
                          for f in _COUNTERS})


def _pad_wavefront(o, d, weight, pixel, capacity: int) -> Wavefront:
    n = o.shape[0]
    pad = capacity - n
    if pad < 0:
        raise ValueError("wavefront larger than its capacity")
    if pad:
        z3 = o.new_zeros((pad, 3))
        o = torch.cat([o, z3])
        d = torch.cat([d, unit_axis(2, d.dtype, d.device).expand(pad, 3)])
        weight = torch.cat([weight, z3])
        pixel = torch.cat([pixel, pixel.new_zeros((pad,))])
    alive = torch.arange(capacity, device=o.device) < n
    return Wavefront(o=o, d=d, weight=weight, pixel=pixel, alive=alive)


def _compact(cands: Wavefront, capacity: int):
    """Stream-compact alive candidates (leading dim >= capacity) into a
    fresh pool of `capacity`, in order. Returns (Wavefront, dropped)."""
    alive = cands.alive
    idx = torch.cumsum(alive.to(torch.int64), 0) - 1
    dest = torch.where(alive & (idx < capacity), idx, capacity)
    dropped = (alive & (idx >= capacity)).sum()

    def scat(x):
        out = x.new_zeros((capacity + 1,) + x.shape[1:])
        return out.index_put((dest,), x)[:capacity]

    n_alive = alive.sum()
    slot_alive = torch.arange(capacity, device=alive.device) < n_alive
    d = torch.where(slot_alive[:, None], scat(cands.d),
                    unit_axis(2, cands.d.dtype, cands.d.device))
    return Wavefront(o=scat(cands.o), d=d, weight=scat(cands.weight),
                     pixel=scat(cands.pixel), alive=slot_alive), dropped


def add_in_lane_order(radiance: torch.Tensor, pixel: torch.Tensor,
                      contrib: torch.Tensor,
                      alive: torch.Tensor) -> torch.Tensor:
    """radiance.index_add(0, pixel, contrib) over the alive lanes with
    each pixel's terms added in lane order, ((r + c_i) + c_j) for lanes
    i < j, on every device: the CPU's index_add adds in that order; the
    card's adds by float atomics, in any order, and the atomics flush
    subnormal results to zero (a Fresnel split gives a pixel two terms
    in one level; a highlight's ipow(x, 500) is often subnormal). Here a
    stable sort groups each pixel's lanes in lane order, and pass k adds
    every pixel's k-th term by a gather and a plain store, one lane a
    pixel, so no atomic is involved. Dead lanes add nothing. A pass per
    term suits a pixel's few terms a level; a sum into a zeroed table
    whose rows take many terms (a gradient scatter) is
    ops/segment_sum.py's tree, in a fixed number of launches."""
    n = pixel.shape[0]
    sentinel = radiance.shape[0]
    key, perm = torch.sort(torch.where(alive, pixel, sentinel), stable=True)
    head = torch.ones(n, dtype=torch.bool, device=pixel.device)
    head[1:] = key[1:] != key[:-1]
    with profiling.sync("lane_order.heads", key):
        start = torch.nonzero(head & (key != sentinel))[:, 0]
    pix = key[start]
    # bincount on the card reads the keys' least and largest: two syncs
    with profiling.sync("lane_order.counts", key, n=2):
        length = torch.bincount(key, minlength=sentinel + 1)[pix]
    longest = 0
    if start.numel():
        with profiling.sync("lane_order.longest", key):
            longest = int(length.max())
    for k in range(longest):
        has = length > k
        lane = perm[torch.where(has, start + k, start)]
        term = torch.where(has[:, None], contrib[lane], 0.0)
        radiance = radiance.index_put((pix,), radiance[pix] + term)
    return radiance


def _children(mats, wf: Wavefront, surf, live_hit, capacity: int,
              gen: Optional[torch.Generator], path_tracing: bool):
    """The next level's pool: each live hit's mirror and refraction
    children, compacted. Returns (Wavefront, dropped)."""
    mid = surf.material_id
    n = surf.n
    ks = take_rows(mats.ks, mid)
    kt = take_rows(mats.kt, mid)
    ior = take_rows(mats.ior, mid)
    shin = take_rows(mats.shininess, mid)
    refl_flag = (ks > 0).any(-1)
    refr_flag = (kt > 0).any(-1)
    rs = fresnel_rs(wf.d, n, ior)
    mirror_w = (torch.where(refl_flag[:, None], ks, 0.0)
                + torch.where((refr_flag & (rs > 0.01))[:, None],
                              kt * rs[:, None], 0.0))
    refr_d, _tir = refract(wf.d, n, ior)
    refr_w = torch.where(refr_flag[:, None], kt * (1.0 - rs[:, None]), 0.0)
    mirror_d = safe_normalize(reflect(wf.d, n))
    refr_d = safe_normalize(refr_d)
    if path_tracing:
        # glossy perturbation about each axis (Ray.h:149-158, 235-242)
        mirror_d = draw_phong_lobe(gen, mirror_d, shin)[0]
        refr_d = draw_phong_lobe(gen, refr_d, shin)[0]

    def child(dir_c, w_c):
        w = wf.weight * w_c
        return Wavefront(o=surf.p + dir_c * EPSILON,  # Ray.h:91/162/241
                         d=dir_c, weight=w, pixel=wf.pixel,
                         alive=live_hit & (w > 0).any(-1))

    c1, c2 = child(mirror_d, mirror_w), child(refr_d, refr_w)
    cands = Wavefront(*(torch.cat([getattr(c1, f.name), getattr(c2, f.name)])
                        for f in dataclasses.fields(Wavefront)))
    return _compact(cands, capacity)


def integrate(scene: Scene, static: SceneStatic, o, d, pixel,
              n_pixels: int, depth: int, capacity: Optional[int] = None,
              gen: Optional[torch.Generator] = None,
              path_tracing: bool = False, collect_stats: bool = False,
              disable_shadows: bool = False, light_samples: int = 1,
              ray_order: bool = False):
    """Trace a primary wavefront to completion.

    o, d: (N, 3) primary rays; pixel: (N,) pixel ids in [0, n_pixels).
    gen draws the lobes of path_tracing and the square-light origins.
    Returns (radiance (n_pixels, 3), the SUM over the wavefront, and
    RenderStats). ray_order=True returns radiance per PRIMARY-RAY LANE
    (N, 3) instead: level 0 adds elementwise and only child levels
    scatter into their primary lane.
    """
    n0 = o.shape[0]
    dev = o.device
    if capacity is None:
        capacity = n0 * (2 if static.any_refractive else 1)
    capacity = max(capacity, n0)
    if ray_order:
        n_pixels = n0
        pixel = torch.arange(n0, device=dev)
    radiance = torch.zeros((n_pixels, 3), dtype=torch.float32, device=dev)
    wf = _pad_wavefront(o, d, torch.ones((n0, 3), device=dev),
                        pixel.to(torch.int64), capacity)
    mats = scene.materials
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    sec, shad, drop, boxt, trit = zero, zero, zero, zero, zero
    can_spawn = static.any_reflective or static.any_refractive
    no_diffuse = torch.zeros(capacity, dtype=torch.bool, device=dev)

    for level in range(depth + 1 if can_spawn else 1):
        with profiling.span("integrate.level"):
            # dead lanes get tmax < tmin: the traversal skips them
            with profiling.span("integrate.closest"):
                lane_tmax = torch.where(wf.alive, MIRO_TMAX, -1.0)
                hit, surf, *counts = trace_closest(
                    scene, static, wf.o, wf.d, tmax=lane_tmax,
                    collect_stats=collect_stats)
                live_hit = wf.alive & hit.hit
            with profiling.span("integrate.shade"):
                direct, _tex, n_sh, *sh_counts = shade_direct(
                    scene, static, wf.d, surf, gen,
                    disable_shadows=disable_shadows,
                    light_samples=light_samples, collect_stats=collect_stats)
            if collect_stats:
                for box, tri in counts + sh_counts:
                    boxt, trit = boxt + box, trit + tri
            if scene.photons is not None:
                with profiling.span("integrate.photons"):
                    diffuse = live_hit & is_diffuse(mats, surf.material_id)
                    with profiling.sync("photon_lanes", diffuse):
                        lanes = torch.nonzero(diffuse)[:, 0]
                    # the lanes are distinct: a plain store of direct +
                    # estimate, JAX's add, with no atomic
                    direct = direct.index_put((lanes,), direct[lanes]
                                              + irradiance_estimate(
                                                  scene.photons,
                                                  surf.p[lanes],
                                                  surf.n[lanes]))
            with profiling.span("integrate.accumulate"):
                # env on a miss (Scene.cpp:338-342); camera rays are never
                # diffuse
                env = env_lookup(scene.env, wf.d, no_diffuse)
                add = torch.where(live_hit[:, None], direct,
                                  torch.where(wf.alive[:, None], env, 0.0))
                if ray_order and level == 0:
                    radiance = radiance + (wf.weight * add)[:n_pixels]
                else:
                    radiance = add_in_lane_order(radiance, wf.pixel,
                                                 wf.weight * add, wf.alive)
                shad = shad + n_sh * live_hit.sum()
            if not can_spawn:
                break
            with profiling.span("integrate.children"):
                wf, dropped = _children(mats, wf, surf, live_hit, capacity,
                                        gen, path_tracing)
                sec = sec + wf.alive.sum()
                drop = drop + dropped

    primary = torch.full((), n0, dtype=torch.int64, device=dev)
    stats = RenderStats(primary_rays=primary, secondary_rays=sec,
                        shadow_rays=shad, dropped_rays=drop, box_tests=boxt,
                        tri_tests=trit)
    profiling.record("render_stats", (primary, sec, shad))
    return radiance, stats


@functools.lru_cache(maxsize=8)
def block_ray_order(width: int, height: int):
    """Pixel (x, y) of each ray in the 16x8 pixel-block order: each
    block of 128 consecutive rays covers a compact image patch, so the
    traversal's neighbouring threads take coherent paths. Cached (the
    sort costs tens of milliseconds at 512x512); the arrays are
    read-only."""
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    xs, ys = xs.reshape(-1), ys.reshape(-1)
    order = np.lexsort((xs % 16, ys % 8, xs // 16, ys // 8))
    xs, ys = xs[order], ys[order]
    xs.flags.writeable = ys.flags.writeable = False
    return xs, ys


@profiling.traced("render.band")
@frame_errors()
def render_hdr_band(scene: Scene, static: SceneStatic, cam: Camera,
                    cfg: RenderConfig, gen: Optional[torch.Generator],
                    y0: int, n_rows: int):
    """Rows [y0, y0 + n_rows) of the deterministic (Whitted) render
    (JAX render/integrator.py:285-319), for chunking a frame into
    separate calls. The 16x8 block order is built band-local and its
    rows offset by y0 (the order is translation-invariant for 8-aligned
    bands); pixel ids are band-local. gen draws square-light origins
    (None: seeded from cfg.seed on the scene's device). Returns
    ((n_rows, w, 3) linear HDR in image row order, RenderStats); bands
    stacked over the frame give render_hdr's image. Like render_hdr, one
    frame: its traversal errors raise at its end (wide_bvh.frame_errors)."""
    w = cfg.width
    if n_rows % 8 or w % 16:
        raise ValueError("a band needs whole 16x8 blocks: n_rows a "
                         "multiple of 8 and the width of 16")
    dev = scene.device
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    xs_n, ys_n = block_ray_order(w, n_rows)
    with profiling.sync("pixel_order", dev, n=2):
        xs = torch.tensor(xs_n, device=dev)
        ys_local = torch.tensor(ys_n, device=dev)
    pixel = ys_local * w + xs
    o, d = eye_rays(cam, xs, ys_local + y0, w, cfg.height)
    radiance, stats = integrate(
        scene, static, o, d, pixel, n_rows * w, cfg.trace_depth, gen=gen,
        collect_stats=cfg.collect_stats,
        disable_shadows=cfg.disable_shadows,
        light_samples=cfg.light_samples, ray_order=True)
    radiance = (radiance.reshape(n_rows // 8, w // 16, 8, 16, 3)
                .permute(0, 2, 1, 3, 4).reshape(n_rows, w, 3))
    return radiance, stats


@profiling.traced("render.frame")
@frame_errors()
def render_hdr(scene: Scene, static: SceneStatic, cam: Camera,
               cfg: RenderConfig, gen: Optional[torch.Generator] = None):
    """Scene::raytraceImage before the tonemap (Scene.cpp:93-173).
    Returns ((H, W, 3) linear HDR, RenderStats); row 0 is the BOTTOM
    scanline (the reference's Image layout). With cfg.path_tracing or
    cfg.dof it averages cfg.trace_samples jittered (or thin-lens)
    samples per pixel. gen defaults to a generator on the scene's
    device seeded from cfg.seed; a generator on another device draws
    there and its numbers are moved to the scene's (core/sampling.py),
    so one CPU generator gives card and CPU renders the same draws.
    A frame blocks the host at its start (the pixel order and the
    camera's tan go to the card) and once at its end, where it reads the
    traversal's error bits (wide_bvh.frame_errors); nothing between its
    first launch and that read waits for the card."""
    w, h = cfg.width, cfg.height
    n_pix = w * h
    dev = scene.device
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    sampled = cfg.path_tracing or cfg.dof
    spp = cfg.trace_samples if sampled else 1
    xs_n, ys_n = block_ray_order(w, h)
    with profiling.sync("pixel_order", dev, n=2):
        xs = torch.tensor(xs_n, device=dev)
        ys = torch.tensor(ys_n, device=dev)
    pixel = ys * w + xs
    basis = camera_basis(cam, w, h)
    # the block order enumerates (yb, xb, yi, xi), so un-permuting
    # ray-ordered radiance is a reshape + transpose
    ray_order = (h % 8 == 0) and (w % 16 == 0)
    # row bands of contiguous rays bound the wavefront's memory
    rows = cfg.row_tile if cfg.row_tile > 0 else h
    if cfg.row_tile > 0 and (rows % 8 or h % rows):
        raise ValueError(f"row_tile {rows} must be a multiple of 8 "
                         f"dividing the height {h}")
    cpx = w * rows

    @profiling.traced("render.band")
    def band(c0):
        cs = slice(c0, c0 + cpx)
        if sampled:
            o, d = draw_eye_rays(
                cam, xs[cs], ys[cs], w, h, gen,
                dof_aperture=cfg.dof_aperture if cfg.dof else 0.0,
                dof_focus=cfg.dof_focus_plane, basis=basis)
        else:
            o, d = eye_rays(cam, xs[cs], ys[cs], w, h, basis=basis)
        return integrate(scene, static, o, d, pixel[cs], n_pix,
                         cfg.trace_depth, gen=gen,
                         path_tracing=cfg.path_tracing,
                         collect_stats=cfg.collect_stats,
                         disable_shadows=cfg.disable_shadows,
                         light_samples=cfg.light_samples,
                         ray_order=ray_order)

    acc, parts = None, []
    for _ in range(spp):
        out = [band(c0) for c0 in range(0, n_pix, cpx)]
        parts += [st for _, st in out]
        # bands are contiguous ray ranges in ray order; otherwise each
        # band scatters into the whole frame
        rads = [r for r, _ in out]
        rad = torch.cat(rads) if ray_order else functools.reduce(torch.add,
                                                                 rads)
        acc = rad if acc is None else acc + rad
    stats = (parts[0] if len(parts) == 1
             else _total_stats(parts, n_pix * spp, dev))
    if sampled:
        acc = div_scalar(acc, spp)
    if ray_order:
        acc = (acc.reshape(h // 8, w // 16, 8, 16, 3)
               .permute(0, 2, 1, 3, 4).reshape(h * w, 3))
    return acc.reshape(h, w, 3), stats
