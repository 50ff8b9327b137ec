"""Where the traversal kernels' cycles go, on one NVIDIA GPU.

    python -m cse168_raytracer_tpu_torch.profile_walk [--res 512]
        [--kernels wide binary blocks]

Builds each chosen kernel source with its clock64 probe (the plain
builds carry none of it) and runs it on lit sponza_proxy at --res:

- wide: csrc/traverse_wide.cu with -DWALK_PROBE, on one fwd+bwd step of
  the lit scene (kernels K1, closest hit, and K2, any hit) and one
  forward render with the traversal counters (K3);
- binary: csrc/traverse_binary.cu with -DWALK_PROBE (kernel K5, kind
  "pallas_sah"), closest hit on the primary rays and any hit on the lit
  shadow rays, each without and with its counters;
- blocks: csrc/tri_blocks.cu with -DK6_PROBE (kernel K6, kind
  "pallas"), closest hit on the primary rays.

For the walks it prints, per warp: the clock cycles lane 0 spent
walking internal nodes and serving leaves (and the walk's share), the
rounds of serving, the leaf groups (distinct leaves served at once) and
ray-leaf pairs, the rays per group, and the serve cycles per pair and
per group. For K6 it prints, per 256-ray tile, the cycles of thread 0
of its cull CTA in the cull and of its test CTAs in waiting for staged
operands and in the triangle tests, and the (tile, block) pairs
tested, on average and in the tile that passes the most blocks. A probe
adds a few clock reads per step; its times are not the plain kernel's,
which portbench/ and profile_kinds.py measure. Fails without a CUDA
device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from cse168_raytracer_tpu_torch.config import EPSILON, RenderConfig
from cse168_raytracer_tpu_torch.models.lights import (LIGHT_POINT,
                                                      make_light_table)
from cse168_raytracer_tpu_torch.ops import (binary_bvh, cuda_build,
                                            tri_blocks, wide_bvh)
from cse168_raytracer_tpu_torch.ops.accel import attach_accel
from cse168_raytracer_tpu_torch.ops.intersect import ray_bounds
from cse168_raytracer_tpu_torch.render.camera import eye_rays
from cse168_raytracer_tpu_torch.render.integrator import (block_ray_order,
                                                          render_hdr)
from cse168_raytracer_tpu_torch.scenes import build

KERNELS = ("wide", "binary", "blocks")


def step(scene, static, cam, cfg):
    """One fwd+bwd step of sum(render_hdr) w.r.t. kd; returns the
    gradient."""
    kd = scene.materials.kd.detach().clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(kd=kd))
    hdr, _ = render_hdr(s, static, cam, cfg)
    hdr.sum().backward()
    return kd.grad


def read_probe(fn):
    """The six sums of a probe entry point, which zeroes them."""
    got = (ctypes.c_ulonglong * 6)()
    rc = fn(got)
    if rc:
        raise RuntimeError(f"probe read: CUDA error {rc}")
    return list(got)


def walk_line(key, launches, sums):
    walk, serve, rounds, groups, pairs, warps = sums
    return (f"{key}: {launches} launches, {warps} warps; per warp: "
            f"walk {walk / warps:.0f} cycles, serve {serve / warps:.0f} "
            f"cycles (walk share {100 * walk / (walk + serve):.1f}%); "
            f"rounds {rounds / warps:.2f}, groups {groups / warps:.2f}, "
            f"ray-leaf pairs {pairs / warps:.2f} "
            f"({pairs / max(groups, 1):.2f} rays per group); serve cycles "
            f"per pair {serve / max(pairs, 1):.0f}, per group "
            f"{serve / max(groups, 1):.0f}")


def lit_scene(res, dev):
    cfg = RenderConfig(width=res, height=res, trace_depth=4)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=dev)
    scene = scene.replace(lights=make_light_table(
        [dict(kind=LIGHT_POINT, position=(0.0, 8.0, 0.0), color=(1, 1, 1),
              wattage=200.0)], dev))
    return scene, static, cam, cfg


def scene_rays(scene, cam, res, dev):
    """The frame's primary rays in the integrator's block order, and the
    shadow rays toward the light from their closest hits on the wide
    tree (missing rays get tmax = -1), as chip_smoke.py makes them."""
    xs, ys = block_ray_order(res, res)
    o, d = eye_rays(cam, torch.tensor(xs, device=dev),
                    torch.tensor(ys, device=dev), res, res)
    o, d = o.contiguous(), d.contiguous()
    auto = attach_accel(scene, "auto")
    t = wide_bvh.closest_hit_triangles(auto.accel, o, d, 0.0, 1e12)[0]
    hit = t < 3e37
    p = o + torch.where(hit, t, 1.0)[:, None] * d
    lv = scene.lights.position[0] - p
    dist = lv.norm(dim=-1)
    ld = (lv / dist[:, None]).contiguous()
    return {"primary": (o, d, 0.0, 1e12),
            "lit shadow": ((p + ld * EPSILON).contiguous(), ld, 0.0,
                           torch.where(hit, dist, -1.0).contiguous())}


def profile_wide(res, dev):
    lib = wide_bvh._bind(cuda_build.load_library("traverse_wide.cu",
                                                 ("WALK_PROBE",)))
    lib.traverse_wide_probe.argtypes = [ctypes.c_void_p]
    saved_lib, launch = wide_bvh._lib, wide_bvh._launch
    sums, launches = {}, {}

    def probed(bvh, o, d, tmin, tmax, any_hit, with_stats=False):
        out = launch(bvh, o, d, tmin, tmax, any_hit, with_stats)
        got = read_probe(lib.traverse_wide_probe)
        key = (f"W={bvh.width} {'any' if any_hit else 'closest'}"
               f"{' stats' if with_stats else ''}")
        sums[key] = [a + b for a, b in zip(sums.get(key, [0] * 6), got)]
        launches[key] = launches.get(key, 0) + 1
        return out

    wide_bvh._lib, wide_bvh._launch = lib, probed
    try:
        scene, static, cam, cfg = lit_scene(res, dev)
        scene = attach_accel(scene, "auto")
        step(scene, static, cam, cfg)
        with torch.no_grad():
            render_hdr(scene, static, cam, cfg.replace(collect_stats=True))
        torch.cuda.synchronize()
    finally:
        wide_bvh._lib, wide_bvh._launch = saved_lib, launch
    for key, s in sums.items():
        print("[wide] " + walk_line(key, launches[key], s))


def profile_binary(scene, rays):
    lib = binary_bvh._bind(cuda_build.load_library("traverse_binary.cu",
                                                   ("WALK_PROBE",)))
    lib.traverse_binary_probe.argtypes = [ctypes.c_void_p]
    saved = binary_bvh._lib
    binary_bvh._lib = lib
    try:
        bvh = attach_accel(scene, "pallas_sah").accel
        read_probe(lib.traverse_binary_probe)
        for key, any_hit in (("primary", False), ("lit shadow", True)):
            fn = (binary_bvh.any_hit_triangles if any_hit
                  else binary_bvh.closest_hit_triangles)
            for stats in (False, True):
                fn(bvh, *rays[key], with_stats=stats)
                torch.cuda.synchronize()
                got = read_probe(lib.traverse_binary_probe)
                mode = ("any" if any_hit else "closest") + (
                    " stats" if stats else "")
                print(f"[binary] {key} rays, " + walk_line(mode, 1, got))
    finally:
        binary_bvh._lib = saved


def profile_blocks(scene, rays):
    lib = tri_blocks._bind(cuda_build.load_library("tri_blocks.cu",
                                                   ("K6_PROBE",)))
    lib.tri_blocks_probe.argtypes = [ctypes.c_void_p]
    saved = tri_blocks._lib
    tri_blocks._lib = lib
    try:
        blocks = attach_accel(scene, "pallas").accel
        read_probe(lib.tri_blocks_probe)
        tri_blocks.closest_hit(blocks, *rays["primary"])
        torch.cuda.synchronize()
        cull, stage, test, tiles, pairs, ctas = read_probe(
            lib.tri_blocks_probe)
        o, d = rays["primary"][:2]
        per_tile = tri_blocks._launch(blocks, o, d,
                                      *ray_bounds(o, 0.0, 1e12),
                                      count_pairs=True)[2]
        read_probe(lib.tri_blocks_probe)
    finally:
        tri_blocks._lib = saved
    total = cull + stage + test
    print(f"[blocks] primary rays, closest: {tiles} tiles of 256 rays, "
          f"{blocks.num_blocks} blocks, {ctas} test CTAs; per tile: cull "
          f"{cull / tiles:.0f} cycles ({100 * cull / total:.1f}%), staging "
          f"{stage / tiles:.0f} ({100 * stage / total:.1f}%), tests "
          f"{test / tiles:.0f} ({100 * test / total:.1f}%); "
          f"{pairs / tiles:.3f} (tile, block) pairs, the most "
          f"{int(per_tile.max())} in one tile; per pair: staging "
          f"{stage / max(pairs, 1):.0f}, tests {test / max(pairs, 1):.0f} "
          "cycles")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_walk: needs a CUDA device")
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    if "wide" in args.kernels:
        profile_wide(args.res, dev)
    if "binary" in args.kernels or "blocks" in args.kernels:
        scene, _, cam, _ = lit_scene(args.res, dev)
        rays = scene_rays(scene, cam, args.res, dev)
        if "binary" in args.kernels:
            profile_binary(scene, rays)
        if "blocks" in args.kernels:
            profile_blocks(scene, rays)


if __name__ == "__main__":
    main()
