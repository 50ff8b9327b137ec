"""Where the time of one main-path step goes, on one NVIDIA GPU.

    python -m cse168_raytracer_tpu_torch.profile_step [--res 512] [--steps 3]
        [--render] [--accel KIND] [--scene NAME]

Builds sponza_proxy with its light inside the atrium (as chip_smoke.py's
lit run; with --scene, that registry scene as registered, at its
registered trace depth, for example refract_spheres for the stone
texture and bump map at every level), attaches the accelerator KIND
(ops/accel.py; default "auto",
the wide BVH; the counterpart of the second argument of the JAX
package's tools/perf/profile_phases.py) and times fwd+bwd steps of
sum(render_hdr) with respect to kd by CUDA events; with --render, the
forward-only render with the traversal counters on, as `cli render
--stats` runs it. Then it traces the same steps with torch.profiler and
prints: the device's busy share of the traced wall time, the CUDA
kernels by total device time, and the host-side operators by total CPU
time. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import torch

from cse168_raytracer_tpu_torch.config import RenderConfig
from cse168_raytracer_tpu_torch.models.lights import (LIGHT_POINT,
                                                      make_light_table)
from cse168_raytracer_tpu_torch.ops.accel import KINDS, attach_accel
from cse168_raytracer_tpu_torch.render.integrator import render_hdr
from cse168_raytracer_tpu_torch.scenes import SCENES, build


def step(scene, static, cam, cfg):
    kd = scene.materials.kd.detach().clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(kd=kd))
    hdr, _ = render_hdr(s, static, cam, cfg)
    hdr.sum().backward()
    return kd.grad


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--rows", type=int, default=25,
                    help="rows of each table")
    ap.add_argument("--render", action="store_true",
                    help="profile the forward-only render with counters "
                         "(cli render --stats) instead of the fwd+bwd step")
    ap.add_argument("--accel", default="auto", choices=KINDS,
                    help="accelerator kind (ops/accel.py)")
    ap.add_argument("--scene", default="sponza_proxy", choices=sorted(SCENES),
                    help="registry scene; sponza_proxy is lit and traced "
                         "to depth 4, any other as registered")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    lit = args.scene == "sponza_proxy"
    cfg = RenderConfig(width=args.res, height=args.res)
    if lit:
        cfg = cfg.replace(trace_depth=4)
    scene, static, cam, cfg = build(args.scene, cfg, device=dev)
    scene = attach_accel(scene, args.accel)
    if lit:
        scene = scene.replace(lights=make_light_table(
            [dict(kind=LIGHT_POINT, position=(0.0, 8.0, 0.0),
                  color=(1, 1, 1), wattage=200.0)], dev))
    if args.render:
        cfg = cfg.replace(collect_stats=True)

        @torch.no_grad()
        def work():
            return render_hdr(scene, static, cam, cfg)[0]
    else:
        def work():
            return step(scene, static, cam, cfg)
    work()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.steps):
        work()
    end.record()
    torch.cuda.synchronize()
    print(f"{args.scene} {'render' if args.render else 'step'} (accel "
          f"{args.accel}, depth {cfg.trace_depth}) "
          f"{start.elapsed_time(end) / args.steps:.3f} ms "
          f"(CUDA events, mean of {args.steps})")

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.steps):
            work()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _union_us([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    print(f"traced {args.steps} steps: wall {wall_us / 1e3:.3f} ms, "
          f"{len(kernels)} device events, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% of wall; idle "
          f"{100 * (1 - busy / wall_us):.1f}%)")
    table = prof.key_averages()
    print(table.table(sort_by="cuda_time_total", row_limit=args.rows))
    print(table.table(sort_by="self_cpu_time_total", row_limit=args.rows))


def _union_us(ranges):
    """Total length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(ranges):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


if __name__ == "__main__":
    main()
