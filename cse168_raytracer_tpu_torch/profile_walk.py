"""Where the card walk's cycles go, on one NVIDIA GPU.

    python -m cse168_raytracer_tpu_torch.profile_walk [--res 512]

Builds csrc/traverse_wide.cu with -DWALK_PROBE (its clock64 probe; the
plain build carries none of it) and runs, on that build, one fwd+bwd
step of profile_step.py's lit sponza_proxy (kernels K1, closest hit, and
K2, any hit) and one forward render with the traversal counters (K3).
For each kernel it prints, per warp: the clock cycles lane 0 spent
walking internal nodes and serving leaves (and the walk's share), the
rounds of serving, the leaf groups (distinct leaves served at once) and
ray-leaf pairs, the rays per group, and the serve cycles per pair and
per group. The probe adds a few clock reads per round; its times are
not the plain kernel's, which chip_smoke.py measures. Fails without a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from cse168_raytracer_tpu_torch.config import RenderConfig
from cse168_raytracer_tpu_torch.models.lights import (LIGHT_POINT,
                                                      make_light_table)
from cse168_raytracer_tpu_torch.ops import cuda_build, wide_bvh
from cse168_raytracer_tpu_torch.ops.accel import attach_accel
from cse168_raytracer_tpu_torch.profile_step import step
from cse168_raytracer_tpu_torch.render.integrator import render_hdr
from cse168_raytracer_tpu_torch.scenes import build


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_walk: needs a CUDA device")
    dev = torch.device("cuda:0")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    lib = wide_bvh._bind(cuda_build.load_library("traverse_wide.cu",
                                                 ("WALK_PROBE",)))
    lib.traverse_wide_probe.argtypes = [ctypes.c_void_p]
    wide_bvh._lib = lib
    sums, launches = {}, {}
    launch = wide_bvh._launch

    def probed(bvh, o, d, tmin, tmax, any_hit, with_stats=False):
        out = launch(bvh, o, d, tmin, tmax, any_hit, with_stats)
        got = (ctypes.c_ulonglong * 6)()
        rc = lib.traverse_wide_probe(got)
        if rc:
            raise RuntimeError(f"traverse_wide_probe: CUDA error {rc}")
        key = (f"W={bvh.width} {'any' if any_hit else 'closest'}"
               f"{' stats' if with_stats else ''}")
        sums[key] = [a + b for a, b in zip(sums.get(key, [0] * 6), got)]
        launches[key] = launches.get(key, 0) + 1
        return out

    wide_bvh._launch = probed
    cfg = RenderConfig(width=args.res, height=args.res, trace_depth=4)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=dev)
    scene = attach_accel(scene, "auto").replace(lights=make_light_table(
        [dict(kind=LIGHT_POINT, position=(0.0, 8.0, 0.0), color=(1, 1, 1),
              wattage=200.0)], dev))
    step(scene, static, cam, cfg)
    with torch.no_grad():
        render_hdr(scene, static, cam, cfg.replace(collect_stats=True))
    torch.cuda.synchronize()
    for key, (walk, serve, rounds, groups, pairs, warps) in sums.items():
        print(f"{key}: {launches[key]} launches, {warps} warps; per warp: "
              f"walk {walk / warps:.0f} cycles, serve {serve / warps:.0f} "
              f"cycles (walk share {100 * walk / (walk + serve):.1f}%); "
              f"rounds {rounds / warps:.2f}, groups {groups / warps:.2f}, "
              f"ray-leaf pairs {pairs / warps:.2f} "
              f"({pairs / max(groups, 1):.2f} rays per group); serve cycles "
              f"per pair {serve / max(pairs, 1):.0f}, per group "
              f"{serve / max(groups, 1):.0f}")


if __name__ == "__main__":
    main()
