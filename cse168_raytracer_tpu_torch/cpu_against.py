"""Compare this checkout's CPU renders with another checkout's, bit for bit.

    python3 cse168_raytracer_tpu_torch/cpu_against.py --against DIR

Each checkout's package renders, on the CPU and in a process of its own,
the forward and the kd gradient of sum(render_hdr) of chip_smoke.py's
phase 5 scenes (sphere and mixed_scene at 64x64, depth 4, Whitted, and
mixed_scene path-traced at 2 spp on one seeded CPU generator),
refract_spheres at 64x64 and test_sphere at 80x48 (the camera's
divisions by a width and a height that are not powers of two); and
photon maps built on chip_smoke.py's photon_box (a coarse glass sphere,
20,000 + 20,000 photons from one seeded CPU generator), its 32x32
depth-10 render with them and the gradient w.r.t. the global map's
stored powers. It prints, for each, how many pixels, gradient entries
or stored photons differ in their bits between the two checkouts and
the largest relative difference. Needs no GPU.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = (("sphere", 64, 64, False), ("mixed", 64, 64, False),
         ("mixed", 64, 64, True), ("refract_spheres", 64, 64, False),
         ("test_sphere", 80, 48, False))


def render(out):
    """The CASES with the package and chip_smoke.py first on sys.path,
    saved to the .npz `out`."""
    import torch

    import chip_smoke
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.scenes import build
    cpu = torch.device("cpu")
    arrays = {}
    for name, w, h, traced in CASES:
        extra = dict(path_tracing=True, trace_samples=2) if traced else {}
        cfg = RenderConfig(width=w, height=h, trace_depth=4, **extra)
        if name == "mixed":
            scene, static, cam = chip_smoke.mixed_scene(cpu)
        else:
            scene, static, cam, _ = build(name, cfg, device=cpu)
        gen = torch.Generator("cpu").manual_seed(0) if traced else None
        hdr, grad, _ = chip_smoke.fwd_bwd(attach_accel(scene), static, cam,
                                          cfg, gen)
        key = name + (" path-traced" if traced else "")
        arrays[key + " hdr"] = hdr.numpy()
        arrays[key + " grad"] = grad.numpy()
    arrays.update(photons())
    np.savez(out, **arrays)


def photons():
    """photon_box's maps, render and global-power gradient (CPU)."""
    import torch

    import chip_smoke
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.photon import build_photon_maps
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    chip_smoke.SPHERE_RINGS = 8
    scene, static, cam = chip_smoke.photon_scene(torch.device("cpu"))
    cfg = RenderConfig(**dict(chip_smoke.PHOTON_CFG, photons_per_light=20_000,
                              caustic_photons_per_light=20_000))
    maps = build_photon_maps(scene, static, cfg,
                             torch.Generator().manual_seed(7))
    g = maps.global_map
    power = g.power.clone().requires_grad_(True)
    lit = scene.replace(photons=maps.replace(global_map=g.replace(
        power=power)))
    hdr = render_hdr(lit, static, cam, RenderConfig(width=32, height=32,
                                                    trace_depth=10))[0]
    hdr.sum().backward()
    return {"photon_box global map positions": g.pos.numpy(),
            "photon_box caustic map positions":
                maps.caustic_map.pos.numpy(),
            "photon_box hdr": hdr.detach().numpy(),
            "photon_box grad": power.grad.numpy()}


def run_child(root, out):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--root", root, "--out",
         out], capture_output=True, text=True, timeout=1800, cwd=root)
    if proc.returncode:
        raise RuntimeError(f"cpu_against on {root} failed:\n{proc.stdout}\n"
                           f"{proc.stderr}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="the other checkout")
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose package renders")
    ap.add_argument("--out", help="where a child writes its .npz")
    args = ap.parse_args(argv)
    if args.out:
        sys.path.insert(0, os.path.abspath(args.root))
        render(args.out)
        return 0
    if not args.against:
        ap.error("--against DIR is required")
    with tempfile.TemporaryDirectory() as tmp:
        runs = []
        for root in (os.path.abspath(args.against), HERE):
            out = os.path.join(tmp, f"{len(runs)}.npz")
            run_child(root, out)
            runs.append(np.load(out))
        other, this = runs
        for key in this.files:
            a, b = other[key], this[key]
            if a.shape != b.shape:
                print(f"{key}: shapes {a.shape} against {b.shape}")
                continue
            differ = a.view(np.int32) != b.view(np.int32)
            n = int(differ.any(-1).sum()) if key.endswith("hdr") \
                else int(differ.sum())
            rel = float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))
            print(f"{key} {a.shape}: {n} "
                  f"{'pixels' if key.endswith('hdr') else 'entries'} differ "
                  f"in their bits; max |diff| / max {rel:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
