"""Time kernels K5 and K6 and the steps of their accelerator kinds, on one
NVIDIA GPU, optionally against another checkout of the repository.

    python3 cse168_raytracer_tpu_torch/profile_kinds.py [--res 512]
        [--reps 10] [--against DIR]

One run builds lit sponza_proxy at --res (chip_smoke.py's phase 9
scene), its "auto", "pallas_sah" and "pallas" accelerators, the frame's
primary rays in block order and the shadow rays toward the light from
their closest hits, and prints one line `RESULT {json}`: the ms of K5's
closest hit on the primary rays and any hit on the shadow rays, each
without and with its counters, and of K6 on the primary rays (CUDA
events over --reps launches after a warm-up); the ms of a fwd+bwd step
with "pallas_sah" and with "pallas" (5 steps after a warm-up); and a
digest of each kernel's outputs; and, by torch.profiler over one call,
the device time of each kernel launch and copy that each of the five
calls makes. With --against DIR it runs itself in turns on DIR's
package and on this checkout's (DIR, this, this, DIR), each in a
process of its own, and prints each quantity's mean over the two runs
of each, whether the two give the same outputs bit for bit, and the
first run's device times of each.
It imports the package of the checkout it measures (--root), so it times
an older commit's kernels with this file, and this checkout's timers
(chip_smoke.py's time_cuda and device_ops) whichever package it
measures. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("k5_closest", "k5_any", "k5_closest_stats", "k5_any_stats", "k6",
        "step_pallas_sah", "step_pallas")


def measure(res, reps):
    """One run on the package first on sys.path; returns the result."""
    import torch

    from cse168_raytracer_tpu_torch.config import EPSILON, RenderConfig
    from cse168_raytracer_tpu_torch.models.lights import (LIGHT_POINT,
                                                          make_light_table)
    from cse168_raytracer_tpu_torch.ops import binary_bvh as bb
    from cse168_raytracer_tpu_torch.ops import tri_blocks as tb
    from cse168_raytracer_tpu_torch.ops import wide_bvh as wb
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.camera import eye_rays
    from cse168_raytracer_tpu_torch.render.integrator import (
        block_ray_order, render_hdr)
    from cse168_raytracer_tpu_torch.scenes import build
    from chip_smoke import device_ops, time_cuda

    if not torch.cuda.is_available():
        raise SystemExit("profile_kinds: needs a CUDA device")
    dev = torch.device("cuda:0")
    cfg = RenderConfig(width=res, height=res, trace_depth=4)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=dev)
    scene = scene.replace(lights=make_light_table(
        [dict(kind=LIGHT_POINT, position=(0.0, 8.0, 0.0), color=(1, 1, 1),
              wattage=200.0)], dev))
    auto = attach_accel(scene, "auto")
    kinds = {k: attach_accel(scene, k) for k in ("pallas_sah", "pallas")}
    xs, ys = block_ray_order(res, res)
    o, d = eye_rays(cam, torch.tensor(xs, device=dev),
                    torch.tensor(ys, device=dev), res, res)
    o, d = o.contiguous(), d.contiguous()
    t = wb.closest_hit_triangles(auto.accel, o, d, 0.0, 1e12)[0]
    hit = t < 3e37
    p = o + torch.where(hit, t, 1.0)[:, None] * d
    lv = scene.lights.position[0] - p
    dist = lv.norm(dim=-1)
    ld = (lv / dist[:, None]).contiguous()
    primary = (o, d, 0.0, 1e12)
    shadow = ((p + ld * EPSILON).contiguous(), ld, 0.0,
              torch.where(hit, dist, -1.0).contiguous())
    sah, blocks = kinds["pallas_sah"].accel, kinds["pallas"].accel
    calls = {
        "k5_closest": lambda: bb.closest_hit_triangles(sah, *primary),
        "k5_any": lambda: bb.any_hit_triangles(sah, *shadow),
        "k5_closest_stats": lambda: bb.closest_hit_triangles(
            sah, *primary, with_stats=True),
        "k5_any_stats": lambda: bb.any_hit_triangles(sah, *shadow,
                                                     with_stats=True),
        "k6": lambda: tb.closest_hit(blocks, *primary),
    }

    def device_ms(fn):
        """{kernel or copy: device ms} of one call of fn."""
        out = {}
        for name, us in device_ops(fn) or []:
            out[name] = out.get(name, 0.0) + us / 1e3
        return out

    out, digest, kernels = {}, {}, {}
    for key, fn in calls.items():
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        h = hashlib.sha256()
        for x in got:
            h.update(x.cpu().numpy().tobytes())
        digest[key] = h.hexdigest()[:16]
        out[key] = time_cuda(fn, reps)
        kernels[key] = device_ms(fn)

    def step(s):
        kd = s.materials.kd.detach().clone().requires_grad_(True)
        hdr, _ = render_hdr(s.replace(materials=s.materials.replace(kd=kd)),
                            static, cam, cfg)
        hdr.sum().backward()

    for kind, s in kinds.items():
        out["step_" + kind] = time_cuda(lambda: step(s), 5)
    out["digest"] = digest
    out["device_ms"] = kernels
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    out["card"] = card.splitlines()[0] if card else "unknown"
    return out


def run_child(root, res, reps):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--root", root, "--res",
         str(res), "--reps", str(reps)], capture_output=True, text=True,
        timeout=900, cwd=root)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"profile_kinds on {root} failed:\n"
                       f"{proc.stdout}\n{proc.stderr}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose package is measured")
    ap.add_argument("--against", default=None, metavar="DIR",
                    help="another checkout to time in turns with this one")
    args = ap.parse_args(argv)
    if args.against is None:
        sys.path.insert(0, HERE)
        import chip_smoke  # noqa: F401  (this checkout's timers)
        sys.path.insert(0, os.path.abspath(args.root))
        print("RESULT " + json.dumps(measure(args.res, args.reps)),
              flush=True)
        return 0
    other = os.path.abspath(args.against)
    runs = []
    for label, root in (("against", other), ("this", HERE), ("this", HERE),
                        ("against", other)):
        r = run_child(root, args.res, args.reps)
        runs.append((label, r))
        print(f"[{label}] {root}: " + ", ".join(
            f"{k} {r[k]:.3f} ms" for k in KEYS) + f"; {r['card']}",
            flush=True)
    mean = {lab: {k: sum(r[k] for l2, r in runs if l2 == lab) / 2
                  for k in KEYS} for lab in ("against", "this")}
    same = all(r["digest"] == runs[0][1]["digest"] for _, r in runs)
    for k in KEYS:
        a, t = mean["against"][k], mean["this"][k]
        print(f"[mean] {k}: against {a:.3f} ms, this {t:.3f} ms "
              f"({a / t:.2f}x)")
    print(f"[outputs] bit-equal in all four runs: {same}")
    for label, r in (runs[0], runs[1]):
        for key, ks in r["device_ms"].items():
            print(f"[device {label}] {key}: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in ks.items()))
    print("RESULT " + json.dumps({"runs": runs, "mean": mean,
                                  "same_outputs": same}))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
