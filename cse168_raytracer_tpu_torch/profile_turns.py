"""Time the main step and one `cli render` against another checkout of
the repository, in turns, on one NVIDIA GPU.

    python3 cse168_raytracer_tpu_torch/profile_turns.py --against DIR
        [--rounds 3] [--steps 10] [--photons]

One run, a process of its own on the package of the checkout --root,
builds sponza_proxy at 512x512, trace depth 4, with the "auto"
accelerator and times fwd+bwd steps of sum(render_hdr) with respect to
kd (chip_smoke.py's phase 4), as registered and lit (its light at
(0, 8, 0)): --steps steps after a warm-up, each step the time between
CUDA events recorded at its start and at the next step's start, with no
synchronisation between steps; then it runs `cli render --scene
sponza_proxy --stats` at 512x512, depth 4 (phase 8(a)) and takes its
steady render's time on the host clock. With --photons it also builds
chip_smoke.py's phase 11 photon maps on photon_box (seed 7) and times
the 512x512, depth-10 photon-mapped forward and irradiance_estimate on
65,536 level-0 diffuse points (CUDA events, --steps each after a
warm-up). It prints `RESULT {json}` with a digest of the lit image. With --against DIR it runs DIR's package and
this checkout's in turns (DIR, this, this, DIR), --rounds times, and
prints for each quantity and side the median of the runs' medians, the
range of the runs' medians (the run-to-run spread), the median and
interquartile range over all steps, and whether every run rendered the
same lit image bit for bit; and the card's name and power limit. Fails
without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = 512
DEPTH = 4
STEPS = ("registered", "lit")
PHOTON_STEPS = ("photon_fwd", "gather")


def timed(fn, steps):
    """ms of each of `steps` calls of fn after a warm-up, by CUDA events
    recorded between the calls."""
    import torch
    fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(steps + 1)]
    events[0].record()
    for ev in events[1:]:
        fn()
        ev.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def measure_photons(steps):
    """The photon-mapped forward and the gather on the package first on
    sys.path (chip_smoke.py's phase 11 configuration)."""
    import torch

    import chip_smoke
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.ops.photon import (build_photon_maps,
                                                       irradiance_estimate)
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    dev = torch.device("cuda:0")
    scene, static, cam = chip_smoke.photon_scene(dev)
    maps = build_photon_maps(scene, static,
                             RenderConfig(**chip_smoke.PHOTON_CFG),
                             torch.Generator(device=dev).manual_seed(7))
    lit = scene.replace(photons=maps)
    cfg = RenderConfig(width=RES, height=RES, trace_depth=10)
    p, n = chip_smoke.diffuse_points(scene, static, cam, 65_536, RES)
    with torch.no_grad():
        return {"photon_fwd": timed(lambda: render_hdr(lit, static, cam,
                                                       cfg), steps),
                "gather": timed(lambda: irradiance_estimate(maps, p, n),
                                steps)}


def measure(steps, photons=False):
    """One run on the package first on sys.path."""
    import torch

    from cse168_raytracer_tpu_torch import cli
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.models.lights import (LIGHT_POINT,
                                                          make_light_table)
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    from cse168_raytracer_tpu_torch.scenes import build

    if not torch.cuda.is_available():
        raise SystemExit("profile_turns: needs a CUDA device")
    dev = torch.device("cuda:0")
    cfg = RenderConfig(width=RES, height=RES, trace_depth=DEPTH)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=dev)
    scene = attach_accel(scene)
    lit = scene.replace(lights=make_light_table(
        [dict(kind=LIGHT_POINT, position=(0.0, 8.0, 0.0), color=(1, 1, 1),
              wattage=200.0)], dev))
    out = {}
    for label, s in (("registered", scene), ("lit", lit)):
        def step():
            kd = s.materials.kd.detach().clone().requires_grad_(True)
            hdr, _ = render_hdr(
                s.replace(materials=s.materials.replace(kd=kd)), static,
                cam, cfg)
            hdr.sum().backward()
            return hdr.detach()

        out[label] = timed(step, steps)
        if label == "lit":
            out["digest"] = hashlib.sha256(
                step().cpu().numpy().tobytes()).hexdigest()[:16]
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["render", "--scene", "sponza_proxy", "--width", str(RES),
                "--height", str(RES), "--depth", str(DEPTH), "--stats",
                "--out", os.path.join(tmp, "out.png")]
        with contextlib.redirect_stderr(io.StringIO()):
            res = cli.render(cli.parser().parse_args(argv))
    out["cli"] = [res["steady_s"] * 1e3]
    if photons:
        out.update(measure_photons(steps))
    return out


def run_child(root, steps, photons):
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--root", root,
         "--steps", str(steps)] + (["--photons"] if photons else []),
        capture_output=True, text=True, timeout=900, cwd=root)
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    raise RuntimeError(f"profile_turns on {root} failed:\n"
                       f"{proc.stdout}\n{proc.stderr}")


def summary(runs, key):
    """Median of the runs' medians, their range, and the median and
    interquartile range of all values."""
    meds = [statistics.median(r[key]) for r in runs]
    values = sorted(v for r in runs for v in r[key])
    q = statistics.quantiles(values, n=4) if len(values) > 1 else values * 3
    return {"median": statistics.median(meds), "run_min": min(meds),
            "run_max": max(meds), "all_median": statistics.median(values),
            "iqr": q[2] - q[0]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--root", default=HERE,
                    help="the checkout whose package is measured")
    ap.add_argument("--against", default=None, metavar="DIR",
                    help="another checkout to time in turns with this one")
    ap.add_argument("--photons", action="store_true",
                    help="also time the photon-mapped forward and gather")
    args = ap.parse_args(argv)
    if args.against is None:
        sys.path.insert(0, os.path.abspath(args.root))
        print("RESULT " + json.dumps(measure(args.steps, args.photons)),
              flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    other = os.path.abspath(args.against)
    runs = {"against": [], "this": []}
    keys = STEPS + ("cli",) + (PHOTON_STEPS if args.photons else ())
    for i in range(args.rounds):
        for label, root in (("against", other), ("this", HERE),
                            ("this", HERE), ("against", other)):
            r = run_child(root, args.steps, args.photons)
            runs[label].append(r)
            print(f"[round {i}] {label}: " + ", ".join(
                f"{k} median {statistics.median(r[k]):.3f} ms"
                for k in keys) + f"; lit image {r['digest']}", flush=True)
    result = {"card": card, "runs": runs, "summary": {}}
    for k in keys:
        result["summary"][k] = {lab: summary(rs, k)
                                for lab, rs in runs.items()}
        a, t = (result["summary"][k][lab] for lab in ("against", "this"))
        line = lambda x: (f"{x['median']:.3f} ms (runs {x['run_min']:.3f}-"
                          f"{x['run_max']:.3f}, all {x['all_median']:.3f}, "
                          f"IQR {x['iqr']:.3f})")
        print(f"[summary] {k}: against median {line(a)}; this {line(t)}; "
              f"this within the against runs' range: "
              f"{a['run_min'] <= t['median'] <= a['run_max']}")
    digests = {r["digest"] for rs in runs.values() for r in rs}
    result["same_lit_image"] = len(digests) == 1
    print(f"[outputs] the lit image bit-equal in every run: "
          f"{result['same_lit_image']}; {card}")
    print("RESULT " + json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
