"""Time ops/segment_sum.py's kernel against another checkout's, in turns,
at the shapes chip_smoke.py's phase 13(g) gives it, on one NVIDIA GPU.

    python3 cse168_raytracer_tpu_torch/profile_segsum.py --against DIR
        [--rounds 2] [--reps 20]

This checkout records the inputs first: a lit sponza_proxy step's kd
backward (512x512, depth 4; one material, so one row) and ReattachRows'
backward w.r.t. the triangles' v0, the largest photon backward call of
photon_box's 512x512 depth-10 photon-power gradient (chip_smoke.py's
phase 11 maps), and made from seed 0: the kd terms as one run, a run of
2^21 terms, 262,144 x 29 terms on 2^19 + 1 rows (20 key bits) and runs
of 1-64 terms. Then one process a run, on the package of DIR or of this
checkout, loads them and for each shape checks segment_sum against
segment_sum_plain by torch.equal, times --reps calls by CUDA events
after a warm-up (chip_smoke.py's time_cuda), and lists the device operations of one call (kernels
and memsets) with torch.profiler. The runs go DIR, this, this, DIR,
--rounds times; it prints for each shape and side the median of the
runs' times, their range, and the operations a call with the device
time of each in the profiled call (chip_smoke.py's device_ops), and the
card's name and power limit. Fails without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = os.path.join(HERE, "cse168_raytracer_tpu_torch", "_build",
                      "segsum_shapes.pt")


def record(path):
    """The 13(g) inputs, saved to `path` as {label: (values, ids,
    n_rows)} on the CPU."""
    import torch
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from cse168_raytracer_tpu_torch.config import RenderConfig
    from cse168_raytracer_tpu_torch.core import fastgather
    from cse168_raytracer_tpu_torch.ops import photon as ph
    from cse168_raytracer_tpu_torch.ops import surface
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    from cse168_raytracer_tpu_torch.render.integrator import render_hdr
    from cse168_raytracer_tpu_torch.scenes import build
    dev = torch.device("cuda")
    cfg = RenderConfig(width=cs.RES, height=cs.RES, trace_depth=cs.DEPTH)
    scene, static, cam, cfg = build("sponza_proxy", cfg, device=dev)
    lit = cs.lit_sponza(attach_accel(scene))
    kd = cs.record_segment_sum(fastgather,
                               lambda: cs.fwd_bwd(lit, static, cam, cfg))

    def v0_step():
        v0 = lit.tris.v0.detach().clone().requires_grad_(True)
        s = lit.replace(tris=lit.tris.replace(v0=v0))
        render_hdr(s, static, cam, cfg)[0].sum().backward()
    tri = cs.record_segment_sum(surface, v0_step)
    pscene, pstatic, pcam = cs.photon_scene(dev)
    maps, _ = cs.phase_photon_build(dev, "", pscene, pstatic)
    big = RenderConfig(width=cs.PHOTON_RES, height=cs.PHOTON_RES,
                       trace_depth=10)
    level = cs.record_segment_sum(ph, lambda: cs.photon_power_grads(
        pscene, pstatic, pcam, big, maps))
    shapes = {"kd backward (main step)": kd,
              "kd backward, one run of all": (kd[0], torch.zeros_like(kd[1]),
                                              kd[2]),
              "ReattachRows backward (v0)": tri,
              "photon backward (13(f))": level}
    shapes.update(cs.segsum_synthetic(dev))
    torch.save({k: tuple(x.cpu() if torch.is_tensor(x) else x for x in v)
                for k, v in shapes.items()}, path)


def run_one(root, path, reps):
    """This process's run on the package of `root`: RESULT {json}."""
    sys.path.insert(0, HERE)
    import chip_smoke as cs     # this checkout's, before `root` is on the path
    sys.path.insert(0, root)
    import torch
    from cse168_raytracer_tpu_torch.ops import segment_sum as ss
    shapes = torch.load(path)
    out = {}
    for label, (v, ids, n_rows) in shapes.items():
        v, ids = v.cuda().contiguous(), ids.cuda().long().contiguous()
        want = ss.segment_sum_plain(v, ids, n_rows)
        got = ss.segment_sum(v, ids, n_rows)
        equal = bool(torch.equal(got, want))
        fn = lambda: ss.segment_sum(v, ids, n_rows)
        out[label] = {"ms": cs.time_cuda(fn, reps), "equal": equal,
                      "ops": cs.device_ops(fn) or []}
    print("RESULT " + json.dumps(out), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", required=True)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--root", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.root:
        return run_one(args.root, SHAPES, args.reps)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_segsum.py needs a CUDA device")
    os.makedirs(os.path.dirname(SHAPES), exist_ok=True)
    record(SHAPES)
    sides = {"parent": os.path.abspath(args.against), "this": HERE}
    runs = {x: [] for x in sides}
    for _ in range(args.rounds):
        for side in ["parent", "this", "this", "parent"]:
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--against",
                 args.against, "--reps", str(args.reps), "--root",
                 sides[side]], capture_output=True, text=True, cwd=HERE,
                timeout=900)
            line = [x for x in res.stdout.splitlines()
                    if x.startswith("RESULT ")]
            if res.returncode or not line:
                raise SystemExit(f"{side} run failed:\n{res.stdout}\n"
                                 f"{res.stderr}")
            runs[side].append(json.loads(line[0][7:]))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(f"card: {smi}")
    for label in runs["this"][0]:
        for side in sides:
            ms = [r[label]["ms"] for r in runs[side]]
            ops = runs[side][0][label]["ops"]
            print(f"[segsum turns] {label}, {side}: median "
                  f"{statistics.median(ms):.4f} ms (runs {min(ms):.4f}-"
                  f"{max(ms):.4f}), equal to plain "
                  f"{all(r[label]['equal'] for r in runs[side])}, "
                  f"{len(ops)} device operations a call (profiled us: "
                  + ", ".join(f"{n} {us:.1f}" for n, us in ops) + ")")
    os.remove(SHAPES)


if __name__ == "__main__":
    main()
