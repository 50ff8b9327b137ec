"""New cells, configurations, traffic mixes, kinds of iteration, numbers
compared and metrics come in as new files and manifest entries alone: a
copy of the benchmark in a temporary folder gains them, and the harness
finds and runs them with no file of the copy edited but BENCHMARK.json."""

import json
import os
import shutil
import subprocess
import sys

import torch

from benchkit import ROOT, SEED, run_cpu, tiny_cell
from portbench.harness import Cell, Context, judge, result_line

# a kind of iteration that no traffic had: a light meter, each iteration
# a frame's mean radiance per channel, with its own reference
METER = """
import torch
from portbench.iterations import render


class Meter(render.Loop):
    def __call__(self, i):
        out = super().__call__(i)
        out["mean"] = out.pop("hdr").mean((0, 1))
        return out


def setup(cell, ctx, seed, device, sync):
    from portbench.harness import port_scene
    scene, static, cam, cfg = port_scene(cell, ctx, device, sync)
    return Meter(cell.traffic, cell.conf, scene, static, cam, cfg, seed,
                 device)


class Reference:
    def __init__(self, cell, seed, device, dtype):
        self.frames = render.reference(cell, seed, device, dtype)

    def outputs(self, kept):
        return {"mean": self.frames.outputs(kept)["hdr"].mean((0, 1))}

    def view(self, kept, state):
        return {"mean": kept["mean"].float()}


def reference(cell, seed, device, dtype=torch.float32):
    return Reference(cell, seed, device, dtype)
"""

MEAN_REL_ERR = """
def read(got, want):
    g, r = got.get("mean"), want["mean"]
    if g is None or g.shape != r.shape:
        return float("inf")
    return float(((g - r).abs() / r.abs().clamp(min=1e-12)).max())
"""


def copy_of_bench(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    return {p: (tmp_path / p).read_bytes()
            for p in (str(f.relative_to(tmp_path))
                      for f in (tmp_path / "portbench").rglob("*")
                      if f.is_file())}


def test_new_cell_from_new_files(tmp_path):
    before = copy_of_bench(tmp_path)
    bench = tmp_path / "portbench"
    conf = json.loads((bench / "configs" / "photon_box.json").read_text())
    conf["name"] = "photon_box_dim"
    conf["lights"][0]["wattage"] = 25.0
    (bench / "configs" / "photon_box_dim.json").write_text(json.dumps(conf))
    shutil.copy(bench / "configs" / "photon_box.py",
                bench / "configs" / "photon_box_dim.py")
    # data alone: another accelerator, one warm-up
    traffic = json.loads((bench / "traffic" / "frames_whitted.json")
                         .read_text())
    traffic.update(accel="pallas_sah", warmup_iters=1)
    (bench / "traffic" / "frames_binary.json").write_text(json.dumps(traffic))
    (bench / "limits" / "dim_box.json").write_text('{"pixels_off": 0.01}')
    # new code: a kind of iteration, its reference and its number
    (bench / "iterations" / "meter.py").write_text(METER)
    (bench / "compare" / "mean_rel_err.py").write_text(MEAN_REL_ERR)
    traffic.update(iteration="meter", accel="auto")
    (bench / "traffic" / "meter_frames.json").write_text(json.dumps(traffic))
    (bench / "limits" / "box_meter.json").write_text('{"mean_rel_err": 1e-4}')
    (bench / "metrics" / "frames_per_s.py").write_text(
        "def read(ctx):\n"
        "    return len(ctx.iter_s) / ctx.window_s if ctx.iter_s else None\n")
    m = json.loads((tmp_path / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "photon_box_dim", "source": "the same",
                         "file": "portbench/configs/photon_box_dim.json",
                         "reduced": [], "why": "half the light"})
    m["workloads"] += [
        {"name": "dim_box", "config": "photon_box_dim",
         "traffic": "frames_binary", "chips": 1, "why": "a test cell"},
        {"name": "box_meter", "config": "photon_box",
         "traffic": "meter_frames", "chips": 1, "why": "a test cell"}]
    m["end_to_end"].append({"name": "frames_per_s", "unit": "frames/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["dim_box", "box_meter"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))

    cell = tiny_cell("dim_box", root=str(tmp_path))
    assert cell.conf["lights"][0]["wattage"] == 25.0
    assert "frames_per_s" in cell.readers
    assert {"kernels_per_iter", "device_idle_pct"} <= {
        x["name"] for x in cell.per_layer}
    from cse168_raytracer_tpu_torch.ops.binary_bvh import BinaryBVH
    loop = cell.iteration.setup(cell, Context(), SEED, torch.device("cpu"),
                                lambda: None)
    assert isinstance(loop.scene.accel, BinaryBVH)
    loop.finish()
    for name in ("dim_box", "box_meter"):
        cell = tiny_cell(name, root=str(tmp_path))
        run = run_cpu(cell)
        nums = judge(cell, SEED, run, torch.device("cpu"))
        assert set(nums) == set(cell.limits)
        out = result_line(cell, run, nums, False, "cpu", "")
        assert out["correct"], (name, out["checks"])
        assert out["metrics"]["frames_per_s"]["value"] > 0
    assert run["kept"][0]["mean"].shape == (3,)
    # the meter's number fails a frame that is 1% too bright
    low = cell.iteration.reference(cell, SEED, torch.device("cpu"))
    want = low.outputs(run["kept"][0])
    assert cell.compare["mean_rel_err"].read(
        {"mean": want["mean"] * 1.01}, want) > 1e-4
    for p, data in before.items():
        assert (tmp_path / p).read_bytes() == data, p
    # the cells that were there resolve as before
    assert Cell("sponza_fit", str(tmp_path)).traffic == \
        Cell("sponza_fit").traffic


def run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sponza_fit",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_no_result():
    out = run_py(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_without_the_port_no_result(tmp_path):
    copy_of_bench(tmp_path)
    out = run_py(str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
