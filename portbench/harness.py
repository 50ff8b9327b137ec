"""Run one cell of the port's benchmark once.

A cell (BENCHMARK.json's `workloads`) names a configuration and a
traffic mix; everything is found by name under the benchmark's folder:
  configs/<config>.json   the configuration's sizes, as run
  configs/<config>.py     build_port(conf, device) -> the port's scene,
                          build_raw(conf) -> the raw scene of the
                          reference
  traffic/<traffic>.json  the traffic's parameters, among them
                          "iteration", the kind of timed iteration
  iterations/<kind>.py    the kind's set-up, loop and reference
                          (iterations/__init__.py)
  limits/<cell>.json      the limit of each number compared
  compare/<number>.py     one module a number compared
                          (compare/__init__.py)
  metrics/<metric>.py     one reader a metric (metrics/__init__.py)

A run: set-up (the port's imports, the kind's set-up: for "render" the
scene and attach_accel timed as accel_build_s, the loop's tables; then
warm-up iterations); then either the measured window (--trace 0:
iterations until --seconds have passed, each ended by a synchronize)
or the traced window (--trace 1: the traffic's trace_iters under
torch.profiler, with the per-layer readers' wrappers installed, the
device's activity alone, then one iteration with the host's too, for
the breakdown of idle gaps); then the peak device memory, the
program's state freed, the check against the reference on the kept
iterations' outputs, and one JSON line. The reference and the check
run after the window and count in no metric.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

FORBIDDEN = ("jax", "jaxlib", "flax", "cse168_raytracer_tpu")
BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


class Context:
    """What the metric readers read (metrics/__init__.py)."""

    def __init__(self):
        self.setup_s = None
        self.spans = {}
        self.iter_s = []
        self.window_s = 0.0
        self.samples_per_iter = 0
        self.trace = None
        self.traced_iters = 0
        self.calls = {}
        self.n_tris = 0
        self.gaps = []
        self.probing = False
        self._undo = []

    def patch(self, obj, name, value):
        """setattr(obj, name, value) until undo()."""
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


def _module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    with open(path) as f:
        return json.load(f)


class Cell:
    """One workload of the manifest with everything it names, resolved
    by name under `root` (a checkout: BENCHMARK.json and the benchmark's
    folder)."""

    def __init__(self, workload: str, root: str = ROOT):
        manifest = _json(os.path.join(root, "BENCHMARK.json"))
        bench = os.path.join(root, manifest["paths"][0])
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r}; have {sorted(cells)}")
        self.name = workload
        self.entry = cells[workload]
        self.chips = int(self.entry["chips"])
        config = {c["name"]: c for c in manifest["configs"]}[
            self.entry["config"]]
        conf_path = os.path.join(root, config["file"])
        self.conf = _json(conf_path)
        self.scenes = _module(os.path.splitext(conf_path)[0] + ".py",
                               "portbench_config_" + config["name"])
        self.traffic = _json(os.path.join(bench, "traffic",
                                          self.entry["traffic"] + ".json"))
        kind = self.traffic["iteration"]
        self.iteration = _module(os.path.join(bench, "iterations",
                                              kind + ".py"),
                                 "portbench_iteration_" + kind)
        self.limits = _json(os.path.join(bench, "limits",
                                         workload + ".json"))
        self.compare = {
            n: _module(os.path.join(bench, "compare", n + ".py"),
                       "portbench_compare_" + n.replace(".", "_"))
            for n in self.limits}

        def mine(m):
            return workload in m.get("workloads", [workload])
        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        e2e = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in manifest["per_layer"]
                          if (workload in m["workloads"] if "workloads" in m
                              else m["moves"] in e2e)]
        self.readers = {
            m["name"]: _module(os.path.join(bench, "metrics",
                                            m["name"] + ".py"),
                               "portbench_metric_" + m["name"].replace(
                                   ".", "_"))
            for m in self.end_to_end + self.per_layer}


def jax_loaded() -> list:
    """The forbidden top-level modules in sys.modules (whole names)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def power_limit() -> str:
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return res.stdout.strip().splitlines()[0] if res.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def port_scene(cell: Cell, ctx: Context, device, sync):
    """The configuration's scene in the port with the traffic's
    accelerator ("accel", "auto" if not given), attach_accel timed as
    accel_build_s: (Scene, SceneStatic, Camera, RenderConfig)."""
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    scene, static, cam, cfg = cell.scenes.build_port(cell.conf, device)
    ts = time.perf_counter()
    scene = attach_accel(scene, cell.traffic.get("accel", "auto"))
    sync()
    ctx.spans["accel_build_s"] = time.perf_counter() - ts
    ctx.n_tris = int(scene.tris.n_valid)
    return scene, static, cam, cfg


def setup(cell: Cell, seed: int, device, sync):
    """The cell's iteration kind set up from the seed and warmed up:
    (Context, loop)."""
    ctx = Context()
    loop = cell.iteration.setup(cell, ctx, seed, device, sync)
    ctx.samples_per_iter = loop.samples_per_iter
    for k in range(int(cell.traffic.get("warmup_iters", 1))):
        loop(-1 - k)
        sync()
    return ctx, loop


def window(ctx: Context, loop, seconds: float, seed: int, sync,
           min_iters: int = 1) -> dict:
    """The measured window: iterations, each ended by `sync`, until
    `seconds` have passed and `min_iters` have run. Keeps the first
    iteration's outputs, one drawn from the seed and the last; returns
    them by iteration."""
    import numpy as np
    pick = 1 + int(np.random.default_rng(seed).integers(0, 31))
    kept, last, i = {}, None, 0
    w0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        out = loop(i)
        sync()
        b = time.perf_counter()
        ctx.iter_s.append(b - a)
        if i in (0, pick):
            kept[i] = out
        last = out
        i += 1
        if b - w0 >= seconds and i >= min_iters:
            break
    ctx.window_s = b - w0
    kept[last["i"]] = last
    return kept


def traced(ctx: Context, loop, cell: Cell, sync) -> dict:
    """The traced window: one probe iteration with the readers' wrappers
    installed and ctx.probing set (a wrapper may then read what costs a
    synchronize), then the traffic's trace_iters under torch.profiler
    with the device's activity alone (the host's operators are not
    recorded, so the window runs near its untraced pace), then one
    iteration with the host's operators too, whose trace names the
    device's idle gaps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from portbench import trace as tr
    n = int(cell.traffic.get("trace_iters", 3))
    kept = {}
    on_card = [ProfilerActivity.CUDA] if torch.cuda.is_available() \
        else [ProfilerActivity.CPU]
    for r in cell.readers.values():
        if hasattr(r, "install"):
            r.install(ctx)
    try:
        ctx.probing = True
        loop(n)
        sync()
        ctx.probing = False
        with profile(activities=on_card) as prof:
            sync()
            w0 = time.perf_counter()
            for i in range(n):
                out = loop(i)
                sync()
                if i in (0, n - 1):
                    kept[i] = out
            wall = time.perf_counter() - w0
    finally:
        ctx.probing = False
        ctx.undo()
    ctx.trace = tr.from_profiler(prof, wall_us=wall * 1e6)
    ctx.traced_iters = n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(tr.WINDOW):
            loop(n + 1)
            sync()
    ctx.gaps = tr.from_profiler(prof).idle_gaps()
    return kept


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t0: float, sync=None, min_iters: int = 1) -> dict:
    """Set-up, the window and the program's outputs of one run: a dict
    with the Context, the kept iterations' outputs, the iterations
    attempted, the peak memory and the port's triangle rows. `sync`
    ends an iteration (the card's synchronize by default)."""
    import torch
    if sync is None:
        sync = torch.cuda.synchronize
    ctx, loop = setup(cell, seed, device, sync)
    ctx.setup_s = time.perf_counter() - t0
    if trace:
        kept = traced(ctx, loop, cell, sync)
        attempted = ctx.traced_iters
    else:
        kept = window(ctx, loop, seconds, seed, sync, min_iters)
        attempted = len(ctx.iter_s)
    return finish(cell, ctx, loop, kept, attempted, device)


def finish(cell: Cell, ctx: Context, loop, kept: dict, attempted: int,
           device) -> dict:
    """The run's record once its window has closed: the peak device
    memory read, what the check needs of the program's state kept
    (loop.finish()), and the rest of that state freed."""
    import torch
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    state = loop.finish()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(ctx=ctx, kept=[kept[k] for k in sorted(kept)],
                attempted=attempted, peak=peak, state=state)


def judge(cell: Cell, seed: int, run: dict, device, reference=None,
          low=None) -> dict:
    """The compared numbers of a run's kept iterations (compare/), the
    worst over them. `low`, the kind's reference in a lower precision,
    stands in the program's place: the control."""
    import torch
    from portbench.check import worst
    if reference is None:
        reference = cell.iteration.reference(cell, seed, device)
    readings = []
    for prog in run["kept"]:
        want = reference.outputs(prog)
        got = (low.outputs(prog) if low is not None
               else reference.view(prog, run["state"]))
        readings.append({n: float(m.read(got, want))
                         for n, m in cell.compare.items()})
        del want, got
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return worst(readings)


def result_line(cell: Cell, run: dict, numbers: dict, trace: bool,
                device_name: str, power: str) -> dict:
    ctx = run["ctx"]
    limits = cell.limits
    failed = sorted(k for k, v in numbers.items()
                    if not v <= limits.get(k, float("-inf")))
    missing = sorted(set(limits) - set(numbers))
    correct = not failed and not missing
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.readers[m["name"]].read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": cell.chips,
              "memory_peak_bytes": int(run["peak"])}
    out = {"correct": bool(correct), "attempted": int(run["attempted"]),
           "failed": int(0 if correct else len(run["kept"])),
           "metrics": metrics, "device": device}
    if trace and ctx.trace is not None:
        device["busy_s"] = ctx.trace.busy_us() / 1e6
        device["window_s"] = ctx.trace.window_us / 1e6
        out["breakdown"] = {"device_ops": ctx.trace.top_ops(),
                            "idle_gaps": ctx.gaps}
    out["power_limit"] = power
    out["checks"] = {k: {"value": numbers.get(k), "limit": lim}
                     for k, lim in sorted(limits.items())}
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t0: float) -> int:
    args = parse(argv)
    if args.seed < 0:
        print("the seed must be a non-negative integer", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    run = measure(cell, args.seed, args.seconds, bool(args.trace), device,
                  t0)
    found = jax_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    ctx = run["ctx"]
    device_name = torch.cuda.get_device_name(0)
    power = power_limit()
    print(f"[{cell.name}] seed {args.seed}; {device_name}, {power}; set-up "
          f"{ctx.setup_s:.3f} s (accel {ctx.spans['accel_build_s']:.3f} s); "
          f"{run['attempted']} iterations"
          + (f" in {ctx.window_s:.3f} s" if not args.trace else " traced")
          + f"; peak {run['peak']} bytes", file=sys.stderr)
    if ctx.iter_s:
        q = sorted(ctx.iter_s)
        at = lambda f: 1e3 * q[min(len(q) - 1, int(f * len(q)))]
        print(f"[{cell.name}] iteration ms: min {1e3 * q[0]:.3f}, quartiles "
              f"{at(0.25):.3f} / {at(0.5):.3f} / {at(0.75):.3f}, max "
              f"{1e3 * q[-1]:.3f}; first {1e3 * ctx.iter_s[0]:.3f}",
              file=sys.stderr)
    tj = time.perf_counter()
    numbers = judge(cell, args.seed, run, device)
    print(f"[{cell.name}] reference and check {time.perf_counter() - tj:.3f} s"
          f" over {len(run['kept'])} kept iterations", file=sys.stderr)
    found = jax_loaded()
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    out = result_line(cell, run, numbers, bool(args.trace), device_name,
                      power)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0
