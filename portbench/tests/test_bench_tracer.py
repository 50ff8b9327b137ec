"""The readers of the program's own spans and counters: their arithmetic
on a synthetic sink, the sink they open for the traced window, nothing
read from a port without a tracer, their entries in BENCHMARK.json, and
a traced tiny cell on the CPU that reports them."""

import json
import os
import types

import pytest
import torch

from benchkit import ROOT, SEED, run_cpu, tiny_cell
from portbench.harness import Cell, Context, judge, result_line
from portbench.metrics import (host_ms_per_level, host_syncs_per_iter,
                               scene_build_s, sync_wait_ms_per_iter,
                               traverse_live_share)

NEW = {"host_syncs_per_iter": ("syncs/iter", "program_counter",
                               "integrator", "samples_per_s"),
       "sync_wait_ms_per_iter": ("ms/iter", "program_span", "integrator",
                                 "samples_per_s"),
       "host_ms_per_level": ("ms/level", "program_span", "integrator",
                             "samples_per_s"),
       "traverse_live_share": ("%", "program_counter", "kernels: traversal",
                               "samples_per_s"),
       "scene_build_s": ("s", "program_span", "scene build", "setup_s")}
READERS = (host_syncs_per_iter, sync_wait_ms_per_iter, host_ms_per_level,
           traverse_live_share)


def span(name, start_ns, end_ns):
    return types.SimpleNamespace(name=name, start_ns=start_ns, end_ns=end_ns)


def synthetic_ctx(traced_iters=2):
    ctx = Context()
    ctx.traced_iters = traced_iters
    ctx.calls["sink"] = types.SimpleNamespace(
        spans=[span("integrate.level", 0, 4_000_000),
               span("sync.lane_order.heads", 100, 500_100),
               span("integrate.level", 5_000_000, 7_000_000),
               span("sync.ray_bounds", 0, 250_000),
               span("render.frame", 0, 9_000_000)],
        counts={"sync.lane_order.heads": 3, "sync.ray_bounds": 5,
                "bvh.lanes": 400, "launch.wide.closest": 2},
        records={"render_stats": [(torch.tensor(100), torch.tensor(20),
                                   torch.tensor(80)),
                                  (50, 0, 50)],
                 "segment_sum": [(10, 3, 1)]})
    return ctx


def test_readers_on_a_synthetic_sink():
    ctx = synthetic_ctx()
    assert host_syncs_per_iter.read(ctx) == 4.0
    assert sync_wait_ms_per_iter.read(ctx) == pytest.approx(0.375)
    assert host_ms_per_level.read(ctx) == pytest.approx(3.0)
    assert traverse_live_share.read(ctx) == pytest.approx(75.0)


def test_readers_read_nothing_without_a_window_or_a_sink():
    ctx = synthetic_ctx(traced_iters=0)
    assert all(r.read(ctx) is None for r in READERS)
    ctx = Context()
    ctx.traced_iters = 3
    assert all(r.read(ctx) is None for r in READERS)
    ctx = synthetic_ctx()
    ctx.calls["sink"].counts.pop("bvh.lanes")
    ctx.calls["sink"].spans = []
    assert traverse_live_share.read(ctx) is None
    assert host_ms_per_level.read(ctx) is None
    assert sync_wait_ms_per_iter.read(ctx) == 0.0


def test_one_sink_for_the_window_dropping_the_probe():
    from cse168_raytracer_tpu_torch.utils import profiling
    ctx = Context()
    for r in READERS:
        r.install(ctx)
    sink = ctx.calls["sink"]
    assert profiling.SINK is sink
    ctx.probing = True
    profiling.count("sync.test_probe")
    ctx.probing = False
    profiling.count("sync.test_probe", 2)
    with profiling.span("integrate.level"):
        pass
    ctx.undo()
    assert profiling.SINK is None
    profiling.count("sync.test_probe")
    assert sink.counts == {"sync.test_probe": 2}
    assert [s.name for s in sink.spans] == ["integrate.level"]


def test_a_port_without_a_tracer_gives_nothing(monkeypatch):
    """A checkout whose port predates the tracer (no Sink; spans(), the
    phases' totals, empty since nothing opens a phase): install opens
    nothing and every reader reads None, raising nothing."""
    from cse168_raytracer_tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "Sink")
    monkeypatch.setattr(profiling, "spans", dict)
    ctx = Context()
    for r in READERS:
        r.install(ctx)
    ctx.traced_iters = 2
    assert "sink" not in ctx.calls and profiling.SINK is None
    assert all(r.read(ctx) is None for r in READERS)
    assert scene_build_s.read(ctx) is None


def test_scene_build_s_reads_the_phase():
    from cse168_raytracer_tpu_torch.utils import profiling
    profiling.reset()
    assert scene_build_s.read(Context()) is None
    with profiling.phase("scene.build", log=False):
        pass
    assert scene_build_s.read(Context()) >= 0.0


def test_manifest_has_the_new_entries_last():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = [w["name"] for w in manifest["workloads"]]
    tail = manifest["per_layer"][-len(NEW):]
    assert [m["name"] for m in tail] == list(NEW)
    for m in tail:
        unit, source, layer, moves = NEW[m["name"]]
        assert (m["unit"], m["source"], m["layer"], m["moves"]) == (
            unit, source, layer, moves)
        assert m["workloads"] == cells
    for name in cells:
        assert set(NEW) <= {m["name"] for m in Cell(name).per_layer}


def test_traced_tiny_cell_reports_the_programs_metrics():
    """On the CPU no traversal kernel launches, so traverse_live_share
    reads nothing there; the others read the program."""
    cell = tiny_cell("photon_box_whitted")
    run = run_cpu(cell, trace=True)
    out = result_line(cell, run, judge(cell, SEED, run, torch.device("cpu")),
                      True, "cpu", "")
    got = out["metrics"]
    for name in ("host_ms_per_level", "sync_wait_ms_per_iter",
                 "host_syncs_per_iter", "scene_build_s"):
        assert name in got, name
    assert got["host_syncs_per_iter"]["value"] == 0.0   # none on the CPU
    assert got["host_ms_per_level"]["value"] > 0
    assert "traverse_live_share" not in got
    assert run["ctx"].calls["sink"].records["render_stats"]
