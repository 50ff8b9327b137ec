"""The photon-mapped cell (photon_box_render) at a tiny size on the CPU:
32 x 32 pixels, the glass sphere at 8 rings, 4,000 photons a map and
k = 50 (set here: benchkit.tiny_cell leaves the photon counts as the
configuration has them). The port against the plain reference, the
check against five injected faults, the cell's files found by name,
its two metric readers, and the reference's pieces against the port's
on the same photons."""

import dataclasses
import json
import os
import shutil
import types

import numpy as np
import pytest
import torch

from benchkit import ROOT, SEED, run_cpu, tiny_cell
from portbench.harness import Cell, Context, judge, result_line
from portbench.metrics import photon_gather_roofline, photon_map_build_s
from portbench.reference import photon as rp

CELL = "photon_box_render"
K = 50


def small_cell(root=ROOT):
    cell = tiny_cell(CELL, root=root, size=32)
    cell.conf["photons"].update(photons_per_light=4000,
                                caustic_photons_per_light=4000,
                                photon_samples=K)
    return cell


def verdict(cell, run, **kw):
    nums = judge(cell, SEED, run, torch.device("cpu"), **kw)
    return result_line(cell, run, nums, False, "cpu", "")


@pytest.fixture(scope="module")
def run():
    return run_cpu(small_cell())


def test_port_against_the_reference(run):
    cell = small_cell()
    out = verdict(cell, run)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"map_power_err", "estimate_pixels_off",
                                  "photon_set_off"}
    assert out["checks"]["map_power_err"]["value"] < 1e-6
    assert out["checks"]["estimate_pixels_off"]["value"] == 0.0
    assert out["checks"]["photon_set_off"]["value"] < 0.005
    state = run["state"]
    assert state["map_stored"].tolist() == [4000, 4000]
    assert (state["map_power"] > 0).all()
    # the photons the check read are the maps' own
    build = run["kept"][0]["build"]
    assert all(build["photons"][m][0].shape == (4000, 3) for m in rp.MAPS)


def inject(monkeypatch, fault):
    """Break the port at run time with `fault`."""
    from cse168_raytracer_tpu_torch.ops import photon as ph
    from cse168_raytracer_tpu_torch.render import integrator
    real_build, real_render = ph.build_photon_maps, integrator.render_hdr
    real_trace = ph.draw_trace_photon_batch
    if fault in ("pos_back", "dir_flipped"):
        # the tracer stores each photon a tenth of a unit back along its
        # ray, or with its direction turned: the grids are built from the
        # same wrong photons and the power is unchanged
        def trace(*a, **k):
            out = real_trace(*a, **k)
            if fault == "pos_back":
                return dataclasses.replace(out, pos=out.pos - 0.1 * out.dir)
            return dataclasses.replace(out, dir=-out.dir)
        monkeypatch.setattr(ph, "draw_trace_photon_batch", trace)
    elif fault == "no_caustic":
        monkeypatch.setattr(ph, "build_photon_maps", lambda *a, **k:
                            real_build(*a, **k).replace(caustic_map=None))
    elif fault == "k_low":
        # k = 40 for 50, as 400 for 500 at full size
        def low(g):
            return g.replace(knn=40, coarse=g.coarse.replace(knn=40))

        def build(*a, **k):
            m = real_build(*a, **k)
            return m.replace(global_map=low(m.global_map),
                             caustic_map=low(m.caustic_map))
        monkeypatch.setattr(ph, "build_photon_maps", build)
    elif fault == "pixels16":
        def render(*a, **k):
            hdr, stats = real_render(*a, **k)
            flat = hdr.sum(-1).reshape(-1)
            bump = torch.ones_like(flat)
            bump[flat.topk(16).indices] = 1.05
            return hdr * bump.reshape(hdr.shape[:2])[..., None], stats
        monkeypatch.setattr(integrator, "render_hdr", render)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("fault", ["no_caustic", "k_low", "pixels16",
                                   "pos_back", "dir_flipped"])
def test_each_injected_fault_exceeds_a_limit(monkeypatch, fault):
    cell = small_cell()
    inject(monkeypatch, fault)
    run = run_cpu(cell)
    monkeypatch.undo()
    out = verdict(cell, run)
    assert not out["correct"], (fault, out["checks"])
    checks = out["checks"]
    if fault == "no_caustic":
        assert checks["map_power_err"]["value"] == 1.0
    if fault in ("pos_back", "dir_flipped"):
        # only the photon sets see it
        assert checks["photon_set_off"]["value"] > 0.9
        assert checks["map_power_err"]["value"] <= \
            checks["map_power_err"]["limit"]


def test_control_in_bfloat16_fails_both_numbers(run):
    cell = small_cell()
    low = cell.iteration.reference(cell, SEED, torch.device("cpu"),
                                   torch.bfloat16)
    out = verdict(cell, run, low=low)
    assert all(c["value"] > c["limit"] for c in out["checks"].values()), \
        out["checks"]


def test_cell_resolves_from_new_files_and_the_manifest(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    cell = Cell(CELL, str(tmp_path))
    bench = tmp_path / "portbench"
    assert cell.entry["chips"] == 1
    assert cell.traffic["iteration"] == "photon"
    assert (bench / "configs" / "photon_box_maps.json").exists()
    assert cell.conf["reduced"] == [] and cell.conf["photons"][
        "photons_per_light"] == 200000
    assert set(cell.compare) == {"map_power_err", "estimate_pixels_off",
                                 "photon_set_off"}
    assert {"samples_per_s", "setup_s"} == {m["name"]
                                            for m in cell.end_to_end}
    assert {m["name"] for m in cell.per_layer} == {
        "accel_build_s", "kernels_per_iter", "traverse_roofline",
        "device_idle_pct", "host_syncs_per_iter", "sync_wait_ms_per_iter",
        "host_ms_per_level", "traverse_live_share", "scene_build_s",
        "photon_map_build_s", "photon_gather_roofline"}
    with open(tmp_path / "BENCHMARK.json") as f:
        manifest = json.load(f)
    new = [m for m in manifest["per_layer"]
           if m["name"].startswith("photon_")]
    assert [m["name"] for m in manifest["per_layer"][-2:]] == [
        "photon_map_build_s", "photon_gather_roofline"]
    assert all(m["workloads"] == [CELL] for m in new)
    # the configuration's port scene carries the map sizes
    scene, static, cam, cfg = cell.scenes.build_port(cell.conf, "cpu")
    assert (cfg.photons_per_light, cfg.caustic_photons_per_light,
            cfg.photon_samples, cfg.trace_depth_photons,
            cfg.photon_grid_max_per_cell, cfg.photon_max_batches) == (
        200000, 200000, 500, 5, 32, 1200)
    # and photon_box's meshes, imported
    box = Cell("photon_box_whitted", str(tmp_path))
    assert len(cell.scenes.build_raw(cell.conf)["meshes"]) == len(
        box.scenes.build_raw(box.conf)["meshes"])


def test_readers_on_a_traced_cpu_run():
    cell = small_cell()
    run = run_cpu(cell, trace=True)
    ctx = run["ctx"]
    recs = ctx.calls["sink"].records["photon_gather"]
    assert recs and all(r["points"] > 0 and "events" not in r for r in recs)
    assert all(r["p"].shape == (r["points"], 3) for r in recs)
    out = result_line(cell, run, judge(cell, SEED, run, torch.device("cpu")),
                      True, "cpu", "")
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["photon_map_build_s"]["value"] > 0
    assert got["host_ms_per_level"]["value"] > 0
    assert "photon_gather_roofline" not in got       # no events off the card
    assert photon_gather_roofline.read(Context()) is None


def coarse_grid():
    """A floor map whose sparse corner needs the coarse level, and points
    over the floor and the corner."""
    from cse168_raytracer_tpu_torch.ops import photon as ph
    rng = np.random.default_rng(1)
    n = 4000
    pos = np.stack([rng.uniform(-2, 2, n), np.zeros(n),
                    rng.uniform(-3, 1, n)], 1).astype(np.float32)
    pos[:40, 0] = rng.uniform(6, 7, 40).astype(np.float32)
    power = rng.uniform(0, 1e-3, (n, 3)).astype(np.float32)
    dirs = np.tile(np.float32([[0, -1, 0]]), (n, 1))
    grid = ph.build_grid(pos, power, dirs, 0.2, max_per_cell=16, knn=30,
                         coarse_factor=8.0, device="cpu")
    g = torch.Generator().manual_seed(2)
    p = torch.stack([torch.rand(300, generator=g) * 9 - 2,
                     torch.zeros(300), torch.rand(300, generator=g) * 4 - 3],
                    1)
    return grid, p


def test_least_photons_are_the_ports_candidates_within_radius():
    """The reader's own count of the photons a gather must read equals
    the port's candidates within each level's radius: every point's
    fine level, and the coarse level where the fine one weighs less than
    k."""
    from cse168_raytracer_tpu_torch.ops import photon as ph
    grid, p = coarse_grid()
    nrm = torch.tensor([0.0, 1.0, 0.0]).expand(p.shape[0], 3)
    _, _, in_r, _ = ph._in_range(grid, p, nrm)
    _, cnt, _ = ph._gather_level(grid, p, nrm, grid.power)
    _, _, in_c, _ = ph._in_range(grid.coarse, p, nrm)
    need = cnt < grid.knn
    assert 0 < int(need.sum()) < p.shape[0]
    want = int(in_r.sum()) + int(in_c[need].sum())
    assert photon_gather_roofline.least_photons(p, grid) == want
    count, wsum = photon_gather_roofline.within(p, grid.pos, grid.weight,
                                                float(grid.radius))
    assert torch.equal(count, in_r.sum(1))
    assert torch.allclose(wsum, cnt)


def test_gather_roofline_arithmetic():
    class Event:
        def __init__(self, ms):
            self.ms = ms

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return end.ms - self.ms
    grid, p = coarse_grid()
    ctx = Context()
    ctx.traced_iters = 1
    rec = dict(points=p.shape[0], p=p, grid=grid,
               events=(Event(1.0), Event(3.0)))
    ctx.calls["sink"] = types.SimpleNamespace(records={"photon_gather": [rec]})
    least = photon_gather_roofline.least_photons(p, grid)
    want = 100 * (300 * 36 + least * 40) / 3.35e12 / 2e-3
    assert photon_gather_roofline.read(ctx) == pytest.approx(want)
    assert photon_gather_roofline.gather_bytes(1000, 5007) == \
        1000 * 36 + 5007 * 40
    rec.pop("events")
    assert photon_gather_roofline.read(ctx) is None
    ctx.calls["sink"].records = {"photon_gather": [dict(points=3)]}
    assert photon_gather_roofline.read(ctx) is None   # a record of old
    ctx.calls["sink"].records = {}
    assert photon_gather_roofline.read(ctx) is None


def test_map_build_reader_reads_the_phase():
    from cse168_raytracer_tpu_torch.utils import profiling
    profiling.reset()
    assert photon_map_build_s.read(Context()) is None
    with profiling.phase("photons.build", log=False):
        pass
    assert photon_map_build_s.read(Context()) >= 0.0


def test_reference_grid_and_radius_equal_the_ports_on_one_cloud():
    """The reference's radius, hash and fold over photons strewn on a
    floor and a wall give the port's grid entry for entry."""
    from cse168_raytracer_tpu_torch.ops import photon as ph
    rng = np.random.default_rng(3)
    n = 6000
    pos = np.concatenate([
        np.stack([rng.uniform(0, 5, n // 2), np.zeros(n // 2),
                  rng.uniform(-5, 1, n // 2)], 1),
        np.stack([rng.uniform(0, 5, n // 2), rng.uniform(0, 5, n // 2),
                  np.full(n // 2, -5.0)], 1)]).astype(np.float32)
    power = rng.uniform(0, 1e-4, (n, 3)).astype(np.float32)
    dirs = np.tile(np.float32([[0, -1, 0]]), (n, 1))
    radius = ph._auto_radius(pos, K, 16)
    assert rp.gather_radius(pos, K) == radius
    for factor in (1.0, 8.0):
        grid = ph.build_grid(pos, power, dirs, radius * factor, 16, knn=K,
                             coarse_factor=None, device="cpu")
        level = rp.Level(pos, dirs, power, radius * factor, 16, "cpu",
                         torch.float32)
        w = grid.weight > 0
        a = torch.cat([grid.pos[w], grid.power[w], grid.weight[w, None]], 1)
        b = torch.cat([level.pos, level.power, level.weight[:, None]], 1)
        assert sorted(map(tuple, a.tolist())) == sorted(map(tuple, b.tolist()))


def test_reference_tracing_replays_the_ports_photons():
    """One batch of each map's photons, traced by the port and replayed
    by the reference from the same generator state: the generators end
    in the same state, and the photons are the same bit for bit but for
    the few whose paths met a quad's diagonal, where the two triangles
    both take a ray within EPSILON and each tracer may pick either."""
    from cse168_raytracer_tpu_torch.ops import photon as ph
    from portbench.harness import port_scene
    from portbench.reference import scene as ref_scene
    from portbench.reference.intersect import Clusters
    cell = small_cell()
    scene, static, cam, cfg = port_scene(cell, Context(), torch.device("cpu"),
                                         lambda: None)
    raw = cell.scenes.build_raw(cell.conf)
    rs = ref_scene.build(raw, "cpu")
    tracer = rp.Tracer(raw, rs, Clusters(rs.v0_host, rs.e1_host, rs.e2_host,
                                         "cpu"), "cpu")
    for caustic in (False, True):
        g1 = torch.Generator().manual_seed(11)
        g2 = torch.Generator().manual_seed(11)
        out = ph.draw_trace_photon_batch(scene, static, 0, 4000, caustic,
                                         cfg.trace_depth_photons, False, g1)
        m = out.mask.reshape(-1)
        want = torch.cat([getattr(out, f).reshape(-1, 3)[m]
                          for f in ("pos", "dir", "power")], 1)
        got = torch.cat(tracer.batch(tracer.lights[0], caustic,
                                     cfg.trace_depth_photons, 4000, g2), 1)
        assert torch.equal(g1.get_state(), g2.get_state())
        assert want.shape[0] > 1000
        assert abs(got.shape[0] - want.shape[0]) <= 0.005 * want.shape[0]
        a = set(map(tuple, want.tolist()))
        b = set(map(tuple, got.tolist()))
        assert len(a & b) >= 0.99 * len(a)
