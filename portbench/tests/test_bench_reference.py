"""The plain reference against the port at a tiny size on the CPU: every
cell of BENCHMARK.json, through the harness's own set-up, loop and
comparison, comes out correct; and its pieces hold alone."""

import json
import os

import numpy as np
import pytest
import torch

from benchkit import ROOT, SEED, run_cpu, tiny_cell
from portbench import check
from portbench.harness import judge, result_line
from portbench.reference.intersect import Clusters, closest_hit

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_correct_on_the_cpu(name):
    cell = tiny_cell(name)
    run = run_cpu(cell)
    assert run["attempted"] >= 1 and len(run["kept"]) >= 1
    nums = judge(cell, SEED, run, torch.device("cpu"))
    assert set(nums) == set(cell.limits)
    out = result_line(cell, run, nums, False, "cpu", "")
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert {m["name"] for m in cell.end_to_end} == set(out["metrics"])


def test_gradients_agree_closely():
    cell = tiny_cell("sponza_fit")
    nums = judge(cell, SEED, run_cpu(cell), torch.device("cpu"))
    assert nums["kd_grad_err"] < 1e-5 and nums["v0_grad_err"] < 1e-4


def test_traced_run_reads_its_layers():
    cell = tiny_cell("sponza_fit")
    run = run_cpu(cell, trace=True)
    ctx = run["ctx"]
    assert ctx.traced_iters == cell.traffic["trace_iters"]
    probe = [c for c, _ in ctx.calls["traverse_probe"]]
    assert probe and ctx.calls["traverse"] == probe * ctx.traced_iters
    assert len(ctx.calls["segment_sum"]) % ctx.traced_iters == 0
    out = result_line(cell, run, judge(cell, SEED, run, torch.device("cpu")),
                      True, "cpu", "")
    assert "accel_build_s" in out["metrics"]
    assert out["attempted"] == ctx.traced_iters
    assert out["device"]["window_s"] > 0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_closest_hit_against_brute_force():
    rng = np.random.default_rng(0)
    v0 = rng.uniform(-1, 1, (300, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    cl = Clusters(v0, e1, e2, "cpu", torch.float64)
    o = torch.as_tensor(rng.uniform(-2, 2, (500, 3)))
    d = torch.as_tensor(rng.normal(size=(500, 3)))
    d = d / d.norm(dim=-1, keepdim=True)
    t, tri, _, _ = closest_hit(cl, o, d, 0.0, 1e12, pair_chunk=7)
    V0, E1, E2 = (torch.as_tensor(x, dtype=torch.float64)
                  for x in (v0, e1, e2))
    p = torch.linalg.cross(d[:, None], E2[None], dim=-1)
    det = (E1[None] * p).sum(-1)
    tv = o[:, None] - V0[None]
    u = (tv * p).sum(-1) / det
    q = torch.linalg.cross(tv, E1[None].expand_as(tv), dim=-1)
    v = (d[:, None] * q).sum(-1) / det
    tt = (E2[None] * q).sum(-1) / det
    ok = (u >= 0) & (v >= 0) & (u + v <= 1) & (tt >= 0)
    want = torch.where(ok, tt, torch.inf).min(1)
    hit = torch.isfinite(want.values)
    assert torch.equal(hit, torch.isfinite(t)) and hit.sum() > 50
    assert torch.allclose(t[hit], want.values[hit], rtol=1e-12, atol=0)
    assert torch.equal(tri[hit], want.indices[hit])
    assert (tri[~hit] == -1).all()


def test_triangle_match_finds_permuted_rows():
    cell = tiny_cell("photon_box_whitted")
    ref = check.Reference(cell.scenes.build_raw(cell.conf), cell.conf,
                          cell.traffic, SEED, "cpu")
    n = ref.scene.num_tris
    perm = np.random.default_rng(1).permutation(n)
    pad = 5
    prog = {k: np.concatenate([getattr(ref.scene, k + "_host")[perm],
                               np.zeros((pad, 3), np.float32)])
            for k in ("v0", "e1", "e2")}
    prog["valid"] = np.arange(n + pad) < n
    rows = check.triangle_match(prog, ref.scene)
    assert np.array_equal(prog["v0"][rows], ref.scene.v0_host)
    prog["v0"][perm.argsort()[0], 0] += 1.0
    assert check.triangle_match(prog, ref.scene) is None


def test_pixel_sample_is_drawn_from_the_seed():
    a = check.pixel_sample(64, 64, 100, 7)
    assert np.array_equal(a, check.pixel_sample(64, 64, 100, 7))
    assert not np.array_equal(a, check.pixel_sample(64, 64, 100, 8))
    assert len(set(a.tolist())) == 100
