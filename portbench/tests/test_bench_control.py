"""The comparison fails what it must: the control (the reference computed
in bfloat16, the precision below the configurations' float32, put in
the program's place), and a run of every cell with its timed path
broken underneath, once for each fault the cell can have: an iteration
that returns the state of an earlier one unchanged, half of the image
left out (so the loss is taken over the rest), an answer altered where
it is produced. The cells run on one card, so none has an exchange
between chips to leave out."""

import json
import os

import pytest
import torch

from benchkit import ROOT, SEED, run_cpu, tiny_cell
from portbench.harness import judge, result_line

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    CELLS = [w["name"] for w in json.load(f)["workloads"]]


def verdict(cell, run, **kw):
    nums = judge(cell, SEED, run, torch.device("cpu"), **kw)
    return result_line(cell, run, nums, False, "cpu", "")


@pytest.mark.parametrize("name", CELLS)
def test_control_in_bfloat16_is_not_correct(name):
    cell = tiny_cell(name)
    low = cell.iteration.reference(cell, SEED, torch.device("cpu"),
                                   torch.bfloat16)
    out = verdict(cell, run_cpu(cell), low=low)
    assert not out["correct"], out["checks"]


def broken(monkeypatch, fault):
    """Break render_hdr, as the loop calls it, with `fault`."""
    from cse168_raytracer_tpu_torch.render import integrator
    real = integrator.render_hdr
    first = {}

    def render(scene, static, cam, cfg, gen=None):
        hdr, stats = real(scene, static, cam, cfg, gen)
        if fault == "stale":
            # every call after the first hands back the first one's image
            if "hdr" not in first:
                first["hdr"] = hdr.detach().clone()
                return hdr, stats
            if not hdr.requires_grad:
                return first["hdr"].clone(), stats
            return hdr - hdr.detach() + first["hdr"], stats
        if fault == "half":
            # every other pixel (a checkerboard) left out
            h, w = hdr.shape[:2]
            yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w),
                                    indexing="ij")
            keep = ((yy + xx) % 2 == 0).to(hdr.dtype)[..., None]
            return hdr * keep, stats
        if fault == "altered":
            # the 16 brightest pixels 5% too bright
            flat = hdr.detach().sum(-1).reshape(-1)
            bump = torch.ones_like(flat)
            bump[flat.topk(16).indices] = 1.05
            return hdr * bump.reshape(hdr.shape[:2])[..., None], stats
        raise ValueError(fault)
    monkeypatch.setattr(integrator, "render_hdr", render)


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    cell = tiny_cell(name)
    broken(monkeypatch, fault)
    run = run_cpu(cell)
    assert len(run["kept"]) >= 2
    out = verdict(cell, run)
    assert not out["correct"], (fault, out["checks"])
