"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
is found: each configuration's file and scene module, each traffic file
and the iteration kind it names, each cell's limits and the module of
each number they name, each metric's reader."""

import importlib.util
import json
import os
import re

import pytest

from benchkit import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_tok", "num_experts_per")


@pytest.fixture(scope="module")
def manifest():
    path = os.path.join(ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    with open(path) as f:
        return json.load(f)


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    cmd = manifest["command"]
    assert 1 <= len(cmd) <= 32 and all(line(w) for w in cmd)
    assert 1 <= len(manifest["paths"]) <= 16
    for p in manifest["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
        assert os.path.isdir(os.path.join(ROOT, p))
    for w in cmd[1:]:
        if os.path.exists(os.path.join(ROOT, w)):
            assert any(w.startswith(p.rstrip("/") + "/")
                       for p in manifest["paths"])


def test_run_seconds_fit_the_check(manifest):
    s = manifest["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs(manifest):
    names = [c["name"] for c in manifest["configs"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    used = {w["config"] for w in manifest["workloads"]}
    files = set()
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["name"] in used
        assert any(c["file"].startswith(p.rstrip("/") + "/")
                   for p in manifest["paths"])
        assert c["file"] not in files
        files.add(c["file"])
        conf_path = os.path.join(ROOT, c["file"])
        with open(conf_path) as f:
            conf = json.load(f)
        assert os.path.exists(os.path.splitext(conf_path)[0] + ".py")
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.match(k) and k in conf
            assert not k.endswith(("_dim", "_rank"))
            assert not any(wd in k for wd in WIDTH_WORDS)
        assert conf["reduced"] == c["reduced"]


def test_workloads(manifest):
    cells = manifest["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line(w["why"])
        traffic = os.path.join(ROOT, "portbench", "traffic",
                               w["traffic"] + ".json")
        with open(traffic) as f:
            kind = json.load(f)["iteration"]
        assert NAME.match(kind) and os.path.exists(os.path.join(
            ROOT, "portbench", "iterations", kind + ".py"))
        limits = os.path.join(ROOT, "portbench", "limits",
                              w["name"] + ".json")
        with open(limits) as f:
            for n in json.load(f):
                assert NAME.match(n) and os.path.exists(os.path.join(
                    ROOT, "portbench", "compare", n + ".py"))


def test_metrics(manifest):
    cells = {w["name"] for w in manifest["workloads"]}
    e2e, pl = manifest["end_to_end"], manifest["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    names = [m["name"] for m in e2e + pl]
    assert len(set(names)) == len(names)
    assert "setup_s" in names
    layers = {}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in pl:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert line(m["layer"]) and m["moves"] in {x["name"] for x in e2e}
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in e2e + pl:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(ROOT, "portbench", "metrics",
                                           m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_reports_enough(manifest):
    from portbench.harness import Cell
    for w in manifest["workloads"]:
        cell = Cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert set(cell.readers) == e2e | {m["name"] for m in cell.per_layer}
        for r in cell.readers.values():
            assert callable(r.read)
        assert cell.limits and all(v >= 0 for v in cell.limits.values())
        assert set(cell.compare) == set(cell.limits)
        assert all(callable(m.read) for m in cell.compare.values())
        assert callable(cell.iteration.setup)
        assert callable(cell.iteration.reference)
        assert callable(cell.scenes.build_port)
        assert callable(cell.scenes.build_raw)


@pytest.mark.parametrize("folder", ["metrics", "compare"])
def test_reader_modules_import_without_the_port(folder):
    d = os.path.join(ROOT, "portbench", folder)
    for f in sorted(os.listdir(d)):
        if f.endswith(".py") and f != "__init__.py":
            spec = importlib.util.spec_from_file_location(
                folder + "_" + f[:-3], os.path.join(d, f))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            assert callable(mod.read)
