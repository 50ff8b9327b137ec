"""Each cell run end to end on the card for a short window, as a check
runs it (skips without a card; on the card:
python3 -m pytest --noconftest -m cuda portbench/tests/test_bench_card.py)."""

import json
import os
import subprocess
import sys

import pytest

from benchkit import ROOT, SEED, card  # noqa: F401  (the fixture)

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    MANIFEST = json.load(f)
CELLS = [w["name"] for w in MANIFEST["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name, trace):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", name, "--seed",
         str(SEED), "--seconds", "2", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    assert list(res)[-1] == "checks"
    if trace:
        assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
        assert "kernels_per_iter" in res["metrics"]
    else:
        assert {"samples_per_s", "setup_s"} <= set(res["metrics"])
