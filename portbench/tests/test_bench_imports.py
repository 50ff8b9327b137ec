"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names (the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

from benchkit import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "cse168_raytracer_tpu"}
BENCH = os.path.join(ROOT, "portbench")


def imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]


def sources(root):
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_top_level_names_are_compared_whole():
    names = {"cse168_raytracer_tpu_torch", "jaxtyping", "portbench"}
    assert not names & FORBIDDEN
    assert "cse168_raytracer_tpu" in FORBIDDEN


def test_no_module_imports_jax():
    bad = {p: sorted(set(imports(p)) & FORBIDDEN) for p in sources(BENCH)}
    assert not {p: b for p, b in bad.items() if b}


def test_reference_imports_nothing_of_the_port():
    for p in sources(os.path.join(BENCH, "reference")):
        assert "cse168_raytracer_tpu_torch" not in set(imports(p)), p


def test_a_run_loads_no_jax():
    """What run.py loads, in a fresh process: the harness, every reader,
    scene, iteration and compare module, the port's modules a run
    imports and the reference."""
    code = (
        "import sys; sys.path.insert(0, sys.argv[1])\n"
        "from portbench import harness, check, trace\n"
        "import portbench.reference.render\n"
        "from cse168_raytracer_tpu_torch.render import integrator\n"
        "from cse168_raytracer_tpu_torch.ops import accel\n"
        "import json\n"
        "for w in json.load(open(sys.argv[1] + '/BENCHMARK.json'))"
        "['workloads']:\n"
        "    harness.Cell(w['name'])\n"
        "print(harness.jax_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
