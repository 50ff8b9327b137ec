#!/usr/bin/env python3
"""The port's benchmark: run one cell once on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics; with
--trace 1 its per-layer metrics), device, with --trace 1 breakdown, and
last the numbers compared against the plain reference with their limits
(also the last lines of standard error). Exits non-zero, printing no
result, without enough CUDA devices, where the port cannot be imported,
or where jax, jaxlib, flax or cse168_raytracer_tpu got loaded. Every
build and kernel cache stays inside the checkout (the port builds into
cse168_raytracer_tpu_torch/_build/; TORCH_EXTENSIONS_DIR and
TRITON_CACHE_DIR are set to portbench/.cache/).
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "portbench", ".cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["USE_FLAX"] = "0"
# the checkout's root in place of this folder, whose module names
# (trace, check) would shadow the standard library's
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != HERE]
sys.path.insert(0, ROOT)

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
