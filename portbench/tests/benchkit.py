"""Helpers of the benchmark's own tests (CPU, tiny sizes).

    python -m pytest portbench/tests -q

A tiny cell is a cell of BENCHMARK.json at 16 x 16 pixels (the glass
sphere at 8 rings, every pixel sampled), run on the CPU with the port's
plain paths: the same harness, loop, reference and comparison as on
the card. Tests marked `cuda` run a real cell and skip without a card.
"""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

SEED = 3_000_000_123      # above 2**31: seeds need more than 32 bits


def tiny_cell(name, root=ROOT, size=16):
    from portbench.harness import Cell
    cell = Cell(name, root)
    cell.conf["width"] = cell.conf["height"] = size
    if "sphere" in cell.conf:
        cell.conf["sphere"]["rings"] = 8
    if "sample_pixels" in cell.traffic:
        cell.traffic["sample_pixels"] = size * size
    return cell


def run_cpu(cell, seed=SEED, min_iters=3, trace=False):
    """measure() on the CPU: set-up, a window of min_iters iterations,
    the kept outputs (the first, one drawn from the seed where the window
    reaches it, the last)."""
    import torch
    from portbench.harness import measure
    return measure(cell, seed, 0.0, trace, torch.device("cpu"),
                   time.perf_counter(), sync=lambda: None,
                   min_iters=min_iters)


@pytest.fixture
def card():
    """The card, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run on the card)")
    return torch.device("cuda:0")
