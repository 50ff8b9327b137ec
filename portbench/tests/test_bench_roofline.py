"""The roofline counts from shapes, and the trace readers on a
synthetic trace."""

import pytest
import torch

from benchkit import ROOT  # noqa: F401
from portbench import roofline
from portbench.harness import Context
from portbench.metrics import (device_idle_pct, kernels_per_iter,
                               segment_sum_roofline,
                               traverse_roofline)
from portbench.trace import Trace, merged, short_name, union_us


def test_traverse_counts():
    nbytes, ops = roofline.traverse_call(1000, 10, closest=True)
    assert nbytes == 1000 * (32 + 4 + 4 + 128) + 10 * 36
    assert ops == 1000 * (12 + 53)
    nbytes, _ = roofline.traverse_call(1000, 10, closest=False)
    assert nbytes == 1000 * (32 + 4) + 10 * 36


def test_segment_sum_counts():
    nbytes, ops = roofline.segment_sum_call(262144, 29, 270336)
    assert nbytes == 262144 * 29 * 4 + 262144 * 8 + 270336 * 29 * 4
    assert ops == 262144 * 29


def test_least_time_names_its_term():
    assert roofline.least_seconds(3.35e12, 0)[1] == "bytes"
    assert roofline.least_seconds(0, 67e12) == (1.0, "operations")


def test_union_and_merge():
    r = [(0, 2), (1, 3), (5, 6)]
    assert union_us(r) == 4
    assert merged(r) == [[0, 3], [5, 6]]


def test_short_names():
    assert short_name("void traverse_warp<true, false>(float*)") == \
        "traverse_warp"
    assert short_name("Memset (Device)") == "Memset"


def synthetic():
    dev = [("traverse_warp<1>", 10, 20), ("segsum_tiles", 20, 30),
           ("Memset (Device)", 30, 32), ("elementwise", 60, 70)]
    host = [("aten::nonzero", 32, 60), ("portbench_iteration", 0, 100)]
    return Trace(device_ops=dev, host_ops=host, window=(0, 100))


def test_busy_idle_and_gaps():
    t = synthetic()
    assert t.busy_us() == 32
    ctx = Context()
    ctx.trace, ctx.traced_iters = t, 2
    assert device_idle_pct.read(ctx) == pytest.approx(68.0)
    assert kernels_per_iter.read(ctx) == 1.5
    gaps = dict(t.idle_gaps())
    assert gaps["aten::nonzero"] == pytest.approx(28e-6)
    assert gaps["portbench_iteration"] == pytest.approx(40e-6)
    assert t.top_ops()[0][0] in ("traverse_warp", "segsum_tiles",
                                 "elementwise")


def test_roofline_readers_from_calls():
    ctx = Context()
    ctx.trace, ctx.n_tris, ctx.traced_iters = synthetic(), 100, 2
    live = traverse_roofline.live(3, 0.0, torch.tensor([1.0, -1.0, 2.0]))
    assert live == 2
    ctx.calls["traverse_probe"] = [(True, live)]
    ctx.calls["traverse"] = [True, True]
    nbytes, ops = roofline.traverse_call(2, 100, True)
    want = 2 * 100 * roofline.least_seconds(nbytes, ops)[0] / 10e-6
    assert traverse_roofline.read(ctx) == pytest.approx(want)
    ctx.calls["traverse"] = [True, False]
    assert traverse_roofline.read(ctx) is None
    ctx.calls["segment_sum"] = [(10, 3, 4)]
    want = 100 * roofline.least_seconds(
        *roofline.segment_sum_call(10, 3, 4))[0] / 10e-6
    assert segment_sum_roofline.read(ctx) == pytest.approx(want)


def test_readers_without_their_kernels_read_nothing():
    ctx = Context()
    ctx.trace = Trace(device_ops=[("elementwise", 0, 1)], host_ops=[],
                      window=(0, 10))
    ctx.traced_iters = 1
    ctx.calls["traverse_probe"] = [(True, 3)]
    ctx.calls["traverse"] = [True]
    ctx.calls["segment_sum"] = [(10, 3, 4)]
    assert traverse_roofline.read(ctx) is None
    assert segment_sum_roofline.read(ctx) is None
    assert traverse_roofline.read(Context()) is None
