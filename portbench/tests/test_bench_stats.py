"""The end-to-end readers on synthetic iteration times."""

import pytest

from benchkit import ROOT  # noqa: F401  (puts the checkout on sys.path)
from portbench.harness import Context
from portbench.metrics import iter_ms_p95, samples_per_s, setup_s


def ctx_of(times, samples=1000):
    ctx = Context()
    ctx.iter_s = list(times)
    ctx.window_s = sum(times)
    ctx.samples_per_iter = samples
    return ctx


def test_samples_per_s_is_all_work_over_all_time():
    ctx = ctx_of([0.01] * 100)
    assert samples_per_s.read(ctx) == pytest.approx(100 * 1000 / 1.0)


def test_a_stall_lowers_the_rate():
    steady = samples_per_s.read(ctx_of([0.01] * 100))
    stalled = samples_per_s.read(ctx_of([0.01] * 99 + [0.5]))
    assert stalled < steady * 0.7


def test_p95_is_the_nearest_rank():
    times = [i / 1000 for i in range(1, 201)]      # 1 .. 200 ms
    assert iter_ms_p95.read(ctx_of(times)) == pytest.approx(190.0)
    assert iter_ms_p95.p95([5.0]) == 5.0


def test_a_stall_moves_the_tail_only_past_five_percent():
    one = [0.01] * 199 + [0.5]
    assert iter_ms_p95.read(ctx_of(one)) == pytest.approx(10.0)
    many = [0.01] * 180 + [0.5] * 20
    assert iter_ms_p95.read(ctx_of(many)) == pytest.approx(500.0)


def test_empty_window_reads_nothing():
    ctx = Context()
    assert samples_per_s.read(ctx) is None
    assert iter_ms_p95.read(ctx) is None


def test_setup_is_read_as_recorded():
    ctx = Context()
    ctx.setup_s = 12.5
    assert setup_s.read(ctx) == 12.5
