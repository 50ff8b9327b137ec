"""The port's tracer (utils/profiling.py) on the CPU: off it records
nothing; spans nest per thread, a backward's too; under torch.profiler
a span's range encloses the operators run inside it; a render gives
one integrate.level a level with its stages under it; the ray counters
that integrate hands a sink count the lanes the traversal walks; the
set-up phases are kept without a sink."""

import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.core.fastgather import take_rows  # noqa: E402
from cse168_raytracer_tpu_torch.ops import photon as tph  # noqa: E402
from cse168_raytracer_tpu_torch.ops import wide_bvh as twb  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from cse168_raytracer_tpu_torch.utils import profiling  # noqa: E402
from test_torch_cuda_tracing import glass_scene  # noqa: E402

STAGES = {"integrate.closest", "integrate.shade", "integrate.photons",
          "integrate.accumulate", "integrate.children"}


def floor_photons(n=3000, seed=0):
    """Photon maps of n photons strewn over the glass scene's floor."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-2, 2, n), np.zeros(n),
                    rng.uniform(-3, 1, n)], 1).astype(np.float32)
    power = rng.uniform(0, 1e-3, (n, 3)).astype(np.float32)
    dirs = np.tile(np.float32([[0, -1, 0]]), (n, 1))
    grid = tph.build_grid(pos, power, dirs, 0.3, max_per_cell=16, knn=8,
                          coarse_factor=None, device="cpu")
    return tph.PhotonMaps(global_map=grid, caustic_map=None)


@pytest.fixture(scope="module")
def glass():
    return glass_scene("cpu")


def test_off_records_nothing_and_shares_one_null_context(glass):
    assert profiling.SINK is None and not torch.autograd._profiler_enabled()
    a, b = profiling.span("render.frame"), profiling.span("integrate.level")
    assert a is b
    x = torch.ones(3)
    assert profiling.sync("ray_bounds", x) is a      # not on the card
    before = dict(profiling.COUNTS)
    scene, static, cam = glass
    render_hdr(scene, static, cam, RenderConfig(width=16, height=16,
                                                trace_depth=1))
    # no launch, no sync: only the pool passes, counted on every device
    # (the glass scene has no sphere and no plane)
    moved = {k for k, v in profiling.COUNTS.items() if v != before.get(k, 0)}
    assert moved == {"pool.skipped.spheres", "pool.skipped.planes"}
    with profiling.span("a"):
        profiling.record("segment_sum", (1, 2, 3))
    assert profiling.SINK is None


def test_spans_nest_per_thread_and_a_backward_is_its_own_root():
    table = torch.rand(4, 3, requires_grad=True)
    loss = take_rows(table, torch.tensor([0, 2, 2, 3])).sum()
    seen = {}

    def other():
        with profiling.span("render.band"):
            with profiling.span("integrate.level"):
                seen["thread"] = threading.get_ident()
        loss.backward()         # the backward's thread is this one
    with profiling.recording() as sink:
        with profiling.span("render.frame"):
            with profiling.span("integrate.level"):
                t = threading.Thread(target=other)
                t.start()
                t.join()
    by = {(s.name, s.thread): s for s in sink.spans}
    me = threading.get_ident()
    frame = by["render.frame", me]
    level = by["integrate.level", me]
    assert frame.parent is None and frame.root == frame.id
    assert level.parent == frame.id and level.root == frame.id
    band = by["render.band", seen["thread"]]
    inner = by["integrate.level", seen["thread"]]
    assert band.parent is None and band.root == band.id
    assert inner.parent == band.id and inner.root == band.id
    back = by["backward.take_rows", seen["thread"]]
    assert back.parent is None and back.root == back.id
    assert sink.records["segment_sum"] == [(4, 3, 4)]
    for s in sink.spans:
        assert s.start_ns <= s.end_ns
    assert frame.start_ns <= level.start_ns <= level.end_ns <= frame.end_ns


def test_span_ranges_enclose_their_operators_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    x = torch.ones(1000)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("integrate.level"):
            with profiling.span("integrate.shade"):
                y = x * 2.0
            z = y + 1.0
        with profiling.phase("accel.build", log=False):
            torch.zeros(3)
    ev = {}
    for e in prof.events():
        ev.setdefault(e.name, []).append(e.time_range)
    level, shade = ev["integrate.level"][0], ev["integrate.shade"][0]
    mul, add = ev["aten::mul"][0], ev["aten::add"][0]
    assert level.start <= shade.start <= mul.start <= mul.end <= shade.end
    assert shade.end <= add.start <= add.end <= level.end
    setup = ev["accel.build"][0]
    assert any(setup.start <= r.start <= r.end <= setup.end
               for r in ev["aten::zeros"])
    assert float(z[0]) == 3.0


def test_a_render_gives_one_level_span_a_level_with_its_stages(glass):
    scene, static, cam = glass
    scene = scene.replace(photons=floor_photons())
    cfg = RenderConfig(width=16, height=16, trace_depth=3)
    with profiling.recording() as sink:
        render_hdr(scene, static, cam, cfg)
    names = {s.id: s.name for s in sink.spans}
    frames = [s for s in sink.spans if s.name == "render.frame"]
    assert len(frames) == 1 and frames[0].parent is None
    bands = [s for s in sink.spans if s.name == "render.band"]
    assert [names[b.parent] for b in bands] == ["render.frame"]
    levels = [s for s in sink.spans if s.name == "integrate.level"]
    assert len(levels) == cfg.trace_depth + 1
    for lv in levels:
        assert names[lv.parent] == "render.band"
        stages = [s.name for s in sink.spans if s.parent == lv.id]
        assert sorted(stages) == sorted(STAGES)
        assert all(s.root == frames[0].id for s in sink.spans
                   if s.parent == lv.id)
    assert not [n for n in names.values()
                if "traverse" in n or "segsum" in n]


def test_render_stats_count_the_lanes_the_traversal_walks(glass,
                                                         monkeypatch):
    """primary + secondary + shadow rays of RenderStats, which integrate
    hands an open sink, equal the lanes with tmax >= tmin of every
    traversal call: no ray of the glass pane's scene spawns past level
    1, so no child counted goes untraced, and every shading point casts
    its shadow ray."""
    scene, static, cam = glass
    live = []
    for name in ("closest_hit_triangles", "any_hit_triangles"):
        real = getattr(twb, name)

        def wrapped(bvh, o, d, tmin, tmax, *a, _real=real, **k):
            n = o.shape[0]
            lo = torch.as_tensor(tmin, dtype=torch.float32).expand(n)
            hi = torch.as_tensor(tmax, dtype=torch.float32).expand(n)
            live.append(int((hi >= lo).sum()))
            return _real(bvh, o, d, tmin, tmax, *a, **k)
        monkeypatch.setattr(twb, name, wrapped)
    cfg = RenderConfig(width=16, height=16, trace_depth=3)
    with profiling.recording() as sink:
        _, stats = render_hdr(scene, static, cam, cfg)
    assert int(stats.secondary_rays) > 0 and int(stats.shadow_rays) > 0
    (primary, secondary, shadow), = sink.records["render_stats"]
    assert primary is stats.primary_rays and shadow is stats.shadow_rays
    rays = int(primary) + int(secondary) + int(shadow)
    assert rays == sum(live) and len(live) == 2 * (cfg.trace_depth + 1)


def test_a_paused_sink_drops_what_arrives():
    paused = [True]
    with profiling.recording(paused=lambda: paused[0]) as sink:
        with profiling.span("integrate.level"):
            profiling.count("sync.test_site", 2)
            profiling.record("render_stats", (1, 2, 3))
        paused[0] = False
        with profiling.span("integrate.shade"):
            profiling.count("sync.test_site")
    assert [s.name for s in sink.spans] == ["integrate.shade"]
    assert sink.counts == {"sync.test_site": 1} and not sink.records
    assert profiling.counts("sync")["test_site"] >= 3     # always counted
    with pytest.raises(RuntimeError):
        with profiling.recording():
            with profiling.recording():
                pass
    assert profiling.SINK is None


def test_setup_phases_are_kept_without_a_sink(glass):
    profiling.reset()
    glass_scene("cpu")
    ph = profiling.spans()
    assert {"scene.build", "accel.build", "accel.sah", "accel.wide",
            "accel.upload"} <= set(ph)
    assert ph["accel.build"] >= ph["accel.sah"] + ph["accel.wide"]
    # a phase inside one of its name adds nothing
    profiling.reset()
    with profiling.phase("scene.build", log=False):
        with profiling.phase("scene.build", log=False):
            time.sleep(0.05)
    assert 0.05 <= profiling.spans()["scene.build"] < 0.1


def test_counts_from_many_threads_lose_no_increment():
    """More threads than cores counting one counter and, while a sink is
    open, its increments too, with the interpreter switching threads
    every microsecond."""
    n_threads, n = 16, 10000
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = profiling.counts("sync").get("test_threads", 0)
        with profiling.recording() as sink:
            threads = [threading.Thread(target=lambda: [
                profiling.count("sync.test_threads") for _ in range(n)])
                for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert sink.counts["sync.test_threads"] == n_threads * n
    assert profiling.counts("sync")["test_threads"] - before == n_threads * n
