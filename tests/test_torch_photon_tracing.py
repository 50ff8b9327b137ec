"""The photon gather's tracing (ops/photon.py grid_irradiance and
utils/profiling.py device_record) on the CPU: with a sink open a render
gives the span photon.gather under integrate.photons, the counters
photon.gathers and photon.points, and one "photon_gather" record a
call, holding the call's points and grid; with no sink open (or a
paused one) no CUDA event is created, and the record runs no reduction
either way; off the card a record carries no events; the estimate is
the same bits either way. And the maps keep the photons they were built
from (PhotonMaps.photons)."""

import pytest

torch = pytest.importorskip("torch")

import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.ops import photon as tph  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from cse168_raytracer_tpu_torch.utils import profiling  # noqa: E402
from test_torch_cuda_tracing import glass_scene  # noqa: E402
from test_torch_tracing import floor_photons  # noqa: E402


@pytest.fixture(scope="module")
def glass():
    scene, static, cam = glass_scene("cpu")
    return scene.replace(photons=floor_photons()), static, cam


@pytest.fixture(scope="module")
def coarse_map():
    """A floor map with a coarse level: points of a sparse corner take
    the coarse estimate."""
    import numpy as np
    rng = np.random.default_rng(1)
    n = 4000
    pos = np.stack([rng.uniform(-2, 2, n), np.zeros(n),
                    rng.uniform(-3, 1, n)], 1).astype(np.float32)
    pos[:40, 0] = rng.uniform(6, 7, 40).astype(np.float32)
    power = rng.uniform(0, 1e-3, (n, 3)).astype(np.float32)
    dirs = np.tile(np.float32([[0, -1, 0]]), (n, 1))
    return tph.build_grid(pos, power, dirs, 0.2, max_per_cell=16, knn=30,
                          coarse_factor=8.0, device="cpu")


def points(n=300, seed=2):
    g = torch.Generator().manual_seed(seed)
    p = torch.stack([torch.rand(n, generator=g) * 8 - 2, torch.zeros(n),
                     torch.rand(n, generator=g) * 4 - 3], 1)
    nrm = torch.tensor([0.0, 1.0, 0.0]).expand(n, 3).contiguous()
    return p, nrm


def test_a_photon_render_records_its_gathers(glass):
    scene, static, cam = glass
    cfg = RenderConfig(width=16, height=16, trace_depth=1)
    before = profiling.counts("photon")
    with profiling.recording() as sink:
        render_hdr(scene, static, cam, cfg)
    names = {s.id: s.name for s in sink.spans}
    gathers = [s for s in sink.spans if s.name == "photon.gather"]
    assert gathers and all(names[s.parent] == "integrate.photons"
                           for s in gathers)
    recs = sink.records["photon_gather"]
    assert len(recs) == len(gathers) == sink.counts["photon.gathers"]
    assert sum(r["points"] for r in recs) == sink.counts["photon.points"]
    assert sink.counts["photon.points"] > 0
    after = profiling.counts("photon")
    assert after["gathers"] - before.get("gathers", 0) == len(recs)
    for r in recs:
        assert "events" not in r                      # no card here
        assert profiling.device_ms(r) is None
        assert r["p"].shape == (r["points"], 3)
        assert r["grid"] is scene.photons.global_map


def test_record_holds_the_calls_points_and_grid(coarse_map):
    p, nrm = points()
    with profiling.recording() as sink:
        tph.grid_irradiance(coarse_map, p, nrm, chunk=64)
    rec, = sink.records["photon_gather"]
    assert set(rec) == {"points", "p", "grid"}
    assert rec["points"] == p.shape[0]
    assert rec["p"] is p and rec["grid"] is coarse_map


def test_no_sink_creates_no_event_and_runs_no_reduction(coarse_map,
                                                        monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    def no_event(*a, **k):
        raise AssertionError("a CUDA event was created")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    p, nrm = points()

    def sums(sink):
        """aten::sum operators of one gather call; sink None: no sink,
        "paused": a paused one, "open": an open one."""
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            if sink is None:
                tph.grid_irradiance(coarse_map, p, nrm, chunk=64)
            else:
                with profiling.recording(
                        paused=lambda: sink == "paused") as s:
                    tph.grid_irradiance(coarse_map, p, nrm, chunk=64)
                assert bool(s.records) == (sink == "open")
        return sum(e.name == "aten::sum" for e in prof.events())
    assert sums(None) == sums("paused") == sums("open") == 0
    assert profiling.device_record("photon_gather", p) is \
        profiling.span("photon.gather")               # the shared null


def test_device_record_times_the_block_on_the_card(monkeypatch):
    """The card's half, with CUDA events standing in: a start event
    before the block, an end event after it, read by device_ms."""
    made = []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            self.at = None
            made.append(self)

        def record(self):
            self.at = len(made)

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 1.5 * (end.at - self.at)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    with profiling.recording() as sink:
        with profiling.device_record("photon_gather",
                                     torch.device("cuda")) as rec:
            assert len(made) == 1 and made[0].at is not None
            rec["points"] = 7
    (got,) = sink.records["photon_gather"]
    assert got is rec and got["points"] == 7 and len(got["events"]) == 2
    assert profiling.device_ms(got) == 1.5


@pytest.mark.parametrize("chunk", [37, None])
def test_estimate_is_the_same_bits_with_and_without_a_sink(coarse_map,
                                                           chunk):
    p, nrm = points()
    off = tph.grid_irradiance(coarse_map, p, nrm, chunk=chunk)
    with profiling.recording():
        on = tph.grid_irradiance(coarse_map, p, nrm, chunk=chunk)
    assert torch.equal(off, on)


def test_gradient_is_the_same_with_and_without_a_sink(coarse_map):
    p, nrm = points()
    grads = []
    for sink in (False, True):
        g = coarse_map.replace(
            power=coarse_map.power.clone().requires_grad_(True),
            coarse=coarse_map.coarse.replace(
                power=coarse_map.coarse.power.clone().requires_grad_(True)))
        if sink:
            with profiling.recording():
                e = tph.grid_irradiance(g, p, nrm, chunk=64)
        else:
            e = tph.grid_irradiance(g, p, nrm, chunk=64)
        e.sum().backward()
        grads.append((g.power.grad, g.coarse.power.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))
    assert grads[0][1].abs().sum() > 0


def test_maps_keep_the_photons_they_were_built_from():
    """PhotonMaps.photons holds each map's photons as its grid got them:
    as many as the grid stores, the same rows where no bucket folds, their
    power summed alike, and kept by to(); a map with no target holds
    None."""
    import numpy as np
    from chip_smoke import photon_scene
    scene, static, _ = photon_scene("cpu", glass=True)
    cfg = RenderConfig(photons_per_light=3000, caustic_photons_per_light=0,
                       photon_samples=40, photon_grid_max_per_cell=4096)
    gen = torch.Generator().manual_seed(5)
    maps = tph.build_photon_maps(scene, static, cfg, gen)
    assert set(maps.photons) == {"global", "caustic"}
    assert maps.photons["caustic"] is None and maps.caustic_map is None
    pos, dirs, power = maps.photons["global"]
    grid = maps.global_map
    assert pos.shape == dirs.shape == power.shape == (grid.n_valid, 3)
    assert pos.dtype == dirs.dtype == power.dtype == np.float32
    assert np.allclose(power.astype(np.float64).sum(0),
                       grid.power.double().sum(0).numpy(), rtol=1e-6)
    # no bucket folds at this cap: the grid's rows are the photons
    assert float(grid.weight.max()) == 1.0
    rows = lambda x: sorted(map(tuple, x.tolist()))
    assert rows(pos) == rows(grid.pos.numpy())
    assert rows(dirs) == rows(grid.dir.numpy())
    assert maps.to("cpu").photons is maps.photons
