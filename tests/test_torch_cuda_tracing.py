"""The tracer's counters on the card: every blocking host-device call of
one 64 x 64 iteration of each traffic kind (a fit step with its
backward, a path-traced thin-lens frame, a Whitted frame through glass)
is counted by its sync.<site> counter, one for one with the warnings of
torch.cuda.set_sync_debug_mode("warn") raised inside that site's span;
the sites of each kind are the frame's start and its one read of the
traversal's error bits (and the glass frame's lane-order adds), and
nothing waits for the card between a frame's first launch and that
read; a walk's stack overflow or bad link raises at the frame's end;
and the backward's spans are roots on autograd's own thread.

Also the glass-pane scene that tests/test_torch_tracing.py renders on
the CPU. These tests need an NVIDIA GPU and skip without one; they import
neither jax nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_tracing.py
"""

import dataclasses
import threading
import time
import warnings

import pytest

torch = pytest.importorskip("torch")

from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.models.geometry import \
    pack_triangles  # noqa: E402
from cse168_raytracer_tpu_torch.models.lights import \
    LIGHT_POINT  # noqa: E402
from cse168_raytracer_tpu_torch.models.materials import \
    MaterialBuilder  # noqa: E402
from cse168_raytracer_tpu_torch.models.scene import make_scene  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render.camera import make_camera  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from cse168_raytracer_tpu_torch.scenes import build  # noqa: E402
from cse168_raytracer_tpu_torch.utils import profiling  # noqa: E402
from chip_smoke import lit_sponza, photon_box, quad  # noqa: E402

SYNC_WARNING = "called a synchronizing CUDA operation"


def glass_scene(device):
    """A white floor under a horizontal glass pane (kt 1, ior 1.5), lit
    by a point light; every material has a finite shininess, so every
    shading point casts its shadow ray, and no ray spawns past level 1:
    camera rays refract through the pane onto the floor or reflect into
    the sky. Returns (Scene with its tree, SceneStatic, Camera)."""
    mb = MaterialBuilder()
    floor = mb.phong(kd=(0.8, 0.8, 0.8), shininess=20.0)
    glass = mb.phong(kd=(0.0, 0.0, 0.0), kt=(1.0, 1.0, 1.0),
                     shininess=50.0, ior=1.5)
    meshes = [(quad((-3, 0, 2), (3, 0, 2), (3, 0, -4), (-3, 0, -4),
                    (0, 1, 0)), floor),
              (quad((-0.8, 0.5, 0.3), (0.8, 0.5, 0.3), (0.8, 0.5, -1.2),
                    (-0.8, 0.5, -1.2), (0, 1, 0)), glass)]
    scene, static = make_scene(
        tris=pack_triangles(meshes, device=device), materials=mb.build(device),
        lights=[dict(kind=LIGHT_POINT, position=(0.5, 3.0, 0.5),
                     color=(1, 1, 1), wattage=40.0)], device=device)
    cam = make_camera(eye=(0.0, 1.6, 2.2), look_at=(0.0, 0.2, -0.6),
                      fov=50.0, device=device)
    return attach_accel(scene), static, cam


def sponza(device, size):
    """The registered sponza_proxy with its light below the ceiling."""
    scene, static, cam, cfg = build(
        "sponza_proxy", RenderConfig(width=size, height=size, trace_depth=4),
        device=device)
    return attach_accel(lit_sponza(scene)), static, cam, cfg


def iteration(kind, device, size=64):
    """One iteration of a traffic kind, as a callable: "fit" (a Whitted
    render of lit sponza_proxy, loss sum, backward w.r.t. kd and v0),
    "pt_dof" (a 16-sample path-traced thin-lens frame of it) or
    "whitted_glass" (a depth-10 Whitted frame of chip_smoke.photon_box,
    the glass sphere in its box)."""
    if kind == "whitted_glass":
        scene, static, cam = photon_box(device)
        scene = attach_accel(scene)
        cfg = RenderConfig(width=size, height=size, trace_depth=10)

        def run():
            with torch.no_grad():
                return render_hdr(scene, static, cam, cfg)
        return run
    scene, static, cam, cfg = sponza(device, size)
    if kind == "pt_dof":
        cfg = cfg.replace(path_tracing=True, dof=True, trace_samples=16)
        gen = torch.Generator(device=device).manual_seed(5)

        def run():
            with torch.no_grad():
                return render_hdr(scene, static, cam, cfg, gen)
        return run

    def run():
        kd = scene.materials.kd.detach().clone().requires_grad_(True)
        v0 = scene.tris.v0.detach().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(kd=kd),
                          tris=scene.tris.replace(v0=v0))
        hdr, stats = render_hdr(s, static, cam, cfg)
        hdr.sum().backward()
        return hdr, stats
    return run


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def sync_debug():
    """torch.cuda.set_sync_debug_mode back to off after the test."""
    yield
    torch.cuda.set_sync_debug_mode(0)


pytestmark = pytest.mark.cuda


def sync_warnings(run):
    """Run `run` with a sink open and set_sync_debug_mode("warn").
    Returns ([(perf_counter_ns, thread, file, line) of each synchronizing
    warning], the sink)."""
    raised = []     # (perf_counter_ns, thread, file, line)

    def note(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            raised.append((time.perf_counter_ns(), threading.get_ident(),
                           filename, lineno))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = note
        with profiling.recording() as sink:
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
    return raised, sink


def sync_warnings_by_site(run):
    """Run `run` with a sink open and set_sync_debug_mode("warn"); put
    each synchronizing warning down to the innermost sync.<site> span
    open on its thread when it was raised. Returns ({sync.<site>:
    warnings}, [(file, line) of the warnings outside every sync span],
    the sink)."""
    raised, sink = sync_warnings(run)
    syncs = [s for s in sink.spans if s.name.startswith("sync.")]
    by_site, outside = {}, []
    for t, thread, filename, lineno in raised:
        open_ = [s for s in syncs
                 if s.thread == thread and s.start_ns <= t <= s.end_ns]
        if not open_:
            outside.append((filename, lineno))
            continue
        site = max(open_, key=lambda s: s.start_ns).name
        by_site[site] = by_site.get(site, 0) + 1
    return by_site, outside, sink


@pytest.mark.parametrize("kind", ["fit", "pt_dof", "whitted_glass"])
def test_sync_counters_match_sync_debug_warnings(cuda, sync_debug, kind):
    """Per site: the sync.<site> increments equal the warnings raised
    inside that site's spans, and no warning falls outside them."""
    run = iteration(kind, cuda)
    run()                       # kernels loaded, caches warm
    torch.cuda.synchronize()
    before = profiling.counts("sync")
    by_site, outside, sink = sync_warnings_by_site(run)
    counted = {k: v for k, v in sink.counts.items() if k.startswith("sync.")}
    assert counted == {"sync." + k: v - before.get(k, 0)
                       for k, v in profiling.counts("sync").items()
                       if v != before.get(k, 0)}
    assert not outside, (kind, sorted(set(outside)))
    assert by_site == counted and counted, (kind, by_site, counted)


# the sync sites of one 64 x 64 iteration, and its traversal launches:
# the frame's start (the pixel order, the camera's tan) and its one read
# of the error bits; the glass frame adds its lane-order adds, a level
# past the first (ROADMAP D1c)
FRAME_SYNCS = {"sync.pixel_order": 2, "sync.camera_fov": 2,
               "sync.launch_error": 1}
SYNCS = {"fit": FRAME_SYNCS, "pt_dof": FRAME_SYNCS,
         "whitted_glass": {**FRAME_SYNCS, "sync.lane_order.heads": 10,
                           "sync.lane_order.counts": 20,
                           "sync.lane_order.longest": 10}}
LAUNCHES = {"fit": 2, "pt_dof": 32, "whitted_glass": 22}


def launches(counts):
    return sum(v for k, v in counts.items() if k.startswith("launch.wide."))


@pytest.mark.parametrize("kind", ["fit", "pt_dof", "whitted_glass"])
def test_sync_sites_of_one_iteration(cuda, kind):
    """The exact sync.<site> increments of one iteration, and every
    traversal launch's error check joined to the frame's."""
    run = iteration(kind, cuda)
    run()
    torch.cuda.synchronize()
    with profiling.recording() as sink:
        run()
    torch.cuda.synchronize()
    counted = {k: v for k, v in sink.counts.items() if k.startswith("sync.")}
    assert counted == SYNCS[kind]
    assert launches(sink.counts) == LAUNCHES[kind]
    assert sink.counts["launch_error.deferred"] == LAUNCHES[kind]


@pytest.mark.parametrize("kind", ["fit", "pt_dof"])
def test_nothing_waits_between_the_first_launch_and_the_error_read(
        cuda, sync_debug, kind):
    """No synchronizing call warns between the start of the frame's first
    bvh.launch span and the start of its one sync.launch_error span;
    that read warns."""
    run = iteration(kind, cuda)
    run()
    torch.cuda.synchronize()
    raised, sink = sync_warnings(run)
    me = threading.get_ident()
    first = min(s.start_ns for s in sink.spans if s.name == "bvh.launch")
    (read,) = [s for s in sink.spans if s.name == "sync.launch_error"]
    assert first < read.start_ns
    between = [(f, line) for t, thread, f, line in raised
               if thread == me and first <= t <= read.start_ns]
    assert not between, sorted(set(between))
    assert any(read.start_ns <= t <= read.end_ns for t, *_ in raised)


@pytest.mark.parametrize("fault", ["stack overflow", "bad link"])
def test_render_raises_a_walk_error_at_the_frames_end(cuda, fault):
    """render_hdr over sponza_proxy's tree with a one-slot stack, or with
    its leaf links out of range: both launches run, their bits join the
    frame's word, and the frame's one read raises."""
    scene, static, cam, cfg = sponza(cuda, 64)
    tree = scene.accel
    broken = {"stack overflow": dataclasses.replace(tree, stack_depth=1),
              "bad link": dataclasses.replace(tree, links=torch.where(
                  tree.links < 0, tree.links - 10 ** 6, tree.links))}[fault]
    with profiling.recording() as sink:
        with pytest.raises(RuntimeError, match="traverse_wide: .*" + fault):
            render_hdr(scene.replace(accel=broken), static, cam, cfg)
    assert launches(sink.counts) == 2
    assert sink.counts["launch_error.deferred"] == 2
    assert sink.counts["sync.launch_error"] == 1


def test_backward_spans_are_roots_on_autograd_thread(cuda):
    run = iteration("fit", cuda, size=32)
    run()
    with profiling.recording() as sink:
        run()
    torch.cuda.synchronize()
    back = [s for s in sink.spans if s.name.startswith("backward.")]
    assert {s.name for s in back} == {"backward.take_rows",
                                      "backward.reattach_rows"}
    me = threading.get_ident()
    assert all(s.parent is None and s.root == s.id and s.thread != me
               for s in back)
    frames = [s for s in sink.spans if s.name == "render.frame"]
    assert len(frames) == 1 and frames[0].thread == me
    assert sink.counts["bvh.lanes"] > 0
