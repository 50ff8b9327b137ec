"""A frame's one check of the traversal's errors, and the constants it
makes on the device, on the CPU.

- wide_bvh.frame_errors: inside a frame every launch of the card walks
  ORs its error bits into one word, read when the frame ends, with the
  per-launch check's message; nested frames share the word; outside a
  frame each launch keeps its own word and its own read. The launches
  run traverse_wide.cu's card build through the CUDA emulation
  (test_torch_traverse.emulated_build), routed to from CPU tensors.
- intersect.ray_bounds and vecmath.unit_axis give the bits of the host
  copies they replace.
- a 32 x 32 frame of the glass-pane scene, its kd and fov gradients and
  a sampled thin-lens frame, bit for bit as stored in
  tests/golden/torch_glass_frames_32.npz (written by the render before
  the frame's camera basis was computed once and its constants made on
  the device; `python tests/test_torch_frame_errors.py write` rewrites
  it).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)
from cse168_raytracer_tpu_torch.config import (EPSILON,  # noqa: E402
                                               MIRO_TMAX, RenderConfig)
from cse168_raytracer_tpu_torch.core.vecmath import unit_axis  # noqa: E402
from cse168_raytracer_tpu_torch.models.geometry import \
    pack_triangles  # noqa: E402
from cse168_raytracer_tpu_torch.ops import wide_bvh as twb  # noqa: E402
from cse168_raytracer_tpu_torch.ops.intersect import \
    ray_bounds  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from cse168_raytracer_tpu_torch.utils import profiling  # noqa: E402
from test_torch_cuda_tracing import glass_scene  # noqa: E402
from test_torch_traverse import (clustered_mesh,  # noqa: E402
                                 emulated_build, rays)

STORED = os.path.join(os.path.dirname(__file__), "golden",
                      "torch_glass_frames_32.npz")


def glass_frames():
    """The glass-pane scene (tests/test_torch_cuda_tracing.py) on the CPU
    at 32 x 32: a depth-2 Whitted frame with the gradients of its sum
    w.r.t. kd and the camera's fov, and a 4-sample path-traced thin-lens
    frame in two row bands from a generator seeded 7. Returns numpy
    arrays by name."""
    scene, static, cam = glass_scene("cpu")
    kd = scene.materials.kd.detach().clone().requires_grad_(True)
    fov = cam.fov.detach().clone().requires_grad_(True)
    cfg = RenderConfig(width=32, height=32, trace_depth=2)
    hdr, stats = render_hdr(
        scene.replace(materials=scene.materials.replace(kd=kd)), static,
        dataclasses.replace(cam, fov=fov), cfg)
    hdr.sum().backward()
    pt_cfg = cfg.replace(path_tracing=True, dof=True, trace_samples=4,
                         dof_aperture=0.05, dof_focus_plane=2.5, row_tile=16)
    with torch.no_grad():
        pt, pt_stats = render_hdr(scene, static, cam, pt_cfg,
                                  torch.Generator().manual_seed(7))
    return {"whitted": hdr.detach().numpy(), "kd_grad": kd.grad.numpy(),
            "fov_grad": fov.grad.numpy(), "pt": pt.numpy(),
            "stats": np.array([int(getattr(st, f)) for st in (stats, pt_stats)
                               for f in ("primary_rays", "secondary_rays",
                                         "shadow_rays", "dropped_rays")])}


def test_glass_frames_equal_the_stored_copy():
    """Every value, gradient and counter bit for bit as stored, with
    dtypes."""
    stored = np.load(STORED)
    got = glass_frames()
    assert sorted(stored.files) == sorted(got)
    for name, x in got.items():
        assert x.dtype == stored[name].dtype, name
        assert x.shape == stored[name].shape, name
        assert x.tobytes() == stored[name].tobytes(), name
    assert got["fov_grad"] != 0 and np.abs(got["kd_grad"]).max() > 0


# ---------------------------------------------------------------------------
# the helpers against the host copies they replace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x", [0.0, -1.0, EPSILON, MIRO_TMAX, 1e12, 3.0e37,
                               1e-45, 0.1, 7, float("inf")])
def test_ray_bounds_of_a_number_equal_its_copy(x):
    o = torch.zeros((5, 3))
    want = torch.as_tensor(x, dtype=torch.float32).expand(5).contiguous()
    got = ray_bounds(o, x, x)
    assert len(got) == 2
    for g in got:
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert torch.equal(g.view(torch.int32), want.view(torch.int32))


def test_ray_bounds_pass_tensors_through():
    o = torch.zeros((4, 3))
    lanes = torch.tensor([0.5, -1.0, 2.0, 1e12])
    scalar = torch.tensor(0.25, dtype=torch.float64)
    tmin, tmax = ray_bounds(o, scalar, lanes)
    assert torch.equal(tmin, torch.full((4,), 0.25))
    assert torch.equal(tmax, lanes) and tmax.dtype == torch.float32
    assert ray_bounds(torch.zeros((0, 3)), 1.0)[0].shape == (0,)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_unit_axis_equals_its_copy(i):
    want = torch.tensor([float(i == k) for k in range(3)])
    got = unit_axis(i, torch.float32, torch.device("cpu"))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert got.dtype == torch.float32


# ---------------------------------------------------------------------------
# the frame scope
# ---------------------------------------------------------------------------

CPU = torch.device("cpu")


def launch_message(bits):
    """What the per-launch check raises on a word holding `bits`."""
    with pytest.raises(RuntimeError) as e:
        twb._raise_on(torch.tensor([bits], dtype=torch.int32))
    return str(e.value)


@pytest.mark.parametrize("bits", [1, 2, 3])
def test_frame_raises_at_its_end_with_the_launch_message(bits):
    reached = []
    with pytest.raises(RuntimeError) as e:
        with twb.frame_errors():
            word = twb._error_word(CPU, "traverse_wide")
            word |= bits
            twb._after_launch(word)     # joins the frame: no read yet
            reached.append(True)
    assert reached and str(e.value) == launch_message(bits)
    assert ("stack overflow" in str(e.value)) == bool(bits & 1)
    assert ("bad link" in str(e.value)) == bool(bits & 2)


def test_frame_with_clear_bits_is_silent_and_counts_its_launches():
    before = profiling.counts("launch_error").get("deferred", 0)
    with twb.frame_errors():
        for _ in range(3):
            twb._after_launch(twb._error_word(CPU, "traverse_wide"))
    assert profiling.counts("launch_error")["deferred"] == before + 3
    assert twb._frame.words is None


def test_nested_frames_share_one_word():
    with pytest.raises(RuntimeError, match="traverse_binary/traverse_wide: "
                       "stack overflow"):
        with twb.frame_errors():
            outer = twb._error_word(CPU, "traverse_wide")
            with twb.frame_errors():
                inner = twb._error_word(CPU, "traverse_binary")
                assert inner is outer
                inner |= 1
            # the inner frame's end read nothing
            assert twb._frame.words == {CPU: outer}
    assert twb._frame.words is None


def test_outside_a_frame_each_launch_reads_its_own_word():
    a = twb._error_word(CPU, "traverse_wide")
    b = twb._error_word(CPU, "traverse_wide")
    assert a is not b and int(a) == int(b) == 0
    twb._after_launch(a)                # clear: nothing raised
    b |= 2
    with pytest.raises(RuntimeError, match="traverse_wide: bad link"):
        twb._after_launch(b)


def test_a_frame_that_raises_reads_nothing():
    with pytest.raises(ValueError, match="inside"):
        with twb.frame_errors():
            twb._error_word(CPU, "traverse_wide").fill_(1)
            raise ValueError("inside")
    assert twb._frame.words is None


# ---------------------------------------------------------------------------
# the card walk through the CUDA emulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_walk(tmp_path_factory):
    return twb._bind(emulated_build(tmp_path_factory, "traverse_wide.cu"))


@pytest.fixture
def emulated(card_walk, monkeypatch):
    """The card walk's entry points on CPU tensors: routed to _launch,
    through the emulated card build; returns the launch counts."""
    monkeypatch.setattr(twb, "_lib", card_walk)
    monkeypatch.setattr(twb, "_route", lambda o: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(profiling, "COUNTS",
                        dict.fromkeys(profiling.COUNTS, 0))
    return lambda: sum(profiling.counts(twb.LAUNCH).values())


def broken_trees():
    """A clustered mesh's tree with a one-slot stack, and with its leaf
    links out of range."""
    pack = pack_triangles([(clustered_mesh(3000, 17), 0)], device="cpu")
    bvh = twb.build_bvh4_sah(pack, width=4)[1]
    assert bvh.n_nodes > 1
    bad = dataclasses.replace(bvh, links=torch.where(
        bvh.links < 0, bvh.links - 10 ** 6, bvh.links))
    return {"stack overflow": dataclasses.replace(bvh, stack_depth=1),
            "bad link": bad}


@pytest.mark.parametrize("fault", ["stack overflow", "bad link"])
def test_card_walk_errors_raise_at_the_launch_outside_a_frame_and_at_its_end_inside(
        emulated, fault):
    tree = broken_trees()[fault]
    o, d, tmin, tmax = (torch.as_tensor(x) for x in rays(61, 256))
    with pytest.raises(RuntimeError, match=fault):
        twb.closest_hit_triangles(tree, o, d, tmin, tmax)
    assert emulated() == 1
    done = []
    with pytest.raises(RuntimeError, match=fault) as e:
        with twb.frame_errors():
            twb.closest_hit_triangles(tree, o, d, tmin, tmax)
            twb.any_hit_triangles(tree, o, d, tmin, tmax)
            done.append(True)
    assert done and emulated() == 3
    assert str(e.value).startswith("traverse_wide: ")
    assert profiling.counts("launch_error")["deferred"] == 2


def test_render_raises_a_walk_error_at_the_frames_end(emulated):
    """render_hdr over a tree whose walk overflows its stack: every
    launch of the frame joins the frame's word (launch_error.deferred
    counts them all), and the frame's end raises; over the sound tree
    it renders what the plain walk renders."""
    from cse168_raytracer_tpu_torch.ops.accel import attach_accel
    scene, static, cam = glass_scene("cpu")
    pack = pack_triangles([(clustered_mesh(3000, 17), 0)], device="cpu")
    scene = attach_accel(scene.replace(tris=pack))
    assert scene.accel.n_nodes > 1
    cfg = RenderConfig(width=16, height=16, trace_depth=1)
    hdr, _ = render_hdr(scene, static, cam, cfg)
    launches = emulated()
    assert launches >= 2
    assert profiling.counts("launch_error")["deferred"] == launches
    shallow = scene.replace(accel=dataclasses.replace(scene.accel,
                                                      stack_depth=1))
    with pytest.raises(RuntimeError, match="traverse_wide: stack overflow"):
        render_hdr(shallow, static, cam, cfg)
    assert emulated() == 2 * launches
    assert profiling.counts("launch_error")["deferred"] == 2 * launches
    with pytest.MonkeyPatch.context() as m:
        m.setattr(twb, "_route", lambda o: False)
        plain, _ = render_hdr(scene, static, cam, cfg)
    assert torch.equal(hdr, plain)


if __name__ == "__main__" and sys.argv[1:] == ["write"]:
    np.savez_compressed(STORED, **glass_frames())
