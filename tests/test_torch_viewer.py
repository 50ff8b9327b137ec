"""The port's interactive viewer (render/viewer.py) against the JAX
package's, driven headless: tests/test_viewer.py's three cases, the
camera after the same keys and drags in both viewers (atol 1e-5), and
rotate_about_axis against the JAX function."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from cse168_raytracer_tpu.config import RenderConfig as JCfg  # noqa: E402
from cse168_raytracer_tpu.core import vecmath as jvm  # noqa: E402
from cse168_raytracer_tpu.ops.accel import attach_accel as j_attach  # noqa: E402
from cse168_raytracer_tpu.render.viewer import \
    InteractiveViewer as JViewer  # noqa: E402
from cse168_raytracer_tpu.scenes import build as j_build  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.core.vecmath import \
    rotate_about_axis  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render import viewer as tviewer  # noqa: E402
from cse168_raytracer_tpu_torch.scenes import build  # noqa: E402


def _viewer():
    cfg = RenderConfig(width=32, height=32, trace_depth=2)
    scene, static, cam, cfg = build("sphere", cfg, device="cpu")
    return tviewer.InteractiveViewer(attach_accel(scene), static, cam, cfg)


def test_keys_move_camera_like_miro():
    """MiroWindow::keyboard camera moves (MiroWindow.cpp:214-245)."""
    v = _viewer()
    eye0 = v.state.cam.eye.numpy()
    vd = v.state.cam.view_dir.numpy()
    assert v.handle_key("w")
    np.testing.assert_allclose(v.state.cam.eye.numpy(), eye0 + vd, atol=1e-6)
    assert v.handle_key("s")
    np.testing.assert_allclose(v.state.cam.eye.numpy(), eye0, atol=1e-6)
    v.handle_key("+")
    v.handle_key("w")
    np.testing.assert_allclose(v.state.cam.eye.numpy(), eye0 + 1.5 * vd,
                               atol=1e-6)
    right = np.cross(vd, v.state.cam.up.numpy())
    eye1 = v.state.cam.eye.numpy()
    v.handle_key("d")
    np.testing.assert_allclose(v.state.cam.eye.numpy(), eye1 + 1.5 * right,
                               atol=1e-5)
    assert not v.handle_key("escape")


def test_drag_orbit_preserves_unit_view_dir():
    """MiroWindow::motion orbit (MiroWindow.cpp:91-115)."""
    v = _viewer()
    vd0 = v.state.cam.view_dir.numpy()
    v.handle_drag(30.0, -12.0)
    vd1 = v.state.cam.view_dir.numpy()
    assert abs(np.linalg.norm(vd1) - 1.0) < 1e-5
    assert not np.allclose(vd0, vd1)
    assert float(vd0 @ vd1) > 0.5


def test_preview_and_raytrace_frames(tmp_path, monkeypatch):
    """Camera::click's two modes (Camera.cpp:37-70): full-size uint8
    frames from both renderers, the preview a 4x4-repeated 16x16
    render; 'i' writes one PPM."""
    v = _viewer()
    f_preview = v.render_frame()
    assert f_preview.shape == (32, 32, 3) and f_preview.dtype == np.uint8
    assert (f_preview == np.repeat(np.repeat(f_preview[::4, ::4], 4, 0), 4,
                                   1)).all()
    v.handle_key("r")
    f_full = v.render_frame()
    assert f_full.shape == (32, 32, 3) and f_full.any()
    monkeypatch.chdir(tmp_path)
    v.handle_key("i")
    assert len([p for p in os.listdir(".") if p.endswith(".ppm")]) == 1
    v.handle_key("g")
    assert not v.state.raytrace


def test_camera_moves_match_jax_viewer(capsys):
    """The same keys and drags in both viewers leave the same camera and
    scale (atol 1e-5), the unnormalized right vector included."""
    jcfg = JCfg(width=32, height=32, trace_depth=2)
    js, jst, jcam, jcfg = j_build("sphere", jcfg)
    jv = JViewer(j_attach(js), jst, jcam, jcfg)
    v = _viewer()
    script = ["w", "+", "d", ("drag", 30.0, -12.0), "a", "q", "-", "-", "z",
              "W", "S", ("drag", -5.0, 7.5), "D", "m", "x", "A",
              ("drag", 0.0, 20.0), "Q", "Z"]
    for step in script:
        for viewer in (jv, v):
            if isinstance(step, tuple):
                viewer.handle_drag(*step[1:])
            else:
                assert viewer.handle_key(step)
        for f in ("eye", "view_dir", "up"):
            np.testing.assert_allclose(getattr(v.state.cam, f).numpy(),
                                       np.asarray(getattr(jv.state.cam, f)),
                                       atol=1e-5, err_msg=f"{step} {f}")
        assert v.state.scale_fact == jv.state.scale_fact
    out = capsys.readouterr().out
    assert out.count("Eye:") == 2 and out.count("ViewDir:") == 2


@pytest.mark.parametrize("theta", [0.0, 0.3, -1.2, np.pi, 5.0])
def test_rotate_about_axis_matches_jax(theta):
    rng = np.random.default_rng(int(abs(theta) * 10))
    v = rng.normal(size=(64, 3)).astype(np.float32)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    ours = rotate_about_axis(torch.as_tensor(v), theta, torch.as_tensor(w))
    ref = jvm.rotate_about_axis(jnp.asarray(v), theta, jnp.asarray(w))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(ours.numpy(), axis=1),
                               np.linalg.norm(v, axis=1), rtol=1e-5)


def test_main_loop_without_matplotlib_raises(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.startswith("matplotlib"):
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib"):
        _viewer().main_loop()
