"""The port's scene registry against the JAX package's.

- Host arrays: every asset-free scene built by both registries is the
  same, byte for byte (tests/test_torch_host.py's
  test_registry_scene_arrays; here the asset scenes where the reference
  assets exist, and sponza from an OBJ).
- Renders at 16x16 of refract_spheres (stone texture and bump map,
  glass, depth 0), texture_plane (stem), cellular_plane, spiral and the
  sponza substitute: the JAX package's forward render against the
  port's, on the JAX scene carried over by interop.scene_from_numpy,
  and the port's own registry build, which must render the very same
  image. Bar: tests/test_golden.py's, on the sigmoid-tonemapped bytes:
  at least 99.9% within +-2 and a mean |difference| of at most 0.05.
  Pixel for pixel the HDR values differ by more than test_torch_render's
  rtol 1e-4 where the reference's formulas magnify an ulp: the bump map
  (a central difference with step 1e-4), the cellular texture's
  exp(-100 x) and the specular power 500 on spiral's spheres.
- spiral's kd gradient against jax.grad, over the pixels within rtol
  1e-4 (as tests/test_torch_render.py does), at rtol 1e-3: a pixel of
  its small spheres (radius down to 0.0019) is mostly the specular
  highlight, which hides in the pixel's bar a diffuse difference of a
  few 1e-4 that the kd gradient, diffuse alone, shows (worst measured
  4.4e-4).
- The asset scenes raise FileNotFoundError naming the missing file when
  the reference assets are absent (and match the JAX build where they
  are present); sponza's CSE168_SPONZA_OBJ rules; the command line."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)
from test_torch_host import assert_scene_equal  # noqa: E402
from test_torch_render import (TOL, jax_render_and_grad,  # noqa: E402
                               port_inputs, port_render_and_grad)

from cse168_raytracer_tpu.config import RenderConfig as JCfg  # noqa: E402
from cse168_raytracer_tpu.ops.accel import attach_accel as j_attach  # noqa: E402
from cse168_raytracer_tpu.render.integrator import \
    render_hdr as j_render  # noqa: E402
from cse168_raytracer_tpu.scenes import registry as jreg  # noqa: E402
from cse168_raytracer_tpu_torch import cli  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from cse168_raytracer_tpu_torch.render.tonemap import (  # noqa: E402
    sigmoid_tonemap, to_bytes)
from cse168_raytracer_tpu_torch.scenes import registry as preg  # noqa: E402

RES = 16
ASSET_FREE = ["cellular_plane", "refract_spheres", "spiral", "sponza",
              "texture_plane"]
ASSET_SCENES = ["bunny1", "bunny20", "cornell", "petal", "photon_cornell",
                "scene1", "sphere_texture", "teapot"]
DEPTH = {"refract_spheres": 0}      # JAX compiles each level: keep it short


@pytest.fixture(autouse=True)
def no_sponza_override(monkeypatch):
    monkeypatch.delenv("CSE168_SPONZA_OBJ", raising=False)


def builds(name, res=RES):
    jcfg = JCfg(width=res, height=res, trace_depth=DEPTH.get(name, 4))
    js, jst, jcam, _ = jreg.build(name, jcfg)
    cfg = RenderConfig(width=res, height=res,
                       trace_depth=DEPTH.get(name, 4))
    ps, pst, pcam, _ = preg.build(name, cfg, device="cpu")
    return (js, jst, jcam, jcfg), (ps, pst, pcam, cfg)


def golden_bar(ours, ref, what):
    a, b = (to_bytes(sigmoid_tonemap(torch.as_tensor(np.array(x)))).numpy()
            for x in (ours, ref))
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    close = np.isclose(ours, ref, **TOL).all(-1).mean()
    assert np.mean(diff <= 2) >= 0.999 and diff.mean() <= 0.05, (
        f"{what}: {np.mean(diff <= 2) * 100:.2f}% of bytes within +-2, "
        f"mean|diff| {diff.mean():.4f}, max {diff.max()}; {close * 100:.2f}% "
        "of pixels within rtol 1e-4")


def jax_render(js, jst, jcam, jcfg):
    js = j_attach(js)
    hdr, _ = jax.jit(lambda s: j_render(s, jst, jcam, jcfg,
                                        jax.random.key(0)))(js)
    return np.asarray(hdr)


@pytest.mark.parametrize("name", ASSET_FREE)
def test_scene_render_matches_jax(name):
    (js, jst, jcam, jcfg), (ps, pst, pcam, cfg) = builds(name)
    want = jax_render(js, jst, jcam, jcfg)
    cs, cst, ccam = port_inputs(js, jst, jcam)
    with torch.no_grad():
        carried = render_hdr(attach_accel(cs), cst, ccam, cfg)[0].numpy()
        own = render_hdr(attach_accel(ps), pst, pcam, cfg)[0].numpy()
    assert carried.shape == want.shape == (RES, RES, 3)
    assert np.isfinite(carried).all() and carried.max() > carried.min()
    assert np.array_equal(own, carried)
    golden_bar(carried, want, name)


def test_spiral_kd_gradient_matches_jax():
    (js, jst, jcam, _), _ = builds("spiral")
    jax_run = jax_render_and_grad(js, jst, jcam, RES)
    inputs = port_inputs(js, jst, jcam)
    jh, _ = jax_run(np.ones((RES, RES), np.float32))
    ph, _, _ = port_render_and_grad(*inputs, RES)
    close = np.isclose(ph, jh, **TOL).all(-1)
    assert close.mean() >= 0.95
    weight = close.astype(np.float32)
    _, jg = jax_run(weight)
    _, pg, _ = port_render_and_grad(*inputs, RES, weight)
    assert np.abs(pg).sum() > 0 and np.isfinite(pg).all()
    np.testing.assert_allclose(pg, jg, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("name", ASSET_SCENES)
def test_asset_scenes(name):
    """Without the reference assets: FileNotFoundError naming the file
    (as the JAX registry raises); with them: the JAX build's arrays."""
    try:
        jbuilt = jreg.build(name, JCfg(width=RES, height=RES))
    except FileNotFoundError as e:
        missing = str(e).split()[-1].strip("'\"")
        assert missing.startswith((jreg.REF_MODELS, jreg.REF_GFX))
        with pytest.raises(FileNotFoundError,
                           match=os.path.basename(missing)):
            preg.build(name, RenderConfig(width=RES, height=RES),
                       device="cpu")
        return
    ps, pst, pcam, _ = preg.build(name, RenderConfig(width=RES, height=RES),
                                  device="cpu")
    assert_scene_equal(*jbuilt[:3], ps, pst, pcam)


def test_registry_names_match_jax():
    assert list(preg.SCENES) == list(jreg.SCENES) and len(preg.SCENES) == 16


def test_sponza_obj_override(tmp_path, monkeypatch, capsys):
    """CSE168_SPONZA_OBJ wins; a missing explicit path raises; unset, the
    substitute is used with a note on stderr."""
    preg.build("sponza", device="cpu")
    assert "PROCEDURAL SUBSTITUTE" in capsys.readouterr().err
    monkeypatch.setenv("CSE168_SPONZA_OBJ", str(tmp_path / "none.obj"))
    with pytest.raises(FileNotFoundError, match="none.obj"):
        preg.build("sponza", device="cpu")
    path = tmp_path / "s.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 1\nf 1 2 3\nf 2 4 3\n")
    monkeypatch.setenv("CSE168_SPONZA_OBJ", str(path))
    (js, jst, jcam, _), (ps, pst, pcam, _) = builds("sponza")
    assert ps.tris.n_valid == 2
    assert_scene_equal(js, jst, jcam, ps, pst, pcam)


@pytest.mark.parametrize("name", ASSET_FREE)
def test_cli_renders_scene_on_cpu(name, tmp_path, capsys):
    argv = ["render", "--scene", name, "--device", "cpu", "--width", "16",
            "--height", "16", "--depth", "2", "--out",
            str(tmp_path / "x.ppm")]
    res = cli.render(cli.parser().parse_args(argv))
    hdr = res["hdr"]
    assert hdr.shape == (16, 16, 3) and torch.isfinite(hdr).all()
    assert hdr.max() > hdr.min()
    assert os.path.getsize(tmp_path / "x.ppm") > 0


def test_texture_constructors_default_to_the_card(monkeypatch):
    """The texture builders and the asset-free scenes, given no device,
    ask for the card and raise without one."""
    from cse168_raytracer_tpu_torch.models import textures
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pix = np.ones((4, 24, 3), np.float32)
    for make in (lambda **kw: textures.build_cellular_texture(10, 3, 3, **kw),
                 lambda **kw: textures.build_image_texture(pix, False, **kw),
                 lambda **kw: preg.build("texture_plane", **kw)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        make(device="cpu")
