"""The port's render_hdr and its kd gradient against the JAX package's.

Each scene is built by the JAX package and carried over with
cse168_raytracer_tpu_torch.interop, so both packages render the very
same inputs: the JAX package with its CPU accelerator, the port with
its wide BVH (whose traversal runs the plain twin on the CPU). Bar:
each pixel's three channels within rtol 1e-4 / atol 1e-5 on at least
99.9% of the pixels, and the kd gradient of the sum over the pixels
that meet it within rtol 1e-4."""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from chip_smoke import mixed_spec  # noqa: E402
from cse168_raytracer_tpu.config import RenderConfig as JCfg  # noqa: E402
from cse168_raytracer_tpu.ops.accel import attach_accel as j_attach  # noqa: E402
from cse168_raytracer_tpu.render.integrator import \
    render_hdr as j_render  # noqa: E402
from cse168_raytracer_tpu.scenes import build as j_build  # noqa: E402
from cse168_raytracer_tpu_torch import interop  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402

DEPTH = 4
TOL = dict(rtol=1e-4, atol=1e-5)


def jax_mixed_scene():
    """chip_smoke.mixed_spec() built by the JAX package: a procedural
    box mesh, a mirror and a refractive sphere, a checkered plane, two
    point lights."""
    from cse168_raytracer_tpu.models.geometry import (make_plane_pool,
                                                      make_sphere_pool,
                                                      pack_triangles)
    from cse168_raytracer_tpu.models.materials import MaterialBuilder
    from cse168_raytracer_tpu.models.scene import make_scene
    from cse168_raytracer_tpu.render.camera import make_camera
    spec = mixed_spec()
    mb = MaterialBuilder()
    for method, kw in spec["materials"]:
        getattr(mb, method)(**kw)
    scene, static = make_scene(
        tris=pack_triangles([(spec["mesh"], spec["mesh_material"])]),
        spheres=make_sphere_pool(*spec["spheres"]),
        planes=make_plane_pool(*spec["planes"]),
        materials=mb.build(), lights=spec["lights"])
    return scene, static, make_camera(**spec["camera"])


def jax_scene(name, res):
    if name == "mixed":
        scene, static, cam = jax_mixed_scene()
    else:
        scene, static, cam, _ = j_build(name, JCfg(width=res, height=res))
    return scene, static, cam


def port_inputs(scene, static, cam):
    ps, pst = interop.scene_from_numpy(jax.tree.map(np.asarray, scene),
                                       static, "cpu")
    return ps, pst, interop.camera_from_numpy(jax.tree.map(np.asarray, cam),
                                              "cpu")


def jax_render_and_grad(scene, static, cam, res):
    """A function of a per-pixel weight (res, res) returning the JAX
    package's HDR image and the kd gradient of sum(weight * hdr),
    compiled once."""
    cfg = JCfg(width=res, height=res, trace_depth=DEPTH)
    scene = j_attach(scene)

    def loss(kd, weight):
        s = scene.replace(materials=scene.materials._replace(kd=kd))
        hdr, _ = j_render(s, static, cam, cfg, jax.random.key(0))
        return (hdr * weight[..., None]).sum(), hdr

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))

    def run(weight):
        (_, hdr), grad = step(scene.materials.kd, weight)
        return np.asarray(hdr), np.asarray(grad)

    return run


def port_render_and_grad(scene, static, cam, res, weight=None):
    cfg = RenderConfig(width=res, height=res, trace_depth=DEPTH)
    scene = attach_accel(scene)
    kd = scene.materials.kd.clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(kd=kd))
    hdr, stats = render_hdr(s, static, cam, cfg)
    w = torch.ones((res, res)) if weight is None else torch.as_tensor(weight)
    (hdr * w[..., None]).sum().backward()
    return hdr.detach().numpy(), kd.grad.numpy(), stats


def assert_render_matches(scene, static, cam, res, min_lit=0.05):
    """The per-pixel bar on the image; then the kd gradient of the sum
    over the pixels that met it. A pixel that missed it sits where an ulp
    decides the outcome (a grazing hit at a sphere's silhouette, a shadow
    ray leaving a surface at its terminator): both packages are right
    there, and its whole value enters the gradient of a plain sum."""
    jax_run = jax_render_and_grad(scene, static, cam, res)
    jh, _ = jax_run(np.ones((res, res), np.float32))
    inputs = port_inputs(scene, static, cam)
    ph, _, stats = port_render_and_grad(*inputs, res)
    assert ph.shape == jh.shape == (res, res, 3)
    assert np.isfinite(ph).all()
    close = np.isclose(ph, jh, **TOL).all(-1)
    assert close.mean() >= 0.999, (close.mean(), np.argwhere(~close)[:5])
    assert (ph.max(-1) > 0).mean() >= min_lit
    weight = close.astype(np.float32)
    _, jg = jax_run(weight)
    _, pg, _ = port_render_and_grad(*inputs, res, weight)
    assert np.isfinite(pg).all()
    np.testing.assert_allclose(pg, jg, rtol=1e-4, atol=1e-6)
    return ph, pg, stats


def test_render_sphere():
    scene, static, cam = jax_scene("sphere", 32)
    _, grad, stats = assert_render_matches(scene, static, cam, 32)
    assert int(stats.secondary_rays) == 0 and np.abs(grad).sum() > 0


def test_render_mixed_scene():
    """Mirror and refractive children, their compaction, and closest-hit
    shadow rays whose refractive occluders attenuate."""
    scene, static, cam = jax_scene("mixed", 32)
    assert static.any_refractive and static.any_reflective
    _, grad, stats = assert_render_matches(scene, static, cam, 32)
    assert int(stats.secondary_rays) > 0 and int(stats.dropped_rays) == 0
    assert np.abs(grad).sum() > 0


@pytest.mark.parametrize("light", ["registered", "lit"])
def test_render_sponza_proxy(light):
    """The benchmark's scene at 16x16: as registered its light sits above
    the closed ceiling and every shadow ray is occluded (a black image);
    lit, with the light moved inside the atrium as chip_smoke.py does,
    the image and its kd gradient carry signal."""
    from chip_smoke import LIT_LIGHT
    from cse168_raytracer_tpu.models.lights import make_light_table
    scene, static, cam = jax_scene("sponza_proxy", 16)
    if light == "lit":
        scene = scene.replace(lights=make_light_table(
            [dict(kind=0, position=LIT_LIGHT, color=(1, 1, 1),
                  wattage=200.0)]))
    ph, grad, stats = assert_render_matches(
        scene, static, cam, 16, min_lit=0.0 if light == "registered" else 0.05)
    assert int(stats.shadow_rays) == 16 * 16
    assert (ph.max() > 0) == (light == "lit")
    assert (np.abs(grad).sum() > 0) == (light == "lit")


def test_port_mixed_scene_matches_jax_build():
    """chip_smoke's mixed scene, built by the port, holds the arrays the
    JAX package builds from the same spec."""
    from chip_smoke import mixed_scene
    js, jst, jcam = jax_mixed_scene()
    ts, tst, tcam = mixed_scene("cpu")
    cs, cst, ccam = port_inputs(js, jst, jcam)
    assert tst == cst
    for pool in ("tris", "spheres", "planes", "materials", "lights"):
        a, b = getattr(ts, pool), getattr(cs, pool)
        for f in vars(a):
            x, y = getattr(a, f), getattr(b, f)
            if torch.is_tensor(x):
                assert torch.equal(x, y), f"{pool}.{f}"
    for f in ("eye", "up", "fov"):
        assert torch.equal(getattr(tcam, f), getattr(ccam, f)), f
    torch.testing.assert_close(tcam.view_dir, ccam.view_dir, rtol=0,
                               atol=1e-6)


def test_port_imports_no_jax():
    """Importing every module of the port pulls in neither jax nor the
    JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import cse168_raytracer_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'flax' or m.startswith('cse168_raytracer_tpu.')"
        " or m == 'cse168_raytracer_tpu']\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20
