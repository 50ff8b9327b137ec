"""The port's sampled renders against the JAX package's, statistically,
and the path-traced kd gradient against finite differences.

PyTorch cannot replay jax.random, so the sampled renders (path tracing,
the thin lens, square-light NEE) are compared as tools/golden_tpu.py
compares its path-traced cases: the sigmoid-tonemapped images, in
0..255 units, averaged over 8x8 pixel blocks; the port's block RMS
against the JAX render of seed 0 must be within 3x the RMS between the
JAX renders of seeds 0 and 1 (the estimator's own noise) plus 1/255.
Each scene is built by the JAX package and carried over with
cse168_raytracer_tpu_torch.interop, so both render the same inputs."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from cse168_raytracer_tpu.config import RenderConfig as JCfg  # noqa: E402
from cse168_raytracer_tpu.models.lights import \
    make_light_table as j_lights  # noqa: E402
from cse168_raytracer_tpu.ops.accel import attach_accel as j_attach  # noqa: E402
from cse168_raytracer_tpu.render.integrator import \
    render_hdr as j_render  # noqa: E402
from cse168_raytracer_tpu.scenes import build as j_build  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from test_torch_render import jax_mixed_scene, port_inputs  # noqa: E402

RES = 32
SQUARE_LIGHT = [dict(kind=1, position=(-3, 6, 3), normal=(0.3, -1, -0.2),
                     dims=(3.0, 2.0), color=(1, 1, 1), wattage=500.0)]


def blocks(hdr):
    """8x8 block means of the sigmoid tonemap, in 0..255 units."""
    img = 255.0 / (1.0 + np.exp(-(6.0 * np.asarray(hdr, np.float64) - 3.0)))
    h, w, _ = img.shape
    return img.reshape(h // 8, 8, w // 8, 8, 3).mean(axis=(1, 3))


def rms(a, b):
    return float(np.sqrt(np.mean((a - b) ** 2)))


def compare(js, jst, jcam, **cfg_kw):
    """JAX renders of seeds 0 and 1 and the port's render (its tree
    attached, counters on) of one configuration. Returns (port block
    RMS vs JAX seed 0, tolerance, port HDR, port stats)."""
    cfg = JCfg(width=RES, height=RES, **cfg_kw)
    jsa = j_attach(js)
    run = jax.jit(j_render, static_argnames=("static", "cfg"))
    ja = blocks(run(jsa, jst, jcam, cfg, jax.random.key(0))[0])
    jb = blocks(run(jsa, jst, jcam, cfg, jax.random.key(1))[0])
    ps, pst, pcam = port_inputs(js, jst, jcam)
    pcfg = RenderConfig(width=RES, height=RES, collect_stats=True, **cfg_kw)
    with torch.no_grad():
        hdr, stats = render_hdr(attach_accel(ps), pst, pcam, pcfg)
    assert torch.isfinite(hdr).all()
    err, tol = rms(blocks(hdr.numpy()), ja), 3.0 * rms(ja, jb) + 1.0
    assert err <= tol, (err, tol)
    return err, tol, hdr, stats


def test_path_traced_test_sphere():
    """test_sphere's mirror sphere (ks 1, shininess 10) under path
    tracing: each child ray leaves through the glossy Phong lobe."""
    js, jst, jcam, _ = j_build("test_sphere", JCfg(width=RES, height=RES))
    err, tol, hdr, stats = compare(js, jst, jcam, path_tracing=True,
                                   trace_samples=32, trace_depth=4)
    assert int(stats.primary_rays) == RES * RES * 32
    assert int(stats.secondary_rays) > 0
    # the bar tells the lobe apart: the Whitted render misses it
    ps, pst, pcam = port_inputs(js, jst, jcam)
    with torch.no_grad():
        whitted, _ = render_hdr(ps, pst, pcam, RenderConfig(
            width=RES, height=RES, trace_depth=4))
    assert rms(blocks(whitted.numpy()), blocks(hdr.numpy())) > tol


def test_thin_lens_triangle_scene():
    """The thin lens over chip_smoke's mixed scene (a box mesh in the
    tree, a mirror and a glass sphere, a checkered plane): the port walks
    its tree with the plain walk on the CPU, counters on."""
    js, jst, jcam = jax_mixed_scene()
    _, _, _, stats = compare(js, jst, jcam, dof=True, trace_samples=32,
                             trace_depth=4)
    assert int(stats.box_tests) > 0 and int(stats.tri_tests) > 0


def test_square_light_samples():
    """A square light sampled 4 times per shading point (stratified
    cells), in the deterministic Whitted render."""
    js, jst, jcam, _ = j_build("sphere", JCfg(width=RES, height=RES))
    js = js.replace(lights=j_lights(SQUARE_LIGHT))
    _, _, _, stats = compare(js, jst, jcam, light_samples=4, trace_depth=4)
    assert int(stats.shadow_rays) > 0


def test_path_traced_kd_gradient_matches_finite_differences():
    """kd gradient of the path-traced render, the generator reseeded for
    every evaluation so that the render is a function of kd alone,
    against central differences (as tests/test_grad_oracle.py): kd moves
    no discrete choice, and it enters the image as kd^2 (the reference's
    quirk), so the differences are exact up to float32 rounding."""
    js, jst, jcam, _ = j_build("test_sphere", JCfg(width=12, height=12))
    ps, pst, pcam = port_inputs(js, jst, jcam)
    cfg = RenderConfig(width=12, height=12, trace_depth=2, path_tracing=True,
                       trace_samples=4, seed=3)

    def loss(kd):
        s = ps.replace(materials=ps.materials.replace(kd=kd))
        return render_hdr(s, pst, pcam, cfg)[0].sum()

    kd0 = ps.materials.kd.clone()
    kd = kd0.clone().requires_grad_(True)
    loss(kd).backward()
    eps = 1e-2
    fd = torch.zeros_like(kd0, dtype=torch.float64)
    with torch.no_grad():
        for i in np.ndindex(*kd0.shape):
            up, dn = kd0.clone(), kd0.clone()
            up[i] += eps
            dn[i] -= eps
            fd[i] = (float(loss(up)) - float(loss(dn))) / (2 * eps)
    assert fd.abs().max() > 1.0
    np.testing.assert_allclose(kd.grad.numpy(), fd.numpy(), rtol=1e-2,
                               atol=1e-2)
