"""Ray casts skip a sphere or plane pool that holds no valid primitive.

A pool built with a host-known n_valid of 0 (make_scene's empty pools)
is never scanned: no pass of scene_closest_hit / scene_any_hit /
closest_hit runs over it, and make_surface leaves its branch out. A pool
whose n_valid is None (unknown) is scanned as every pool was before.
Each scene is rendered twice on the CPU at 32 x 32, as built and with
each pool's n_valid set to None (the dense path), and the two must give
the same bits (torch.equal): a Whitted render's image and the kd and v0
gradients of sum(hdr), and a 2-sample path-traced thin-lens image.
Scenes: lit sponza_proxy and chip_smoke.photon_box (no sphere, no
plane), and registry scenes with spheres only (sphere), a plane only
(texture_plane) and both (test_sphere, refract_spheres), two of them
also by brute force (no tree). Also the counters pool.skipped.<kind> /
pool.scanned.<kind>, and n_valid as the registry and
interop.scene_from_numpy set it. tests/test_torch_cuda.py holds the
same equality on the card; this module imports no jax at its top, so
that file can share its helpers.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)
from chip_smoke import lit_sponza, photon_box  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from cse168_raytracer_tpu_torch.scenes import build  # noqa: E402
from cse168_raytracer_tpu_torch.utils import profiling  # noqa: E402

RES = 32
SCENES = ["sponza_proxy", "photon_box", "sphere", "texture_plane",
          "test_sphere", "refract_spheres"]
ASSET_FREE = ["sphere", "test_sphere", "sponza_proxy", "refract_spheres",
              "texture_plane", "cellular_plane", "spiral", "sponza"]


def scene_case(name, device, res=RES, tree=True):
    """(Scene, SceneStatic, Camera, RenderConfig) of a case at res x res:
    sponza_proxy lit below its ceiling at depth 4 (the benchmark's
    sponza_proxy_lit), photon_box at depth 10, or a registry scene as
    registered; with its tree unless tree is False."""
    if name == "sponza_proxy":
        scene, static, cam, cfg = build(
            name, RenderConfig(width=res, height=res, trace_depth=4),
            device=device)
        scene = lit_sponza(scene)
    elif name == "photon_box":
        scene, static, cam = photon_box(device)
        cfg = RenderConfig(width=res, height=res, trace_depth=10)
    else:
        scene, static, cam, cfg = build(
            name, RenderConfig(width=res, height=res), device=device)
    return (attach_accel(scene) if tree else scene), static, cam, cfg


def dense(scene):
    """The scene with each pool's n_valid unknown: every pool scanned."""
    return scene.replace(
        spheres=dataclasses.replace(scene.spheres, n_valid=None),
        planes=dataclasses.replace(scene.planes, n_valid=None))


def render(scene, static, cam, cfg, mode):
    """The outputs a mode holds: "fit" the Whitted image and the kd and
    v0 gradients of sum(hdr) (None where v0 gets none), "whitted" the
    Whitted image, "pt_dof" the image of a 2-sample path-traced
    thin-lens render from a generator seeded 5."""
    if mode == "fit":
        kd = scene.materials.kd.detach().clone().requires_grad_(True)
        v0 = scene.tris.v0.detach().clone().requires_grad_(True)
        s = scene.replace(materials=scene.materials.replace(kd=kd),
                          tris=scene.tris.replace(v0=v0))
        hdr = render_hdr(s, static, cam, cfg)[0]
        hdr.sum().backward()
        return hdr.detach(), kd.grad, v0.grad
    gen = None
    if mode == "pt_dof":
        cfg = cfg.replace(path_tracing=True, dof=True, trace_samples=2)
        gen = torch.Generator(device=scene.device).manual_seed(5)
    with torch.no_grad():
        return (render_hdr(scene, static, cam, cfg, gen)[0],)


def assert_same_bits(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert float(want[0].max()) > 0


@pytest.mark.parametrize("name,mode,tree", [
    *((n, m, True) for n in SCENES for m in ("fit", "pt_dof")),
    ("sphere", "fit", False), ("texture_plane", "fit", False)])
def test_skipped_pools_give_the_dense_bits(name, mode, tree):
    scene, static, cam, cfg = scene_case(name, "cpu", tree=tree)
    assert_same_bits(render(scene, static, cam, cfg, mode),
                     render(dense(scene), static, cam, cfg, mode))


@pytest.mark.parametrize("name,moved", [
    ("sponza_proxy", {"pool.skipped.spheres", "pool.skipped.planes"}),
    ("sphere", {"pool.scanned.spheres", "pool.skipped.planes"}),
    ("texture_plane", {"pool.skipped.spheres", "pool.scanned.planes"}),
    ("test_sphere", {"pool.scanned.spheres", "pool.scanned.planes"})])
def test_pool_counters_count_the_passes(name, moved):
    """A render counts a pass over each pool it scans and each it skips;
    the dense path scans every pool."""
    scene, static, cam, cfg = scene_case(name, "cpu", res=8)
    for s, want in ((scene, moved),
                    (dense(scene), {"pool.scanned.spheres",
                                    "pool.scanned.planes"})):
        with profiling.recording() as sink:
            render(s, static, cam, cfg, "whitted")
        pool = {k: v for k, v in sink.counts.items()
                if k.startswith("pool.")}
        assert set(pool) == want and min(pool.values()) > 0


@pytest.mark.parametrize("name", ASSET_FREE)
def test_n_valid_counts_the_valid_rows(name):
    """n_valid of the registry's pools, and of the pools and pack that
    interop carries over from the JAX package's scene, is the count of
    valid rows."""
    import jax
    from cse168_raytracer_tpu.config import RenderConfig as JCfg
    from cse168_raytracer_tpu.scenes import build as jbuild
    from cse168_raytracer_tpu_torch import interop
    ts = build(name, RenderConfig(width=8, height=8), device="cpu")[0]
    js, jst, _, _ = jbuild(name, JCfg(width=8, height=8))
    ps = interop.scene_from_numpy(jax.tree.map(np.asarray, js), jst,
                                  "cpu")[0]
    for pool in (ts.spheres, ts.planes, ps.spheres, ps.planes, ps.tris):
        assert pool.n_valid == int(pool.valid.sum())
