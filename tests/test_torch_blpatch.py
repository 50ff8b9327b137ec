"""The port's bilinear patches against the JAX package's.

`intersect_blpatches` and `_blpatch_surface` take the same numpy inputs
in both packages (hits and ids equal, t, P, N and UV within rtol 1e-5);
tests/test_blpatch.py's three cases run on the port; scenes of patches,
a small mesh (through the wide BVH's plain walk), a sphere and a plane
are built by the JAX package, carried over by interop and rendered by
both at 16x16, depth 2, held to tests/test_golden.py's bar, with their
gradients w.r.t. kd and a patch corner against jax.grad at rtol 1e-3."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from chip_smoke import box_mesh  # noqa: E402
from cse168_raytracer_tpu.config import RenderConfig as JCfg  # noqa: E402
from cse168_raytracer_tpu.models import geometry as jg  # noqa: E402
from cse168_raytracer_tpu.models.lights import LIGHT_POINT  # noqa: E402
from cse168_raytracer_tpu.models.materials import \
    MaterialBuilder as JMB  # noqa: E402
from cse168_raytracer_tpu.models.scene import make_scene as j_scene  # noqa: E402
from cse168_raytracer_tpu.ops import intersect as ji  # noqa: E402
from cse168_raytracer_tpu.ops import surface as jsu  # noqa: E402
from cse168_raytracer_tpu.ops.accel import attach_accel as j_attach  # noqa: E402
from cse168_raytracer_tpu.render.camera import \
    make_camera as j_camera  # noqa: E402
from cse168_raytracer_tpu.render.integrator import \
    render_hdr as j_render  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.models import geometry as tg  # noqa: E402
from cse168_raytracer_tpu_torch.models.materials import \
    MaterialBuilder  # noqa: E402
from cse168_raytracer_tpu_torch.models.scene import make_scene  # noqa: E402
from cse168_raytracer_tpu_torch.ops import intersect as ti  # noqa: E402
from cse168_raytracer_tpu_torch.ops import surface as tsu  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render.camera import make_camera  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from cse168_raytracer_tpu_torch.render.tonemap import (  # noqa: E402
    sigmoid_tonemap, to_bytes)
from test_torch_render import port_inputs  # noqa: E402

RTOL = 1e-5
RES = 16

# corners (p00, p10, p01, p11) of four patches per case
PATCHES = {
    "flat": [((0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 0, 1)),
             ((-1, 0.5, -1), (0.5, 0.5, -1), (-1, 0.5, 0.5), (0.5, 0.5, 0.5)),
             ((0, -1, 0), (2, -1, 0), (0, -1, 2), (2, -1, 2)),
             ((-2, 0, 0), (-1, 0, 0), (-2, 0, 1), (-1, 0, 1))],
    "curved": [((0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 1, 1)),
               ((-1, 0, -1), (1, 0.3, -1), (-1, 0.3, 1), (1, -0.6, 1)),
               ((0, -1, 0), (2, -0.5, 0), (0, -1, 2), (2, 0.5, 2)),
               ((-2, 0.2, 0), (-1, 0, 0), (-2, 0, 1), (-1, 0.7, 1))],
    "twisted": [((0, 0, 0), (1, 0.4, 0), (0, 0.4, 1), (1.3, -0.5, 1.2)),
                ((-1, -0.5, -1), (1, 0.5, -1.2), (-1.1, 0.5, 1), (1, -0.5, 1)),
                ((0.5, -1, -0.5), (2, 0, 0), (0, 0, 2), (2, -1, 2.5)),
                ((-2, 0, 0), (-1, 1, 0.2), (-2.2, 1, 1), (-1, 0, 1))],
    # A = p11 - p10 - p01 + p00 of 1e-13 to 4e-13 (representable on the
    # y = 0 plane): |qa| < 1e-12, the linear branch with its -1 sentinel
    # root. (An A of an ulp of 1 would make the quadratic's roots chaotic:
    # JAX's own jit and eager results differ there.)
    "near_linear": [((0, 0, 0), (1, 0, 0), (0, 0, 1), (1, 1e-13, 1)),
                    ((-1.5, 0, -1), (-0.2, 0, -1), (-1.5, 0, 0.5),
                     (-0.2, -2e-13, 0.5)),
                    ((0.2, 0, -1.2), (2, 0, -1.2), (0.2, 0, -0.1),
                     (2, 4e-13, -0.1)),
                    ((-2, 0, 1.2), (-0.5, 0, 1.2), (-2, 0, 2.5),
                     (-0.5, 3e-13, 2.5))],
}


def pools(case):
    corners = np.asarray(PATCHES[case], np.float32)      # (4, 4, 3)
    args = [corners[:, i] for i in range(4)] + [[0, 1, 2, 3]]
    return jg.make_blpatch_pool(*args), tg.make_blpatch_pool(*args,
                                                             device="cpu")


def random_rays(n, seed):
    """Rays from above the patches aimed down at a random point of the
    [-2.5, 2.5] x [-1.5, 3] square, some with a tmax that cuts them."""
    rng = np.random.default_rng(seed)
    o = rng.uniform([-2, 1.5, -1.5], [2.5, 4, 3], (n, 3)).astype(np.float32)
    aim = rng.uniform([-2.5, -1, -1.5], [2.5, 0.5, 3], (n, 3))
    d = (aim - o) / np.linalg.norm(aim - o, axis=1, keepdims=True)
    tmax = np.where(rng.uniform(size=n) < 0.2, rng.uniform(0.5, 3, n),
                    1e12).astype(np.float32)
    return o, d.astype(np.float32), tmax


def parallel_rays():
    """Rays parallel to the flat patches, in their planes and beside
    them."""
    o = np.asarray([[-3, 0, 0.5], [0.5, 0, -3], [-3, 0.5, 0], [-3, 0.25, 0.5],
                    [-3, -1, 1], [0.5, 0.5, -3]], np.float32)
    d = np.asarray([[1, 0, 0], [0, 0, 1], [1, 0, 0], [1, 0, 0], [1, 0, 0],
                    [0, 0, 1]], np.float32)
    return o, d, np.full(6, 1e12, np.float32)


def both_hits(case, o, d, tmax):
    jpool, tpool = pools(case)
    jh = jax.jit(lambda o, d, tm: ji.intersect_blpatches(jpool, o, d, 0.0, tm)
                 )(jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax))
    th = ti.intersect_blpatches(tpool, torch.as_tensor(o),
                                torch.as_tensor(d), 0.0,
                                torch.as_tensor(tmax))
    return jpool, tpool, jh, th


def assert_hits_equal(jh, th):
    hit = np.asarray(jh.hit)
    np.testing.assert_array_equal(th.hit.numpy(), hit)
    np.testing.assert_array_equal(th.prim_type.numpy(),
                                  np.asarray(jh.prim_type))
    np.testing.assert_array_equal(th.prim_id.numpy()[hit],
                                  np.asarray(jh.prim_id)[hit])
    np.testing.assert_allclose(th.t.numpy(), np.asarray(jh.t), rtol=RTOL)
    return hit


@pytest.mark.parametrize("case", sorted(PATCHES))
def test_intersect_matches_jax(case):
    o, d, tmax = random_rays(512, seed=len(case))
    _, _, jh, th = both_hits(case, o, d, tmax)
    hit = assert_hits_equal(jh, th)
    assert 0.05 < hit.mean() < 0.95
    assert (th.prim_type.numpy()[hit] == ti.PRIM_BLPATCH).all()
    assert len(np.unique(th.prim_id.numpy()[hit])) >= 2


@pytest.mark.parametrize("case", ["flat", "near_linear"])
def test_intersect_parallel_rays_match_jax(case):
    _, _, jh, th = both_hits(case, *parallel_rays())
    assert_hits_equal(jh, th)


@pytest.mark.parametrize("case", ["curved", "twisted", "near_linear"])
def test_surface_matches_jax(case):
    """(P, N, geometric N, UV, material) of the winners, from JAX's t."""
    o, d, tmax = random_rays(512, seed=7)
    jpool, tpool, jh, _ = both_hits(case, o, d, tmax)
    hit = np.asarray(jh.hit)
    t = np.where(hit, np.asarray(jh.t), 1.0).astype(np.float32)
    ids = np.where(hit, np.asarray(jh.prim_id), 0).astype(np.int32)
    js = jax.jit(jsu._blpatch_surface, static_argnums=())(
        jpool, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
        jnp.asarray(ids))
    ts = tsu._blpatch_surface(tpool, torch.as_tensor(o), torch.as_tensor(d),
                              torch.as_tensor(t), torch.as_tensor(ids))
    for a, b in zip(ts[:4], js[:4]):
        np.testing.assert_allclose(a.numpy()[hit], np.asarray(b)[hit],
                                   rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(ts[4].numpy(), np.asarray(js[4]))


# ---------------------------------------------------------------------------
# tests/test_blpatch.py's cases on the port
# ---------------------------------------------------------------------------

def _flat_patch():
    return tg.make_blpatch_pool(p00=(0, 0, 0), p10=(1, 0, 0), p01=(0, 0, 1),
                                p11=(1, 0, 1), material_ids=0, device="cpu")


def test_flat_patch_hit_and_uv():
    pool = _flat_patch()
    o = torch.tensor([[0.25, 2.0, 0.75], [0.5, 1.0, 0.5], [2.0, 1.0, 2.0]])
    d = torch.tensor([0.0, -1.0, 0.0]).expand(3, 3)
    h = ti.intersect_blpatches(pool, o, d, 0.0, 1e12)
    assert h.hit.tolist() == [True, True, False]
    np.testing.assert_allclose(h.t.numpy()[:2], [2.0, 1.0], rtol=1e-5)
    assert int(h.prim_type[0]) == ti.PRIM_BLPATCH
    p, n, gn, uv, mid = tsu._blpatch_surface(pool, o, d, h.t,
                                             torch.zeros(3, dtype=torch.int32))
    np.testing.assert_allclose(uv.numpy()[0], [0.25, 0.75], atol=1e-4)
    nn = n.numpy()[0] / np.linalg.norm(n.numpy()[0])
    np.testing.assert_allclose(nn, [0, -1, 0], atol=1e-5)


def test_curved_patch_point_on_surface():
    pool = tg.make_blpatch_pool(p00=(0, 0, 0), p10=(1, 0, 0), p01=(0, 0, 1),
                                p11=(1, 1, 1), material_ids=0, device="cpu")
    rng = np.random.RandomState(0)
    o = torch.as_tensor((rng.uniform(0.1, 0.9, (32, 3)).astype(np.float32)
                         * np.array([1, 0, 1]) + np.array([0, 3.0, 0]))
                        .astype(np.float32))
    d = torch.tensor([0.0, -1.0, 0.0]).expand(32, 3)
    h = ti.intersect_blpatches(pool, o, d, 0.0, 1e12)
    assert bool(h.hit.all())
    p, n, gn, uv, mid = tsu._blpatch_surface(
        pool, o, d, h.t, torch.zeros(32, dtype=torch.int32))
    uv, pp = uv.numpy(), p.numpy()
    np.testing.assert_allclose(pp[:, 1], uv[:, 0] * uv[:, 1], atol=1e-4)
    np.testing.assert_allclose(pp[:, 0], uv[:, 0], atol=1e-4)
    np.testing.assert_allclose(pp[:, 2], uv[:, 1], atol=1e-4)


def test_patch_in_scene_render():
    """A bilinear patch renders through the whole pipeline, built by the
    port's own constructors."""
    mb = MaterialBuilder()
    m = mb.phong(kd=(1, 1, 1))
    pool = tg.make_blpatch_pool(p00=(-2, 0, -2), p10=(-2, 0, 2),
                                p01=(2, 0, -2), p11=(2, 1.5, 2),
                                material_ids=m, device="cpu")
    scene, static = make_scene(materials=mb.build("cpu"), blpatches=pool,
                               lights=[dict(kind=LIGHT_POINT,
                                            position=(0, 5, 0),
                                            color=(1, 1, 1), wattage=500.0)],
                               device="cpu")
    cam = make_camera(eye=(0, 4, 6), look_at=(0, 0, 0), fov=45, device="cpu")
    hdr, _ = render_hdr(scene, static, cam,
                        RenderConfig(width=16, height=16, trace_depth=1))
    assert torch.isfinite(hdr).all() and hdr.max() > 0


# ---------------------------------------------------------------------------
# scenes: patches with a mesh, a sphere and a plane
# ---------------------------------------------------------------------------

def jax_patch_scene(refractive: bool):
    """Two curved patches (one a mirror) above a checkered plane, a box
    mesh, and a sphere (glass when `refractive`, so shadow rays take the
    closest-hit path; else diffuse, and they take the any-hit path); a
    point light above the patches, which shadow the plane."""
    mb = JMB()
    white = mb.phong(kd=(0.8, 0.8, 0.8))
    patch = mb.phong(kd=(0.2, 0.6, 0.9), ks=(0.1, 0.1, 0.1), shininess=20.0)
    mirror = mb.phong(kd=(0.1, 0.1, 0.1), ks=(0.6, 0.6, 0.6))
    ball = (mb.phong(kd=(0, 0, 0), kt=(1, 1, 1), ior=1.5) if refractive
            else mb.phong(kd=(0.9, 0.3, 0.2)))
    box = mb.phong(kd=(0.3, 0.9, 0.3))
    corners = np.asarray([((-1.5, 1.0, -1.0), (0.5, 1.2, -1.0),
                           (-1.5, 1.1, 1.0), (0.5, 2.0, 1.0)),
                          ((0.8, 0.3, -1.8), (2.2, 0.6, -1.8),
                           (0.8, 1.6, -0.8), (2.2, 1.2, -0.6))], np.float32)
    pool = jg.make_blpatch_pool(*(corners[:, i] for i in range(4)),
                                [patch, mirror])
    mesh = box_mesh([(-1.8, 0.4, 1.6, 0.8, 0.8, 0.8)])
    scene, static = j_scene(
        tris=jg.pack_triangles([(mesh, box)]),
        spheres=jg.make_sphere_pool([(1.4, 0.6, 1.2)], [0.6], [ball]),
        planes=jg.make_plane_pool([(0, 0, 0)], [(0, 1, 0)], [white]),
        materials=mb.build(), blpatches=pool,
        lights=[dict(kind=LIGHT_POINT, position=(-0.2, 5.0, 0.3),
                     color=(1, 1, 1), wattage=300.0)])
    cam = j_camera(eye=(0.5, 4.0, 6.0), look_at=(0, 0.6, 0), fov=50)
    return scene, static, cam


def jax_render_and_grads(scene, static, cam):
    """JAX's image and the gradients of its sum w.r.t. kd and the
    patches' p11, with the JAX package's own accelerator."""
    cfg = JCfg(width=RES, height=RES, trace_depth=2)
    scene = j_attach(scene)

    def loss(kd, p11):
        s = scene.replace(materials=scene.materials._replace(kd=kd),
                          blpatches=scene.blpatches._replace(p11=p11))
        hdr, _ = j_render(s, static, cam, cfg, jax.random.key(0))
        return hdr.sum(), hdr

    (_, hdr), grads = jax.jit(jax.value_and_grad(loss, (0, 1), has_aux=True))(
        scene.materials.kd, scene.blpatches.p11)
    return np.asarray(hdr), [np.asarray(g) for g in grads]


def port_render_and_grads(scene, static, cam):
    scene = attach_accel(scene)
    assert scene.accel is not None
    kd = scene.materials.kd.clone().requires_grad_(True)
    p11 = scene.blpatches.p11.clone().requires_grad_(True)
    s = scene.replace(materials=scene.materials.replace(kd=kd),
                      blpatches=scene.blpatches.replace(p11=p11))
    hdr, stats = render_hdr(s, static, cam,
                            RenderConfig(width=RES, height=RES, trace_depth=2))
    hdr.sum().backward()
    return hdr.detach(), [kd.grad.numpy(), p11.grad.numpy()], stats


def golden_bar(a, b):
    qa, qb = (to_bytes(sigmoid_tonemap(torch.as_tensor(np.array(x)))).numpy()
              .astype(np.int32) for x in (a, b))
    diff = np.abs(qa - qb)
    assert np.mean(diff <= 2) >= 0.999 and diff.mean() <= 0.05, (
        np.mean(diff <= 2), diff.mean(), diff.max())


@pytest.fixture(scope="module", params=[False, True],
                ids=["any_hit_shadows", "refractive"])
def patch_renders(request):
    js, jst, jcam = jax_patch_scene(request.param)
    jhdr, jgrads = jax_render_and_grads(js, jst, jcam)
    ps, pst, pcam = port_inputs(js, jst, jcam)
    assert pst.any_refractive == request.param
    return (ps, pst, pcam, jhdr, jgrads) + port_render_and_grads(ps, pst,
                                                                 pcam)


def test_patch_scene_render_matches_jax(patch_renders):
    *_, jhdr, _, hdr, _, stats = patch_renders
    golden_bar(hdr.numpy(), jhdr)
    assert int(stats.secondary_rays) > 0


def test_patch_scene_grads_match_jax(patch_renders):
    """d sum(hdr) / d kd and / d p11 against jax.grad at rtol 1e-3 (atol
    a thousandth of the largest entry)."""
    *_, jgrads, _, grads, _ = patch_renders
    for g, jgr in zip(grads, jgrads):
        assert np.isfinite(g).all() and np.abs(jgr).max() > 0
        np.testing.assert_allclose(g, jgr, rtol=1e-3,
                                   atol=1e-3 * np.abs(jgr).max())


def test_patches_cast_shadows(patch_renders):
    """The patches occlude the light: the plane under them goes dark, and
    it lights up without them (both shadow paths)."""
    ps, pst, pcam, *_ = patch_renders
    cfg = RenderConfig(width=RES, height=RES, trace_depth=2)
    with torch.no_grad():
        s = attach_accel(ps)
        with_p = render_hdr(s, pst, pcam, cfg)[0]
        # the patches moved far below the plane: nothing else changes
        far = s.blpatches.replace(**{k: getattr(s.blpatches, k) - torch.tensor(
            [0.0, 100.0, 0.0]) for k in ("p00", "p10", "p01", "p11")})
        without = render_hdr(s.replace(blpatches=far), pst, pcam, cfg)[0]
    brighter = (without - with_p).sum(-1) > 1e-3
    assert brighter.sum() >= 4


def test_interop_carries_patches():
    js, jst, _ = jax_patch_scene(False)
    ps, _ = port_inputs(js, jst, j_camera(eye=(0, 0, 5), look_at=(0, 0, 0)))[:2]
    for f in ("p00", "p10", "p01", "p11", "material_id", "valid"):
        np.testing.assert_array_equal(getattr(ps.blpatches, f).numpy(),
                                      np.asarray(getattr(js.blpatches, f)))
    assert ps.blpatches.material_id.dtype == torch.int32


def test_empty_pool_hits_nothing():
    pool = tg.empty_blpatch_pool("cpu")
    o, d, tmax = random_rays(64, seed=3)
    h = ti.intersect_blpatches(pool, torch.as_tensor(o), torch.as_tensor(d),
                               0.0, torch.as_tensor(tmax))
    assert not h.hit.any()
    assert pool.to("cpu").valid.shape == (1,)
