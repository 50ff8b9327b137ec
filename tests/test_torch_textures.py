"""The port's textures, bump heights, bump-mapped normals and environment
against the JAX package's, on the same seeded points.

Bars, stated per test: the smooth lookups (noise sums, cloud, stem,
petal, flower centre, image, cellular distances) within rtol 1e-5 /
atol 2e-6; lookups with a cell id or an exp(-100 x) (stone, cellular)
within rtol 1e-4 / atol 1e-5. The bump height within atol 2e-6: it is
what the bump map differentiates. The bump-mapped normal is a central
difference of that height with a step of 1e-4, which magnifies a
one-ulp height difference about 5,000-fold, so its components are held
to tests/test_golden.py's per-pixel bar read on [0, 1]: at least 99.9%
within 2/255 of the JAX normal's, and a mean |difference| of at most
0.05/255."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from cse168_raytracer_tpu.models import materials as jmat  # noqa: E402
from cse168_raytracer_tpu.models import textures as jt  # noqa: E402
from cse168_raytracer_tpu.ops import shading as jshade  # noqa: E402
from cse168_raytracer_tpu.ops import surface as jsurf  # noqa: E402
from cse168_raytracer_tpu_torch import interop  # noqa: E402
from cse168_raytracer_tpu_torch.models import textures as pt  # noqa: E402
from cse168_raytracer_tpu_torch.models.scene import SceneStatic  # noqa: E402
from cse168_raytracer_tpu_torch.ops import shading as pshade  # noqa: E402
from cse168_raytracer_tpu_torch.ops.surface import Surface  # noqa: E402

SEED = 5
N = 2000
SMOOTH = dict(rtol=1e-5, atol=2e-6)
CELL = dict(rtol=1e-4, atol=1e-5)


def uv_points(lo=-3.0, hi=3.0, n=N, seed=SEED):
    rng = np.random.default_rng(seed)
    return rng.uniform(lo, hi, (n, 2)).astype(np.float32)


def both(jfn, pfn, *arrays):
    """jfn jitted on the arrays, pfn on their tensors; numpy results."""
    want = jax.tree.map(np.asarray, jax.jit(jfn)(*arrays))
    got = pfn(*(torch.as_tensor(np.array(a)) for a in arrays))
    return jax.tree.map(lambda x: x.detach().numpy(), got), want


CLOUD = np.float32([3.0, 0.1, 0.2, 50.0, 0.4, 0.35, 0.5, 0.3])


@pytest.mark.parametrize("name", ["noise", "noise_dynamic", "stone",
                                  "stone_bump", "cloud", "stem_leaf",
                                  "flower_center", "checker"])
def test_procedural_lookup_matches_jax(name):
    uv = uv_points()
    u, v = uv[:, 0], uv[:, 1]
    rng = np.random.default_rng(SEED + 1)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    scale = rng.uniform(0.5, 4.0, N).astype(np.float32)
    iters = rng.integers(1, 8, N).astype(np.int32)
    pivot = np.float32([0.1, -0.2, 0.3])
    bar = SMOOTH
    if name == "noise":
        args, f = (u, v, scale), lambda m, u, v, s: m.generate_noise(
            u, v, s, 3.0, 2.0, 0.8, 5)
    elif name == "noise_dynamic":
        args, f = (u, v, iters), lambda m, u, v, it: m.generate_noise_dynamic(
            u, v, u * 0, 0.5, 2.0, 0.5, it, 7)
    elif name in ("stone", "stone_bump"):
        bar = CELL if name == "stone" else dict(rtol=0, atol=2e-6)
        fn = name.replace("stone", "stone_lookup") if name == "stone" else name
        args, f = (u, v, scale), lambda m, u, v, s: getattr(m, fn)(u, v, s)
    elif name == "cloud":
        params = np.tile(CLOUD, (N, 1))
        params[:, 0] = scale
        args, f = (u, v, params), lambda m, u, v, q: m.cloud_lookup(u, v, q)
    elif name == "stem_leaf":
        args, f = (u, v, scale), lambda m, u, v, s: m.stem_leaf_lookup(u, v, s)
    elif name == "flower_center":
        args, f = (p, scale), lambda m, p, s: m.flower_center_lookup(
            p, p.new_tensor(pivot) if m is pt else jnp.asarray(pivot), s + 2)
    else:
        c1 = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        c2 = rng.uniform(0, 1, (N, 3)).astype(np.float32)
        args, f = (u, v, scale, c1, c2), \
            lambda m, u, v, s, a, b: m.checker_lookup(u, v, s, a, b)
    got, want = both(lambda *a: f(jt, *a), lambda *a: f(pt, *a), *args)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **bar)


def jax_petal_uv(p, pivot, radius):
    """JAX petal_lookup's coordinates (textures.py:191-208), its jnp
    operations copied."""
    position = p - pivot
    r = jnp.sqrt(jnp.maximum(jnp.sum(position * position, axis=-1), 1e-30))
    posn = position / r[..., None]
    v = jnp.arccos(jnp.clip(-posn[..., 1], -1.0, 1.0)) / jt.PI
    theta = jnp.arccos(jnp.clip(posn[..., 0], -1.0, 1.0)) / (2.0 * jt.PI)
    u = jnp.where(-posn[..., 2] > 0, theta, 1.0 - theta)
    return u, v, r / radius


def jax_petal_color(u, v, dist):
    """JAX petal_lookup's colour (textures.py:194-216) at given (u, v),
    its jnp operations copied around the JAX package's generate_noise."""
    dist = dist[..., None]
    mix = lambda a, b: (1 - dist) * jnp.array(a) + dist * jnp.array(b)
    diffuse = mix([0.1, 0.0, 0.6], [0.6, 0.3, 1.0])
    highlight = mix([0.2, 0.0, 0.8], [0.8, 0.5, 1.0])
    depression = mix([0.2, 0.0, 0.5], [0.3, 0.15, 0.75])
    z = jnp.zeros_like(u)
    turb = jnp.abs(jt.generate_noise(u, v * 0.25, z, 4.0, 2.0, 0.9, 10))
    high = jnp.minimum(jnp.power(turb / 0.1, 0.85) * 1.5, 1.0)[..., None]
    turb2 = jnp.abs(jt.generate_noise(u, v, z, 4.0, 3.0, 0.9, 25))
    low = jnp.minimum(jnp.power(turb2 / 0.1, 0.85) * 1.5, 1.0)[..., None]
    return (0.5 * (high * diffuse + (1 - high) * highlight)
            + 0.5 * (low * diffuse + (1 - low) * depression))


def test_petal_matches_jax():
    """petal_uv within 1e-6 (arccos may differ by ulps) and petal_color
    on the same (u, v) at the smooth bar, each against the JAX lines it
    ports. The whole lookup is not held against JAX petal_lookup point
    by point: its 25-octave noise, at frequencies up to 4 * 3^24, makes
    a point's value a function of the last ulp of u."""
    rng = np.random.default_rng(SEED + 1)
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    radius = rng.uniform(2.5, 6.0, N).astype(np.float32)
    pivot = np.float32([0.1, -0.2, 0.3])
    (pu, pv, pd), (ju, jv, jd) = both(
        lambda p, r: jax_petal_uv(p, jnp.asarray(pivot), r),
        lambda p, r: pt.petal_uv(p, p.new_tensor(pivot), r), p, radius)
    for a, b in ((pu, ju), (pv, jv), (pd, jd)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    got, want = both(jax_petal_color, pt.petal_color, ju, jv, jd)
    np.testing.assert_allclose(got, want, **SMOOTH)
    full = pt.petal_lookup(torch.as_tensor(p), torch.as_tensor(pivot),
                           torch.as_tensor(radius)).numpy()
    assert np.isfinite(full).all() and (full >= 0).all()


def cellular_pair(n_points=300, grid=8, seed=2):
    return (jt.build_cellular_texture(n_points, grid, grid, seed=seed),
            pt.build_cellular_texture(n_points, grid, grid, seed=seed,
                                      device="cpu"))


def test_cellular_build_and_lookup_match_jax():
    jc, pc = cellular_pair()
    assert pc.halo == jc.halo
    for f in ("points", "valid"):
        assert (getattr(pc, f).numpy().tobytes()
                == np.asarray(getattr(jc, f)).tobytes()), f
    uv = uv_points(-2.0, 2.0)
    got, want = both(lambda u, v: jt.cellular_distances(jc, u, v, 4),
                     lambda u, v: pt.cellular_distances(pc, u, v, 4),
                     uv[:, 0], uv[:, 1])
    np.testing.assert_allclose(got, want, **SMOOTH)
    got, want = both(lambda u, v: jt.cellular_lookup(jc, u, v),
                     lambda u, v: pt.cellular_lookup(pc, u, v),
                     uv[:, 0], uv[:, 1])
    np.testing.assert_allclose(got, want, **CELL)


def test_cellular_lookup_is_differentiable_in_points():
    jc, pc = cellular_pair(n_points=60, grid=6, seed=3)
    uv = uv_points(0.0, 1.0, n=64)
    jg = np.asarray(jax.jit(jax.grad(
        lambda pts: jt.cellular_lookup(jc.replace(points=pts), uv[:, 0],
                                       uv[:, 1]).sum()))(jc.points))
    pts = pc.points.clone().requires_grad_(True)
    pt.cellular_lookup(pt.CellularTexture(pts, pc.valid, pc.halo),
                       torch.as_tensor(uv[:, 0]),
                       torch.as_tensor(uv[:, 1])).sum().backward()
    assert np.abs(jg).sum() > 0
    np.testing.assert_allclose(pts.grad.numpy(), jg, rtol=1e-4, atol=1e-4)


def image_pair(is_hdr, h=20, w=30):
    rng = np.random.default_rng(SEED + is_hdr)
    pix = rng.uniform(0, 4 if is_hdr else 1, (h, w, 3)).astype(np.float32)
    return (jt.build_image_texture(pix, is_hdr),
            pt.build_image_texture(pix, is_hdr, device="cpu"))


@pytest.mark.parametrize("is_hdr", [False, True])
@pytest.mark.parametrize("lowres", [False, True])
@pytest.mark.parametrize("where", ["inside", "outside"])
def test_image_lookup(is_hdr, lowres, where):
    """Bilinear lookups inside [0, 1)^2 at the smooth bar, and in
    [-1.5, 2.5)^2: there C's sign-keeping fmod gives weights out to
    +-30 (the image's width), which multiply a rounding difference by
    as much, and the fetch wraps positively (the seam of
    TexturedSphere.obj); bar rtol 1e-4 / atol 1e-4."""
    jtex, ptex = image_pair(is_hdr)
    for f in ("image", "lowres", "max_intensity"):
        assert (getattr(ptex, f).numpy().tobytes()
                == np.asarray(getattr(jtex, f)).tobytes()), f
    uv = uv_points(0.0, 1.0) if where == "inside" else uv_points(-1.5, 2.5)
    got, want = both(lambda u, v: jt.image_lookup(jtex, u, v, lowres),
                     lambda u, v: pt.image_lookup(ptex, u, v, lowres),
                     uv[:, 0], uv[:, 1])
    if where == "outside" and not is_hdr:
        assert np.abs(got).max() > 2.0     # extrapolated
    np.testing.assert_allclose(got, want, **(
        SMOOTH if where == "inside" else dict(rtol=1e-4, atol=1e-4)))


def test_radiance_hdr_round_trip(tmp_path):
    """Each package's writer read back by both readers: the same bytes."""
    rng = np.random.default_rng(SEED)
    img = (rng.uniform(0, 1, (9, 13, 3)) ** 3 * 50).astype(np.float32)
    img[0, 0] = 0.0
    a, b = str(tmp_path / "jax.hdr"), str(tmp_path / "port.hdr")
    jt.write_radiance_hdr(a, img)
    pt.write_radiance_hdr(b, img)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got = pt.read_radiance_hdr(a)
    assert got.tobytes() == jt.read_radiance_hdr(b).tobytes()
    # RGBE shares one exponent: 8 bits of the largest channel
    assert (np.abs(got - img) <= img.max(-1, keepdims=True) * 2 ** -7).all()
    tex = pt.load_image_texture(a, device="cpu")
    want = jt.load_image_texture(a)
    assert tex.is_hdr and want.is_hdr
    assert tex.image.numpy().tobytes() == np.asarray(want.image).tobytes()
    assert tex.lowres.numpy().tobytes() == np.asarray(want.lowres).tobytes()


def test_image_loader_errors(tmp_path):
    with pytest.raises(FileNotFoundError, match="nothere.hdr"):
        pt.load_image_texture(str(tmp_path / "nothere.hdr"), device="cpu")
    png = tmp_path / "x.png"
    png.write_bytes(b"")
    try:
        import imageio  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="x.png"):
            pt.load_image_texture(str(png), device="cpu")


def env_pair(kind):
    jtex, ptex = image_pair(True, 12, 24)
    if kind == "image":
        kw = dict(rotation=(0.3, -0.2))
        return (jt.make_environment(image=jtex, **kw),
                pt.make_environment(image=ptex, device="cpu", **kw))
    kw = dict(cloud_params=CLOUD, rotation=(0.4, 0.1),
              quirk_cloud_env_black=kind == "black_cloud")
    if kind == "bg":
        kw = dict(bg_color=(0.1, 0.2, 0.3))
    return jt.make_environment(**kw), pt.make_environment(device="cpu", **kw)


@pytest.mark.parametrize("kind", ["image", "cloud", "black_cloud", "bg"])
def test_env_lookup_matches_jax(kind):
    """The smooth bar; the cloud within atol 5e-4. Its (u, v) come from
    atan2 and asin, which may differ by an ulp (6e-8) from XLA's; the
    15 octaves' slopes sum to about 225 per unit of u, and the sigmoid
    of sharpness 50 multiplies by up to 12.5 more: 1.7e-4."""
    je, pe = env_pair(kind)
    rng = np.random.default_rng(SEED)
    d = rng.normal(0, 1, (N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    diffuse = rng.uniform(0, 1, N) < 0.5
    got, want = both(lambda d, s: jt.env_lookup(je, d, s),
                     lambda d, s: pt.env_lookup(pe, d, s), d, diffuse)
    assert got.shape == (N, 3)
    if kind == "black_cloud":
        assert not got.any()
    elif kind != "bg":
        assert got.std() > 0
    np.testing.assert_allclose(got, want, **(
        dict(rtol=0, atol=5e-4) if kind == "cloud" else SMOOTH))


def material_tables():
    """Every texture kind in one table (both packages), with one image
    and one cellular texture."""
    rows = [("phong", dict(kd=(0.3, 0.6, 0.9))),
            ("textured", dict(kind=jmat.TEX_CHECKER, params=[2.0],
                              color1=(1, 0, 0), color2=(0, 0, 1))),
            ("textured", dict(kind=jmat.TEX_STONE, params=[3.0])),
            ("textured", dict(kind=jmat.TEX_CLOUD, params=CLOUD)),
            ("textured", dict(kind=jmat.TEX_PETAL,
                              params=[7.0, 0.1, -0.2, 0.0])),
            ("textured", dict(kind=jmat.TEX_STEM, params=[1.5])),
            ("textured", dict(kind=jmat.TEX_LEAF, params=[1.0])),
            ("textured", dict(kind=jmat.TEX_FLOWER_CENTER,
                              params=[1.1, -0.1, -0.35, 0.0])),
            ("textured", dict(kind=jmat.TEX_IMAGE, params=[], image_id=0)),
            ("textured", dict(kind=jmat.TEX_CELLULAR, params=[1.0],
                              image_id=0))]
    from cse168_raytracer_tpu_torch.models.materials import MaterialBuilder
    jb, pb = jmat.MaterialBuilder(), MaterialBuilder()
    for method, kw in rows:
        getattr(jb, method)(**kw)
        getattr(pb, method)(**kw)
    return jb.build(), pb.build("cpu"), len(rows)


def test_diffuse_color_and_bump_height_every_kind():
    """diffuse_color over all ten kinds. The lanes of constant, checker,
    stone, flower-centre, image and cellular materials against JAX
    diffuse_color at the cell bar; the noise-heavy kinds (cloud, stem,
    leaf, petal), each held against JAX above, against the port's own
    lookups exactly, which checks the dispatch without compiling their
    octaves twice. bump_height against JAX within atol 2e-6."""
    jm, pm, n_mat = material_tables()
    jtex, ptex = image_pair(False)
    jc, pc = cellular_pair()
    kinds = jt.active_kinds(jm)
    assert kinds == pt.active_kinds(pm) and len(kinds) == 10
    rng = np.random.default_rng(SEED)
    mid = rng.integers(0, n_mat, N).astype(np.int32)
    uv = uv_points()
    p = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    cheap = (jmat.TEX_CONSTANT, jmat.TEX_CHECKER, jmat.TEX_STONE,
             jmat.TEX_FLOWER_CENTER, jmat.TEX_IMAGE, jmat.TEX_CELLULAR)
    want = np.asarray(jax.jit(lambda mid, uv, p: jt.diffuse_color(
        jm, [jtex], mid, uv, p, cheap, cellulars=[jc]))(mid, uv, p))
    tmid, tuv, tp = (torch.as_tensor(x) for x in (mid, uv, p))
    got = pt.diffuse_color(pm, [ptex], tmid, tuv, tp, kinds,
                           cellulars=[pc]).numpy()
    kind = pm.texture_kind.numpy()[mid]
    sel = np.isin(kind, cheap)
    np.testing.assert_allclose(got[sel], want[sel], **CELL)
    params = pm.texture_params[tmid]
    u, v = tuv[:, 0], tuv[:, 1]
    own = {jmat.TEX_CLOUD: pt.cloud_lookup(tp[:, 0], tp[:, 1], params[:, :8]),
           jmat.TEX_STEM: pt.stem_leaf_lookup(u, v, params[:, 0]),
           jmat.TEX_LEAF: pt.stem_leaf_lookup(tp[:, 0], tp[:, 1],
                                              params[:, 0]),
           jmat.TEX_PETAL: pt.petal_lookup(tp, params[:, 1:4], params[:, 0])}
    for k, c in own.items():
        lanes = kind == k
        assert lanes.any() and np.array_equal(got[lanes], c.numpy()[lanes])
    got, want = both(lambda mid, uv: jt.bump_height(jm, mid, uv, kinds),
                     lambda mid, uv: pt.bump_height(pm, mid, uv, kinds),
                     mid, uv)
    assert (got[mid == 2] != 0).all() and not got[mid != 2].any()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    assert pt.has_bump(pm) and jt.has_bump(jm)


def test_apply_bump_normals():
    """Bump-mapped normals of a stone material and of a plain one at
    seeded shading points, against JAX ops/shading.apply_bump (bar in
    the module docstring; the plain material's normals within 1e-6)."""
    jm, pm, n_mat = material_tables()
    rng = np.random.default_rng(SEED)
    n = 4000
    nrm = rng.normal(0, 1, (n, 3)).astype(np.float32) * rng.uniform(
        0.5, 2, (n, 1)).astype(np.float32)
    arrays = dict(p=rng.uniform(-2, 2, (n, 3)).astype(np.float32), n=nrm,
                  geo_n=nrm, uv=uv_points(-4, 4, n),
                  material_id=np.where(rng.uniform(0, 1, n) < 0.8, 2,
                                       0).astype(np.int32),
                  hit=np.ones(n, bool))
    kinds = jt.active_kinds(jm)
    jscene = type("S", (), {"materials": jm})
    jstatic = type("St", (), {"texture_kinds": kinds, "any_bump": True})
    want = np.asarray(jax.jit(lambda s: jshade.apply_bump(
        jscene, jstatic, s))(jsurf.Surface(**arrays)))
    pscene = type("S", (), {"materials": pm})
    pstatic = SceneStatic(texture_kinds=kinds, any_bump=True, num_lights=0,
                          any_refractive=False, any_reflective=False)
    got = pshade.apply_bump(pscene, pstatic, Surface(
        **{k: torch.as_tensor(v) for k, v in arrays.items()})).numpy()
    err = np.abs(got - want).max(-1)
    stone = arrays["material_id"] == 2
    plain = ~stone
    assert np.isfinite(got).all()
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    assert err[plain].max() <= 1e-6, err[plain].max()
    # the bump tilts the stone normals away from the plain ones
    flat = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    assert np.median(np.abs(got - flat).max(-1)[stone]) > 1e-3
    comp = np.abs(got - want)[stone]
    print(f"stone normals: {(comp <= 2 / 255).mean():.6f} of components "
          f"within 2/255, mean {comp.mean():.3g}, worst {comp.max():.3g}")
    assert (comp <= 2 / 255).mean() >= 0.999 and comp.mean() <= 0.05 / 255


def test_scene_from_numpy_carries_textures():
    """interop carries images, cellulars and an image environment."""
    from cse168_raytracer_tpu.models.scene import make_scene
    jm, pm, _ = material_tables()
    jtex, _ = image_pair(False)
    jc, _ = cellular_pair()
    je, _ = env_pair("image")
    js, jst = make_scene(materials=jm, env=je, images=[jtex],
                         cellulars=[jc])
    ps, pst = interop.scene_from_numpy(jax.tree.map(np.asarray, js), jst,
                                       "cpu")
    assert pst.texture_kinds == tuple(jst.texture_kinds) and pst.any_bump
    assert len(ps.images) == 1 and len(ps.cellulars) == 1
    assert ps.cellulars[0].halo == jc.halo
    for a, b in ((ps.images[0].lowres, jtex.lowres),
                 (ps.cellulars[0].points, jc.points),
                 (ps.env.image.image, je.image.image)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()
    assert ps.env.image.is_hdr == je.image.is_hdr


def test_no_texture_raises_left():
    """No NotImplementedError is left for textures, bump maps, images,
    cellulars, image and cloud environments, or bilinear patches."""
    import cse168_raytracer_tpu_torch as port
    root = os.path.dirname(port.__file__)
    for rel in ("models/textures.py", "ops/shading.py", "interop.py"):
        with open(os.path.join(root, rel)) as f:
            src = f.read()
        assert "A10" not in src, rel
    with open(os.path.join(root, "interop.py")) as f:
        assert f.read().count("NotImplementedError") == 0
