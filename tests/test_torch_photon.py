"""The port's photon mapping against the JAX package's.

Host arrays (build_grid, _auto_radius) are held byte for byte, the
spatial hash exactly. The gather runs both packages on the same grid
and points: r'^2 bit for bit (the JAX function's is read where it is
detached) and the irradiance within rtol 1e-5 (only the order of the
final sum may differ). Photon tracing takes fed uniforms (the `feed`
fixture of test_torch_sampling.py stands in for jax.random.uniform) and
is compared slot by slot. Built maps compare statistically; renders
with maps carried from the JAX package compare per pixel, and the
photon-power gradient against jax.grad and finite differences."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from chip_smoke import box_mesh  # noqa: E402
from cse168_raytracer_tpu.config import RenderConfig as JCfg  # noqa: E402
from cse168_raytracer_tpu.models import lights as jl  # noqa: E402
from cse168_raytracer_tpu.models.geometry import (  # noqa: E402
    make_plane_pool, make_sphere_pool, pack_triangles)
from cse168_raytracer_tpu.models.materials import MaterialBuilder  # noqa: E402
from cse168_raytracer_tpu.models.scene import make_scene  # noqa: E402
from cse168_raytracer_tpu.ops import photon as jp  # noqa: E402
from cse168_raytracer_tpu.ops.accel import attach_accel as j_attach  # noqa: E402
from cse168_raytracer_tpu.render import photon_viz as jviz  # noqa: E402
from cse168_raytracer_tpu.render.camera import make_camera  # noqa: E402
from cse168_raytracer_tpu.render.integrator import \
    render_hdr as j_render  # noqa: E402
from cse168_raytracer_tpu.utils import checkpoint as jck  # noqa: E402
from cse168_raytracer_tpu_torch import cli, interop  # noqa: E402
from cse168_raytracer_tpu_torch.config import RenderConfig  # noqa: E402
from cse168_raytracer_tpu_torch.models import lights as tl  # noqa: E402
from cse168_raytracer_tpu_torch.ops import photon as tp  # noqa: E402
from cse168_raytracer_tpu_torch.ops.accel import attach_accel  # noqa: E402
from cse168_raytracer_tpu_torch.render import photon_viz as tviz  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    render_hdr  # noqa: E402
from cse168_raytracer_tpu_torch.utils import checkpoint as tck  # noqa: E402
from test_torch_golden import load_ppm  # noqa: E402
from test_torch_photon_gather_kernel import gather_case  # noqa: E402
from test_torch_render import port_inputs  # noqa: E402
from test_torch_sampling import feed  # noqa: E402,F401  (fixture)

GRID_FIELDS = ("pos", "power", "dir", "weight", "cell_hash", "radius")
RENDER_TOL = dict(rtol=1e-4, atol=1e-5)
DIR_LIGHT = dict(kind=2, position=(0, 8, 0), normal=(0, -1, 0),
                 color=(1, 1, 1), wattage=10.0, radius=3.0)
N_TRACE = 512


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def caustic_scene():
    """tests/test_photon.py's glass sphere over a diffuse floor under a
    directional beam, built by the JAX package."""
    mb = MaterialBuilder()
    floor = mb.phong(kd=(0.8, 0.8, 0.8))
    glass = mb.phong(kd=(0, 0, 0), kt=(1, 1, 1), ior=1.5)
    spheres = make_sphere_pool([(0, 1, 0)], [1.0], [glass])
    planes = make_plane_pool([(0, 0, 0)], [(0, 1, 0)], [floor])
    return make_scene(spheres=spheres, planes=planes, materials=mb.build(),
                      lights=[DIR_LIGHT])


def triangle_scene():
    """A triangle floor and boxes of diffuse, mirror, glass and glossy
    materials under the beam: photons bounce through the mesh."""
    mb = MaterialBuilder()
    mats = [mb.phong(kd=(0.8, 0.7, 0.6)),
            mb.phong(kd=(0.1, 0.1, 0.1), ks=(0.8, 0.8, 0.8), shininess=30),
            mb.phong(kd=(0, 0, 0), kt=(1, 1, 1), ior=1.5, shininess=50),
            mb.phong(kd=(0.3, 0.6, 0.3), ks=(0.3, 0.3, 0.3), shininess=10)]
    floor = box_mesh([(0, -0.06, 0, 4, 0.05, 4)])   # no face coplanar
    rng = np.random.RandomState(3)
    meshes = [(floor, 0)] + [
        (box_mesh([(rng.uniform(-2, 2), s, rng.uniform(-2, 2), s, s, s)]), i)
        for i, s in zip([1, 2, 3, 0, 1, 2], rng.uniform(0.3, 0.8, 6))]
    return make_scene(tris=pack_triangles(meshes), materials=mb.build(),
                      lights=[DIR_LIGHT])


def two_plane_scene():
    """tests/test_photon.py's floor and ceiling with a directional area
    light between them: the global map stores on both planes."""
    mb = MaterialBuilder()
    white = mb.phong(kd=(0.8, 0.8, 0.8))
    planes = make_plane_pool([(0, 0, 0), (0, 4, 0)],
                             [(0, 1, 0), (0, -1, 0)], [white, white])
    lights = [dict(kind=2, position=(0, 3, 0), normal=(0, -1, 0), radius=1.0,
                   color=(1, 1, 1), wattage=100.0)]
    scene, static = make_scene(planes=planes, materials=mb.build(),
                               lights=lights)
    cam = make_camera(eye=(0, 2, 6), look_at=(0, 1, 0), fov=60,
                      bg_color=(0, 0, 0))
    return scene, static, cam


@pytest.fixture(scope="module")
def plane_maps():
    """The two-plane scene and the JAX package's maps of it: 1500
    global photons, as tests/test_grad_oracle.py::test_grad_photon_power
    builds them, and 1500 caustic ones of the caustic scene."""
    scene, static, cam = two_plane_scene()
    cfg = JCfg(width=8, height=8, trace_depth=1, photons_per_light=1500,
               caustic_photons_per_light=0)
    maps = jp.build_photon_maps(scene, static, cfg, jax.random.key(1))
    cs, cst = caustic_scene()
    cmaps = jp.build_photon_maps(cs, cst, JCfg(
        photons_per_light=0, caustic_photons_per_light=1500),
        jax.random.key(1))
    maps = maps.replace(caustic_map=cmaps.caustic_map)
    return scene, static, cam, maps


# ---------------------------------------------------------------------------
# host arrays
# ---------------------------------------------------------------------------

def assert_same_grid(port, ref):
    """Every field of a port grid equals the JAX grid's, byte for byte,
    its coarse level too."""
    for f in GRID_FIELDS:
        a, b = np.asarray(getattr(ref, f)), getattr(port, f).cpu().numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    for f in ("n_valid", "table_size", "max_per_cell", "knn"):
        assert int(getattr(port, f)) == int(getattr(ref, f)), f
    assert (port.coarse is None) == (ref.coarse is None)
    if ref.coarse is not None:
        assert_same_grid(port.coarse, ref.coarse)


def cloud(case):
    """(pos, power, dirs) of a seeded photon cloud: "plain" uniform,
    "folds" (a tight blob that overfills its cells), "clusters"."""
    rng = np.random.RandomState({"plain": 0, "folds": 1, "clusters": 2}[case])
    if case == "plain":
        pos = rng.uniform(-2, 2, (500, 3))
    elif case == "folds":
        pos = np.concatenate([rng.normal(0, 0.01, (400, 3)),
                              rng.uniform(-1, 1, (300, 3))])
    else:
        blobs = rng.uniform(-2, 2, (6, 3))
        pos = np.concatenate([b + rng.normal(0, 0.08, (700, 3))
                              for b in blobs])
    n = pos.shape[0]
    power = np.abs(rng.normal(1.0, 0.3, (n, 3)))
    power[:5, 1] = 0.0                      # a zero channel in a folded cell
    dirs = rng.normal(0, 1, (n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (pos.astype(np.float32), power.astype(np.float32),
            dirs.astype(np.float32))


@pytest.mark.parametrize("case,radius,cap,coarse", [
    ("plain", 0.5, 64, None), ("folds", 1.0, 16, None),
    ("folds", 0.05, 16, 8.0), ("clusters", 0.35, 64, 8.0),
    ("clusters", 0.2, 32, 4.0)])
def test_build_grid_bytes(case, radius, cap, coarse):
    pos, power, dirs = cloud(case)
    ref = jp.build_grid(pos, power, dirs, radius, max_per_cell=cap, knn=300,
                        coarse_factor=coarse)
    port = tp.build_grid(pos, power, dirs, radius, max_per_cell=cap,
                         knn=300, coarse_factor=coarse, device="cpu")
    assert_same_grid(port, ref)
    if case == "folds":
        assert float(port.weight.max()) > 1.0     # a cell was folded


@pytest.mark.parametrize("n,seed", [(5, 0), (700, 1), (6000, 2)])
def test_auto_radius_equal(n, seed):
    rng = np.random.RandomState(seed)
    pos = np.concatenate([rng.uniform(-4, 4, (n - n // 3, 3)),
                          rng.normal(0, 0.25, (n // 3, 3))]).astype(np.float32)
    for k, cap in ((500, 64), (50, 32)):
        assert (tp._auto_radius(pos, k, cap)
                == jp._auto_radius(pos, k, cap))


def test_hash_cells_wraps_as_uint32():
    """Negative cells and cells near +-2^31 hash as the JAX function's
    int32 -> uint32 cast does, and a cell one past the int32 range (a
    saturated floor plus a neighbour offset) as int32 arithmetic wraps."""
    lim = 2 ** 31
    vals = np.array([0, 1, -1, -2, 12345, -98765, lim - 1, lim - 2, -lim,
                     -lim + 1, 7, -7], np.int64)
    rng = np.random.RandomState(5)
    cells = np.stack([rng.choice(vals, 300) for _ in range(3)], axis=1)
    for table in (16, 1 << 20, 1 << 23):
        want = np.asarray(jp._hash_cells(jnp.asarray(cells.astype(np.int32)),
                                         table))
        got = tp._hash_cells(torch.as_tensor(cells), table).numpy()
        np.testing.assert_array_equal(got, want)
    # int64 cells beyond the int32 range wrap as the int32 sum would
    past = cells + rng.choice([-1, 0, 1], cells.shape)
    wrapped = ((past + lim) % (2 * lim) - lim).astype(np.int32)
    np.testing.assert_array_equal(
        tp._hash_cells(torch.as_tensor(past), 1 << 20).numpy(),
        np.asarray(jp._hash_cells(jnp.asarray(wrapped), 1 << 20)))


# ---------------------------------------------------------------------------
# the gather
# ---------------------------------------------------------------------------

def jax_gather(grid, q, n, monkeypatch):
    """The JAX grid_irradiance, compiled, with the r'^2 of each level it
    visited (the 1-D values it detaches, in call order) as outputs."""
    real = jax.lax.stop_gradient

    def run(q, n):
        seen = []

        def spy(x):
            if x.ndim == 1:
                seen.append(x)
            return real(x)

        monkeypatch.setattr(jax.lax, "stop_gradient", spy)
        irr = jp.grid_irradiance(grid, q, n)
        monkeypatch.setattr(jax.lax, "stop_gradient", real)
        return irr, seen

    irr, seen = jax.jit(run)(jnp.asarray(q), jnp.asarray(n))
    return np.asarray(irr), [np.asarray(x) for x in seen]


@pytest.mark.parametrize("case", ["fixed", "sparse", "overflow", "clustered",
                                  "knn500"])
def test_gather_matches_jax(case, monkeypatch):
    pos, power, dirs, kw, q, nrm = gather_case(case)
    ref = jp.build_grid(pos, power, dirs, **kw)
    port = tp.build_grid(pos, power, dirs, **kw, device="cpu")
    want, r2s = jax_gather(ref, q, nrm, monkeypatch)
    tq, tn = torch.as_tensor(q), torch.as_tensor(nrm)
    got = tp.grid_irradiance(port, tq, tn).numpy()
    assert want.sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    levels = [port] + ([port.coarse] if port.coarse is not None else [])
    assert len(r2s) == len(levels)
    for level, r2 in zip(levels, r2s):
        _, _, mine = tp._gather_level(level, tq, tn, level.power)
        assert mine.numpy().tobytes() == r2.tobytes()
    if case == "sparse":
        assert got[0].sum() > 0        # only the coarse level reaches it


def test_gather_far_and_huge_points(monkeypatch):
    """Points far outside the grid (floor(p / r) saturating at the int32
    range, and its neighbour cells wrapping) and on the photons."""
    pos, power, dirs, kw, q, nrm = gather_case("fixed")
    q = np.concatenate([q[:8], pos[:8], [[1e12, -1e12, 3e9],
                                         [-1e30, 0.0, 1e30]]]).astype(
        np.float32)
    nrm = np.concatenate([nrm[:16], nrm[:2]])
    ref = jp.build_grid(pos, power, dirs, **kw)
    port = tp.build_grid(pos, power, dirs, **kw, device="cpu")
    want, _ = jax_gather(ref, q, nrm, monkeypatch)
    got = tp.grid_irradiance(port, torch.as_tensor(q),
                             torch.as_tensor(nrm)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_gather_chunks_do_not_change_the_answer():
    pos, power, dirs, kw, q, nrm = gather_case("sparse")
    port = tp.build_grid(pos, power, dirs, **kw, device="cpu")
    tq, tn = torch.as_tensor(q), torch.as_tensor(nrm)
    whole = tp.grid_irradiance(port, tq, tn, chunk=1000)
    for chunk in (1, 7, 16):
        assert torch.equal(tp.grid_irradiance(port, tq, tn, chunk=chunk),
                           whole)


def plain_irradiance(grid, p, n, fine_power, coarse_power, chunk):
    """grid_irradiance by plain autograd through _gather_level, chunk by
    chunk: it keeps every chunk's (N, 27, K) arrays for the backward."""
    out = []
    for c in range(0, p.shape[0], chunk):
        pc, nc = p[c:c + chunk], n[c:c + chunk]
        e, cnt, _ = tp._gather_level(grid, pc, nc, fine_power)
        e_c, cnt_c, _ = tp._gather_level(grid.coarse, pc, nc, coarse_power)
        use_c = (cnt < grid.knn) & (cnt_c >= grid.knn)
        out.append(torch.where(use_c[:, None], e_c, e))
    return torch.cat(out)


def test_gather_backward_matches_plain_autograd():
    """The gather's gradient in both levels' powers equals plain
    autograd's at several chunks, and its autograd graph saves nothing
    of the (N, 27, K) candidate arrays."""
    pos, power, dirs, kw, q, nrm = gather_case("sparse")
    # knn 150: points in the cluster use the fine level, points near it
    # the coarse one
    q = np.concatenate([q, pos[:24] + 0.01]).astype(np.float32)
    nrm = np.concatenate([nrm, nrm[:24]])
    grid = tp.build_grid(pos, power, dirs, **dict(kw, knn=150),
                         device="cpu")
    tq, tn = torch.as_tensor(q), torch.as_tensor(nrm)
    weight = torch.as_tensor(np.random.default_rng(9).uniform(
        0.5, 1.5, (q.shape[0], 3)).astype(np.float32))
    grads = []
    for plain in (True, False):
        fine = grid.power.clone().requires_grad_(True)
        coarse = grid.coarse.power.clone().requires_grad_(True)
        saved = []

        def pack(t):
            saved.append(t.numel())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            if plain:
                irr = plain_irradiance(grid, tq, tn, fine, coarse, 16)
            else:
                g = grid.replace(power=fine,
                                 coarse=grid.coarse.replace(power=coarse))
                irr = tp.grid_irradiance(g, tq, tn, chunk=16)
        (irr * weight).sum().backward()
        grads.append((fine.grad, coarse.grad, max(saved)))
    (pf, pc, plain_saved), (cf, cc, saved) = grads
    assert pf.abs().sum() > 0 and pc.abs().sum() > 0
    torch.testing.assert_close(cf, pf, rtol=1e-6, atol=1e-9)
    torch.testing.assert_close(cc, pc, rtol=1e-6, atol=1e-9)
    assert plain_saved >= 16 * 27 * 64
    assert saved <= q.shape[0] * 3, saved


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

def fed_uniforms(seed, n, levels, path_tracing):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(0, 1, s).astype(np.float32)
    return dict(origin=u(n, 2), direction=u(n, 2), roulette=u(levels, n),
                bounce=u(levels, n, 2),
                lobes=u(levels, 2, n, 2) if path_tracing else None,
                fresnel=u(levels, n))


def feed_trace(feed, un, square=None):
    """Queue the JAX tracer's draws in its order: sample_origin's square
    and disc uniforms, the direction's (drawn twice from one key), then
    per level the roulette, the cosine bounce, the lobes, the Fresnel
    roulette. Returns the port's PhotonUniforms."""
    n = un["origin"].shape[0]
    sq = (np.zeros((n, 2), np.float32) if square is None else square)
    arrays = [sq, un["origin"], un["direction"], un["direction"]]
    for lv in range(un["roulette"].shape[0]):
        arrays += [un["roulette"][lv], un["bounce"][lv]]
        if un["lobes"] is not None:
            arrays += [un["lobes"][lv, 0], un["lobes"][lv, 1]]
        arrays.append(un["fresnel"][lv])
    feed(*arrays)
    return tp.PhotonUniforms(**{k: None if v is None else torch.as_tensor(v)
                                for k, v in un.items()})


def compare_batches(port, ref):
    """Bars measured on the CPU (4,096 photons x 6 levels, 32 runs over
    both scenes, both maps, with and without lobes): stored masks agreed
    on >= 99.99% of the (level, photon) slots; of the slots both
    stored, at most 2 of 200-370 had a position, direction or power
    outside rtol 1e-4 / atol 1e-4 (a photon whose path an ulp turned at
    a grazing refraction); bounce counts differed by at most 1. Held
    here: masks on 99.9% of the slots, 98% of the jointly stored slots
    within that tolerance, bounces within 0.5% of the photons."""
    pm, rm = port.mask.numpy(), np.asarray(ref.mask)
    assert float(np.mean(pm == rm)) >= 0.999
    both = pm & rm
    assert both.sum() > 0
    for f in ("pos", "dir", "power"):
        a, b = getattr(port, f).numpy()[both], np.asarray(getattr(ref, f))[both]
        ok = np.isclose(a, b, rtol=1e-4, atol=1e-4).all(1)
        assert ok.mean() >= 0.98, (f, int((~ok).sum()), ok.size)
    np.testing.assert_allclose(port.bounces.numpy(), np.asarray(ref.bounces),
                               atol=max(2, 0.005 * pm.shape[1]))


@pytest.mark.parametrize("caustic", [False, True])
@pytest.mark.parametrize("path_tracing", [False, True])
def test_trace_caustic_scene_fed(feed, caustic, path_tracing):
    js, jst = caustic_scene()
    ps, pst = interop.scene_from_numpy(np_tree(js), jst, "cpu")
    un = fed_uniforms(10 + 2 * caustic + path_tracing, N_TRACE, 6,
                      path_tracing)
    u = feed_trace(feed, un)
    ref = jp.trace_photon_batch(js, jst, 0, N_TRACE, caustic, 5,
                                path_tracing, jax.random.key(0))
    port = tp.trace_photon_batch(ps, pst, 0, caustic, path_tracing, u)
    compare_batches(port, ref)
    mask = port.mask.numpy()
    assert mask[0].sum() == 0 and mask.sum() > 0


@pytest.mark.parametrize("caustic", [False, True])
def test_trace_triangle_scene_fed(feed, caustic):
    """A mesh scene: the JAX package through its CPU accelerator, the
    port through the wide tree's plain walk."""
    js, jst = triangle_scene()
    ps, pst = interop.scene_from_numpy(np_tree(js), jst, "cpu")
    ps = attach_accel(ps)
    un = fed_uniforms(20 + caustic, N_TRACE, 6, True)
    u = feed_trace(feed, un)
    ref = jp.trace_photon_batch(j_attach(js), jst, 0, N_TRACE, caustic, 5,
                                True, jax.random.key(0))
    port = tp.trace_photon_batch(ps, pst, 0, caustic, True, u)
    compare_batches(port, ref)


def test_trace_gates_and_draws():
    """The gates of tests/test_photon.py on the port's own draws: global
    photons never store at depth 1, and die on a specular first bounce;
    caustic photons store only under the sphere, on the floor."""
    js, jst = caustic_scene()
    ps, pst = interop.scene_from_numpy(np_tree(js), jst, "cpu")
    gen = torch.Generator().manual_seed(0)
    glob = tp.draw_trace_photon_batch(ps, pst, 0, N_TRACE, False, 5, False,
                                      gen)
    mask = glob.mask.numpy()
    assert mask[0].sum() == 0 and mask.sum() > 0
    # a global photon through the glass never stores (its first bounce
    # is specular): every stored one came off the floor at level 0
    assert (glob.pos.numpy()[mask][:, 1] > -1e-3).all()
    caus = tp.draw_trace_photon_batch(ps, pst, 0, N_TRACE, True, 5, False,
                                      gen)
    stored = caus.pos.numpy()[caus.mask.numpy()]
    assert stored.shape[0] > 0
    assert np.abs(stored[:, [0, 2]]).max() < 3.0
    assert np.abs(stored[:, 1]).max() < 1e-3


def test_point_lights_do_not_emit():
    mb = MaterialBuilder()
    planes = make_plane_pool([(0, 0, 0)], [(0, 1, 0)],
                             [mb.phong(kd=(0.9, 0.9, 0.9))])
    js, jst = make_scene(planes=planes, materials=mb.build(), lights=[
        dict(kind=0, position=(0, 5, 0), color=(1, 1, 1), wattage=100.0)])
    ps, pst = interop.scene_from_numpy(np_tree(js), jst, "cpu")
    cfg = RenderConfig(photons_per_light=100, caustic_photons_per_light=100)
    gen = torch.Generator().manual_seed(0)
    assert tp.build_photon_maps(ps, pst, cfg, gen) is None
    assert tp.build_photon_maps(ps, pst, cfg, gen, return_stats=True) == (
        None, {})


def test_sample_photon_direction_fed(feed):
    from test_torch_sampling import LIGHTS
    lt_j = jl.make_light_table(LIGHTS)
    lt_t = tl.make_light_table(LIGHTS, "cpu")
    u = np.random.default_rng(7).uniform(0, 1, (300, 2)).astype(np.float32)
    for li in range(3):
        (tu, _) = feed(u, u)
        want = np.asarray(jl.sample_photon_direction(lt_j, li,
                                                     jax.random.key(0),
                                                     (300,)))
        got = tl.sample_photon_direction(lt_t, li, tu).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-6)
    assert np.allclose(np.linalg.norm(got, axis=1), 1, atol=1e-6)


def test_emission_samplers_fed(feed):
    """cosine_hemisphere_about and sphere_surface_to_dir against the JAX
    functions on the same uniforms."""
    from cse168_raytracer_tpu.core import sampling as js
    from cse168_raytracer_tpu_torch.core import sampling as ts
    from test_torch_sampling import unit_vectors, uniforms
    n = unit_vectors(11)
    u1, u2 = uniforms(12, n.shape[:1]), uniforms(13, n.shape[:1])
    tu1, tu2 = feed(u1, u2)
    tn, jn = torch.as_tensor(n), jnp.asarray(n)
    for port, ref in ((ts.cosine_hemisphere_about(tu1, tn),
                       js.cosine_hemisphere_about(jax.random.key(0), jn)),
                      (ts.sphere_surface_to_dir(tu2, tn),
                       js.sphere_surface_to_dir(jn, jax.random.key(0)))):
        np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=2e-6)


# ---------------------------------------------------------------------------
# map building, statistically
# ---------------------------------------------------------------------------

def stored_summary(maps, stats, name):
    """(stored per level / emitted, total stored power) of one map, and
    the emitted count."""
    grid = maps.global_map if name == "global" else maps.caustic_map
    power = (grid.power.numpy() if isinstance(grid.power, torch.Tensor)
             else np.asarray(grid.power))
    st = stats[name]
    return (np.asarray(st["stored_per_level"], np.float64) / st["emitted"],
            power.astype(np.float64).sum(0), st["emitted"])


@pytest.mark.parametrize("name", ["global", "caustic"])
def test_build_photon_maps_statistically(name):
    """Stored photons per level (per emitted photon) and the map's total
    stored energy against the JAX package's, within 3x the difference
    between two JAX seeds plus 3 sigma of one build's binomial noise."""
    js, jst = two_plane_scene()[:2] if name == "global" else caustic_scene()
    target = 2000 if name == "global" else 300
    cfg_kw = dict(photons_per_light=target if name == "global" else 0,
                  caustic_photons_per_light=target if name == "caustic"
                  else 0)
    refs = [stored_summary(*jp.build_photon_maps(
        js, jst, JCfg(**cfg_kw), jax.random.key(seed), return_stats=True),
        name) for seed in (1, 2)]
    ps, pst = interop.scene_from_numpy(np_tree(js), jst, "cpu")
    maps, st = tp.build_photon_maps(ps, pst, RenderConfig(**cfg_kw),
                                    torch.Generator().manual_seed(0),
                                    return_stats=True)
    assert st[name]["emitted"] % 10000 == 0 and st[name]["stored"] >= target
    grid = maps.global_map if name == "global" else maps.caustic_map
    assert grid.n_valid == target and grid.coarse is not None
    frac, energy, emitted = stored_summary(maps, st, name)
    (f0, e0, _), (f1, e1, _) = refs
    noise = np.sqrt(f0 * (1 - f0) / emitted)
    assert (np.abs(frac - f0) <= 3 * np.abs(f1 - f0) + 3 * noise).all(), (
        frac, f0, f1)
    assert (np.abs(energy - e0) <= 3 * np.abs(e1 - e0)
            + 3 * e0 / np.sqrt(target)).all(), (energy, e0, e1)


# ---------------------------------------------------------------------------
# renders with maps carried from the JAX package, and the gradient
# ---------------------------------------------------------------------------

def port_scene(js, jst, jcam, maps):
    return port_inputs(js.replace(photons=maps), jst, jcam)


def test_render_with_carried_maps(plane_maps):
    """render_hdr with both maps per pixel against the JAX package's,
    and the maps brighten the render (tests/test_photon.py:243-266)."""
    js, jst, jcam, maps = plane_maps
    cfg = dict(width=16, height=16, trace_depth=2)
    run = jax.jit(j_render, static_argnames=("static", "cfg"))
    want = np.asarray(run(js.replace(photons=maps), jst, jcam, JCfg(**cfg),
                          jax.random.key(0))[0])
    ps, pst, pcam = port_scene(js, jst, jcam, maps)
    with torch.no_grad():
        got = render_hdr(ps, pst, pcam, RenderConfig(**cfg))[0].numpy()
        base = render_hdr(ps.replace(photons=None), pst, pcam,
                          RenderConfig(**cfg))[0].numpy()
    np.testing.assert_allclose(got, want, **RENDER_TOL)
    assert (got >= base - 1e-6).all() and got.sum() > base.sum() * 1.01


def test_render_glass_with_caustic_map():
    """The caustic scene (a refractive sphere: children, closest-hit
    shadows) with its JAX-built caustic map, per pixel at 32x32 within
    test_golden.py's bar."""
    js, jst = caustic_scene()
    maps = jp.build_photon_maps(js, jst, JCfg(
        photons_per_light=0, caustic_photons_per_light=600),
        jax.random.key(3))
    jcam = make_camera(eye=(0, 3, 5), look_at=(0, 0.5, 0), fov=60)
    cfg = dict(width=32, height=32, trace_depth=3)
    want = np.asarray(jax.jit(j_render, static_argnames=("static", "cfg"))(
        js.replace(photons=maps), jst, jcam, JCfg(**cfg),
        jax.random.key(0))[0])
    ps, pst, pcam = port_scene(js, jst, jcam, maps)
    with torch.no_grad():
        got = render_hdr(ps, pst, pcam, RenderConfig(**cfg))[0].numpy()
    to8 = lambda h: np.round(255 / (1 + np.exp(-(6 * h - 3))))
    diff = np.abs(to8(got) - to8(want))
    assert np.mean(diff <= 2) >= 0.999 and diff.mean() <= 0.05
    assert np.mean(np.isclose(got, want, **RENDER_TOL)) >= 0.999


def port_gain_loss(ps, pst, pcam, cfg):
    """sum(hdr) as a function of a per-channel gain on the global map's
    stored powers (its coarse level left as built)."""
    g0 = ps.photons.global_map

    def loss(gain):
        g = g0.replace(power=g0.power * gain[None, :])
        scene = ps.replace(photons=ps.photons.replace(global_map=g))
        return render_hdr(scene, pst, pcam, cfg)[0].sum()
    return loss


def test_grad_photon_power_vs_jax_and_fd(plane_maps):
    """d sum(hdr) / d gain on the stored global powers against jax.grad
    on the same maps (rtol 1e-3), and against central differences as
    tests/test_grad_oracle.py::test_grad_photon_power does."""
    js, jst, jcam, maps = plane_maps
    maps = maps.replace(caustic_map=None)
    cfg = dict(width=8, height=8, trace_depth=1)
    jcfg = JCfg(**cfg)

    def f(gain):
        g = maps.global_map
        m = maps.replace(global_map=g.replace(power=g.power * gain[None, :]))
        return j_render(js.replace(photons=m), jst, jcam, jcfg,
                        jax.random.key(0))[0].sum()
    g_jax = np.asarray(jax.jit(jax.grad(f))(jnp.ones(3)))
    ps, pst, pcam = port_scene(js, jst, jcam, maps)
    loss = port_gain_loss(ps, pst, pcam, RenderConfig(**cfg))
    gain = torch.ones(3, requires_grad=True)
    loss(gain).backward()
    g = gain.grad.numpy()
    assert np.all(np.abs(g) > 0)
    np.testing.assert_allclose(g, g_jax, rtol=1e-3)
    h = 1e-2
    with torch.no_grad():
        fd = np.array([(float(loss(torch.ones(3) + h * e))
                        - float(loss(torch.ones(3) - h * e))) / (2 * h)
                       for e in torch.eye(3)])
    np.testing.assert_allclose(g, fd, rtol=2e-2, atol=1e-4)


def test_render_grad_same_at_any_chunk(plane_maps, monkeypatch):
    """The render's photon-power gradient (both maps, both levels) is
    the same whether the gather takes the lanes at once or in chunks of
    a few points."""
    js, jst, jcam, maps = plane_maps
    ps, pst, pcam = port_scene(js, jst, jcam, maps)
    cfg = RenderConfig(width=16, height=16, trace_depth=2)
    out = []
    for budget in (1 << 20, 27 * 64 * 5):
        monkeypatch.setattr(tp, "_CHUNK_CANDIDATES", budget)
        grids = {}
        for name in ("global_map", "caustic_map"):
            g = getattr(ps.photons, name)
            grids[name] = g.replace(
                power=g.power.clone().requires_grad_(True),
                coarse=g.coarse.replace(
                    power=g.coarse.power.clone().requires_grad_(True)))
        scene = ps.replace(photons=ps.photons.replace(**grids))
        render_hdr(scene, pst, pcam, cfg)[0].sum().backward()
        out.append([t.grad for g in grids.values()
                    for t in (g.power, g.coarse.power)])
    assert tp.gather_chunk(ps.photons.global_map) == 5
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    assert sum(float(t.abs().sum()) for t in out[0]) > 0


# ---------------------------------------------------------------------------
# checkpoints, overlay, command line
# ---------------------------------------------------------------------------

def test_checkpoints_load_across_packages(plane_maps, tmp_path):
    js, jst, jcam, maps = plane_maps
    jck.save_photon_maps(str(tmp_path / "j.npz"), maps)
    loaded = tck.load_photon_maps(str(tmp_path / "j.npz"), "cpu")
    assert loaded.global_map.coarse is None
    ref = jck.load_photon_maps(str(tmp_path / "j.npz"))
    assert_same_grid(loaded.global_map, ref.global_map)
    assert_same_grid(loaded.caustic_map, ref.caustic_map)
    # it renders as the JAX package renders its own load
    cfg = dict(width=16, height=16, trace_depth=1)
    want = np.asarray(jax.jit(j_render, static_argnames=("static", "cfg"))(
        js.replace(photons=ref), jst, jcam, JCfg(**cfg),
        jax.random.key(0))[0])
    ps, pst, pcam = port_inputs(js, jst, jcam)
    with torch.no_grad():
        got = render_hdr(ps.replace(photons=loaded), pst, pcam,
                         RenderConfig(**cfg))[0].numpy()
    np.testing.assert_allclose(got, want, **RENDER_TOL)
    # and a port-written file loads in the JAX package
    tck.save_photon_maps(str(tmp_path / "t.npz"), loaded)
    back = jck.load_photon_maps(str(tmp_path / "t.npz"))
    assert_same_grid(loaded.global_map, back.global_map)
    assert_same_grid(loaded.caustic_map, back.caustic_map)


def test_overlay_bytes_equal_jax(plane_maps):
    js, jst, jcam, maps = plane_maps
    ps, pst, pcam = port_scene(js, jst, jcam, maps)
    base = np.random.default_rng(0).integers(0, 200, (48, 64, 3), np.uint8)
    want = jviz.photon_overlay(base, np_tree(jcam), np_tree(maps), 64, 48)
    got = tviz.photon_overlay(base, pcam, ps.photons, 64, 48)
    assert got.tobytes() == want.tobytes()
    green = (got[:, :, 1] == 255) & (got[:, :, 0] == 40)
    red = (got[:, :, 0] == 255) & (got[:, :, 1] == 40)
    assert green.sum() > 20 and red.sum() > 0
    pts = np.asarray([np.asarray(jcam.eye + jcam.view_dir * 5.0),
                      np.asarray(jcam.eye - jcam.view_dir * 5.0)])
    for a, b in zip(tviz.project_points(pcam, pts, 48, 48),
                    jviz.project_points(np_tree(jcam), pts, 48, 48)):
        np.testing.assert_array_equal(a, b)


def run_cli(tmp_path, *extra, built=None):
    args = cli.parser().parse_args(
        ["render", "--scene", "sphere" if built is None else "two_plane",
         "--device", "cpu", "--width", "16", "--height", "16", "--depth",
         "2", "--out", str(tmp_path / "x.ppm"), *extra])
    return cli.render(args, built=built)


def test_cli_photons_without_emitter(tmp_path, capsys):
    """sphere has only point lights: --photons builds nothing, renders
    as without it, and the overlay says so."""
    plain = run_cli(tmp_path)["hdr"]
    res = run_cli(tmp_path, "--photons", "1000", "--visualize-photons",
                  str(tmp_path / "v.png"))
    err = capsys.readouterr().err
    assert res["photons"] is None and torch.equal(res["hdr"], plain)
    assert "[viz] no photon maps built" in err
    assert not (tmp_path / "v.png").exists()


def port_two_plane(glass=False):
    """two_plane_scene for the port; glass=True adds a glass sphere
    under the light, so the caustic map stores photons too."""
    js, jst, jcam = two_plane_scene()
    if glass:
        mb = MaterialBuilder()
        white = mb.phong(kd=(0.8, 0.8, 0.8))
        glass_m = mb.phong(kd=(0, 0, 0), kt=(1, 1, 1), ior=1.5)
        js, jst = make_scene(
            spheres=make_sphere_pool([(0, 1, 0)], [0.8], [glass_m]),
            planes=make_plane_pool([(0, 0, 0), (0, 4, 0)],
                                   [(0, 1, 0), (0, -1, 0)], [white, white]),
            materials=mb.build(), lights=[
                dict(kind=2, position=(0, 3, 0), normal=(0, -1, 0),
                     radius=1.0, color=(1, 1, 1), wattage=100.0)])
    return port_inputs(js, jst, jcam)


def test_cli_photon_lines_and_overlay(tmp_path, capsys):
    out = tmp_path / "v.ppm"
    res = run_cli(tmp_path, "--photons", "1000", "--caustic-photons", "200",
                  "--stats", "--visualize-photons", str(out),
                  built=port_two_plane(glass=True))
    err = capsys.readouterr().err
    assert "[photons] traced in" in err
    for name in ("global", "caustic"):
        st = res["photon_stats"][name]
        assert (f"[stats] photons {name}: emitted={st['emitted']} "
                f"stored={st['stored']} bounces={st['bounces']}") in err
    assert res["photons"].global_map.n_valid == 1000
    assert res["photons"].caustic_map.n_valid == 200
    img = load_ppm(out)
    assert ((img[:, :, 1] == 255) & (img[:, :, 0] == 40)).sum() > 20
    assert ((img[:, :, 0] == 255) & (img[:, :, 1] == 40)).sum() > 0
    assert "[viz] wrote" in err


def test_cli_no_photon_map_suppresses_the_map(tmp_path, capsys):
    lit = run_cli(tmp_path, "--photons", "500", built=port_two_plane())
    off = run_cli(tmp_path, "--photons", "500", "--no-photon-map",
                  built=port_two_plane())
    plain = run_cli(tmp_path, built=port_two_plane())
    assert "[photons]" in capsys.readouterr().err
    assert off["photons"] is None and torch.equal(off["hdr"], plain["hdr"])
    assert float(lit["hdr"].sum()) > float(off["hdr"].sum())


def test_device_split_counts_a_marked_range_once():
    """chip_smoke's split of a traced forward: the device-side user
    annotation of record_function("photon_gather") is a window, not a
    kernel, so kernel time stays within busy time and the gather's time
    is the union of the kernels inside its windows."""
    from types import SimpleNamespace

    from chip_smoke import device_split
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, s, e, dev=cuda, note=False):
        return SimpleNamespace(name=name, device_type=dev,
                               time_range=SimpleNamespace(start=s, end=e),
                               is_user_annotation=note)

    events = [
        ev("traverse_warp<4>", 0, 100),
        ev("photon_gather", 90, 400, dev=cpu, note=True),  # host range
        ev("photon_gather", 120, 300, note=True),          # device window
        ev("sort", 120, 200), ev("sort", 120, 200),        # listed twice
        ev("gather_rows", 200, 300),
        ev("traverse_warp<4>", 300, 350),
        ev("other_range", 0, 350, note=True),
    ]
    split = device_split(events, "photon_gather")
    assert split == dict(kernels=4, kernel_ms=0.33, busy_ms=0.33,
                         gather_ms=0.18, gather_ranges=1, traverse_ms=0.15)
    assert split["kernel_ms"] <= split["busy_ms"]
