"""The port's samplers against the JAX package's, on the same uniforms.

PyTorch cannot replay jax.random, so each test makes its uniforms from a
seed with numpy and feeds them to both sides: to the port's functions of
explicit uniforms directly, and to the JAX function by standing in for
the `jax.random.uniform` draws it makes (in order, each checked for the
shape the JAX function asks for). Bar: rtol 1e-6 with an absolute floor
of 2e-6 (unit vectors, and points of size ~10): the transforms run sin,
cos, acos, sqrt and pow, which may differ by an ulp or two between
XLA's and PyTorch's CPU kernels."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from cse168_raytracer_tpu.core import sampling as js  # noqa: E402
from cse168_raytracer_tpu.core import vecmath as jv  # noqa: E402
from cse168_raytracer_tpu.models import lights as jl  # noqa: E402
from cse168_raytracer_tpu.render import camera as jc  # noqa: E402
from cse168_raytracer_tpu_torch.core import sampling as ts  # noqa: E402
from cse168_raytracer_tpu_torch.core import vecmath as tv  # noqa: E402
from cse168_raytracer_tpu_torch.models import lights as tl  # noqa: E402
from cse168_raytracer_tpu_torch.render import camera as tc  # noqa: E402

TOL = dict(rtol=1e-6, atol=2e-6)
N = 512
KEY = jax.random.key(0)
LIGHTS = [
    dict(kind=0, position=(1.0, 4.0, -2.0), color=(1, 1, 1), wattage=300.0),
    dict(kind=1, position=(0.5, 5.0, 0.3), normal=(0.1, -1.0, 0.2),
         dims=(1.5, 0.75), color=(1, 0.9, 0.8), wattage=500.0),
    dict(kind=2, position=(0.0, 6.0, 1.0), normal=(0.2, -1.0, -0.1),
         radius=1.7, color=(1, 1, 1), wattage=20.0),
]


@pytest.fixture
def feed(monkeypatch):
    """feed(u1, u2, ...): the JAX package's next jax.random.uniform
    draws return u1, u2, ... (numpy float32 arrays of the asked shape)."""
    queue = []

    def fake_uniform(key, shape=(), dtype=jnp.float32, *args, **kw):
        u = queue.pop(0)
        assert tuple(shape) == u.shape, (shape, u.shape)
        return jnp.asarray(u, dtype)

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)

    def push(*arrays):
        queue.extend(arrays)
        return [torch.as_tensor(a) for a in arrays]

    yield push
    assert not queue, "a fed draw was not taken"


def uniforms(seed, shape):
    return np.random.default_rng(seed).uniform(
        0, 1, tuple(shape) + (2,)).astype(np.float32)


def close(port, ref):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref), **TOL)


def unit_vectors(seed, n=N):
    """Seeded unit vectors; first the degenerate and near-degenerate
    axes of the tangent frame (along +-z, and within 1e-3 of it)."""
    v = np.random.default_rng(seed).normal(0, 1, (n, 3))
    v[:6] = [[0, 0, 1], [0, 0, -1], [1e-4, 0, 1], [0, -1e-3, -1],
             [1e-3, 1e-3, 1], [0, 1, 0]]
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def test_tangent_frames_and_align_hemisphere():
    v = unit_vectors(1)
    rng = np.random.default_rng(2)
    theta = rng.uniform(0, 2 * np.pi, N).astype(np.float32)
    phi = rng.uniform(0, np.pi / 2, N).astype(np.float32)
    out = tv.align_hemisphere(*map(torch.as_tensor, (v, theta, phi)))
    close(out, jv.align_hemisphere(*map(jnp.asarray, (v, theta, phi))))
    # the degenerate axis takes the y fallback; the frame is the
    # reference's unnormalized one, and onb its normalized form
    for port, ref in zip(tv.get_tangents(torch.as_tensor(v)),
                         jv.get_tangents(jnp.asarray(v))):
        close(port, ref)
    for port, ref in zip(tv.onb(torch.as_tensor(v)), jv.onb(jnp.asarray(v))):
        close(port, ref)
    assert np.allclose(np.linalg.norm(out.numpy(), axis=1), 1, atol=1e-6)


@pytest.mark.parametrize("shininess", [0.0, 10.0, 1000.0])
def test_phong_lobe(feed, shininess):
    axis = unit_vectors(3)
    s = np.full(N, shininess, np.float32)
    u = uniforms(4, (N,))
    u[:3, 0] = [0.0, 1e-20, 1.0]          # below and at the 1e-12 clip
    (tu,) = feed(u)
    jd, jcos = js.phong_lobe(KEY, jnp.asarray(axis), jnp.asarray(s))
    td, tcos = ts.phong_lobe(tu, torch.as_tensor(axis), torch.as_tensor(s))
    close(td, jd)
    close(tcos, jcos)


def test_cosine_sphere_hemisphere_disc(feed):
    n = unit_vectors(5)
    u = [uniforms(6 + i, (N,)) for i in range(4)]
    tu = feed(*u)
    jd, jpdf = js.cosine_hemisphere(KEY, jnp.asarray(n))
    td, tpdf = ts.cosine_hemisphere(tu[0], torch.as_tensor(n))
    close(td, jd)
    close(tpdf, jpdf)
    close(ts.uniform_sphere(tu[1]), js.uniform_sphere(KEY, (N,)))
    close(ts.uniform_hemisphere(tu[2], torch.as_tensor(n)),
          js.uniform_hemisphere(KEY, jnp.asarray(n)))
    close(ts.uniform_disc(tu[3], 0.7), js.uniform_disc(KEY, 0.7, (N,)))


@pytest.mark.parametrize("n_side", [1, 7])
def test_stratified_grid_jitter(feed, n_side):
    (tu,) = feed(uniforms(10, (n_side, n_side)))
    close(ts.stratified_grid_jitter(tu, n_side),
          js.stratified_grid_jitter(KEY, n_side))


def light_tables():
    return jl.make_light_table(LIGHTS), tl.make_light_table(LIGHTS, "cpu")


@pytest.mark.parametrize("sample_idx,total", [(0, 1), (5, 9)])
@pytest.mark.parametrize("li", [0, 1, 2])
def test_sample_origin(feed, li, sample_idx, total):
    """sample_origin draws the square's uniforms, then the disc's; each
    kind takes its own (a point light none)."""
    jlt, tlt = light_tables()
    u_sq, u_disc = uniforms(11, (N,)), uniforms(12, (N,))
    feed(u_sq, u_disc)
    ref = jl.sample_origin(jlt, li, KEY, (N,), sample_idx, total)
    u = u_disc if li == 2 else u_sq
    close(tl.sample_origin(tlt, li, torch.as_tensor(u), sample_idx, total),
          ref)


@pytest.mark.parametrize("sample_idx,total", [(0, 1), (3, 4)])
@pytest.mark.parametrize("li", [0, 1, 2])
def test_nee_sample(feed, li, sample_idx, total):
    jlt, tlt = light_tables()
    rng = np.random.default_rng(13)
    p = rng.uniform(-3, 3, (N, 3)).astype(np.float32)
    n = unit_vectors(14)
    u_sq = uniforms(15, (N,))
    feed(u_sq, uniforms(16, (N,)))
    ref = jl.nee_sample(jlt, li, jnp.asarray(p), jnp.asarray(n), KEY,
                        sample_idx, total)
    out = tl.nee_sample(tlt, li, torch.as_tensor(p), torch.as_tensor(n),
                        torch.as_tensor(u_sq) if li == 1 else None,
                        sample_idx, total)
    for f in ("l", "dist", "falloff", "n_dot_l"):
        close(getattr(out, f), getattr(ref, f))
    np.testing.assert_array_equal(out.in_beam.numpy(), np.asarray(ref.in_beam))
    if li == 2:       # the directional beam lights some points, not all
        assert 0 < int(out.in_beam.sum()) < N


@pytest.mark.parametrize("aperture", [0.0, 0.2])
def test_eye_rays_jittered_and_thin_lens(feed, aperture):
    jcam = jc.make_camera(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55)
    tcam = tc.make_camera(eye=(8, 1.5, 1), look_at=(0, 2.5, -1), fov=55,
                          device="cpu")
    w, h = 24, 16
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    xs, ys = xs.ravel(), ys.ravel()
    # the jitter, then (thin lens only) the lens
    fed = feed(uniforms(17, xs.shape),
               *([uniforms(18, xs.shape)] if aperture else []))
    tj, tl_ = fed[0], (fed[1] if aperture else None)
    jo, jd = jc.eye_rays(jcam, jnp.asarray(xs), jnp.asarray(ys), w, h,
                         key=KEY, dof_aperture=aperture, dof_focus=15.3)
    to, td = tc.eye_rays(tcam, torch.as_tensor(xs), torch.as_tensor(ys), w,
                         h, jitter=tj, lens=tl_, dof_aperture=aperture,
                         dof_focus=15.3)
    close(to, jo)
    close(td, jd)


def test_draw_wrappers_take_uniforms_from_the_generator():
    """Each draw_* wrapper equals its transform on the generator's next
    uniforms, and a reseeded generator repeats the sampled render inputs."""
    axis = torch.as_tensor(unit_vectors(19, 64))
    s = torch.full((64,), 10.0)
    g1 = torch.Generator().manual_seed(5)
    g2 = torch.Generator().manual_seed(5)
    u = lambda *shape: ts.uniform(g2, shape)
    pairs = [
        (ts.draw_phong_lobe(g1, axis, s), ts.phong_lobe(u(64, 2), axis, s)),
        (ts.draw_cosine_hemisphere(g1, axis),
         ts.cosine_hemisphere(u(64, 2), axis)),
        (ts.draw_uniform_sphere(g1, (64,)), ts.uniform_sphere(u(64, 2))),
        (ts.draw_uniform_hemisphere(g1, axis),
         ts.uniform_hemisphere(u(64, 2), axis)),
        (ts.draw_uniform_disc(g1, 0.3, (64,)), ts.uniform_disc(u(64, 2), 0.3)),
        (ts.draw_stratified_grid_jitter(g1, 4),
         ts.stratified_grid_jitter(u(4, 4, 2), 4)),
    ]
    for a, b in pairs:
        for x, y in zip(*((a, b) if isinstance(a, tuple) else ((a,), (b,)))):
            assert torch.equal(x, y)
    cam = tc.make_camera(eye=(0, 1, 5), look_at=(0, 0, 0), device="cpu")
    x = torch.arange(64) % 8
    y = torch.arange(64) // 8
    o1, r1 = tc.draw_eye_rays(cam, x, y, 8, 8, g1, 0.2, 15.3)
    o2, r2 = tc.eye_rays(cam, x, y, 8, 8, ts.uniform(g2, (64, 2)),
                         ts.uniform(g2, (64, 2)), 0.2, 15.3)
    assert torch.equal(o1, o2) and torch.equal(r1, r2)
    _, tlt = light_tables()
    p = torch.zeros(64, 3)
    n1 = tl.draw_nee_sample(tlt, 1, p, axis, g1, 2, 4)
    n2 = tl.nee_sample(tlt, 1, p, axis, ts.uniform(g2, (64, 2)), 2, 4)
    assert torch.equal(n1.l, n2.l) and torch.equal(n1.dist, n2.dist)
