"""The port's device-stable arithmetic on the CPU (core/vecmath.py and the
integrator's accumulation) against numpy, the JAX package and PyTorch's
own ops.

sqrt_rn is the port's one route to a float32 root: correctly rounded,
as numpy's float32 root and JAX's (XLA's, which flushes subnormal
inputs to zero) are, where PyTorch's float32 root on the CPU is an ulp
low on about 0.6% of inputs; its gradient is torch.sqrt's formula.
div_scalar(x, c) is XLA's x / c for a Python number c: x times the
float32 reciprocal of c, which is also what PyTorch's CUDA kernel
computes, where PyTorch's CPU kernel divides. add_in_lane_order is
index_add with each pixel's terms added in lane order on every device.
The card's side of the same claims is in tests/test_torch_cuda.py and
chip_smoke.py's phase 13."""

import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)

from cse168_raytracer_tpu.core import vecmath as jvm  # noqa: E402
from cse168_raytracer_tpu.render import camera as jcam  # noqa: E402
from cse168_raytracer_tpu_torch.core import vecmath as vm  # noqa: E402
from cse168_raytracer_tpu_torch.render import camera as pcam  # noqa: E402
from cse168_raytracer_tpu_torch.render.integrator import \
    add_in_lane_order  # noqa: E402

PACKAGE = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                       "cse168_raytracer_tpu_torch")
TINY = np.finfo(np.float32).tiny


def root_inputs(n=1 << 20, seed=0):
    """n float32 values >= 0: zero, subnormals (one in 16), 1e30, and the
    rest log-uniform over [2^-126, 1e38]."""
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(np.log(TINY), np.log(1e38), n)).astype(np.float32)
    k = n // 16
    x[:k] = rng.integers(1, 1 << 23, k).astype(np.int32).view(np.float32)
    x[k:k + 3] = (0.0, 1e30, 1.0)
    return x


def test_sqrt_rn_equals_numpy_and_jax():
    """Bit for bit: numpy's float32 root everywhere, JAX's jitted root
    everywhere but on subnormal inputs (XLA's CPU flushes them to 0);
    PyTorch's float32 root on the CPU is an ulp low on some inputs."""
    x = root_inputs()
    got = vm.sqrt_rn(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(x).view(np.int32))
    want_jax = np.asarray(jax.jit(jnp.sqrt)(x))
    normal = x >= TINY
    np.testing.assert_array_equal(got[normal].view(np.int32),
                                  want_jax[normal].view(np.int32))
    assert (want_jax[~normal] == 0).all()
    assert (got[~normal & (x > 0)] > 0).all()
    off = torch.sqrt(torch.from_numpy(x)).numpy() != got
    assert 0 < off.mean() < 0.02


def test_sqrt_rn_gradient_is_torch_sqrts():
    """The gradient is torch.sqrt's formula, grad / (2 * root), at the
    correctly rounded root: equal to torch.sqrt's gradient wherever
    torch.sqrt's root is that root."""
    x = torch.from_numpy(root_inputs(1 << 16, seed=1)[1 << 12:]).double()
    x = x.clamp(min=1e-30, max=1e30).float()
    g = torch.rand(x.shape, generator=torch.Generator().manual_seed(2))
    a = x.clone().requires_grad_(True)
    r = vm.sqrt_rn(a)
    r.backward(g)
    b = x.clone().requires_grad_(True)
    ref = torch.sqrt(b)
    ref.backward(g)
    same = r.detach() == ref.detach()
    assert same.float().mean() > 0.98
    assert torch.equal(a.grad[same], b.grad[same])
    assert torch.equal(a.grad, g / (2 * r.detach()))


def _sqrt_calls(path):
    """(line, code) of each square-root call in a module: torch.sqrt,
    torch.rsqrt and Tensor.sqrt / .rsqrt / .sqrt_ (numpy's and math's
    are host float64 and are not counted)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    allowed = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and \
                node.name in ("sqrt_rn", "_RootRN"):
            allowed |= {id(n) for n in ast.walk(node)}
    out = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("sqrt", "rsqrt", "sqrt_")
                and not (isinstance(node.func.value, ast.Name)
                         and node.func.value.id in ("np", "math"))
                and id(node) not in allowed):
            out.append((node.lineno, ast.unparse(node)))
    return out


def test_no_float32_root_outside_sqrt_rn():
    """No module of the port takes a float32 root except through
    core/vecmath.sqrt_rn (whose two routes are the only calls)."""
    found = {}
    for root, _, files in os.walk(PACKAGE):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                calls = _sqrt_calls(path)
                if calls:
                    found[os.path.relpath(path, PACKAGE)] = calls
    assert found == {}, found
    assert _sqrt_calls(os.path.join(PACKAGE, "core", "vecmath.py")) == []


@pytest.mark.parametrize("c", [3.0, 480.0, 640.0, 2 * np.pi, np.pi, 0.1,
                               5.0, 20.0, 1.9999389648437500, 2e-4])
def test_div_scalar_is_xlas_division(c):
    """div_scalar(x, c) equals the JAX package's jitted x / c bit for bit
    (XLA multiplies by the float32 reciprocal of a constant divisor),
    where PyTorch's CPU division differs on many inputs."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal(1 << 16) * np.exp(rng.uniform(-20, 20, 1 << 16))
         ).astype(np.float32)
    got = vm.div_scalar(torch.from_numpy(x), c).numpy()
    want = np.asarray(jax.jit(lambda v: v / c)(x))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    true_div = (torch.from_numpy(x) / c).numpy()
    assert (true_div != got).any() == (np.log2(c) % 1 != 0)


def test_eye_rays_at_640x480_match_jax():
    """The camera's divisions by the width and height (div_scalar): the
    port's rays at 640x480 against the JAX package's jitted eye_rays."""
    w, h = 640, 480
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    spec = dict(eye=(9.0, 1.0, 0.0), look_at=(0.0, 0.0, 0.0), fov=90.0)
    jo, jd = jax.jit(lambda x, y: jcam.eye_rays(
        jcam.make_camera(**spec), x, y, w, h))(xs.ravel(), ys.ravel())
    po, pd = pcam.eye_rays(pcam.make_camera(**spec, device="cpu"),
                           torch.from_numpy(xs.ravel()),
                           torch.from_numpy(ys.ravel()), w, h)
    np.testing.assert_array_equal(po.numpy(), np.asarray(jo))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)


def _optics_inputs(n=1 << 14, seed=4):
    rng = np.random.default_rng(seed)
    unit = lambda v: (v / np.linalg.norm(v, axis=-1, keepdims=True)
                      ).astype(np.float32)
    d = unit(rng.standard_normal((n, 3)))
    nrm = unit(rng.standard_normal((n, 3)))
    ior = rng.uniform(1.0, 2.5, n).astype(np.float32)
    return d, nrm, ior


def test_normalize_refract_fresnel_match_jax():
    """normalize, refract and fresnel_rs (each root through sqrt_rn)
    against the JAX package's jitted functions on the same inputs, at the
    port's per-pixel bar (rtol 1e-4, atol 1e-5): the JAX normalize takes
    rsqrt and sums in XLA's order, so a few grazing refractions differ by
    more than an ulp."""
    d, nrm, ior = _optics_inputs()
    v = (d * np.float32(3.7) + np.float32(0.25)).astype(np.float32)
    tol = dict(rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(vm.normalize(torch.from_numpy(v)).numpy(),
                               np.asarray(jax.jit(jvm.normalize)(v)), **tol)
    pr, ptir = vm.refract(*map(torch.from_numpy, (d, nrm, ior)))
    jr, jtir = jax.jit(jvm.refract)(d, nrm, ior)
    np.testing.assert_array_equal(ptir.numpy(), np.asarray(jtir))
    np.testing.assert_allclose(pr.numpy(), np.asarray(jr), **tol)
    pf = vm.fresnel_rs(*map(torch.from_numpy, (d, nrm, ior))).numpy()
    jf = np.asarray(jax.jit(jvm.fresnel_rs)(d, nrm, ior))
    np.testing.assert_allclose(pf, jf, **tol)


def test_add_in_lane_order_is_index_add():
    """Repeated pixels, dead lanes (zero terms), terms of mixed
    magnitudes: equal to the CPU's index_add, whose order is the lanes',
    and the same gradient on the alive lanes (none on the dead ones)."""
    g = torch.Generator().manual_seed(5)
    n, n_pix = 4096, 512
    pixel = torch.randint(0, n_pix, (n,), generator=g)
    alive = torch.rand(n, generator=g) < 0.8
    terms = torch.rand((n, 3), generator=g) * torch.exp(
        6 * torch.randn((n, 3), generator=g))
    terms = torch.where(alive[:, None], terms, 0.0).requires_grad_(True)
    base = torch.rand((n_pix, 3), generator=g)
    got = add_in_lane_order(base, pixel, terms, alive)
    want = base.index_add(0, pixel, terms)
    assert torch.equal(got, want)
    w = torch.rand((n_pix, 3), generator=g)
    ga, = torch.autograd.grad((got * w).sum(), terms)
    gb, = torch.autograd.grad((want * w).sum(), terms)
    assert torch.equal(ga[alive], gb[alive]) and not ga[~alive].any()
    # the order shows: summing the terms first rounds differently
    pairwise = base + torch.zeros_like(base).index_add(0, pixel, terms)
    assert not torch.equal(got, pairwise)
