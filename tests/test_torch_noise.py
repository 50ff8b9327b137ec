"""The port's Perlin and Worley noise against the JAX package's.

Points are made from a seed with numpy (negative coordinates included)
and go through the jitted JAX function and the port's. Bars: Perlin and
its turbulence within atol 2e-6 (the JAX package's own bar against the
reference's goldens; XLA may contract a multiply-add that PyTorch
rounds twice); Worley's F within rtol 1e-6 (one ulp at most was seen),
its delta within atol 1e-6 and its ids exactly, ties included."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)
from test_noise import (PERLIN_GOLDEN, PTS, WORLEY2_GOLDEN,  # noqa: E402
                        WORLEY3_GOLDEN)

from cse168_raytracer_tpu.core import noise as jn  # noqa: E402
from cse168_raytracer_tpu_torch.core import noise as pn  # noqa: E402

SEED = 11
N = 3000


def points(dim, lo=-40.0, hi=40.0):
    rng = np.random.default_rng(SEED + dim)
    return rng.uniform(lo, hi, (N, dim)).astype(np.float32)


def test_perlin_and_turbulence_match_jax():
    p = points(3)
    jp, jt = jax.jit(lambda p: (jn.perlin(p[:, 0], p[:, 1], p[:, 2]),
                                jn.perlin_turbulence(p, octaves=5)))(p)
    tp = torch.as_tensor(p)
    np.testing.assert_allclose(pn.perlin(tp[:, 0], tp[:, 1], tp[:, 2]),
                               np.asarray(jp), rtol=0, atol=2e-6)
    np.testing.assert_allclose(pn.perlin_turbulence(tp, octaves=5),
                               np.asarray(jt), rtol=0, atol=2e-6)


def test_noise_matches_reference_goldens():
    """The reference implementation's values at the JAX package's probe
    points (tests/test_noise.py), at that file's bars."""
    p = torch.as_tensor(PTS)
    np.testing.assert_allclose(pn.perlin(p[:, 0], p[:, 1], p[:, 2]),
                               PERLIN_GOLDEN, atol=2e-6)
    np.testing.assert_allclose(pn.worley3(p)[0], WORLEY3_GOLDEN, rtol=2e-5)
    np.testing.assert_allclose(pn.worley2(p[:, :2])[0], WORLEY2_GOLDEN,
                               rtol=2e-5)


def assert_worley_equal(got, want):
    (tf, td, ti), (jf, jd, ji) = got, [np.asarray(x) for x in want]
    np.testing.assert_allclose(tf.numpy(), jf, rtol=1e-6, atol=0)
    np.testing.assert_allclose(td.numpy(), jd, rtol=0, atol=1e-6)
    assert ji.dtype == np.uint32
    np.testing.assert_array_equal(ti.numpy(), ji.astype(np.int64))


@pytest.mark.parametrize("dim,order", [(2, 3), (3, 3), (2, 45)])
def test_worley_matches_jax(dim, order):
    """F, delta and ids of F1..Fn. order 45 ranks every slot of worley2's
    9 cells, so the masked slots, which all hold 999999.9, tie: their ids
    must come out in lax.top_k's order (the lowest slot first)."""
    p = points(dim)
    fn = {2: (jn.worley2, pn.worley2), 3: (jn.worley3, pn.worley3)}[dim]
    want = jax.jit(lambda p: fn[0](p, max_order=order))(p)
    got = fn[1](torch.as_tensor(p), max_order=order)
    if order == 45:
        # a masked slot reads F = sqrt(999999.9) / DENSITY_ADJUSTMENT
        assert (np.asarray(want[0]) > 2000).any(), "no tie was forced"
    assert_worley_equal(got, want)


def test_smallest_k_keeps_top_k_tie_order():
    rng = np.random.default_rng(SEED)
    x = rng.integers(0, 4, (64, 40)).astype(np.float32)   # many ties
    vals, idx = jax.lax.top_k(-jnp.asarray(x), 7)
    tv, ti = pn.smallest_k(torch.as_tensor(x), 7)
    np.testing.assert_array_equal(tv.numpy(), -np.asarray(vals))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(idx))


def test_uint32_seeds_in_int64():
    """The LCG and the seed-to-float conversion, carried in int64, give
    uint32's results bit for bit, at seeds near 2^32 and at cube indices
    below zero."""
    rng = np.random.default_rng(SEED)
    seeds = np.concatenate([
        np.arange(2**32 - 600, 2**32, dtype=np.uint64),
        rng.integers(0, 2**32, 4000, dtype=np.uint64),
        np.arange(0, 300, dtype=np.uint64),
        (2 ** np.arange(24, 33, dtype=np.uint64)) - 1,
    ]).astype(np.uint32)
    want_churn = seeds * np.uint32(1402024253) + np.uint32(586950981)
    ts = torch.as_tensor(seeds.astype(np.int64))
    np.testing.assert_array_equal(pn._churn(ts).numpy(),
                                  want_churn.astype(np.int64))
    jf = jax.jit(lambda s: (s.astype(jnp.float32) + 0.5)
                 * (1.0 / 4294967296.0))(seeds)
    got = pn.u32_to_float(ts).numpy()
    assert got.tobytes() == np.asarray(jf).tobytes()
    np.testing.assert_array_equal(
        got, (seeds.astype(np.float32) + np.float32(0.5))
        * np.float32(1.0 / 4294967296.0))
    cubes = rng.integers(-2**31, 2**31 - 1, (500, 3)).astype(np.int32)
    jc, jpts, jids = jax.jit(jn._cube_points_3d)(cubes)
    tc, tpts, tids = pn._cube_points(torch.as_tensor(cubes).long())
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tids.numpy(),
                                  np.asarray(jids).astype(np.int64))
    assert tpts.numpy().tobytes() == np.asarray(jpts).tobytes()


def test_worley_is_differentiable():
    p = torch.as_tensor(points(2)[:64]).requires_grad_(True)
    f, _, _ = pn.worley2(p, max_order=2)
    f.sum().backward()
    assert torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0
