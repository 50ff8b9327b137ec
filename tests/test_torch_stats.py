"""Kernel K3, the traversal's in-kernel counters, on the CPU.

On CPU tensors the counters come from ops/wide_bvh.walk_plain, the
kernel's own walk in plain PyTorch. It is held:
- against the brute-force oracle (wide_bvh.brute_force_triangles): the
  same hits;
- against the CUDA kernel's walk compiled for the host with g++
  (traverse_wide.cu's traverse_host): t, id and both visit counts equal,
  for W=4 and W=8, closest-hit and any-hit;
- against the Pallas kernel's with_stats mode in interpret mode, on
  batches laid out with one live ray in each 256-lane tile, so that the
  tile's count is that ray's own walk. The two walks then differ only
  where the port differs on purpose (ops/wide_bvh.py): its slots are
  widened by BOX_PAD, which can add visits, and the Pallas any-hit
  retires a ray at the next internal visit after its hit, so it counts
  that internal node and any leaves popped before it.
The kernel itself runs on the card: tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from cse168_raytracer_tpu.ops import pallas_bvh as jpb  # noqa: E402
from cse168_raytracer_tpu_torch.ops import wide_bvh as twb  # noqa: E402
from cse168_raytracer_tpu_torch.ops.stats import \
    traversal_stats  # noqa: E402
from cse168_raytracer_tpu_torch.utils import profiling  # noqa: E402
from test_torch_traverse import (BIG, MESHES, build_both,  # noqa: E402,F401
                                 check_against_brute, host_lib, host_walk,
                                 rays)

# Bars against the Pallas kernel, set from the differences above. A ray
# that walks to the end (every closest-hit ray, and an any-hit ray that
# finds no occluder) passes every slab test the Pallas walk passes, so it
# visits at least as much: an any-hit walk always (its interval never
# shrinks), a closest-hit walk nearly always (an early hit in a padded
# slot may cull a node later). Each case has its own bar on the share of
# such walks with equal counts and on how far the padding may raise the
# internal and leaf visit totals, set just past what was measured:
# - tri3000 (below): 96.9-98.5% equal; totals up 0-0.6%;
# - sponza_proxy's primary rays (tests/test_torch_render_stats.py): 89.5%
#   equal; internal visits up 0.4%, leaf visits 1.3%;
# - its shadow rays, whose walks start on a surface that the padded boxes
#   of neighbouring leaves take in: 52.3% equal; up 5.1% and 37.6%.
# Of the occluded any-hit rays 96.4-100% retire late as modelled.
BARS = {                # (share of full walks equal, padded excess)
    "tri3000": (0.95, 0.02),
    "sponza_proxy primary": (0.85, 0.03),
    "sponza_proxy shadow": (0.45, 0.45),
}
AT_LEAST_SHARE = 0.99   # closest-hit walks visiting at least as much
LATE_SHARE = 0.9        # occluded rays retiring as modelled


def as_t(r):
    return tuple(torch.as_tensor(x) for x in r)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_walk_plain_matches_brute_force(name, width):
    *_, tbvh = build_both(name, width)
    r = rays(80 + width, 1024)
    t, ids, n_int, n_leaf = twb.walk_plain(tbvh, *as_t(r))
    tp, idp, _ = twb.brute_force_triangles(tbvh, *as_t(r))
    check_against_brute(t.numpy(), ids.numpy(), tp.numpy(), idp.numpy())
    both = (t < BIG) & (tp < BIG)
    assert torch.equal(t[both], tp[both])     # one arithmetic, one order
    occ = twb.walk_plain(tbvh, *as_t(r), any_hit=True)[0] < BIG
    assert torch.equal(occ, tp < BIG)
    # dead rays visit nothing; every live ray visits at least the root
    live = torch.as_tensor(r[3] >= r[2])
    assert not n_int[~live].any() and not n_leaf[~live].any()
    assert bool(((n_int + n_leaf)[live] >= 1).all())


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", ["tri80", "tri3000"])
def test_walk_plain_equals_kernel_walk(host_walk, name, width, any_hit):
    """Exactly: t, id and both counts of every ray."""
    *_, tbvh = build_both(name, width)
    r = rays(90 + width, 2048)
    ht, hid, _, err, h_int, h_leaf = host_walk(tbvh, *r, any_hit=any_hit,
                                               with_stats=True)
    assert err == 0
    t, ids, n_int, n_leaf = twb.walk_plain(tbvh, *as_t(r), any_hit=any_hit)
    np.testing.assert_array_equal(t.numpy(), ht)
    np.testing.assert_array_equal(n_int.numpy(), h_int)
    np.testing.assert_array_equal(n_leaf.numpy(), h_leaf)
    if not any_hit:
        np.testing.assert_array_equal(ids.numpy(), hid)
    assert (h_leaf > 0).any() and (t.numpy() < BIG).any()
    # without counters the walk is the same
    t0, id0, *_ = host_walk(tbvh, *r, any_hit=any_hit)
    np.testing.assert_array_equal(t0, ht)
    if not any_hit:
        np.testing.assert_array_equal(id0, hid)


def pallas_counts(jbvh, o, d, tmin, tmax, any_hit):
    """The Pallas kernel's with_stats counts of each ray, walked alone in
    its own 256-lane tile (the other lanes are dead: tmax < tmin)."""
    n, T = o.shape[0], jpb.T
    lane = lambda x, fill: np.concatenate(
        [x[:, None], np.broadcast_to(fill, (n, T - 1) + x.shape[1:])],
        axis=1).reshape((n * T,) + x.shape[1:])
    args = (lane(o, o[:, None]), lane(d, d[:, None]),
            lane(tmin, np.float32(0)), lane(tmax, np.float32(-1)))
    h, box, tri = jpb.pallas_bvh_closest_hit_triangles(
        jbvh, *map(jnp.asarray, args), any_hit=any_hit, interpret=True,
        with_stats=True)
    pick = lambda x: np.asarray(x)[::T]
    return pick(h.hit), pick(box), pick(tri)


def assert_counts_agree(case, width, any_hit, t, box, tri, jhit, jbox,
                        jtri):
    """The port's per-ray tests (t, box, tri) against the Pallas kernel's
    one-ray-per-tile ones, allowing the differences set out above at the
    bars of BARS[case]."""
    exact_share, max_excess = BARS[case]
    hit = t < BIG
    np.testing.assert_array_equal(hit, jhit)
    # visits: W box tests per internal visit, K triangle tests per leaf
    p_int, p_leaf = box // width, tri // twb.K
    j_int, j_leaf = jbox // width, jtri // jpb.K
    same = (p_int == j_int) & (p_leaf == j_leaf)
    # rays that walk to the end: all closest-hit rays, unoccluded any-hit
    full = ~hit if any_hit else np.ones_like(hit)
    share = same[full].mean()
    at_least = ((p_int >= j_int) & (p_leaf >= j_leaf))[full].mean()
    print(f"W={width} any_hit={any_hit}: {share:.4f} of {full.sum()} full "
          f"walks with equal counts, {at_least:.4f} with at least as many; "
          f"internal visits {p_int[full].sum()} vs {j_int[full].sum()}, "
          f"leaf visits {p_leaf[full].sum()} vs {j_leaf[full].sum()}")
    assert share >= exact_share
    assert at_least == 1.0 if any_hit else at_least >= AT_LEAST_SHARE
    for p, j in ((p_int, j_int), (p_leaf, j_leaf)):
        top = (1 + max_excess) * j[full].sum()
        assert j[full].sum() <= p[full].sum() <= top
    if any_hit and hit.any():
        # an occluded ray: the Pallas walk counts one more internal node
        # (or none, when its stack held only leaves) and the leaves popped
        # before it
        late = ((j_int - p_int >= 0) & (j_int - p_int <= 1)
                & (j_leaf >= p_leaf))[hit]
        print(f"  occluded: {late.mean():.4f} of {hit.sum()} retire late "
              f"as the Pallas kernel does; {same[hit].mean():.4f} equal")
        assert late.mean() >= LATE_SHARE


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("width", [4, 8])
def test_counts_against_pallas_with_stats(width, any_hit):
    _, _, jbvh, _, _, tbvh = build_both("tri3000", width)
    o, d, tmin, tmax = rays(100 + width, 128)
    tmax = np.abs(tmax)
    plain = (twb.any_hit_triangles_plain if any_hit
             else twb.closest_hit_triangles_plain)
    out = plain(tbvh, *as_t((o, d, tmin, tmax)), with_stats=True)
    t, box, tri = (x.numpy() for x in (out[0], out[-2], out[-1]))
    assert (t < BIG).sum() > 10
    assert_counts_agree("tri3000", width, any_hit, t, box, tri,
                        *pallas_counts(jbvh, o, d, tmin, tmax, any_hit))


def test_stats_route_and_traversal_stats():
    """On CPU tensors the wrapper's counters are walk_plain's (no kernel
    launches), stats on leaves the hits as they are, and
    traversal_stats is their mean per ray."""
    *_, tbvh = build_both("tri3000", 4)
    r = as_t(rays(110, 512))
    before = profiling.counts(twb.LAUNCH)
    t, ids, attr, box, tri = twb.closest_hit_triangles(tbvh, *r,
                                                       with_stats=True)
    t0, ids0, attr0 = twb.closest_hit_triangles(tbvh, *r)
    both = (t < BIG) & (t0 < BIG)
    assert torch.equal(t < BIG, t0 < BIG) and torch.equal(t[both], t0[both])
    _, _, n_int, n_leaf = twb.walk_plain(tbvh, *r)
    assert torch.equal(box, 4 * n_int) and torch.equal(tri, twb.K * n_leaf)
    occ, abox, atri = twb.any_hit_triangles(tbvh, *r, with_stats=True)
    assert torch.equal(occ < BIG, t0 < BIG)
    assert int(abox.sum()) <= int(box.sum())  # any-hit stops early
    assert profiling.counts(twb.LAUNCH) == before
    st = traversal_stats(tbvh, r[0], r[1], r[2], r[3])
    assert st.rays == 512
    assert float(st.box_tests_per_ray) == pytest.approx(
        box.double().mean().item(), rel=1e-12)
    assert float(st.tri_tests_per_ray) == pytest.approx(
        tri.double().mean().item(), rel=1e-12)
