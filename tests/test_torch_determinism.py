"""The port's fixed orders of summation and its photon arithmetic.

- The photon tracer's divisions equal jitted JAX's bit for bit (the
  roulette's mean of three, the caustic power's tenth), and its stored
  photons hold to test_torch_photon.py's bars on fed uniforms.
- vecmath.sum_fixed (the photon gather's sums) equals a pure-Python
  pairwise sum; ops/segment_sum.py's plain version equals a pure-Python
  tree over each row's run (empty rows, runs of one, runs across 1,024
  terms, -0.0), and a row's sum does not depend on other rows' lanes.
- The gradients that go through segment_sum: the photon-power gradient
  is the same bits at every forward chunk and holds to plain autograd at
  several backward chunks; the kd gradient holds to jax.grad on a
  render whose runs cross a tile; take_rows' and ReattachRows' backwards
  equal F.embedding's and index_add_'s wherever the terms are integers
  (then every order gives the same sum), and hold to rtol 1e-6
  elsewhere.
- The card kernel csrc/segment_sum.cu, built for the host through
  test_torch_traverse.py's emulation of CUDA, equals segment_sum_plain
  exactly and itself across two runs (one row, with no sort; 1-19 key
  bits; runs of 1-70 terms at every offset from 32- and 1,024-lane
  edges; descending ids; every term in the last row; -0.0 beside an
  empty row; 29 sparse columns), and its radix sort gives
  torch.sort(stable=True)'s permutation.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_determinism.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)
import torch.nn.functional as F  # noqa: E402

from cse168_raytracer_tpu.ops import photon as jp  # noqa: E402
from cse168_raytracer_tpu_torch import interop  # noqa: E402
from cse168_raytracer_tpu_torch.config import PI  # noqa: E402
from cse168_raytracer_tpu_torch.core.fastgather import take_rows  # noqa: E402
from cse168_raytracer_tpu_torch.core.vecmath import sum_fixed  # noqa: E402
from cse168_raytracer_tpu_torch.ops import photon as tp  # noqa: E402
from cse168_raytracer_tpu_torch.ops import segment_sum as ss  # noqa: E402
from cse168_raytracer_tpu_torch.ops.surface import ReattachRows  # noqa: E402
from cse168_raytracer_tpu_torch.utils import profiling  # noqa: E402
from test_torch_photon import (N_TRACE, caustic_scene,  # noqa: E402
                               compare_batches, fed_uniforms, feed_trace,
                               gather_case, np_tree, plain_irradiance)
from test_torch_render import assert_render_matches, jax_scene  # noqa: E402
from test_torch_sampling import feed  # noqa: E402,F401  (fixture)
from test_torch_traverse import emulated_build  # noqa: E402


def bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------------------
# C1: the photon tracer's divisions, against jitted JAX
# ---------------------------------------------------------------------------

def test_avg_is_jitted_jnp_mean():
    """The roulette's average of three, over 2^16 rows: texture colours
    in [0, 1] and magnitudes over many binades; the division by 3.0 it
    replaced differs from JAX on a share of them."""
    rng = np.random.default_rng(0)
    n = 1 << 16
    x = np.concatenate([rng.uniform(0, 1, (n // 2, 3)),
                        np.exp(rng.uniform(-30, 30, (n // 2, 3)))]
                       ).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.mean(a, -1))(x))
    t = torch.as_tensor(x)
    np.testing.assert_array_equal(bits(tp._avg(t).numpy()), bits(want))
    divided = ((t[:, 0] + t[:, 1]) + t[:, 2]) / 3.0
    assert (bits(divided.numpy()) != bits(want)).sum() > n // 10


@pytest.mark.parametrize("caustic", [False, True])
def test_emitted_power_is_jitted_jax(caustic):
    """A directional-area light's photon power, p0 * area / 10 for a
    caustic photon, as the JAX tracer computes it under jit
    (cse168_raytracer_tpu/ops/photon.py:350-354), over 2^16 lights."""
    rng = np.random.default_rng(1 + caustic)
    n = 1 << 16
    color = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    watt = rng.uniform(0, 100, n).astype(np.float32)
    radius = rng.uniform(0, 5, n).astype(np.float32)

    def jax_power(color, watt, radius):
        p0 = color * watt[:, None]
        area = PI * radius ** 2
        return jnp.where(True, p0 * area[:, None]
                         / (10.0 if caustic else 1.0), p0)

    want = np.asarray(jax.jit(jax_power)(color, watt, radius))
    c, w, r = (torch.as_tensor(a) for a in (color, watt, radius))
    got = tp.emitted_power(c * w[:, None], (PI * (r * r))[:, None], caustic)
    np.testing.assert_array_equal(bits(got.numpy()), bits(want))


@pytest.mark.parametrize("caustic", [False, True])
def test_trace_fed_matches_jax(feed, caustic):
    """trace_photon_batch on fed uniforms against the JAX tracer's
    stored photons, at test_torch_photon.py's bars."""
    js, jst = caustic_scene()
    ps, pst = interop.scene_from_numpy(np_tree(js), jst, "cpu")
    un = fed_uniforms(40 + caustic, N_TRACE, 6, False)
    u = feed_trace(feed, un)
    ref = jp.trace_photon_batch(js, jst, 0, N_TRACE, caustic, 5, False,
                                jax.random.key(0))
    port = tp.trace_photon_batch(ps, pst, 0, caustic, False, u)
    compare_batches(port, ref)
    assert port.mask.numpy().sum() > 0


# ---------------------------------------------------------------------------
# the orders
# ---------------------------------------------------------------------------

def pairwise(xs):
    """The sum of sum_fixed's order, written as a recursion: the sum of
    a power-of-two list is the sum of its even positions plus the sum of
    its odd ones; a list is padded with -0.0 to a power of two."""
    xs = [np.float32(v) for v in xs]
    p = 1
    while p < len(xs):
        p *= 2
    xs += [np.float32(-0.0)] * (p - len(xs))

    def rec(v):
        if len(v) == 1:
            return v[0]
        return np.float32(rec(v[0::2]) + rec(v[1::2]))
    return rec(xs)


def run_tree(vals):
    """Round s, h = 2^s: rank k with k % 2h == 0 adds rank k + h if that
    is in the run; rank 0 at the end. +0.0 for an empty run."""
    a = [np.float32(v) for v in vals]
    h = 1
    while h < len(a):
        for k in range(0, len(a), 2 * h):
            if k + h < len(a):
                a[k] = np.float32(a[k] + a[k + h])
        h *= 2
    return a[0] if a else np.float32(0.0)


def wild(rng, shape):
    """float32 values over many binades with signs, -0.0 and
    subnormals among them."""
    x = (rng.normal(0, 1, shape) * np.exp(rng.normal(0, 6, shape))
         ).astype(np.float32)
    flat = x.reshape(-1)
    flat[::11] = -0.0
    flat[5::13] = rng.integers(1, 1 << 20, flat[5::13].shape).astype(
        np.int32).view(np.float32) * np.float32(-1.0)
    return x


@pytest.mark.parametrize("n", [1, 2, 3, 27, 864, 1000, 1728])
def test_sum_fixed_is_pairwise(n):
    rng = np.random.default_rng(n)
    x = wild(rng, (5, n))
    x[0] = -0.0
    got = sum_fixed(torch.as_tensor(x), 1).numpy()
    want = np.array([pairwise(row) for row in x], np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))
    # the same along another axis, with a trailing axis kept
    got_t = sum_fixed(torch.as_tensor(np.ascontiguousarray(x.T))[:, :, None],
                      0)[:, 0].numpy()
    np.testing.assert_array_equal(bits(got_t), bits(want))


def segment_case(rng, cols, big=3000):
    """ids (N,) over 70 rows (rows 2, 5 and 64-69 empty) with runs of
    `big`, 1,025, 1,024, 33 and 1 terms and short ones, shuffled."""
    ids = np.concatenate([np.zeros(big, np.int64), np.full(1025, 1),
                          np.full(1024, 3), np.full(33, 4), [6, 7],
                          rng.integers(8, 64, 700)])
    rng.shuffle(ids)
    return wild(rng, (ids.size, cols)), ids, 70


def assert_run_trees(got, values, ids, n_rows):
    want = np.array([[run_tree(values[ids == r, c])
                      for c in range(values.shape[1])]
                     for r in range(n_rows)], np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("cols", [1, 3, 29])
def test_segment_sum_plain_is_the_run_tree(cols):
    rng = np.random.default_rng(cols)
    values, ids, n_rows = segment_case(rng, cols)
    values[ids == 6] = -0.0           # a run of one -0.0 stays -0.0
    got = ss.segment_sum_plain(torch.as_tensor(values), torch.as_tensor(ids),
                               n_rows).numpy()
    assert_run_trees(got, values, ids, n_rows)
    assert (bits(got[6]) == bits(np.float32(-0.0))).all()
    assert (bits(got[[2, 5, 64]]) == 0).all()    # empty rows are +0.0


def test_segment_sum_row_ignores_other_rows_lanes():
    """Moving the other rows' lanes about (this row's lanes stay where
    they are) leaves this row's sum as it was."""
    rng = np.random.default_rng(7)
    values, ids, n_rows = segment_case(rng, 3)
    want = ss.segment_sum_plain(torch.as_tensor(values), torch.as_tensor(ids),
                                n_rows)
    for row in (0, 1, 4):
        others = np.flatnonzero(ids != row)
        moved = others[rng.permutation(others.size)]
        v2, i2 = values.copy(), ids.copy()
        v2[others], i2[others] = values[moved], ids[moved]
        got = ss.segment_sum_plain(torch.as_tensor(v2), torch.as_tensor(i2),
                                   n_rows)
        assert torch.equal(got[row], want[row])


def test_segment_sum_routes_by_device():
    rng = np.random.default_rng(3)
    values, ids, n_rows = segment_case(rng, 2, big=10)
    v, i = torch.as_tensor(values), torch.as_tensor(ids)
    assert torch.equal(ss.segment_sum(v, i, n_rows),
                       ss.segment_sum_plain(v, i, n_rows))
    assert torch.equal(ss.segment_sum(v[:0], i[:0], 4), torch.zeros(4, 2))
    with pytest.raises(ValueError, match="no kernel"):
        ss.segment_sum(v.to("meta"), i.to("meta"), n_rows)
    with pytest.raises(ValueError, match="need values"):
        ss.segment_sum(v, i[:-1], n_rows)


# ---------------------------------------------------------------------------
# the gradients
# ---------------------------------------------------------------------------

def photon_grads(grid, q, n, weight, chunk):
    fine = grid.power.clone().requires_grad_(True)
    coarse = grid.coarse.power.clone().requires_grad_(True)
    g = grid.replace(power=fine, coarse=grid.coarse.replace(power=coarse))
    (tp.grid_irradiance(g, q, n, chunk=chunk) * weight).sum().backward()
    return fine.grad, coarse.grad


def photon_case():
    """700 points in and around test_torch_photon.py's sparse cluster:
    some take the fine level, some the coarse one."""
    pos, power, dirs, kw, q, nrm = gather_case("sparse")
    rng = np.random.default_rng(5)
    near = pos[rng.integers(0, pos.shape[0], 659)]
    q = np.concatenate([q, near + rng.normal(0, 0.02, (659, 3))]
                       ).astype(np.float32)
    nrm = np.concatenate([nrm] * 18)[:q.shape[0]]
    grid = tp.build_grid(pos, power, dirs, **dict(kw, knn=150), device="cpu")
    weight = torch.as_tensor(rng.uniform(0.5, 1.5, (q.shape[0], 3)).astype(
        np.float32))
    return grid, torch.as_tensor(q), torch.as_tensor(nrm), weight


def test_photon_power_grad_same_bits_at_any_chunk():
    grid, q, n, weight = photon_case()
    assert q.shape[0] == 700
    grads = [photon_grads(grid, q, n, weight, c) for c in (1, 7, 606, 700)]
    fine, coarse = grads[-1]
    assert fine.abs().sum() > 0 and coarse.abs().sum() > 0
    for f, c in grads[:-1]:
        assert torch.equal(f, fine) and torch.equal(c, coarse)


def test_photon_power_grad_over_backward_chunks(monkeypatch):
    """Backward chunks of 5 and 64 points: the same gradient as plain
    autograd through _gather_level within rtol 1e-6 (only the order of
    the sums differs), and the same bits at two forward chunks."""
    grid, q, n, weight = photon_case()
    q, n, weight = q[:150], n[:150], weight[:150]
    fine = grid.power.clone().requires_grad_(True)
    coarse = grid.coarse.power.clone().requires_grad_(True)
    (plain_irradiance(grid, q, n, fine, coarse, 16) * weight).sum().backward()
    for points in (5, 64):
        monkeypatch.setattr(tp, "_BACKWARD_CANDIDATES",
                            points * 27 * grid.max_per_cell)
        assert tp.backward_chunk(grid) == points
        a = photon_grads(grid, q, n, weight, 16)
        b = photon_grads(grid, q, n, weight, 150)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        torch.testing.assert_close(a[0], fine.grad, rtol=1e-6, atol=1e-9)
        torch.testing.assert_close(a[1], coarse.grad, rtol=1e-6, atol=1e-9)


def test_kd_grad_matches_jax_across_a_tile():
    """The sphere scene at 48x48 (2,304 lanes, runs of one material
    longer than a 1,024-term tile): image and kd gradient against
    jax.grad at test_torch_render.py's bars."""
    scene, static, cam = jax_scene("sphere", 48)
    _, grad, _ = assert_render_matches(scene, static, cam, 48)
    assert np.abs(grad).sum() > 0


def lookup_case(rng, cols, integer):
    """A (9, cols) table, 4,000 ids, one row never taken, and a
    cotangent: integer-valued, with one row taken 2,500 times; or
    positive reals (no cancellation), each row taken ~500 times, where
    the orders' roundings stay within rtol 1e-6 of each other."""
    if integer:
        ids = np.concatenate([np.zeros(2500, np.int64),
                              rng.integers(1, 8, 1500)])
    else:
        ids = rng.integers(0, 8, 4000)
    rng.shuffle(ids)
    shape = (4000,) if cols is None else (4000, cols)
    g = (rng.integers(-50, 50, shape) if integer
         else rng.uniform(0.5, 1.5, shape)).astype(np.float32)
    table = rng.uniform(0, 1, (9,) + shape[1:]).astype(np.float32)
    return table, ids.reshape(50, 80), g.reshape((50, 80) + shape[1:])


@pytest.mark.parametrize("cols", [None, 3])
@pytest.mark.parametrize("integer", [True, False])
def test_take_rows_backward_against_embedding(cols, integer):
    rng = np.random.default_rng(11 + integer)
    table, ids, g = lookup_case(rng, cols, integer)
    grads = []
    for ours in (True, False):
        t = torch.as_tensor(table).requires_grad_(True)
        i, gt = torch.as_tensor(ids), torch.as_tensor(g)
        if ours:
            out = take_rows(t, i)
        else:
            tab = t[:, None] if cols is None else t
            out = F.embedding(i, tab)
            out = out[..., 0] if cols is None else out
        assert torch.equal(out.detach(), torch.as_tensor(table)[ids])
        out.backward(gt)
        grads.append(t.grad)
    ours, emb = grads
    assert float(ours[8].abs().sum()) == 0.0
    if integer:
        assert torch.equal(ours, emb)
    else:
        torch.testing.assert_close(ours, emb, rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        assert torch.equal(take_rows(torch.as_tensor(table).requires_grad_(
            True), torch.as_tensor(ids)), torch.as_tensor(table)[ids])


@pytest.mark.parametrize("integer", [True, False])
def test_reattach_rows_backward_against_index_add(integer):
    rng = np.random.default_rng(21 + integer)
    ids = torch.as_tensor(rng.integers(0, 40, 3000))
    g = torch.as_tensor((rng.integers(-50, 50, (3000, 32)) if integer
                         else rng.uniform(0.5, 1.5, (3000, 32))).astype(
                             np.float32))
    fields = [torch.zeros((40, w), requires_grad=True)
              for w in (3, 3, 3, 3, 3, 3, 3, 2, 2, 2)]
    rows = torch.zeros((3000, 32))
    ReattachRows.apply(rows, ids, 40, *fields).backward(g)
    want = torch.zeros((40, 27)).index_add_(0, ids, g[:, :27])
    got = torch.cat([f.grad for f in fields], 1)
    if integer:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the card kernel, built for the host through the emulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def segsum_card(tmp_path_factory):
    return ss._bind(emulated_build(tmp_path_factory, "segment_sum.cu"))


@pytest.fixture
def emulated(segsum_card, monkeypatch):
    """segment_sum's launch on CPU tensors through the emulated card
    build; returns the launch counts."""
    monkeypatch.setattr(ss, "_lib", segsum_card)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(profiling, "COUNTS",
                        dict.fromkeys(profiling.COUNTS, 0))
    return lambda: profiling.counts(ss.LAUNCH)


def big_run_case(rng, cols):
    """One run of 2^20 + 5,000 terms (over 1,024 tiles: the rows pass
    sums its partials in two levels), one of 1,053 and an empty row."""
    n = (1 << 20) + 5000
    ids = np.zeros(n, np.int64)
    ids[::1000] = 1
    return wild(rng, (n, cols)), ids, 3


def edge_runs_case(rng, window, offsets):
    """Runs of every length 1-70, each starting `offset` sorted positions
    past a multiple of `window` for every offset of offsets(length):
    filler rows of one term before each run set its start. Rows in run
    order, the lanes shuffled."""
    lens, pos = [], 0
    for length in range(1, 71):
        for off in offsets(length):
            pad = (off - pos) % window
            lens += [1] * pad + [length]
            pos += pad + length
    ids = np.repeat(np.arange(len(lens)), lens)
    rng.shuffle(ids)
    return wild(rng, (ids.size, 3)), ids, len(lens)


def sparse_29_case(rng):
    """ReattachRows' shape, cut down: 29 columns, 5,000 terms on 40,000
    rows, most rows empty; runs of one to 1,500 terms (the longest in two
    tiles), a lone -0.0 row and an empty row beside it."""
    lens = np.concatenate([[1500, 700, 65, 64, 33], rng.integers(1, 30,
                                                                 150)])
    rows = rng.choice(np.arange(2, 40_000), lens.size, replace=False)
    ids = np.concatenate([np.repeat(rows, lens), [0]])
    values = wild(rng, (ids.size, 29))
    values[-1] = -0.0          # row 0: one -0.0 term; row 1: empty
    order = rng.permutation(ids.size)
    return values[order], ids[order], 40_000


def key_bits_case(rng, bits):
    """2,000 terms on n_rows rows, ceil(log2 n_rows) == bits: random ids,
    the first and last rows among them."""
    n_rows = {1: 2, 8: 256, 9: 257, 11: 2000, 17: 100_000,
              19: 270_336}[bits]
    ids = rng.integers(0, n_rows, 2000)
    ids[:3] = [0, n_rows - 1, n_rows - 1]
    return wild(rng, (ids.size, 2)), ids, n_rows


SEGSUM_CASES = ["runs, 1 column", "runs, 3 columns", "runs, 29 columns",
                "a run of 2^20", "2,000 rows, most empty", "one row",
                "1 key bit", "8 key bits", "9 key bits", "11 key bits",
                "17 key bits", "19 key bits", "runs 1-70 at 32-lane edges",
                "runs 1-70 at 1,024-lane edges", "descending ids",
                "every term in the last row", "-0.0 beside an empty row",
                "29 columns, sparse"]


def segsum_case(case):
    rng = np.random.default_rng(len(case))
    if case == "a run of 2^20":
        return big_run_case(rng, 1)
    if case.startswith("2,000"):
        # most rows empty; the last row holds a run
        ids = np.sort(rng.integers(0, 2000, 1500))
        ids[:40] = 1999
        return wild(rng, (ids.size, 5)), ids, 2000
    if case == "one row":
        return wild(rng, (5000, 3)), np.zeros(5000, np.int64), 1
    if case.endswith("key bits") or case == "1 key bit":
        return key_bits_case(rng, int(case.split()[0]))
    if case == "runs 1-70 at 32-lane edges":
        return edge_runs_case(rng, 32, lambda length: range(32))
    if case == "runs 1-70 at 1,024-lane edges":
        return edge_runs_case(rng, 1024, lambda length: sorted(
            {(-j) % 1024 for j in (0, length // 2, length)}))
    if case == "descending ids":
        ids = np.sort(rng.integers(0, 3000, 6000))[::-1].copy()
        return wild(rng, (ids.size, 3)), ids, 3000
    if case == "every term in the last row":
        return wild(rng, (3000, 3)), np.full(3000, 299), 300
    if case == "-0.0 beside an empty row":
        ids = np.array([0, 2, 2, 5, 5, 5])
        values = wild(rng, (6, 4))
        values[0] = -0.0
        return values, ids, 7
    if case == "29 columns, sparse":
        return sparse_29_case(rng)
    return segment_case(rng, int(case.split()[1]))


@pytest.mark.parametrize("case", SEGSUM_CASES)
def test_card_kernel_equals_plain(emulated, case):
    values, ids, n_rows = segsum_case(case)
    v, i = torch.as_tensor(values), torch.as_tensor(ids)
    want = ss.segment_sum_plain(v, i, n_rows)
    first = ss._launch(v, i, n_rows)
    again = ss._launch(v, i, n_rows)
    assert emulated()["sums"] == 2
    # the sort runs only with more than one row
    assert emulated()["sort"] == (2 if n_rows > 1 else 0)
    assert torch.equal(first, want) and torch.equal(again, first)
    assert bits(first.numpy()).tobytes() == bits(want.numpy()).tobytes()
    if case == "-0.0 beside an empty row":
        assert (bits(first[0].numpy()) == bits(np.float32(-0.0))).all()
        assert (bits(first[[1, 6]].numpy()) == 0).all()


@pytest.mark.parametrize("case", ["8 key bits", "19 key bits",
                                  "descending ids",
                                  "every term in the last row",
                                  "runs 1-70 at 32-lane edges"])
def test_card_sort_is_torch_sort(emulated, case):
    """The kernel's own radix sort (stable_order on the emulated card
    build) gives torch.sort(stable=True)'s permutation."""
    _, ids, n_rows = segsum_case(case)
    i = torch.as_tensor(ids)
    perm = ss._sort_launch(i, n_rows)
    assert perm.dtype == torch.int32
    assert torch.equal(perm.long(), torch.sort(i, stable=True)[1])
    assert emulated()["sort"] == 1 and emulated()["sums"] == 0
