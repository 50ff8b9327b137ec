"""The photon gather kernel (csrc/photon_gather.cu, ops/photon_gather.py)
against its plain PyTorch twin (ops/photon.py gather_levels).

On the card (tests marked `cuda`, skipped without one): the kernel's
irradiance, fine r'^2 and level choice equal the twin's by torch.equal,
and its coarse r'^2 where the coarse level is used, over the gather
cases below (tests/test_photon.py's), far, huge and NaN points, an empty
grid, zero points, no coarse level and box-sized maps at max_per_cell 32
and 64; the photon-power gradients after a kernel forward equal those
after the twin's; each call counts one launch. These import neither jax
nor the JAX package:

    python -m pytest --noconftest -m cuda tests/test_torch_photon_gather_kernel.py

On the CPU: CPU tensors take the twin and launch nothing; the wrapper's
checks raise before the library is loaded; and the kernel built for the
host through tests/test_torch_traverse.py's CUDA emulation (a warp of
threads behind each shuffle) gives the twin's bits on small cases."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_golden  # noqa: E402,F401  (shares the cores between workers)
from cse168_raytracer_tpu_torch.ops import cuda_build  # noqa: E402
from cse168_raytracer_tpu_torch.ops import photon as tp  # noqa: E402
from cse168_raytracer_tpu_torch.ops import photon_gather as pg  # noqa: E402
from cse168_raytracer_tpu_torch.utils import profiling  # noqa: E402

CASES = ("fixed", "sparse", "overflow", "clustered", "knn500")


def gather_case(case):
    """(pos, power, dirs, build kwargs, query points, normals): the
    cases of tests/test_photon.py (fixed radius, sparse fallback,
    overflow energy, clustered, the 500-NN auto radius), with random
    normals so the facing test rejects photons too."""
    rng = np.random.default_rng({"fixed": 0, "sparse": 1, "overflow": 3,
                                 "clustered": 4, "knn500": 11}[case])
    if case == "fixed":
        pos = rng.uniform(-2, 2, (500, 3))
        kw = dict(radius=0.5, max_per_cell=64, coarse_factor=None)
        q = rng.uniform(-1, 1, (64, 3))
    elif case == "sparse":
        pos = np.array([1.25, 0, 0]) + rng.uniform(-0.3, 0.3, (600, 3))
        kw = dict(radius=0.5, max_per_cell=64, coarse_factor=8.0)
        q = np.concatenate([np.zeros((1, 3)), rng.uniform(-2, 2, (40, 3))])
    elif case == "overflow":
        pos = rng.normal(0, 0.01, (400, 3))
        kw = dict(radius=1.0, max_per_cell=16, knn=1 << 30)
        q = rng.normal(0, 0.3, (32, 3))
    elif case == "clustered":
        blobs = rng.uniform(-2, 2, (6, 3))
        pos = np.concatenate([b + rng.normal(0, 0.08, (700, 3))
                              for b in blobs])
        kw = dict(radius=0.35, max_per_cell=64, knn=1 << 30)
        q = np.concatenate([blobs, rng.uniform(-2, 2, (40, 3))])
    else:
        bg = np.stack([rng.uniform(-4, 4, 12000), np.zeros(12000),
                       rng.uniform(-4, 4, 12000)], 1)
        hot = np.stack([rng.normal(0, 0.25, 6000), np.zeros(6000),
                        rng.normal(0, 0.25, 6000)], 1)
        pos = np.concatenate([bg, hot])
        kw = dict(radius=tp._auto_radius(pos.astype(np.float32), 500, 64),
                  max_per_cell=64, knn=500)
        q = np.concatenate([[[0, 0, 0], [2, 0, 2], [0.6, 0, 0]],
                            rng.uniform(-3, 3, (29, 3)) * [1, 0, 1]])
    n_ph = pos.shape[0]
    power = np.abs(rng.normal(1.0, 0.2, (n_ph, 3))) / n_ph
    dirs = rng.normal(0, 1, (n_ph, 3)) - [0, 2.0, 0]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    nrm = rng.normal(0, 1, (q.shape[0], 3)) + [0, 2.0, 0]
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    f32 = lambda a: np.asarray(a, np.float32)
    return f32(pos), f32(power), f32(dirs), kw, f32(q), f32(nrm)


def unit(rng, shape, bias=(0.0, 2.0, 0.0)):
    v = rng.normal(0, 1, shape) + bias
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def box_case(n_photons, n_points, cap, seed=5):
    """A photon_box-like map: photons on the floor and walls of a box
    [-1, 1]^3 with a dense caustic spot under the sphere, the radius
    of k = 500 (as build_photon_maps sets it), a coarse level at 8x, and
    gather points on the same surfaces and, where the fine level finds
    no photon, half a unit above the floor."""
    rng = np.random.default_rng(seed)

    def on_walls(n):
        u, v = rng.uniform(-1, 1, (2, n))
        wall = rng.integers(0, 5, n)
        x = np.where(wall == 1, -1.0, np.where(wall == 2, 1.0, u))
        y = np.where(wall == 0, -1.0, np.where(wall == 3, 1.0, v))
        z = np.where(wall == 4, -1.0, np.where((wall == 1) | (wall == 2),
                                               u, v))
        return np.stack([x, y, z], 1)
    spot = np.stack([rng.normal(0.2, 0.08, n_photons // 4),
                     np.full(n_photons // 4, -1.0),
                     rng.normal(0.1, 0.08, n_photons // 4)], 1)
    pos = np.concatenate([on_walls(n_photons - spot.shape[0]), spot])
    pos = pos.astype(np.float32)
    power = (rng.uniform(0.2, 1.0, (pos.shape[0], 3)) / pos.shape[0])
    kw = dict(radius=tp._auto_radius(pos, 500, cap), max_per_cell=cap,
              knn=500, coarse_factor=8.0)
    q = on_walls(n_points)
    q[:8] = [0.0, -0.5, 0.0] + rng.normal(0, 0.05, (8, 3))
    return (pos, power.astype(np.float32), unit(rng, pos.shape), kw,
            q.astype(np.float32), unit(rng, q.shape))


def odd_case(cap):
    """Few photons (a table of 16 buckets: the 27 probes share buckets)
    or a max_per_cell that is not a power of two."""
    rng = np.random.default_rng(cap)
    n = 6 if cap == 3 else 900
    pos = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    power = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    kw = dict(radius=0.6, max_per_cell=cap, knn=4 if cap == 3 else 40,
              coarse_factor=8.0)
    q = rng.uniform(-1.5, 1.5, (40, 3)).astype(np.float32)
    return pos, power, unit(rng, (n, 3)), kw, q, unit(rng, (40, 3))


def extreme_points(q, nrm, pos):
    """q and some photons' positions as points, with points far outside
    the grid (floor(p / r) saturating, its neighbours wrapping), at
    infinity and NaN."""
    far = np.float32([[1e12, -1e12, 3e9], [-1e30, 0.0, 1e30],
                      [np.inf, 0.0, 0.0], [np.nan, 1.0, 0.0]])
    pts = np.concatenate([q[:12], pos[:8], far]).astype(np.float32)
    return pts, np.concatenate([nrm[:12], nrm[:8], nrm[:4]])


def build(case, device="cpu"):
    """(grid, points, normals) of a named case on device."""
    if case in CASES or case == "far":
        pos, power, dirs, kw, q, nrm = gather_case(
            "fixed" if case == "far" else case)
        if case == "far":
            q, nrm = extreme_points(q, nrm, pos)
    elif case.startswith("box"):
        pos, power, dirs, kw, q, nrm = box_case(4000, 48,
                                                int(case[3:]), seed=6)
    else:
        pos, power, dirs, kw, q, nrm = odd_case(int(case[3:]))
    grid = tp.build_grid(pos, power, dirs, **kw, device=device)
    t = lambda a: torch.as_tensor(a, device=device)
    return grid, t(q), t(nrm)


def twin(grid, p, n, chunk=1 << 30):
    return tp.gather_levels(grid, p, n, grid.power,
                            None if grid.coarse is None else
                            grid.coarse.power, chunk)


def assert_same(got, want):
    """The kernel's four outputs against the twin's: all bits, the coarse
    r'^2 where the coarse level is used."""
    irr, r2, r2_c, use_c = (x.cpu() for x in got)
    w_irr, w_r2, w_r2_c, w_use = (x.cpu() for x in want)
    assert torch.equal(use_c, w_use)
    assert torch.equal(irr, w_irr), (irr - w_irr).abs().max()
    assert torch.equal(r2, w_r2)
    assert torch.equal(r2_c[use_c], w_r2_c[use_c])
    # no -0.0 / +0.0 swaps either
    assert irr.numpy().tobytes() == w_irr.numpy().tobytes()


# ---------------------------------------------------------------------------
# on the CPU
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_twin(monkeypatch):
    """grid_irradiance on CPU tensors runs gather_levels, launches no
    kernel and loads no library."""
    monkeypatch.setattr(profiling, "COUNTS", dict.fromkeys(profiling.COUNTS,
                                                           0))
    monkeypatch.setattr(pg, "_lib", None)
    grid, p, n = build("sparse")
    got = tp.grid_irradiance(grid, p, n)
    assert torch.equal(got, twin(grid, p, n)[0])
    assert got.abs().sum() > 0
    assert profiling.counts(pg.LAUNCH) == {"forward": 0}
    assert pg._lib is None


def bad_arguments(grid, p, n):
    """(label, grid, p, n) the kernel does not take."""
    big = grid.replace(max_per_cell=pg.MAX_PER_CELL + 1,
                       coarse=grid.coarse.replace(
                           max_per_cell=pg.MAX_PER_CELL + 1))
    return [
        ("float64 points", grid, p.double(), n),
        ("non-contiguous normals", grid, p,
         torch.cat([n, n], 1)[:, ::2]),
        ("points (N, 4)", grid, torch.cat([p, p[:, :1]], 1), n),
        ("max_per_cell beyond the kernel", big, p, n),
        ("coarse max_per_cell differs", grid.replace(
            coarse=grid.coarse.replace(max_per_cell=16)), p, n),
        ("float64 weights", grid.replace(weight=grid.weight.double()), p, n),
        ("int64 cell_hash", grid.replace(cell_hash=grid.cell_hash.long()),
         p, n),
        ("CPU tensors", grid, p, n),
    ]


@pytest.mark.parametrize("which", range(8))
def test_wrapper_checks_raise_before_loading(which, monkeypatch):
    def no_load(*a, **k):
        raise AssertionError("the library was loaded")
    monkeypatch.setattr(cuda_build, "load_library", no_load)
    monkeypatch.setattr(pg, "_lib", None)
    grid, p, n = build("sparse")
    label, g, pp, nn = bad_arguments(grid, p, n)[which]
    with pytest.raises(ValueError, match="photon gather kernel"):
        pg.gather(g, pp, nn, g.power,
                  None if g.coarse is None else g.coarse.power)
    assert pg._lib is None, label


# ---------------------------------------------------------------------------
# the card kernel, built for the host through the emulation
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gather_card(tmp_path_factory):
    from test_torch_traverse import emulated_build
    return pg._bind(emulated_build(tmp_path_factory, "photon_gather.cu"))


@pytest.fixture
def emulated(gather_card, monkeypatch):
    """photon_gather._launch on CPU tensors through the emulated card
    build; returns it as f(grid, p, n)."""
    monkeypatch.setattr(pg, "_lib", gather_card)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(profiling, "COUNTS", dict.fromkeys(profiling.COUNTS,
                                                           0))
    return lambda grid, p, n: pg._launch(
        grid, p, n, grid.power,
        None if grid.coarse is None else grid.coarse.power)


@pytest.mark.parametrize("case", CASES + ("far", "box32", "odd3", "odd20"))
def test_emulated_kernel_equals_twin(case, emulated):
    grid, p, n = build(case)
    got = emulated(grid, p, n)
    assert_same(got, twin(grid, p, n))
    assert profiling.counts(pg.LAUNCH) == {"forward": 1}
    if case == "sparse":
        assert got[3][0] and got[0][0].sum() > 0   # the coarse level's
    if case in ("knn500", "box32"):
        assert got[0].sum() > 0


def test_emulated_kernel_at_the_largest_max_per_cell(emulated):
    """MAX_PER_CELL (27 K padded to 2,048 candidates) gives the twin's
    bits; one more is refused by the kernel itself."""
    pos, power, dirs, kw, q, nrm = odd_case(20)
    kw["max_per_cell"] = pg.MAX_PER_CELL
    grid = tp.build_grid(pos, power, dirs, **kw, device="cpu")
    p, n = torch.as_tensor(q), torch.as_tensor(nrm)
    assert 27 * pg.MAX_PER_CELL <= 2048 < 27 * (pg.MAX_PER_CELL + 1)
    assert_same(emulated(grid, p, n), twin(grid, p, n))
    over = pg.MAX_PER_CELL + 1
    big = grid.replace(max_per_cell=over,
                       coarse=grid.coarse.replace(max_per_cell=over))
    with pytest.raises(RuntimeError, match="launch failed"):
        emulated(big, p, n)


def test_emulated_kernel_without_a_coarse_level(emulated):
    grid, p, n = build("box32")
    grid = grid.replace(coarse=None)
    got = emulated(grid, p, n)
    assert_same(got, twin(grid, p, n))
    assert not got[3].any()


def test_emulated_kernel_on_an_empty_grid(emulated):
    """No photon: zero irradiance, r'^2 = r^2, the fine level; the twin
    gives the same on a grid whose one photon is out of every point's
    reach (it cannot index an empty table)."""
    grid, p, n = build("sparse")
    z = np.zeros((0, 3), np.float32)
    empty = tp.build_grid(z, z, z, 0.5, max_per_cell=64, coarse_factor=8.0,
                          device="cpu")
    far = np.float32([[1e6, 1e6, 1e6]])
    lone = tp.build_grid(far, far, far, 0.5, max_per_cell=64,
                         coarse_factor=8.0, device="cpu")
    got = emulated(empty, p, n)
    assert_same(got, twin(lone, p, n))
    assert not got[0].any() and not got[3].any()
    assert torch.equal(got[1], (empty.radius * empty.radius).expand(
        p.shape[0]))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


def card_case(case, cuda):
    """build(case) on the card; "box32" and "box64" at photon_box's map
    sizes (200,000 photons, 65,536 points)."""
    if case not in ("box32", "box64"):
        return build(case, cuda)
    pos, power, dirs, kw, q, nrm = box_case(200_000, 65_536, int(case[3:]))
    grid = tp.build_grid(pos, power, dirs, **kw, device=cuda)
    t = lambda a: torch.as_tensor(a, device=cuda)
    return grid, t(q), t(nrm)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ("far", "odd3", "odd20", "box32",
                                          "box64"))
def test_kernel_equals_twin(case, cuda):
    grid, p, n = card_case(case, cuda)
    got = pg.gather(grid, p, n, grid.power,
                    None if grid.coarse is None else grid.coarse.power)
    assert_same(got, twin(grid, p, n, tp.gather_chunk(grid)))
    if case.startswith("box"):
        assert got[3].any() and (~got[3]).any()


@pytest.mark.cuda
def test_kernel_without_a_coarse_level_and_without_points(cuda):
    grid, p, n = build("box32", cuda)
    grid = grid.replace(coarse=None)
    assert_same(pg.gather(grid, p, n, grid.power, None), twin(grid, p, n))
    for g in (grid, card_case("sparse", cuda)[0]):
        out = tp.grid_irradiance(g, p[:0], n[:0])
        assert out.shape == (0, 3) and out.device.type == "cuda"
        assert_same(pg.gather(g, p[:0], n[:0], g.power, None if g.coarse
                              is None else g.coarse.power),
                    twin(g, p[:0], n[:0]))


@pytest.mark.cuda
def test_kernel_on_an_empty_grid(cuda):
    _, p, n = card_case("sparse", cuda)
    z = np.zeros((0, 3), np.float32)
    empty = tp.build_grid(z, z, z, 0.5, max_per_cell=64, coarse_factor=8.0,
                          device=cuda)
    far = np.float32([[1e6, 1e6, 1e6]])
    lone = tp.build_grid(far, far, far, 0.5, max_per_cell=64,
                         coarse_factor=8.0, device=cuda)
    got = pg.gather(empty, p, n, empty.power, empty.coarse.power)
    assert_same(got, twin(lone, p, n))
    assert not got[0].any() and not got[3].any()


@pytest.mark.cuda
def test_power_gradients_after_the_kernel_equal_the_twins(cuda, monkeypatch):
    """_Irradiance's backward (plain, segment_sum) after a kernel forward
    and after a twin forward: the same gradients of both levels' powers,
    bit for bit."""
    grid, p, n = build("knn500", cuda)
    weight = torch.as_tensor(np.random.default_rng(9).uniform(
        0.5, 1.5, (p.shape[0], 3)).astype(np.float32), device=cuda)

    def grads():
        fine = grid.power.clone().requires_grad_(True)
        coarse = grid.coarse.power.clone().requires_grad_(True)
        g = grid.replace(power=fine, coarse=grid.coarse.replace(power=coarse))
        (tp.grid_irradiance(g, p, n) * weight).sum().backward()
        return fine.grad, coarse.grad

    kernel = grads()
    monkeypatch.setattr(pg, "gather", lambda grid, p, n, power, cpow:
                        tp.gather_levels(grid, p, n, power, cpow, 1 << 16))
    plain = grads()
    assert kernel[0].abs().sum() > 0 and kernel[1].abs().sum() > 0
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_one_launch_a_call(cuda, monkeypatch):
    monkeypatch.setattr(profiling, "COUNTS", dict.fromkeys(profiling.COUNTS,
                                                           0))
    grid, p, n = card_case("sparse", cuda)
    for calls in (1, 2, 3):
        tp.grid_irradiance(grid, p, n)
        assert profiling.counts(pg.LAUNCH) == {"forward": calls}
    tp.grid_irradiance(grid, p[:0], n[:0])
    assert profiling.counts(pg.LAUNCH) == {"forward": 3}
