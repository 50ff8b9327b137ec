"""The port's wide-BVH traversal against the JAX package.

The plain PyTorch version (ops/wide_bvh.walk_plain, what the traversal
runs on CPU tensors) is held against the Pallas kernel `_traverse4_one`
in interpret mode, closest hit with attributes and any hit, and against
the JAX brute force, at the bar of tests/test_bvh.py::_check_against_brute.
The CUDA kernel's walk, compiled for the host from the same source, is
held against the port's brute-force oracle (wide_bvh.brute_force_triangles).
The kernel itself runs only on a GPU: tests/test_torch_cuda.py."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from test_torch_host import ensure_native  # noqa: E402

from cse168_raytracer_tpu.models import geometry as jgeo  # noqa: E402
from cse168_raytracer_tpu.ops import pallas_bvh as jpb  # noqa: E402
from cse168_raytracer_tpu.ops.intersect import \
    intersect_triangles as j_intersect  # noqa: E402
from cse168_raytracer_tpu_torch.models import geometry as tgeo  # noqa: E402
from cse168_raytracer_tpu_torch.ops import wide_bvh as twb  # noqa: E402
from cse168_raytracer_tpu_torch.ops.intersect import \
    intersect_triangles as t_intersect  # noqa: E402

BIG = 3.0e37
N_RAYS = 256      # the Pallas kernel runs interpreted: keep it small


def random_mesh(n_tri, seed):
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 1, (n_tri * 3, 3)).astype(np.float32)
    f = np.arange(n_tri * 3, dtype=np.int64).reshape(n_tri, 3)
    return {"vertices": v,
            "normals": rng.normal(0, 1, (n_tri * 3, 3)).astype(np.float32),
            "texcoords": rng.uniform(0, 1, (n_tri * 3, 2)).astype(np.float32),
            "tri_vidx": f, "tri_nidx": f, "tri_tidx": f}


def clustered_mesh(n_tri, seed):
    """Small triangles around a few centres: a tree with real depth."""
    rng = np.random.default_rng(seed)
    centres = rng.uniform(-2, 2, (12, 3))
    c = centres[rng.integers(0, 12, n_tri)] + rng.normal(0, 0.4, (n_tri, 3))
    v = (c[:, None, :] + rng.normal(0, 0.08, (n_tri, 3, 3))).reshape(-1, 3)
    f = np.arange(n_tri * 3, dtype=np.int64).reshape(n_tri, 3)
    return {"vertices": v.astype(np.float32),
            "normals": np.tile(np.float32([[0, 1, 0]]), (n_tri * 3, 1)),
            "texcoords": np.zeros((0, 2), np.float32), "tri_vidx": f,
            "tri_nidx": f, "tri_tidx": np.full((n_tri, 3), -1, np.int64)}


MESHES = {"tri1": lambda: random_mesh(1, 13), "tri33": lambda: random_mesh(33, 14),
          "tri80": lambda: random_mesh(80, 15),
          "tri3000": lambda: clustered_mesh(3000, 16)}


def rays(seed, n=N_RAYS):
    """Rays from around (0, 0, -5) in random directions, a few along the
    axes (zero direction components: the NaN case of the slab test), a
    few dead (tmax < tmin), the rest with tmax spread over the scene."""
    rng = np.random.default_rng(seed)
    o = (np.float32([0, 0, -5])
         + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    target = rng.normal(0, 1.2, (n, 3))
    d = target - o
    d[:6] = [[0, 0, 1], [0, 0, 1], [1, 0, 0], [0, 1, 0], [0, 0, 1],
             [0, 0, 1]]
    o[:2] = [[0, 0, -5], [0.01, -0.02, -5]]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = np.zeros(n, np.float32)
    tmax = rng.uniform(3, 12, n).astype(np.float32)
    tmax[6:10] = -1.0
    return o, d, tmin, tmax


def build_both(name, width):
    ensure_native()
    mesh = MESHES[name]()
    meshes = [(mesh, 2), (random_mesh(5, 9), 1)]
    jpack = jgeo.pack_triangles(meshes)
    tpack = tgeo.pack_triangles(meshes, device="cpu")
    jnew, jbvh = jpb.build_pallas_bvh4_sah(jpack, width=width)
    tnew, tbvh = twb.build_bvh4_sah(tpack, width=width)
    return jpack, jnew, jbvh, tpack, tnew, tbvh


def check_against_brute(t, ids, t_ref, ids_ref):
    """tests/test_bvh.py::_check_against_brute on (t, id) arrays."""
    hit, hit_ref = t < BIG, t_ref < BIG
    assert np.array_equal(hit, hit_ref), int((hit != hit_ref).sum())
    both = hit & hit_ref
    np.testing.assert_allclose(t[both], t_ref[both], rtol=1e-4, atol=1e-5)
    if both.any():
        assert np.mean(ids[both] == ids_ref[both]) > 0.99
    return both & (ids == ids_ref)


def twin(tbvh, r, any_hit=False):
    o, d, tmin, tmax = (torch.as_tensor(x) for x in r)
    if any_hit:
        return twb.any_hit_triangles(tbvh, o, d, tmin, tmax).numpy()
    t, ids, attr = twb.closest_hit_triangles(tbvh, o, d, tmin, tmax)
    return t.numpy(), ids.numpy(), attr.numpy()


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_twin_matches_pallas_closest_attr(name, width):
    _, _, jbvh, _, _, tbvh = build_both(name, width)
    r = rays(sorted(MESHES).index(name))
    h, jattr = jpb.pallas_bvh_closest_hit_triangles(
        jbvh, *(jnp.asarray(x) for x in r), interpret=True, with_attr=True)
    jt = np.where(np.asarray(h.hit), np.asarray(h.t), BIG)
    t, ids, attr = twin(tbvh, r)
    same = check_against_brute(t, ids, jt, np.asarray(h.prim_id))
    assert (t < BIG).sum() > (10 if name != "tri1" else 0)
    # the winners' attribute rows, and zero rows on a miss
    np.testing.assert_array_equal(attr[same], np.asarray(jattr)[same])
    assert not attr[t >= BIG].any()
    assert np.all(t[6:10] == BIG) and np.all(ids[6:10] == 0)


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", ["tri80", "tri3000"])
def test_twin_matches_pallas_any_hit(name, width):
    _, _, jbvh, _, _, tbvh = build_both(name, width)
    r = rays(10 + width)
    h = jpb.pallas_bvh_closest_hit_triangles(
        jbvh, *(jnp.asarray(x) for x in r), any_hit=True, interpret=True)
    occ = twin(tbvh, r, any_hit=True) < BIG
    np.testing.assert_array_equal(occ, np.asarray(h.hit))
    assert 0 < occ.sum() < N_RAYS


@pytest.mark.parametrize("name", sorted(MESHES))
def test_twin_matches_jax_brute_force(name):
    """The twin on the leaf-ordered pack against the JAX brute force on
    the original pack, and the port's own brute force likewise."""
    jpack, jnew, _, tpack, tnew, tbvh = build_both(name, 4)
    o, d, tmin, tmax = rays(20 + len(name), 1024)
    tmax = np.maximum(tmax, 0.0)           # the brute force takes tmax >= 0
    r = (o, d, tmin, tmax)
    h = j_intersect(jpack, *(jnp.asarray(x) for x in r))
    jt = np.where(np.asarray(h.hit), np.asarray(h.t), BIG)
    t, ids, attr = twin(tbvh, r)
    # ids index different packs: compare the triangles' vertices instead
    hit = t < BIG
    assert np.array_equal(hit, np.asarray(h.hit))
    np.testing.assert_allclose(t[hit], jt[hit], rtol=1e-4, atol=1e-5)
    same_v0 = np.all(tnew.v0.numpy()[ids[hit]]
                     == np.asarray(jpack.v0)[np.asarray(h.prim_id)[hit]], 1)
    assert same_v0.mean() > 0.99
    th = t_intersect(tpack, *(torch.as_tensor(x) for x in r))
    np.testing.assert_array_equal(th.hit.numpy(), np.asarray(h.hit))
    np.testing.assert_allclose(th.t.numpy()[hit], jt[hit], rtol=1e-4,
                               atol=1e-5)
    tb, idb, _ = twb.brute_force_triangles(tbvh, *(torch.as_tensor(x)
                                                   for x in r))
    check_against_brute(tb.numpy(), idb.numpy(), t, ids)


def test_wrapper_routes_cpu_tensors_to_twin():
    _, _, _, _, _, tbvh = build_both("tri80", 4)
    o, d, tmin, tmax = (torch.as_tensor(x) for x in rays(30))
    before = dict(twb.LAUNCHES)
    t, ids, attr = twb.closest_hit_triangles(tbvh, o, d, tmin, tmax)
    tp, idp, attrp = twb.closest_hit_triangles_plain(tbvh, o, d, tmin, tmax)
    assert torch.equal(t, tp) and torch.equal(ids, idp)
    assert torch.equal(attr, attrp)
    assert torch.equal(twb.any_hit_triangles(tbvh, o, d, 0.0, tmax),
                       twb.any_hit_triangles_plain(tbvh, o, d, 0.0, tmax))
    assert twb.LAUNCHES == before          # no kernel ran
    with pytest.raises(ValueError):
        twb.closest_hit_triangles(tbvh, o.to("meta"), d.to("meta"), tmin,
                                  tmax)


# ---------------------------------------------------------------------------
# the CUDA kernel's walk, compiled for the host
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def host_walk(tmp_path_factory):
    """traverse_wide.cu built with g++ (its walk is plain C++; the host
    build exports traverse_host, one ray after another)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel's walk for the host")
    src = twb.cuda_build.CSRC + "/traverse_wide.cu"
    lib_path = str(tmp_path_factory.mktemp("walk") / "libwalk.so")
    # no fused multiply-add: the kernel rounds every product and sum
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-x", "c++",
                    "-shared", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.traverse_host.argtypes = [i, i, p, p, p, p, i, p, p, p, p, i, i, p,
                                  i, p, p, p, p, p]
    lib.traverse_host.restype = i

    def run(bvh, o, d, tmin, tmax, any_hit, stack_depth=None,
            with_stats=False):
        """(t, id, attr, error bits), and with_stats the internal-node
        and leaf visit counts after them."""
        n = o.shape[0]
        depth = bvh.stack_depth if stack_depth is None else stack_depth
        o, d, tmin, tmax = (torch.as_tensor(x).contiguous()
                            for x in (o, d, tmin, tmax))
        out_t = torch.empty(n)
        out_id = torch.empty(n, dtype=torch.int32)
        out_attr = torch.empty(n, 32)
        visits = [torch.empty(n, dtype=torch.int32) if with_stats else None
                  for _ in range(2)]
        stack = torch.empty(depth * n, dtype=torch.int32)
        ptr = lambda x: ctypes.c_void_p(None if x is None else x.data_ptr())
        err = lib.traverse_host(
            bvh.width, int(any_hit), ptr(o), ptr(d), ptr(tmin), ptr(tmax), n,
            ptr(bvh.cbox), ptr(bvh.links), ptr(bvh.leafW), ptr(bvh.attrA),
            bvh.n_nodes, bvh.n_leaves, ptr(stack), depth, ptr(out_t),
            ptr(out_id), ptr(out_attr), *map(ptr, visits))
        out = (out_t.numpy(), out_id.numpy(), out_attr.numpy(), err)
        return out + tuple(v.numpy() for v in visits) if with_stats else out

    return run


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_kernel_walk_matches_twin(host_walk, name, width):
    _, _, _, _, _, tbvh = build_both(name, width)
    r = rays(40 + width, 2048)
    t, ids, attr, err = host_walk(tbvh, *r, any_hit=False)
    assert err == 0
    tp, idp, attrp = (x.numpy() for x in twb.brute_force_triangles(
        tbvh, *(torch.as_tensor(x) for x in r)))
    same = check_against_brute(t, ids, tp, idp)
    # one arithmetic in one order: bit-equal wherever both hit
    both = (t < BIG) & (tp < BIG)
    np.testing.assert_array_equal(t[both], tp[both])
    np.testing.assert_array_equal(attr[same], attrp[same])
    assert not attr[t >= BIG].any() and not ids[t >= BIG].any()
    occ, _, _, err = host_walk(tbvh, *r, any_hit=True)
    assert err == 0
    np.testing.assert_array_equal(occ < BIG, tp < BIG)


def test_kernel_walk_reports_stack_overflow(host_walk):
    _, _, _, _, _, tbvh = build_both("tri3000", 4)
    assert tbvh.n_nodes > 1
    r = rays(50)
    *_, err = host_walk(tbvh, *r, any_hit=False, stack_depth=1)
    assert err & 1
