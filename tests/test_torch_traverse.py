"""The port's wide-BVH traversal against the JAX package.

The plain PyTorch version (ops/wide_bvh.walk_plain, what the traversal
runs on CPU tensors) is held against the Pallas kernel `_traverse4_one`
in interpret mode, closest hit with attributes and any hit, and against
the JAX brute force, at the bar of tests/test_bvh.py::_check_against_brute.
The CUDA kernel's walk, compiled for the host from the same source, is
held against the port's brute-force oracle (wide_bvh.brute_force_triangles).
The kernel itself runs only on a GPU: tests/test_torch_cuda.py."""

import ctypes
import dataclasses
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


def build_both(name, width, mesh=None):
    """The JAX and the port's packs and trees of MESHES[name] (or of
    `mesh`) beside five random triangles."""
    ensure_native()
    mesh = MESHES[name]() if mesh is None else mesh
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
def host_lib(tmp_path_factory):
    """traverse_wide.cu built with g++ (its walk is plain C++; the host
    build exports traverse_host, one ray after another, and the card
    walk's block limits)."""
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
    return lib


@pytest.mark.parametrize("depth", [1, 26, 454])
def test_stack_shared_memory_bytes(host_lib, depth):
    """The card walk's blocks of 128 threads keep `depth` int32 stack
    slots per thread in shared memory."""
    assert twb._stack_smem_bytes(host_lib, depth) == depth * 128 * 4


@pytest.mark.parametrize("depth", [0, 455, 100_000])
def test_stack_shared_memory_raises_above_the_limit(host_lib, depth):
    """Above the 227 KB a Hopper block may use (or with no stack) the
    wrapper raises before any launch."""
    with pytest.raises(ValueError, match="shared memory"):
        twb._stack_smem_bytes(host_lib, depth)


@pytest.fixture(scope="module")
def host_walk(host_lib):
    """The host build's walk: run(bvh, o, d, tmin, tmax, any_hit)."""
    lib = host_lib

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


# ---------------------------------------------------------------------------
# the card walk, its warp collectives emulated on the host
# ---------------------------------------------------------------------------

# What traverse_wide.cu's -D__CUDACC__ build uses of CUDA, on the host:
# a warp is 32 std::threads that meet at a barrier for every collective,
# the warps of a launch run one after another, shared memory is one
# buffer per block, and the intrinsics round as the card's do (no fused
# multiply-add: the build passes -ffp-contract=off).
CUDA_EMULATION_H = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__ __restrict
struct float4 { float x, y, z, w; };
struct emu_dim3 { unsigned x, y, z; };
inline thread_local emu_dim3 threadIdx, blockIdx;
inline thread_local int* emu_smem;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
typedef void* cudaStream_t;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
template <class T> inline T __ldg(const T* p) {
  if (sizeof(T) == 16 && (uintptr_t)p % 16) {
    fprintf(stderr, "misaligned 16-byte load\n");
    abort();
  }
  return *p;
}
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline int __ffs(unsigned x) { return __builtin_ffs((int)x); }
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline int atomicOr(int* p, int v) {
  return __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
}

struct EmuWarp {
  std::barrier<> bar{32};
  uint64_t buf[2][32];
};
inline thread_local EmuWarp* emu_warp;
inline thread_local int emu_parity;
// every lane posts v and waits for the others; two buffers in turn, so a
// lane that runs ahead to the next collective overwrites nothing read
inline const uint64_t* emu_exchange(uint64_t v, unsigned mask) {
  if (mask != 0xffffffffu) {
    fprintf(stderr, "a collective over part of a warp\n");
    abort();
  }
  const int p = emu_parity;
  emu_parity ^= 1;
  emu_warp->buf[p][threadIdx.x & 31] = v;
  emu_warp->bar.arrive_and_wait();
  return emu_warp->buf[p];
}
template <class T> inline uint64_t emu_bits(T v) {
  uint64_t b = 0;
  memcpy(&b, &v, sizeof(T));
  return b;
}
template <class T> inline T __shfl_sync(unsigned m, T v, int src) {
  T r;
  const uint64_t b = emu_exchange(emu_bits(v), m)[src & 31];
  memcpy(&r, &b, sizeof(T));
  return r;
}
inline unsigned __ballot_sync(unsigned m, int pred) {
  const uint64_t* b = emu_exchange(pred ? 1 : 0, m);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= b[l] ? 1u << l : 0u;
  return r;
}
inline unsigned __match_any_sync(unsigned m, int v) {
  const uint64_t* b = emu_exchange(emu_bits(v), m);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) r |= (int)b[l] == v ? 1u << l : 0u;
  return r;
}
inline int __reduce_min_sync(unsigned m, int v) {
  const uint64_t* b = emu_exchange(emu_bits(v), m);
  int r = (int)b[0];
  for (int l = 1; l < 32; ++l) r = (int)b[l] < r ? (int)b[l] : r;
  return r;
}
// kernel<<<blocks, threads, smem, stream>>>(args), rewritten as a call
inline void emu_launch(int blocks, int threads, long smem, void*,
                       std::function<void()> kernel) {
  for (int b = 0; b < blocks; ++b) {
    std::vector<int> shared(smem / 4 + 1, 0x7eadbeef);
    for (int w = 0; w < threads / 32; ++w) {
      EmuWarp warp;
      std::vector<std::thread> lanes;
      for (int l = 0; l < 32; ++l)
        lanes.emplace_back([&, l] {
          threadIdx = {unsigned(w * 32 + l), 0, 0};
          blockIdx = {unsigned(b), 0, 0};
          emu_smem = shared.data();
          emu_warp = &warp;
          emu_parity = 0;
          kernel();
        });
      for (auto& t : lanes) t.join();
    }
  }
}
"""


def emulated_source(src):
    """traverse_wide.cu with its dynamic shared memory taken from the
    emulation and each `kernel<<<cfg>>>(args)` made emu_launch(cfg,
    [&] { kernel(args); })."""
    src = src.replace("extern __shared__ int smem[];", "int* smem = emu_smem;")
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        k, depth = j, 0         # back over the kernel's name and <...>
        while k > 0:
            c = src[k - 1]
            depth += (c == ">") - (c == "<")
            if depth == 0 and (c.isspace() or c in "(;{"):
                break
            k -= 1
        e = src.index(">>>", j)
        a = b = e + 3
        assert src[a] == "("
        depth = 0
        while True:             # to the argument list's closing bracket
            depth += (src[b] == "(") - (src[b] == ")")
            if depth == 0:
                break
            b += 1
        out.append(src[i:k])
        out.append(f"emu_launch({src[j + 3:e]}, [&] {{ "
                   f"{src[k:j]}{src[a:b + 1]}; }})")
        i = b + 1
    return "".join(out) + src[i:]


@pytest.fixture(scope="module")
def card_walk(tmp_path_factory):
    """The card build of traverse_wide.cu (the warp-cooperative walk, its
    stacks in shared memory) compiled for the host against
    CUDA_EMULATION_H, bound as the wrapper binds the card's library."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the card walk for the host")
    tmp = tmp_path_factory.mktemp("card_walk")
    (tmp / "cuda_runtime.h").write_text(CUDA_EMULATION_H)
    shutil.copy(twb.cuda_build.CSRC + "/pluecker.cuh", tmp)
    with open(twb.cuda_build.CSRC + "/traverse_wide.cu") as f:
        (tmp / "traverse_wide.cpp").write_text(emulated_source(f.read()))
    lib_path = str(tmp / "libcardwalk.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-ffp-contract=off",
                    "-D__CUDACC__", "-I", str(tmp), "-shared", "-fPIC",
                    "-pthread", "-w", "-o", lib_path,
                    str(tmp / "traverse_wide.cpp")], check=True)
    return twb._bind(ctypes.CDLL(lib_path))


@pytest.fixture
def emulated(card_walk, monkeypatch):
    """wide_bvh._launch and _launch_per_ray on CPU tensors, through the
    emulated card build; returns the launch counts."""
    monkeypatch.setattr(twb, "_lib", card_walk)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 0}))
    launches = dict.fromkeys(twb.LAUNCHES, 0)
    monkeypatch.setattr(twb, "LAUNCHES", launches)
    return launches


def check_card_walk(tbvh, r, any_hit, per_ray=False):
    """The card walk (or the per-ray kernel), with and without counters,
    equal to walk_plain: t, id, attributes and visit counts. Returns the
    outputs without counters."""
    o, d, tmin, tmax = (torch.as_tensor(x) for x in r)
    tp, idp, n_int, n_leaf = twb.walk_plain(tbvh, o, d, tmin, tmax,
                                            any_hit=any_hit)
    attrp = twb._gather_attr(tbvh, tp, idp.long())
    launch = twb._launch_per_ray if per_ray else twb._launch
    for stats in (True, False):
        t, ids, attr, nv, lv = launch(tbvh, o, d, tmin, tmax, any_hit, stats)
        assert torch.equal(t, tp)
        if not any_hit:
            assert torch.equal(ids, idp) and torch.equal(attr, attrp)
        if stats:
            assert torch.equal(nv, n_int) and torch.equal(lv, n_leaf)
    return t.numpy(), (None if any_hit else ids.numpy()), \
        (None if any_hit else attr.numpy())


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_card_walk_matches_pallas(emulated, name, width):
    """The card walk, closest hit with attributes and any hit, with and
    without counters, against the Pallas kernel (interpreted) on the
    rays of test_twin_matches_pallas_closest_attr, and equal to
    walk_plain."""
    _, _, jbvh, _, _, tbvh = build_both(name, width)
    r = rays(sorted(MESHES).index(name))
    jr = [jnp.asarray(x) for x in r]
    h, jattr = jpb.pallas_bvh_closest_hit_triangles(
        jbvh, *jr, interpret=True, with_attr=True)
    jt = np.where(np.asarray(h.hit), np.asarray(h.t), BIG)
    t, ids, attr = check_card_walk(tbvh, r, any_hit=False)
    same = check_against_brute(t, ids, jt, np.asarray(h.prim_id))
    np.testing.assert_array_equal(attr[same], np.asarray(jattr)[same])
    assert np.all(t[6:10] == BIG) and np.all(ids[6:10] == 0)
    occ, _, _ = check_card_walk(tbvh, r, any_hit=True)
    hj = jpb.pallas_bvh_closest_hit_triangles(jbvh, *jr, any_hit=True,
                                              interpret=True)
    np.testing.assert_array_equal(occ < BIG, np.asarray(hj.hit))
    assert emulated == {"closest": 1, "any": 1, "stats_closest": 1,
                        "stats_any": 1}


@pytest.mark.parametrize("width", [4, 8])
@pytest.mark.parametrize("case", ["ragged", "ties"])
def test_card_walk_ragged_dead_and_ties(emulated, case, width):
    """300 rays (the last warp holds 12), a dead ray in every warp, on
    the clustered mesh; and a mesh whose every hit is a tie, on two lanes
    of one leaf and across leaves, where the id must be the Pallas
    kernel's and walk_plain's (the first lane, the first leaf). The card
    walk and the per-ray kernel, against walk_plain and the Pallas kernel
    (interpreted)."""
    from test_torch_cuda import tie_mesh
    mesh = clustered_mesh(3000, 23) if case == "ragged" else tie_mesh(400, 24)
    _, _, jbvh, _, _, tbvh = build_both(case, width, mesh)
    o, d, tmin, tmax = rays(70 + width, 300)
    tmax[3::7] = -1.0
    r = (o, d, tmin, tmax)
    h = jpb.pallas_bvh_closest_hit_triangles(
        jbvh, *(jnp.asarray(x) for x in r), interpret=True)
    jt = np.where(np.asarray(h.hit), np.asarray(h.t), BIG)
    t, ids, _ = check_card_walk(tbvh, r, any_hit=False)
    check_against_brute(t, ids, jt, np.asarray(h.prim_id))
    np.testing.assert_array_equal(ids, np.asarray(h.prim_id) * (t < BIG))
    assert 0 < int((t < BIG).sum()) < 300 and np.all(t[3::7] == BIG)
    check_card_walk(tbvh, r, any_hit=True)
    check_card_walk(tbvh, r, any_hit=False, per_ray=True)


def test_card_walk_reports_errors(emulated):
    """A stack overflow and a bad link raise at the launch."""
    _, _, _, _, _, tbvh = build_both("tri3000", 4)
    o, d, tmin, tmax = (torch.as_tensor(x) for x in rays(50))
    with pytest.raises(RuntimeError, match="stack overflow"):
        twb._launch(dataclasses.replace(tbvh, stack_depth=1), o, d, tmin,
                    tmax, False)
    bad = dataclasses.replace(tbvh, links=torch.where(
        tbvh.links < 0, tbvh.links - 10 ** 6, tbvh.links))
    with pytest.raises(RuntimeError, match="bad link"):
        twb._launch(bad, o, d, tmin, tmax, True)
