// Binary-BVH closest-hit and any-hit traversal for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cse168_raytracer_tpu/ops/pallas_bvh.py::
// _traverse_one (the body of _traverse_kernel, launched from
// pallas_bvh_closest_hit_triangles with a PallasBVH: attach_accel's
// kind="pallas_sah", or the implicit LBVH) in its three modes: closest
// hit, any hit, and with_stats (the STATS counters). It reads the JAX
// package's tree arrays byte for byte:
//   cbox  (Nn, 16) f32 [loL(3) hiL(3) loR(3) hiR(3) childL childR pad2];
//         a child link >= 0 names an internal node, < 0 the leaf ~link;
//   leafW (L, 16, 4K) f32, the leaf table of traverse_wide.cu.
//
// The walk is the Pallas kernel's ordered descent (pallas_bvh.py:336-355)
// for one ray (walk(), in the host build below): each stack entry keeps
// the child's entry t, an entry whose t lies past the ray's current best
// is dropped when popped, and an internal visit pushes the far child
// first so that the near one is popped next. The TPU orders a 256-ray
// tile by the tile's smallest entry t; here each ray orders by its own,
// which changes which nodes a ray visits but not its hit. Counts are
// each ray's own walk (the TPU bills a tile's visits to every ray of
// it): box tests = 2 x internal visits, triangle tests = K x leaf visits
// (pallas_bvh.py:570-574). As in traverse_wide.cu, boxes are widened by
// BOX_PAD (pluecker.cuh), or a per-ray walk loses hits just past a
// leaf's box that the tile-wide walk keeps.
//
// What bounds it on this card: not FLOPs but lanes that idle and loads
// that scatter, as for traverse_wide.cu. The first design (one thread
// per ray) spent 54-58% of a warp's cycles outside its own leaf tests
// (profile_walk.py's WALK_PROBE split, PERF.md): a lane at a leaf ran its
// 128 triangle tests with scalar gathers while the other lanes waited,
// and every push and pop went through a stack in device memory. The card
// walk (traverse_binary_warp) is traverse_wide.cu's, for the binary tree:
//  1. a warp-uniform "walk until a leaf, then test the leaves together"
//     loop: each lane pops entries and tests internal nodes as walk()
//     does until it holds a leaf or its stack is empty; then the warp
//     serves every pending leaf, one group of lanes per distinct leaf
//     (__match_any_sync), with pluecker::warp_shade_leaf<128> (each lane
//     holds four triangles' operands from 16-byte loads, the rays come
//     by shuffle); only then do the lanes walk on. A lane that holds a
//     leaf neither pops nor pushes until its leaf is served and its best
//     updated, so every ray's pops, its curmax at each entry, its visits
//     and its answer are walk()'s and walk_binary_plain's. All 32 lanes
//     stay in the loop to its end (threads past n and dead or retired
//     rays with an empty stack), so the full-warp collectives are
//     defined;
//  2. the stack lives in dynamic shared memory, slot-major, two words a
//     slot: the links at [s][thread] and the entry t's after them, so a
//     warp's pushes and pops fall in 32 distinct banks;
//  3. an internal node's 16-float row comes in as four 16-byte loads.
// Rays are taken in the integrator's 16x8 pixel-block order (one block
// of 128 threads is one pixel block), so a warp's rays walk nearly the
// same nodes and meet at the same leaves. A stack overflow or a bad link
// sets a bit of the error flag, which the wrapper reads after the launch.
//
// walk(), the host build's per-ray walk (g++ -x c++), is the reference
// the CPU tests hold against ops/binary_bvh.walk_binary_plain; the card
// walk repeats its steps in that order.

#include "pluecker.cuh"

#ifdef __CUDACC__
#include <atomic>
#endif

namespace {

using pluecker::BIG;
using pluecker::Ray;

constexpr int K = 128;          // triangles per leaf
constexpr int THREADS = 128;    // the card walk's block: 16x8 rays
constexpr int MAX_SMEM = 232448;  // shared memory a block may use

enum : int { ERR_STACK = 1, ERR_LINK = 2 };

struct Tree {
  const float* cbox;
  const float* leafW;
  int n_nodes;
  int n_leaves;
};

struct Visits {
  int internal = 0, leaf = 0;
};

// Which children of an internal node's row v the ray enters with
// curmax, and at what t: the BOX_PAD-widened slab tests of walk() and
// walk_binary_plain, the near child (the left one on equal entry t)
// first.
struct Children {
  int near_link, far_link;
  float near_t, far_t;
  bool near_hit, far_hit;
};

HD Children children(const float v[16], const Ray& r, float curmax) {
  float ext_l, ext_r;
  const float ent_l = pluecker::padded_entry(v, v + 3, r, curmax, &ext_l);
  const float ent_r = pluecker::padded_entry(v + 6, v + 9, r, curmax, &ext_r);
  const bool h_l = ent_l <= ext_l, h_r = ent_r <= ext_r;
  const float t_l = h_l ? ent_l : INFINITY;
  const float t_r = h_r ? ent_r : INFINITY;
  const int c_l = (int)v[12], c_r = (int)v[13];
  const bool l_near = t_l <= t_r;
  return {l_near ? c_l : c_r, l_near ? c_r : c_l, l_near ? t_l : t_r,
          l_near ? t_r : t_l, l_near ? h_l : h_r, l_near ? h_r : h_l};
}

// Outputs of a launch: t and id always, the visit counts with STATS.
struct Out {
  float* t;
  int* id;
  int* nv;
  int* lv;
};

#ifdef __CUDACC__

#ifdef WALK_PROBE
// Built only with -DWALK_PROBE (profile_walk.py): the card walk sums, over
// the warps of its launches, lane 0's clock cycles walking internal nodes
// and serving leaves, and the warp's rounds of serving, its leaf groups
// and its ray-leaf pairs; the sixth entry counts the warps.
__device__ unsigned long long walk_probe[6];
#define PROBE(...) __VA_ARGS__
#else
#define PROBE(...)
#endif

// The card walk: walk()'s steps for each lane's ray, with the leaves
// tested by the warp together (see the note at the head of this file).
// The stack is `stack_depth` slots of dynamic shared memory per thread:
// slot s of thread x holds its link at [s * THREADS + x] and its entry t
// at [(stack_depth + s) * THREADS + x].
template <bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(THREADS)
    traverse_binary_warp(Tree tree, const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ tmin,
                         const float* __restrict__ tmax, int n,
                         int stack_depth, Out out, int* err) {
  extern __shared__ int smem[];
  int* stack = smem + threadIdx.x;
  float* stack_t = (float*)(smem + stack_depth * THREADS) + threadIdx.x;
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  Ray r = {};
  r.tmax = -1.0f;  // threads past n walk nothing, but stay in the warp
  if (i < n) r = pluecker::load_ray(o, d, tmin, tmax, i);
  float best = BIG;
  int best_id = 0, e = 0, sp = 0, leaf = -1;
  Visits vis;
  if (r.tmax >= r.tmin) {  // dead rays visit nothing
    stack[0] = 0;
    stack_t[0] = r.tmin;
    sp = 1;
  }
  PROBE(long long walk_cycles = 0, serve_cycles = 0, rounds = 0,
        groups = 0, pairs = 0;)
  for (;;) {
    PROBE(const long long c0 = clock64();)
    // walk() until this lane holds a leaf or its stack is empty
    while (leaf < 0 && sp > 0) {
      --sp;
      const int node = stack[sp * THREADS];
      const float curmax = fminf(r.tmax, best);
      if (!(stack_t[sp * THREADS] <= curmax)) continue;
      if (node < 0) {
        if (-node - 1 >= tree.n_leaves) {
          e |= ERR_LINK;
          sp = 0;
        } else {
          leaf = -node - 1;
          if (STATS) ++vis.leaf;
        }
        continue;
      }
      if (node >= tree.n_nodes) {
        e |= ERR_LINK;
        sp = 0;
        continue;
      }
      if (STATS) ++vis.internal;
      const float4* row = (const float4*)(tree.cbox + (long)node * 16);
      float v[16];
      for (int q = 0; q < 4; ++q) {
        const float4 x = __ldg(row + q);
        v[4 * q] = x.x;
        v[4 * q + 1] = x.y;
        v[4 * q + 2] = x.z;
        v[4 * q + 3] = x.w;
      }
      const Children c = children(v, r, curmax);
      // far child first, so that the near one is popped next
      const int need = sp + c.far_hit + c.near_hit;
      if (need > stack_depth) {
        e |= ERR_STACK;
        sp = 0;
        continue;
      }
      if (c.far_hit) {
        stack[sp * THREADS] = c.far_link;
        stack_t[sp++ * THREADS] = c.far_t;
      }
      if (c.near_hit) {
        stack[sp * THREADS] = c.near_link;
        stack_t[sp++ * THREADS] = c.near_t;
      }
    }
    // the warp serves every pending leaf, one group of lanes per leaf
    unsigned pending = __ballot_sync(pluecker::FULL_WARP, leaf >= 0);
    PROBE(const long long c1 = clock64(); walk_cycles += c1 - c0;)
    if (!pending) break;
    PROBE(++rounds; pairs += __popc(pending);)
    const unsigned same = __match_any_sync(pluecker::FULL_WARP, leaf);
    do {
      const int lead = __ffs(pending) - 1;
      const unsigned group = __shfl_sync(pluecker::FULL_WARP, same, lead);
      const int lf = __shfl_sync(pluecker::FULL_WARP, leaf, lead);
      int lane;
      const float lt = pluecker::warp_shade_leaf<K>(
          tree.leafW + (long)lf * 16 * 4 * K, group, r, fminf(r.tmax, best),
          &lane);
      if (lt < best) {  // BIG outside the group
        best = lt;
        best_id = lf * K + lane;
        if (ANY_HIT) sp = 0;
      }
      pending &= ~group;
      PROBE(++groups;)
    } while (pending);
    PROBE(serve_cycles += clock64() - c1;)
    leaf = -1;
  }
  PROBE(if ((threadIdx.x & 31) == 0) {
    const long long v[6] = {walk_cycles, serve_cycles, rounds, groups, pairs,
                            1};
    for (int k = 0; k < 6; ++k)
      atomicAdd(walk_probe + k, (unsigned long long)v[k]);
  })
  if (i < n) {
    out.t[i] = best;
    out.id[i] = best_id;
    if (STATS) {
      out.nv[i] = vis.internal;
      out.lv[i] = vis.leaf;
    }
  }
  if (e) atomicOr(err, e);
}

template <bool ANY_HIT, bool STATS>
int launch(const Tree& tree, const float* o, const float* d,
           const float* tmin, const float* tmax, int n, int stack_depth,
           const Out& out, int* err, cudaStream_t stream) {
  const long smem = 2L * stack_depth * THREADS * (long)sizeof(int);
  if (stack_depth < 1 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = traverse_binary_warp<ANY_HIT, STATS>;
  // above 48 KB of dynamic shared memory a launch needs the kernel's
  // limit raised: raise it once per device
  static std::atomic<unsigned long long> raised{0};  // a bit per device
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  if (dev >= 64 || !((raised.load() >> dev) & 1)) {
    rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (rc != cudaSuccess) return (int)rc;
    if (dev < 64) raised.fetch_or(1ull << dev);
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  kernel<<<blocks, THREADS, smem, stream>>>(tree, o, d, tmin, tmax, n,
                                            stack_depth, out, err);
  return (int)cudaGetLastError();
}

#else  // host build

// This ray's stack: node links and entry t's, `stride` apart.
struct Stack {
  int* node;
  float* t;
  long stride;
  int depth;
};

bool push(const Stack& s, int* sp, int node, float t, int* err) {
  if (*sp >= s.depth) {
    *err |= ERR_STACK;
    return false;
  }
  s.node[(long)*sp * s.stride] = node;
  s.t[(long)*sp * s.stride] = t;
  ++*sp;
  return true;
}

// Walk the tree for one ray. Returns the best t (BIG on a miss) and its
// id; any-hit returns at the first accepted triangle. With STATS, `vis`
// counts the internal nodes and leaves this walk visits.
template <bool ANY_HIT, bool STATS>
float walk(const Tree& tree, const Ray& r, const Stack& s, int* best_id,
              int* err, Visits* vis) {
  float best = BIG;
  *best_id = 0;
  if (!(r.tmax >= r.tmin)) return best;  // dead and padded rays
  int sp = 0;
  if (!push(s, &sp, 0, r.tmin, err)) return best;
  while (sp > 0) {
    --sp;
    const int node = s.node[(long)sp * s.stride];
    const float ten = s.t[(long)sp * s.stride];
    const float curmax = fminf(r.tmax, best);
    if (!(ten <= curmax)) continue;  // entered past the best hit
    if (node >= 0) {
      if (node >= tree.n_nodes) {
        *err |= ERR_LINK;
        return best;
      }
      if (STATS) ++vis->internal;
      float v[16];
      for (int a = 0; a < 16; ++a) v[a] = LDG(tree.cbox + (long)node * 16 + a);
      const Children c = children(v, r, curmax);
      // far child first, so that the near one is popped next
      if (c.far_hit && !push(s, &sp, c.far_link, c.far_t, err)) return best;
      if (c.near_hit && !push(s, &sp, c.near_link, c.near_t, err))
        return best;
    } else {
      const int leaf = -node - 1;
      if (leaf >= tree.n_leaves) {
        *err |= ERR_LINK;
        return best;
      }
      if (STATS) ++vis->leaf;
      int lane;
      const float* lw = tree.leafW + (long)leaf * 16 * 4 * K;
      const float lt = pluecker::shade_leaf<K>(lw, r, curmax, &lane);
      if (lt < best) {
        best = lt;
        *best_id = leaf * K + lane;
        if (ANY_HIT) return best;
      }
    }
  }
  return best;
}

template <bool ANY_HIT, bool STATS>
void trace_one(const Tree& tree, const float* o, const float* d,
               const float* tmin, const float* tmax, long i, long n,
               int* stack_node, float* stack_t, int stack_depth,
               const Out& out, int* err) {
  const Ray r = pluecker::load_ray(o, d, tmin, tmax, i);
  const Stack s{stack_node + i, stack_t + i, n, stack_depth};
  int id;
  Visits vis;
  out.t[i] = walk<ANY_HIT, STATS>(tree, r, s, &id, err, &vis);
  out.id[i] = id;
  if (STATS) {
    out.nv[i] = vis.internal;
    out.lv[i] = vis.leaf;
  }
}

#endif  // __CUDACC__

}  // namespace

// The card walk's block size and the shared memory a block may use (227
// KB), for the wrapper to size and check the stacks with before a launch.
extern "C" int traverse_binary_threads() { return THREADS; }
extern "C" int traverse_binary_max_smem() { return MAX_SMEM; }

#ifdef __CUDACC__

// One launch of the card walk over n rays (n > 0). Outputs: out_t (n,)
// f32 (BIG on a miss), out_id (n,) i32 = leaf*K + lane (0 on a miss; for
// any-hit the triangle that occluded), and, when out_nv and out_lv are
// not null, each ray's internal-node and leaf visits (n,) i32 (the STATS
// kernel; both null runs it without counters). The stack takes
// stack_depth * 128 * 8 bytes of shared memory per block, at most
// 232,448. cbox is 16-byte aligned. `err` is one i32 that the wrapper
// zeroes and reads back (1: stack overflow, 2: bad link). Returns
// cudaGetLastError() after the launch.
extern "C" int traverse_binary(int any_hit, const void* o, const void* d,
                               const void* tmin, const void* tmax, int n,
                               const void* cbox, const void* leafW,
                               int n_nodes, int n_leaves, int stack_depth,
                               void* out_t, void* out_id, void* out_nv,
                               void* out_lv, void* err, void* stream) {
  if ((out_nv == nullptr) != (out_lv == nullptr))
    return (int)cudaErrorInvalidValue;
  const Tree tree{(const float*)cbox, (const float*)leafW, n_nodes,
                  n_leaves};
  const Out out{(float*)out_t, (int*)out_id, (int*)out_nv, (int*)out_lv};
  const bool stats = out_nv != nullptr;
  auto fn = any_hit ? (stats ? launch<true, true> : launch<true, false>)
                    : (stats ? launch<false, true> : launch<false, false>);
  return fn(tree, (const float*)o, (const float*)d, (const float*)tmin,
            (const float*)tmax, n, stack_depth, out, (int*)err,
            (cudaStream_t)stream);
}

#ifdef WALK_PROBE
// Copy the probe's six sums to `out` (host memory) and zero them.
extern "C" int traverse_binary_probe(void* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, walk_probe, sizeof(walk_probe));
  if (rc != cudaSuccess) return (int)rc;
  const unsigned long long zeros[6] = {};
  return (int)cudaMemcpyToSymbol(walk_probe, zeros, sizeof(zeros));
}
#endif

#else  // host build

// The same walk on the host, one ray after another, for the CPU tests.
// Arguments as traverse_binary without the stream, with (stack_depth, n)
// scratch stacks stack_node (i32) and stack_t (f32); out_nv and out_lv
// may be null. Returns the error bits.
extern "C" int traverse_binary_host(int any_hit, const float* o,
                                    const float* d, const float* tmin,
                                    const float* tmax, int n,
                                    const float* cbox, const float* leafW,
                                    int n_nodes, int n_leaves,
                                    int* stack_node, float* stack_t,
                                    int stack_depth, float* out_t,
                                    int* out_id, int* out_nv, int* out_lv) {
  const Tree tree{cbox, leafW, n_nodes, n_leaves};
  const Out out{out_t, out_id, out_nv, out_lv};
  int err = 0;
  for (long i = 0; i < n; ++i) {
    if (any_hit && out_nv)
      trace_one<true, true>(tree, o, d, tmin, tmax, i, n, stack_node,
                            stack_t, stack_depth, out, &err);
    else if (any_hit)
      trace_one<true, false>(tree, o, d, tmin, tmax, i, n, stack_node,
                             stack_t, stack_depth, out, &err);
    else if (out_nv)
      trace_one<false, true>(tree, o, d, tmin, tmax, i, n, stack_node,
                             stack_t, stack_depth, out, &err);
    else
      trace_one<false, false>(tree, o, d, tmin, tmax, i, n, stack_node,
                              stack_t, stack_depth, out, &err);
  }
  return err;
}

#endif
