// Wide-BVH closest-hit and any-hit traversal for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cse168_raytracer_tpu/ops/pallas_bvh.py::
// _traverse4_one (launched from pallas_bvh_closest_hit_triangles) in its
// closest-hit-with-attributes and any-hit modes, for W = 4 and W = 8
// trees, and its with_stats mode (the -DSTATS counters): with STATS the
// walk also writes each ray's internal-node and leaf visit counts. The
// TPU kernel counts the visits of a 256-ray tile and bills them to every
// ray in it; here each thread walks its own ray (a warp shares only its
// leaf tests), so a count is that ray's own walk. The counters are
// registers written once, and the STATS=false instantiations carry none
// of them. It reads the JAX package's tree arrays byte for byte:
//   cbox  (N, 8W) f32, plane-grouped: lo_x[W] lo_y[W] lo_z[W]
//         hi_x[W] hi_y[W] hi_z[W] pad[2W]; empty slots are degenerate
//         boxes at 1e30 linked to leaf 0 (the slab test rejects them);
//   links (N*W,) i32: >= 0 an internal node, < 0 the leaf -link-1;
//   leafW (L, 16, 4K) f32: column k holds triangle k's Pluecker rows for
//         beta (col k), gamma (K+k) and den (2K+k) in rows 0-5 against
//         the ray operand [d, o x d], and the t numerator (3K+k) in rows
//         6-9 against [o, 1];
//   attrA (L, 16, 2K) f32: attribute row r < 16 of lane k at [r][k],
//         row 16+r at [r][K+k] (ops/surface.py pack_attr_rows layout).
//
// What bounds it on this card: not FLOPs but lanes that idle and loads
// that scatter. A leaf visit is 128 triangle tests of ~53 operations
// and 22 operand loads each, against ~4 slab tests per internal visit,
// so leaves carry ~97% of the operations. One thread walking one ray
// (walk() below, the first design of this kernel) runs that leaf loop
// once for every iteration on which some lane of the warp reaches a
// leaf while the others wait, gathers each of its operands from up to
// 32 leaves, and keeps its stack in device memory on the walk's
// dependency chain. The card walk (traverse_warp) answers each cause:
//  1. lanes idling: a warp-uniform "walk until a leaf, then test the
//     leaves together" loop (Aila and Laine's while-while). Each lane
//     pops and tests internal nodes as walk() does until it holds a
//     leaf or its stack is empty; then the warp serves every pending
//     leaf, and only then do the lanes walk on. A lane that holds a
//     leaf does nothing else until that leaf is tested and its best
//     updated, so every ray's pops, its curmax at each node, its visits
//     and its answer are walk()'s and walk_plain's. All 32 lanes stay in
//     the loop to its end (threads past n and dead or retired rays with
//     an empty stack), so the full-warp shuffles are defined;
//  2. scattered operand loads: the leaf test is the warp's
//     (pluecker::warp_shade_leaf): per distinct pending leaf
//     (__match_any_sync), each lane loads four triangles' operands with
//     16-byte loads that are contiguous across the warp, keeps them in
//     registers and tests them against each ray of the group, whose
//     operands come by shuffle; the warp then reduces (t, k) with
//     shade_leaf's tie rule. A leaf's operands are read once per group
//     of rays at it, as the TPU kernel's one product over a ray tile
//     reads them once;
//  3. the stack in device memory: each thread's stack_depth slots live
//     in dynamic shared memory, slot-major ([slot][thread]), so a
//     warp's pushes and pops fall in 32 distinct banks.
// Threads take rays in the integrator's 16x8 pixel-block order (one
// block of 128 threads is one pixel block), so a warp's rays walk
// nearly the same nodes and often wait at the same leaf; the winner's
// attributes are gathered once after the walk. What bounds the card
// walk is then the issue of the leaf tests themselves: four exact
// triangle tests per lane and ray (each with an IEEE division), the
// ray's shuffles and the reduction, at the occupancy that the four
// triangles' operands in registers allow (~150 registers a thread,
// three blocks an SM). The leaf test stays exact f32 (no tensor cores):
// it must equal the plain version bit for bit. wgmma, TMA and a leaf
// re-layout are left for later work.
//
// Arithmetic: the leaf test and the padded slab test are pluecker.cuh's,
// shared with traverse_binary.cu and tri_blocks.cu: round-to-nearest
// intrinsics in one fixed order, never a fused multiply-add, so the
// results equal the plain PyTorch twin in ops/wide_bvh.py bit for bit.
//
// walk() is plain C++ so that it also compiles for the host (g++ -x
// c++), where the CPU tests run it ray by ray against the twin; the card
// walk repeats its steps in that order.

#include <string.h>

#include <atomic>

#include "pluecker.cuh"

namespace {

using pluecker::BIG;
using pluecker::Ray;
using pluecker::load_ray;

constexpr int K = 128;                  // triangles per leaf
constexpr int THREADS = 128;            // the card walk's block: 16x8 rays
constexpr int MAX_SMEM = 232448;        // shared memory a block may use

enum : int { ERR_STACK = 1, ERR_LINK = 2 };

struct Tree {
  const float* cbox;
  const int* links;
  const float* leafW;
  const float* attrA;
  int n_nodes;
  int n_leaves;
};

// Visit counts of one walk (STATS).
struct Visits {
  int internal = 0, leaf = 0;
};

// Walk the tree for one ray. `stack` holds this ray's slots at a stride
// of `stride` ints. Returns the best t (BIG on a miss) and its id; any-hit
// returns at the first accepted triangle. With STATS, `vis` counts the
// internal nodes and leaves this walk visits.
template <int W, bool ANY_HIT, bool STATS>
HD float walk(const Tree& tree, const Ray& r, int* stack, long stride,
              int stack_depth, int* best_id, int* err, Visits* vis) {
  float best = BIG;
  *best_id = 0;
  if (!(r.tmax >= r.tmin)) return best;  // dead and padded lanes
  int sp = 0;
  stack[0] = 0;
  sp = 1;
  while (sp > 0) {
    const int node = stack[(long)(--sp) * stride];
    if (node >= 0) {
      if (node >= tree.n_nodes) {
        *err |= ERR_LINK;
        return best;
      }
      if (STATS) ++vis->internal;
      const float curmax = fminf(r.tmax, best);
      const float* cb = tree.cbox + (long)node * 8 * W;
      for (int i = 0; i < W; ++i) {
        float lo[3], hi[3], ext;
        for (int a = 0; a < 3; ++a) {
          lo[a] = LDG(cb + a * W + i);
          hi[a] = LDG(cb + 3 * W + a * W + i);
        }
        const float ent = pluecker::padded_entry(lo, hi, r, curmax, &ext);
        if (ent <= ext) {
          if (sp >= stack_depth) {
            *err |= ERR_STACK;
            return best;
          }
          stack[(long)(sp++) * stride] = LDG(tree.links + (long)node * W + i);
        }
      }
    } else {
      const int leaf = -node - 1;
      if (leaf >= tree.n_leaves) {
        *err |= ERR_LINK;
        return best;
      }
      if (STATS) ++vis->leaf;
      int lane;
      const float* lw = tree.leafW + (long)leaf * 16 * 4 * K;
      const float lt =
          pluecker::shade_leaf<K>(lw, r, fminf(r.tmax, best), &lane);
      if (lt < best) {
        best = lt;
        *best_id = leaf * K + lane;
        if (ANY_HIT) return best;
      }
    }
  }
  return best;
}

// The winner's 32 attribute floats, zeros on a miss.
HD void gather_attr(const Tree& tree, float best, int id, float* out) {
  if (best < BIG) {
    const float* a = tree.attrA + (long)(id / K) * 16 * 2 * K;
    const int lane = id % K;
    for (int r = 0; r < 16; ++r) {
      out[r] = LDG(a + r * 2 * K + lane);
      out[16 + r] = LDG(a + r * 2 * K + K + lane);
    }
  } else {
    for (int r = 0; r < 32; ++r) out[r] = 0.0f;
  }
}

// Outputs of a launch; out_id and out_attr are unused by any-hit,
// out_nv and out_lv (the visit counts) unless STATS.
struct Out {
  float* t;
  int* id;
  float* attr;
  int* nv;
  int* lv;
};

template <int W, bool ANY_HIT, bool STATS>
HD void trace_one(const Tree& tree, const float* o, const float* d,
                  const float* tmin, const float* tmax, long i, long n,
                  int* stack, int stack_depth, const Out& out, int* err) {
  const Ray r = load_ray(o, d, tmin, tmax, i);
  int id;
  Visits vis;
  const float best = walk<W, ANY_HIT, STATS>(tree, r, stack + i, n,
                                             stack_depth, &id, err, &vis);
  out.t[i] = best;
  if (!ANY_HIT) {
    out.id[i] = id;
    gather_attr(tree, best, id, out.attr + 32 * i);
  }
  if (STATS) {
    out.nv[i] = vis.internal;
    out.lv[i] = vis.leaf;
  }
}

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
// The stack is `stack_depth` ints of dynamic shared memory per thread,
// slot s of thread x at [s * THREADS + x].
template <int W, bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(THREADS)
    traverse_warp(Tree tree, const float* __restrict__ o,
                  const float* __restrict__ d,
                  const float* __restrict__ tmin,
                  const float* __restrict__ tmax, int n, int stack_depth,
                  Out out, int* err) {
  extern __shared__ int smem[];
  int* stack = smem + threadIdx.x;
  const long i = (long)blockIdx.x * THREADS + threadIdx.x;
  Ray r = {};
  r.tmax = -1.0f;  // threads past n walk nothing, but stay in the warp
  if (i < n) r = load_ray(o, d, tmin, tmax, i);
  float best = BIG;
  int best_id = 0, e = 0, sp = 0, leaf = -1;
  Visits vis;
  if (r.tmax >= r.tmin) {  // dead rays visit nothing
    stack[0] = 0;
    sp = 1;
  }
  PROBE(long long walk_cycles = 0, serve_cycles = 0, rounds = 0,
        groups = 0, pairs = 0;)
  for (;;) {
    PROBE(const long long c0 = clock64();)
    // walk() until this lane holds a leaf or its stack is empty
    while (leaf < 0 && sp > 0) {
      const int node = stack[--sp * THREADS];
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
      const float curmax = fminf(r.tmax, best);
      const float* cb = tree.cbox + (long)node * 8 * W;
      for (int s = 0; s < W; ++s) {
        float lo[3], hi[3], ext;
        for (int a = 0; a < 3; ++a) {
          lo[a] = LDG(cb + a * W + s);
          hi[a] = LDG(cb + 3 * W + a * W + s);
        }
        const float ent = pluecker::padded_entry(lo, hi, r, curmax, &ext);
        if (ent <= ext) {
          if (sp >= stack_depth) {
            e |= ERR_STACK;
            sp = 0;
            break;
          }
          stack[sp++ * THREADS] = LDG(tree.links + (long)node * W + s);
        }
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
    if (!ANY_HIT) {
      out.id[i] = best_id;
      gather_attr(tree, best, best_id, out.attr + 32 * i);
    }
    if (STATS) {
      out.nv[i] = vis.internal;
      out.lv[i] = vis.leaf;
    }
  }
  if (e) atomicOr(err, e);
}

// One launch of the card walk. Returns a CUDA error code.
template <int W, bool ANY_HIT, bool STATS>
int launch_w(Tree tree, const float* o, const float* d, const float* tmin,
             const float* tmax, int n, int stack_depth, const Out& out,
             int* err, cudaStream_t stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  const long smem = (long)stack_depth * THREADS * (long)sizeof(int);
  if (stack_depth < 1 || smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  auto kernel = traverse_warp<W, ANY_HIT, STATS>;
  if (smem > 48 * 1024) {
    // above 48 KB the kernel must be let take more, once per device
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
  }
  kernel<<<blocks, THREADS, smem, stream>>>(tree, o, d, tmin, tmax, n,
                                            stack_depth, out, err);
  return (int)cudaGetLastError();
}

template <bool ANY_HIT>
int launch(int width, Tree tree, const float* o, const float* d,
           const float* tmin, const float* tmax, int n, int stack_depth,
           const Out& out, int* err, cudaStream_t stream) {
  if ((out.nv == nullptr) != (out.lv == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool stats = out.nv != nullptr;
  if (width == 4)
    return (stats ? launch_w<4, ANY_HIT, true> : launch_w<4, ANY_HIT, false>)(
        tree, o, d, tmin, tmax, n, stack_depth, out, err, stream);
  if (width == 8)
    return (stats ? launch_w<8, ANY_HIT, true> : launch_w<8, ANY_HIT, false>)(
        tree, o, d, tmin, tmax, n, stack_depth, out, err, stream);
  return (int)cudaErrorInvalidValue;
}

int run_closest(int width, const void* o, const void* d, const void* tmin,
                const void* tmax, int n, const void* cbox, const void* links,
                const void* leafW, const void* attrA, int n_nodes,
                int n_leaves, int stack_depth, void* out_t, void* out_id,
                void* out_attr, void* out_nv, void* out_lv, void* err,
                void* stream) {
  const Tree tree{(const float*)cbox, (const int*)links, (const float*)leafW,
                  (const float*)attrA, n_nodes, n_leaves};
  const Out out{(float*)out_t, (int*)out_id, (float*)out_attr, (int*)out_nv,
                (int*)out_lv};
  return launch<false>(width, tree, (const float*)o, (const float*)d,
                       (const float*)tmin, (const float*)tmax, n,
                       stack_depth, out, (int*)err, (cudaStream_t)stream);
}

int run_any(int width, const void* o, const void* d, const void* tmin,
            const void* tmax, int n, const void* cbox, const void* links,
            const void* leafW, int n_nodes, int n_leaves, int stack_depth,
            void* out_t, void* out_nv, void* out_lv, void* err, void* stream) {
  const Tree tree{(const float*)cbox, (const int*)links, (const float*)leafW,
                  nullptr, n_nodes, n_leaves};
  const Out out{(float*)out_t, nullptr, nullptr, (int*)out_nv, (int*)out_lv};
  return launch<true>(width, tree, (const float*)o, (const float*)d,
                      (const float*)tmin, (const float*)tmax, n, stack_depth,
                      out, (int*)err, (cudaStream_t)stream);
}

#endif  // __CUDACC__

}  // namespace

// The card walk's block size and the shared memory a block may use (227
// KB), for the wrapper to size and check the stacks with before a launch.
extern "C" int traverse_wide_threads() { return THREADS; }
extern "C" int traverse_wide_max_smem() { return MAX_SMEM; }

#ifdef __CUDACC__

// Closest hit with the winner's attribute row, by the card walk.
// Outputs: out_t (n,) f32 (BIG on a miss), out_id (n,) i32 = leaf*K +
// lane (0 on a miss), out_attr (n, 32) f32 (zeros on a miss), and, when
// out_nv and out_lv are not null, each ray's internal-node and leaf
// visits (n,) i32 (the STATS kernel; both null runs the kernel without
// counters). The stack takes stack_depth * 128 * 4 bytes of shared
// memory per block, at most 232,448. `err` is one i32 that the wrapper
// zeroes and reads back. Returns cudaGetLastError() after the launch.
extern "C" int traverse_closest_attr(
    int width, const void* o, const void* d, const void* tmin,
    const void* tmax, int n, const void* cbox, const void* links,
    const void* leafW, const void* attrA, int n_nodes, int n_leaves,
    int stack_depth, void* out_t, void* out_id, void* out_attr,
    void* out_nv, void* out_lv, void* err, void* stream) {
  return run_closest(width, o, d, tmin, tmax, n, cbox, links, leafW, attrA,
                     n_nodes, n_leaves, stack_depth, out_t, out_id, out_attr,
                     out_nv, out_lv, err, stream);
}

// Any hit: out_t < BIG marks an occluded ray. Same conventions.
extern "C" int traverse_any(int width, const void* o, const void* d,
                            const void* tmin, const void* tmax, int n,
                            const void* cbox, const void* links,
                            const void* leafW, int n_nodes, int n_leaves,
                            int stack_depth, void* out_t, void* out_nv,
                            void* out_lv, void* err, void* stream) {
  return run_any(width, o, d, tmin, tmax, n, cbox, links, leafW, n_nodes,
                 n_leaves, stack_depth, out_t, out_nv, out_lv, err, stream);
}

#ifdef WALK_PROBE
// Copy the probe's six sums to `out` (host memory) and zero them.
extern "C" int traverse_wide_probe(void* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, walk_probe, sizeof(walk_probe));
  if (rc != cudaSuccess) return (int)rc;
  const unsigned long long zeros[6] = {};
  return (int)cudaMemcpyToSymbol(walk_probe, zeros, sizeof(zeros));
}
#endif

#else  // host build

template <int W, bool ANY_HIT>
void host_rays(const Tree& tree, const float* o, const float* d,
               const float* tmin, const float* tmax, int n, int* stack,
               int stack_depth, const Out& out, int* err) {
  for (long i = 0; i < n; ++i) {
    if (out.nv)
      trace_one<W, ANY_HIT, true>(tree, o, d, tmin, tmax, i, n, stack,
                                  stack_depth, out, err);
    else
      trace_one<W, ANY_HIT, false>(tree, o, d, tmin, tmax, i, n, stack,
                                   stack_depth, out, err);
  }
}

// The same walk on the host, one ray after another, for the CPU tests.
// Arguments as traverse_closest_attr; any_hit selects the mode (then
// out_id and out_attr are unused); out_nv and out_lv may be null.
// Returns the error bits.
extern "C" int traverse_host(int width, int any_hit, const float* o,
                             const float* d, const float* tmin,
                             const float* tmax, int n, const float* cbox,
                             const int* links, const float* leafW,
                             const float* attrA, int n_nodes, int n_leaves,
                             int* stack, int stack_depth, float* out_t,
                             int* out_id, float* out_attr, int* out_nv,
                             int* out_lv) {
  const Tree tree{cbox, links, leafW, attrA, n_nodes, n_leaves};
  const Out out{out_t, out_id, out_attr, out_nv, out_lv};
  int err = 0;
  if (width == 4 && any_hit)
    host_rays<4, true>(tree, o, d, tmin, tmax, n, stack, stack_depth, out,
                       &err);
  else if (width == 4)
    host_rays<4, false>(tree, o, d, tmin, tmax, n, stack, stack_depth, out,
                        &err);
  else if (any_hit)
    host_rays<8, true>(tree, o, d, tmin, tmax, n, stack, stack_depth, out,
                       &err);
  else
    host_rays<8, false>(tree, o, d, tmin, tmax, n, stack, stack_depth, out,
                        &err);
  return err;
}

#endif
