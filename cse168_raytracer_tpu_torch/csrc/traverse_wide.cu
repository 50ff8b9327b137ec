// Wide-BVH closest-hit and any-hit traversal for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cse168_raytracer_tpu/ops/pallas_bvh.py::
// _traverse4_one (launched from pallas_bvh_closest_hit_triangles) in its
// closest-hit-with-attributes and any-hit modes, for W = 4 and W = 8
// trees, and its with_stats mode (the -DSTATS counters): with STATS the
// walk also writes each ray's internal-node and leaf visit counts. The
// TPU kernel counts the visits of a 256-ray tile and bills them to every
// ray in it; here one thread walks one ray, so a count is that ray's own
// walk. The counters are registers written once, and the STATS=false
// instantiations carry none of them. It reads the JAX package's tree
// arrays byte for byte:
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
// What bounds it on this card: divergent, latency-bound node and leaf
// fetches, not FLOPs. A leaf visit does ~30 flops per triangle against
// ~90 bytes of leaf operands, and which leaf comes next depends on the
// last fetch. The simple design answers that with occupancy and
// coherence: one thread walks one ray with its own stack, threads take
// rays in the integrator's 16x8 pixel-block order so that a warp's rays
// walk nearly the same nodes (their fetches coalesce into broadcasts and
// hit L1), the leaf loop reads each operand column in order so a cache
// line serves 32 consecutive triangles, and the winner's attributes are
// gathered once after the walk. wgmma, TMA, warp-level traversal and a
// leaf re-layout are left for later work.
//
// Arithmetic: the leaf test and the padded slab test are pluecker.cuh's,
// shared with traverse_binary.cu and tri_blocks.cu: round-to-nearest
// intrinsics in one fixed order, never a fused multiply-add, so the
// results equal the plain PyTorch twin in ops/wide_bvh.py bit for bit.
//
// The walk is plain C++ so that it also compiles for the host
// (g++ -x c++), where the CPU tests run it against the twin.

#include <string.h>

#include "pluecker.cuh"

namespace {

using pluecker::BIG;
using pluecker::Ray;
using pluecker::load_ray;

constexpr int K = 128;                  // triangles per leaf

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

template <int W, bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(128)
    traverse_kernel(Tree tree, const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n, int* stack,
                    int stack_depth, Out out, int* err) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int e = 0;
  trace_one<W, ANY_HIT, STATS>(tree, o, d, tmin, tmax, i, n, stack,
                               stack_depth, out, &e);
  if (e) atomicOr(err, e);
}

template <int W, bool ANY_HIT>
void launch_w(Tree tree, const float* o, const float* d, const float* tmin,
              const float* tmax, int n, int* stack, int stack_depth,
              const Out& out, int* err, cudaStream_t stream) {
  const int threads = 128;  // one 16x8 pixel block of rays
  const int blocks = (n + threads - 1) / threads;
  if (out.nv)
    traverse_kernel<W, ANY_HIT, true><<<blocks, threads, 0, stream>>>(
        tree, o, d, tmin, tmax, n, stack, stack_depth, out, err);
  else
    traverse_kernel<W, ANY_HIT, false><<<blocks, threads, 0, stream>>>(
        tree, o, d, tmin, tmax, n, stack, stack_depth, out, err);
}

template <bool ANY_HIT>
int launch(int width, Tree tree, const float* o, const float* d,
           const float* tmin, const float* tmax, int n, int* stack,
           int stack_depth, const Out& out, int* err, cudaStream_t stream) {
  if ((out.nv == nullptr) != (out.lv == nullptr))
    return (int)cudaErrorInvalidValue;
  if (width == 4)
    launch_w<4, ANY_HIT>(tree, o, d, tmin, tmax, n, stack, stack_depth, out,
                         err, stream);
  else if (width == 8)
    launch_w<8, ANY_HIT>(tree, o, d, tmin, tmax, n, stack, stack_depth, out,
                         err, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Closest hit with the winner's attribute row. Outputs: out_t (n,) f32
// (BIG on a miss), out_id (n,) i32 = leaf*K + lane (0 on a miss),
// out_attr (n, 32) f32 (zeros on a miss), and, when out_nv and out_lv
// are not null, each ray's internal-node and leaf visits (n,) i32 (the
// STATS kernel; both null runs the kernel without counters). `stack` is
// (stack_depth, n) i32 scratch; `err` one i32 that the wrapper zeroes
// and reads back. Returns cudaGetLastError() after the launch.
extern "C" int traverse_closest_attr(
    int width, const void* o, const void* d, const void* tmin,
    const void* tmax, int n, const void* cbox, const void* links,
    const void* leafW, const void* attrA, int n_nodes, int n_leaves,
    void* stack, int stack_depth, void* out_t, void* out_id, void* out_attr,
    void* out_nv, void* out_lv, void* err, void* stream) {
  const Tree tree{(const float*)cbox, (const int*)links, (const float*)leafW,
                  (const float*)attrA, n_nodes, n_leaves};
  const Out out{(float*)out_t, (int*)out_id, (float*)out_attr, (int*)out_nv,
                (int*)out_lv};
  return launch<false>(width, tree, (const float*)o, (const float*)d,
                       (const float*)tmin, (const float*)tmax, n,
                       (int*)stack, stack_depth, out, (int*)err,
                       (cudaStream_t)stream);
}

// Any hit: out_t < BIG marks an occluded ray. Same conventions.
extern "C" int traverse_any(int width, const void* o, const void* d,
                            const void* tmin, const void* tmax, int n,
                            const void* cbox, const void* links,
                            const void* leafW, int n_nodes, int n_leaves,
                            void* stack, int stack_depth, void* out_t,
                            void* out_nv, void* out_lv, void* err,
                            void* stream) {
  const Tree tree{(const float*)cbox, (const int*)links, (const float*)leafW,
                  nullptr, n_nodes, n_leaves};
  const Out out{(float*)out_t, nullptr, nullptr, (int*)out_nv, (int*)out_lv};
  return launch<true>(width, tree, (const float*)o, (const float*)d,
                      (const float*)tmin, (const float*)tmax, n, (int*)stack,
                      stack_depth, out, (int*)err, (cudaStream_t)stream);
}

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
