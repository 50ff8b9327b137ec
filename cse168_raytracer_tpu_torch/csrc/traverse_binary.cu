// Binary-BVH closest-hit and any-hit traversal for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cse168_raytracer_tpu/ops/pallas_bvh.py::
// _traverse_one (the body of _traverse_kernel, launched from
// pallas_bvh_closest_hit_triangles with a PallasBVH: attach_accel's
// kind="pallas_sah", or the implicit LBVH) in its three modes: closest
// hit, any hit, and with_stats (the -DSTATS counters). It reads the JAX
// package's tree arrays byte for byte:
//   cbox  (Nn, 16) f32 [loL(3) hiL(3) loR(3) hiR(3) childL childR pad2];
//         a child link >= 0 names an internal node, < 0 the leaf ~link;
//   leafW (L, 16, 4K) f32, the leaf table of traverse_wide.cu.
//
// The walk is the Pallas kernel's ordered descent (pallas_bvh.py:336-355)
// for one ray: each stack entry keeps the child's entry t, an entry whose
// t lies past the ray's current best is dropped when popped, and an
// internal visit pushes the far child first so that the near one is
// popped next. The TPU orders a 256-ray tile by the tile's smallest
// entry t; here each ray orders by its own, which changes which nodes a
// ray visits but not its hit. Counts are each ray's own walk (the TPU
// bills a tile's visits to every ray of it): box tests = 2 x internal
// visits, triangle tests = K x leaf visits (pallas_bvh.py:570-574). As
// in traverse_wide.cu, boxes are widened by BOX_PAD (pluecker.cuh), or a
// per-ray walk loses hits just past a leaf's box that the tile-wide walk
// keeps.
//
// What bounds it on this card: as for traverse_wide.cu, divergent,
// latency-bound node and leaf fetches, not FLOPs; a binary tree makes
// about twice the internal visits of the 4-wide one, each a dependent
// 64-byte fetch. The simple design is traverse_wide.cu's: one thread per
// ray with its own stack in global scratch, rays taken in the
// integrator's 16x8 pixel-block order so that a warp's walks stay
// coherent, the leaf test of pluecker.cuh (the same t as K1's, bit for
// bit). A stack overflow or a bad link sets a bit of the error flag.
//
// The walk is plain C++ so that it also compiles for the host (g++ -x
// c++), where the CPU tests run it against ops/binary_bvh.walk_binary_plain.

#include "pluecker.cuh"

namespace {

using pluecker::BIG;
using pluecker::Ray;

constexpr int K = 128;  // triangles per leaf

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

// This ray's stack: node links and entry t's, `stride` apart.
struct Stack {
  int* node;
  float* t;
  long stride;
  int depth;
};

HD bool push(const Stack& s, int* sp, int node, float t, int* err) {
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
HD float walk(const Tree& tree, const Ray& r, const Stack& s, int* best_id,
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
      const float* cb = tree.cbox + (long)node * 16;
      float lo[3], hi[3], ext_l, ext_r;
      for (int a = 0; a < 3; ++a) {
        lo[a] = LDG(cb + a);
        hi[a] = LDG(cb + 3 + a);
      }
      const float ent_l = pluecker::padded_entry(lo, hi, r, curmax, &ext_l);
      for (int a = 0; a < 3; ++a) {
        lo[a] = LDG(cb + 6 + a);
        hi[a] = LDG(cb + 9 + a);
      }
      const float ent_r = pluecker::padded_entry(lo, hi, r, curmax, &ext_r);
      const bool h_l = ent_l <= ext_l, h_r = ent_r <= ext_r;
      const float t_l = h_l ? ent_l : INFINITY;
      const float t_r = h_r ? ent_r : INFINITY;
      const int c_l = (int)LDG(cb + 12), c_r = (int)LDG(cb + 13);
      const bool l_near = t_l <= t_r;
      // far child first, so that the near one is popped next
      if (l_near ? h_r : h_l) {
        if (!push(s, &sp, l_near ? c_r : c_l, l_near ? t_r : t_l, err))
          return best;
      }
      if (l_near ? h_l : h_r) {
        if (!push(s, &sp, l_near ? c_l : c_r, l_near ? t_l : t_r, err))
          return best;
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

// Outputs of a launch: t and id always, the visit counts with STATS.
struct Out {
  float* t;
  int* id;
  int* nv;
  int* lv;
};

template <bool ANY_HIT, bool STATS>
HD void trace_one(const Tree& tree, const float* o, const float* d,
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

#ifdef __CUDACC__

template <bool ANY_HIT, bool STATS>
__global__ void __launch_bounds__(128)
    traverse_kernel(Tree tree, const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n, int* stack_node,
                    float* stack_t, int stack_depth, Out out, int* err) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int e = 0;
  trace_one<ANY_HIT, STATS>(tree, o, d, tmin, tmax, i, n, stack_node,
                            stack_t, stack_depth, out, &e);
  if (e) atomicOr(err, e);
}

template <bool ANY_HIT>
void launch_mode(const Tree& tree, const float* o, const float* d,
                 const float* tmin, const float* tmax, int n,
                 int* stack_node, float* stack_t, int stack_depth,
                 const Out& out, int* err, cudaStream_t stream) {
  const int threads = 128;  // one 16x8 pixel block of rays
  const int blocks = (n + threads - 1) / threads;
  if (out.nv)
    traverse_kernel<ANY_HIT, true><<<blocks, threads, 0, stream>>>(
        tree, o, d, tmin, tmax, n, stack_node, stack_t, stack_depth, out,
        err);
  else
    traverse_kernel<ANY_HIT, false><<<blocks, threads, 0, stream>>>(
        tree, o, d, tmin, tmax, n, stack_node, stack_t, stack_depth, out,
        err);
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// One launch over n rays (n > 0). Outputs: out_t (n,) f32 (BIG on a
// miss), out_id (n,) i32 = leaf*K + lane (0 on a miss; for any-hit the
// triangle that occluded), and, when out_nv and out_lv are not null,
// each ray's internal-node and leaf visits (n,) i32 (the STATS kernel;
// both null runs it without counters). stack_node (i32) and stack_t
// (f32) are (stack_depth, n) scratch; `err` one i32 that the wrapper
// zeroes and reads back (1: stack overflow, 2: bad link). Returns
// cudaGetLastError() after the launch.
extern "C" int traverse_binary(int any_hit, const void* o, const void* d,
                               const void* tmin, const void* tmax, int n,
                               const void* cbox, const void* leafW,
                               int n_nodes, int n_leaves, void* stack_node,
                               void* stack_t, int stack_depth, void* out_t,
                               void* out_id, void* out_nv, void* out_lv,
                               void* err, void* stream) {
  if ((out_nv == nullptr) != (out_lv == nullptr))
    return (int)cudaErrorInvalidValue;
  const Tree tree{(const float*)cbox, (const float*)leafW, n_nodes,
                  n_leaves};
  const Out out{(float*)out_t, (int*)out_id, (int*)out_nv, (int*)out_lv};
  if (any_hit)
    launch_mode<true>(tree, (const float*)o, (const float*)d,
                      (const float*)tmin, (const float*)tmax, n,
                      (int*)stack_node, (float*)stack_t, stack_depth, out,
                      (int*)err, (cudaStream_t)stream);
  else
    launch_mode<false>(tree, (const float*)o, (const float*)d,
                       (const float*)tmin, (const float*)tmax, n,
                       (int*)stack_node, (float*)stack_t, stack_depth, out,
                       (int*)err, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

#else  // host build

// The same walk on the host, one ray after another, for the CPU tests.
// Arguments as traverse_binary without the stream; out_nv and out_lv
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
