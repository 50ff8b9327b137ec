// The ray-triangle test shared by the port's traversal kernels
// (traverse_wide.cu, traverse_binary.cu, tri_blocks.cu).
//
// A triangle is ten Pluecker operands (ops/geometry's plucker_operands):
// six rows for each of the beta, gamma and den numerators against the
// ray operand [d, o x d], and four rows for the t numerator against
// [o, 1]. Every kernel evaluates them with the round-to-nearest
// intrinsics in one fixed order and never a fused multiply-add, so each
// kernel equals its plain PyTorch version (ops/pluecker.py) bit for bit,
// and the kernels agree with each other on t. Build without
// --use_fast_math: it would change the IEEE divisions and flush
// denormals.
//
// The code is plain C++ so that it also compiles for the host (g++ -x
// c++, where HD is `inline` and the intrinsics are the plain operators),
// where the CPU tests run the kernels' walks against their plain
// versions; only warp_shade_leaf, the card's warp-cooperative form of
// shade_leaf, is device code.

#pragma once

#include <math.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HD __device__ __forceinline__
#define LDG(p) __ldg(p)
#else
#define HD inline
#define LDG(p) (*(p))
static inline float __fmul_rn(float a, float b) { return a * b; }
static inline float __fadd_rn(float a, float b) { return a + b; }
static inline float __fsub_rn(float a, float b) { return a - b; }
static inline float __fdiv_rn(float a, float b) { return a / b; }
#endif

namespace pluecker {

constexpr float BIG = 3.0e37f;          // ops/intersect.py _BIG (a miss)
constexpr float DEN_TINY = 1e-30f;      // ops/intersect.py _DEN_TINY
constexpr float NEG_EPS = (float)(-1e-4);      // -config.EPSILON
constexpr float ONE_EPS = (float)(1.0 + 1e-4);  // 1 + config.EPSILON
constexpr float BOX_PAD = 1e-3f;        // tree slot widening, 5x 2*EPSILON

struct Ray {
  float o[3], d[3], m[3], rcp[3];
  float tmin, tmax;
};

// The ray's origin, direction, reciprocal direction and moment m = o x d,
// each product rounded on its own (as core/vecmath.cross rounds it).
HD Ray load_ray(const float* o, const float* d, const float* tmin,
                const float* tmax, long i) {
  Ray r;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = LDG(o + 3 * i + a);
    r.d[a] = LDG(d + 3 * i + a);
    r.rcp[a] = __fdiv_rn(1.0f, r.d[a]);
  }
  r.m[0] = __fsub_rn(__fmul_rn(r.o[1], r.d[2]), __fmul_rn(r.o[2], r.d[1]));
  r.m[1] = __fsub_rn(__fmul_rn(r.o[2], r.d[0]), __fmul_rn(r.o[0], r.d[2]));
  r.m[2] = __fsub_rn(__fmul_rn(r.o[0], r.d[1]), __fmul_rn(r.o[1], r.d[0]));
  r.tmin = LDG(tmin + i);
  r.tmax = LDG(tmax + i);
  return r;
}

// One numerator of beta, gamma or den: six operands against [d, m],
// summed left to right. Every leaf test of the port sums in this order.
HD float dot6(const float w[6], const Ray& r) {
  float acc = __fmul_rn(w[0], r.d[0]);
  acc = __fadd_rn(acc, __fmul_rn(w[1], r.d[1]));
  acc = __fadd_rn(acc, __fmul_rn(w[2], r.d[2]));
  acc = __fadd_rn(acc, __fmul_rn(w[3], r.m[0]));
  acc = __fadd_rn(acc, __fmul_rn(w[4], r.m[1]));
  return __fadd_rn(acc, __fmul_rn(w[5], r.m[2]));
}

// The t numerator: four operands against [o, 1].
HD float dot4(const float w[4], const Ray& r) {
  float acc = __fmul_rn(w[0], r.o[0]);
  acc = __fadd_rn(acc, __fmul_rn(w[1], r.o[1]));
  acc = __fadd_rn(acc, __fmul_rn(w[2], r.o[2]));
  return __fadd_rn(acc, w[3]);
}

// dot6 and dot4 of operand rows `stride` floats apart, from global
// memory through the read-only cache.
HD float sum6(const float* w, long stride, const Ray& r) {
  const float v[6] = {LDG(w), LDG(w + stride), LDG(w + 2 * stride),
                      LDG(w + 3 * stride), LDG(w + 4 * stride),
                      LDG(w + 5 * stride)};
  return dot6(v, r);
}

HD float sum4(const float* w, long stride, const Ray& r) {
  const float v[4] = {LDG(w), LDG(w + stride), LDG(w + 2 * stride),
                      LDG(w + 3 * stride)};
  return dot4(v, r);
}

// The same two sums from shared memory (no read-only cache load there).
HD float sum6_s(const float* w, int stride, const Ray& r) {
  const float v[6] = {w[0], w[stride], w[2 * stride], w[3 * stride],
                      w[4 * stride], w[5 * stride]};
  return dot6(v, r);
}

HD float sum4_s(const float* w, int stride, const Ray& r) {
  const float v[4] = {w[0], w[stride], w[2 * stride], w[3 * stride]};
  return dot4(v, r);
}

// t of the hit from the four numerators, or BIG where the triangle does
// not accept the ray with t in [tmin, tmax] (the acceptance rule of
// cse168_raytracer_tpu/ops/pallas_bvh.py:1241-1244, Triangle.cpp:158).
HD float accept(float b, float g, float den, float tn, float tmin,
                float tmax) {
  const bool tiny = fabsf(den) < DEN_TINY;
  const float inv = __fdiv_rn(1.0f, tiny ? 1.0f : den);
  const float beta = __fmul_rn(b, inv);
  const float gamma = __fmul_rn(g, inv);
  const float tt = __fmul_rn(tn, inv);
  const bool ok = beta >= NEG_EPS && gamma >= NEG_EPS &&
                  __fadd_rn(beta, gamma) <= ONE_EPS && tt >= tmin &&
                  tt <= tmax && !tiny;
  return ok ? tt : BIG;
}

// The tree kernels' leaf table: (L, 16, 4K) f32, column k holding
// triangle k's beta (col k), gamma (K+k) and den (2K+k) rows 0-5 and its
// t numerator (col 3K+k) in rows 6-9. Nearest accepted triangle of one
// leaf with t in [tmin, curmax]; the first lane wins ties. Returns BIG
// when none is accepted.
template <int K>
HD float shade_leaf(const float* lw, const Ray& r, float curmax, int* lane) {
  const long s = 4 * K;
  float lt = BIG;
  int lj = 0;
  for (int k = 0; k < K; ++k) {
    const float tt = accept(sum6(lw + k, s, r), sum6(lw + K + k, s, r),
                            sum6(lw + 2 * K + k, s, r),
                            sum4(lw + 6 * s + 3 * K + k, s, r), r.tmin,
                            curmax);
    if (tt < lt) {
      lt = tt;
      lj = k;
    }
  }
  *lane = lj;
  return lt;
}

// Triangle k's ten operand rows, held in registers.
struct TriOps {
  float b[6], g[6], den[6], tn[4];
};

// shade_leaf's test of one triangle whose operands a thread holds.
HD float tri_t(const TriOps& op, const Ray& r, float curmax) {
  return accept(dot6(op.b, r), dot6(op.g, r), dot6(op.den, r),
                dot4(op.tn, r), r.tmin, curmax);
}

#ifdef __CUDACC__

constexpr unsigned FULL_WARP = 0xffffffffu;

// shade_leaf for the rays of the lanes in `group`, tested by the whole
// warp together. The group is warp-uniform and all 32 lanes call this.
// Lane l loads triangles 4l..4l+3 of the leaf table, one 16-byte load
// per operand row (so each row is one contiguous 512-byte read of the
// warp), and keeps their operands in registers. Then, for each ray of
// the group, every lane takes the ray's d, m, o, tmin and curmax from
// its lane by shuffle and tests its four triangles, and the warp
// reduces to the least t (__reduce_min_sync on an order-keeping int
// key) and, on equal t, the least k: shade_leaf's first-lane-wins rule,
// since the first lane that holds the least t holds the first k with
// it; the t returned is that lane's. A lane of the group gets its ray's
// answer (t, or BIG when no triangle accepts it, and the lane), every
// other lane BIG.
template <int K>
__device__ __forceinline__ float warp_shade_leaf(const float* lw,
                                                 unsigned group,
                                                 const Ray& r, float curmax,
                                                 int* lane) {
  static_assert(K == 4 * 32, "four triangles per lane");
  const int l = threadIdx.x & 31;
  const float* base = lw + 4 * l;
  TriOps op[4];
  for (int a = 0; a < 6; ++a) {
    const float4 vb = __ldg((const float4*)(base + a * 4 * K));
    const float4 vg = __ldg((const float4*)(base + a * 4 * K + K));
    const float4 vd = __ldg((const float4*)(base + a * 4 * K + 2 * K));
    const float b[4] = {vb.x, vb.y, vb.z, vb.w};
    const float g[4] = {vg.x, vg.y, vg.z, vg.w};
    const float dn[4] = {vd.x, vd.y, vd.z, vd.w};
    for (int j = 0; j < 4; ++j) {
      op[j].b[a] = b[j];
      op[j].g[a] = g[j];
      op[j].den[a] = dn[j];
    }
  }
  for (int a = 0; a < 4; ++a) {
    const float4 vt = __ldg((const float4*)(base + (6 + a) * 4 * K + 3 * K));
    const float tn[4] = {vt.x, vt.y, vt.z, vt.w};
    for (int j = 0; j < 4; ++j) op[j].tn[a] = tn[j];
  }
  float my_t = BIG;
  int my_lane = 0;
  for (unsigned g = group; g; g &= g - 1) {
    const int q = __ffs(g) - 1;
    Ray rq;
    for (int a = 0; a < 3; ++a) {
      rq.o[a] = __shfl_sync(FULL_WARP, r.o[a], q);
      rq.d[a] = __shfl_sync(FULL_WARP, r.d[a], q);
      rq.m[a] = __shfl_sync(FULL_WARP, r.m[a], q);
    }
    rq.tmin = __shfl_sync(FULL_WARP, r.tmin, q);
    const float cm = __shfl_sync(FULL_WARP, curmax, q);
    float lt = BIG;
    int lj = 0;
    for (int j = 0; j < 4; ++j) {
      const float tt = tri_t(op[j], rq, cm);
      if (tt < lt) {
        lt = tt;
        lj = j;
      }
    }
    // the least t in one warp reduction: as ints, floats that are not
    // NaN (lt never is) order as their bit patterns do once a negative
    // one's magnitude bits are flipped; +0 and -0 share key 0, equal as
    // shade_leaf's compare holds them
    const int bits = __float_as_int(lt);
    const int key = lt == 0.0f ? 0 : (bits >= 0 ? bits : bits ^ 0x7fffffff);
    const int least = __reduce_min_sync(FULL_WARP, key);
    const int src = __ffs(__ballot_sync(FULL_WARP, key == least)) - 1;
    const float t = __shfl_sync(FULL_WARP, lt, src);
    const int k = 4 * src + __shfl_sync(FULL_WARP, lj, src);
    if (l == q) {
      my_t = t;
      my_lane = k;
    }
  }
  *lane = my_lane;
  return my_t;
}

#endif  // __CUDACC__

HD float slab_near(float a) { return isnan(a) ? -INFINITY : a; }
HD float slab_far(float a) { return isnan(a) ? INFINITY : a; }

// The ray's entry t into the box [lo, hi] widened by BOX_PAD of its own
// extent, clipped to [tmin, tmax]; the box passes when the entry is at
// most the exit, written to *exit_t. The acceptance rule admits points
// up to 2*EPSILON of a triangle's extent outside it, so a tree widens
// each box; without that a walk misses hits just past a shared edge,
// which the brute force finds. An empty slot (a degenerate point at
// 1e30) has zero extent and stays a point. NaN from 0*inf leaves that
// axis unconstrained. The intrinsics keep nvcc from fusing these into a
// multiply-add, so the visits equal the plain walks'.
HD float padded_entry(const float lo[3], const float hi[3], const Ray& r,
                      float tmax, float* exit_t) {
  float ent = r.tmin, ext = tmax;
  for (int a = 0; a < 3; ++a) {
    const float pad = __fmul_rn(__fsub_rn(hi[a], lo[a]), BOX_PAD);
    const float ta =
        __fmul_rn(__fsub_rn(__fsub_rn(lo[a], pad), r.o[a]), r.rcp[a]);
    const float tb =
        __fmul_rn(__fsub_rn(__fadd_rn(hi[a], pad), r.o[a]), r.rcp[a]);
    ent = fmaxf(ent, fminf(slab_near(ta), slab_near(tb)));
    ext = fminf(ext, fmaxf(slab_far(ta), slab_far(tb)));
  }
  *exit_t = ext;
  return ent;
}

}  // namespace pluecker
