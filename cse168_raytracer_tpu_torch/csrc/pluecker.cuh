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
// versions.

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

// One numerator of beta, gamma or den: six operand rows `stride` floats
// apart, against [d, m], summed left to right.
HD float sum6(const float* w, long stride, const Ray& r) {
  float acc = __fmul_rn(LDG(w), r.d[0]);
  acc = __fadd_rn(acc, __fmul_rn(LDG(w + stride), r.d[1]));
  acc = __fadd_rn(acc, __fmul_rn(LDG(w + 2 * stride), r.d[2]));
  acc = __fadd_rn(acc, __fmul_rn(LDG(w + 3 * stride), r.m[0]));
  acc = __fadd_rn(acc, __fmul_rn(LDG(w + 4 * stride), r.m[1]));
  return __fadd_rn(acc, __fmul_rn(LDG(w + 5 * stride), r.m[2]));
}

// The t numerator: four operand rows against [o, 1].
HD float sum4(const float* w, long stride, const Ray& r) {
  float acc = __fmul_rn(LDG(w), r.o[0]);
  acc = __fadd_rn(acc, __fmul_rn(LDG(w + stride), r.o[1]));
  acc = __fadd_rn(acc, __fmul_rn(LDG(w + 2 * stride), r.o[2]));
  return __fadd_rn(acc, LDG(w + 3 * stride));
}

// The same two sums from shared memory (no read-only cache load there).
HD float sum6_s(const float* w, int stride, const Ray& r) {
  float acc = __fmul_rn(w[0], r.d[0]);
  acc = __fadd_rn(acc, __fmul_rn(w[stride], r.d[1]));
  acc = __fadd_rn(acc, __fmul_rn(w[2 * stride], r.d[2]));
  acc = __fadd_rn(acc, __fmul_rn(w[3 * stride], r.m[0]));
  acc = __fadd_rn(acc, __fmul_rn(w[4 * stride], r.m[1]));
  return __fadd_rn(acc, __fmul_rn(w[5 * stride], r.m[2]));
}

HD float sum4_s(const float* w, int stride, const Ray& r) {
  float acc = __fmul_rn(w[0], r.o[0]);
  acc = __fadd_rn(acc, __fmul_rn(w[stride], r.o[1]));
  acc = __fadd_rn(acc, __fmul_rn(w[2 * stride], r.o[2]));
  return __fadd_rn(acc, w[3 * stride]);
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
