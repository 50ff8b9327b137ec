// Closest hit by brute force over Morton-ordered 256-triangle blocks,
// culled per 256-ray tile, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cse168_raytracer_tpu/ops/
// pallas_intersect.py::_kernel (called from _pallas_hit_impl, behind the
// zero-cotangent custom VJP _pallas_hit; attach_accel's kind="pallas").
// It reads the JAX package's block arrays byte for byte:
//   aabb (NB, 8) f32 [lo(3) hi(3) pad(2)], an empty block's box at 1e30;
//   w6   (NB, 6, 3*256) f32: column k holds triangle k's beta (col k),
//        gamma (256+k) and den (512+k) Pluecker rows against [d, o x d];
//   w4   (NB, 4, 256) f32: the t numerator's rows against [o, 1].
//
// One CTA of 256 threads is the TPU kernel's 256-ray tile (RAY_TILE, the
// same padding: rays past the end have tmax = -1). For each block every
// thread slab-tests its own ray against the block's box with the fixed
// [tmin, tmax] (the TPU kernel does not shrink tmax with the best hit),
// and __syncthreads_or decides whether the CTA tests the block: exactly
// the TPU's tile-level cull, so the same blocks are tested and a ray
// grazing a box gets the same answer. The CTA then stages the block's
// 22 x 256 operand floats (22.5 KB) into shared memory cooperatively, and
// each thread tests its ray against the 256 triangles with pluecker.cuh's
// arithmetic (the t of the tree kernels, bit for bit). Ties follow the
// TPU kernel (pallas_intersect.py:159-178): within a lane the earliest
// block wins, and among lanes with the smallest t the smallest lane, so
// each ray keeps the least (t, lane, block).
//
// What bounds it on this card: the triangle tests of the (tile, block)
// pairs that pass the cull, about 50 f32 operations each, 65,536 per
// pair; the operand bytes are read once per passing pair from L2 and
// then served from shared memory as broadcasts (every thread reads the
// same triangle at the same time). The simple design keeps a thread per
// ray and its running best in registers; a tensor-core numerator product
// or a finer cull are later work. Forward only: the wrapper detaches its
// inputs, as the TPU kernel's VJP returns zero cotangents.

#include "pluecker.cuh"

namespace {

using pluecker::BIG;
using pluecker::Ray;

constexpr int BLOCK = 256;     // triangles per block
constexpr int RAY_TILE = 256;  // rays per CTA

// The block's box test of ray r against [tmin, tmax] (ops/accel.py _slab:
// NaN from 0*inf leaves that axis unconstrained).
HD bool slab(const float* box, const Ray& r) {
  float ent = r.tmin, ext = r.tmax;
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fmul_rn(__fsub_rn(LDG(box + a), r.o[a]), r.rcp[a]);
    const float t1 =
        __fmul_rn(__fsub_rn(LDG(box + 3 + a), r.o[a]), r.rcp[a]);
    ent = fmaxf(ent, fminf(pluecker::slab_near(t0), pluecker::slab_near(t1)));
    ext = fminf(ext, fmaxf(pluecker::slab_far(t0), pluecker::slab_far(t1)));
  }
  return ent <= ext;
}

// The ray's test against the 256 triangles of one block whose operands
// lie at w6 (6 rows of 3*BLOCK) and w4 (4 rows of BLOCK), updating its
// least (t, lane, block).
HD void test_block(const float* w6, const float* w4, const Ray& r, int blk,
                   float* bt, int* bl, int* bb) {
  for (int k = 0; k < BLOCK; ++k) {
    const float tt = pluecker::accept(
        pluecker::sum6_s(w6 + k, 3 * BLOCK, r),
        pluecker::sum6_s(w6 + BLOCK + k, 3 * BLOCK, r),
        pluecker::sum6_s(w6 + 2 * BLOCK + k, 3 * BLOCK, r),
        pluecker::sum4_s(w4 + k, BLOCK, r), r.tmin, r.tmax);
    if (tt < *bt || (tt == *bt && k < *bl)) {
      *bt = tt;
      *bl = k;
      *bb = blk;
    }
  }
}

// A padding ray of the last tile (pallas_intersect.py:205-213).
HD Ray pad_ray() {
  Ray r;
  for (int a = 0; a < 3; ++a) {
    r.o[a] = 0.0f;
    r.d[a] = 1.0f;
    r.m[a] = 0.0f;
    r.rcp[a] = 1.0f;
  }
  r.tmin = 0.0f;
  r.tmax = -1.0f;
  return r;
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(RAY_TILE)
    tri_blocks_kernel(const float* __restrict__ aabb,
                      const float* __restrict__ w6,
                      const float* __restrict__ w4, int nb,
                      const float* __restrict__ o,
                      const float* __restrict__ d,
                      const float* __restrict__ tmin,
                      const float* __restrict__ tmax, int n, float* out_t,
                      int* out_id) {
  __shared__ float s6[6 * 3 * BLOCK];
  __shared__ float s4[4 * BLOCK];
  const int tid = threadIdx.x;
  const long i = (long)blockIdx.x * RAY_TILE + tid;
  const Ray r = i < n ? pluecker::load_ray(o, d, tmin, tmax, i) : pad_ray();
  float bt = BIG;
  int bl = 0, bb = 0;
  for (int b = 0; b < nb; ++b) {
    // every thread reaches this barrier: the CTA skips or tests together
    if (!__syncthreads_or(slab(aabb + (long)b * 8, r))) continue;
    const float* g6 = w6 + (long)b * 6 * 3 * BLOCK;
    const float* g4 = w4 + (long)b * 4 * BLOCK;
    for (int k = tid; k < 6 * 3 * BLOCK; k += RAY_TILE) s6[k] = LDG(g6 + k);
    for (int k = tid; k < 4 * BLOCK; k += RAY_TILE) s4[k] = LDG(g4 + k);
    __syncthreads();
    test_block(s6, s4, r, b, &bt, &bl, &bb);
    __syncthreads();  // the next block's staging overwrites s6 and s4
  }
  if (i < n) {
    out_t[i] = bt;
    out_id[i] = bb * BLOCK + bl;
  }
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Closest hit of n rays (n > 0) against nb blocks: out_t (n,) f32, BIG on
// a miss; out_id (n,) i32 = block*256 + lane, 0 on a miss. Returns
// cudaGetLastError() after the launch.
extern "C" int tri_blocks_closest(const void* aabb, const void* w6,
                                  const void* w4, int nb, const void* o,
                                  const void* d, const void* tmin,
                                  const void* tmax, int n, void* out_t,
                                  void* out_id, void* stream) {
  const int tiles = (n + RAY_TILE - 1) / RAY_TILE;
  tri_blocks_kernel<<<tiles, RAY_TILE, 0, (cudaStream_t)stream>>>(
      (const float*)aabb, (const float*)w6, (const float*)w4, nb,
      (const float*)o, (const float*)d, (const float*)tmin,
      (const float*)tmax, n, (float*)out_t, (int*)out_id);
  return (int)cudaGetLastError();
}

#else  // host build

// The same algorithm on the host, tile after tile, for the CPU tests;
// also returns the number of (tile, block) pairs that passed the cull.
extern "C" long tri_blocks_host(const float* aabb, const float* w6,
                                const float* w4, int nb, const float* o,
                                const float* d, const float* tmin,
                                const float* tmax, int n, float* out_t,
                                int* out_id) {
  long pairs = 0;
  for (long t0 = 0; t0 < n; t0 += RAY_TILE) {
    Ray rays[RAY_TILE];
    float bt[RAY_TILE];
    int bl[RAY_TILE], bb[RAY_TILE];
    for (int j = 0; j < RAY_TILE; ++j) {
      rays[j] = t0 + j < n ? pluecker::load_ray(o, d, tmin, tmax, t0 + j)
                           : pad_ray();
      bt[j] = BIG;
      bl[j] = bb[j] = 0;
    }
    for (int b = 0; b < nb; ++b) {
      bool any = false;
      for (int j = 0; j < RAY_TILE; ++j) any |= slab(aabb + (long)b * 8, rays[j]);
      if (!any) continue;
      ++pairs;
      for (int j = 0; j < RAY_TILE; ++j)
        test_block(w6 + (long)b * 6 * 3 * BLOCK, w4 + (long)b * 4 * BLOCK,
                   rays[j], b, &bt[j], &bl[j], &bb[j]);
    }
    for (int j = 0; j < RAY_TILE && t0 + j < n; ++j) {
      out_t[t0 + j] = bt[j];
      out_id[t0 + j] = bb[j] * BLOCK + bl[j];
    }
  }
  return pairs;
}

#endif
