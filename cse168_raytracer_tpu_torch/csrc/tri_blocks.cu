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
// The answers are the TPU kernel's. Rays come in tiles of 256 (the same
// padding: rays past the end have tmax = -1). A tile tests a block when
// any ray of the tile passes the block's box with its fixed [tmin, tmax]
// (the TPU kernel does not shrink tmax with the best hit), so a ray
// grazing a box gets the same answer whatever its neighbours. Each ray
// keeps the least (t, lane, block) of the tested triangles
// (pallas_intersect.py:159-178: within a lane the earliest block, among
// lanes with the smallest t the smallest lane), with pluecker.cuh's
// arithmetic, so t is the tree kernels' bit for bit.
//
// What bounds it on this card: the triangle tests of the (tile, block)
// pairs that pass the cull, 65,536 per pair, ~53 f32 operations each
// and one IEEE division, issued one warp instruction a clock per
// scheduler; the operands are read once per pair from L2. The first
// design (one 256-thread CTA a tile, one thread a ray) spent 18.7% of a
// tile's cycles in a cull of one dependent box load and one barrier per
// block (625 a tile on sponza_proxy, 30 of which pass), staged each
// block synchronously, fed each test with 22 scalar shared-memory loads,
// and left the kernel's time to its slowest tile (108 passing blocks
// against a mean of 30) (profile_walk.py's K6_PROBE split, PERF.md).
// This design answers each cause, in three launches:
//  1. tri_blocks_cull, the cull in one pass: a CTA of 128 threads (two
//     rays a thread: rays x and x + 128 of the tile) tests every block's
//     box, staged through shared memory in chunks with 16-byte loads;
//     each warp ballots its rays' slab results and ORs a word of 32
//     blocks into a shared mask, one atomicOr a warp a word, and the
//     tile's bitmask goes to device memory;
//  2. tri_blocks_test, SPLIT CTAs a tile, each taking every SPLIT-th
//     passing block in ascending order, so a tile that passes many
//     blocks is shared. The next block's 22 x 256 operand floats
//     (22,528 bytes) are copied into the second of two shared buffers
//     with cp.async while the current block is tested. A thread loads
//     four adjacent triangles' 22 operand rows with one 16-byte shared
//     load each (a broadcast: the warp reads the same address) and
//     tests them against both its rays, 22 loads for 8 tests instead of
//     22 for one. Where no lane of the warp can accept a ray's four
//     triangles by the signs of their numerators (surely_out, exact),
//     their t numerators and divisions are skipped. Each ray's triangles
//     are taken in ascending lane order, block after block, so a
//     thread's best is the least (t, lane, block) of its CTA's share;
//     the CTAs of a tile merge theirs by atomicMin on a 64-bit key that
//     orders as the triple does;
//  3. tri_blocks_finish decodes each ray's key into its t and id.
// The test is pluecker::accept of dot6, dot6, dot6 and dot4 in their
// fixed order (pluecker::tri_t's): round-to-nearest intrinsics, no fused
// multiply-add, no tensor cores. With no fusing, the f32 pipe issues one
// multiply or add per lane and clock, half the rate that a 67 TFLOP/s
// bound counting a fused multiply-add as two assumes.
// Forward only: the wrapper detaches its inputs, as the TPU kernel's VJP
// returns zero cotangents.

#include "pluecker.cuh"

#ifdef __CUDACC__
#include <cuda_pipeline_primitives.h>
#endif

namespace {

using pluecker::BIG;
using pluecker::Ray;

constexpr int BLOCK = 256;     // triangles per block
constexpr int RAY_TILE = 256;  // rays per tile
constexpr int THREADS = 128;   // two rays a thread
constexpr int OPS = 6 * 3 * BLOCK + 4 * BLOCK;  // operand floats a block
constexpr int CULL_CHUNK = 256;  // boxes the cull stages at once
constexpr int SPLIT = 4;         // test CTAs a tile
// dynamic shared memory: the cull's boxes and mask words; the tests' two
// operand buffers
constexpr int CULL_SMEM = CULL_CHUNK * 32 + CULL_CHUNK / 8;
constexpr int TEST_SMEM = 2 * OPS * 4;

// The block's box test of ray r against [tmin, tmax] (ops/accel.py _slab:
// NaN from 0*inf leaves that axis unconstrained).
HD bool slab(const float* box, const Ray& r) {
  float ent = r.tmin, ext = r.tmax;
  for (int a = 0; a < 3; ++a) {
    const float t0 = __fmul_rn(__fsub_rn(box[a], r.o[a]), r.rcp[a]);
    const float t1 = __fmul_rn(__fsub_rn(box[3 + a], r.o[a]), r.rcp[a]);
    ent = fmaxf(ent, fminf(pluecker::slab_near(t0), pluecker::slab_near(t1)));
    ext = fminf(ext, fmaxf(pluecker::slab_far(t0), pluecker::slab_far(t1)));
  }
  return ent <= ext;
}

// The least (t, lane, block) so far: a triangle with equal t replaces
// the best only from a smaller lane, so with lanes taken in ascending
// order within a block and blocks in ascending order, the earliest
// block wins within a lane.
HD void keep(float tt, int k, int blk, float* bt, int* bl, int* bb) {
  if (tt < *bt || (tt == *bt && k < *bl)) {
    *bt = tt;
    *bl = k;
    *bb = blk;
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

#ifdef K6_PROBE
// Built only with -DK6_PROBE (profile_walk.py): thread 0 of each CTA
// sums its clock cycles in the cull (the cull kernel), in waiting for
// staged operands and in the tests (the test kernel); then the tiles,
// the (tile, block) pairs that passed and the test kernel's CTAs.
__device__ unsigned long long k6_probe[6];
#define PROBE(...) __VA_ARGS__
#else
#define PROBE(...)
#endif

// The index of the first set bit of mask at or after b, or nb.
__device__ __forceinline__ int next_block(const unsigned* mask, int b,
                                          int nb) {
  for (int w = b >> 5; w << 5 < nb; ++w) {
    const unsigned bits = mask[w] & (w == b >> 5 ? ~0u << (b & 31) : ~0u);
    if (bits) return (w << 5) + __ffs(bits) - 1;
  }
  return nb;
}

// Copy block b's operands into buf with 16-byte asynchronous copies, the
// CTA's threads taking every THREADS-th piece.
__device__ __forceinline__ void stage(float* buf, const float* w6,
                                      const float* w4, int b) {
  const float4* g6 = (const float4*)(w6 + (long)b * 6 * 3 * BLOCK);
  const float4* g4 = (const float4*)(w4 + (long)b * 4 * BLOCK);
  float4* s = (float4*)buf;
  for (int k = threadIdx.x; k < OPS / 4; k += THREADS)
    __pipeline_memcpy_async(s + k, k < 6 * 3 * BLOCK / 4
                                       ? g6 + k
                                       : g4 + (k - 6 * 3 * BLOCK / 4),
                            16);
}

// Triangles 4g..4g+3 of a staged block, their operand rows read with
// one 16-byte load each.
__device__ __forceinline__ void load_quad(const float* buf, int g,
                                          pluecker::TriOps op[4]) {
  const float* w6 = buf + 4 * g;
  const float* w4 = buf + 6 * 3 * BLOCK + 4 * g;
  for (int a = 0; a < 6; ++a) {
    const float4 vb = *(const float4*)(w6 + a * 3 * BLOCK);
    const float4 vg = *(const float4*)(w6 + a * 3 * BLOCK + BLOCK);
    const float4 vd = *(const float4*)(w6 + a * 3 * BLOCK + 2 * BLOCK);
    const float b[4] = {vb.x, vb.y, vb.z, vb.w};
    const float gg[4] = {vg.x, vg.y, vg.z, vg.w};
    const float dn[4] = {vd.x, vd.y, vd.z, vd.w};
    for (int j = 0; j < 4; ++j) {
      op[j].b[a] = b[j];
      op[j].g[a] = gg[j];
      op[j].den[a] = dn[j];
    }
  }
  for (int a = 0; a < 4; ++a) {
    const float4 vt = *(const float4*)(w4 + a * BLOCK);
    const float tn[4] = {vt.x, vt.y, vt.z, vt.w};
    for (int j = 0; j < 4; ++j) op[j].tn[a] = tn[j];
  }
}

// The least (t, lane, block) of a ray as one 64-bit key that orders as
// the triple does: t as an order-keeping 32-bit pattern (+0 and -0 the
// same, as keep's compare holds them), then the lane (8 bits), the block
// (23 bits) and, last, whether t is -0, so that decoding gives back the
// winner's t bit for bit. The split test kernel merges its CTAs' bests
// with atomicMin on these keys.
__device__ __forceinline__ unsigned long long pack_key(float t, int lane,
                                                       int blk) {
  const unsigned u = __float_as_uint(t), mag = u & 0x7fffffffu;
  const unsigned ord = mag == 0 ? 0x80000000u
                       : u >> 31 ? ~u
                                 : u | 0x80000000u;
  return (unsigned long long)ord << 32 | (unsigned)lane << 24 |
         (unsigned)blk << 1 | (mag == 0 && u >> 31);
}

__device__ __forceinline__ float key_t(unsigned long long key) {
  if (key & 1) return -0.0f;
  const unsigned ord = (unsigned)(key >> 32);
  return __uint_as_float(ord >> 31 ? ord & 0x7fffffffu : ~ord);
}

// The tile's two rays of this thread (rays x and x + 128 of the tile).
__device__ __forceinline__ void tile_rays(const float* o, const float* d,
                                          const float* tmin,
                                          const float* tmax, int n, int tile,
                                          Ray r[2], long i[2]) {
  for (int q = 0; q < 2; ++q) {
    i[q] = (long)tile * RAY_TILE + q * THREADS + threadIdx.x;
    r[q] = i[q] < n ? pluecker::load_ray(o, d, tmin, tmax, i[q]) : pad_ray();
  }
}

// Whether accept(b, g, den, ...) surely returns BIG whatever the t
// numerator and the bounds, so that its division may be skipped: den
// tiny (or NaN: accept's beta is then NaN), or beta or gamma surely
// below NEG_EPS. For x (b or g) finite and of the sign opposite to den
// with |x| >= 2^-12 |den| (den is not tiny, so 2^-12 |den| is a normal
// float and exact), x/den <= -2^-12; accept's beta = RN(x * RN(1/den))
// is then <= -2^-12 (1 - 2^-24)^2 < -2.4e-4 < NEG_EPS, or -inf, so
// beta >= NEG_EPS fails and accept returns BIG. An infinite x gives
// beta = -inf against a finite den and NaN against an infinite one, and
// accept rejects both; a NaN x never passes. So the test rejects no
// triangle that accept would take.
__device__ __forceinline__ bool surely_out(float b, float g, float den) {
  const float lim = 0x1p-12f * fabsf(den);
  const unsigned sd = __float_as_uint(den);
  const bool nb = (__float_as_uint(b) ^ sd) >> 31;
  const bool ng = (__float_as_uint(g) ^ sd) >> 31;
  // bitwise, not short-circuit: no branch
  return !(fabsf(den) >= pluecker::DEN_TINY) | (nb & (fabsf(b) >= lim)) |
         (ng & (fabsf(g) >= lim));
}

// 1. The cull: one CTA a tile tests every block's box against the tile's
// rays, staged through shared memory CULL_CHUNK boxes at a time with
// 16-byte loads; each warp ballots its rays' slab results and ORs a word
// of 32 blocks into the chunk's shared mask, one atomicOr a warp a word;
// the tile's mask goes to masks[tile * words ...], and its count of
// passing blocks to out_pairs when not null. It also sets each of the
// tile's rays' keys to a miss.
__global__ void __launch_bounds__(THREADS)
    tri_blocks_cull(const float* __restrict__ aabb, int nb,
                    const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n,
                    unsigned* __restrict__ masks,
                    unsigned long long* __restrict__ keys, int* out_pairs) {
  extern __shared__ float4 smem[];  // CULL_SMEM bytes
  float4* sbox = smem;
  unsigned* smask = (unsigned*)(smem + 2 * CULL_CHUNK);
  const int tid = threadIdx.x, lane = tid & 31, words = (nb + 31) >> 5;
  Ray r[2];
  long i[2];
  tile_rays(o, d, tmin, tmax, n, blockIdx.x, r, i);
  for (int q = 0; q < 2; ++q)
    if (i[q] < n) keys[i[q]] = pack_key(BIG, 0, 0);
  unsigned* mask = masks + (long)blockIdx.x * words;
  PROBE(const long long c0 = clock64();)
  int passed = 0;
  for (int c = 0; c < nb; c += CULL_CHUNK) {
    const int cnt = min(CULL_CHUNK, nb - c);
    __syncthreads();  // the last chunk's boxes and mask are read
    for (int k = tid; k < 2 * cnt; k += THREADS)
      sbox[k] = __ldg((const float4*)(aabb + (long)c * 8) + k);
    if (tid < CULL_CHUNK / 32) smask[tid] = 0;
    __syncthreads();
    for (int j = 0; j < cnt; j += 32) {
      unsigned word = 0;
      for (int q = 0; q < 32 && j + q < cnt; ++q) {
        const float4 lo = sbox[2 * (j + q)], hi = sbox[2 * (j + q) + 1];
        const float box[6] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y};
        const bool hit = slab(box, r[0]) | slab(box, r[1]);
        if (__ballot_sync(pluecker::FULL_WARP, hit)) word |= 1u << q;
      }
      if (lane == 0 && word) atomicOr(smask + (j >> 5), word);
    }
    __syncthreads();
    if (tid < (cnt + 31) >> 5) {
      mask[(c >> 5) + tid] = smask[tid];
      passed += __popc(smask[tid]);
    }
  }
  if (out_pairs) {
    // thread t < CULL_CHUNK / 32 summed its words of every chunk
    if (tid == 0) out_pairs[blockIdx.x] = 0;
    __syncthreads();
    if (passed) atomicAdd(out_pairs + blockIdx.x, passed);
  }
  PROBE(if (tid == 0) {
    atomicAdd(k6_probe + 0, (unsigned long long)(clock64() - c0));
    atomicAdd(k6_probe + 3, 1ull);
  }
  if (passed) atomicAdd(k6_probe + 4, (unsigned long long)passed);)
}

// The block of rank `rank` among the mask's set bits at or after b.
__device__ __forceinline__ int skip_blocks(const unsigned* mask, int b,
                                           int nb, int rank) {
  b = next_block(mask, b, nb);
  for (int k = 0; k < rank && b < nb; ++k) b = next_block(mask, b + 1, nb);
  return b;
}

// 2. The tests: CTA x takes tile x / SPLIT and, of the tile's passing
// blocks in ascending order, those whose rank is x % SPLIT modulo SPLIT.
// The next block's operands are staged (cp.async) into one of two shared
// buffers while the current one is tested; each thread tests four
// triangles against its two rays from registers (see the head of this
// file). Each ray's best over the CTA's blocks is merged into keys by
// atomicMin.
__global__ void __launch_bounds__(THREADS)
    tri_blocks_test(const float* __restrict__ w6,
                    const float* __restrict__ w4, int nb,
                    const float* __restrict__ o,
                    const float* __restrict__ d,
                    const float* __restrict__ tmin,
                    const float* __restrict__ tmax, int n,
                    const unsigned* __restrict__ masks,
                    unsigned long long* __restrict__ keys) {
  extern __shared__ float4 smem[];  // TEST_SMEM bytes
  float* buf = (float*)smem;
  const int tile = blockIdx.x / SPLIT, part = blockIdx.x % SPLIT;
  const unsigned* mask = masks + (long)tile * ((nb + 31) >> 5);
  int b = skip_blocks(mask, 0, nb, part), slot = 0;
  if (b >= nb) return;  // the CTA's share is empty: all its threads leave
  Ray r[2];
  long i[2];
  tile_rays(o, d, tmin, tmax, n, tile, r, i);
  PROBE(long long c1 = clock64(), stage_c = 0, test_c = 0;)
  float bt[2] = {BIG, BIG};
  int bl[2] = {0, 0}, bb[2] = {0, 0};
  stage(buf, w6, w4, b);
  __pipeline_commit();
  while (b < nb) {
    const int nxt = skip_blocks(mask, b + 1, nb, SPLIT - 1);
    if (nxt < nb) stage(buf + (slot ^ 1) * OPS, w6, w4, nxt);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // this thread's copies of block b landed
    __syncthreads();           // and every other thread's
    PROBE(const long long c2 = clock64(); stage_c += c2 - c1;)
    const float* cur = buf + slot * OPS;
#pragma unroll 1
    for (int g = 0; g < BLOCK / 4; ++g) {
      pluecker::TriOps op[4];
      load_quad(cur, g, op);
      // the three dot6 of the eight tests, and which of them accept may
      // take: where no lane of the warp needs a ray's four, the t
      // numerators and divisions of all four are skipped
      float vb[2][4], vg[2][4], vd[2][4];
      bool need[2] = {false, false};
      for (int q = 0; q < 2; ++q)
        for (int j = 0; j < 4; ++j) {
          vb[q][j] = pluecker::dot6(op[j].b, r[q]);
          vg[q][j] = pluecker::dot6(op[j].g, r[q]);
          vd[q][j] = pluecker::dot6(op[j].den, r[q]);
          need[q] |= !surely_out(vb[q][j], vg[q][j], vd[q][j]);
        }
      for (int q = 0; q < 2; ++q) {
        if (!__any_sync(pluecker::FULL_WARP, need[q])) continue;
        // the least (t, lane) of the four, then one keep: the same best
        // as four keeps in lane order, since keep takes the least
        // (t, lane) and on an equal pair the earlier block
        float m = BIG;
        int mj = 0;
        for (int j = 0; j < 4; ++j) {
          const float tt = pluecker::accept(vb[q][j], vg[q][j], vd[q][j],
                                            pluecker::dot4(op[j].tn, r[q]),
                                            r[q].tmin, r[q].tmax);
          if (tt < m) {
            m = tt;
            mj = j;
          }
        }
        keep(m, 4 * g + mj, b, &bt[q], &bl[q], &bb[q]);
      }
    }
    __syncthreads();  // the next iteration's staging overwrites cur
    PROBE(c1 = clock64(); test_c += c1 - c2;)
    b = nxt;
    slot ^= 1;
  }
  for (int q = 0; q < 2; ++q)
    if (i[q] < n && bt[q] < BIG)
      atomicMin(keys + i[q], pack_key(bt[q], bl[q], bb[q]));
  PROBE(if (threadIdx.x == 0) {
    atomicAdd(k6_probe + 1, (unsigned long long)stage_c);
    atomicAdd(k6_probe + 2, (unsigned long long)test_c);
    atomicAdd(k6_probe + 5, 1ull);
  })
}

// 3. Each ray's key decoded into its t and id = block*256 + lane.
__global__ void tri_blocks_finish(const unsigned long long* __restrict__ keys,
                                  int n, float* out_t, int* out_id) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned long long key = keys[i];
  out_t[i] = key_t(key);
  out_id[i] = (int)((key >> 1) & 0x7fffff) * BLOCK + (int)((key >> 24) & 0xff);
}

#else  // host build

// The ray's test against the 256 triangles of one block whose operands
// lie at w6 (6 rows of 3*BLOCK) and w4 (4 rows of BLOCK), one triangle
// at a time.
void test_block(const float* w6, const float* w4, const Ray& r, int blk,
                float* bt, int* bl, int* bb) {
  for (int k = 0; k < BLOCK; ++k) {
    const float tt = pluecker::accept(
        pluecker::sum6_s(w6 + k, 3 * BLOCK, r),
        pluecker::sum6_s(w6 + BLOCK + k, 3 * BLOCK, r),
        pluecker::sum6_s(w6 + 2 * BLOCK + k, 3 * BLOCK, r),
        pluecker::sum4_s(w4 + k, BLOCK, r), r.tmin, r.tmax);
    keep(tt, k, blk, bt, bl, bb);
  }
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// Closest hit of n rays (n > 0) against nb blocks, by three launches
// (the cull, the tests, the decoding): out_t (n,) f32, BIG on a miss;
// out_id (n,) i32 = block*256 + lane, 0 on a miss; out_pairs, if not
// null, (tiles,) i32: the blocks each 256-ray tile tested. Scratch:
// masks, (tiles * ceil(nb / 32),) u32, and keys, (n,) u64. The block
// arrays are 16-byte aligned. Returns cudaGetLastError() after the
// launches.
extern "C" int tri_blocks_closest(const void* aabb, const void* w6,
                                  const void* w4, int nb, const void* o,
                                  const void* d, const void* tmin,
                                  const void* tmax, int n, void* masks,
                                  void* keys, void* out_t, void* out_id,
                                  void* out_pairs, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int tiles = (n + RAY_TILE - 1) / RAY_TILE;
  tri_blocks_cull<<<tiles, THREADS, CULL_SMEM, st>>>(
      (const float*)aabb, nb, (const float*)o, (const float*)d,
      (const float*)tmin, (const float*)tmax, n, (unsigned*)masks,
      (unsigned long long*)keys, (int*)out_pairs);
  tri_blocks_test<<<tiles * SPLIT, THREADS, TEST_SMEM, st>>>(
      (const float*)w6, (const float*)w4, nb, (const float*)o,
      (const float*)d, (const float*)tmin, (const float*)tmax, n,
      (const unsigned*)masks, (unsigned long long*)keys);
  tri_blocks_finish<<<(n + 255) / 256, 256, 0, st>>>(
      (const unsigned long long*)keys, n, (float*)out_t, (int*)out_id);
  return (int)cudaGetLastError();
}

#ifdef K6_PROBE
// Copy the probe's six sums to `out` (host memory) and zero them.
extern "C" int tri_blocks_probe(void* out) {
  cudaError_t rc = cudaMemcpyFromSymbol(out, k6_probe, sizeof(k6_probe));
  if (rc != cudaSuccess) return (int)rc;
  const unsigned long long zeros[6] = {};
  return (int)cudaMemcpyToSymbol(k6_probe, zeros, sizeof(zeros));
}
#endif

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
