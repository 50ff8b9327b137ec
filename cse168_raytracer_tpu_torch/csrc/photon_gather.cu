// The photon gather of ops/photon.py grid_irradiance on the card: both
// levels of a map, every point, in one launch, for Hopper (sm_90a).
//
// A kernel of the port alone: no Pallas kernel of the JAX package does
// this. The JAX gather is plain jnp that XLA compiles
// (cse168_raytracer_tpu/ops/photon.py:241 _gather_level). The port's
// plain version is its twin in PyTorch (ops/photon.py _candidates,
// _in_range, _gather_level, gather_levels), which the CPU runs; this file
// gives the twin's bits. For each point and level:
//   - the point's cell floor(p / r), saturating at the int32 range (the
//     card's conversion: NaN gives 0, which changes nothing, since a NaN
//     point is within no radius); its 27 neighbour cells hashed (uint32
//     products wrapping, xor, % table_size); the 27 hashes in ascending
//     order, one slot each, a hash met again keeping no photon (the
//     twin's sort and de-duplication); each distinct bucket's first
//     photon by binary search in the sorted cell_hash, and its count,
//     at most max_per_cell (K);
//   - the candidates: position m = slot * K + k of a (27 K) axis, the
//     bucket's k-th photon where k < count and it is below n_valid;
//     d2 = (dx dx + dy dy) + dz dz; within the radius where d2 < r^2;
//   - the weighted count within r, then 12 bisection steps of r'^2 in
//     [0, r^2]: each the weighted count of the candidates with d2 < mid,
//     mid = 0.5 (lo + hi), against k nearest (knn);
//   - the accepted candidates (within r, d2 < r'^2, the photon's
//     direction against the normal n: (dir_x n_x + dir_y n_y) + dir_z n_z
//     < 0) and their power summed, over pi r'^2.
// The coarse level is gathered only where the fine level weighs under
// knn within r, since its estimate is used nowhere else: use_c = the
// fine count < knn and the coarse count >= knn. Its r'^2 (read by the
// backward only where use_c) is written where it was gathered and is 0
// elsewhere, where the twin computes it and the backward never reads it.
//
// Every sum over a point's candidates is vecmath.sum_fixed's order: the
// (27 K) axis padded with -0.0 to a power of two P and halved. A warp
// takes a point; lane l holds positions l + 32 j (j < J) in registers,
// halves its own J values (t[j] += t[j + h], h = J/2, ..., 1: the
// twin's halvings down to 32 positions), and the lanes fold by
// __shfl_down_sync at offsets 16, ..., 1 (its last five). So the sums
// are the twin's additions in the twin's order, bit for bit, and the
// answer does not depend on the device. J is 32 (K up to 37) or 64 (K
// up to 75); where 32 J exceeds P the halvings above P add -0.0 to each
// value, which leaves every value as it is (x + -0.0 = x, +0.0 and
// -0.0 included), so a sum over 32 J positions is the sum over P.
// Every operation rounds to nearest and none is fused (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn): the port's rule for matching the
// CPU.
//
// What bounds it on this card: bytes, at best. A point needs each photon
// within its radius once (position, direction, power, weight: 40 bytes)
// and nothing of a level it does not use; the operations (a distance,
// 12 compares and adds a candidate) are a handful a byte. A level's
// photons (~8 MB for 200,000) fit in the 50 MB L2, so device memory need
// deliver each of them once for all points, and the per-point reads run
// at L2's rate: the least device-memory time is microseconds, and what
// the kernel spends is latency (see below). The twin
// writes and rereads several (N, P) arrays a level and launches ~300
// kernels a chunk. This kernel keeps d2, the weights and the 12
// bisection steps in registers (the halvings unrolled at compile time,
// so no array falls to local memory) and reads the candidates from L1
// and L2: with K = 32 lane l reads photon start + l of each bucket, so
// a warp's loads are runs of neighbouring photons, and neighbouring
// points (neighbouring warps) share buckets. Each pass issues all its
// loads before it uses one (a position with no photon, or one the pass
// does not need, reads row 0, one line that L1 holds, and drops it), so
// a warp waits on one latency a pass, not one a candidate, and reads
// direction and power only of candidates within r'^2 and accepted. What is left is latency: the 27 binary searches a level
// and the passes, hidden by the warps an SM holds. One block holds
// WARPS points, each warp's slot table (start and count of its 27
// slots, both levels) in shared memory.

#include <cuda_runtime.h>

// A level as the C interface takes it (ops/photon_gather.py's _Level).
struct LevelArgs {
  const void* pos;
  const void* dir;
  const void* power;
  const void* weight;
  const void* cell_hash;
  const void* radius;
  long long rows, n_valid, table_size, max_per_cell;
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;              // points a block, a warp each
constexpr int PROBES = 27;            // neighbour cells of a point
constexpr int STEPS = 12;             // bisection steps of r'^2
constexpr int TABLE = 4 * 32;         // ints of a warp's slot table
// the largest K: 27 K padded to at most 2,048 positions, 64 a lane
constexpr int MAX_PER_CELL = 2048 / PROBES;
constexpr unsigned H1 = 73856093u, H2 = 19349663u, H3 = 83492791u;

// One level of a map on the card (a PhotonGrid's tensors).
struct Level {
  const float* pos;       // (rows, 3), sorted by cell hash
  const float* dir;       // (rows, 3)
  const float* power;     // (rows, 3)
  const float* weight;    // (rows,)
  const int* cell_hash;   // (rows,), ascending
  const float* radius;    // (), the level's radius
  int rows, n_valid, max_per_cell;
  unsigned table_size;
};

// floor(x / r) as an int32 cell, as ops/photon.py's floor_i32 gives it
// on the card: saturating; NaN converts to 0.
__device__ __forceinline__ int floor_cell(float x, float r) {
  const float f = floorf(__fdiv_rn(x, r));
  if (f != f) return 0;
  if (f >= 2147483648.0f) return 2147483647;
  if (f <= -2147483648.0f) return -2147483647 - 1;
  return (int)f;
}

// Lane 0's sum of v over the lanes, by offsets 16, ..., 1, broadcast.
__device__ __forceinline__ float fold_lanes(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(FULL, v, off));
  return __shfl_sync(FULL, v, 0);
}

// The lane's halvings t[j] += t[j + H] for j < H, then H / 2, ..., 1,
// unrolled at compile time, so t stays in registers.
template <int H, int J>
__device__ __forceinline__ void halve(float (&t)[J]) {
  if constexpr (H > 0) {
#pragma unroll
    for (int j = 0; j < H; ++j) t[j] = __fadd_rn(t[j], t[j + H]);
    halve<H / 2>(t);
  }
}

// sum_fixed over the warp's 32 J positions, lane l's t[j] position
// l + 32 j. Overwrites t.
template <int J>
__device__ __forceinline__ float sum_fixed(float (&t)[J]) {
  halve<J / 2>(t);
  return fold_lanes(t[0]);
}

// A lane's walk over its candidate positions m = lane + 32 j of the
// (27 K) axis: slot b and photon k of it, advanced without dividing.
struct Walk {
  int b, k;
  __device__ __forceinline__ Walk(int lane, int k_per)
      : b(lane / k_per), k(lane - lane / k_per * k_per) {}
  __device__ __forceinline__ void next(int k_per) {
    k += 32;
    while (k >= k_per) {
      k -= k_per;
      ++b;
    }
  }
  __device__ __forceinline__ bool padding() const { return b >= PROBES; }
  // the photon row at the position, or -1: the slot table holds each
  // slot's first row (start) and count
  __device__ __forceinline__ int row(const int* start, const int* count,
                                     int n_valid) const {
    if (b >= PROBES || k >= count[b]) return -1;
    const int idx = start[b] + k;
    return idx < n_valid ? idx : -1;
  }
};

// What a level with no rows reads in their place (never used).
__device__ const float kNothing[3] = {0.0f, 0.0f, 0.0f};

// The point's 27 slots of level g into start / count (the warp's table):
// lane l < 27 hashes neighbour cell l, ranks its hash among the 27, and,
// if no lower lane holds the same hash, searches its bucket.
__device__ __forceinline__ void find_slots(const Level& g,
                                           const float (&p)[3], float r,
                                           int lane, int* start, int* count) {
  unsigned h = 0;
  if (lane < PROBES) {
    count[lane] = 0;
    // the cell plus an offset in -1..1, wrapping as uint32
    const unsigned cx =
        (unsigned)floor_cell(p[0], r) + (unsigned)(lane / 9 - 1);
    const unsigned cy =
        (unsigned)floor_cell(p[1], r) + (unsigned)((lane / 3) % 3 - 1);
    const unsigned cz =
        (unsigned)floor_cell(p[2], r) + (unsigned)(lane % 3 - 1);
    h = ((cx * H1) ^ (cy * H2) ^ (cz * H3)) % g.table_size;
  }
  int slot = 0;
  bool again = false;
#pragma unroll
  for (int j = 0; j < PROBES; ++j) {
    const unsigned hj = __shfl_sync(FULL, h, j);
    slot += hj < h;
    again |= hj == h && j < lane;
  }
  __syncwarp();
  if (lane < PROBES && !again) {
    const int key = (int)h;
    int lo = 0, len = g.rows;        // the first row with hash >= key
    while (len > 0) {
      const int half = len >> 1;
      if (__ldg(g.cell_hash + lo + half) < key) {
        lo += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    int end = lo;                    // the first row past the bucket,
    len = min(g.max_per_cell, g.rows - lo);   // at most K rows on
    while (len > 0) {
      const int half = len >> 1;
      if (__ldg(g.cell_hash + end + half) <= key) {
        end += half + 1;
        len -= half + 1;
      } else {
        len = half;
      }
    }
    start[slot] = lo;
    count[slot] = end - lo;
  }
  __syncwarp();
}

// One level's gather up to r'^2: the slots, the candidates' d2 and
// weights, the weighted count within r (cnt), r'^2 (hi) and the bits j
// of the candidates the point accepts (acc). A padding position holds
// d2 = -inf and weight -0.0 (so every sum sees the twin's -0.0 there), a
// position with no photon +inf and +0.0, a photon beyond r its d2 and
// +0.0. The loads of a pass do not wait on one another: a position with
// no photon reads row 0 (or kNothing) and drops it.
template <int J>
__device__ __forceinline__ void gather_level(const Level& g,
                                             const float (&p)[3],
                                             const float (&n)[3], float knn,
                                             int lane, int* start, int* count,
                                             float& cnt, float& hi,
                                             unsigned long long& acc) {
  const float r = __ldg(g.radius);
  const float r2 = __fmul_rn(r, r);
  find_slots(g, p, r, lane, start, count);
  const int k_per = g.max_per_cell;
  const float* pos = g.rows > 0 ? g.pos : kNothing;
  const float* wgt = g.rows > 0 ? g.weight : kNothing;
  const float* dir = g.rows > 0 ? g.dir : kNothing;
  float d2[J], w[J], t[J];
  Walk at(lane, k_per);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int idx = at.row(start, count, g.n_valid);
    const long long row = idx >= 0 ? idx : 0;
    const float dx = __fsub_rn(__ldg(pos + 3 * row), p[0]);
    const float dy = __fsub_rn(__ldg(pos + 3 * row + 1), p[1]);
    const float dz = __fsub_rn(__ldg(pos + 3 * row + 2), p[2]);
    const float wt = __ldg(wgt + row);
    const float dd = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                               __fmul_rn(dz, dz));
    d2[j] = at.padding() ? -INFINITY : idx < 0 ? INFINITY : dd;
    w[j] = at.padding() ? -0.0f : idx >= 0 && dd < r2 ? wt : 0.0f;
    t[j] = w[j];
    at.next(k_per);
  }
  cnt = sum_fixed(t);
  float lo = 0.0f;
  hi = r2;
#pragma unroll 1
  for (int s = 0; s < STEPS; ++s) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
#pragma unroll
    for (int j = 0; j < J; ++j) t[j] = d2[j] < mid ? w[j] : 0.0f;
    const bool ge = sum_fixed(t) >= knn;
    hi = ge ? mid : hi;
    lo = ge ? lo : mid;
  }
  // accepted: a photon (d2 >= 0 excludes padding, NaN fails both tests)
  // within r'^2 (<= r^2) whose direction is against the normal
  acc = 0;
  Walk again(lane, k_per);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool near = d2[j] >= 0.0f && d2[j] < hi;
    const long long row = near ? again.row(start, count, g.n_valid) : 0;
    const float dot = __fadd_rn(
        __fadd_rn(__fmul_rn(__ldg(dir + 3 * row), n[0]),
                  __fmul_rn(__ldg(dir + 3 * row + 1), n[1])),
        __fmul_rn(__ldg(dir + 3 * row + 2), n[2]));
    if (near && dot < 0.0f) acc |= 1ull << j;
    again.next(k_per);
  }
}

// The accepted candidates' power summed, over pi r'^2.
template <int J>
__device__ __forceinline__ void estimate(const Level& g, int lane,
                                         const int* start, const int* count,
                                         unsigned long long acc, float hi,
                                         float pi, float (&e)[3]) {
  const int k_per = g.max_per_cell;
  const float* pw = g.rows > 0 ? g.power : kNothing;
  float t[3][J];
  Walk at(lane, k_per);
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const bool take = (acc >> j) & 1;
    const long long row = take ? at.row(start, count, g.n_valid) : 0;
    const float none = at.padding() ? -0.0f : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float v = __ldg(pw + 3 * row + c);
      t[c][j] = take ? v : none;
    }
    at.next(k_per);
  }
  const float area = __fmul_rn(pi, hi);
#pragma unroll
  for (int c = 0; c < 3; ++c) e[c] = __fdiv_rn(sum_fixed(t[c]), area);
}

// A warp a point: the fine level, the coarse level where the fine one
// weighs under knn within r, the estimate of the level used.
template <int J>
__global__ void __launch_bounds__(32 * WARPS)
photon_gather(Level fine, Level coarse, int has_coarse, const float* pts,
              const float* nrm, long long n_points, float knn, float pi,
              float* irr, float* r2_out, float* r2c_out,
              unsigned char* use_c_out) {
  extern __shared__ int tables[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long i = (long long)blockIdx.x * WARPS + warp;
  if (i >= n_points) return;
  int* tab = tables + warp * TABLE;
  float p[3], n[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    p[a] = __ldg(pts + 3 * i + a);
    n[a] = __ldg(nrm + 3 * i + a);
  }
  float cnt, hi, cnt_c = 0.0f, hi_c = 0.0f;
  unsigned long long acc, acc_c = 0;
  gather_level<J>(fine, p, n, knn, lane, tab, tab + 32, cnt, hi, acc);
  bool use_c = false;
  if (has_coarse && cnt < knn) {
    gather_level<J>(coarse, p, n, knn, lane, tab + 64, tab + 96, cnt_c,
                    hi_c, acc_c);
    use_c = cnt_c >= knn;
  }
  float e[3];
  if (use_c)
    estimate<J>(coarse, lane, tab + 64, tab + 96, acc_c, hi_c, pi, e);
  else
    estimate<J>(fine, lane, tab, tab + 32, acc, hi, pi, e);
  if (lane == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) irr[3 * i + a] = e[a];
    r2_out[i] = hi;
    r2c_out[i] = hi_c;
    use_c_out[i] = use_c;
  }
}

Level level_of(const LevelArgs& a) {
  return Level{(const float*)a.pos,    (const float*)a.dir,
               (const float*)a.power,  (const float*)a.weight,
               (const int*)a.cell_hash, (const float*)a.radius,
               (int)a.rows,            (int)a.n_valid,
               (int)a.max_per_cell,    (unsigned)a.table_size};
}

template <int J>
void launch(const Level& fine, const Level& coarse, int has_coarse,
            const float* pts, const float* nrm, long long n_points, float knn,
            float pi, float* irr, float* r2, float* r2_c, unsigned char* use_c,
            cudaStream_t st) {
  const long long blocks = (n_points + WARPS - 1) / WARPS;
  photon_gather<J><<<(unsigned)blocks, 32 * WARPS,
                     WARPS * TABLE * sizeof(int), st>>>(
      fine, coarse, has_coarse, pts, nrm, n_points, knn, pi, irr, r2, r2_c,
      use_c);
}

}  // namespace

// grid_irradiance's forward of `n_points` (> 0) points `pts` (n, 3) with
// unit normals `nrm` (n, 3) over the level `fine` and, unless `coarse` is
// null, its coarse level (the same max_per_cell): the irradiance `irr`
// (n, 3), r'^2 of the fine level `r2` (n,) and of the coarse level
// `r2_c` (n,; 0 where it was not gathered), the level choice `use_c`
// (n,) bool. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// arguments the kernel does not take.
extern "C" int photon_gather_launch(const void* pts, const void* nrm,
                                    long long n_points,
                                    const LevelArgs* fine,
                                    const LevelArgs* coarse, float knn,
                                    float pi, void* irr, void* r2, void* r2_c,
                                    void* use_c, void* stream) {
  if (n_points <= 0 || fine == nullptr || fine->max_per_cell < 1 ||
      fine->max_per_cell > MAX_PER_CELL ||
      (coarse != nullptr && coarse->max_per_cell != fine->max_per_cell))
    return (int)cudaErrorInvalidValue;
  const Level f = level_of(*fine);
  const Level c = coarse != nullptr ? level_of(*coarse) : f;
  const int has_coarse = coarse != nullptr;
  const cudaStream_t st = (cudaStream_t)stream;
  if (PROBES * fine->max_per_cell <= 32 * 32)
    launch<32>(f, c, has_coarse, (const float*)pts, (const float*)nrm,
               n_points, knn, pi, (float*)irr, (float*)r2, (float*)r2_c,
               (unsigned char*)use_c, st);
  else
    launch<64>(f, c, has_coarse, (const float*)pts, (const float*)nrm,
               n_points, knn, pi, (float*)irr, (float*)r2, (float*)r2_c,
               (unsigned char*)use_c, st);
  return (int)cudaGetLastError();
}
