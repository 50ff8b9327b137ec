// Segmented sum of the rows of a (N, C) float32 array into n_rows rows,
// in one fixed order, for Hopper (sm_90a).
//
// A kernel of the port alone: no Pallas kernel of the JAX package does
// this. It replaces the backward scatters of the gradient path on the
// card (embedding_dense_backward under F.embedding, and index_add_'s
// float atomics), whose order of addition is the device's: sorted
// partial sums on the card, lane order on the CPU, any order by atomics.
// ops/segment_sum.py states the order, and segment_sum_plain computes it
// with PyTorch ops; this kernel gives the same bits:
//   the terms of row r are the lanes i with ids[i] == r, ranked in lane
//   order (a stable sort of ids); round s, h = 2^s: rank k with
//   k % 2h == 0 adds rank k + h when k + h < the run's length L; after
//   ceil(log2 L) rounds rank 0 holds the row's sum; an empty row is +0.0.
//
// The wrapper sorts ids (torch.sort, stable) and passes the permutation
// `perm` and each row's first sorted position `row_start` (n_rows + 1).
// Tile t of row r (ranks 1024t .. 1024t + 1023 of its run) has the slot
// base(r) + t, base(r) = r + row_start[r] / 1024: base(r) + ceil(L /
// 1024) <= base(r + 1), so slots are distinct and below n_rows + N / 1024
// without a prefix sum over the rows; a slot past its row's last tile is
// a hole. Two launches:
//  1. segsum_tiles: one warp a slot. Lane l holds ranks 32k + l, k < 32,
//     in registers (a[k]); rounds 0-4 pair lanes l and l + h of one k
//     (warp shuffles), rounds 5-9 pair a[k] and a[k + h / 32] of one
//     lane, so lane 0's a[0] is the tile's rank 0 after round 9, its
//     partial sum, written to partial[slot]. A missing term is -0.0,
//     and an add of one is skipped anyway (-0.0 is the identity);
//  2. segsum_rows: one warp a row. The row's tile partials are ranks
//     1024t of its run, so rounds 10-19 are the same tree over them
//     (and rounds 20-29 the tree over sums of 1,024 partials, taken in
//     place, for runs of more than 2^20 terms). It writes every output
//     row, +0.0 for an empty one.
// Only round-to-nearest adds (__fadd_rn), no atomics.
//
// What bounds it on this card: the bytes, each term read once through
// `perm` (gathered: a row's lanes are in ascending order, so a long run
// reads nearly contiguous memory) and each output written once; the
// shuffles of rounds 0-4 (5 a column for a run of up to 32 terms, 160
// for a full tile) are the instruction cost. Short runs (the triangle
// table's gradient: 262,144 terms on 270,336 rows, most of them empty)
// leave most lanes of a warp idle, and every row and slot takes a warp.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;              // 8 warps a block
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 1024;                // ranks a tile: 32 lanes x 32
constexpr unsigned FULL = 0xffffffffu;

// The tree over ranks 32k + lane < len (rounds 0-9) of a[k]; lane 0's
// return is the sum at rank 0. Every lane of the warp calls it.
__device__ __forceinline__ float tree1024(float (&a)[32], int len,
                                          int lane) {
  const int rows = (len + 31) >> 5;  // warp-uniform
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 1 << s;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      if (k < rows) {
        const float o = __shfl_down_sync(FULL, a[k], h);
        if ((lane & (2 * h - 1)) == 0 && 32 * k + lane + h < len)
          a[k] = __fadd_rn(a[k], o);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int hk = 1 << j;
#pragma unroll
    for (int k = 0; k + hk < 32; k += 2 * hk)
      if (32 * (k + hk) + lane < len) a[k] = __fadd_rn(a[k], a[k + hk]);
  }
  return a[0];
}

// The first tile slot of row r.
__device__ __forceinline__ long long base_of(const long long* row_start,
                                             long long r) {
  return r + (row_start[r] >> 10);
}

// The last row whose first slot is at most g (base_of increases with r,
// and base_of(0) = 0), searched by the whole warp: each round the lanes
// probe 32 evenly spaced rows of [lo, hi] at once, so a search over
// 270,336 rows takes 4 rounds of loads instead of 19 one after another.
__device__ __forceinline__ int row_of_slot(const long long* row_start,
                                           int n_rows, long long g,
                                           int lane) {
  long long lo = 0, hi = n_rows - 1;  // the row is in [lo, hi]
  while (lo < hi) {                   // warp-uniform
    const long long step = (hi - lo + 31) / 32;
    const long long probe = lo + (lane + 1) * step;
    const bool below = probe <= hi && base_of(row_start, probe) <= g;
    // the lanes with `below` are a prefix of the warp
    const int k = __popc(__ballot_sync(FULL, below));
    const long long top = lo + (k + 1) * step - 1;
    lo += k * step;
    hi = top < hi ? top : hi;
  }
  return (int)lo;
}

__global__ void __launch_bounds__(THREADS)
    segsum_tiles(const float* __restrict__ values, int cols,
                 const long long* __restrict__ perm,
                 const long long* __restrict__ row_start, int n_rows,
                 long long slots, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const long long g = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (g >= slots) return;  // warp-uniform, as every exit below
  const int row = row_of_slot(row_start, n_rows, g, lane);
  const long long start =
      row_start[row] + (g - base_of(row_start, row)) * TILE;
  const long long rest = row_start[row + 1] - start;
  if (rest <= 0) return;  // a hole
  const int len = rest < TILE ? (int)rest : TILE;
  const int rows = (len + 31) >> 5;
  int idx[32];
#pragma unroll
  for (int k = 0; k < 32; ++k)
    idx[k] = (k < rows && 32 * k + lane < len)
                 ? (int)perm[start + 32 * k + lane] : -1;
  for (int c = 0; c < cols; ++c) {
    float a[32];
#pragma unroll
    for (int k = 0; k < 32; ++k)
      a[k] = idx[k] >= 0 ? values[(long long)idx[k] * cols + c] : -0.0f;
    const float s = tree1024(a, len, lane);
    if (lane == 0) partial[g * cols + c] = s;
  }
}

__global__ void __launch_bounds__(THREADS)
    segsum_rows(const long long* __restrict__ row_start, int n_rows,
                int cols, float* __restrict__ partial,
                float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // warp-uniform
  const long long first = base_of(row_start, row);
  const long long tiles =
      (row_start[row + 1] - row_start[row] + TILE - 1) / TILE;
  if (tiles <= 1) {  // an empty row, or its one tile's partial: lanes
                     // take the columns
    for (int c = lane; c < cols; c += 32)
      out[row * cols + c] = tiles ? partial[first * cols + c] : 0.0f;
    return;
  }
  for (int c = 0; c < cols; ++c) {
    // rounds 10 and up: the tree over the tile partials (ranks 1024t of
    // the run), 1,024 at a time, each chunk's sum stored in place at
    // its first partial, until one is left
    long long n = tiles, stride = 1;
    while (n > 1) {
      for (long long q = 0; q * TILE < n; ++q) {
        const long long rest = n - q * TILE;
        const int len = rest < TILE ? (int)rest : TILE;
        float a[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const long long t = q * TILE + 32 * k + lane;
          a[k] = 32 * k + lane < len
                     ? partial[(first + t * stride) * cols + c] : -0.0f;
        }
        const float s = tree1024(a, len, lane);
        __syncwarp();
        if (lane == 0) partial[(first + q * TILE * stride) * cols + c] = s;
        __syncwarp();
      }
      n = (n + TILE - 1) / TILE;
      stride *= TILE;
    }
    if (lane == 0) out[row * cols + c] = partial[first * cols + c];
  }
}

}  // namespace

// The sum (see above) of `values` (n, cols) into `out` (n_rows, cols),
// with perm (n,) and row_start (n_rows + 1) int64 as the wrapper
// computes them and the scratch `partial` (slots, cols), slots =
// n_rows + n / 1024 (0: the tiles pass is not launched, for timing the
// rows pass alone). Returns cudaGetLastError().
extern "C" int segment_sum_launch(const void* values, int cols,
                                  const void* perm, const void* row_start,
                                  int n_rows, long long slots, void* partial,
                                  void* out, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  if (slots > 0)
    segsum_tiles<<<(unsigned)((slots + WARPS - 1) / WARPS), THREADS, 0,
                   st>>>((const float*)values, cols, (const long long*)perm,
                         (const long long*)row_start, n_rows, slots,
                         (float*)partial);
  segsum_rows<<<(unsigned)(((long long)n_rows + WARPS - 1) / WARPS), THREADS,
                0, st>>>((const long long*)row_start, n_rows, cols,
                         (float*)partial, (float*)out);
  return (int)cudaGetLastError();
}
