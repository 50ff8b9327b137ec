// Segmented sum of the rows of a (N, C) float32 array into n_rows rows,
// in one fixed order, for Hopper (sm_90a).
//
// A kernel of the port alone: no Pallas kernel of the JAX package does
// this. It replaces the backward scatters of the gradient path on the
// card (embedding_dense_backward under F.embedding, and index_add_'s
// float atomics), whose order of addition is the device's: sorted
// partial sums on the card, lane order on the CPU, any order by atomics.
// ops/segment_sum.py states the order, and segment_sum_plain computes it
// with PyTorch ops; this file gives the same bits:
//   the terms of row r are the lanes i with ids[i] == r, ranked in lane
//   order (a stable sort of ids); round s, h = 2^s: rank k with
//   k % 2h == 0 adds rank k + h when k + h < the run's length L; after
//   ceil(log2 L) rounds rank 0 holds the row's sum; an empty row is +0.0.
//
// The same sum as a stream (the binary counter): read the run's terms in
// rank order, keeping p[j], the sum of a finished aligned block of 2^j
// terms; term k is carried up through the levels j where bit j of k is
// set (x = p[j] + x: the left block first) and stored at the first level
// where it is clear; at the end the blocks of L's set bits are folded
// from the right (v = p[j] + v, j ascending). That is the tree's every
// addition in its order, with log2(L) + 1 registers and no shuffles.
//
// One call (segment_sum_launch), sized from the host's numbers alone (no
// sync), 2 device operations with one row and 5 + passes with more:
//  sort, when n_rows > 1 (bits = ceil(log2 n_rows), in passes of at most
//  8 bits; a memset clears the counters first):
//   1. segsum_hist: the rows' term counts (integer atomics, one for each
//      group of a warp's lanes with one id) and each pass's digit counts;
//   2. segsum_sort_pass, once a pass: a stable LSD radix pass over those
//      bits only. A block takes a ticket (its place in the array, so no
//      block waits on one that has not started), ranks its 4,096 keys by
//      digit (a warp's lanes of one digit by __match_any_sync, the warps
//      in order), publishes its digit counts and looks back over the
//      earlier blocks' (decoupled look-back, 16 blocks a step) for its
//      digits' offsets, orders the keys in shared memory and writes them
//      out so that a digit's keys land on neighbouring addresses. Stable
//      passes of a stable order: the permutation equals
//      torch.sort(stable=True)'s, which is unique;
//   3. segsum_runs: an exclusive scan over the rows (the same look-back)
//      of (terms, short runs, tiles), writing each non-empty row's run
//      into the short list or its tiles into the tile list.
//  With n_rows == 1 none of this runs: the run is the array itself, read
//  in place.
//  zero-fill: an empty row is +0.0, all zero bits: one cudaMemsetAsync of
//  `out` (n_rows > 1).
//  sums, over the runs alone (no warp for an empty row):
//   - segsum_tiles: a run longer than short_max (32 terms; 64 from 16
//     columns up) in tiles of 1,024 ranks aligned to the run's start, a
//     warp a (tile, 4-column chunk). Lane l streams its aligned block of
//     w ranks (w the least power of two with 32w >= the tile's length:
//     the rounds below w), five shuffles add the lanes' blocks. A run of
//     one tile writes its row; otherwise the tile stores its partial, and
//     the warp that finishes a run's last tile of a chunk (an integer
//     ticket) adds the run's partials by the same tree (rounds 10 and up,
//     1,024 at a time, in place) and writes those columns;
//   - segsum_short: the short runs, 32 / C side by side in a warp (C >=
//     32: one, the lanes over the columns), a lane a (run, column), each
//     lane streaming 4 runs at once through the binary counter, 4 terms
//     of each a step: 16 loads in flight.
// Only round-to-nearest adds (__fadd_rn), no float atomics, no FMA.
//
// What bounds it on this card: the bytes at best (each term read once
// through the permutation, a gather; each row written once; the sort
// reads the ids once for the counts and moves 8 bytes a term a pass), and
// in practice the latency of dependent loads: segsum_tiles holds 32
// terms a lane in registers (198 registers, one block an SM) and
// segsum_short's lanes wait on list, permutation and values in turn.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int TILE = 1024;                 // ranks a tile, at most
constexpr int WARPS = 8;                   // warps a block, every kernel
constexpr int THREADS = 32 * WARPS;
constexpr int RADIX_BITS = 8;              // a pass's digit, at most
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int SORT_STEPS = 16;             // keys a lane a pass
constexpr int SORT_TILE = THREADS * SORT_STEPS;
constexpr int SORT_SHARED =
    4 * ((WARPS + 2) * RADIX + 2 * WARPS + 4 + 2 * SORT_TILE);
static_assert(SORT_SHARED <= 48 * 1024, "a sort pass's shared memory");
constexpr int RUN_ROWS = 8;                // rows a thread of the scan
constexpr int SHORT_BLOCKS = 2;            // segsum_short's blocks an SM
constexpr int SHORT_LEVELS = 7;            // short runs of up to 64 terms
constexpr int RUNS = 4;                    // short runs a lane at once
constexpr int STEP = 4;                    // terms of each at a time
constexpr int CHUNK = 4;                   // columns a tile's work item
constexpr int LOOK = 16;                   // blocks a look-back step reads
constexpr unsigned long long AGGREGATE = 1ull << 32;
constexpr unsigned long long PREFIX = 2ull << 32;

// The binary counter: term k (x) carried up the levels of k's set bits.
template <int LV>
__device__ __forceinline__ void push(float (&p)[LV], int k, float x) {
  bool open = true;
#pragma unroll
  for (int j = 0; j < LV; ++j) {
    if (open) {
      if ((k >> j) & 1) {
        x = __fadd_rn(p[j], x);
      } else {
        p[j] = x;
        open = false;
      }
    }
  }
}

// The sum of len (> 0) pushed terms: len's blocks folded from the right.
template <int LV>
__device__ __forceinline__ float fold(const float (&p)[LV], int len) {
  float v = 0.0f;
  bool any = false;
#pragma unroll
  for (int j = 0; j < LV; ++j) {
    if ((len >> j) & 1) {
      v = any ? __fadd_rn(p[j], v) : p[j];
      any = true;
    }
  }
  return v;
}

// The tree over a tile's len (<= 1,024) ranks, lane l holding ranks
// w * l + k (k < w) in x[k], w = width_of(len) a power of two: the
// lane streams its aligned block of w ranks (the rounds below w), five
// shuffles add the lanes' blocks (the rounds from w up). Lane 0's return
// is the tile's sum. Every lane of the warp calls it.
__device__ __forceinline__ float warp_tree(const float (&x)[32], int len,
                                           int w, int lane) {
  const int rest = len - w * lane;
  const int m = rest < 0 ? 0 : rest > w ? w : rest;
  float p[6];
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < m) push(p, k, x[k]);
  float v = m > 0 ? fold(p, m) : 0.0f;
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int h = 1 << s;
    const float o = __shfl_down_sync(FULL, v, h);
    if ((lane & (2 * h - 1)) == 0 && w * (lane + h) < len)
      v = __fadd_rn(v, o);
  }
  return v;
}

// The ranks a lane takes in a tile of len ranks: the least power of two
// that spreads them over the 32 lanes.
__device__ __forceinline__ int width_of(int len) {
  int w = 1;
  while (32 * w < len) w <<= 1;
  return w;
}

// An id as a sort key; an id outside [0, n_rows) (against the contract)
// is kept in range, so it corrupts no memory.
__device__ __forceinline__ int key_of(long long id, int n_rows) {
  return id < 0 ? 0 : id >= n_rows ? n_rows - 1 : (int)id;
}

__device__ __forceinline__ unsigned long long load_volatile(
    const unsigned long long* p) {
  return *(const volatile unsigned long long*)p;
}

__device__ __forceinline__ void store_volatile(unsigned long long* p,
                                               unsigned long long v) {
  *(volatile unsigned long long*)p = v;
}

// The decoupled look-back: the counts of blocks j, j - 1, ... added down
// to the nearest one that holds an inclusive prefix (flag 2), which is
// added too. Each step reads the status words (flag << 32 | count) of
// LOOK blocks at once and adds them in order up to the first that is
// not yet published (flag 0), where the next step starts. Block 0
// always publishes a prefix, so the walk ends.
__device__ __forceinline__ unsigned look_back(
    const unsigned long long* status, long long j, long long stride) {
  unsigned before = 0;
  for (;;) {
    unsigned long long v[LOOK];
#pragma unroll
    for (int w = 0; w < LOOK; ++w)
      v[w] = j - w >= 0 ? load_volatile(status + (j - w) * stride) : PREFIX;
    int used = 0;
    bool done = false, wait = false;
#pragma unroll
    for (int w = 0; w < LOOK; ++w) {
      if (!done && !wait) {
        const unsigned long long f = v[w] >> 32;
        if (f == 0) {
          wait = true;
        } else {
          before += (unsigned)v[w];
          ++used;
          done = f == 2;
        }
      }
    }
    if (done) return before;
    j -= used;
  }
}

// ---------------------------------------------------------------------------
// the sort
// ---------------------------------------------------------------------------

// Row counts and every pass's digit counts. Shared memory: passes * RADIX
// unsigned.
__global__ void __launch_bounds__(THREADS)
    segsum_hist(const long long* __restrict__ ids, long long n, int n_rows,
                int passes, int dbits, unsigned* __restrict__ row_count,
                unsigned* __restrict__ digit_count) {
  extern __shared__ unsigned hist_sh[];
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < passes * RADIX; i += THREADS) hist_sh[i] = 0;
  __syncthreads();
  const unsigned mask = (1u << dbits) - 1;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long base = (long long)blockIdx.x * THREADS + (tid & ~31);
       base < n; base += stride) {  // warp-uniform
    const long long i = base + lane;
    const bool ok = i < n;
    const int key = ok ? key_of(ids[i], n_rows) : -1;
    // one atomic a group of lanes with one key
    const unsigned peers = __match_any_sync(FULL, key);
    if (ok && (peers & ((1u << lane) - 1)) == 0) {
      const unsigned c = __popc(peers);
      atomicAdd(&row_count[key], c);
      for (int p = 0; p < passes; ++p)
        atomicAdd(&hist_sh[p * RADIX + ((key >> (p * dbits)) & mask)], c);
    }
  }
  __syncthreads();
  for (int i = tid; i < passes * RADIX; i += THREADS)
    if (hist_sh[i]) atomicAdd(&digit_count[i], hist_sh[i]);
}

// One stable pass over digit (key >> shift) & (2^dbits - 1), dbits <=
// RADIX_BITS. Pass 0 reads the int64 ids (keys_in, perm_in null) and
// numbers the lanes; the last pass writes no keys (keys_out null). status: (blocks, RADIX) words of
// flag << 32 | count, zeroed; ticket zeroed. Shared memory: SORT_SHARED
// bytes.
__global__ void __launch_bounds__(THREADS)
    segsum_sort_pass(const long long* __restrict__ ids,
                     const int* __restrict__ keys_in,
                     const int* __restrict__ perm_in,
                     int* __restrict__ keys_out, int* __restrict__ perm_out,
                     long long n, int n_rows, int shift, int dbits,
                     const unsigned* __restrict__ digit_count,
                     unsigned long long* status, unsigned* ticket) {
  extern __shared__ unsigned sort_sh[];
  unsigned* wcount = sort_sh;                     // [WARPS][RADIX]
  unsigned* dstart = sort_sh + WARPS * RADIX;     // [RADIX]
  unsigned* lstart = dstart + RADIX;              // [RADIX]
  unsigned* wsum = lstart + RADIX;                // [2][WARPS]
  unsigned* tile_no = wsum + 2 * WARPS;           // [1]
  int* keys_sh = (int*)(tile_no + 4);             // [SORT_TILE]
  int* idx_sh = keys_sh + SORT_TILE;              // [SORT_TILE]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nb = 1 << dbits;
  const unsigned mask = (unsigned)nb - 1;
  if (tid == 0) tile_no[0] = atomicAdd(ticket, 1u);
  for (int d = lane; d < RADIX; d += 32) wcount[warp * RADIX + d] = 0;
  __syncthreads();
  const long long b = tile_no[0];
  const long long first =
      b * SORT_TILE + (long long)warp * (SORT_TILE / WARPS);
  // each warp ranks its 512 keys in lane order, by digit
  int key[SORT_STEPS], idx[SORT_STEPS];
  unsigned rank[SORT_STEPS];
#pragma unroll
  for (int s = 0; s < SORT_STEPS; ++s) {  // every load in flight at once
    const long long i = first + 32 * s + lane;
    const bool ok = i < n;
    key[s] = ok ? (ids ? key_of(ids[i], n_rows) : keys_in[i]) : -1;
    idx[s] = ok ? (perm_in ? perm_in[i] : (int)i) : 0;
  }
#pragma unroll
  for (int s = 0; s < SORT_STEPS; ++s) {
    const bool ok = key[s] >= 0;
    const int d = ok ? (int)((key[s] >> shift) & mask) : -1;
    const unsigned peers = __match_any_sync(FULL, d);
    const unsigned below = peers & ((1u << lane) - 1);
    const unsigned before = ok ? wcount[warp * RADIX + d] : 0u;
    __syncwarp();
    if (ok && below == 0) wcount[warp * RADIX + d] = before + __popc(peers);
    __syncwarp();
    rank[s] = before + __popc(below);
  }
  __syncthreads();
  // thread d (RADIX == THREADS): digit d's offsets for the warps and the
  // block's count; its first position in the block, and in the whole
  // array (scans of the block's and the pass's digit counts)
  const int d = tid;
  unsigned count = 0;
  for (int w = 0; w < WARPS; ++w) {
    const unsigned c = wcount[w * RADIX + d];
    wcount[w * RADIX + d] = count;
    count += c;
  }
  const unsigned total = d < nb ? digit_count[d] : 0u;
  unsigned in_block = count, in_all = total;
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned a = __shfl_up_sync(FULL, in_block, o);
    const unsigned g = __shfl_up_sync(FULL, in_all, o);
    if (lane >= o) {
      in_block += a;
      in_all += g;
    }
  }
  if (lane == 31) {
    wsum[warp] = in_block;
    wsum[WARPS + warp] = in_all;
  }
  __syncthreads();
  in_block -= count;
  in_all -= total;
  for (int w = 0; w < warp; ++w) {
    in_block += wsum[w];
    in_all += wsum[WARPS + w];
  }
  lstart[d] = in_block;
  // the earlier blocks' count of digit d (decoupled look-back)
  if (d < nb) {
    unsigned long long* mine = status + b * RADIX + d;
    unsigned before = 0;
    if (b == 0) {
      store_volatile(mine, PREFIX | count);
    } else {
      store_volatile(mine, AGGREGATE | count);
      before = look_back(status + d, b - 1, RADIX);
      store_volatile(mine, PREFIX | (before + count));
    }
    dstart[d] = in_all + before;
  }
  __syncthreads();
  // the keys in the block's sorted order in shared memory, then written
  // out in that order: a digit's keys go to consecutive addresses
#pragma unroll
  for (int s = 0; s < SORT_STEPS; ++s) {
    if (key[s] >= 0) {
      const int dd = (int)((key[s] >> shift) & mask);
      const unsigned at = lstart[dd] + wcount[warp * RADIX + dd] + rank[s];
      keys_sh[at] = key[s];
      idx_sh[at] = idx[s];
    }
  }
  __syncthreads();
  const long long rest = n - b * SORT_TILE;
  const int held = rest < SORT_TILE ? (int)rest : SORT_TILE;
  for (int at = tid; at < held; at += THREADS) {
    const int k = keys_sh[at];
    const int dd = (int)((k >> shift) & mask);
    const unsigned pos = dstart[dd] + (at - lstart[dd]);
    if (keys_out) keys_out[pos] = k;
    perm_out[pos] = idx_sh[at];
  }
}

// The exclusive scan over the rows of (terms, short runs, tiles), 2,048
// rows a block in ticket order with a look-back, writing the run lists:
// short_list[i] = (row, start, length), tile_list[t] = (row, run start,
// run length, the run's first tile); totals = (short runs, tiles).
// status: (blocks, 3) words, one a sum, zeroed; ticket zeroed. Shared
// memory: 3 * WARPS + 4 unsigned.
__global__ void __launch_bounds__(THREADS)
    segsum_runs(const unsigned* __restrict__ row_count, int n_rows,
                int short_max,
                unsigned long long* status, unsigned* ticket,
                int* __restrict__ short_list, int* __restrict__ tile_list,
                unsigned* __restrict__ totals) {
  extern __shared__ unsigned run_sh[];
  unsigned* wsum = run_sh;                  // [3][WARPS]
  unsigned* prefix = run_sh + 3 * WARPS;    // [3], then the block number
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) prefix[3] = atomicAdd(ticket, 1u);
  __syncthreads();
  const long long b = prefix[3];
  const long long r0 = (b * THREADS + tid) * RUN_ROWS;
  unsigned own[3] = {0, 0, 0};
  unsigned len[RUN_ROWS];
#pragma unroll
  for (int q = 0; q < RUN_ROWS; ++q) {
    len[q] = r0 + q < n_rows ? row_count[r0 + q] : 0u;
    own[0] += len[q];
    own[1] += len[q] >= 1 && len[q] <= (unsigned)short_max;
    own[2] += len[q] > (unsigned)short_max ? (len[q] + TILE - 1) / TILE : 0u;
  }
  unsigned at[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    unsigned v = own[c];
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned t = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += t;
    }
    if (lane == 31) wsum[c * WARPS + warp] = v;
    at[c] = v - own[c];
  }
  __syncthreads();
  if (tid < 3) {  // thread c: sum c's look-back
    unsigned total = 0;
    for (int w = 0; w < WARPS; ++w) total += wsum[tid * WARPS + w];
    unsigned long long* mine = status + 3 * b + tid;
    unsigned before = 0;
    if (b == 0) {
      store_volatile(mine, PREFIX | total);
    } else {
      store_volatile(mine, AGGREGATE | total);
      before = look_back(status + tid, b - 1, 3);
      store_volatile(mine, PREFIX | (before + total));
    }
    prefix[tid] = before;
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int w = 0; w < warp; ++w) at[c] += wsum[c * WARPS + w];
    at[c] += prefix[c];
  }
  for (int q = 0; q < RUN_ROWS; ++q) {
    const long long r = r0 + q;
    if (r >= n_rows) break;
    const unsigned L = len[q];
    if (L >= 1 && L <= (unsigned)short_max) {
      int* e = short_list + 3ll * at[1]++;
      e[0] = (int)r;
      e[1] = (int)at[0];
      e[2] = (int)L;
    } else if (L > (unsigned)short_max) {
      const unsigned tiles = (L + TILE - 1) / TILE;
      for (unsigned t = 0; t < tiles; ++t) {
        int* e = tile_list + 4ll * (at[2] + t);
        e[0] = (int)r;
        e[1] = (int)at[0];
        e[2] = (int)L;
        e[3] = (int)at[2];
      }
      at[2] += tiles;
    }
    at[0] += L;
    if (r == n_rows - 1) {
      totals[0] = at[1];
      totals[1] = at[2];
    }
  }
}

// ---------------------------------------------------------------------------
// the sums
// ---------------------------------------------------------------------------

// RUNS short runs streamed side by side by one lane for column c, STEP
// terms of each at a time: RUNS * STEP loads in flight.
__device__ __forceinline__ void stream_runs(const float* __restrict__ values,
                                           int cols, int c,
                                           const int* __restrict__ perm,
                                           const int (&row)[RUNS],
                                           const int (&start)[RUNS],
                                           const int (&len)[RUNS],
                                           float* __restrict__ out) {
  float p[RUNS][SHORT_LEVELS];
  int longest = 0;
#pragma unroll
  for (int r = 0; r < RUNS; ++r) longest = len[r] > longest ? len[r] : longest;
  for (int k0 = 0; k0 < longest; k0 += STEP) {
    int idx[RUNS][STEP];
    float x[RUNS][STEP];
#pragma unroll
    for (int r = 0; r < RUNS; ++r)
#pragma unroll
      for (int u = 0; u < STEP; ++u) {
        const int at = start[r] + k0 + u;
        idx[r][u] = k0 + u < len[r] ? (perm ? perm[at] : at) : 0;
      }
#pragma unroll
    for (int r = 0; r < RUNS; ++r)
#pragma unroll
      for (int u = 0; u < STEP; ++u)
        x[r][u] = k0 + u < len[r] ? values[(long long)idx[r][u] * cols + c]
                                  : 0.0f;
#pragma unroll
    for (int r = 0; r < RUNS; ++r)
#pragma unroll
      for (int u = 0; u < STEP; ++u)
        if (k0 + u < len[r]) push(p[r], k0 + u, x[r][u]);
  }
#pragma unroll
  for (int r = 0; r < RUNS; ++r)
    if (len[r] > 0) out[(long long)row[r] * cols + c] = fold(p[r], len[r]);
}

// Columns c0 .. c0 + CHUNK - 1 (< cols) of a run's tile partials (tiles of
// them from `first`) added by the tree, 1,024 at a time in place, into
// the row; every lane calls it.
__device__ void combine(float* partial, int cols, int c0, long long first,
                        long long tiles, float* __restrict__ row, int lane) {
  for (int c = c0; c < c0 + CHUNK && c < cols; ++c) {
    long long n = tiles, stride = 1;
    while (n > 1) {  // warp-uniform
      for (long long q = 0; q * TILE < n; ++q) {
        const long long rest = n - q * TILE;
        const int len = rest < TILE ? (int)rest : TILE;
        const int w = width_of(len);
        float x[32];
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const long long t = q * TILE + w * lane + k;
          x[k] = k < w && w * lane + k < len
                     ? __ldcg(&partial[(first + t * stride) * cols + c])
                     : 0.0f;
        }
        const float v = warp_tree(x, len, w, lane);
        if (lane == 0)
          __stcg(&partial[(first + q * TILE * stride) * cols + c], v);
        __syncwarp();
      }
      n = (n + TILE - 1) / TILE;
      stride *= TILE;
    }
    if (lane == 0) row[c] = __ldcg(&partial[first * cols + c]);
  }
}

// Batches of short runs, warp w taking batches w, w + the grid's warps,
// ...: RUNS runs a group of lanes, a lane a column. short_list null: the
// whole array (n terms) is row 0's one run. n_short from totals when
// that is given (the scan's count, on the device).
__global__ void __launch_bounds__(THREADS, SHORT_BLOCKS)
    segsum_short(const float* __restrict__ values, int cols,
                 const int* __restrict__ perm,
                 const int* __restrict__ short_list,
                 const unsigned* __restrict__ totals, int n, int n_short,
                 float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  if (totals) n_short = (int)totals[0];
  const int width = cols >= 32 ? 32 : cols;  // lanes a run
  const int groups = 32 / width;             // runs side by side
  const int per_batch = groups * RUNS;
  const int g = lane / width;
  for (int batch = blockIdx.x * WARPS + (threadIdx.x >> 5);
       batch * per_batch < n_short; batch += gridDim.x * WARPS) {
    int row[RUNS], start[RUNS], len[RUNS];
#pragma unroll
    for (int r = 0; r < RUNS; ++r) {
      const int i = batch * per_batch + g * RUNS + r;
      row[r] = start[r] = len[r] = 0;
      if (g < groups && i < n_short) {
        len[r] = n;
        if (short_list) {
          row[r] = short_list[3 * i];
          start[r] = short_list[3 * i + 1];
          len[r] = short_list[3 * i + 2];
        }
      }
    }
    for (int c = lane % width; c < cols; c += 32)
      stream_runs(values, cols, c, perm, row, start, len, out);
  }
}

// (tile, column chunk) pairs, warp w taking pairs w, w + the grid's
// warps, ...; a run's last tile to finish a chunk adds the run's partials
// of those columns (done: a ticket for each run and chunk, zeroed).
// tile_list null: the whole array (n terms) is row 0's run, in n_tiles
// tiles. n_tiles from totals when that is given.
__global__ void __launch_bounds__(THREADS)
    segsum_tiles(const float* __restrict__ values, int cols,
                 const int* __restrict__ perm,
                 const int* __restrict__ tile_list,
                 const unsigned* __restrict__ totals, int n, int n_tiles,
                 float* partial, unsigned* done, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  if (totals) n_tiles = (int)totals[1];
  const int chunks = (cols + CHUNK - 1) / CHUNK;
  for (long long item = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
       item < (long long)n_tiles * chunks;
       item += (long long)gridDim.x * WARPS) {  // warp-uniform, as below
    const int t = (int)(item / chunks);
    const int c0 = (int)(item % chunks) * CHUNK;
    int row = 0, run_start = 0, run_len = n, first = 0;
    if (tile_list) {
      row = tile_list[4 * t];
      run_start = tile_list[4 * t + 1];
      run_len = tile_list[4 * t + 2];
      first = tile_list[4 * t + 3];
    }
    const int tiles = (run_len + TILE - 1) / TILE;
    const int ts = run_start + (t - first) * TILE;
    const int rest = run_start + run_len - ts;
    const int len = rest < TILE ? rest : TILE;
    const int w = width_of(len);
    int idx[32];
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int r = ts + w * lane + k;
      idx[k] = k < w && w * lane + k < len ? (perm ? perm[r] : r) : 0;
    }
    for (int c = c0; c < c0 + CHUNK && c < cols; ++c) {
      float x[32];
#pragma unroll
      for (int k = 0; k < 32; ++k)
        x[k] = k < w && w * lane + k < len
                   ? values[(long long)idx[k] * cols + c] : 0.0f;
      const float v = warp_tree(x, len, w, lane);
      if (lane == 0) {
        if (tiles == 1)
          out[(long long)row * cols + c] = v;
        else
          __stcg(&partial[(long long)t * cols + c], v);
      }
    }
    if (tiles == 1) continue;
    unsigned ticket = 0;
    if (lane == 0) {
      __threadfence();
      ticket = atomicAdd(&done[(long long)first * chunks + c0 / CHUNK], 1u);
    }
    ticket = __shfl_sync(FULL, ticket, 0);
    if (ticket == (unsigned)tiles - 1) {
      __threadfence();
      combine(partial, cols, c0, first, tiles, out + (long long)row * cols,
              lane);
    }
  }
}

// The longest run a group of lanes streams (longer ones go in tiles):
// with 16 columns and more a run has the warp's lanes to itself, one
// coalesced row read a term, where a tile reads a column at a time.
int short_max_of(int cols) { return cols >= 16 ? 64 : 32; }

struct Plan {
  int bits, passes, dbits;
  long long sort_blocks, run_blocks, max_short, max_tiles;
  // byte offsets into the scratch; [0, zeroed) is cleared by the sort
  size_t row_count, digit_count, tickets, status, run_status, totals,
      done, zeroed, keys0, keys1, perm1, short_list, tile_list,
      partial, bytes;
};

size_t align_up(size_t x) { return (x + 255) & ~(size_t)255; }

Plan plan_of(long long n, int cols, int n_rows) {
  Plan p{};
  p.bits = 0;
  while ((1ll << p.bits) < n_rows) ++p.bits;
  p.passes = (p.bits + RADIX_BITS - 1) / RADIX_BITS;
  p.dbits = p.passes ? (p.bits + p.passes - 1) / p.passes : 0;
  p.sort_blocks = (n + SORT_TILE - 1) / SORT_TILE;
  p.run_blocks = ((long long)n_rows + THREADS * RUN_ROWS - 1) /
                 (THREADS * RUN_ROWS);
  p.max_short = n < n_rows ? n : n_rows;
  p.max_tiles = n_rows == 1 ? (n + TILE - 1) / TILE
                            : n / TILE + n / (short_max_of(cols) + 1) + 1;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at = align_up(at + bytes);
    return here;
  };
  const bool sort = n_rows > 1;
  // the sums' counters first: zeroed alone when the sort does not run
  p.done = take(4 * p.max_tiles * ((cols + CHUNK - 1) / CHUNK));
  p.row_count = take(sort ? 4ll * n_rows : 0);
  p.digit_count = take(4ll * RADIX * p.passes);
  p.tickets = take(4ll * (p.passes + 1));
  p.status = take(8ll * RADIX * p.sort_blocks * p.passes);
  p.run_status = take(sort ? 24 * p.run_blocks : 0);
  p.totals = take(8);
  p.zeroed = at;
  p.keys0 = take(sort ? 4 * n : 0);
  p.keys1 = take(sort ? 4 * n : 0);
  p.perm1 = take(sort ? 4 * n : 0);
  p.short_list = take(sort ? 12 * p.max_short : 0);
  p.tile_list = take(sort ? 16 * p.max_tiles : 0);
  p.partial = take(4ll * cols * p.max_tiles);
  p.bytes = at;
  return p;
}

int sm_count() {
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// A grid of `blocks` blocks of `kernel`, at most as many as the card
// holds at once.
template <auto K>
unsigned grid_of(long long blocks) {
  static long long most = 0;  // one for each kernel K
  if (!most) {
    int per_sm = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, K, THREADS, 0);
    most = (long long)(per_sm > 0 ? per_sm : 1) * sm_count();
  }
  return (unsigned)(blocks < most ? blocks : most);
}

}  // namespace

// Bytes of scratch a call needs (16-byte aligned from its start).
extern "C" long long segment_sum_scratch_bytes(long long n, int cols,
                                               int n_rows) {
  return (long long)plan_of(n, cols, n_rows).bytes;
}

// The sum (see above) of `values` (n, cols) by `ids` (n,) int64 into
// `out` (n_rows, cols); `perm` (n,) int32 receives the stable sort's
// permutation when n_rows > 1. `parts` picks what runs, for timing them
// apart: 1 the sort (and the scan into run lists), 2 the sums, 4 the
// zero-fill; 7 is the whole call. A sums part without the sort part
// reads the lists of an earlier call on the same scratch. Returns
// cudaGetLastError().
extern "C" int segment_sum_launch(const void* values, int cols,
                                  const void* ids, long long n, int n_rows,
                                  void* perm, void* scratch, void* out,
                                  int parts, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n <= 0 || n_rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  const Plan p = plan_of(n, cols, n_rows);
  char* s = (char*)scratch;
  auto at = [&](size_t off) { return (void*)(s + off); };
  const bool sort = n_rows > 1;
  if (sort && (parts & 1)) {
    cudaMemsetAsync(scratch, 0, p.zeroed, st);
    const long long hist_blocks = (n + THREADS - 1) / THREADS;
    segsum_hist<<<(unsigned)(hist_blocks < 8ll * sm_count()
                                 ? hist_blocks : 8ll * sm_count()),
                  THREADS, 4 * RADIX * p.passes, st>>>(
        (const long long*)ids, n, n_rows, p.passes, p.dbits,
        (unsigned*)at(p.row_count), (unsigned*)at(p.digit_count));
    int* keys[2] = {(int*)at(p.keys0), (int*)at(p.keys1)};
    const int* keys_in = nullptr;
    const int* perm_in = nullptr;
    for (int q = 0; q < p.passes; ++q) {
      const bool last = q == p.passes - 1;
      // the last pass writes `perm`: the passes alternate back from it
      int* perm_out = (p.passes - 1 - q) % 2 == 0 ? (int*)perm
                                                  : (int*)at(p.perm1);
      int* keys_out = last ? nullptr : keys[q % 2];
      const int shift = q * p.dbits;
      const int dbits = p.bits - shift < p.dbits ? p.bits - shift : p.dbits;
      segsum_sort_pass<<<(unsigned)p.sort_blocks, THREADS,
                         SORT_SHARED, st>>>(
          q == 0 ? (const long long*)ids : nullptr, keys_in, perm_in,
          keys_out, perm_out, n, n_rows, shift, dbits,
          (const unsigned*)at(p.digit_count) + q * RADIX,
          (unsigned long long*)at(p.status) + q * RADIX * p.sort_blocks,
          (unsigned*)at(p.tickets) + q);
      keys_in = keys_out;
      perm_in = perm_out;
    }
    segsum_runs<<<(unsigned)p.run_blocks, THREADS, 4 * (3 * WARPS + 4),
                  st>>>((const unsigned*)at(p.row_count), n_rows,
                        short_max_of(cols),
                        (unsigned long long*)at(p.run_status),
                        (unsigned*)at(p.tickets) + p.passes,
                        (int*)at(p.short_list), (int*)at(p.tile_list),
                        (unsigned*)at(p.totals));
  }
  if (sort && (parts & 4))
    cudaMemsetAsync(out, 0, 4ull * n_rows * cols, st);
  if (parts & 2) {
    // the tiles (a ticket for each run and column chunk, zeroed here when
    // the sort did not zero them), then the short runs
    const int chunks = (cols + CHUNK - 1) / CHUNK;
    const int per_batch = (cols >= 32 ? 1 : 32 / cols) * RUNS;
    const int short_max = short_max_of(cols);
    const long long tiles = sort ? p.max_tiles : n > short_max ? p.max_tiles
                                                               : 0;
    const long long runs = sort ? p.max_short : n > short_max ? 0 : 1;
    if (!sort || !(parts & 1))
      cudaMemsetAsync(at(p.done), 0, p.row_count - p.done, st);
    const int* totals = sort ? (const int*)at(p.totals) : nullptr;
    if (tiles)
      segsum_tiles<<<grid_of<segsum_tiles>((tiles * chunks + WARPS - 1) /
                                           WARPS),
                     THREADS, 0, st>>>(
          (const float*)values, cols, sort ? (const int*)perm : nullptr,
          sort ? (const int*)at(p.tile_list) : nullptr,
          (const unsigned*)totals, (int)n, (int)tiles,
          (float*)at(p.partial), (unsigned*)at(p.done), (float*)out);
    if (runs)
      segsum_short<<<grid_of<segsum_short>((runs + per_batch * WARPS - 1) /
                                           (per_batch * WARPS)),
                     THREADS, 0, st>>>(
          (const float*)values, cols, sort ? (const int*)perm : nullptr,
          sort ? (const int*)at(p.short_list) : nullptr,
          (const unsigned*)totals, (int)n, (int)runs, (float*)out);
  }
  return (int)cudaGetLastError();
}
