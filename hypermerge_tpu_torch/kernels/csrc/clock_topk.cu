// Kernel 7 of the port: the top k docs a query clock dominates.
//
// Replaces hypermerge_tpu/ops/clock_kernels.py::top_k_dominated (:81-91):
//   ok[d]    = all(clocks[d] <= q)
//   score[d] = ok[d] ? sum(min(clocks[d], 1 << 20)) : -1   (int32)
//   (scores, indices) = jax.lax.top_k(score, k)
// lax.top_k orders equal scores lowest index first, so the result is the
// first k of the (score descending, index ascending) order. Capping each
// entry at 2^20 keeps the sum of up to 1,024 actors inside int32, so rows
// of the INT32_INF sentinel rank first instead of wrapping negative; the
// sum still wraps as XLA's int32 sum does for clocks outside that range.
//
// Keys. Each row becomes one 64-bit key: the high word is the score's
// bits XOR 0x7FFFFFFF, so that ascending keys are descending scores over
// every int32 (wrapped negatives and INT32_MIN included), and the low
// word is the row. Keys are unique, the order is total, and the first k
// keys in ascending order are the reference's result. Rows past D get the
// pad key UINT64_MAX, above every real key.
//
// What bounds it on the H100: bytes. The matrix is read once (33.5 MB at
// config 5's [131072, 64]: 0.0100 ms at 3.35 TB/s); the rest is a
// selection over D keys. The first version scored a row per thread (a
// warp's loads 256 bytes apart) and sorted all D pairs in global scratch
// in one block, 153 barrier-separated stages on one SM of 132. Here:
//
//   tile_kernel, one block per tile of T = 1024 rows (128 blocks at
//     config 5: one wave over the card's SMs; T = 2048 would leave half of
//     them idle). G lanes of a warp share a row (G the power of two at or
//     above its 16-byte chunks, at most 32), so neighbouring threads read
//     neighbouring 16-byte addresses; rows whose width is not a multiple
//     of 4 ints are read as ints. The lanes fold their row's `ok` and sum
//     with __shfl_xor_sync, lane 0 writes the key to shared memory, and
//     the block sorts its T keys there (8 KB; the stages with j < 32 on
//     warp shuffles, 25 barriers for 1,024 keys where one per stage took
//     55) and writes its first keep = k_pad keys, k_pad being k rounded
//     up to a power of two, in descending order for odd tiles.
//   merge_kernel, one block, over the tiles x keep candidates (8,192
//     keys, 64 KB of dynamic shared memory at config 5's k = 64). The
//     tiles' runs are sorted, ascending and descending in turn; the block
//     halves them level by level: the elementwise min of an ascending and
//     a descending run holds the keep smallest keys of the two as a
//     bitonic sequence, which log2(keep) stages sort (bitonic_topk in
//     bitonic.cuh). Seven levels of three barriers at config 5 (the min,
//     the stage j = 32, the warp-shuffle stages), where a full sort of the
//     candidates took 70 barrier stages of four times the work. The
//     global top k is a subset of the tiles' top keep, so this is exact.
//
// Large k. When k_pad exceeds T (a tile's run no longer holds its top k)
// or the candidates exceed what one block holds in shared memory, kernel B
// cannot run; k = D is such a case. The caller picks the route
// (hypermerge_tpu_torch/ops/clock_kernels.py topk_plan); this entry checks
// that the select route fits.
// The same tile_kernel then sorts each tile in the direction of the full
// network and writes all T keys to scratch of P keys (the tiles' rows
// rounded up to a power of two); the stages with j >= T run as one launch
// each over the grid (global_stage_kernel), those below T in shared
// memory within each block (shared_stage_kernel), whose last launch
// writes the first k.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

typedef unsigned long long Key;

constexpr int kCap = 1 << 20;
constexpr int kMaxTile = 2048;  // shared keys of tile_kernel (16 KB)
constexpr int kRowsInFlight = 4;  // rows a lane loads before it folds
constexpr int kMaxMergeThreads = 1024;
constexpr long long kMaxMerge = 16384;  // merge_kernel's keys (128 KB)
constexpr int kSelect = 0, kSort = 1;   // the routes
constexpr unsigned kFullMask = 0xffffffffu;
constexpr Key kPad = ~0ull;
constexpr unsigned kScoreFlip = 0x7FFFFFFFu;

__device__ __forceinline__ Key pack_key(int score, long long d) {
  const unsigned hi = static_cast<unsigned>(score) ^ kScoreFlip;
  return (static_cast<Key>(hi) << 32) | static_cast<unsigned>(d);
}

__device__ __forceinline__ void unpack_key(Key key, int* score, int* row) {
  *score = static_cast<int>(static_cast<unsigned>(key >> 32) ^ kScoreFlip);
  *row = static_cast<int>(key & 0xffffffffu);
}

__device__ __forceinline__ void fold(int x, int qc, bool* ok, unsigned* sum) {
  *ok = *ok && x <= qc;
  *sum += static_cast<unsigned>(x < kCap ? x : kCap);  // int32 wrap-around
}

// this lane's part of row d: 16-byte chunks j, j + G, ... when vec, else
// ints j, j + G, ...
__device__ __forceinline__ void row_part(const int* __restrict__ m,
                                         const int* __restrict__ q, long long d,
                                         int A, bool vec, int j, int G, bool* ok,
                                         unsigned* sum) {
  const int* row = m + d * A;
  if (vec) {
    const int4* rv = reinterpret_cast<const int4*>(row);
    const int4* qv = reinterpret_cast<const int4*>(q);
    for (int c = j; c < (A >> 2); c += G) {
      const int4 x = rv[c], y = qv[c];
      fold(x.x, y.x, ok, sum);
      fold(x.y, y.y, ok, sum);
      fold(x.z, y.z, ok, sum);
      fold(x.w, y.w, ok, sum);
    }
  } else {
    for (int c = j; c < A; c += G) fold(row[c], q[c], ok, sum);
  }
}

// One block per tile of T rows. sorted_out == nullptr: the select route
// (ascending sort, the first `keep` keys to cand, odd tiles reversed);
// else the large-k route (the full network's direction, all T keys to
// sorted_out at the tile's offset).
__global__ void tile_kernel(const int* __restrict__ m, long long D, int A,
                            const int* __restrict__ q,
                            bool vec, int G, int T, int keep, Key* cand,
                            Key* sorted_out) {
  __shared__ Key s[kMaxTile];
  const int lane = threadIdx.x & 31;
  const int j = lane % G;
  const int row_in_pass =
      static_cast<int>(threadIdx.x >> 5) * (32 / G) + lane / G;
  const int rows_per_pass = static_cast<int>(blockDim.x) / G;
  const long long row0 = static_cast<long long>(blockIdx.x) * T;
  for (int r0 = 0; r0 < T; r0 += kRowsInFlight * rows_per_pass) {
    bool ok[kRowsInFlight];
    unsigned sum[kRowsInFlight];
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {  // the loads first
      const int r = r0 + u * rows_per_pass + row_in_pass;
      ok[u] = true;
      sum[u] = 0;
      if (r < T && row0 + r < D)
        row_part(m, q, row0 + r, A, vec, j, G, &ok[u], &sum[u]);
    }
#pragma unroll
    for (int u = 0; u < kRowsInFlight; ++u) {
      const int r = r0 + u * rows_per_pass + row_in_pass;
      int okw = ok[u];
      unsigned sw = sum[u];
      for (int o = G >> 1; o > 0; o >>= 1) {  // every lane of the warp
        sw += __shfl_xor_sync(kFullMask, sw, o);
        okw &= __shfl_xor_sync(kFullMask, okw, o);
      }
      if (j == 0 && r < T)
        s[r] = row0 + r < D ? pack_key(okw ? static_cast<int>(sw) : -1, row0 + r)
                            : kPad;
    }
  }
  __syncthreads();
  if (sorted_out == nullptr) {
    shared_bitonic(s, T, 0, 2, T);
    const bool reversed = (blockIdx.x & 1) != 0;
    Key* out = cand + static_cast<long long>(blockIdx.x) * keep;
    for (int i = threadIdx.x; i < keep; i += blockDim.x)
      out[reversed ? keep - 1 - i : i] = s[i];
  } else {
    shared_bitonic(s, T, row0, 2, T);
    for (int i = threadIdx.x; i < T; i += blockDim.x) sorted_out[row0 + i] = s[i];
  }
}

// One block: the n candidates (runs of `keep`, ascending and descending in
// turn) padded to M, reduced to the first run's keep smallest, the first
// k out.
__global__ void merge_kernel(const Key* cand, int n, int M, int keep, int k,
                             int* out_score, int* out_idx) {
  extern __shared__ Key merge_keys[];
  for (int i = threadIdx.x; i < M; i += blockDim.x)
    merge_keys[i] = i < n ? cand[i] : kPad;
  __syncthreads();
  bitonic_topk(merge_keys, M, keep);
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    unpack_key(merge_keys[i], out_score + i, out_idx + i);
}

// the large-k route: one stage (k, j >= T) over the P keys
__global__ void global_stage_kernel(Key* key, long long P, long long k,
                                    long long j) {
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       t < (P >> 1); t += static_cast<long long>(gridDim.x) * blockDim.x)
    global_bitonic_pair(key, t, k, j);
}

// the large-k route: the stages (k, j < T) of each tile in shared memory;
// after the last merge (k == P) the first kout keys go out
__global__ void shared_stage_kernel(Key* key, int T, long long k, long long P,
                                    int kout, int* out_score, int* out_idx) {
  __shared__ Key s[kMaxTile];
  const long long base = static_cast<long long>(blockIdx.x) * T;
  for (int i = threadIdx.x; i < T; i += blockDim.x) s[i] = key[base + i];
  __syncthreads();
  shared_bitonic(s, T, base, k, k);
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    key[base + i] = s[i];
    if (k == P && base + i < kout)
      unpack_key(s[i], out_score + base + i, out_idx + base + i);
  }
}

long long pow2_at_least(long long x) {
  long long p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// m: device [D, A] int32; q: device [A] int32; out_score/out_idx: device
// [k] int32, 0 <= k <= D. tile (a power of two, at most 2048) and threads
// (a multiple of 32) are the launch shape, route 0 the select route and 1
// the large-k route; scratch holds scratch_len int64 keys: tiles x k_pad
// candidates on the select route, P keys on the large-k route
// (hypermerge_tpu_torch/ops/clock_kernels.py topk_plan computes both).
// Returns -1 on bad arguments, else the first non-zero cudaGetLastError().
extern "C" int hm_clock_topk(const int* m, int D, int A, const int* q, int k,
                             int tile, int threads, int route, void* scratch,
                             long long scratch_len, int* out_score, int* out_idx,
                             void* stream) {
  if (D <= 0 || A < 0 || k < 0 || k > D || tile < 1 || tile > kMaxTile ||
      (tile & (tile - 1)) != 0 || threads < 32 || threads % 32 != 0 ||
      (route != kSelect && route != kSort))
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = A % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int units = vec ? A / 4 : A;
  int G = 1;
  while (G < units && G < 32) G <<= 1;
  const long long tiles = (D + tile - 1) / tile;
  const long long k_pad = pow2_at_least(k > 1 ? k : 1);
  const long long M = pow2_at_least(tiles * k_pad);
  Key* key = static_cast<Key*>(scratch);
  if (route == kSelect) {
    if (k_pad > tile || M > kMaxMerge) return -1;
    const int keep = static_cast<int>(k_pad);
    if (scratch_len < tiles * keep) return -1;
    tile_kernel<<<static_cast<unsigned>(tiles), threads, 0, s>>>(
        m, D, A, q, vec, G, tile, keep, key, nullptr);
    int rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
    const int bytes = static_cast<int>(M * sizeof(Key));
    if (bytes > 48 * 1024) {  // dynamic shared memory above the default cap
      rc = static_cast<int>(cudaFuncSetAttribute(
          merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
      if (rc != 0) return rc;
    }
    const int mt = static_cast<int>(
        M / 2 < 32 ? 32 : M / 2 > kMaxMergeThreads ? kMaxMergeThreads : M / 2);
    merge_kernel<<<1, mt, bytes, s>>>(key, static_cast<int>(tiles * keep),
                                       static_cast<int>(M), keep, k, out_score,
                                       out_idx);
    return static_cast<int>(cudaGetLastError());
  }
  // the large-k route: every key sorted across blocks (two tiles at least)
  const long long P = pow2_at_least(tiles * tile);
  if (tiles < 2 || scratch_len < P) return -1;
  tile_kernel<<<static_cast<unsigned>(P / tile), threads, 0, s>>>(
      m, D, A, q, vec, G, tile, 0, nullptr, key);
  int rc = static_cast<int>(cudaGetLastError());
  for (long long kk = 2ll * tile; rc == 0 && kk <= P; kk <<= 1) {
    for (long long j = kk >> 1; rc == 0 && j >= tile; j >>= 1) {
      const long long grid = (P / 2 + threads - 1) / threads;
      global_stage_kernel<<<static_cast<unsigned>(grid), threads, 0, s>>>(
          key, P, kk, j);
      rc = static_cast<int>(cudaGetLastError());
    }
    if (rc != 0) break;
    shared_stage_kernel<<<static_cast<unsigned>(P / tile), threads, 0, s>>>(
        key, tile, kk, P, k, out_score, out_idx);
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}
