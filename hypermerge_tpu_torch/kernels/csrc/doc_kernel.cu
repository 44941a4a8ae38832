// Kernel 1 of the port: batched CRDT materialization.
//
// Replaces hypermerge_tpu/ops/crdt_kernels.py::_doc_kernel and _widen
// (vmapped over docs by batched_kernel). For every document of a [D, N]
// batch it computes, in order:
//   1. the dead mask from pred targets (byte stores; every writer stores 1)
//   2. visible, INC totals (atomicAdd), element winners (atomicMax on the
//      OpId composite), the clock (atomicMax per local slot), sort keys
//   3. LWW map winners: bitonic sort by (gid, ctr, slot), run ends
//   4. RGA sibling sort by (parent asc, OpId desc): first-child table and
//      next-sibling links through the permutation
//   5. the climb to the next sibling by pointer doubling, then Wyllie list
//      ranking, each exactly ceil(log2 N) + 1 rounds on double buffers
//
// Two routes compute the same bytes in every output lane:
//
// The one-block route (materialize_kernel) runs one block per doc, with a
// __syncthreads() between phases. It serves batches that fill the card
// with docs of a tile or less: the bulk slab (4096 docs x 1024 rows), a
// mesh rank's slab, live ticks of many short docs.
//
// The many-block route serves docs longer than one sort tile when they
// are too few to fill the card, or many enough to make a large batch
// (the live tick of one long doc: at D = 1 the one-block route runs the
// whole doc on one SM of 132). It is a sequence of ordinary launches on
// the stream, each one grid over all D x N rows (or D x (N + 1) chain
// entries, the sink included), so that the launch boundary is the phase
// barrier:
//   init, supersession, rows, element winners; the map sort; its run
//   ends; the sibling keys, their sort, its run ends; the climb's
//   init and its rounds; the ranks' init and their rounds.
// Each sort is the bitonic network over (key, row) pairs per doc, run as
// clock_topk.cu's large-k route runs it: every tile of T rows sorted in
// shared memory in the full network's direction (mb_tile_kernel), then
// for k = 2T .. N the stages j >= T one launch each over every doc's
// pairs (mb_stage_kernel) and the stages j < T in shared memory per tile.
// The direction of a compare follows the row's index inside its doc, not
// its place in the batch. The entry picks the route from (D, N) and the
// card's SM count (pick_route); `route` forces one (tests, timings).
//
// What bounds it on the H100: the lanes are read and written once (about
// 40 bytes per row at int32 width), so at the bulk slab the bytes bound
// is tens of microseconds at 3.35 TB/s. The two bitonic sorts (log2 N
// (log2 N + 1) / 2 stages each) and the 2 x (log2 N + 1) doubling rounds
// are passes over per-doc scratch: barriers and scratch latency bound
// the one-block route, launches the many-block route (about 120 at
// N = 262,144, over 2-3 MB of scratch that stays in the 50 MB L2).
// A doc's scratch is a few tens of KB at the slab and stays in L1/L2;
// the sort keys pack each lexsort into one 64-bit key with the row as
// the final tie-break (in the pair), so the unstable bitonic network
// returns the stable order. Moving the one-block route's scratch lanes
// into shared memory is the next speed step for the slab.
//
// Sort key notes (why one 64-bit key per lexsort is exact):
//   - (ctr, slot) order == comp order, comp = ctr * A + slot + 1, because
//     0 <= slot < A; comp < 2^30 (the host checks ctr * A + A < 2^30).
//   - map sort: key = gid << 32 | comp, gid in [0, 2^31).
//   - sibling sort: key = pa * 2^32 + inv, inv = 2^30 - comp in [1, 2^30).
//   - ties in key are broken by row index (bitonic.cuh), as jnp.lexsort's
//     stability does.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 7;
constexpr int kSet = 4;
constexpr int kInc = 6;
constexpr int kMakeList = 1;
constexpr int kMakeText = 2;

// int32 scratch lanes of N + 2 per doc (ops/crdt_kernels.py allocates
// _DOC_SCRATCH_LANES = kLanes of them)
enum { kOrder, kBest, kFirstChild, kNextSib, kBufA, kBufB, kBufC, kBufD, kLanes };

int ceil_log2(int n) {
  int r = 0;
  while ((1 << r) < n) ++r;
  return r < 1 ? 1 : r;
}

typedef long long Key;

// the batch as every kernel of both routes sees it
struct Batch {
  const uint8_t* flags;
  const int *slot, *ctr, *seq, *obj, *key, *ref, *value, *ptgt;
  int D, N, P, A, K, L, log2n;  // L = N + 2: a scratch lane's length
  uint8_t *dead, *visible, *map_winner, *elem_winner, *elem_live;
  int *rank, *inc_total, *clock, *scratch;
  Key* keys;
};

__device__ __forceinline__ int* lane_of(const Batch& b, long long d, int which) {
  return b.scratch + (d * kLanes + which) * b.L;
}

struct Row {
  bool valid, is_ins, in_forest;
  int parent;
};

__device__ __forceinline__ Row decode_row(uint8_t f, int obj, int ref) {
  Row r;
  const int act = f & 7;
  r.valid = act != kPad;
  r.is_ins = ((f >> 3) & 1) && r.valid;
  r.in_forest = r.is_ins || ((act == kMakeList || act == kMakeText) && r.valid);
  r.parent = r.is_ins ? (ref == -2 ? obj : ref) : -1;
  return r;
}

// -- each phase's work on one row (or entry) i of doc d, shared by the two
// routes: the one-block route loops over a doc's rows between barriers,
// the many-block route over every doc's rows in one launch a phase

// 0. init: dead, inc_total and best of the rows, first_child of the N + 2
// entries, the clock (i < max(N + 2, A))
__device__ __forceinline__ void init_entry(const Batch& b, long long d, int i) {
  if (i < b.N) {
    const long long g = (d << b.log2n) + i;
    b.dead[g] = 0;
    b.inc_total[g] = 0;
    lane_of(b, d, kBest)[i] = 0;
  }
  if (i < b.L) lane_of(b, d, kFirstChild)[i] = -1;
  if (i < b.A) b.clock[d * b.A + i] = 0;
}

// 1. supersession by pred edge p (targets outside [0, N) land in the sink)
__device__ __forceinline__ void supersede(const Batch& b, long long d, int p) {
  const int t = b.ptgt[d * b.P + p];
  if (t >= 0 && t < b.N) b.dead[(d << b.log2n) + t] = 1;
}

// 2. per-row lanes and scatters; the map sort's (key, row) pair
__device__ __forceinline__ void row_lanes(const Batch& b, long long d, int i) {
  const int N = b.N, A = b.A;
  const long long r0 = d << b.log2n, g = r0 + i;
  const uint8_t f = b.flags[g];
  const int act = f & 7;
  const Row row = decode_row(f, b.obj[g], b.ref[g]);
  const bool vis = (act <= 3 || act == kSet) && row.valid && !b.dead[g];
  b.visible[g] = vis;
  const int r = b.ref[g], k = b.key[g], sl = b.slot[g];
  const int comp = b.ctr[g] * A + sl + 1;
  if (act == kInc && row.valid && r >= 0 && b.value) {
    const int tgt = r < N ? r : N - 1;  // clip(ref, 0, N - 1)
    if (!b.dead[r0 + tgt]) atomicAdd(&b.inc_total[r0 + tgt], b.value[g]);
  }
  const bool upd = vis && !row.is_ins && k < 0 && r >= 0;
  const bool own = vis && row.is_ins;
  const int eo = upd ? r : (own ? i : N);
  if ((upd || own) && eo < N) atomicMax(&lane_of(b, d, kBest)[eo], comp);
  if (row.valid && sl >= 0 && sl < A)
    atomicMax(&b.clock[d * A + sl], b.seq ? b.seq[g] : 0);
  const int gid = (vis && k >= 0) ? (b.obj[g] + 1) * (b.K + 1) + (k + 1) : 0;
  b.keys[g] = (static_cast<Key>(gid) << 32) | static_cast<unsigned>(comp);
  lane_of(b, d, kOrder)[i] = i;
}

// 3. element winners (best is final after the phase barrier)
__device__ __forceinline__ void element_winner(const Batch& b, long long d,
                                               int i) {
  const int N = b.N;
  const long long g = (d << b.log2n) + i;
  const Row row = decode_row(b.flags[g], b.obj[g], b.ref[g]);
  const bool vis = b.visible[g];
  const int r = b.ref[g];
  const int comp = b.ctr[g] * b.A + b.slot[g] + 1;
  const bool upd = vis && !row.is_ins && b.key[g] < 0 && r >= 0;
  const bool own = vis && row.is_ins;
  int eo = upd ? r : (own ? i : N);
  eo = eo < 0 ? 0 : (eo > N - 1 ? N - 1 : eo);
  const int* best = lane_of(b, d, kBest);
  b.elem_live[g] = row.is_ins && best[i] > 0;
  b.elem_winner[g] = (upd || own) && comp == best[eo];
}

// 3b. LWW map winners: the last row of each gid run of the sorted doc
__device__ __forceinline__ void map_end(const Batch& b, long long d, int j) {
  const long long r0 = d << b.log2n;
  const Key* kk = b.keys + r0;
  const int gid = static_cast<int>(kk[j] >> 32);
  const bool last = j == b.N - 1;
  const bool run_end = last || gid != static_cast<int>(kk[j + 1] >> 32);
  b.map_winner[r0 + lane_of(b, d, kOrder)[j]] = run_end && gid > 0;
}

// 4. the sibling sort's (key, row) pair: parent asc, OpId desc
__device__ __forceinline__ void sibling_key(const Batch& b, long long d, int i) {
  const long long g = (d << b.log2n) + i;
  const Row row = decode_row(b.flags[g], b.obj[g], b.ref[g]);
  const int comp = b.ctr[g] * b.A + b.slot[g] + 1;
  const long long pa = row.in_forest ? row.parent + 1 : b.N + 1;
  b.keys[g] = pa * (1LL << 32) + ((1 << 30) - comp);
  lane_of(b, d, kOrder)[i] = i;
}

// 4b. first-child table and next-sibling links from the sorted doc
__device__ __forceinline__ void sibling_end(const Batch& b, long long d, int j) {
  const int N = b.N;
  const Key* kk = b.keys + (d << b.log2n);
  const int* order = lane_of(b, d, kOrder);
  const long long pa = kk[j] >> 32;
  const bool run_start = j == 0 || pa != (kk[j - 1] >> 32);
  // the reference also writes index N + 1 (non-forest rows), never read
  if (run_start && pa >= 0 && pa <= N) lane_of(b, d, kFirstChild)[pa] = order[j];
  const bool same = j < N - 1 && (kk[j + 1] >> 32) == pa;
  lane_of(b, d, kNextSib)[order[j]] = same ? order[j + 1] : -1;
}

// 5. the climb to the next sibling: entry i's first jump (terminal = N)
__device__ __forceinline__ int climb_start(const Batch& b, long long d, int i) {
  const int N = b.N;
  if (i == N) return N;
  const long long g = (d << b.log2n) + i;
  const Row row = decode_row(b.flags[g], b.obj[g], b.ref[g]);
  if (!row.in_forest) return N;
  return lane_of(b, d, kNextSib)[i] != -1 ? i
                                          : (row.parent >= 0 ? row.parent : N);
}

// entry i's successor (into succ) and unit rank (into rank) from the
// climb's fixpoint `fix`
__device__ __forceinline__ void rank_start(const Batch& b, long long d, int i,
                                           const int* fix, int* succ,
                                           int* rank) {
  const int N = b.N;
  int nx = N, rk = 0;
  if (i < N) {
    const long long g = (d << b.log2n) + i;
    const Row row = decode_row(b.flags[g], b.obj[g], b.ref[g]);
    if (row.in_forest) {
      const int fc = lane_of(b, d, kFirstChild)[i + 1];
      const int fx = fix[i];
      const int sc = fc != -1 ? fc : (fx < N ? lane_of(b, d, kNextSib)[fx] : -1);
      nx = sc == -1 ? N : sc;
      rk = 1;
    }
  }
  succ[i] = nx;
  rank[i] = rk;
}

// -- the one-block route: one block per doc, a barrier between phases ------

__global__ void __launch_bounds__(kThreads) materialize_kernel(Batch b,
                                                               int rounds) {
  const long long d = blockIdx.x;
  const int N = b.N, tid = threadIdx.x, nt = blockDim.x;
  const int W = b.L > b.A ? b.L : b.A;
  for (int i = tid; i < W; i += nt) init_entry(b, d, i);
  __syncthreads();
  for (int p = tid; p < b.P; p += nt) supersede(b, d, p);
  __syncthreads();
  for (int i = tid; i < N; i += nt) row_lanes(b, d, i);
  __syncthreads();
  for (int i = tid; i < N; i += nt) element_winner(b, d, i);
  Key* kk = b.keys + (d << b.log2n);
  int* order = lane_of(b, d, kOrder);
  block_bitonic_sort(kk, order, N);
  for (int j = tid; j < N; j += nt) map_end(b, d, j);
  __syncthreads();
  for (int i = tid; i < N; i += nt) sibling_key(b, d, i);
  __syncthreads();
  block_bitonic_sort(kk, order, N);
  for (int j = tid; j < N; j += nt) sibling_end(b, d, j);
  __syncthreads();

  // pointer doubling on double buffers
  int* cur = lane_of(b, d, kBufA);
  int* nxt = lane_of(b, d, kBufB);
  for (int i = tid; i <= N; i += nt) cur[i] = climb_start(b, d, i);
  __syncthreads();
  for (int r = 0; r < rounds; ++r) {
    for (int i = tid; i <= N; i += nt) nxt[i] = cur[cur[i]];
    __syncthreads();
    int* t = cur; cur = nxt; nxt = t;
  }
  // cur = fixpoint; successor lists into the other buffer, ranks into C
  int* succ_a = nxt;
  int* succ_b = cur;
  int* rank_a = lane_of(b, d, kBufC);
  int* rank_b = lane_of(b, d, kBufD);
  for (int i = tid; i <= N; i += nt) rank_start(b, d, i, cur, succ_a, rank_a);
  __syncthreads();

  // Wyllie list ranking: rank = #nodes from here to the chain end
  for (int r = 0; r < rounds; ++r) {
    for (int i = tid; i <= N; i += nt) {
      const int n = succ_a[i];
      rank_b[i] = rank_a[i] + rank_a[n];
      succ_b[i] = succ_a[n];
    }
    __syncthreads();
    int* t = succ_a; succ_a = succ_b; succ_b = t;
    t = rank_a; rank_a = rank_b; rank_b = t;
  }
  for (int i = tid; i < N; i += nt) b.rank[(d << b.log2n) + i] = rank_a[i];
}

// -- the many-block route: one launch a phase, a grid over every doc -------

constexpr int kRowThreads = 256;
// rows a tile of the many-block sorts: (key, row) pairs in shared memory,
// 12 bytes a row, under the 48 KB a block has without opting in; a test
// build defines a small one, so that a few hundred rows take the global
// stages
#ifndef HM_DOC_TILE
#define HM_DOC_TILE 2048
#endif
constexpr int kTile = HM_DOC_TILE;
static_assert(kTile >= 32 && (kTile & (kTile - 1)) == 0 &&
                  kTile * (sizeof(long long) + sizeof(int)) <= 48 * 1024,
              "HM_DOC_TILE: a power of two of 32 .. 4096 rows");
enum { kRouteAuto, kRouteOneBlock, kRouteManyBlock };

__device__ __forceinline__ long long first_index() {
  return blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
}

__device__ __forceinline__ long long index_stride() {
  return static_cast<long long>(gridDim.x) * blockDim.x;
}

// the doc, and the row in it, of flat row g of the [D, N] batch
__device__ __forceinline__ long long doc_of(const Batch& b, long long g) {
  return g >> b.log2n;
}

__device__ __forceinline__ int row_of(const Batch& b, long long g) {
  return static_cast<int>(g & (b.N - 1));
}

__global__ void __launch_bounds__(kRowThreads) mb_init_kernel(Batch b) {
  const int W = b.L > b.A ? b.L : b.A;
  for (long long x = first_index(); x < static_cast<long long>(b.D) * W;
       x += index_stride())
    init_entry(b, x / W, static_cast<int>(x % W));
}

__global__ void __launch_bounds__(kRowThreads) mb_supersede_kernel(Batch b) {
  for (long long x = first_index(); x < static_cast<long long>(b.D) * b.P;
       x += index_stride())
    supersede(b, x / b.P, static_cast<int>(x % b.P));
}

__global__ void __launch_bounds__(kRowThreads) mb_rows_kernel(Batch b) {
  for (long long g = first_index(); g < static_cast<long long>(b.D) * b.N;
       g += index_stride())
    row_lanes(b, doc_of(b, g), row_of(b, g));
}

__global__ void __launch_bounds__(kRowThreads) mb_winners_kernel(Batch b) {
  for (long long g = first_index(); g < static_cast<long long>(b.D) * b.N;
       g += index_stride())
    element_winner(b, doc_of(b, g), row_of(b, g));
}

// the sort's stages k = k_first .. k_last with j < T over one tile of T
// rows per block (a doc holds N / T tiles), in shared memory
__global__ void __launch_bounds__(1024) mb_tile_kernel(Batch b, int T,
                                                       long long k_first,
                                                       long long k_last) {
  extern __shared__ Key tile_keys[];
  int* tile_rows = reinterpret_cast<int*>(tile_keys + T);
  const long long g0 = static_cast<long long>(blockIdx.x) * T;
  const int i0 = row_of(b, g0);
  int* order = lane_of(b, doc_of(b, g0), kOrder) + i0;
  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    tile_keys[e] = b.keys[g0 + e];
    tile_rows[e] = order[e];
  }
  __syncthreads();
  shared_bitonic_pairs(tile_keys, tile_rows, T, i0, k_first, k_last);
  for (int e = threadIdx.x; e < T; e += blockDim.x) {
    b.keys[g0 + e] = tile_keys[e];
    order[e] = tile_rows[e];
  }
}

// the sort's stage (k, j >= T) over every doc's N / 2 pairs
__global__ void __launch_bounds__(kRowThreads) mb_stage_kernel(Batch b,
                                                               long long k,
                                                               long long j) {
  const int half_log = b.log2n - 1;
  for (long long t = first_index(); t < (static_cast<long long>(b.D) << half_log);
       t += index_stride()) {
    const long long d = t >> half_log, base = d << b.log2n;
    const long long u = t - (d << half_log);  // the pair's index in its doc
    const long long i = ((u & ~(j - 1)) << 1) | (u & (j - 1));
    const long long l = i + j;
    const bool ascending = (i & k) == 0;
    int* order = lane_of(b, d, kOrder);
    exchange_pairs(b.keys + base + i, order + i, b.keys + base + l, order + l,
                   ascending);
  }
}

__global__ void __launch_bounds__(kRowThreads) mb_map_ends_kernel(Batch b) {
  for (long long g = first_index(); g < static_cast<long long>(b.D) * b.N;
       g += index_stride())
    map_end(b, doc_of(b, g), row_of(b, g));
}

__global__ void __launch_bounds__(kRowThreads) mb_sibling_keys_kernel(Batch b) {
  for (long long g = first_index(); g < static_cast<long long>(b.D) * b.N;
       g += index_stride())
    sibling_key(b, doc_of(b, g), row_of(b, g));
}

__global__ void __launch_bounds__(kRowThreads) mb_sibling_ends_kernel(Batch b) {
  for (long long g = first_index(); g < static_cast<long long>(b.D) * b.N;
       g += index_stride())
    sibling_end(b, doc_of(b, g), row_of(b, g));
}

// The chain kernels run over D x (N + 1) entries, a doc's N rows and its
// sink (entry N): the doc of entry x is x / (N + 1).

__global__ void __launch_bounds__(kRowThreads) mb_climb_init_kernel(Batch b,
                                                                    int dst) {
  const int n1 = b.N + 1;
  for (long long x = first_index(); x < static_cast<long long>(b.D) * n1;
       x += index_stride()) {
    const long long d = x / n1;
    const int i = static_cast<int>(x - d * n1);
    lane_of(b, d, dst)[i] = climb_start(b, d, i);
  }
}

// one round of pointer doubling: dst = src[src]
__global__ void __launch_bounds__(kRowThreads) mb_climb_kernel(Batch b, int src,
                                                               int dst) {
  const int n1 = b.N + 1;
  for (long long x = first_index(); x < static_cast<long long>(b.D) * n1;
       x += index_stride()) {
    const long long d = x / n1;
    const int i = static_cast<int>(x - d * n1);
    const int* cur = lane_of(b, d, src);
    lane_of(b, d, dst)[i] = cur[cur[i]];
  }
}

__global__ void __launch_bounds__(kRowThreads) mb_rank_init_kernel(Batch b,
                                                                   int fix,
                                                                   int succ,
                                                                   int rank) {
  const int n1 = b.N + 1;
  for (long long x = first_index(); x < static_cast<long long>(b.D) * n1;
       x += index_stride()) {
    const long long d = x / n1;
    const int i = static_cast<int>(x - d * n1);
    rank_start(b, d, i, lane_of(b, d, fix), lane_of(b, d, succ),
               lane_of(b, d, rank));
  }
}

// one Wyllie round; the last also writes the rank output
__global__ void __launch_bounds__(kRowThreads) mb_rank_kernel(
    Batch b, int succ_src, int succ_dst, int rank_src, int rank_dst,
    int last) {
  const int n1 = b.N + 1;
  for (long long x = first_index(); x < static_cast<long long>(b.D) * n1;
       x += index_stride()) {
    const long long d = x / n1;
    const int i = static_cast<int>(x - d * n1);
    const int* succ = lane_of(b, d, succ_src);
    const int* rk = lane_of(b, d, rank_src);
    const int n = succ[i];
    const int total = rk[i] + rk[n];
    lane_of(b, d, rank_dst)[i] = total;
    lane_of(b, d, succ_dst)[i] = succ[n];
    if (last && i < b.N) b.rank[(d << b.log2n) + i] = total;
  }
}

unsigned grid_for(long long items) {
  const long long blocks = (items + kRowThreads - 1) / kRowThreads;
  return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// The sort of every doc's (keys, order) pairs over tiles of T rows, in
// two steps: every tile sorted in shared memory in the full network's
// direction, then the stages k = 2T .. N (j >= T one launch each over
// every doc's pairs, j < T in shared memory per tile). A pass that reads
// neighbours across tile seams must follow the second step.

int tile_threads(int T) { return T / 2 < 32 ? 32 : (T / 2 > 1024 ? 1024 : T / 2); }

size_t tile_bytes(int T) {
  return static_cast<size_t>(T) * (sizeof(Key) + sizeof(int));
}

int sort_tiles(const Batch& b, int T, cudaStream_t s) {
  const unsigned tiles = static_cast<unsigned>(static_cast<long long>(b.D) * b.N / T);
  mb_tile_kernel<<<tiles, tile_threads(T), tile_bytes(T), s>>>(b, T, 2, T);
  return static_cast<int>(cudaGetLastError());
}

int merge_tiles(const Batch& b, int T, cudaStream_t s) {
  const long long rows = static_cast<long long>(b.D) * b.N;
  const unsigned tiles = static_cast<unsigned>(rows / T);
  int rc = 0;
  for (long long k = 2LL * T; rc == 0 && k <= b.N; k <<= 1) {
    for (long long j = k >> 1; rc == 0 && j >= T; j >>= 1) {
      mb_stage_kernel<<<grid_for(rows / 2), kRowThreads, 0, s>>>(b, k, j);
      rc = static_cast<int>(cudaGetLastError());
    }
    if (rc != 0) break;
    mb_tile_kernel<<<tiles, tile_threads(T), tile_bytes(T), s>>>(b, T, k, k);
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}

int many_block(const Batch& b, int T, cudaStream_t s) {
  const long long rows = static_cast<long long>(b.D) * b.N;
  const long long entries = static_cast<long long>(b.D) * (b.N + 1);
  const long long inits = static_cast<long long>(b.D) * (b.L > b.A ? b.L : b.A);
  mb_init_kernel<<<grid_for(inits), kRowThreads, 0, s>>>(b);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc == 0) {
    mb_supersede_kernel<<<grid_for(static_cast<long long>(b.D) * b.P),
                          kRowThreads, 0, s>>>(b);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0) {
    mb_rows_kernel<<<grid_for(rows), kRowThreads, 0, s>>>(b);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0) {
    mb_winners_kernel<<<grid_for(rows), kRowThreads, 0, s>>>(b);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0) rc = sort_tiles(b, T, s);
  if (rc == 0) rc = merge_tiles(b, T, s);
  if (rc == 0) {
    mb_map_ends_kernel<<<grid_for(rows), kRowThreads, 0, s>>>(b);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0) {
    mb_sibling_keys_kernel<<<grid_for(rows), kRowThreads, 0, s>>>(b);
    rc = static_cast<int>(cudaGetLastError());
  }
  if (rc == 0) rc = sort_tiles(b, T, s);
  if (rc == 0) rc = merge_tiles(b, T, s);
  if (rc == 0) {
    mb_sibling_ends_kernel<<<grid_for(rows), kRowThreads, 0, s>>>(b);
    rc = static_cast<int>(cudaGetLastError());
  }
  // the climb on lanes A / B, then successors and ranks double-buffered
  // as the one-block route does: succ on the climb's other lane and the
  // fixpoint's, ranks on C / D
  int cur = kBufA, nxt = kBufB;
  if (rc == 0) {
    mb_climb_init_kernel<<<grid_for(entries), kRowThreads, 0, s>>>(b, cur);
    rc = static_cast<int>(cudaGetLastError());
  }
  const int rounds = ceil_log2(b.N) + 1;
  for (int round = 0; rc == 0 && round < rounds; ++round) {
    mb_climb_kernel<<<grid_for(entries), kRowThreads, 0, s>>>(b, cur, nxt);
    rc = static_cast<int>(cudaGetLastError());
    const int t = cur;
    cur = nxt;
    nxt = t;
  }
  int succ_a = nxt, succ_b = cur, rank_a = kBufC, rank_b = kBufD;
  if (rc == 0) {
    mb_rank_init_kernel<<<grid_for(entries), kRowThreads, 0, s>>>(b, cur,
                                                                  succ_a,
                                                                  rank_a);
    rc = static_cast<int>(cudaGetLastError());
  }
  for (int round = 0; rc == 0 && round < rounds; ++round) {
    mb_rank_kernel<<<grid_for(entries), kRowThreads, 0, s>>>(
        b, succ_a, succ_b, rank_a, rank_b, round == rounds - 1);
    rc = static_cast<int>(cudaGetLastError());
    int t = succ_a;
    succ_a = succ_b;
    succ_b = t;
    t = rank_a;
    rank_a = rank_b;
    rank_b = t;
  }
  return rc;
}

// The route the entry takes for a batch of D docs of N rows, from (D, N)
// and the SM count of the current device (-1 if it cannot be read). The
// rule is read off both routes forced over a grid of D in 1 .. 512 and N
// in 1,024 .. 65,536 on one H100 (chip_smoke.py's `time_doc_routes`,
// PERF.md §6). Where a doc fits one tile (N <= 2,048) the one-block route
// led at every D but one, where it trailed by a few percent. Above a
// tile the many-block route led wherever the docs left half the SMs idle
// or more (2 D <= SMs) and wherever a batch held 2^22 rows or more; in
// between (D of 128 to 512, under 2^22 rows) the one-block route led by
// up to 26%, and the two tied within 5% at [128, 16384].
int pick_route(int D, int N) {
  if (N <= kTile) return kRouteOneBlock;
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != 0)
    return -1;
  return 2LL * D <= sms || static_cast<long long>(D) * N >= (1LL << 22)
             ? kRouteManyBlock
             : kRouteOneBlock;
}

}  // namespace

extern "C" int hm_doc_route(int D, int N) {
  return D < 1 || N < 1 ? -1 : pick_route(D, N);
}

// All [D, N] lanes device memory; seq and value may be null (read as
// zeros). route: 0 picks from (D, N) (hm_doc_route), 1 the one-block
// route, 2 the many-block route (tests and timings force one; both give
// the same bytes). scratch: int32 [D, kLanes, N + 2]; keys: int64 [D, N].
// Returns -1 on bad arguments or an unreadable SM count, else the first
// non-zero CUDA error.
extern "C" int hm_materialize(
    const uint8_t* flags, const int* slot, const int* ctr, const int* seq,
    const int* obj, const int* key, const int* ref, const int* value,
    const int* ptgt, int D, int N, int P, int A, int K, int route,
    uint8_t* dead, uint8_t* visible, uint8_t* map_winner,
    uint8_t* elem_winner, uint8_t* elem_live, int* rank, int* inc_total,
    int* clock, int* scratch, long long* keys, void* stream) {
  if (D < 1 || N < 1 || (N & (N - 1)) != 0 || P < 0 || A < 0) return -1;
  if (route < kRouteAuto || route > kRouteManyBlock) return -1;
  if (route == kRouteAuto) route = pick_route(D, N);
  if (route < 0) return -1;
  int log2n = 0;
  while ((1 << log2n) < N) ++log2n;
  const Batch b{flags, slot, ctr, seq, obj, key, ref, value, ptgt,
                D, N, P, A, K, N + 2, log2n,
                dead, visible, map_winner, elem_winner, elem_live,
                rank, inc_total, clock, scratch, keys};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteOneBlock) {
    materialize_kernel<<<D, kThreads, 0, s>>>(b, ceil_log2(N) + 1);
    return static_cast<int>(cudaGetLastError());
  }
  return many_block(b, kTile < N ? kTile : N, s);
}
