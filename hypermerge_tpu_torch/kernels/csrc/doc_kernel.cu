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
//      next-sibling links through the permutation, and the climb's first
//      jump of each row
//   5. the climb to the next sibling by pointer doubling, then Wyllie list
//      ranking
//
// The lanes are read as the host narrowed them for the link (host_args:
// int8, int16 or int32 each): Batch carries each lane's pointer and width,
// and `load` sign-extends an element to int32 (the width is uniform across
// the grid, so the branch is too).
//
// Two routes compute the same bytes in every output lane:
//
// The one-block route (materialize_kernel) runs one block per doc, with a
// __syncthreads() between phases. It serves batches that fill the card
// with docs of a few thousand rows or less: the bulk slab (4096 docs x
// 1024 rows), a mesh rank's slab, live ticks of many short docs. A doc's
// scratch lives in dynamic shared memory (shared_scratch) where it fits
// the card's opt-in limit (N <= 8,192 on an H100), else in global lanes
// (global_scratch); the body is the same, only the lanes' addresses
// differ. A thread's rows are i = tid, tid + threads, ...; where a thread
// has at most kKeepRows of them (N <= 4,096), it decodes each once and
// keeps it in registers across the phases, and the sorts hold four (key,
// row) pairs a thread in registers (bitonic.cuh's blocked_bitonic: only
// the stages across warps go through memory); larger docs sort with
// shared_bitonic_pairs. The clock's atomics go to shared memory too. The
// climb and the ranking take exactly ceil_log2(N) rounds each (a chain
// holds at most N rows, and 2^ceil_log2(N) >= N). Given a wire, the launch
// ends with summary_wire.cuh's wire_doc over the lanes it still holds: the
// bulk slab's whole device program in one launch.
//
// The many-block route serves docs longer than one sort tile when they
// are too few to fill the card, or many enough to make a large batch
// (the live tick of one long doc: at D = 1 the one-block route runs the
// whole doc on one SM of 132). It is a sequence of ordinary launches on
// the stream, each one grid over all D x N rows (or D x (N + 1) chain
// entries, the sink included), so that the launch boundary is the phase
// barrier:
//   init, supersession, rows, element winners; the map sort; its run
//   ends; the sibling keys, their sort, its run ends and first jumps; the
//   climb's rounds; the ranks' init and their rounds.
// Each sort is the bitonic network over (key, row) pairs per doc, run as
// clock_topk.cu's large-k route runs it: every tile of T rows sorted in
// shared memory in the full network's direction (mb_tile_kernel), then
// for k = 2T .. N the stages j >= T one launch each over every doc's
// pairs (mb_stage_kernel) and the stages j < T in shared memory per tile.
// The direction of a compare follows the row's index inside its doc, not
// its place in the batch. The entry picks the route from (D, N) and the
// card (pick_route); `route` forces one (tests, timings).
//
// What bounds it on the H100: the lanes are read and written once (about
// 20 bytes per row as the link narrows them, the wire another 2), so at
// the bulk slab the bytes bound is tens of microseconds at 3.35 TB/s.
// The three bitonic sorts (the wire's included) and the 2 ceil_log2(N)
// doubling rounds are passes over per-doc scratch: on the one-block route
// barriers, shuffles and shared-memory latency bound it (about 60 barriers
// a doc at N = 1,024 over 28.6 KB of shared memory), launches bound the
// many-block route (about 120 at N = 262,144, over 2-3 MB of scratch that
// stays in the 50 MB L2).
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
#include "summary_wire.cuh"

namespace {

constexpr int kPad = 7;
constexpr int kSet = 4;
constexpr int kInc = 6;
constexpr int kMakeList = 1;
constexpr int kMakeText = 2;

// int32 global scratch lanes of N + 2 per doc (ops/crdt_kernels.py
// allocates _DOC_SCRATCH_LANES = kLanes of them)
enum { kOrder, kBest, kFirstChild, kNextSib, kBufA, kBufB, kBufC, kBufD, kLanes };

int ceil_log2(int n) {
  int r = 0;
  while ((1 << r) < n) ++r;
  return r < 1 ? 1 : r;
}

typedef long long Key;

// the input lanes as the link carries them: signed elements of 1, 2 or 4
// bytes (lane k's width in bits 4k .. 4k + 3 of Batch::widths); seq and
// value may be null (zeros, on lean runs)
enum { kSlot, kCtr, kSeq, kObj, kKey, kRef, kValue, kPtgt, kInputLanes };

// the batch as every kernel of both routes sees it (passed by value to
// every launch, so it stays small: the many-block route launches it about
// 120 times a call)
struct Batch {
  const uint8_t* flags;
  const void* lane[kInputLanes];
  int widths;
  int D, N, P, A, K, L, log2n;  // L = N + 2: a scratch lane's length
  uint8_t *dead, *visible, *map_winner, *elem_winner, *elem_live;
  int *rank, *inc_total, *clock, *scratch;
  Key* keys;
};

// element i of input lane `which`, sign-extended
__device__ __forceinline__ int load(const Batch& b, int which, long long i) {
  const void* p = b.lane[which];
  const int width = (b.widths >> (4 * which)) & 15;
  if (width == 1) return static_cast<const int8_t*>(p)[i];
  if (width == 2) return static_cast<const int16_t*>(p)[i];
  return static_cast<const int*>(p)[i];
}

__device__ __forceinline__ int* lane_of(const Batch& b, long long d, int which) {
  return b.scratch + (d * kLanes + which) * b.L;
}

// One doc's scratch, wherever it lives. Lanes whose lives do not overlap
// may share memory (shared_scratch says which): the phases below write
// each only after the last read of what it replaces, a barrier between.
struct Scratch {
  Key* keys;      // [N] the sorts' keys, then the wire's
  int* order;     // [N] the sorts' rows
  int* best;      // [N] the best OpId composite of each element
  int* fc;        // [N + 2] first child by pa (children of i: pa = i + 1)
  int* nsib;      // [N] next sibling
  int* buf[4];    // [N + 1] each: the climb's two buffers, the ranks' two
  int* clock;     // [A] the doc's clock
  uint8_t* dead;  // [N] superseded rows
  uint8_t* mw;    // [N] map winners
  uint8_t* el;    // [N] live elements
};

// Dynamic shared memory at `base` for a doc of N rows, in words:
//   [0, 2N)           keys; then the climb's second buffer; then the wire's keys
//   [2N, 3N + 1)      order; then the ranks' first buffer
//   [3N + 1, 4N + 3)  fc; then the ranks' second buffer
//   [4N + 3, 5N + 3)  best; then nsib
//   [5N + 3, 6N + 4)  the climb's first buffer (sibling_end writes it)
//   [6N + 4, 6N + 4 + kSharedClock)  the clock, where A <= kSharedClock
//   then 3N bytes: dead, mw, el
constexpr int kSharedClock = 256;

__device__ __forceinline__ Scratch shared_scratch(const Batch& b, long long d,
                                                  Key* base) {
  const int N = b.N;
  int* w = reinterpret_cast<int*>(base);
  Scratch s;
  s.keys = base;
  s.buf[1] = w;
  s.order = s.buf[2] = w + 2 * N;
  s.fc = s.buf[3] = w + 3 * N + 1;
  s.best = s.nsib = w + 4 * N + 3;
  s.buf[0] = w + 5 * N + 3;
  s.clock = b.A <= kSharedClock ? w + 6 * N + 4 : b.clock + d * b.A;
  uint8_t* bytes = reinterpret_cast<uint8_t*>(w + 6 * N + 4 + kSharedClock);
  s.dead = bytes;
  s.mw = bytes + N;
  s.el = bytes + 2 * N;
  return s;
}

size_t shared_bytes(int N) {
  const size_t bytes =
      (6 * static_cast<size_t>(N) + 4 + kSharedClock) * sizeof(int) + 3 * N;
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// doc d's lanes of the global scratch; dead, mw and el are the output
// lanes themselves
__device__ __forceinline__ Scratch global_scratch(const Batch& b, long long d) {
  const long long r0 = d << b.log2n;
  Scratch s;
  s.keys = b.keys + r0;
  s.order = lane_of(b, d, kOrder);
  s.best = lane_of(b, d, kBest);
  s.fc = lane_of(b, d, kFirstChild);
  s.nsib = lane_of(b, d, kNextSib);
  for (int k = 0; k < 4; ++k) s.buf[k] = lane_of(b, d, kBufA + k);
  s.clock = b.clock + d * b.A;
  s.dead = b.dead + r0;
  s.mw = b.map_winner + r0;
  s.el = b.elem_live + r0;
  return s;
}

// a row's flags, decoded
enum : unsigned { kValid = 1, kIns = 2, kForest = 4, kValueOp = 8, kIncOp = 16 };

__device__ __forceinline__ unsigned flag_bits(uint8_t f) {
  const int act = f & 7;
  const bool valid = act != kPad;
  const bool ins = ((f >> 3) & 1) && valid;
  unsigned bits = valid ? kValid : 0u;
  if (ins) bits |= kIns;
  if (ins || ((act == kMakeList || act == kMakeText) && valid)) bits |= kForest;
  if ((act <= 3 || act == kSet) && valid) bits |= kValueOp;
  if (act == kInc && valid) bits |= kIncOp;
  return bits;
}

// what the phases read of row g's inputs
struct Row {
  unsigned bits;
  int slot, comp, ref, key;
  int parent;  // an INS row's RGA parent, else -1
  int gid;     // its map group, (obj + 1) * (K + 1) + (key + 1)
};

__device__ __forceinline__ Row decode(const Batch& b, long long g) {
  Row r;
  r.bits = flag_bits(b.flags[g]);
  r.slot = load(b, kSlot, g);
  r.comp = load(b, kCtr, g) * b.A + r.slot + 1;
  r.ref = load(b, kRef, g);
  r.key = load(b, kKey, g);
  const int obj = load(b, kObj, g);
  r.parent = (r.bits & kIns) ? (r.ref == -2 ? obj : r.ref) : -1;
  r.gid = (obj + 1) * (b.K + 1) + (r.key + 1);
  return r;
}

// the element whose winner row i contributes to (N: none); *contrib says
// whether it contributes
__device__ __forceinline__ int element_of(const Row& row, bool vis, int i,
                                          int N, bool* contrib) {
  const bool upd = vis && !(row.bits & kIns) && row.key < 0 && row.ref >= 0;
  const bool own = vis && (row.bits & kIns);
  *contrib = upd || own;
  return upd ? row.ref : (own ? i : N);
}

// -- each phase's work on one row (or entry) i of doc d, shared by the two
// routes: the one-block route loops over a doc's rows between barriers,
// the many-block route over every doc's rows in one launch a phase

// 0. init: dead, inc_total and best of the rows, first_child of the N + 2
// entries, the clock (i < max(N + 2, A))
__device__ __forceinline__ void init_entry(const Batch& b, const Scratch& s,
                                           long long d, int i) {
  if (i < b.N) {
    s.dead[i] = 0;
    b.inc_total[(d << b.log2n) + i] = 0;
    s.best[i] = 0;
  }
  if (i < b.L) s.fc[i] = -1;
  if (i < b.A) s.clock[i] = 0;
}

// 1. supersession by pred edge p (targets outside [0, N) land in the sink)
__device__ __forceinline__ void supersede(const Batch& b, const Scratch& s,
                                          long long d, int p) {
  const int t = load(b, kPtgt, d * b.P + p);
  if (t >= 0 && t < b.N) s.dead[t] = 1;
}

// 2. per-row lanes and scatters; the map sort's (key, row) pair
__device__ __forceinline__ void row_lanes(const Batch& b, const Scratch& s,
                                          long long d, int i, const Row& row) {
  const int N = b.N, A = b.A;
  const long long r0 = d << b.log2n, g = r0 + i;
  const bool vis = (row.bits & kValueOp) && !s.dead[i];
  b.visible[g] = vis;
  if ((row.bits & kIncOp) && row.ref >= 0 && b.lane[kValue]) {
    const int tgt = row.ref < N ? row.ref : N - 1;  // clip(ref, 0, N - 1)
    if (!s.dead[tgt]) atomicAdd(&b.inc_total[r0 + tgt], load(b, kValue, g));
  }
  bool contrib;
  const int eo = element_of(row, vis, i, N, &contrib);
  if (contrib && eo < N) atomicMax(&s.best[eo], row.comp);
  if ((row.bits & kValid) && row.slot >= 0 && row.slot < A)
    atomicMax(&s.clock[row.slot], b.lane[kSeq] ? load(b, kSeq, g) : 0);
  const int gid = vis && row.key >= 0 ? row.gid : 0;
  s.keys[i] = (static_cast<Key>(gid) << 32) | static_cast<unsigned>(row.comp);
  s.order[i] = i;
}

// 3. element winners (best is final after the phase barrier)
__device__ __forceinline__ void element_winner(const Batch& b, const Scratch& s,
                                               long long d, int i,
                                               const Row& row) {
  const int N = b.N;
  const long long g = (d << b.log2n) + i;
  const bool vis = (row.bits & kValueOp) && !s.dead[i];
  bool contrib;
  int eo = element_of(row, vis, i, N, &contrib);
  eo = eo < 0 ? 0 : (eo > N - 1 ? N - 1 : eo);
  const bool live = (row.bits & kIns) && s.best[i] > 0;
  s.el[i] = live;
  b.elem_live[g] = live;
  b.elem_winner[g] = contrib && row.comp == s.best[eo];
}

// 3b. LWW map winners: the last row of each gid run of the sorted doc
__device__ __forceinline__ void map_end(const Batch& b, const Scratch& s,
                                        long long d, int j) {
  const Key* kk = s.keys;
  const int gid = static_cast<int>(kk[j] >> 32);
  const bool last = j == b.N - 1;
  const bool run_end = last || gid != static_cast<int>(kk[j + 1] >> 32);
  s.mw[s.order[j]] = run_end && gid > 0;
}

// 4. the sibling sort's (key, row) pair: parent asc, OpId desc
__device__ __forceinline__ void sibling_key(const Scratch& s, int N, int i,
                                            const Row& row) {
  const long long pa = (row.bits & kForest) ? row.parent + 1 : N + 1;
  s.keys[i] = pa * (1LL << 32) + ((1 << 30) - row.comp);
  s.order[i] = i;
}

// 4b. first-child table and next-sibling links from the sorted doc, and
// the climb's first jump of row order[j] into buf[0] (terminal = N): to
// itself when it has a next sibling, else to its parent (pa - 1)
__device__ __forceinline__ void sibling_end(const Scratch& s, int N, int j) {
  const Key* kk = s.keys;
  const int o = s.order[j];
  const long long pa = kk[j] >> 32;
  const bool run_start = j == 0 || pa != (kk[j - 1] >> 32);
  // the reference also writes index N + 1 (non-forest rows), never read
  if (run_start && pa >= 0 && pa <= N) s.fc[pa] = o;
  const bool same = j < N - 1 && (kk[j + 1] >> 32) == pa;
  s.nsib[o] = same ? s.order[j + 1] : -1;
  s.buf[0][o] = pa > N ? N : (same ? o : (pa >= 1 ? static_cast<int>(pa) - 1 : N));
  if (j == N - 1) s.buf[0][N] = N;
}

// 5. entry i's successor (into succ) and unit rank (into rank) from the
// climb's fixpoint `fix`
__device__ __forceinline__ void rank_start(const Scratch& s, int N, int i,
                                           bool in_forest, const int* fix,
                                           int* succ, int* rank) {
  int nx = N, rk = 0;
  if (i < N && in_forest) {
    const int fc = s.fc[i + 1];
    const int fx = fix[i];
    const int sc = fc != -1 ? fc : (fx < N ? s.nsib[fx] : -1);
    nx = sc == -1 ? N : sc;
    rk = 1;
  }
  succ[i] = nx;
  rank[i] = rk;
}

// -- the one-block route: one block per doc, a barrier between phases ------

constexpr int kMaxThreads = 1024;
constexpr int kKeepRows = 4;  // rows a thread keeps decoded in registers
// shared memory the kernel declares itself (the wire's counts), kept free
// beside the doc's scratch
constexpr size_t kStaticShared = 1024;

int one_block_threads(int N) {
  return N <= 32 * kKeepRows ? 32 : (N / kKeepRows < kMaxThreads ? N / kKeepRows
                                                                 : kMaxThreads);
}

// A thread's rows i = tid, tid + threads, ...: with R > 0 (every row of
// the doc among the first R of some thread) each is decoded once, here,
// and held in registers; with R = 0 each phase decodes its rows again.
template <int R>
struct Rows {
  Row row[R > 0 ? R : 1];

  __device__ __forceinline__ Rows(const Batch& b, long long d) {
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = static_cast<int>(threadIdx.x + r * blockDim.x);
        if (i < b.N) row[r] = decode(b, (d << b.log2n) + i);
      }
    }
  }

  template <class F>
  __device__ __forceinline__ void each(const Batch& b, long long d, F f) {
    if constexpr (R > 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = static_cast<int>(threadIdx.x + r * blockDim.x);
        if (i < b.N) f(i, row[r]);
      }
    } else {
      for (int i = threadIdx.x; i < b.N; i += blockDim.x)
        f(i, decode(b, (d << b.log2n) + i));
    }
  }
};

// the sort of a doc's (keys, order) pairs: four a thread in registers where
// every row is among the first R of a thread, else shared_bitonic_pairs;
// ends with a barrier
template <int R>
__device__ __forceinline__ void sort_rows(const Scratch& s, int N) {
  if (R > 0 && blocked_fits(N))
    blocked_bitonic(PairMem<Key>{s.keys, s.order}, N);
  else
    shared_bitonic_pairs(s.keys, s.order, N, 0, 2, N);
}

// shared: the doc's scratch in dynamic shared memory (shared_bytes(N)),
// else in the global lanes; w.out: the wire, or null for the lanes alone
template <int R>
__global__ void __launch_bounds__(kMaxThreads) materialize_kernel(
    Batch b, int rounds, int shared, Wire w) {
  extern __shared__ Key doc_shared[];
  const long long d = blockIdx.x;
  const long long r0 = d << b.log2n;
  const int N = b.N, tid = threadIdx.x, nt = blockDim.x;
  const Scratch s = shared ? shared_scratch(b, d, doc_shared) : global_scratch(b, d);
  Rows<R> rows(b, d);
  const int W = b.L > b.A ? b.L : b.A;
  for (int i = tid; i < W; i += nt) init_entry(b, s, d, i);
  __syncthreads();
  for (int p = tid; p < b.P; p += nt) supersede(b, s, d, p);
  __syncthreads();
  rows.each(b, d, [&](int i, const Row& row) {
    row_lanes(b, s, d, i, row);
    if (shared) b.dead[r0 + i] = s.dead[i];
  });
  __syncthreads();
  rows.each(b, d, [&](int i, const Row& row) { element_winner(b, s, d, i, row); });
  sort_rows<R>(s, N);
  for (int j = tid; j < N; j += nt) map_end(b, s, d, j);
  __syncthreads();
  rows.each(b, d, [&](int i, const Row& row) { sibling_key(s, N, i, row); });
  __syncthreads();
  sort_rows<R>(s, N);
  for (int j = tid; j < N; j += nt) sibling_end(s, N, j);
  __syncthreads();

  // pointer doubling on double buffers
  int* cur = s.buf[0];
  int* nxt = s.buf[1];
  for (int r = 0; r < rounds; ++r) {
    for (int i = tid; i <= N; i += nt) nxt[i] = cur[cur[i]];
    __syncthreads();
    int* t = cur; cur = nxt; nxt = t;
  }
  // cur = fixpoint; successor lists into the other buffer, ranks into buf[2]
  int* succ_a = nxt;
  int* succ_b = cur;
  int* rank_a = s.buf[2];
  int* rank_b = s.buf[3];
  rows.each(b, d, [&](int i, const Row& row) {
    rank_start(s, N, i, row.bits & kForest, cur, succ_a, rank_a);
  });
  if (tid == 0) rank_start(s, N, N, false, cur, succ_a, rank_a);
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
  const int* rank = rank_a;  // the last round's
  for (int i = tid; i < N; i += nt) {
    b.rank[r0 + i] = rank[i];
    if (shared) b.map_winner[r0 + i] = s.mw[i];
  }
  if (s.clock != b.clock + d * b.A)
    for (int a = tid; a < b.A; a += nt) b.clock[d * b.A + a] = s.clock[a];
  if (w.out != nullptr)
    wire_doc(s.mw, s.el, rank, s.clock,
             reinterpret_cast<unsigned long long*>(s.keys), N, b.A, w, d);
}

int one_block(const Batch& b, bool shared, const Wire& w, cudaStream_t s) {
  const int threads = one_block_threads(b.N);
  const size_t bytes = shared ? shared_bytes(b.N) : 0;
  auto kernel = b.N <= kKeepRows * threads ? materialize_kernel<kKeepRows>
                                           : materialize_kernel<0>;
  if (bytes > 48 * 1024) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
    if (rc != 0) return rc;
  }
  kernel<<<b.D, threads, bytes, s>>>(b, ceil_log2(b.N), shared ? 1 : 0, w);
  return static_cast<int>(cudaGetLastError());
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
// the routes: picked from (D, N) and the card; one block a doc (its
// scratch in shared memory where it fits, else global); the many-block
// route; one block a doc with its scratch in global memory
enum { kRouteAuto, kRouteOneBlock, kRouteManyBlock, kRouteOneBlockGlobal };

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
    init_entry(b, global_scratch(b, x / W), x / W, static_cast<int>(x % W));
}

__global__ void __launch_bounds__(kRowThreads) mb_supersede_kernel(Batch b) {
  for (long long x = first_index(); x < static_cast<long long>(b.D) * b.P;
       x += index_stride())
    supersede(b, global_scratch(b, x / b.P), x / b.P, static_cast<int>(x % b.P));
}

__global__ void __launch_bounds__(kRowThreads) mb_rows_kernel(Batch b) {
  for (long long g = first_index(); g < static_cast<long long>(b.D) * b.N;
       g += index_stride())
    row_lanes(b, global_scratch(b, doc_of(b, g)), doc_of(b, g), row_of(b, g),
              decode(b, g));
}

__global__ void __launch_bounds__(kRowThreads) mb_winners_kernel(Batch b) {
  for (long long g = first_index(); g < static_cast<long long>(b.D) * b.N;
       g += index_stride())
    element_winner(b, global_scratch(b, doc_of(b, g)), doc_of(b, g),
                   row_of(b, g), decode(b, g));
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
    map_end(b, global_scratch(b, doc_of(b, g)), doc_of(b, g), row_of(b, g));
}

__global__ void __launch_bounds__(kRowThreads) mb_sibling_keys_kernel(Batch b) {
  for (long long g = first_index(); g < static_cast<long long>(b.D) * b.N;
       g += index_stride())
    sibling_key(global_scratch(b, doc_of(b, g)), b.N, row_of(b, g),
                decode(b, g));
}

__global__ void __launch_bounds__(kRowThreads) mb_sibling_ends_kernel(Batch b) {
  for (long long g = first_index(); g < static_cast<long long>(b.D) * b.N;
       g += index_stride())
    sibling_end(global_scratch(b, doc_of(b, g)), b.N, row_of(b, g));
}

// The chain kernels run over D x (N + 1) entries, a doc's N rows and its
// sink (entry N): the doc of entry x is x / (N + 1).

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
    const bool in_forest =
        i < b.N && (flag_bits(b.flags[(d << b.log2n) + i]) & kForest);
    rank_start(global_scratch(b, d), b.N, i, in_forest, lane_of(b, d, fix),
               lane_of(b, d, succ), lane_of(b, d, rank));
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
  // the climb on lanes A / B (the sibling ends wrote its first jumps into
  // A), then successors and ranks double-buffered as the one-block route
  // does: succ on the climb's other lane and the fixpoint's, ranks on C / D
  int cur = kBufA, nxt = kBufB;
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

// The card's SM count and the shared memory a block may opt into, of the
// current device; false if either cannot be read.
bool read_card(int* sms, int* optin) {
  int dev = 0;
  return cudaGetDevice(&dev) == 0 &&
         cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev) == 0 &&
         cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                dev) == 0;
}

// The route the entry takes for a batch of D docs of N rows, from (D, N)
// and the card (-1 if it cannot be read). Read off the three routes forced
// over a grid of D in 1 .. 512 and N in 1,024 .. 65,536 on one H100
// (chip_smoke.py's `time_doc_routes`, PERF.md §6). Where a doc's scratch
// fits shared memory (N <= 8,192 there) one block a doc with it there led
// at every shape but a lone doc of 8,192 rows, where the two runs of the
// survey disagreed; so it takes every doc that fits. Where it does not
// fit, the many-block route led while the docs left half the SMs idle or
// more (2 D <= SMs, the live ticks among them), and one block a doc with
// its scratch in global lanes led above (up to 1.8x at [256, 16384]).
int pick_route(int D, int N) {
  int sms = 0, optin = 0;
  if (!read_card(&sms, &optin)) return -1;
  if (shared_bytes(N) + kStaticShared <= static_cast<size_t>(optin))
    return kRouteOneBlock;
  return 2LL * D <= sms ? kRouteManyBlock : kRouteOneBlockGlobal;
}

// the route a launch asked for `route` takes: kRouteOneBlock becomes
// kRouteOneBlockGlobal where a doc does not fit shared memory
int resolve_route(int D, int N, int route) {
  if (D < 1 || N < 1) return -1;
  if (route == kRouteAuto) return pick_route(D, N);
  if (route == kRouteOneBlock) {
    int sms = 0, optin = 0;
    if (!read_card(&sms, &optin)) return -1;
    return shared_bytes(N) + kStaticShared <= static_cast<size_t>(optin)
               ? kRouteOneBlock
               : kRouteOneBlockGlobal;
  }
  return route == kRouteManyBlock || route == kRouteOneBlockGlobal ? route : -1;
}

}  // namespace

// The route hm_materialize takes for D docs of N rows when asked for
// `route` (0 picks from (D, N) and the card): 1 one block a doc with its
// scratch in shared memory, 2 the many-block route, 3 one block a doc with
// its scratch in global memory; -1 on bad arguments or an unreadable card.
extern "C" int hm_doc_route(int D, int N, int route) {
  return resolve_route(D, N, route);
}

// All [D, N] lanes device memory. slot .. ptgt: signed ints of the byte
// widths in `widths` (lane k of slot, ctr, seq, obj, key, ref, value, ptgt
// in bits 4k .. 4k + 3: 1, 2 or 4); seq and value may be null (read as
// zeros). route: as hm_doc_route takes it (tests and timings force one;
// every route gives the same bytes). scratch: int32 [D, kLanes, N + 2] and
// keys: int64 [D, N], for routes 2 and 3 (may be null on route 1). wire:
// the [D, W] uint8 summary wire, written by the one-block route's
// epilogue, laid out by the next six arguments (summary_wire_spec); null
// for the lanes alone. Returns -1 on bad arguments or an unreadable card,
// else the first non-zero CUDA error.
extern "C" int hm_materialize(
    const uint8_t* flags, const void* slot, const void* ctr, const void* seq,
    const void* obj, const void* key, const void* ref, const void* value,
    const void* ptgt, int widths, int D, int N, int P, int A, int K, int route,
    uint8_t* dead, uint8_t* visible, uint8_t* map_winner,
    uint8_t* elem_winner, uint8_t* elem_live, int* rank, int* inc_total,
    int* clock, int* scratch, long long* keys, uint8_t* wire, int mask_bytes,
    int order_bits, int order_bytes, int count_bytes, int W, int lean,
    void* stream) {
  if (D < 1 || N < 1 || (N & (N - 1)) != 0 || P < 0 || A < 0) return -1;
  route = resolve_route(D, N, route);
  if (route < 0) return -1;
  if (route != kRouteOneBlock && (scratch == nullptr || keys == nullptr))
    return -1;
  if (wire != nullptr && route == kRouteManyBlock) return -1;
  for (int k = 0; k < kInputLanes; ++k) {
    const int width = (widths >> (4 * k)) & 15;
    if (width != 1 && width != 2 && width != 4) return -1;
  }
  int log2n = 0;
  while ((1 << log2n) < N) ++log2n;
  const Batch b{flags, {slot, ctr, seq, obj, key, ref, value, ptgt}, widths,
                D, N, P, A, K, N + 2, log2n,
                dead, visible, map_winner, elem_winner, elem_live,
                rank, inc_total, clock, scratch, keys};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteManyBlock) return many_block(b, kTile < N ? kTile : N, s);
  const Wire w{wire, mask_bytes, order_bits, order_bytes, count_bytes, W, lean};
  return one_block(b, route == kRouteOneBlock, w, s);
}
