// Kernel 1 of the port: batched CRDT materialization, one block per doc.
//
// Replaces hypermerge_tpu/ops/crdt_kernels.py::_doc_kernel and _widen
// (vmapped over docs by batched_kernel). For every document of a [D, N]
// batch it computes, in order, with a __syncthreads() between phases:
//   1. the dead mask from pred targets (byte stores; every writer stores 1)
//   2. visible, INC totals (atomicAdd), element winners (atomicMax on the
//      OpId composite), the clock (atomicMax per local slot), sort keys
//   3. LWW map winners: bitonic sort by (gid, ctr, slot), run ends
//   4. RGA sibling sort by (parent asc, OpId desc): first-child table and
//      next-sibling links through the permutation
//   5. the climb to the next sibling by pointer doubling, then Wyllie list
//      ranking, each exactly ceil(log2 N) + 1 rounds on double buffers
//
// What bounds it on the H100: the lanes are read and written once (about
// 40 bytes per row at int32 width), so at the bulk slab of 4096 docs x 1024
// rows the bytes bound is tens of microseconds at 3.35 TB/s. The two
// bitonic sorts (log2 N (log2 N + 1) / 2 stages each) and the 2 x (log2 N
// + 1) doubling rounds are barrier-separated passes over per-doc scratch,
// so the kernel is bound by block barriers and scratch latency, not by
// device-memory bandwidth. What the design does about it: one block per
// doc keeps every pass block-local (no grid-wide sync, no second launch);
// a doc's scratch is a few tens of KB and stays in L1/L2; the sort keys
// pack each lexsort into one 64-bit key with the row index as the final
// tie-break, so the unstable bitonic network returns the stable order.
// Moving the scratch lanes into shared memory is the next speed step.
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

__device__ __forceinline__ int ceil_log2(int n) {
  int r = 0;
  while ((1 << r) < n) ++r;
  return r < 1 ? 1 : r;
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

__global__ void __launch_bounds__(kThreads) materialize_kernel(
    const uint8_t* __restrict__ flags, const int* __restrict__ slot,
    const int* __restrict__ ctr, const int* __restrict__ seq,
    const int* __restrict__ obj, const int* __restrict__ key,
    const int* __restrict__ ref, const int* __restrict__ value,
    const int* __restrict__ ptgt, int N, int P, int A, int K,
    uint8_t* __restrict__ dead, uint8_t* __restrict__ visible,
    uint8_t* __restrict__ map_winner, uint8_t* __restrict__ elem_winner,
    uint8_t* __restrict__ elem_live, int* __restrict__ rank,
    int* __restrict__ inc_total, int* __restrict__ clock,
    int* __restrict__ scratch, long long* __restrict__ keys) {
  const size_t d = blockIdx.x;
  const size_t r0 = d * (size_t)N;
  flags += r0; slot += r0; ctr += r0; obj += r0; key += r0; ref += r0;
  if (seq) seq += r0;
  if (value) value += r0;
  ptgt += d * (size_t)P;
  dead += r0; visible += r0; map_winner += r0; elem_winner += r0;
  elem_live += r0; rank += r0; inc_total += r0;
  clock += d * (size_t)A;
  const int L = N + 2;
  int* s = scratch + d * (size_t)kLanes * L;
  int* order = s + kOrder * L;
  int* best = s + kBest * L;
  int* first_child = s + kFirstChild * L;
  int* nsib = s + kNextSib * L;
  long long* kk = keys + r0;
  const int tid = threadIdx.x, nt = blockDim.x;

  // -- 0. init ---------------------------------------------------------
  for (int i = tid; i < N; i += nt) {
    dead[i] = 0;
    inc_total[i] = 0;
    best[i] = 0;
  }
  for (int i = tid; i < L; i += nt) first_child[i] = -1;
  for (int a = tid; a < A; a += nt) clock[a] = 0;
  __syncthreads();

  // -- 1. supersession (targets outside [0, N) land in the sink) --------
  for (int p = tid; p < P; p += nt) {
    const int t = ptgt[p];
    if (t >= 0 && t < N) dead[t] = 1;
  }
  __syncthreads();

  // -- 2. per-row lanes and scatters -------------------------------------
  for (int i = tid; i < N; i += nt) {
    const uint8_t f = flags[i];
    const int act = f & 7;
    const Row row = decode_row(f, obj[i], ref[i]);
    const bool vis = (act <= 3 || act == kSet) && row.valid && !dead[i];
    visible[i] = vis;
    const int r = ref[i], k = key[i], sl = slot[i];
    const int comp = ctr[i] * A + sl + 1;
    if (act == kInc && row.valid && r >= 0 && value) {
      const int tgt = r < N ? r : N - 1;  // clip(ref, 0, N - 1)
      if (!dead[tgt]) atomicAdd(&inc_total[tgt], value[i]);
    }
    const bool upd = vis && !row.is_ins && k < 0 && r >= 0;
    const bool own = vis && row.is_ins;
    const int eo = upd ? r : (own ? i : N);
    if ((upd || own) && eo < N) atomicMax(&best[eo], comp);
    if (row.valid && sl >= 0 && sl < A) atomicMax(&clock[sl], seq ? seq[i] : 0);
    const int gid = (vis && k >= 0) ? (obj[i] + 1) * (K + 1) + (k + 1) : 0;
    kk[i] = ((long long)gid << 32) | (unsigned)comp;
    order[i] = i;
  }
  __syncthreads();

  // -- 3. element winners; LWW map winners --------------------------------
  for (int i = tid; i < N; i += nt) {
    const Row row = decode_row(flags[i], obj[i], ref[i]);
    const bool vis = visible[i];
    const int r = ref[i];
    const int comp = ctr[i] * A + slot[i] + 1;
    const bool upd = vis && !row.is_ins && key[i] < 0 && r >= 0;
    const bool own = vis && row.is_ins;
    int eo = upd ? r : (own ? i : N);
    eo = eo < 0 ? 0 : (eo > N - 1 ? N - 1 : eo);
    elem_live[i] = row.is_ins && best[i] > 0;
    elem_winner[i] = (upd || own) && comp == best[eo];
  }
  block_bitonic_sort(kk, order, N);
  for (int j = tid; j < N; j += nt) {
    const int g = (int)(kk[j] >> 32);
    const bool run_end = j == N - 1 || g != (int)(kk[j + 1] >> 32);
    map_winner[order[j]] = run_end && g > 0;
  }
  __syncthreads();

  // -- 4. RGA sibling sort: parent asc, OpId desc ----------------------------
  for (int i = tid; i < N; i += nt) {
    const Row row = decode_row(flags[i], obj[i], ref[i]);
    const int comp = ctr[i] * A + slot[i] + 1;
    const long long pa = row.in_forest ? row.parent + 1 : N + 1;
    kk[i] = pa * (1LL << 32) + ((1 << 30) - comp);
    order[i] = i;
  }
  __syncthreads();
  block_bitonic_sort(kk, order, N);
  for (int j = tid; j < N; j += nt) {
    const long long pa = kk[j] >> 32;
    const bool run_start = j == 0 || pa != (kk[j - 1] >> 32);
    // the reference also writes index N + 1 (non-forest rows), never read
    if (run_start && pa >= 0 && pa <= N) first_child[pa] = order[j];
    const bool same = j < N - 1 && (kk[j + 1] >> 32) == pa;
    nsib[order[j]] = same ? order[j + 1] : -1;
  }
  __syncthreads();

  // -- 5. climb to the next sibling: pointer doubling (terminal = N) -------
  int* cur = s + kBufA * L;
  int* nxt = s + kBufB * L;
  for (int i = tid; i <= N; i += nt) {
    int jmp = N;
    if (i < N) {
      const Row row = decode_row(flags[i], obj[i], ref[i]);
      if (row.in_forest)
        jmp = nsib[i] != -1 ? i : (row.parent >= 0 ? row.parent : N);
    }
    cur[i] = jmp;
  }
  __syncthreads();
  const int rounds = ceil_log2(N) + 1;
  for (int r = 0; r < rounds; ++r) {
    for (int i = tid; i <= N; i += nt) nxt[i] = cur[cur[i]];
    __syncthreads();
    int* t = cur; cur = nxt; nxt = t;
  }
  // cur = fixpoint; successor lists into the other buffer, ranks into C
  int* succ_a = nxt;
  int* succ_b = cur;
  int* rank_a = s + kBufC * L;
  int* rank_b = s + kBufD * L;
  for (int i = tid; i <= N; i += nt) {
    int nx = N, rk = 0;
    if (i < N) {
      const Row row = decode_row(flags[i], obj[i], ref[i]);
      if (row.in_forest) {
        const int fc = first_child[i + 1];
        const int fx = cur[i];
        const int succ = fc != -1 ? fc : (fx < N ? nsib[fx] : -1);
        nx = succ == -1 ? N : succ;
        rk = 1;
      }
    }
    succ_a[i] = nx;
    rank_a[i] = rk;
  }
  __syncthreads();

  // -- Wyllie list ranking: rank = #nodes from here to the chain end -------
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
  for (int i = tid; i < N; i += nt) rank[i] = rank_a[i];
}

}  // namespace

extern "C" int hm_materialize(
    const uint8_t* flags, const int* slot, const int* ctr, const int* seq,
    const int* obj, const int* key, const int* ref, const int* value,
    const int* ptgt, int D, int N, int P, int A, int K, uint8_t* dead,
    uint8_t* visible, uint8_t* map_winner, uint8_t* elem_winner,
    uint8_t* elem_live, int* rank, int* inc_total, int* clock, int* scratch,
    long long* keys, void* stream) {
  materialize_kernel<<<D, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      flags, slot, ctr, seq, obj, key, ref, value, ptgt, N, P, A, K, dead,
      visible, map_winner, elem_winner, elem_live, rank, inc_total, clock,
      scratch, keys);
  return static_cast<int>(cudaGetLastError());
}
