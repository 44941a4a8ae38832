// Serve kernel 2: the element order of one list/text container per batch
// row.
//
// Replaces hypermerge_tpu/serve/kernels.py::_build_seq_order (:102-117):
//   mask[b, i] = lanes_b[LIVE, i] != 0 && lanes_b[OBJ, i] == qobj[b]
//                && lanes_b[INSERT, i] == 1
//   key[b, i]  = mask ? -lanes_b[RANK, i] : INT32_MAX   (int32, wraps)
//   order[b]   = jnp.argsort(key[b])   (stable)
//   count[b]   = mask[b].sum()
// out[b * N + i] = order[b, i], out[B * N + b] = count[b].
//
// Keys. A row whose key is below INT32_MAX (the head) becomes one 64-bit
// key: the high word is the key's bits XOR 0x80000000, so that unsigned
// order is int32 order (INT32_MIN and wrapped negations included), the
// low word is the row. Keys are unique and the order total: ascending
// key, then ascending row, the stable argsort's. Every other row has key
// INT32_MAX, the largest, so the stable order puts them last in row order
// (the tail): they are written straight to their place, and only the head
// is sorted. The split is on the key, not on the mask: a live row of rank
// -2^31 + 1 has key INT32_MAX and goes to the tail; count stays the sum
// of the mask.
//
// order_kernel, one block per batch row, walks the rows in chunks of its
// threads from the last chunk to the first. Warp ballots and __popc give
// each row the number of head and of tail rows behind it (one barrier a
// chunk; the warps' counts double-buffered in shared memory): a tail row
// goes to position N - 1 - (tail rows behind it), a head key to slot
// (head rows behind it) of the key array, any unique slot being as good
// since the sort orders them. Then the H head keys, padded with ~0 to P =
// next_pow2(H), are sorted with shared_bitonic (bitonic.cuh: the stages
// j < 32 on warp shuffles, one barrier a larger stage), and their rows
// written to [0, H).
//
// Where the keys live. In dynamic shared memory while the bucket holds at
// most kSharedKeys rows (16,384 keys, 128 KB: the largest power of two of
// 8-byte keys under the 227 KB a block may take). A larger bucket writes
// its head keys to global scratch; a head of at most kSharedKeys keys is
// then sorted in shared memory all the same, a larger one on the global
// route, as clock_topk.cu's large-k route runs it: each tile of
// kSharedKeys keys sorted in shared memory in the full network's
// direction (tile_kernel), the stages j >= kSharedKeys one launch each
// over every row's pairs (global_stage_kernel, global_bitonic_pair), those
// below in shared memory per tile (shared_stage_kernel). Each row runs
// the network of its own P: the launches span the bucket, and a row whose
// P is smaller skips them (the stages above a sorted P are no-ops).
//
// Arguments by value. The batch's lane pointers and qobj travel in a
// `const __grid_constant__` struct (12 bytes an entry; kEntries entries a
// launch, 2,048 under CUDA 12.1 and later, each launch in the smallest of
// three structs that holds its entries), copied from host memory by
// the entry: no upload precedes the launch. A batch above kEntries goes in
// several launches, each writing its own rows of the one output. The
// entry then copies the output into the caller's pinned host buffer and
// waits for the stream: the dispatch's one sync.
//
// What bounds it on the H100: barriers and operations on one SM per batch
// row. At the read mix's B = 1, N = 1024 the block reads 16 KB of lanes
// and sorts the head: 25 barriers for 1,024 keys (one per stage: 55).
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"
#include "params.cuh"

namespace {

typedef unsigned long long Key;

constexpr int kMaxThreads = 1024;
constexpr int kSharedKeys = 16384;  // 128 KB of dynamic shared memory
constexpr int kStageThreads = 256;
constexpr long long kMaxStageBlocks = 4096;
constexpr int kLive = 0, kRank = 1, kObj = 2, kInsert = 3;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr unsigned kKeyFlip = 0x80000000u;
constexpr Key kPad = ~0ull;
constexpr int kOtherParamBytes = 64;  // the kernel's other parameters

// the entries of the three structs (params.cuh): the most one launch
// takes (the largest power of two whose struct fits beside the other
// parameters: 2,048 under CUDA 12.1 and later, 256 under the old
// 4,096-byte limit), the middle one (1,024) and the small one (64)
constexpr int kEntries = pow2_floor((kMaxParamBytes - kOtherParamBytes) / 12);
constexpr int kMidEntries = pow2_floor((kMidParamBytes - kOtherParamBytes) / 12);
constexpr int kSmallEntries = 64 < kMidEntries ? 64 : kMidEntries;

template <int K>
struct Entries {
  const int* lanes[K];
  int qobj[K];
};
static_assert(sizeof(Entries<kEntries>) + kOtherParamBytes <= kMaxParamBytes,
              "the entries exceed one launch's parameters");

__device__ __forceinline__ Key pack_key(int key, int row) {
  return (static_cast<Key>(static_cast<unsigned>(key) ^ kKeyFlip) << 32) |
         static_cast<unsigned>(row);
}

__device__ __forceinline__ int row_of(Key key) {
  return static_cast<int>(key & 0xffffffffu);
}

__device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// One block per entry e of this launch (batch row b0 + e). gkeys: the
// launch's [entries, N] keys when N > shared_keys, else unused; heads: the
// entries' head sizes for the global route, or null.
template <int K>
__global__ void __launch_bounds__(kMaxThreads) order_kernel(
    const __grid_constant__ Entries<K> args, int b0, int B, int N,
    int shared_keys, Key* gkeys, int* heads, int* out) {
  extern __shared__ Key order_keys[];
  __shared__ int warp_counts[2][32];  // (heads << 16) | tails, per warp
  __shared__ int live_count;
  const int e = blockIdx.x;
  const int* lanes = args.lanes[e];
  const int qobj = args.qobj[e];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = static_cast<int>(blockDim.x) >> 5;
  const unsigned behind = lane == 31 ? 0u : kFullMask << (lane + 1);
  Key* keys = N <= shared_keys ? order_keys
                               : gkeys + static_cast<long long>(e) * N;
  int* order = out + static_cast<long long>(b0 + e) * N;
  if (threadIdx.x == 0) live_count = 0;
  int heads_behind = 0, tails_behind = 0, lives = 0;
  int parity = 0;
  const int threads = static_cast<int>(blockDim.x);
  for (int c0 = (N - 1) / threads * threads; c0 >= 0;
       c0 -= threads, parity ^= 1) {
    const int i = c0 + static_cast<int>(threadIdx.x);
    bool live = false;
    int key = INT32_MAX;
    if (i < N) {
      live = lanes[kLive * N + i] != 0 && lanes[kObj * N + i] == qobj &&
             lanes[kInsert * N + i] == 1;
      // -rank with int32 wrap-around, as XLA negates
      if (live)
        key = static_cast<int>(0u - static_cast<unsigned>(lanes[kRank * N + i]));
    }
    const bool head = key != INT32_MAX;
    const bool tail = i < N && !head;
    const unsigned hb = __ballot_sync(kFullMask, head);
    const unsigned tb = __ballot_sync(kFullMask, tail);
    lives += __popc(__ballot_sync(kFullMask, live));
    if (lane == 0) warp_counts[parity][warp] = (__popc(hb) << 16) | __popc(tb);
    __syncthreads();
    int later = 0, all = 0;
    for (int w = 0; w < warps; ++w) {
      const int v = warp_counts[parity][w];
      all += v;
      if (w > warp) later += v;
    }
    if (head)
      keys[heads_behind + (later >> 16) + __popc(hb & behind)] = pack_key(key, i);
    if (tail)
      order[N - 1 - tails_behind - (later & 0xffff) - __popc(tb & behind)] = i;
    heads_behind += all >> 16;
    tails_behind += all & 0xffff;
  }
  if (lane == 0 && lives != 0) atomicAdd(&live_count, lives);
  __syncthreads();
  const int H = heads_behind;
  const int P = pow2_at_least(H);
  if (heads != nullptr && threadIdx.x == 0) heads[e] = H;
  if (P <= shared_keys) {
    if (keys != order_keys)
      for (int i = threadIdx.x; i < H; i += blockDim.x) order_keys[i] = keys[i];
    for (int i = H + threadIdx.x; i < P; i += blockDim.x) order_keys[i] = kPad;
    __syncthreads();
    if (P > 1) shared_bitonic(order_keys, P, 0, 2, P);
    for (int i = threadIdx.x; i < H; i += blockDim.x)
      order[i] = row_of(order_keys[i]);
  } else {  // the global route sorts it
    for (int i = H + threadIdx.x; i < P; i += blockDim.x) keys[i] = kPad;
  }
  if (threadIdx.x == 0)
    out[static_cast<long long>(B) * N + b0 + e] = live_count;
}

// The global route. Block x holds tile x % (N / T) of entry x / (N / T);
// it takes part while the entry's head exceeds T and reaches the tile.

// the stages k = 2 .. T of each tile, in the full network's direction
__global__ void __launch_bounds__(kMaxThreads) tile_kernel(Key* gkeys,
                                                           const int* heads,
                                                           int N, int T) {
  extern __shared__ Key tile_keys[];
  const int tiles = N / T;
  const int e = blockIdx.x / tiles;
  const long long base = static_cast<long long>(blockIdx.x % tiles) * T;
  const int P = pow2_at_least(heads[e]);
  if (P <= T || base >= P) return;
  Key* row = gkeys + static_cast<long long>(e) * N;
  for (int i = threadIdx.x; i < T; i += blockDim.x) tile_keys[i] = row[base + i];
  __syncthreads();
  shared_bitonic(tile_keys, T, base, 2, T);
  for (int i = threadIdx.x; i < T; i += blockDim.x) row[base + i] = tile_keys[i];
}

// one stage (k, j >= T) over the pairs of every entry whose network
// reaches k
__global__ void global_stage_kernel(Key* gkeys, const int* heads, int entries,
                                    int N, long long k, long long j) {
  const long long half = N >> 1;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       t < entries * half; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int e = static_cast<int>(t / half);
    const int P = pow2_at_least(heads[e]);
    if (k > P || t % half >= P / 2) continue;
    global_bitonic_pair(gkeys + static_cast<long long>(e) * N, t % half, k, j);
  }
}

// the stages (k, j < T) of each tile; at k == P the tile's head rows go out
__global__ void __launch_bounds__(kMaxThreads) shared_stage_kernel(
    Key* gkeys, const int* heads, int b0, int N, int T, long long k, int* out) {
  extern __shared__ Key stage_keys[];
  const int tiles = N / T;
  const int e = blockIdx.x / tiles;
  const long long base = static_cast<long long>(blockIdx.x % tiles) * T;
  const int H = heads[e];
  const int P = pow2_at_least(H);
  if (k > P || P <= T || base >= P) return;
  Key* row = gkeys + static_cast<long long>(e) * N;
  for (int i = threadIdx.x; i < T; i += blockDim.x) stage_keys[i] = row[base + i];
  __syncthreads();
  shared_bitonic(stage_keys, T, base, k, k);
  int* order = out + static_cast<long long>(b0 + e) * N;
  for (int i = threadIdx.x; i < T; i += blockDim.x) {
    if (k < P)
      row[base + i] = stage_keys[i];
    else if (base + i < H)
      order[base + i] = row_of(stage_keys[i]);
  }
}

// dynamic shared memory above the default 48 KB, raised per kernel
template <class F>
int allow_shared(F kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// order_kernel over entries [b0, b0 + n) of the batch, n <= K
template <int K>
int launch_order(const long long* lane_ptrs, const int* qobj, int b0, int n,
                 int B, int N, int shared_keys, Key* gkeys, int* heads,
                 int* out, cudaStream_t stream) {
  Entries<K> args;
  for (int e = 0; e < n; ++e) {
    args.lanes[e] = reinterpret_cast<const int*>(lane_ptrs[b0 + e]);
    args.qobj[e] = qobj[b0 + e];
  }
  const int threads = N < 32 ? 32 : N < kMaxThreads ? N : kMaxThreads;
  const int bytes =
      static_cast<int>((N < shared_keys ? N : shared_keys) * sizeof(Key));
  auto kernel = order_kernel<K>;
  const int rc = allow_shared(kernel, bytes);
  if (rc != 0) return rc;
  kernel<<<n, threads, bytes, stream>>>(args, b0, B, N, shared_keys, gkeys,
                                        heads, out);
  return static_cast<int>(cudaGetLastError());
}

// the global route over the n entries of one launch
int launch_global(Key* gkeys, const int* heads, int b0, int n, int N, int T,
                  int* out, cudaStream_t stream) {
  const int threads = T / 2 < 32 ? 32 : T / 2 < kMaxThreads ? T / 2 : kMaxThreads;
  const int blocks = n * (N / T);
  const int bytes = static_cast<int>(T * sizeof(Key));
  int rc = allow_shared(tile_kernel, bytes);
  if (rc == 0) rc = allow_shared(shared_stage_kernel, bytes);
  if (rc != 0) return rc;
  tile_kernel<<<blocks, threads, bytes, stream>>>(gkeys, heads, N, T);
  rc = static_cast<int>(cudaGetLastError());
  const long long pairs = static_cast<long long>(n) * (N / 2);
  const long long want = (pairs + kStageThreads - 1) / kStageThreads;
  const int grid = static_cast<int>(want < kMaxStageBlocks ? want : kMaxStageBlocks);
  for (long long k = 2ll * T; rc == 0 && k <= N; k <<= 1) {
    for (long long j = k >> 1; rc == 0 && j >= T; j >>= 1) {
      global_stage_kernel<<<grid, kStageThreads, 0, stream>>>(gkeys, heads, n,
                                                              N, k, j);
      rc = static_cast<int>(cudaGetLastError());
    }
    if (rc != 0) break;
    shared_stage_kernel<<<blocks, threads, bytes, stream>>>(gkeys, heads, b0, N,
                                                            T, k, out);
    rc = static_cast<int>(cudaGetLastError());
  }
  return rc;
}

}  // namespace

// hm_serve_order_cap(0): the entries one launch takes at most;
// hm_serve_order_cap(1): the most keys sorted in shared memory.
extern "C" int hm_serve_order_cap(int which) {
  return which == 0 ? kEntries : kSharedKeys;
}

// lane_ptrs: host int64 [B] (device pointers of [6, N] int32 lanes);
// qobj: host int32 [B]; both read before this returns. N: a power of two.
// per_launch (the entries a launch takes) and shared_keys (the most keys
// sorted in shared memory, a power of two): 0 for their caps
// (hm_serve_order_cap); a test passes less. scratch: device memory of
// scratch_len int64 words, at least m * N + m with m = min(B, per_launch),
// when N > shared_keys; else unused (may be null). out: device int32
// [B * N + B]; host_out: host int32 [B * N + B], pinned, or null: when
// given, out is copied there and the stream waited on. Returns -1 on bad
// arguments, else the first non-zero CUDA error.
extern "C" int hm_serve_order(const long long* lane_ptrs, const int* qobj,
                              int B, int N, int per_launch, int shared_keys,
                              void* scratch, long long scratch_len, int* out,
                              int* host_out, void* stream) {
  if (B <= 0 || N < 2 || (N & (N - 1)) != 0) return -1;
  if (per_launch < 0 || per_launch > kEntries) return -1;
  const int chunk = per_launch == 0 ? kEntries : per_launch;
  const int T = shared_keys == 0 ? kSharedKeys : shared_keys;
  if (T < 2 || T > kSharedKeys || (T & (T - 1)) != 0) return -1;
  const int m = B < chunk ? B : chunk;
  const bool global = N > T;
  Key* gkeys = static_cast<Key*>(scratch);
  int* heads = nullptr;
  if (global) {
    if (scratch == nullptr || scratch_len < static_cast<long long>(m) * N + m)
      return -1;
    heads = reinterpret_cast<int*>(gkeys + static_cast<long long>(m) * N);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  for (int b0 = 0; rc == 0 && b0 < B; b0 += chunk) {
    const int n = B - b0 < chunk ? B - b0 : chunk;
    rc = n <= kSmallEntries
             ? launch_order<kSmallEntries>(lane_ptrs, qobj, b0, n, B, N, T,
                                           gkeys, heads, out, s)
         : n <= kMidEntries
             ? launch_order<kMidEntries>(lane_ptrs, qobj, b0, n, B, N, T,
                                         gkeys, heads, out, s)
             : launch_order<kEntries>(lane_ptrs, qobj, b0, n, B, N, T, gkeys,
                                      heads, out, s);
    if (rc == 0 && global)
      rc = launch_global(gkeys, heads, b0, n, N, T, out, s);
  }
  if (rc == 0 && host_out != nullptr) {
    const size_t bytes = (static_cast<size_t>(B) * N + B) * sizeof(int);
    rc = static_cast<int>(
        cudaMemcpyAsync(host_out, out, bytes, cudaMemcpyDeviceToHost, s));
    if (rc == 0) rc = static_cast<int>(cudaStreamSynchronize(s));
  }
  return rc;
}
