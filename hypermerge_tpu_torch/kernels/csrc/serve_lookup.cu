// Serve kernel 1: the winner row of one (container, key) per batch row.
//
// Replaces hypermerge_tpu/serve/kernels.py::_build_map_lookup (:87-99):
//   mask[b, i] = lanes_b[MAPWIN, i] != 0 && lanes_b[KEY, i] == qkey[b]
//                && lanes_b[OBJ, i] == qobj[b]
//   row[b]     = jnp.argmax(mask[b])   (lowest match; 0 when none)
//   found[b]   = mask[b].any()
// out[b] = row, out[B + b] = found (0/1).
//
// lookup_kernel, one block per batch row, reads the three lanes it needs
// ([6, N] int32, in place) with int4 loads, four rows a thread (scalar
// loads when N < 4 or the lanes are not 16-byte aligned). Each thread's
// chunks ascend, so it stops at its first match, the smallest row it can
// see; a warp takes the min of its threads' rows with __shfl_xor_sync,
// and one shared slot per warp meets the block's other warps. N stands
// for "no match".
//
// Arguments by value, as serve_counts.cu takes them: the batch's lane
// pointers, qobj and qkey travel in a `const __grid_constant__` struct
// (params.cuh LookupEntries, 16 bytes an entry; kLookupEntries a launch,
// 1,024 under CUDA 12.1 and later, each launch in the smallest of three
// structs that holds its entries), copied from host memory by the entry:
// no upload precedes the launch. A batch above kLookupEntries goes in
// several launches, each writing its own rows of the one output. The
// entry then copies the output into the caller's pinned host buffer and
// waits for the stream: the dispatch's one sync.
//
// What bounds it on the H100: bytes (three of the six lanes read at most
// once, 12 bytes a row); at serving sizes (B = 1, N = 1,024: 12 KB) the
// launch and the result copy.
#include <cstdint>
#include <cuda_runtime.h>

#include "params.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kObj = 2, kKey = 4, kMapWin = 5;
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ bool match(int win, int key, int obj, int qkey,
                                      int qobj) {
  return win != 0 && key == qkey && obj == qobj;
}

// One block per entry e of this launch (batch row b0 + e).
template <int K>
__global__ void __launch_bounds__(kMaxThreads) lookup_kernel(
    const __grid_constant__ LookupEntries<K> args, int b0, int B, int N,
    int* out) {
  __shared__ int warp_rows[kMaxThreads / 32];
  const int e = blockIdx.x;
  const int* lanes = args.lanes[e];
  const int qobj = args.qobj[e], qkey = args.qkey[e];
  const int* obj = lanes + kObj * N;
  const int* key = lanes + kKey * N;
  const int* win = lanes + kMapWin * N;
  int row = N;  // no match
  if (N % 4 == 0 && reinterpret_cast<std::uintptr_t>(lanes) % 16 == 0) {
    for (int i = threadIdx.x; i < N / 4; i += blockDim.x) {
      const int4 w = reinterpret_cast<const int4*>(win)[i];
      const int4 k = reinterpret_cast<const int4*>(key)[i];
      const int4 o = reinterpret_cast<const int4*>(obj)[i];
      if (match(w.x, k.x, o.x, qkey, qobj)) { row = 4 * i; break; }
      if (match(w.y, k.y, o.y, qkey, qobj)) { row = 4 * i + 1; break; }
      if (match(w.z, k.z, o.z, qkey, qobj)) { row = 4 * i + 2; break; }
      if (match(w.w, k.w, o.w, qkey, qobj)) { row = 4 * i + 3; break; }
    }
  } else {
    for (int i = threadIdx.x; i < N; i += blockDim.x) {
      if (match(win[i], key[i], obj[i], qkey, qobj)) { row = i; break; }
    }
  }
  for (int lane_mask = 16; lane_mask > 0; lane_mask >>= 1) {
    const int other = __shfl_xor_sync(kFullMask, row, lane_mask);
    row = other < row ? other : row;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_rows[warp] = row;
  __syncthreads();
  if (threadIdx.x == 0) {
    int best = N;
    for (int w = 0; w < static_cast<int>(blockDim.x) >> 5; ++w)
      best = warp_rows[w] < best ? warp_rows[w] : best;
    out[b0 + e] = best < N ? best : 0;  // argmax of an all-false row is 0
    out[B + b0 + e] = best < N ? 1 : 0;
  }
}

// lookup_kernel over entries [b0, b0 + n) of the batch, n <= K
template <int K>
int launch_lookup(const long long* lane_ptrs, const int* qobj,
                  const int* qkey, int b0, int n, int B, int N, int* out,
                  cudaStream_t stream) {
  LookupEntries<K> args;
  for (int e = 0; e < n; ++e) {
    args.lanes[e] = reinterpret_cast<const int*>(lane_ptrs[b0 + e]);
    args.qobj[e] = qobj[b0 + e];
    args.qkey[e] = qkey[b0 + e];
  }
  // a thread per int4 of a lane, in whole warps, up to kMaxThreads
  const int want = N / 4 < 32 ? 32 : N / 4;
  const int threads = want < kMaxThreads ? want : kMaxThreads;
  auto kernel = lookup_kernel<K>;
  kernel<<<n, threads, 0, stream>>>(args, b0, B, N, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hm_serve_lookup_cap(0): the entries one launch takes at most.
extern "C" int hm_serve_lookup_cap(int which) {
  return which == 0 ? kLookupEntries : -1;
}

// lane_ptrs: host int64 [B] (device pointers of [6, N] int32 lanes);
// qobj, qkey: host int32 [B]; all read before this returns. N: a power of
// two. per_launch: the entries a launch takes, 0 for the cap
// (hm_serve_lookup_cap); a test passes less. out: device int32 [2 * B];
// host_out: host int32 [2 * B], pinned, or null: when given, out is
// copied there and the stream waited on. Returns -1 on bad arguments,
// else the first non-zero CUDA error.
extern "C" int hm_serve_lookup(const long long* lane_ptrs, const int* qobj,
                               const int* qkey, int B, int N, int per_launch,
                               int* out, int* host_out, void* stream) {
  if (B <= 0 || N < 1 || (N & (N - 1)) != 0) return -1;
  if (per_launch < 0 || per_launch > kLookupEntries) return -1;
  const int chunk = per_launch == 0 ? kLookupEntries : per_launch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  for (int b0 = 0; rc == 0 && b0 < B; b0 += chunk) {
    const int n = B - b0 < chunk ? B - b0 : chunk;
    rc = n <= kSmallLookupEntries
             ? launch_lookup<kSmallLookupEntries>(lane_ptrs, qobj, qkey, b0,
                                                  n, B, N, out, s)
         : n <= kMidLookupEntries
             ? launch_lookup<kMidLookupEntries>(lane_ptrs, qobj, qkey, b0, n,
                                                B, N, out, s)
             : launch_lookup<kLookupEntries>(lane_ptrs, qobj, qkey, b0, n, B,
                                             N, out, s);
  }
  if (rc == 0 && host_out != nullptr) {
    const size_t bytes = 2 * static_cast<size_t>(B) * sizeof(int);
    rc = static_cast<int>(
        cudaMemcpyAsync(host_out, out, bytes, cudaMemcpyDeviceToHost, s));
    if (rc == 0) rc = static_cast<int>(cudaStreamSynchronize(s));
  }
  return rc;
}
