// Serve kernel 3: live element and map entry counts of one container per
// batch row.
//
// Replaces hypermerge_tpu/serve/kernels.py::_build_counts (:120-134):
//   at_obj     = lanes_b[OBJ] == qobj[b]
//   n_elems[b] = sum(lanes_b[LIVE] != 0 && at_obj && lanes_b[INSERT] == 1)
//   n_map[b]   = sum(lanes_b[MAPWIN] != 0 && at_obj)
// out[b] = n_elems, out[B + b] = n_map.
//
// counts_kernel, one block per batch row, reads the four lanes it needs
// ([6, N] int32, in place) with int4 loads, four rows a thread (scalar
// loads when N < 4 or the lanes are not 16-byte aligned). Each thread
// packs its two counts into one 64-bit word (n_elems high, n_map low:
// neither exceeds N < 2^31, so the sums never carry across), a warp sums
// them with __shfl_xor_sync, and one shared slot per warp meets the
// block's other warps.
//
// Arguments by value, as serve_order.cu takes them: the batch's lane
// pointers and qobj travel in a `const __grid_constant__` struct
// (params.cuh LaneEntries, 12 bytes an entry; kLaneEntries a launch, 2,048
// under CUDA 12.1 and later, each launch in the smallest of three structs
// that holds its entries), copied from host memory by the entry: no
// upload precedes the launch. A batch above kLaneEntries goes in several
// launches, each writing its own rows of the one output. The entry then
// copies the output into the caller's pinned host buffer and waits for
// the stream: the dispatch's one sync.
//
// What bounds it on the H100: bytes (four of the six lanes read once,
// 16 bytes a row); at serving sizes (B = 8, N = 1,024: 128 KB) the
// launch and the result copy.
#include <cstdint>
#include <cuda_runtime.h>

#include "params.cuh"

namespace {

typedef unsigned long long Word;

constexpr int kMaxThreads = 256;
constexpr int kLive = 0, kObj = 2, kInsert = 3, kMapWin = 5;
constexpr unsigned kFullMask = 0xffffffffu;

// one row's contribution: n_elems in the high word, n_map in the low
__device__ __forceinline__ Word count_row(int live, int obj, int ins, int win,
                                          int qobj) {
  if (obj != qobj) return 0;
  return (static_cast<Word>(live != 0 && ins == 1) << 32) |
         static_cast<Word>(win != 0);
}

// One block per entry e of this launch (batch row b0 + e).
template <int K>
__global__ void __launch_bounds__(kMaxThreads) counts_kernel(
    const __grid_constant__ LaneEntries<K> args, int b0, int B, int N,
    int* out) {
  __shared__ Word warp_sums[kMaxThreads / 32];
  const int e = blockIdx.x;
  const int* lanes = args.lanes[e];
  const int qobj = args.qobj[e];
  const int* live = lanes + kLive * N;
  const int* obj = lanes + kObj * N;
  const int* ins = lanes + kInsert * N;
  const int* win = lanes + kMapWin * N;
  Word sum = 0;
  if (N % 4 == 0 && reinterpret_cast<std::uintptr_t>(lanes) % 16 == 0) {
    for (int i = threadIdx.x; i < N / 4; i += blockDim.x) {
      const int4 l = reinterpret_cast<const int4*>(live)[i];
      const int4 o = reinterpret_cast<const int4*>(obj)[i];
      const int4 s = reinterpret_cast<const int4*>(ins)[i];
      const int4 w = reinterpret_cast<const int4*>(win)[i];
      sum += count_row(l.x, o.x, s.x, w.x, qobj) +
             count_row(l.y, o.y, s.y, w.y, qobj) +
             count_row(l.z, o.z, s.z, w.z, qobj) +
             count_row(l.w, o.w, s.w, w.w, qobj);
    }
  } else {
    for (int i = threadIdx.x; i < N; i += blockDim.x)
      sum += count_row(live[i], obj[i], ins[i], win[i], qobj);
  }
  for (int lane_mask = 16; lane_mask > 0; lane_mask >>= 1)
    sum += __shfl_xor_sync(kFullMask, sum, lane_mask);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    Word total = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x) >> 5; ++w)
      total += warp_sums[w];
    out[b0 + e] = static_cast<int>(total >> 32);
    out[B + b0 + e] = static_cast<int>(total & 0xffffffffu);
  }
}

// counts_kernel over entries [b0, b0 + n) of the batch, n <= K
template <int K>
int launch_counts(const long long* lane_ptrs, const int* qobj, int b0, int n,
                  int B, int N, int* out, cudaStream_t stream) {
  LaneEntries<K> args;
  for (int e = 0; e < n; ++e) {
    args.lanes[e] = reinterpret_cast<const int*>(lane_ptrs[b0 + e]);
    args.qobj[e] = qobj[b0 + e];
  }
  // a thread per int4 of a lane, in whole warps, up to kMaxThreads
  const int want = N / 4 < 32 ? 32 : N / 4;
  const int threads = want < kMaxThreads ? want : kMaxThreads;
  auto kernel = counts_kernel<K>;
  kernel<<<n, threads, 0, stream>>>(args, b0, B, N, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// hm_serve_counts_cap(0): the entries one launch takes at most.
extern "C" int hm_serve_counts_cap(int which) {
  return which == 0 ? kLaneEntries : -1;
}

// lane_ptrs: host int64 [B] (device pointers of [6, N] int32 lanes);
// qobj: host int32 [B]; both read before this returns. N: a power of two.
// per_launch: the entries a launch takes, 0 for the cap
// (hm_serve_counts_cap); a test passes less. out: device int32 [2 * B];
// host_out: host int32 [2 * B], pinned, or null: when given, out is
// copied there and the stream waited on. Returns -1 on bad arguments,
// else the first non-zero CUDA error.
extern "C" int hm_serve_counts(const long long* lane_ptrs, const int* qobj,
                               int B, int N, int per_launch, int* out,
                               int* host_out, void* stream) {
  if (B <= 0 || N < 1 || (N & (N - 1)) != 0) return -1;
  if (per_launch < 0 || per_launch > kLaneEntries) return -1;
  const int chunk = per_launch == 0 ? kLaneEntries : per_launch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc = 0;
  for (int b0 = 0; rc == 0 && b0 < B; b0 += chunk) {
    const int n = B - b0 < chunk ? B - b0 : chunk;
    rc = n <= kSmallLaneEntries
             ? launch_counts<kSmallLaneEntries>(lane_ptrs, qobj, b0, n, B, N,
                                                out, s)
         : n <= kMidLaneEntries
             ? launch_counts<kMidLaneEntries>(lane_ptrs, qobj, b0, n, B, N,
                                              out, s)
             : launch_counts<kLaneEntries>(lane_ptrs, qobj, b0, n, B, N, out,
                                           s);
  }
  if (rc == 0 && host_out != nullptr) {
    const size_t bytes = 2 * static_cast<size_t>(B) * sizeof(int);
    rc = static_cast<int>(
        cudaMemcpyAsync(host_out, out, bytes, cudaMemcpyDeviceToHost, s));
    if (rc == 0) rc = static_cast<int>(cudaStreamSynchronize(s));
  }
  return rc;
}
