// Serve kernel 2: the element order of one list/text container per batch
// row.
//
// Replaces hypermerge_tpu/serve/kernels.py::_build_seq_order (:102-117):
//   mask[b, i] = lanes_b[LIVE, i] != 0 && lanes_b[OBJ, i] == qobj[b]
//                && lanes_b[INSERT, i] == 1
//   key[b, i]  = mask ? -lanes_b[RANK, i] : INT32_MAX   (int32, wraps)
//   order[b]   = jnp.argsort(key[b])   (stable)
//   count[b]   = mask[b].sum()
//
// `args` holds the B lane pointers ([6, N] int32 each, read in place,
// N a power of two), then qobj [B], as int64. One block per batch row:
// its threads write the N (key, row) pairs, then sort them ascending by
// (key, row) with block_bitonic_sort (bitonic.cuh). Ties go by row, so
// the order is total and equals the stable argsort. The pairs sit in
// shared memory up to kSharedRows rows (16 KB), in the caller's global
// scratch ([B, 2, N] int32) above that: a 65,536-row doc is a legal
// bucket. All N positions of the order are written, then the count.
// out[b * N + i] = order[b, i], out[B * N + b] = count[b].
//
// What bounds it on the H100: operations and barriers. The sort takes
// log2(N) * (log2(N) + 1) / 2 barrier-separated stages on one SM per
// batch row; the bytes (three lanes in, one out: 16 bytes a row) are
// small beside that.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSharedRows = 2048;
constexpr int kLive = 0, kRank = 1, kObj = 2, kInsert = 3;

__global__ void __launch_bounds__(kMaxThreads) order_kernel(
    const long long* args, int B, int N, int* scratch, int* out) {
  const int b = blockIdx.x;
  const int* lanes = reinterpret_cast<const int*>(args[b]);
  const int qobj = static_cast<int>(args[B + b]);
  __shared__ int s_key[kSharedRows];
  __shared__ int s_val[kSharedRows];
  __shared__ int count;
  int* key = s_key;
  int* val = s_val;
  if (N > kSharedRows) {
    key = scratch + static_cast<long long>(b) * 2 * N;
    val = key + N;
  }
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  int mine = 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const bool live = lanes[kLive * N + i] != 0 &&
                      lanes[kObj * N + i] == qobj &&
                      lanes[kInsert * N + i] == 1;
    // -rank with int32 wrap-around, as XLA negates
    key[i] = live ? static_cast<int>(
                        0u - static_cast<unsigned>(lanes[kRank * N + i]))
                  : INT32_MAX;
    val[i] = i;
    mine += live;
  }
  atomicAdd(&count, mine);
  __syncthreads();
  block_bitonic_sort(key, val, N);
  int* order = out + static_cast<long long>(b) * N;
  for (int i = threadIdx.x; i < N; i += blockDim.x) order[i] = val[i];
  if (threadIdx.x == 0) out[static_cast<long long>(B) * N + b] = count;
}

}  // namespace

// args: device int64 [2 * B] (B lane pointers, qobj); scratch: device
// int32 [B, 2, N] when N > kSharedRows, else unused (may be null); out:
// device int32 [B * N + B]. Returns the first non-zero cudaGetLastError().
extern "C" int hm_serve_order(const long long* args, int B, int N,
                              int* scratch, int* out, void* stream) {
  if (B <= 0 || N < 2 || (N & (N - 1)) != 0) return -1;
  if (N > kSharedRows && scratch == nullptr) return -1;
  const int threads = N / 2 < kMaxThreads ? N / 2 : kMaxThreads;
  order_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, B, N, scratch, out);
  return static_cast<int>(cudaGetLastError());
}
