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
// Two launches. The first gives a thread to a row: it scores the row and
// writes the pair (key = -score as int64, val = row) into scratch of P
// entries, P the power of two at or above D; rows D..P-1 get the key
// INT64_MAX. The second, one block, sorts the P pairs ascending by (key,
// val) with block_bitonic_sort (bitonic.cuh), which breaks ties by val,
// the row index, and writes the first k out. The order is total, so the
// result is unique and equals the reference's.
//
// What bounds it on the H100: the score pass reads the matrix once (bytes),
// but the one-block sort over P pairs in global scratch takes log2(P) *
// (log2(P) + 1) / 2 barrier-separated stages on one SM, which is what this
// simple design pays for exactness; the pairs (12 bytes each, 1.5 MB at
// P = 131072) stay in L2.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSortThreads = 1024;
constexpr int kCap = 1 << 20;
constexpr long long kPadKey = INT64_MAX;

__global__ void __launch_bounds__(kThreads) score_kernel(
    const int* m, int D, int A, const int* q, int P, long long* key,
    int* val) {
  for (int d = blockIdx.x * blockDim.x + threadIdx.x; d < P;
       d += gridDim.x * blockDim.x) {
    long long k = kPadKey;
    if (d < D) {
      const int* row = m + (long long)d * A;
      bool ok = true;
      unsigned sum = 0;  // int32 sum with wrap-around
      for (int c = 0; c < A; ++c) {
        const int x = row[c];
        ok = ok && x <= q[c];
        sum += static_cast<unsigned>(x < kCap ? x : kCap);
      }
      const int score = ok ? static_cast<int>(sum) : -1;
      k = -static_cast<long long>(score);
    }
    key[d] = k;
    val[d] = d;
  }
}

__global__ void __launch_bounds__(kSortThreads) select_kernel(
    long long* key, int* val, int P, int k, int* out_score, int* out_idx) {
  block_bitonic_sort(key, val, P);
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    out_score[i] = static_cast<int>(-key[i]);
    out_idx[i] = val[i];
  }
}

}  // namespace

// m: device [D, A] int32; q: device [A] int32; key/val: device scratch of
// P entries (P a power of two, D <= P); out_score/out_idx: device [k]
// int32, k <= D. Returns the first non-zero cudaGetLastError().
extern "C" int hm_clock_topk(const int* m, int D, int A, const int* q, int k,
                             int P, long long* key, int* val, int* out_score,
                             int* out_idx, void* stream) {
  if (D <= 0 || P < D || (P & (P - 1)) != 0 || k < 0 || k > D) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int score_grid = (P + kThreads - 1) / kThreads;
  score_kernel<<<score_grid, kThreads, 0, s>>>(m, D, A, q, P, key, val);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  int threads = P / 2 < kSortThreads ? P / 2 : kSortThreads;
  if (threads < 32) threads = 32;
  select_kernel<<<1, threads, 0, s>>>(key, val, P, k, out_score, out_idx);
  return static_cast<int>(cudaGetLastError());
}
