// Kernel 5 of the port: the union of many clocks, a column max.
//
// Replaces hypermerge_tpu/ops/clock_kernels.py::union_reduce (:56,
// jnp.max(clocks, axis=0)) and the reduce half of ops/clock_mirror.py
// _scatter_max_union (:54-56). The mirror's union() runs it right after
// clock_scatter.cu on the same stream, so a pending flush and the union
// stay two launches with no host sync between them.
//
// m is a [D, A] int32 matrix; out[c] = max over d of m[d, c]. Two launches:
// the first sets out to INT32_MIN, the identity of max, so the result
// equals jnp.max for any int32 input and not only for non-negative clocks;
// the second gives each block a chunk of rows. A block is 8 row lanes x 32
// column lanes: for each 32-column tile, every thread folds its column
// over the chunk's rows in steps of 8 (a warp reads 32 neighbouring ints
// of one row), the 8 partials meet in shared memory, and one thread per
// column issues one atomicMax into out.
//
// What bounds it on the H100: bytes. It reads the matrix once (33.5 MB
// at the mirror's 131072 x 64 capacity) and writes A ints; the per-element
// work is one compare. The atomics are one per column per block.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;
constexpr int kRowLanes = kThreads / kCols;
constexpr int kMinRowsPerBlock = 64;
constexpr int kMaxBlocks = 1024;
constexpr int kNoValue = INT32_MIN;  // max's identity

__global__ void __launch_bounds__(kThreads) fill_kernel(int* out, int A) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < A;
       c += gridDim.x * blockDim.x)
    out[c] = kNoValue;
}

__global__ void __launch_bounds__(kThreads) column_max_kernel(
    const int* m, long long D, int A, long long rows_per_block, int* out) {
  __shared__ int part[kRowLanes][kCols];
  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < D ? r0 + rows_per_block : D;
  for (int c0 = 0; c0 < A; c0 += kCols) {
    const int c = c0 + tx;
    int v = kNoValue;
    if (c < A)
      for (long long r = r0 + ty; r < r1; r += kRowLanes) {
        const int x = m[r * A + c];
        v = x > v ? x : v;
      }
    part[ty][tx] = v;
    __syncthreads();
    if (ty == 0 && c < A) {
      for (int k = 1; k < kRowLanes; ++k) v = part[k][tx] > v ? part[k][tx] : v;
      atomicMax(&out[c], v);
    }
    __syncthreads();
  }
}

}  // namespace

// m: device [D, A] int32; out: device [A] int32. Returns the first
// non-zero cudaGetLastError() of the two launches.
extern "C" int hm_clock_union(const int* m, int D, int A, int* out,
                              void* stream) {
  if (D <= 0 || A <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fill_grid = (A + kThreads - 1) / kThreads;
  fill_kernel<<<fill_grid, kThreads, 0, s>>>(out, A);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  long long grid = (D + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  const long long rows_per_block = (D + grid - 1) / grid;
  const int blocks = static_cast<int>((D + rows_per_block - 1) / rows_per_block);
  column_max_kernel<<<blocks, kThreads, 0, s>>>(m, D, A, rows_per_block, out);
  return static_cast<int>(cudaGetLastError());
}
