// Kernel 5 of the port: the union of many clocks, a column max, and its
// min mode.
//
// Replaces hypermerge_tpu/ops/clock_kernels.py::union_reduce (:56,
// jnp.max(clocks, axis=0)) and the reduce half of ops/clock_mirror.py
// _scatter_max_union (:54-56). The mirror's union() runs it right after
// clock_scatter.cu on the same stream, so a pending flush and the union
// stay two launches with no host sync between them. The min mode is the
// fold of the mesh's pmin (hypermerge_tpu/parallel/sharded.py:360, the
// dominated query across sp ranks): parallel/sharded.py runs it over the
// partials that ring_gather.cu brought together.
//
// m is a [D, A] int32 matrix; out[c] = max (or min) over d of m[d, c]. Two
// launches: the first sets out to the identity of the fold (INT32_MIN for
// max, INT32_MAX for min), so the result equals jnp.max / jnp.min for any
// int32 input and not only for non-negative clocks; the second gives each
// block a chunk of rows and a group of 32-column tiles (blocks are row
// chunks first, then column groups, up to 1,024 blocks: a tall matrix such
// as the mirror's splits by rows, a wide one such as the pmin's [2, D]
// partials by columns). A block is 8 row lanes x 32 column lanes: for
// each of its tiles, every thread folds its column over the chunk's rows
// in steps of 8 (a warp reads 32 neighbouring ints of one row), the 8
// partials meet in shared memory, and one thread per column issues one
// atomicMax (atomicMin) into out.
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
constexpr int kMinNoValue = INT32_MAX;  // min's identity
constexpr int kOpMax = 0, kOpMin = 1;

__global__ void __launch_bounds__(kThreads) fill_kernel(int* out, int A,
                                                        int value) {
  for (int c = blockIdx.x * blockDim.x + threadIdx.x; c < A;
       c += gridDim.x * blockDim.x)
    out[c] = value;
}

template <bool kMin>
__device__ __forceinline__ int fold(int a, int b) {
  return kMin ? (b < a ? b : a) : (b > a ? b : a);
}

template <bool kMin>
__global__ void __launch_bounds__(kThreads) column_reduce_kernel(
    const int* m, long long D, int A, long long rows_per_block, int row_blocks,
    int* out) {
  __shared__ int part[kRowLanes][kCols];
  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const int col_groups = gridDim.x / row_blocks;
  const long long r0 = (long long)(blockIdx.x % row_blocks) * rows_per_block;
  const long long r1 = r0 + rows_per_block < D ? r0 + rows_per_block : D;
  for (int c0 = (blockIdx.x / row_blocks) * kCols; c0 < A;
       c0 += col_groups * kCols) {
    const int c = c0 + tx;
    int v = kMin ? kMinNoValue : kNoValue;
    if (c < A)
      for (long long r = r0 + ty; r < r1; r += kRowLanes)
        v = fold<kMin>(v, m[r * A + c]);
    part[ty][tx] = v;
    __syncthreads();
    if (ty == 0 && c < A) {
      for (int k = 1; k < kRowLanes; ++k) v = fold<kMin>(v, part[k][tx]);
      if (kMin)
        atomicMin(&out[c], v);
      else
        atomicMax(&out[c], v);
    }
    __syncthreads();
  }
}

}  // namespace

// m: device [D, A] int32; op: 0 max, 1 min; out: device [A] int32. Returns
// the first non-zero cudaGetLastError() of the two launches.
extern "C" int hm_clock_union(const int* m, int D, int A, int op, int* out,
                              void* stream) {
  if (op != kOpMax && op != kOpMin) return 1;  // cudaErrorInvalidValue
  if (D <= 0 || A <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int fill_grid = (A + kThreads - 1) / kThreads;
  fill_kernel<<<fill_grid, kThreads, 0, s>>>(
      out, A, op == kOpMin ? kMinNoValue : kNoValue);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  long long grid = (D + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  const long long rows_per_block = (D + grid - 1) / grid;
  const int row_blocks =
      static_cast<int>((D + rows_per_block - 1) / rows_per_block);
  const int tiles = (A + kCols - 1) / kCols;
  int col_groups = kMaxBlocks / row_blocks;
  if (col_groups > tiles) col_groups = tiles;
  if (col_groups < 1) col_groups = 1;
  auto kernel = op == kOpMin ? column_reduce_kernel<true>
                             : column_reduce_kernel<false>;
  kernel<<<row_blocks * col_groups, kThreads, 0, s>>>(m, D, A, rows_per_block,
                                                     row_blocks, out);
  return static_cast<int>(cudaGetLastError());
}
