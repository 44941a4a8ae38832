// Kernel 5 of the port: the union of many clocks, a column max, and its
// min mode.
//
// Replaces hypermerge_tpu/ops/clock_kernels.py::union_reduce (:56,
// jnp.max(clocks, axis=0)) and the reduce half of ops/clock_mirror.py
// _scatter_max_union (:54-56). The mirror's union() runs it right after
// clock_scatter.cu on the same stream, so a pending flush and the union
// stay two launches with no host sync between them. The min mode is the
// fold of the mesh's pmin (hypermerge_tpu/parallel/sharded.py:360, the
// dominated query across sp ranks) and of every cross-rank fold of
// parallel/sharded.py (`_fold`: [n_ranks, W] partials that ring_gather.cu
// brought together).
//
// m is a [D, A] int32 matrix; out[c] = max (or min) over d of m[d, c],
// folded from the identity of the fold (INT32_MIN for max, INT32_MAX for
// min), so the result equals jnp.max / jnp.min for any int32 input and
// not only for non-negative clocks. Two routes, by D:
//
// - Short matrices (D <= kMinRowsPerBlock, the mesh's folds): the columns
//   route, one launch. Every thread owns its columns and folds all D rows
//   of them, then writes them with a plain store: no fill, no atomics, no
//   shared memory. Where A % 4 == 0 and m is 16-byte aligned, a thread
//   takes four columns with int4 loads (12,500 threads at the pmin's
//   [2, 50000]: 98 blocks of 128 over the 132 SMs); otherwise (an odd A,
//   a view that starts 4 bytes into a buffer) one column with scalar
//   loads.
// - Tall matrices (the mirror's [131072, 64]): two launches. The first
//   sets out to the identity; the second gives each block a chunk of rows
//   and a group of 32-column tiles (blocks are row chunks first, then
//   column groups, up to 1,024 blocks). A block is 8 row lanes x 32 column
//   lanes: for each of its tiles, every thread folds its column over the
//   chunk's rows in steps of 8 (a warp reads 32 neighbouring ints of one
//   row), the 8 partials meet in shared memory, and one thread per column
//   issues one atomicMax (atomicMin) into out.
//
// What bounds it on the H100: bytes for the tall route (it reads the
// matrix once, 33.5 MB at the mirror's capacity, and writes A ints; the
// per-element work is one compare); the launch for the columns route
// (the pmin's fold moves 0.6 MB).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 32;
constexpr int kRowLanes = kThreads / kCols;
constexpr int kMinRowsPerBlock = 64;
constexpr int kMaxBlocks = 1024;
constexpr int kColumnThreads = 128;
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

// The columns route: item i is the int4 of columns [4i, 4i + 4) (kVec) or
// column i; n_items = A / 4 or A.
template <bool kMin, bool kVec>
__global__ void __launch_bounds__(kColumnThreads) columns_kernel(
    const int* m, int D, int A, int n_items, int* out) {
  constexpr int kId = kMin ? kMinNoValue : kNoValue;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n_items;
       i += gridDim.x * blockDim.x) {
    if (kVec) {
      const int4* p = reinterpret_cast<const int4*>(m) + i;
      int4 v = {kId, kId, kId, kId};
#pragma unroll 4
      for (int r = 0; r < D; ++r) {
        const int4 x = p[static_cast<long long>(r) * (A / 4)];
        v.x = fold<kMin>(v.x, x.x);
        v.y = fold<kMin>(v.y, x.y);
        v.z = fold<kMin>(v.z, x.z);
        v.w = fold<kMin>(v.w, x.w);
      }
      reinterpret_cast<int4*>(out)[i] = v;
    } else {
      int v = kId;
#pragma unroll 4
      for (int r = 0; r < D; ++r)
        v = fold<kMin>(v, m[static_cast<long long>(r) * A + i]);
      out[i] = v;
    }
  }
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

template <bool kMin>
int launch_columns(const int* m, int D, int A, int* out, cudaStream_t s) {
  // out comes from the allocator (256-byte aligned); m may be a view
  const bool vec =
      A % 4 == 0 && reinterpret_cast<std::uintptr_t>(m) % 16 == 0 &&
      reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  const int n_items = vec ? A / 4 : A;
  int grid = (n_items + kColumnThreads - 1) / kColumnThreads;
  if (grid > kMaxBlocks) grid = kMaxBlocks;
  auto kernel = vec ? columns_kernel<kMin, true> : columns_kernel<kMin, false>;
  kernel<<<grid, kColumnThreads, 0, s>>>(m, D, A, n_items, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_tall(const int* m, int D, int A, int op, int* out, cudaStream_t s) {
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

}  // namespace

// m: device [D, A] int32; op: 0 max, 1 min; out: device [A] int32. One
// launch when D <= 64 (the columns route), else two. Returns the first
// non-zero cudaGetLastError().
extern "C" int hm_clock_union(const int* m, int D, int A, int op, int* out,
                              void* stream) {
  if (op != kOpMax && op != kOpMin) return 1;  // cudaErrorInvalidValue
  if (D <= 0 || A <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D <= kMinRowsPerBlock)
    return op == kOpMin ? launch_columns<true>(m, D, A, out, s)
                        : launch_columns<false>(m, D, A, out, s);
  return launch_tall(m, D, A, op, out, s);
}
