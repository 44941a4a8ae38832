// Kernel 6 of the port: the mirror's batched clock writes, a scatter-max.
//
// Replaces hypermerge_tpu/ops/clock_mirror.py::_scatter_max (:50-51,
// `m.at[r, c].max(v)`) and the scatter half of _scatter_max_union (:54-56).
//
// m is the mirror's resident [cap_d, cap_a] int32 clock matrix, updated in
// place; (rows[i], cols[i], vals[i]) are n pending writes. Each thread
// takes triples with a grid stride and raises its cell with atomicMax, so
// duplicate cells resolve to their largest value whatever order the
// threads run in, and a value below the cell's leaves it as it is. The
// mirror pads the triples to a power of two with (0, 0, 0)
// (_pending_arrays), which is a no-op against a non-negative matrix, as in
// the reference. A triple whose row or column lies outside the matrix is
// dropped, so no write leaves the buffer (the mirror's triples always lie
// inside it).
//
// What bounds it on the H100: the n triples (12 bytes each) and one
// atomic per triple; the matrix is not swept. 1,000 writes are a few
// microseconds of work, so at the mirror's sizes the launch dominates.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

__global__ void __launch_bounds__(kThreads) scatter_max_kernel(
    int* m, long long cap_d, int cap_a, const int* rows, const int* cols,
    const int* vals, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    const int r = rows[i], c = cols[i];
    if (r < 0 || r >= cap_d || c < 0 || c >= cap_a) continue;
    atomicMax(&m[(long long)r * cap_a + c], vals[i]);
  }
}

}  // namespace

// m: device [cap_d, cap_a] int32, updated in place; rows/cols/vals: device
// [n] int32. Returns cudaGetLastError() of the launch.
extern "C" int hm_clock_scatter(int* m, int cap_d, int cap_a, const int* rows,
                                const int* cols, const int* vals, int n,
                                void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const int grid = blocks < kMaxBlocks ? blocks : kMaxBlocks;
  scatter_max_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      m, cap_d, cap_a, rows, cols, vals, n);
  return static_cast<int>(cudaGetLastError());
}
