// Kernel 6 of the port: the mirror's batched clock writes, a scatter-max.
//
// Replaces hypermerge_tpu/ops/clock_mirror.py::_scatter_max (:50-51,
// `m.at[r, c].max(v)`) and the scatter half of _scatter_max_union (:54-56).
//
// m is the mirror's resident [cap_d, cap_a] int32 clock matrix, updated in
// place; (rows[i], cols[i], vals[i]) are n pending writes. Each thread
// raises one triple's cell with atomicMax, so duplicate cells resolve to
// their largest value whatever order the threads run in, and a value
// below the cell's leaves it as it is. The mirror pads the triples to a
// power of two with (0, 0, 0) (_pending_arrays), which is a no-op against
// a non-negative matrix, as in the reference. A triple whose row or
// column lies outside the matrix is dropped, so no write leaves the
// buffer (the mirror's triples always lie inside it).
//
// Two entries, one for each place the triples live:
//   hm_clock_scatter: triples already on the card (the mesh's clock union,
//     parallel/sharded.py), read from device memory with a grid stride;
//   hm_clock_scatter_params: triples in host memory (the mirror's pending
//     writes). They travel in the launch itself: the entry copies up to
//     kMaxTriples of them (2,048, 24 KB, under CUDA 12.1 and later) into
//     a struct passed by value (`const __grid_constant__`), so no copy to
//     the card and no staging buffer precede the launch, and the host
//     never blocks on a pageable upload. A larger batch goes in several
//     launches of at most that many, on one stream; atomicMax commutes,
//     so their order does not matter. Each launch takes the smallest
//     struct that holds its triples (3 KB, 12 KB or 24 KB: params.cuh),
//     so config 5's flush of 1,024 carries 12 KB of parameters.
//
// Reading the parameter bank: the lanes of a warp read 32 different
// triples, and the constant cache serves one address at a time, so each
// of a warp's three reads serializes 32 ways. At config 5's 1,024 triples
// that is 32 warps over 8 blocks of 128 threads; chip_smoke.py reads this
// kernel alone beside the device-triple kernel at the same n.
//
// What bounds it on the H100: the n triples (12 bytes each) and one
// atomic per triple; the matrix is not swept. 1,000 writes are a few
// microseconds of work, so at the mirror's sizes the launch dominates.
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "params.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;
constexpr int kParamThreads = 128;
constexpr int kOtherParamBytes = 32;  // m, cap_d, cap_a, n (padded)

// the triples of the three structs: the most one launch can take (the
// largest power of two whose struct fits beside the other parameters:
// 2,048 under CUDA 12.1 and later, 256 under the old 4,096-byte limit),
// the middle one (1,024) and the small one (256)
constexpr int kMaxTriples = pow2_floor((kMaxParamBytes - kOtherParamBytes) / 12);
constexpr int kMidTriples = pow2_floor((kMidParamBytes - kOtherParamBytes) / 12);
constexpr int kSmallTriples = 256 < kMidTriples ? 256 : kMidTriples;

template <int K>
struct Triples {
  int rows[K];
  int cols[K];
  int vals[K];
};
static_assert(sizeof(Triples<kMaxTriples>) + kOtherParamBytes <= kMaxParamBytes,
              "the triples exceed one launch's parameters");

__device__ __forceinline__ void raise_cell(int* m, long long cap_d, int cap_a,
                                           int r, int c, int v) {
  if (r < 0 || r >= cap_d || c < 0 || c >= cap_a) return;
  atomicMax(&m[static_cast<long long>(r) * cap_a + c], v);
}

__global__ void __launch_bounds__(kThreads) scatter_max_kernel(
    int* m, long long cap_d, int cap_a, const int* rows, const int* cols,
    const int* vals, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    raise_cell(m, cap_d, cap_a, rows[i], cols[i], vals[i]);
}

template <int K>
__global__ void __launch_bounds__(kParamThreads) scatter_params_kernel(
    int* m, int cap_d, int cap_a, int n, const __grid_constant__ Triples<K> t) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) raise_cell(m, cap_d, cap_a, t.rows[i], t.cols[i], t.vals[i]);
}

// one launch of n <= K host triples, copied into the launch's parameters
template <int K>
int launch_params(int* m, int cap_d, int cap_a, const int* rows,
                  const int* cols, const int* vals, int n, cudaStream_t stream) {
  Triples<K> t;
  std::memcpy(t.rows, rows, n * sizeof(int));
  std::memcpy(t.cols, cols, n * sizeof(int));
  std::memcpy(t.vals, vals, n * sizeof(int));
  auto kernel = scatter_params_kernel<K>;
  kernel<<<(n + kParamThreads - 1) / kParamThreads, kParamThreads, 0, stream>>>(
      m, cap_d, cap_a, n, t);
  return static_cast<int>(cudaGetLastError());
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

// hm_clock_scatter_params_cap(0): the most triples one launch takes;
// (1): the triples of the middle struct.
extern "C" int hm_clock_scatter_params_cap(int which) {
  return which == 0 ? kMaxTriples : kMidTriples;
}

// m: device [cap_d, cap_a] int32, updated in place; rows/cols/vals: host
// [n] int32, read before this returns (their values travel in the
// launches); per_launch: the triples a launch takes, at most kMaxTriples,
// each launch in the struct sized for them; 0 for kMaxTriples, each
// launch in the smallest struct that holds its triples. (A test passes
// fewer, so that a small batch splits; chip_smoke.py passes 2,048 to
// time the largest struct at 1,024 triples.) Returns -1 on bad
// arguments, else the first non-zero cudaGetLastError().
extern "C" int hm_clock_scatter_params(int* m, int cap_d, int cap_a,
                                       const int* rows, const int* cols,
                                       const int* vals, int n, int per_launch,
                                       void* stream) {
  if (n < 0 || per_launch < 0 || per_launch > kMaxTriples) return -1;
  const int chunk = per_launch == 0 ? kMaxTriples : per_launch;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i0 = 0; i0 < n; i0 += chunk) {
    const int c = n - i0 < chunk ? n - i0 : chunk;
    const int size = per_launch == 0 ? c : chunk;
    const int* r = rows + i0;
    const int* co = cols + i0;
    const int* v = vals + i0;
    const int rc =
        size <= kSmallTriples ? launch_params<kSmallTriples>(m, cap_d, cap_a, r, co, v, c, s)
        : size <= kMidTriples ? launch_params<kMidTriples>(m, cap_d, cap_a, r, co, v, c, s)
                              : launch_params<kMaxTriples>(m, cap_d, cap_a, r, co, v, c, s);
    if (rc != 0) return rc;
  }
  return 0;
}
