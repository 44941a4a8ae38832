// Serve kernel 3: live element and map entry counts of one container per
// batch row.
//
// Replaces hypermerge_tpu/serve/kernels.py::_build_counts (:120-134):
//   at_obj     = lanes_b[OBJ] == qobj[b]
//   n_elems[b] = sum(lanes_b[LIVE] != 0 && at_obj && lanes_b[INSERT] == 1)
//   n_map[b]   = sum(lanes_b[MAPWIN] != 0 && at_obj)
//
// `args` holds the B lane pointers ([6, N] int32 each, read in place),
// then qobj [B], as int64. One block per batch row; each thread counts
// its stride of rows, and two shared atomicAdds fold the block.
// out[b] = n_elems, out[B + b] = n_map.
//
// What bounds it on the H100: bytes (four of the six lanes read once,
// 16 bytes a row); at serving sizes the launch and the result copy.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLive = 0, kObj = 2, kInsert = 3, kMapWin = 5;

__global__ void __launch_bounds__(kThreads) counts_kernel(
    const long long* args, int B, int N, int* out) {
  const int b = blockIdx.x;
  const int* lanes = reinterpret_cast<const int*>(args[b]);
  const int qobj = static_cast<int>(args[B + b]);
  __shared__ int n_elems, n_map;
  if (threadIdx.x == 0) n_elems = n_map = 0;
  __syncthreads();
  int elems = 0, map = 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (lanes[kObj * N + i] != qobj) continue;
    elems += lanes[kLive * N + i] != 0 && lanes[kInsert * N + i] == 1;
    map += lanes[kMapWin * N + i] != 0;
  }
  atomicAdd(&n_elems, elems);
  atomicAdd(&n_map, map);
  __syncthreads();
  if (threadIdx.x == 0) {
    out[b] = n_elems;
    out[B + b] = n_map;
  }
}

}  // namespace

// args: device int64 [2 * B] (B lane pointers, qobj); out: device int32
// [2 * B]. Returns the first non-zero cudaGetLastError().
extern "C" int hm_serve_counts(const long long* args, int B, int N, int* out,
                               void* stream) {
  if (B <= 0 || N <= 0) return -1;
  counts_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, B, N, out);
  return static_cast<int>(cudaGetLastError());
}
