// Serve kernel 1: the winner row of one (container, key) per batch row.
//
// Replaces hypermerge_tpu/serve/kernels.py::_build_map_lookup (:87-99):
//   mask[b, i] = lanes_b[MAPWIN, i] != 0 && lanes_b[KEY, i] == qkey[b]
//                && lanes_b[OBJ, i] == qobj[b]
//   row[b]     = jnp.argmax(mask[b])   (lowest match; 0 when none)
//   found[b]   = mask[b].any()
//
// The batch's lanes are NOT stacked: `args` holds the B lane pointers
// (each a [6, N] int32 array, pad slots repeating entry 0's), then qobj
// [B], then qkey [B], all as int64. One block per batch row; threads
// stride over the N rows, and each keeps the first match of its stride
// (the smallest row it sees), then one shared atomicMin folds the block.
// out[b] = row, out[B + b] = found (0/1).
//
// What bounds it on the H100: bytes. It reads three of the six lanes
// once (12 bytes a row) and writes 8 bytes a batch row; a lookup of a
// small bucket is a launch, not a transfer, so the launch and the one
// result copy dominate.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kObj = 2, kKey = 4, kMapWin = 5;

__global__ void __launch_bounds__(kThreads) lookup_kernel(
    const long long* args, int B, int N, int* out) {
  const int b = blockIdx.x;
  const int* lanes = reinterpret_cast<const int*>(args[b]);
  const int qobj = static_cast<int>(args[B + b]);
  const int qkey = static_cast<int>(args[2 * B + b]);
  __shared__ int best;
  if (threadIdx.x == 0) best = N;  // N: no match
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    if (lanes[kMapWin * N + i] != 0 && lanes[kKey * N + i] == qkey &&
        lanes[kObj * N + i] == qobj) {
      atomicMin(&best, i);
      break;  // later rows of this stride are larger
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    out[b] = best < N ? best : 0;  // argmax of an all-false row is 0
    out[B + b] = best < N ? 1 : 0;
  }
}

}  // namespace

// args: device int64 [3 * B] (B lane pointers, qobj, qkey); out: device
// int32 [2 * B]. Returns the first non-zero cudaGetLastError().
extern "C" int hm_serve_lookup(const long long* args, int B, int N, int* out,
                               void* stream) {
  if (B <= 0 || N <= 0) return -1;
  lookup_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, B, N, out);
  return static_cast<int>(cudaGetLastError());
}
