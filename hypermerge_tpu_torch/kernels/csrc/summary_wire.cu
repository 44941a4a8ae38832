// Kernel 2 of the port: the summary wire over lanes in global memory, one
// block per doc.
//
// Replaces hypermerge_tpu/ops/crdt_kernels.py::_summarize_wire for the
// batches whose kernel 1 ran doc_kernel.cu's many-block route (long docs,
// few of them); a batch on a one-block route gets its wire from that
// launch's epilogue instead. The per-doc body, its layout and its sort are
// summary_wire.cuh's wire_doc, shared with that epilogue.
//
// Where the sort's keys live: in dynamic shared memory while a doc has at
// most kSharedKeys rows (HM_WIRE_SHARED_KEYS, 16,384 keys by default,
// 128 KB: the largest power of two of 8-byte keys under the 227 KB a
// block may take; the host-compiled tests build it smaller), else in the
// caller's global scratch ([D, N] int64).
//
// What bounds it on the H100: it reads 6 bytes per row (two masks and the
// int32 rank) and writes about 1.5 bytes per row, so the bytes bound is a
// few microseconds at the bulk slab. The sort's barriers bound it instead:
// log2 N (log2 N + 1) / 2 stages, of which those with j < 32 run on warp
// shuffles between two barriers, so 1,024 keys take 25 barriers.
#include <cstdint>
#include <cuda_runtime.h>

#include "summary_wire.cuh"

namespace {

typedef unsigned long long Key;

#ifndef HM_WIRE_SHARED_KEYS
#define HM_WIRE_SHARED_KEYS 16384
#endif
constexpr int kSharedKeys = HM_WIRE_SHARED_KEYS;
static_assert(kSharedKeys >= 1 && kSharedKeys <= 16384 &&
                  (kSharedKeys & (kSharedKeys - 1)) == 0,
              "HM_WIRE_SHARED_KEYS: a power of two of at most 16,384 keys");

__global__ void __launch_bounds__(1024) summary_wire_kernel(
    const uint8_t* __restrict__ map_winner,
    const uint8_t* __restrict__ elem_live, const int* __restrict__ rank,
    const int* __restrict__ clock, int N, int A, Wire w,
    Key* __restrict__ scratch) {
  extern __shared__ Key wire_keys[];
  const long long d = blockIdx.x;
  Key* keys = N <= kSharedKeys ? wire_keys : scratch + d * N;
  wire_doc(map_winner + d * N, elem_live + d * N, rank + d * N,
           clock == nullptr ? nullptr : clock + d * A, keys, N, A, w, d);
}

}  // namespace

// the most keys a doc sorts in shared memory
extern "C" int hm_summary_wire_cap(int) { return kSharedKeys; }

// map_winner, elem_live: [D, N] bool; rank: [D, N] int32; clock: [D, A]
// int32, or null on a lean wire; N a power of two. scratch: int64 [D, N]
// when N > hm_summary_wire_cap, else unused (may be null). Returns -1 on
// bad arguments, else the first non-zero CUDA error.
extern "C" int hm_summary_wire(
    const uint8_t* map_winner, const uint8_t* elem_live, const int* rank,
    const int* clock, int D, int N, int A, int mask_bytes, int order_bits,
    int order_bytes, int count_bytes, int W, int lean, uint8_t* out,
    long long* scratch, void* stream) {
  if (D < 1 || N < 1 || (N & (N - 1)) != 0 || (!lean && clock == nullptr))
    return -1;
  const bool shared = N <= kSharedKeys;
  if (!shared && scratch == nullptr) return -1;
  const int bytes = shared ? static_cast<int>(N * sizeof(Key)) : 0;
  if (bytes > 48 * 1024) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        summary_wire_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes));
    if (rc != 0) return rc;
  }
  const int threads = N <= 128 ? 32 : N / 4 < 1024 ? N / 4 : 1024;
  const Wire w{out, mask_bytes, order_bits, order_bytes, count_bytes, W, lean};
  summary_wire_kernel<<<D, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      map_winner, elem_live, rank, clock, N, A, w,
      reinterpret_cast<Key*>(scratch));
  return static_cast<int>(cudaGetLastError());
}
