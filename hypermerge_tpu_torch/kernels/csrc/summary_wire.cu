// Kernel 2 of the port: the fused summary wire, one block per doc.
//
// Replaces hypermerge_tpu/ops/crdt_kernels.py::_summarize_wire (with
// _pack_bits, _pack_uint and _le_bytes). Each block writes its doc's [W]
// row of the [D, W] uint8 wire, laid out as summary_wire_spec says:
//   map_winner bits | elem_live bits | elem_order at order_bits bits each |
//   n_live | n_map (count_bytes each, little-endian) | clock (4 A bytes,
//   little-endian int32; absent on lean wires)
// Bits are in little bit order throughout, as np.unpackbits(...,
// bitorder="little") reads them.
//
// elem_order is the STABLE argsort of where(elem_live, -rank, INT32_MAX):
// every non-live row shares the key INT32_MAX and their index order is on
// the wire, and live ranks repeat across the list/text objects of a doc.
// The bitonic sort orders (key ^ 0x80000000, row) pairs; the row index
// makes every pair distinct, so the result is the stable order.
//
// What bounds it on the H100: it reads 6 bytes per row (two masks and the
// int32 rank) and writes about 1.5 bytes per row, so the bytes bound is a
// few microseconds at the bulk slab. The sort's log2 N (log2 N + 1) / 2
// barrier-separated stages bound it instead. The masks use one warp ballot
// per 32 rows, which also yields the counts (__popc); the order entries are
// assembled a byte at a time, so no two threads write one byte.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) summary_wire_kernel(
    const uint8_t* __restrict__ map_winner,
    const uint8_t* __restrict__ elem_live, const int* __restrict__ rank,
    const int* __restrict__ clock, int N, int A, int mask_bytes,
    int order_bits, int order_bytes, int count_bytes, int W, int lean,
    uint8_t* __restrict__ out, long long* __restrict__ scratch) {
  const size_t d = blockIdx.x;
  map_winner += d * (size_t)N;
  elem_live += d * (size_t)N;
  rank += d * (size_t)N;
  out += d * (size_t)W;
  unsigned* skey = reinterpret_cast<unsigned*>(scratch + d * (size_t)N);
  int* sval = reinterpret_cast<int*>(skey + N);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  __shared__ int counts[2];  // n_live, n_map
  if (tid == 0) counts[0] = counts[1] = 0;

  // order keys, biased so unsigned order == signed order
  for (int i = tid; i < N; i += nt) {
    const unsigned k = elem_live[i] ? 0u - (unsigned)rank[i] : (unsigned)INT_MAX;
    skey[i] = k ^ 0x80000000u;
    sval[i] = i;
  }
  __syncthreads();

  // masks + counts: one ballot per 32 rows (warp-uniform loop)
  for (int base = warp * 32; base < N; base += nwarps * 32) {
    const int i = base + lane;
    const unsigned mw = __ballot_sync(0xffffffffu, i < N && map_winner[i]);
    const unsigned el = __ballot_sync(0xffffffffu, i < N && elem_live[i]);
    const int byte = (base >> 3) + lane;
    if (lane < 4 && byte < mask_bytes) {
      out[byte] = (uint8_t)(mw >> (8 * lane));
      out[mask_bytes + byte] = (uint8_t)(el >> (8 * lane));
    }
    if (lane == 0) {
      atomicAdd(&counts[0], __popc(el));
      atomicAdd(&counts[1], __popc(mw));
    }
  }

  block_bitonic_sort(skey, sval, N);  // ends with a barrier

  // elem_order at exactly order_bits bits per entry
  uint8_t* order_out = out + 2 * mask_bytes;
  const long long total_bits = (long long)N * order_bits;
  for (int b = tid; b < order_bytes; b += nt) {
    unsigned v = 0;
    for (int t = 0; t < 8; ++t) {
      const long long pos = (long long)b * 8 + t;
      if (pos < total_bits) {
        const int e = (int)(pos / order_bits);
        const int bit = (int)(pos % order_bits);
        v |= (((unsigned)sval[e] >> bit) & 1u) << t;
      }
    }
    order_out[b] = (uint8_t)v;
  }

  // counts, then the clock, little-endian
  uint8_t* tail = order_out + order_bytes;
  if (tid < count_bytes) {
    tail[tid] = (uint8_t)((unsigned)counts[0] >> (8 * tid));
    tail[count_bytes + tid] = (uint8_t)((unsigned)counts[1] >> (8 * tid));
  }
  if (!lean) {
    const int* c = clock + d * (size_t)A;
    uint8_t* clock_out = tail + 2 * count_bytes;
    for (int a = tid; a < A; a += nt) {
      const unsigned v = (unsigned)c[a];
      for (int j = 0; j < 4; ++j) clock_out[4 * a + j] = (uint8_t)(v >> (8 * j));
    }
  }
}

}  // namespace

extern "C" int hm_summary_wire(
    const uint8_t* map_winner, const uint8_t* elem_live, const int* rank,
    const int* clock, int D, int N, int A, int mask_bytes, int order_bits,
    int order_bytes, int count_bytes, int W, int lean, uint8_t* out,
    long long* scratch, void* stream) {
  summary_wire_kernel<<<D, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      map_winner, elem_live, rank, clock, N, A, mask_bytes, order_bits,
      order_bytes, count_bytes, W, lean, out, scratch);
  return static_cast<int>(cudaGetLastError());
}
