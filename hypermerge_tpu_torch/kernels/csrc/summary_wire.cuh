// The summary wire's per-doc body, shared by its two callers: doc_kernel.cu's
// one-block route runs it as the epilogue of the launch that computed the
// lanes (they are still in its shared memory), and summary_wire.cu runs it
// over lanes in global memory (the batches whose kernel 1 took the
// many-block route).
//
// Replaces hypermerge_tpu/ops/crdt_kernels.py::_summarize_wire (with
// _pack_bits, _pack_uint and _le_bytes). A doc's [W] row of the [D, W]
// uint8 wire is laid out as summary_wire_spec says:
//   map_winner bits | elem_live bits | elem_order at order_bits bits each |
//   n_live | n_map (count_bytes each, little-endian) | clock (4 A bytes,
//   little-endian int32; absent on lean wires)
// Bits are in little bit order throughout, as np.unpackbits(...,
// bitorder="little") reads them.
//
// elem_order is the STABLE argsort of where(elem_live, -rank, INT32_MAX):
// every non-live row shares the key INT32_MAX and their index order is on
// the wire, and live ranks repeat across the list/text objects of a doc.
// The order key is 32 bits, so it and the row fit one 64-bit key, (key ^
// 0x80000000) << 32 | row: unsigned order is the key's signed order, then
// the row's, so the keys are unique and their sort is the stable order.
// They sort with blocked_bitonic (bitonic.cuh: four keys a thread in
// registers, the stages within a warp on shuffles) where the block holds
// them four a thread, else with shared_bitonic. The masks take one warp
// ballot per 32 rows, which also yields the counts (__popc); elem_order is
// packed a 32-bit word a thread, each entry shifted into place (one
// division a word, none a bit).
#pragma once

#include <climits>
#include <cstdint>

#include "bitonic.cuh"

// the wire's layout (summary_wire_spec) and where it goes: out is the
// [D, W] wire, or null where a launch writes none
struct Wire {
  uint8_t* out;
  int mask_bytes, order_bits, order_bytes, count_bytes, W, lean;
};

// Doc d's wire row from its lanes (doc-local [N] pointers, clock [A] or
// null on a lean wire); keys: [N] scratch for the sort, in shared or global
// memory. Every thread of the block calls it (a multiple of 32 threads).
__device__ inline void wire_doc(const uint8_t* mw, const uint8_t* el,
                                const int* rank, const int* clock,
                                unsigned long long* keys, int N, int A,
                                const Wire& w, long long d) {
  __shared__ int counts[2];  // n_live, n_map
  uint8_t* out = w.out + d * w.W;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  if (tid == 0) counts[0] = counts[1] = 0;
  for (int i = tid; i < N; i += nt) {
    const unsigned k = el[i] ? 0u - static_cast<unsigned>(rank[i])
                             : static_cast<unsigned>(INT_MAX);
    keys[i] = (static_cast<unsigned long long>(k ^ 0x80000000u) << 32) |
              static_cast<unsigned>(i);
  }
  __syncthreads();

  // masks + counts: one ballot per 32 rows (warp-uniform loop)
  for (int base = warp * 32; base < N; base += nwarps * 32) {
    const int i = base + lane;
    const unsigned m = __ballot_sync(0xffffffffu, i < N && mw[i]);
    const unsigned e = __ballot_sync(0xffffffffu, i < N && el[i]);
    const int byte = (base >> 3) + lane;
    if (lane < 4 && byte < w.mask_bytes) {
      out[byte] = static_cast<uint8_t>(m >> (8 * lane));
      out[w.mask_bytes + byte] = static_cast<uint8_t>(e >> (8 * lane));
    }
    if (lane == 0) {
      atomicAdd(&counts[0], __popc(e));
      atomicAdd(&counts[1], __popc(m));
    }
  }

  if (blocked_fits(N))
    blocked_bitonic(KeyMem{keys}, N);
  else
    shared_bitonic(keys, N, 0, 2, N);

  // elem_order: word v holds bits [32 v, 32 v + 32) of the entries, each
  // entry (a row, the key's low word) at order_bits bits
  uint8_t* order_out = out + 2 * w.mask_bytes;
  const int bits = w.order_bits;
  const int words = (w.order_bytes + 3) / 4;
  for (int v = tid; v < words; v += nt) {
    const long long lo = 32LL * v;
    unsigned long long acc = 0;
    for (long long e = lo / bits; e < N && e * bits < lo + 32; ++e) {
      const unsigned long long row = keys[e] & 0xffffffffull;
      const long long at = e * bits - lo;
      acc |= at >= 0 ? row << at : row >> -at;
    }
    for (int q = 0; q < 4 && 4 * v + q < w.order_bytes; ++q)
      order_out[4 * v + q] = static_cast<uint8_t>(acc >> (8 * q));
  }
  __syncthreads();  // every warp's counts are in

  // counts, then the clock, little-endian
  uint8_t* tail = order_out + w.order_bytes;
  if (tid < w.count_bytes) {
    tail[tid] = static_cast<uint8_t>(static_cast<unsigned>(counts[0]) >> (8 * tid));
    tail[w.count_bytes + tid] =
        static_cast<uint8_t>(static_cast<unsigned>(counts[1]) >> (8 * tid));
  }
  if (!w.lean) {
    uint8_t* clock_out = tail + 2 * w.count_bytes;
    for (int a = tid; a < A; a += nt) {
      const unsigned v = static_cast<unsigned>(clock[a]);
      for (int j = 0; j < 4; ++j)
        clock_out[4 * a + j] = static_cast<uint8_t>(v >> (8 * j));
    }
  }
}
