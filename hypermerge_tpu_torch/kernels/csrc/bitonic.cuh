// Block-wide bitonic sort shared by the port's kernels.
//
// Sorts n (a power of two) (key, val) pairs held in global scratch,
// ascending by key and then by val. The kernels store the row index in
// val, so no two pairs compare equal: the order is total, the result is
// unique, and it equals what a stable sort by key gives (jnp.lexsort and
// jnp.argsort are stable). Each compare-exchange stage is followed by a
// __syncthreads(), so every thread of the block must call this.
#pragma once

template <class Key>
__device__ __forceinline__ bool pair_greater(Key ka, int va, Key kb, int vb) {
  return ka > kb || (ka == kb && va > vb);
}

template <class Key>
__device__ void block_bitonic_sort(Key* key, int* val, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        // the t-th pair of this stage: i has bit j clear, l = i | j
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int l = i + j;
        const bool ascending = (i & k) == 0;
        const Key ki = key[i], kl = key[l];
        const int vi = val[i], vl = val[l];
        if (pair_greater(ki, vi, kl, vl) == ascending) {
          key[i] = kl;
          key[l] = ki;
          val[i] = vl;
          val[l] = vi;
        }
      }
      __syncthreads();
    }
  }
}
