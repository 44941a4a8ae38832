// Block-wide bitonic sorts shared by the port's kernels.
//
// A sort orders n (a power of two) keys, or (key, val) pairs ascending by
// key and then by val. The kernels store the row index in val (or in a
// key's low bits), so no two items compare equal: the order is total, the
// result is unique, and it equals what a stable sort by key gives
// (jnp.lexsort and jnp.argsort are stable).
#pragma once

template <class Key>
__device__ __forceinline__ bool pair_greater(Key ka, int va, Key kb, int vb) {
  return ka > kb || (ka == kb && va > vb);
}

// compare-exchange of the pairs (*ka, *va) and (*kb, *vb): the smaller
// pair first when ascending
template <class Key>
__device__ __forceinline__ void exchange_pairs(Key* ka, int* va, Key* kb,
                                               int* vb, bool ascending) {
  const Key a = *ka, b = *kb;
  const int x = *va, y = *vb;
  if (pair_greater(a, x, b, y) == ascending) {
    *ka = b;
    *kb = a;
    *va = y;
    *vb = x;
  }
}

// Sorts of single 64-bit keys on the bitonic network over global positions.
//
// Stage (k, j) of the network compare-exchanges positions i and i | j
// (bit j of i clear), ascending where (i & k) == 0. A kernel that holds n
// keys (n a power of two) of global positions base .. base + n - 1 in
// shared memory runs every stage with j < n there (shared_bitonic); a
// stage with j >= n spans blocks and runs as one launch over the grid
// (global_bitonic_pair). With base = 0 and stages k = 2 .. n,
// shared_bitonic is a block-wide ascending sort. The stages with j < 32
// pair keys of one warp: they run on registers with __shfl_xor_sync, all
// of one k between two barriers, so a sort of 1,024 keys takes 25
// barriers where one per stage took 55. The block's threads must be a
// multiple of 32. Callers pack a unique tie-break (a row index) into each
// key's low bits, so that the order is total and the result unique.

template <class Key>
__device__ __forceinline__ void compare_exchange(Key* s, long long i,
                                                 long long l, bool ascending) {
  const Key a = s[i], b = s[l];
  if ((a > b) == ascending) {
    s[i] = b;
    s[l] = a;
  }
}

// the stages j = j_first, ..., 1 (j_first < 32) on the key this lane
// holds at position e of a run sorted ascending or not; every lane of the
// warp takes part
template <class Key>
__device__ __forceinline__ Key warp_bitonic(Key key, long long e, bool ascending,
                                            int j_first) {
  for (int j = j_first; j > 0; j >>= 1) {
    const Key other = __shfl_xor_sync(0xffffffffu, key, j);
    const bool take_min = ((e & j) == 0) == ascending;
    key = take_min ? (other < key ? other : key) : (other > key ? other : key);
  }
  return key;
}

// the stages k = k_first, 2 k_first, ..., k_last (powers of two) with
// j < n over the n keys in s; each k ends in a __syncthreads(), so every
// thread of the block must call this
template <class Key>
__device__ void shared_bitonic(Key* s, int n, long long base, long long k_first,
                               long long k_last) {
  for (long long k = k_first; k <= k_last; k <<= 1) {
    int j = static_cast<int>((k < n ? k : n) >> 1);
    for (; j >= 32; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        compare_exchange(s, i, i + j, ((base + i) & k) == 0);
      }
      __syncthreads();
    }
    if (j == 0) continue;
    for (int e0 = 0; e0 < n; e0 += blockDim.x) {  // whole warps
      const int e = e0 + static_cast<int>(threadIdx.x);
      const Key key = e < n ? s[e] : Key(0);
      const Key out = warp_bitonic(key, base + e, ((base + e) & k) == 0, j);
      if (e < n) s[e] = out;
    }
    __syncthreads();
  }
}

// The same network over (key, val) pairs, ascending by key and then by
// val, for keys that leave no bits for a tie-break (doc_kernel.cu's
// many-block route: its sort keys use all 64 bits, and val is the row).
// The warp stages shuffle the key and the val apart.

// warp_bitonic over the pair (key, val) this lane holds at position e
template <class Key>
__device__ __forceinline__ void warp_bitonic_pairs(Key& key, int& val,
                                                   long long e, bool ascending,
                                                   int j_first) {
  for (int j = j_first; j > 0; j >>= 1) {
    const Key ok = __shfl_xor_sync(0xffffffffu, key, j);
    const int ov = __shfl_xor_sync(0xffffffffu, val, j);
    const bool take_min = ((e & j) == 0) == ascending;
    if (pair_greater(key, val, ok, ov) == take_min) {
      key = ok;
      val = ov;
    }
  }
}

// shared_bitonic over the n pairs (s[i], v[i]) of network positions
// base .. base + n - 1; every thread of the block must call this, and
// the block's threads must be a multiple of 32
template <class Key>
__device__ void shared_bitonic_pairs(Key* s, int* v, int n, long long base,
                                     long long k_first, long long k_last) {
  for (long long k = k_first; k <= k_last; k <<= 1) {
    int j = static_cast<int>((k < n ? k : n) >> 1);
    for (; j >= 32; j >>= 1) {
      for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        exchange_pairs(s + i, v + i, s + i + j, v + i + j,
                       ((base + i) & k) == 0);
      }
      __syncthreads();
    }
    if (j == 0) continue;
    for (int e0 = 0; e0 < n; e0 += blockDim.x) {  // whole warps
      const int e = e0 + static_cast<int>(threadIdx.x);
      Key key = e < n ? s[e] : Key(0);
      int val = e < n ? v[e] : 0;
      warp_bitonic_pairs(key, val, base + e, ((base + e) & k) == 0, j);
      if (e < n) {
        s[e] = key;
        v[e] = val;
      }
    }
    __syncthreads();
  }
}

// A block-wide sort with each thread's items in registers. Thread t holds
// the four network positions 4t .. 4t + 3: the stages j = 2, 1 compare
// within the thread, the stages 4 <= j < 128 exchange with lane t ^ (j / 4)
// by __shfl_xor_sync, and only the stages j >= 128 (across warps) go
// through memory, one barrier each. So a sort of 1,024 items takes 9
// barriers, and every k <= 128 none. It sorts n items where the block has
// n / 4 threads (n >= 256), or 32 threads and n <= 128 (the positions from
// n up hold the largest item, never stored). Mem gives the items' memory:
// load(p), store(p, item), exchange(i, l, ascending), and inf(), an item
// above every real one. Ends with a barrier; every thread of the block
// must call it.

template <class Key>
struct PairItem {
  Key key;
  int val;
};

template <class Key>
__device__ __forceinline__ bool item_greater(const PairItem<Key>& a,
                                             const PairItem<Key>& b) {
  return pair_greater(a.key, a.val, b.key, b.val);
}

__device__ __forceinline__ bool item_greater(unsigned long long a,
                                             unsigned long long b) {
  return a > b;
}

template <class Key>
__device__ __forceinline__ PairItem<Key> shfl_item(const PairItem<Key>& a,
                                                   int mask) {
  return PairItem<Key>{__shfl_xor_sync(0xffffffffu, a.key, mask),
                       __shfl_xor_sync(0xffffffffu, a.val, mask)};
}

__device__ __forceinline__ unsigned long long shfl_item(unsigned long long a,
                                                        int mask) {
  return __shfl_xor_sync(0xffffffffu, a, mask);
}

// (key, val) pairs in two arrays, ascending by key and then by val
template <class Key>
struct PairMem {
  Key* key;
  int* val;
  __device__ PairItem<Key> load(int p) const { return PairItem<Key>{key[p], val[p]}; }
  __device__ void store(int p, const PairItem<Key>& x) const {
    key[p] = x.key;
    val[p] = x.val;
  }
  __device__ void exchange(int i, int l, bool ascending) const {
    exchange_pairs(key + i, val + i, key + l, val + l, ascending);
  }
  __device__ PairItem<Key> inf() const {
    return PairItem<Key>{static_cast<Key>(~0ull >> 1), 0x7fffffff};
  }
};

// unique 64-bit keys
struct KeyMem {
  unsigned long long* key;
  __device__ unsigned long long load(int p) const { return key[p]; }
  __device__ void store(int p, unsigned long long x) const { key[p] = x; }
  __device__ void exchange(int i, int l, bool ascending) const {
    compare_exchange(key, i, l, ascending);
  }
  __device__ unsigned long long inf() const { return ~0ull; }
};

// whether the block's threads hold n items four a thread (see above)
__device__ __forceinline__ bool blocked_fits(int n) {
  const int m = 4 * static_cast<int>(blockDim.x);
  return m == n ? n >= 256 : (blockDim.x == 32 && n <= 128);
}

// stage (k, J) for J < 4: positions 4t + q and 4t + q + J of this thread
// (J a template argument, so that x stays in registers)
template <int J, class Item>
__device__ __forceinline__ void thread_stage(Item (&x)[4], int t, int k) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (q & J) continue;
    const bool ascending = ((4 * t + q) & k) == 0;
    if (item_greater(x[q], x[q + J]) == ascending) {
      const Item y = x[q];
      x[q] = x[q + J];
      x[q + J] = y;
    }
  }
}

template <class Mem>
__device__ void blocked_bitonic(const Mem& mem, int n) {
  const int t = threadIdx.x, nt = blockDim.x, m = 4 * nt;
  decltype(mem.inf()) x[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) x[q] = 4 * t + q < n ? mem.load(4 * t + q) : mem.inf();
  for (int k = 2; k <= m; k <<= 1) {
    int j = k >> 1;
    if (j >= 128) {  // the stages across warps, through memory
#pragma unroll
      for (int q = 0; q < 4; ++q) mem.store(4 * t + q, x[q]);
      __syncthreads();
      for (; j >= 128; j >>= 1) {
        for (int u = t; u < (m >> 1); u += nt) {
          const int i = ((u & ~(j - 1)) << 1) | (u & (j - 1));
          mem.exchange(i, i + j, (i & k) == 0);
        }
        __syncthreads();
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) x[q] = mem.load(4 * t + q);
    }
    for (; j >= 4; j >>= 1) {  // lane t ^ (j / 4) holds the partners
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const auto o = shfl_item(x[q], j >> 2);
        const int p = 4 * t + q;
        const bool take_min = ((p & j) == 0) == ((p & k) == 0);
        if (item_greater(x[q], o) == take_min) x[q] = o;
      }
    }
    if (j == 2) thread_stage<2>(x, t, k);  // within the thread
    thread_stage<1>(x, t, k);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (4 * t + q < n) mem.store(4 * t + q, x[q]);
  __syncthreads();
}

// pair t of stage (k, j) over the keys in global memory
template <class Key>
__device__ __forceinline__ void global_bitonic_pair(Key* key, long long t,
                                                    long long k, long long j) {
  const long long i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
  compare_exchange(key, i, i + j, (i & k) == 0);
}

// The n keys of s (n a power of two) hold runs of `run` keys (a power of
// two), each sorted, ascending and descending in turn. Leaves the n / run
// runs' `run` smallest keys sorted ascending in s[0, run): at each level
// the elementwise min of a pair of runs (one ascending, one descending)
// holds the pair's `run` smallest keys as a bitonic sequence, written
// over the first run of the pair; log2(run) stages sort it, ascending or
// descending by its place in the next level's pairs (those with j < 32 on
// registers, as in shared_bitonic). Every thread of the block must call
// this, and the block's threads must be a multiple of 32.
template <class Key>
__device__ void bitonic_topk(Key* s, int n, int run) {
  for (int stride = run; stride < n; stride <<= 1) {
    // the pairs (q, q + stride) for q a multiple of 2 stride
    const int pairs = n / (2 * stride);
    for (int t = threadIdx.x; t < pairs * run; t += blockDim.x) {
      const int q = (t / run) * 2 * stride + t % run;
      if (s[q + stride] < s[q]) s[q] = s[q + stride];
    }
    __syncthreads();
    int j = run >> 1;
    for (; j >= 32; j >>= 1) {
      for (int t = threadIdx.x; t < pairs * (run >> 1); t += blockDim.x) {
        const int p = t / (run >> 1), u = t % (run >> 1);
        const int i = ((u & ~(j - 1)) << 1) | (u & (j - 1));
        compare_exchange(s, p * 2 * stride + i, p * 2 * stride + i + j,
                         (p & 1) == 0);
      }
      __syncthreads();
    }
    if (j == 0) continue;
    for (int t0 = 0; t0 < pairs * run; t0 += blockDim.x) {  // whole warps
      const int t = t0 + static_cast<int>(threadIdx.x);
      const int p = t / run, i = t % run;
      const bool valid = t < pairs * run;
      const Key key = valid ? s[p * 2 * stride + i] : Key(0);
      const Key out = warp_bitonic(key, i, (p & 1) == 0, j);
      if (valid) s[p * 2 * stride + i] = out;
    }
    __syncthreads();
  }
}
