// The bytes of parameters one kernel launch may take, shared by the
// kernels that pass their arguments by value in a parameter struct
// (`const __grid_constant__`) instead of uploading them.
//
// CUDA 12.1 and later let a kernel on Volta or newer take up to 32,764
// bytes of parameters; older toolkits keep the 4,096-byte limit. A kernel
// sizes its struct from kMaxParamBytes and static_asserts that the struct
// and its other parameters fit. CUDART_VERSION comes from
// <cuda_runtime.h>, which the including source includes first.
#pragma once

#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
constexpr int kMaxParamBytes = 32764;
#else
constexpr int kMaxParamBytes = 4096;
#endif

// The bytes of a middle-sized struct. A kernel is instantiated for a
// small struct, one of kMidParamBytes and the largest, and each launch
// takes the smallest that holds its arguments: on the H100 the launch of
// a 24 KB struct cost more than that of a 12 KB one carrying the same
// 1,024 triples (chip_smoke.py phase 4, `time_param_structs`).
constexpr int kMidParamBytes =
    12 * 1024 + 64 < kMaxParamBytes ? 12 * 1024 + 64 : kMaxParamBytes;

constexpr int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// The batch entries the serve kernels (serve_order.cu, serve_counts.cu)
// take by value: each entry's [6, N] lane pointer and query container, 12
// bytes an entry. kLaneEntries is the most one launch takes (the largest
// power of two whose struct fits beside kLaneOtherParamBytes of other
// parameters: 2,048 under CUDA 12.1 and later, 256 under the old
// 4,096-byte limit); kMidLaneEntries (1,024) and kSmallLaneEntries (64)
// size the two smaller structs.
constexpr int kLaneOtherParamBytes = 64;
constexpr int kLaneEntries =
    pow2_floor((kMaxParamBytes - kLaneOtherParamBytes) / 12);
constexpr int kMidLaneEntries =
    pow2_floor((kMidParamBytes - kLaneOtherParamBytes) / 12);
constexpr int kSmallLaneEntries = 64 < kMidLaneEntries ? 64 : kMidLaneEntries;

template <int K>
struct LaneEntries {
  const int* lanes[K];
  int qobj[K];
};
static_assert(sizeof(LaneEntries<kLaneEntries>) + kLaneOtherParamBytes <=
                  kMaxParamBytes,
              "the entries exceed one launch's parameters");
