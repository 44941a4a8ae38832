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
