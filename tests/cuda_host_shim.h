// Run a CUDA kernel source on the host, for tests on machines without a GPU.
//
// tests/test_torch_kernel_sources.py compiles the port's .cu files with
// g++ against this header. Every CUDA thread of a block is a std::thread;
// __syncthreads() is a std::barrier over the block, a warp ballot or
// shuffle is a std::barrier over its 32 threads; atomics are GCC builtins.
// A <<<>>> launch runs its blocks one after another (a 2-D grid row by
// row), each with the dynamic shared memory the launch asks for; a cooperative launch
// (cudaLaunchCooperativeKernel) runs every thread of every block at once,
// as the ring gather's blocks wait on each other. Launches from several
// host threads at once (one per card, as peer ranks run) keep their own
// grid and block shapes. A kernel parameter passed by value
// (`const __grid_constant__`, a struct of up to the 32,764 bytes CUDA
// 12.1 allows) is copied to each thread that runs the kernel: a 24 KB
// struct costs 24 KB of every std::thread's stack. CUDART_VERSION is
// that of a CUDA 12.4 toolkit unless the build defines another, and the
// one device has HM_SHIM_SMS SMs (132 unless defined) and lets a block
// opt into HM_SHIM_SHARED_OPTIN bytes of shared memory (232,448). A
// cudaMemcpyAsync is a memcpy, done when it returns, and so is an
// asynchronous copy into shared memory (`__pipeline_memcpy_async`). What
// this checks is
// the kernel's logic (phases, barriers, indexing, sort keys, flag
// protocols), not its speed or the GPU compiler's view of it.
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __grid_constant__
#ifndef CUDART_VERSION
#define CUDART_VERSION 12040
#endif
#define __shared__ static  // a block's shared memory; kernels launched
                           // cooperatively here must not use it

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorPeerAccessAlreadyEnabled = 704;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
constexpr int cudaMemcpyHostToDevice = 1;
constexpr int cudaMemcpyDeviceToHost = 2;
inline int cudaGetLastError() { return 0; }
inline int cudaMemcpyAsync(void* dst, const void* src, size_t bytes, int,
                           cudaStream_t) {
  std::memcpy(dst, src, bytes);
  return 0;
}
inline int cudaStreamSynchronize(cudaStream_t) { return 0; }
inline int cudaDeviceEnablePeerAccess(int, unsigned) { return 0; }
// one device, with the SM count and the shared memory a block may opt
// into of an H100 SXM unless the build defines others
#ifndef HM_SHIM_SMS
#define HM_SHIM_SMS 132
#endif
#ifndef HM_SHIM_SHARED_OPTIN
#define HM_SHIM_SHARED_OPTIN 232448
#endif
constexpr int cudaDevAttrMultiProcessorCount = 16;
constexpr int cudaDevAttrMaxSharedMemoryPerBlockOptin = 97;
inline int cudaGetDevice(int* device) {
  *device = 0;
  return 0;
}
inline int cudaDeviceGetAttribute(int* value, int attr, int) {
  if (attr == cudaDevAttrMultiProcessorCount) {
    *value = HM_SHIM_SMS;
  } else if (attr == cudaDevAttrMaxSharedMemoryPerBlockOptin) {
    *value = HM_SHIM_SHARED_OPTIN;
  } else {
    return cudaErrorInvalidValue;
  }
  return 0;
}
template <class F>
inline int cudaFuncSetAttribute(F, int, int) {
  return 0;
}
// the blocks of `block` threads one SM holds at once: its 2,048 threads
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* blocks, F,
                                                         int block, size_t) {
  *blocks = 2048 / block;
  return 0;
}

struct shim_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
struct uint4 {
  unsigned x, y, z, w;
};
struct int4 {
  int x, y, z, w;
};
inline thread_local shim_dim3 threadIdx, blockIdx, blockDim, gridDim;

// one block's barriers, ballot words, shuffle slots and dynamic shared
// memory
struct shim_block {
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<unsigned long long> shuffles;  // 32 slots per warp
  std::vector<unsigned long long> dynamic;
  unsigned ballots[32] = {};
  shim_block(int threads, size_t dynamic_bytes)
      : bar(threads), shuffles(threads), dynamic((dynamic_bytes + 7) / 8) {
    for (int w = 0; w < threads / 32; ++w)
      warps.push_back(std::make_unique<std::barrier<>>(32));
  }
};
inline thread_local shim_block* shim_current;

inline void __syncthreads() { shim_current->bar.arrive_and_wait(); }

inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::barrier<>& bar = *shim_current->warps[w];
  unsigned* word = &shim_current->ballots[w];
  bar.arrive_and_wait();  // every lane has read the previous ballot
  if (lane == 0) *word = 0;
  bar.arrive_and_wait();
  __atomic_fetch_or(word, pred ? (1u << lane) : 0u, __ATOMIC_SEQ_CST);
  bar.arrive_and_wait();
  return __atomic_load_n(word, __ATOMIC_SEQ_CST);
}

// the lane's value from lane ^ mask of its warp; every lane takes part
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  static_assert(sizeof(T) <= sizeof(unsigned long long));
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::barrier<>& bar = *shim_current->warps[w];
  unsigned long long* slot = &shim_current->shuffles[32 * w];
  bar.arrive_and_wait();  // every lane has read the previous exchange
  std::memcpy(&slot[lane], &v, sizeof(T));
  bar.arrive_and_wait();
  T out;
  std::memcpy(&out, &slot[lane ^ mask], sizeof(T));
  return out;
}

// `extern __shared__ T name[];` becomes `T* name = shim_dynamic_shared<T>();`
template <class T>
inline T* shim_dynamic_shared() {
  return reinterpret_cast<T*>(shim_current->dynamic.data());
}

inline int __popc(unsigned x) { return __builtin_popcount(x); }

inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}

inline int atomicExch(int* p, int v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}

inline int atomicMax(int* p, int v) {
  int cur = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (cur < v && !__atomic_compare_exchange_n(p, &cur, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return cur;
}

inline int atomicMin(int* p, int v) {
  int cur = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (cur > v && !__atomic_compare_exchange_n(p, &cur, v, false,
                                                 __ATOMIC_SEQ_CST,
                                                 __ATOMIC_SEQ_CST)) {
  }
  return cur;
}

// system scope: the host's threads share one memory, so the fence and the
// exchange are the ordinary sequentially consistent ones
inline int atomicExch_system(int* p, int v) {
  return __atomic_exchange_n(p, v, __ATOMIC_SEQ_CST);
}
inline void __threadfence_system() {
  std::atomic_thread_fence(std::memory_order_seq_cst);
}
inline void __nanosleep(unsigned ns) {
  std::this_thread::sleep_for(std::chrono::nanoseconds(ns));
}
// the SM cycle counter, read as nanoseconds of the host's steady clock
inline long long clock64() {
  return std::chrono::duration_cast<std::chrono::nanoseconds>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}
template <class T>
inline T __ldcg(const T* p) {
  return *p;
}
template <class T>
inline T __ldg(const T* p) {
  return *p;
}
// (hi:lo) >> (shift & 31), the low 32 bits
inline unsigned __funnelshift_r(unsigned lo, unsigned hi, unsigned shift) {
  const unsigned long long v = (static_cast<unsigned long long>(hi) << 32) | lo;
  return static_cast<unsigned>(v >> (shift & 31));
}
// cuda_pipeline_primitives.h: a copy into shared memory, done when it
// returns, so a commit and a wait have nothing to do
inline void __pipeline_memcpy_async(void* dst, const void* src, size_t bytes,
                                    size_t = 0) {
  std::memcpy(dst, src, bytes);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}

// the blocks of grid.x x grid.y, x fastest: one after another (sequential)
// or all at once
inline void shim_run(dim3 shape, int block, size_t dynamic_bytes,
                     bool concurrent, const std::function<void()>& body) {
  const int gx = static_cast<int>(shape.x), gy = static_cast<int>(shape.y);
  const int grid = gx * gy;
  const int waves = concurrent ? 1 : grid;
  const int per_wave = concurrent ? grid : 1;
  for (int w = 0; w < waves; ++w) {
    std::vector<std::unique_ptr<shim_block>> blocks;
    std::vector<std::thread> threads;
    for (int k = 0; k < per_wave; ++k)
      blocks.push_back(std::make_unique<shim_block>(block, dynamic_bytes));
    for (int k = 0; k < per_wave; ++k) {
      const int b = w * per_wave + k;
      shim_block* ctx = blocks[k].get();
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&body, ctx, t, b, gx, gy, block] {
          shim_current = ctx;
          threadIdx.x = t;
          blockIdx.x = b % gx;
          blockIdx.y = b / gx;
          blockDim.x = block;
          gridDim.x = gx;
          gridDim.y = gy;
          body();
        });
    }
    for (auto& th : threads) th.join();
  }
}

// stands in for kernel<<<grid, block, dynamic_bytes, stream>>>(...)
inline void shim_launch(dim3 grid, int block, size_t dynamic_bytes,
                        const std::function<void()>& body) {
  shim_run(grid, block, dynamic_bytes, false, body);
}

// every block resident at once, as the card guarantees for this launch
template <class Arg>
inline int cudaLaunchCooperativeKernel(void (*kernel)(Arg), dim3 grid,
                                       dim3 block, void** params, size_t,
                                       cudaStream_t) {
  Arg arg = *static_cast<Arg*>(params[0]);
  shim_run(grid.x, block.x, 0, true, [&] { kernel(arg); });
  return 0;
}
