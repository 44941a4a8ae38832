// Run a CUDA kernel source on the host, for tests on machines without a GPU.
//
// tests/test_torch_kernel_sources.py compiles the port's .cu files with
// g++ against this header. Every CUDA thread of a block is a std::thread;
// __syncthreads() is a std::barrier over the block, a warp ballot is a
// std::barrier over its 32 threads; atomics are GCC builtins. A <<<>>>
// launch runs its blocks one after another; a cooperative launch
// (cudaLaunchCooperativeKernel) runs every thread of every block at once,
// as the ring gather's blocks wait on each other. What this checks is the
// kernel's logic (phases, barriers, indexing, sort keys, flag protocols),
// not its speed or the GPU compiler's view of it.
#pragma once
#include <atomic>
#include <barrier>
#include <chrono>
#include <cstddef>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static  // a block's shared memory; kernels launched
                           // cooperatively here must not use it

typedef void* cudaStream_t;
typedef int cudaError_t;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorPeerAccessAlreadyEnabled = 704;
inline int cudaGetLastError() { return 0; }
inline int cudaDeviceEnablePeerAccess(int, unsigned) { return 0; }

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
inline thread_local shim_dim3 threadIdx, blockIdx;
inline shim_dim3 blockDim, gridDim;

// one block's barriers and ballot words
struct shim_block {
  std::barrier<> bar;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  unsigned ballots[32] = {};
  explicit shim_block(int threads) : bar(threads) {
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

inline int __popc(unsigned x) { return __builtin_popcount(x); }

inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
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

// blocks [0, grid): one after another (sequential) or all at once
inline void shim_run(int grid, int block, bool concurrent,
                     const std::function<void()>& body) {
  blockDim.x = block;
  gridDim.x = grid;
  const int waves = concurrent ? 1 : grid;
  const int per_wave = concurrent ? grid : 1;
  for (int w = 0; w < waves; ++w) {
    std::vector<std::unique_ptr<shim_block>> blocks;
    std::vector<std::thread> threads;
    for (int k = 0; k < per_wave; ++k)
      blocks.push_back(std::make_unique<shim_block>(block));
    for (int k = 0; k < per_wave; ++k) {
      const int b = w * per_wave + k;
      shim_block* ctx = blocks[k].get();
      for (int t = 0; t < block; ++t)
        threads.emplace_back([&body, ctx, t, b] {
          shim_current = ctx;
          threadIdx.x = t;
          blockIdx.x = b;
          body();
        });
    }
    for (auto& th : threads) th.join();
  }
}

// stands in for kernel<<<grid, block, 0, stream>>>(...)
inline void shim_launch(int grid, int block, const std::function<void()>& body) {
  shim_run(grid, block, false, body);
}

// every block resident at once, as the card guarantees for this launch
template <class Arg>
inline int cudaLaunchCooperativeKernel(void (*kernel)(Arg), dim3 grid,
                                       dim3 block, void** params, size_t,
                                       cudaStream_t) {
  Arg arg = *static_cast<Arg*>(params[0]);
  shim_run(grid.x, block.x, true, [&] { kernel(arg); });
  return 0;
}
