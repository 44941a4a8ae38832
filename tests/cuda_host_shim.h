// Run a CUDA kernel source on the host, for tests on machines without a GPU.
//
// tests/test_torch_kernel_sources.py compiles the port's .cu files with
// g++ against this header. Every CUDA thread of a block is a std::thread;
// __syncthreads() is a std::barrier over the block, a warp ballot is a
// std::barrier over its 32 threads; atomics are GCC builtins; blocks run one
// after another. What this checks is the kernel's logic (phases, barriers,
// indexing, sort keys), not its speed or the GPU compiler's view of it.
#pragma once
#include <barrier>
#include <cstdint>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static  // one block runs at a time

typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }

struct shim_dim3 {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local shim_dim3 threadIdx, blockIdx;
inline shim_dim3 blockDim, gridDim;

inline std::barrier<>* shim_block_barrier;
inline std::vector<std::unique_ptr<std::barrier<>>> shim_warp_barriers;
inline unsigned shim_ballots[32];

inline void __syncthreads() { shim_block_barrier->arrive_and_wait(); }

inline unsigned __ballot_sync(unsigned, int pred) {
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32;
  std::barrier<>& bar = *shim_warp_barriers[w];
  bar.arrive_and_wait();  // every lane has read the previous ballot
  if (lane == 0) shim_ballots[w] = 0;
  bar.arrive_and_wait();
  __atomic_fetch_or(&shim_ballots[w], pred ? (1u << lane) : 0u,
                    __ATOMIC_SEQ_CST);
  bar.arrive_and_wait();
  return __atomic_load_n(&shim_ballots[w], __ATOMIC_SEQ_CST);
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

// stands in for kernel<<<grid, block, 0, stream>>>(...)
inline void shim_launch(int grid, int block, const std::function<void()>& body) {
  blockDim.x = block;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    shim_block_barrier = &bar;
    shim_warp_barriers.clear();
    for (int w = 0; w < block / 32; ++w)
      shim_warp_barriers.push_back(std::make_unique<std::barrier<>>(32));
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        body();
      });
    for (auto& th : threads) th.join();
  }
}
