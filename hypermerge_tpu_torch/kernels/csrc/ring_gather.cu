// Kernel 11 of the port: the all-gather across the ranks of a mesh.
//
// Replaces hypermerge_tpu/parallel/sharded.py::_pallas_ring_gather (:134,
// the repo's one pl.pallas_call, :177), which every chip runs to assemble
// the replicated [n*rows, W] array from its [rows, W] block: n-1 steps of
// make_async_remote_copy to the right neighbour through two VMEM slots.
// This kernel computes the same array; it does not copy the mechanism.
// Every rank's block src lands in the output at offset src * block_bytes.
//
// What bounds it on the H100: bytes. With virtual ranks (every rank on
// one card) the n ranks' arrays are equal and on one device, so the
// kernel writes one concatenation, which every rank shares: 2n x
// block_bytes (each input read once, each output byte written once) over
// 3.35 TB/s. With peer ranks, each card's n-1 outgoing blocks over its
// 450 GB/s of NVLink. The first version forwarded blocks around the ring,
// one 1024-thread block per rank, each step waiting on its left
// neighbour's flag: 4 SMs of 132 at n = 4, about 98 GB/s each, 13.7x the
// bound. Here every block copies one slice of a source block to its place
// in each output, so there is no chain to wait on, and the grid is sized
// by the wrapper to fill the card.
//
// push_kernel (virtual ranks). One ordinary launch of n x slices blocks:
// block b copies slice (b % slices) of local[b / slices] into out[0].
// 16-byte copies, four loads in flight per thread, where destination and
// source agree modulo 16, bytes elsewhere (a head up to the first aligned
// byte and the tail). No flag and no wait: all ranks share the card's
// current stream, and stream order is the barrier, as it is for the JAX
// program.
//
// flagged_kernel (peer ranks: one card each, one cooperative launch of
// `blocks` blocks per card; over virtual ranks, all of them in one
// cooperative grid, which keeps the protocol testable on one card). The
// blocks of rank r copy the slices of local[r] into every rank's output
// over NVLink, then count themselves done on rank r's counter; the last
// one fences at system scope, raises flags[d][r] = epoch on every rank d,
// and waits until every flags[r][src] >= epoch: then out_r is whole.
// Flags persist across calls; each call carries a new epoch (a counter per
// ring), and a wait passes at >= because a rank that already raised its
// flags for a later call has also finished this one. The wait backs off
// with __nanosleep and gives up after timeout_ns (counted in SM cycles at
// 2 per ns, the H100's boost clock, so the bound is not shorter on a
// slower clock): the rank then sets its error word and returns. The
// wrapper reads the error words and raises; the kernel never hangs.
//
// Rank r's flag row, int32[n + 2]: slot src is src's arrival flag, slot n
// the error word, slot n + 1 the count of r's finished blocks.
//
// Built with HM_RING_TEST_HOOKS defined (the tests' builds only), the
// library also exports hm_ring_test_hooks: a rank that never raises its
// flags and a rank that waits before its pushes, so that a test can make
// the protocol time out or wait.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRanks = 16;
constexpr int kErrTimeout = 1;
constexpr long long kCyclesPerNs = 2;
constexpr int kPush = 0, kFlagged = 1;

struct RingArgs {
  const unsigned char* local[kMaxRanks];  // rank r's block
  unsigned char* out[kMaxRanks];  // rank r's [n * block_bytes] output (push: out[0])
  int* flags[kMaxRanks];          // rank r's int32[n + 2] flag row
  long long block_bytes;
  long long slice_bytes;  // a multiple of 16
  long long timeout_cycles;
  int n;
  int rank0;   // the rank of the launch's first block (flagged)
  int blocks;  // blocks per rank (flagged)
  int slices;  // slices per source block
  int epoch;
#ifdef HM_RING_TEST_HOOKS
  int silent_rank;  // never raises a flag (-1: none)
  int late_rank;    // waits late_cycles before its pushes (-1: none)
  long long late_cycles;
#endif
};

#ifdef HM_RING_TEST_HOOKS
int g_silent_rank = -1, g_late_rank = -1;
long long g_late_ns = 0;
#endif

// bytes [0, nbytes) of src to dst by the block's threads
__device__ __forceinline__ void copy_span(unsigned char* dst,
                                          const unsigned char* src,
                                          long long nbytes) {
  const long long t = threadIdx.x, stride = blockDim.x;
  const uintptr_t d = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t s = reinterpret_cast<uintptr_t>(src);
  long long head = nbytes;  // bytes copied one at a time before the vectors
  if (((d ^ s) & 15) == 0) {
    head = static_cast<long long>((16 - (d & 15)) & 15);
    if (head > nbytes) head = nbytes;
  }
  for (long long i = t; i < head; i += stride) dst[i] = __ldcg(src + i);
  const long long nvec = (nbytes - head) / 16;
  const uint4* sv = reinterpret_cast<const uint4*>(src + head);
  uint4* dv = reinterpret_cast<uint4*>(dst + head);
  long long i = t;
  for (; i + 3 * stride < nvec; i += 4 * stride) {
    const uint4 v0 = __ldcg(sv + i), v1 = __ldcg(sv + i + stride);
    const uint4 v2 = __ldcg(sv + i + 2 * stride);
    const uint4 v3 = __ldcg(sv + i + 3 * stride);
    dv[i] = v0;
    dv[i + stride] = v1;
    dv[i + 2 * stride] = v2;
    dv[i + 3 * stride] = v3;
  }
  for (; i < nvec; i += stride) dv[i] = __ldcg(sv + i);
  for (long long i = head + nvec * 16 + t; i < nbytes; i += stride)
    dst[i] = __ldcg(src + i);
}

// slice `slice` of local[src] to src's place in the first `ndst` outputs
__device__ __forceinline__ void push_slice(const RingArgs& a, int src,
                                           int slice, int ndst) {
  const long long lo = slice * a.slice_bytes;
  if (lo >= a.block_bytes) return;
  const long long nbytes = (lo + a.slice_bytes < a.block_bytes
                                ? lo + a.slice_bytes : a.block_bytes) - lo;
  const unsigned char* src_p = a.local[src] + lo;
  for (int d = 0; d < ndst; ++d)
    copy_span(a.out[d] + src * a.block_bytes + lo, src_p, nbytes);
}

__global__ void push_kernel(RingArgs a) {
  push_slice(a, static_cast<int>(blockIdx.x) / a.slices,
             static_cast<int>(blockIdx.x) % a.slices, 1);
}

// rank r is done with its pushes once all its blocks are: the last block's
// thread 0 raises r's arrival flag on every rank, then waits for every
// rank's flag on r's row; on timeout it sets r's error word
__device__ __forceinline__ void arrive(const RingArgs& a, int r) {
  __threadfence_system();  // this thread's pushes, before the count
  __syncthreads();
  if (threadIdx.x != 0) return;
  int* row = a.flags[r];
  const int n = a.n;
  if (atomicAdd(row + n + 1, 1) + 1 < a.blocks) return;
  atomicExch(row + n + 1, 0);  // the count, for the next call
  __threadfence_system();      // every block's pushes, before the flags
#ifdef HM_RING_TEST_HOOKS
  if (r != a.silent_rank)
#endif
    for (int d = 0; d < n; ++d) atomicExch_system(a.flags[d] + r, a.epoch);
  const long long t0 = clock64();
  for (int src = 0; src < n; ++src) {
    const volatile int* flag = row + src;
    unsigned ns = 32;
    while (*flag < a.epoch) {
      if (clock64() - t0 > a.timeout_cycles) {
        atomicExch_system(row + n, kErrTimeout);
        return;
      }
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
  }
  __threadfence_system();
}

__global__ void flagged_kernel(RingArgs a) {
  const int r = a.rank0 + static_cast<int>(blockIdx.x) / a.blocks;
  const int g = static_cast<int>(blockIdx.x) % a.blocks;
#ifdef HM_RING_TEST_HOOKS
  if (r == a.late_rank)
    for (const long long t0 = clock64(); clock64() - t0 < a.late_cycles;)
      __nanosleep(1000);
#endif
  for (int slice = g; slice < a.slices; slice += a.blocks)
    push_slice(a, r, slice, a.n);
  arrive(a, r);
}

}  // namespace

// locals, outs, flags: host arrays of device pointers in rank order.
// mode 0 (push): one launch of n * slices blocks over every rank into the
// one output outs[0] (rank0 = 0, count = n; flags unused). mode 1
// (flagged): ranks [rank0, rank0 + count) as one cooperative grid of
// `blocks` blocks each, into all n outputs: count == n for virtual ranks,
// 1 per card for peer ranks. threads: a block's threads. Returns the
// launch's error code.
extern "C" int hm_ring_gather(const long long* locals, const long long* outs,
                              const long long* flags, int n, int rank0,
                              int count, long long block_bytes, int epoch,
                              long long timeout_ns, int mode, int threads,
                              int slices, int blocks, void* stream) {
  if (n < 1 || n > kMaxRanks || count < 1 || rank0 < 0 || rank0 + count > n ||
      threads < 1 || slices < 1 || blocks < 1 || block_bytes < 0 ||
      (mode != kPush && mode != kFlagged) ||
      (mode == kPush && (rank0 != 0 || count != n)))
    return static_cast<int>(cudaErrorInvalidValue);
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.local[r] = reinterpret_cast<const unsigned char*>(locals[r]);
    if (mode == kFlagged) {
      a.out[r] = reinterpret_cast<unsigned char*>(outs[r]);
      a.flags[r] = reinterpret_cast<int*>(flags[r]);
    }
  }
  if (mode == kPush) a.out[0] = reinterpret_cast<unsigned char*>(outs[0]);
  a.block_bytes = block_bytes;
  a.slice_bytes = ((block_bytes + slices - 1) / slices + 15) / 16 * 16;
  if (a.slice_bytes == 0) a.slice_bytes = 16;
  a.timeout_cycles = timeout_ns * kCyclesPerNs;
  a.n = n;
  a.rank0 = rank0;
  a.blocks = blocks;
  a.slices = slices;
  a.epoch = epoch;
#ifdef HM_RING_TEST_HOOKS
  a.silent_rank = g_silent_rank;
  a.late_rank = g_late_rank;
  a.late_cycles = g_late_ns * kCyclesPerNs;
#endif
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == kPush) {
    push_kernel<<<n * slices, threads, 0, s>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  void* params[] = {&a};
  int rc = static_cast<int>(cudaLaunchCooperativeKernel(
      flagged_kernel, dim3(count * blocks), dim3(threads), params, 0, s));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

#ifdef HM_RING_TEST_HOOKS
// The hooks of the launches that follow: silent_rank never raises its
// flags; late_rank waits late_ns before its pushes (-1: none).
extern "C" void hm_ring_test_hooks(int silent_rank, int late_rank,
                                   long long late_ns) {
  g_silent_rank = silent_rank;
  g_late_rank = late_rank;
  g_late_ns = late_ns;
}
#endif

// Peer access from the current device to `peer`, once per pair; "already
// enabled" counts as success.
extern "C" int hm_ring_enable_peer(int peer) {
  cudaError_t rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky-free error state
    return 0;
  }
  return static_cast<int>(rc);
}
