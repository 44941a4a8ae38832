// Kernel 11 of the port: the ring all-gather across the ranks of a mesh.
//
// Replaces hypermerge_tpu/parallel/sharded.py::_pallas_ring_gather (:134,
// the repo's one pl.pallas_call, :177), which every chip runs to assemble
// the replicated [n*rows, W] array from its [rows, W] block: n-1 steps of
// make_async_remote_copy to the right neighbour through two VMEM slots.
// This kernel computes the same array; it does not copy the mechanism.
//
// Rank r owns out_r [n * block_bytes] and a flag row flags_r int32[n]
// (slots 0..n-2: one per step; slot n-1: the rank's error word). It
// copies local_r into out_r[r] and out_{r+1}[r] and raises flag 0 of its
// right neighbour. At step s (1..n-2) it waits until its own flag s-1
// shows that block (r-s) mod n has arrived in out_r, copies that block
// into out_{r+1} at the same offset and raises the neighbour's flag s.
// Last it waits for its own flag n-2. Every output block is written once
// per call: no slot is reused, so no consumer handshake is needed, where
// the TPU kernel's two slots could be overwritten while still in use.
//
// Flags persist across calls; each call carries a new epoch (a counter
// per ring), and a wait passes once the flag is >= the epoch: with cards
// of their own, a fast left neighbour may already have raised the flag
// for the next call, which also means it finished this one. A raise is
// a system-scope release (every thread fences, then one thread stores), a
// wait a system-scope acquire (a volatile poll, then a fence). The poll
// backs off with __nanosleep and gives up after timeout_ns (counted in SM
// cycles at 2 per ns, the H100's boost clock, so the bound is not shorter
// on a slower clock): the rank then sets its error word and returns, and
// so does every rank that waits on it. The wrapper reads the error words
// and raises; the kernel never hangs.
//
// One device function, two launches. Virtual ranks (every rank on one
// card): one cooperative launch of n blocks, block b being rank b, so
// that all ranks are resident at once. Peer ranks (one card each): one
// launch of one block per card on that card's stream, reading the other
// cards' buffers over NVLink.
//
// What bounds it on the H100: bytes. With virtual ranks it moves
// 2 * n * (n-1) * block_bytes (each forwarded block read and written)
// through device memory; with peer ranks each card sends (n-1) blocks over
// its link. One block of 1024 threads per rank, 16-byte copies (four in
// flight per thread) where the two addresses agree modulo 16 and bytes
// elsewhere: the simple version.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRanks = 16;
constexpr int kErrTimeout = 1;
constexpr long long kCyclesPerNs = 2;

struct RingArgs {
  const unsigned char* local[kMaxRanks];  // rank r's block
  unsigned char* out[kMaxRanks];          // rank r's [n * block_bytes] output
  int* flags[kMaxRanks];                  // rank r's int32[n] flag row
  long long block_bytes;
  long long timeout_cycles;
  int n;
  int rank0;        // the rank of block 0 of this launch
  int epoch;
  int silent_rank;  // test hook: this rank never raises a flag (-1: none)
};

__device__ __forceinline__ void copy_block(unsigned char* dst,
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
  // four loads in flight per thread before their stores: one block per
  // rank has to keep enough bytes moving on its own
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

// release: the block's writes, then the flag
__device__ __forceinline__ void raise_flag(const RingArgs& a, int r, int dst,
                                           int step) {
  __threadfence_system();
  __syncthreads();
  if (threadIdx.x == 0 && r != a.silent_rank) {
    __threadfence_system();
    atomicExch_system(a.flags[dst] + step, a.epoch);
  }
}

// acquire: thread 0 polls rank r's flag for `step`; on timeout it sets
// the rank's error word, which every thread reads after the barrier
__device__ __forceinline__ bool arrive(const RingArgs& a, int r, int step) {
  int* err = a.flags[r] + (a.n - 1);
  if (threadIdx.x == 0) {
    const volatile int* flag = a.flags[r] + step;
    const long long t0 = clock64();
    unsigned ns = 32;
    bool ok = true;
    while (*flag < a.epoch) {
      if (clock64() - t0 > a.timeout_cycles) {
        ok = false;
        break;
      }
      __nanosleep(ns);
      if (ns < 1024) ns *= 2;
    }
    __threadfence_system();
    if (!ok) atomicExch_system(err, kErrTimeout);
  }
  __syncthreads();
  return *reinterpret_cast<volatile int*>(err) == 0;
}

__global__ void __launch_bounds__(kThreads) ring_gather_kernel(RingArgs a) {
  const int n = a.n;
  const int r = a.rank0 + static_cast<int>(blockIdx.x);
  const int right = (r + 1) % n;
  const long long B = a.block_bytes;
  copy_block(a.out[r] + r * B, a.local[r], B);
  if (n == 1) return;
  copy_block(a.out[right] + r * B, a.local[r], B);
  raise_flag(a, r, right, 0);
  for (int s = 1; s < n - 1; ++s) {
    if (!arrive(a, r, s - 1)) return;
    const long long blk = (r - s + n) % n;
    copy_block(a.out[right] + blk * B, a.out[r] + blk * B, B);
    raise_flag(a, r, right, s);
  }
  arrive(a, r, n - 2);
}

}  // namespace

// locals, outs, flags: host arrays of n device pointers (rank order);
// launches ranks [rank0, rank0 + count) as one cooperative grid on
// `stream`: count == n for virtual ranks, count == 1 per card for peer
// ranks. silent_rank is a test hook (-1 in use). Returns the launch's
// error code.
extern "C" int hm_ring_gather(const long long* locals, const long long* outs,
                              const long long* flags, int n, int rank0,
                              int count, long long block_bytes, int epoch,
                              int silent_rank, long long timeout_ns,
                              void* stream) {
  if (n < 1 || n > kMaxRanks || count < 1 || rank0 < 0 || rank0 + count > n)
    return static_cast<int>(cudaErrorInvalidValue);
  RingArgs a = {};
  for (int r = 0; r < n; ++r) {
    a.local[r] = reinterpret_cast<const unsigned char*>(locals[r]);
    a.out[r] = reinterpret_cast<unsigned char*>(outs[r]);
    a.flags[r] = reinterpret_cast<int*>(flags[r]);
  }
  a.block_bytes = block_bytes;
  a.timeout_cycles = timeout_ns * kCyclesPerNs;
  a.n = n;
  a.rank0 = rank0;
  a.epoch = epoch;
  a.silent_rank = silent_rank;
  void* params[] = {&a};
  int rc = static_cast<int>(cudaLaunchCooperativeKernel(
      ring_gather_kernel, dim3(count), dim3(kThreads), params, 0,
      static_cast<cudaStream_t>(stream)));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

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
