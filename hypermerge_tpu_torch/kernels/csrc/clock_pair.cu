// Kernel 4 of the port: the pairwise vector-clock algebra.
//
// Replaces hypermerge_tpu/ops/clock_kernels.py gte (:28), cmp (:34), union
// (:46), intersection (:51), satisfied (:63) and cursor_window (:70), and
// with them the two broadcast queries built on gte: the mirror's
// `jnp.all(m <= q)` (ops/clock_mirror.py:262-272) and ClockStore's
// `gte(jnp_broadcast(q, rows), rows)` (storage/stores.py:212-219).
//
// Operands are [R, A] int32 clocks. Each of a and b comes with a row
// stride: A for a full matrix, 0 for one row broadcast to every row (the
// query of a dominated scan), so no broadcast copy is ever made.
//   op 0 gte:           [R] bool, all(a >= b) over the actors
//   op 1 cmp:           [R] int32 code, EQ 0 / GT 1 / LT 2 / CONCUR 3
//                       (clock_kernels.py:25)
//   op 2 union:         [R, A] int32, max(a, b)
//   op 3 intersection:  [R, A] int32, min(a, b)
//   op 4 cursor_window: [R, A] int32, max(min(b, INT32_INF) - a, 0) with
//                       a the doc's seqs and b the cursor's; min(b, INF)
//                       is the identity on int32, and the subtraction
//                       wraps as int32 arithmetic does in XLA
//
// What bounds it on the H100: bytes. Every op reads each input element
// once and does one or two compares per element. The row ops give a warp
// to a row: lanes stride over the actors (neighbouring lanes read
// neighbouring addresses) and one warp ballot per flag folds the row, so
// no shared memory and no barrier. The elementwise ops walk the [R, A]
// cells with a grid stride.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;
constexpr int kMaxBlocks = 2048;
constexpr unsigned kFullMask = 0xffffffffu;
enum { kGte = 0, kCmp = 1, kUnion = 2, kIntersection = 3, kCursorWindow = 4 };
enum { kEq = 0, kGt = 1, kLt = 2, kConcur = 3 };

struct Args {
  const int* a;
  const int* b;
  long long a_stride, b_stride;  // elements between rows; 0 = broadcast
  long long R;
  int A;
  int op;
  void* out;  // uint8 [R] for gte, int32 [R] for cmp, int32 [R, A] else
};

__global__ void __launch_bounds__(kThreads) clock_pair_kernel(Args p) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long threads = (long long)gridDim.x * blockDim.x;
  if (p.op >= kUnion) {
    int* out = static_cast<int*>(p.out);
    const long long cells = p.R * p.A;
    for (long long i = tid; i < cells; i += threads) {
      const long long r = i / p.A;
      const long long c = i - r * p.A;
      const int x = p.a[r * p.a_stride + c];
      const int y = p.b[r * p.b_stride + c];
      int v;
      if (p.op == kUnion) {
        v = x > y ? x : y;
      } else if (p.op == kIntersection) {
        v = x < y ? x : y;
      } else {
        const int d = static_cast<int>(static_cast<unsigned>(y) -
                                       static_cast<unsigned>(x));
        v = d > 0 ? d : 0;
      }
      out[i] = v;
    }
    return;
  }
  // row ops: warp w takes rows w, w + warps, ...; every lane of a warp
  // runs the same iterations, so the ballots see the whole warp
  const int lane = threadIdx.x % kWarp;
  const long long warps = threads / kWarp;
  for (long long r = tid / kWarp; r < p.R; r += warps) {
    const int* ar = p.a + r * p.a_stride;
    const int* br = p.b + r * p.b_stride;
    bool ge = true, le = true;
    for (int c = lane; c < p.A; c += kWarp) {
      const int x = ar[c], y = br[c];
      ge = ge && x >= y;
      le = le && x <= y;
    }
    const bool all_ge = __ballot_sync(kFullMask, ge) == kFullMask;
    if (p.op == kGte) {
      if (lane == 0) static_cast<uint8_t*>(p.out)[r] = all_ge ? 1 : 0;
    } else {
      const bool all_le = __ballot_sync(kFullMask, le) == kFullMask;
      const int code = all_ge && all_le ? kEq
                       : all_ge         ? kGt
                       : all_le         ? kLt
                                        : kConcur;
      if (lane == 0) static_cast<int*>(p.out)[r] = code;
    }
  }
}

}  // namespace

// a and b are device int32 clocks with A actors, R rows of the result;
// a_stride / b_stride are A for a full [R, A] operand and 0 for one [A]
// row broadcast to all rows. Returns cudaGetLastError() of the launch.
extern "C" int hm_clock_pair(const int* a, const int* b, int a_stride,
                             int b_stride, int R, int A, int op, void* out,
                             void* stream) {
  Args p;
  p.a = a;
  p.b = b;
  p.a_stride = a_stride;
  p.b_stride = b_stride;
  p.R = R;
  p.A = A;
  p.op = op;
  p.out = out;
  const long long work = op >= kUnion ? (long long)R * A : (long long)R * kWarp;
  if (work <= 0) return 0;
  const long long blocks = (work + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  clock_pair_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
