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
// once and does one or two compares per element (config 5's dominated
// scan reads a [131072, 64] matrix, 33.5 MB, for 128 KB of verdicts).
//
// The layout, one for every op. A unit is an int4 (16 bytes) where A % 4
// == 0 and every operand's base and row stride are 16-byte aligned (the
// vector route), else an int (the scalar route). G lanes of a warp share a
// row, G the power of two at or above ceil(A / 4), at most 32, so a warp
// takes 32 / G rows a pass and neighbouring lanes read neighbouring
// addresses; lane j of a row owns units j, j + G, ... . Each lane keeps
// kRows rows in flight (its loads for all of them issue before the first
// compare), and a warp walks chunks of kRows x 32 / G consecutive rows
// with a grid stride, so the warps read one contiguous front of the
// matrix together (an equal share of rows a warp, each share one
// contiguous range, read 4% slower cold on an H100 SXM). The grid is what
// the card holds resident at once (its SM count x the kernel's blocks an
// SM, from the occupancy API), so it runs in one wave. No division per
// cell: a lane's row and units follow from shifts of its lane index. The
// kernel is compiled for each op, route, query struct and broadcast side,
// so each holds registers for the operands it reads.
//   The broadcast row (stride 0, either side) is the same for every row,
// so each lane loads its units of it into registers once (kHeld units;
// the units past those, for rows wider than 256 ints, are read again each
// row). It comes either from device memory or, on the by-value route,
// from a `const __grid_constant__` struct in the launch's parameters
// (params.cuh's limit: up to 4,096 ints under CUDA 12.1 and later, a
// 1 KB struct for rows of at most 256), so the query of a dominated scan
// needs no upload.
//   Row ops fold a row's flags across its G lanes with one warp ballot
// each; every lane reads every row's verdict from the ballot words, and
// lane t of the warp writes row t of the chunk, so a warp's verdict
// stores are contiguous. Elementwise ops store their units as they load
// them (int4 stores on the vector route).
//
// The entry optionally copies the result into a host buffer (pinned, the
// caller's) and waits for the stream, so a dominated scan returns its
// verdicts with no pageable copy. Every CUDA error is the entry's return
// code.
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

#include "params.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a lane has in flight
constexpr unsigned kFullMask = 0xffffffffu;
enum { kGte = 0, kCmp = 1, kUnion = 2, kIntersection = 3, kCursorWindow = 4 };
enum { kEq = 0, kGt = 1, kLt = 2, kConcur = 3 };
enum { kNone = -1, kSideA = 0, kSideB = 1 };  // the broadcast side

struct Args {
  const int* a;
  const int* b;
  long long a_stride, b_stride;  // elements between rows; 0 = broadcast
  long long R;
  int A;
  int log2g;  // G = 1 << log2g lanes a row
  void* out;  // uint8 [R] for gte, int32 [R] for cmp, int32 [R, A] else
};

// the query row by value: the ints of the largest struct (the largest
// power of two that fits beside Args) and of the small one
constexpr int kOtherParamBytes = 128;
constexpr int kMaxQuery = pow2_floor((kMaxParamBytes - kOtherParamBytes) / 4);
constexpr int kSmallQuery = 256 < kMaxQuery ? 256 : kMaxQuery;

template <int K>
struct QueryRow {
  int v[K];
};
static_assert(sizeof(Args) <= kOtherParamBytes, "Args outgrew its room");
static_assert(sizeof(QueryRow<kMaxQuery>) + kOtherParamBytes <= kMaxParamBytes,
              "the query row exceeds one launch's parameters");

// unit u of a row: an int4 on the vector route, an int (v[0]) else
template <bool kVec>
__device__ __forceinline__ void load_unit(const int* __restrict__ row, int u,
                                          int (&v)[4]) {
  if constexpr (kVec) {
    const int4 t = reinterpret_cast<const int4*>(row)[u];
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = row[u];
  }
}

// unit u of the broadcast row: from the parameters (kParam) or the device
template <bool kVec, bool kParam, int K>
__device__ __forceinline__ void bcast_unit(const int* __restrict__ row,
                                           const QueryRow<K>& q, int u,
                                           int (&v)[4]) {
  if constexpr (kParam) {
    constexpr int W = kVec ? 4 : 1;
#pragma unroll
    for (int i = 0; i < W; ++i) v[i] = q.v[u * W + i];
  } else {
    load_unit<kVec>(row, u, v);
  }
}

__device__ __forceinline__ int apply(int op, int x, int y) {
  if (op == kUnion) return x > y ? x : y;
  if (op == kIntersection) return x < y ? x : y;
  const int d =
      static_cast<int>(static_cast<unsigned>(y) - static_cast<unsigned>(x));
  return d > 0 ? d : 0;  // cursor_window: int32 wrap-around
}

// unit u of the kRows rows r0 + i * rpp + sub: the loads of every row
// first, then the flags (row ops) or the stores (elementwise ops); bc is
// the broadcast row's unit u
template <int kOp, bool kVec, int kSide>
__device__ __forceinline__ void step(const Args& p, long long r0, int rpp,
                                     int sub, int u, bool have,
                                     const int (&bc)[4], bool (&ge)[kRows],
                                     bool (&le)[kRows]) {
  constexpr int W = kVec ? 4 : 1;
  int x[kRows][4], y[kRows][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = r0 + i * rpp + sub;
    if (!have || r >= p.R) continue;
    if constexpr (kSide == kSideA) {
#pragma unroll
      for (int w = 0; w < W; ++w) x[i][w] = bc[w];
    } else {
      load_unit<kVec>(p.a + r * p.a_stride, u, x[i]);
    }
    if constexpr (kSide == kSideB) {
#pragma unroll
      for (int w = 0; w < W; ++w) y[i][w] = bc[w];
    } else {
      load_unit<kVec>(p.b + r * p.b_stride, u, y[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long r = r0 + i * rpp + sub;
    if (!have || r >= p.R) continue;
    if constexpr (kOp == kGte || kOp == kCmp) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        ge[i] = ge[i] && x[i][w] >= y[i][w];
        le[i] = le[i] && x[i][w] <= y[i][w];
      }
    } else {
      int* row = static_cast<int*>(p.out) + r * p.A;
      if constexpr (kVec) {
        int4 v;
        v.x = apply(kOp, x[i][0], y[i][0]);
        v.y = apply(kOp, x[i][1], y[i][1]);
        v.z = apply(kOp, x[i][2], y[i][2]);
        v.w = apply(kOp, x[i][3], y[i][3]);
        reinterpret_cast<int4*>(row)[u] = v;
      } else {
        row[u] = apply(kOp, x[i][0], y[i][0]);
      }
    }
  }
}

// kSide: the broadcast side whose row the lanes hold (kNone: two full
// operands); kQ: the ints of the by-value query row (0: the broadcast
// row, if any, is read from the device)
template <int kOp, bool kVec, int kQ, int kSide>
__global__ void __launch_bounds__(kThreads)
    clock_pair_kernel(const Args p,
                      const __grid_constant__ QueryRow<kQ ? kQ : 1> q) {
  constexpr bool kParam = kQ > 0;
  constexpr int kHeld = kVec ? 2 : 8;  // broadcast units a lane holds
  const int lane = threadIdx.x & 31;
  const int G = 1 << p.log2g;
  const int j = lane & (G - 1);
  const int sub = lane >> p.log2g;
  const int rpp = 32 >> p.log2g;  // rows a warp takes a pass
  const long long chunk = static_cast<long long>(kRows) * rpp;
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const long long warps =
      (static_cast<long long>(gridDim.x) * blockDim.x) >> 5;
  const int units = kVec ? p.A >> 2 : p.A;
  const int* hrow = kSide == kSideA ? p.a : p.b;
  int held[kHeld][4];
#pragma unroll
  for (int k = 0; k < kHeld; ++k) {
    if (kSide != kNone && j + k * G < units)
      bcast_unit<kVec, kParam>(hrow, q, j + k * G, held[k]);
  }
  // every lane of a warp runs the same iterations, so the ballots see
  // the whole warp
  for (long long r0 = warp * chunk; r0 < p.R; r0 += warps * chunk) {
    bool ge[kRows], le[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) ge[i] = le[i] = true;
#pragma unroll
    for (int k = 0; k < kHeld; ++k) {
      if (k * G < units)
        step<kOp, kVec, kSide>(p, r0, rpp, sub, j + k * G, j + k * G < units,
                               held[k], ge, le);
    }
    for (int k = kHeld; k * G < units; ++k) {
      const int u = j + k * G;
      int bc[4];
      if (kSide != kNone && u < units) bcast_unit<kVec, kParam>(hrow, q, u, bc);
      step<kOp, kVec, kSide>(p, r0, rpp, sub, u, u < units, bc, ge, le);
    }
    if constexpr (kOp == kGte || kOp == kCmp) {
      // bit l of bad[i]: lane l's columns of its row i fail; row (i, s)
      // holds if bits s*G .. s*G + G - 1 are clear
      unsigned bad_ge[kRows], bad_le[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        bad_ge[i] = __ballot_sync(kFullMask, !ge[i]);
        bad_le[i] = kOp == kCmp ? __ballot_sync(kFullMask, !le[i]) : 0u;
      }
      const unsigned gmask = G == 32 ? kFullMask : (1u << G) - 1;
      for (int t = lane; t < chunk && r0 + t < p.R; t += 32) {
        const int i = t >> (5 - p.log2g);  // t / rpp
        const int s = t & (rpp - 1);
        unsigned wge = 0, wle = 0;
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (k == i) {
            wge = bad_ge[k];
            wle = bad_le[k];
          }
        }
        const bool all_ge = ((wge >> (s * G)) & gmask) == 0;
        if constexpr (kOp == kGte) {
          static_cast<uint8_t*>(p.out)[r0 + t] = all_ge ? 1 : 0;
        } else {
          const bool all_le = ((wle >> (s * G)) & gmask) == 0;
          static_cast<int*>(p.out)[r0 + t] = all_ge && all_le ? kEq
                                             : all_ge         ? kGt
                                             : all_le         ? kLt
                                                              : kConcur;
        }
      }
    }
  }
}

int sm_count(int* sms) {
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc == 0)
    rc = static_cast<int>(
        cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
  return rc;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// one launch with the query row in a struct of K ints (K = 0: none):
// as many blocks as the rows need, at most what the card holds resident
// at once (its SM count x this kernel's blocks an SM), so the grid runs
// in one wave and each block's prologue (the held row) is paid once
template <int kOp, bool kVec, int K, int kSide>
int launch_sized(const Args& p, const int* query, long long blocks, int sms,
                 cudaStream_t stream) {
  static std::atomic<int> per_sm{0};  // this kernel's resident blocks
  auto kernel = clock_pair_kernel<kOp, kVec, K, kSide>;
  int fit = per_sm.load(std::memory_order_relaxed);
  if (fit == 0) {
    const int rc = static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel, kThreads, 0));
    if (rc != 0) return rc;
    fit = fit > 0 ? fit : 1;
    per_sm.store(fit, std::memory_order_relaxed);
  }
  const long long cap = static_cast<long long>(sms) * fit;
  const unsigned grid = static_cast<unsigned>(blocks < cap ? blocks : cap);
  QueryRow<K ? K : 1> q;
  if (K > 0)
    std::memcpy(q.v, query, static_cast<size_t>(p.A) * sizeof(int));
  else
    q.v[0] = 0;
  kernel<<<grid, kThreads, 0, stream>>>(p, q);
  return static_cast<int>(cudaGetLastError());
}

template <int kOp, bool kVec, int kSide>
int launch_query(const Args& p, const int* query, long long blocks, int sms,
                 cudaStream_t stream) {
  if constexpr (kSide != kNone) {
    if (query != nullptr)
      return p.A <= kSmallQuery
                 ? launch_sized<kOp, kVec, kSmallQuery, kSide>(p, query, blocks,
                                                               sms, stream)
                 : launch_sized<kOp, kVec, kMaxQuery, kSide>(p, query, blocks,
                                                             sms, stream);
  }
  return launch_sized<kOp, kVec, 0, kSide>(p, query, blocks, sms, stream);
}

template <int kOp>
int launch_op(const Args& p, bool vec, int side, const int* query,
              long long blocks, int sms, cudaStream_t s) {
  if (vec) {
    if (side == kSideA) return launch_query<kOp, true, kSideA>(p, query, blocks, sms, s);
    if (side == kSideB) return launch_query<kOp, true, kSideB>(p, query, blocks, sms, s);
    return launch_query<kOp, true, kNone>(p, query, blocks, sms, s);
  }
  if (side == kSideA) return launch_query<kOp, false, kSideA>(p, query, blocks, sms, s);
  if (side == kSideB) return launch_query<kOp, false, kSideB>(p, query, blocks, sms, s);
  return launch_query<kOp, false, kNone>(p, query, blocks, sms, s);
}

}  // namespace

// hm_clock_pair_cap(0): the most ints of a query row passed by value;
// (1): the ints of the small struct.
extern "C" int hm_clock_pair_cap(int which) {
  return which == 0 ? kMaxQuery : which == 1 ? kSmallQuery : -1;
}

// a and b are device int32 clocks with A actors, R rows of the result;
// a_stride / b_stride are A for a full [R, A] operand and 0 for one [A]
// row broadcast to all rows. query: host int32 [A] or null; when given,
// it is the operand on query_side (0: a, 1: b), which must have stride 0
// (its device pointer is then not read), and travels in the launch's
// parameters (A at most hm_clock_pair_cap(0)); it is read before this
// returns. out: device uint8 [R] (gte), int32 [R] (cmp) or int32 [R, A];
// host_out: host memory of out's bytes, pinned, or null: when given, out
// is copied there and the stream waited on. Returns -1 on bad arguments,
// else the first non-zero CUDA error.
extern "C" int hm_clock_pair(const int* a, const int* b, int a_stride,
                             int b_stride, int R, int A, int op,
                             const int* query, int query_side, void* out,
                             void* host_out, void* stream) {
  if (R < 0 || A < 0 || a_stride < 0 || b_stride < 0 || op < kGte ||
      op > kCursorWindow)
    return -1;
  if (query != nullptr &&
      (A > kMaxQuery || (query_side != kSideA && query_side != kSideB) ||
       (query_side == kSideA ? a_stride : b_stride) != 0))
    return -1;
  if (R == 0) return 0;
  Args p;
  p.a = a;
  p.b = b;
  p.a_stride = a_stride;
  p.b_stride = b_stride;
  p.R = R;
  p.A = A;
  p.out = out;
  const int side = query != nullptr ? query_side
                   : a_stride == 0  ? kSideA
                   : b_stride == 0  ? kSideB
                                    : kNone;
  // the vector route: every operand read from the device (and the
  // elementwise output) at 16-byte aligned bases and row strides
  const bool a_dev = !(query != nullptr && query_side == kSideA);
  const bool b_dev = !(query != nullptr && query_side == kSideB);
  const bool vec = A % 4 == 0 && (!a_dev || (aligned16(a) && a_stride % 4 == 0)) &&
                   (!b_dev || (aligned16(b) && b_stride % 4 == 0)) &&
                   (op < kUnion || aligned16(out));
  const int quarter = (A + 3) / 4;
  int log2g = 0;
  while ((1 << log2g) < quarter && log2g < 5) ++log2g;
  p.log2g = log2g;
  int sms = 0;
  int rc = sm_count(&sms);
  if (rc != 0) return rc;
  const long long rows_per_block =
      static_cast<long long>(kThreads / 32) * kRows * (32 >> log2g);
  const long long blocks = (R + rows_per_block - 1) / rows_per_block;
  sms = sms > 0 ? sms : 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kGte: rc = launch_op<kGte>(p, vec, side, query, blocks, sms, s); break;
    case kCmp: rc = launch_op<kCmp>(p, vec, side, query, blocks, sms, s); break;
    case kUnion: rc = launch_op<kUnion>(p, vec, side, query, blocks, sms, s); break;
    case kIntersection:
      rc = launch_op<kIntersection>(p, vec, side, query, blocks, sms, s);
      break;
    default: rc = launch_op<kCursorWindow>(p, vec, side, query, blocks, sms, s);
  }
  if (rc == 0 && host_out != nullptr) {
    const size_t bytes = static_cast<size_t>(R) *
                         (op == kGte ? 1 : op == kCmp ? 4 : 4 * static_cast<size_t>(A));
    rc = static_cast<int>(
        cudaMemcpyAsync(host_out, out, bytes, cudaMemcpyDeviceToHost, s));
    if (rc == 0) rc = static_cast<int>(cudaStreamSynchronize(s));
  }
  return rc;
}
