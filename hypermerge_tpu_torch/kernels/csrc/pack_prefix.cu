// Kernel 3 of the port: the prefix pack's padded-plane emit, with the slab
// launch's own lanes and ranges beside it.
//
// Replaces hypermerge_tpu/ops/pack_kernels.py::_build_pack (the jitted
// program behind device_pack_prefix). For a slab of D single-writer docs
// whose M source rows lie back to back in 12 narrow planes (action, ctr,
// seq, obj_ctr, obj_a, key, ref_ctr, ref_a, insert, vkind, value, dt), it
// writes the 11 padded [Dp, N] wire planes of ops/columnar.py COLUMNS
// (action, actor, ctr, seq, obj, key, ref, insert, vkind, value, dt) and
// two lanes only doc_kernel.cu reads: flags = action | insert << 3
// (uint8) and slot (int8 zeros: every doc on this path has one writer).
// It folds five ranges into ranges[5]: the value min and max, the ctr max
// and the seq max (each with 0 folded in, as the reference's
// min(initial=0) / max(initial=0)), and the count of INC rows. The entry
// starts them at the fold's identity, so the 0 comes from the threads.
//
// Cell (d, p) is a real row when d < D and p < ends[d]; its source row is
// doc_start[d] + p. Otherwise it takes its column's pad default (action
// PAD, obj -1, key -1, ref REF_NONE, flags PAD, 0 elsewhere).
//
// Parity with the reference, cell for cell:
//   - obj/ref rows are "cast to the row type, then subtract 1" in that
//     type (int16_t unless row32), so they wrap as numpy's int16 does;
//   - ref_a == -2 is REF_HEAD, any other non-zero ref_a is REF_NONE;
//   - the key and value LUT reads clamp the index to [0, len - 1], as the
//     reference's device program does: an out-of-range lane is discarded
//     by the select, and no read leaves the table;
//   - action/insert/vkind/dt are uint8, actor and value int32, ctr/seq/
//     obj/ref the row type, key the key type (int16_t unless key32).
//
// What bounds it on the H100: bytes. It reads each narrow source row once
// (12 to 20 bytes) and writes 24 bytes per cell (38 with int32 row
// planes); the per-cell work is a few integer operations. The design:
//   - a 2-D grid: blockIdx.y is a doc (a y-stride loop past the grid's
//     limit), blockIdx.x a tile of T = threads x 16 cells of its row. A
//     block reads its doc's scalars once, so no cell divides or reloads
//     them;
//   - a tile wholly at or past ends[d] reads nothing and writes the pad
//     defaults;
//   - the source windows are staged through shared memory: each plane's
//     window [doc_start + tile0, + real cells) is copied asynchronously
//     (cp.async, 16-byte chunks of the window's 16-byte-aligned superset:
//     a plane starts 16-byte aligned and may be read up to the next 16
//     bytes past its end), and each thread reads its 16 cells back with
//     128-bit shared loads and a funnel shift by the window's
//     misalignment. The dtype switch runs once per plane and thread;
//   - vector stores: a thread owns 16 consecutive cells, so a uint8 plane
//     is one 16-byte store, an int16 plane two, an int32 plane four. A
//     row's base is 16-byte aligned when N % 16 == 0; any other N takes
//     the scalar path (cells strided over the block, element loads);
//   - the LUT reads go through the read-only path (__ldg);
//   - the ranges fold in registers, then warp shuffles, then one atomic
//     per warp where it moves the result.
#include <climits>
#include <cstdint>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>

namespace {

constexpr int kV = 16;           // cells a thread owns on the vector path
constexpr int kMaxThreads = 128;  // a block's threads at most
constexpr int kPlanes = 12;
constexpr int kLanes = 13;  // the 11 wire planes, flags, slot
constexpr int kRanges = 5;
constexpr int kPad = 7, kInc = 6, kObjRoot = -1, kRefHead = -2, kRefNone = -3;
constexpr int kVkFloat = 2, kVkStr = 3, kVkBigint = 5;

// source plane order (ops/columnar.py _PACK_SRC_PLANES)
enum {
  kAction, kCtr, kSeq, kObjCtr, kObjA, kKey, kRefCtr, kRefA, kInsert,
  kVkind, kValue, kDt
};
// source dtype codes (ops/pack_kernels.py _TORCH_CODE)
enum { kCodeI8 = 0, kCodeI16 = 1, kCodeI32 = 2, kCodeU8 = 3 };
// ranges[]
enum { kVmin, kVmax, kCtrMax, kSeqMax, kIncCount };

__host__ __device__ __forceinline__ int code_bytes(int code) {
  return code == kCodeI16 ? 2 : code == kCodeI32 ? 4 : 1;
}

// the output lanes, ops/columnar.py COLUMNS order, then flags and slot
struct Out {
  uint8_t* action;
  int* actor;
  void* ctr;
  void* seq;
  void* obj;
  void* key;
  void* ref;
  uint8_t* insert;
  uint8_t* vkind;
  int* value;
  uint8_t* dt;
  uint8_t* flags;
  int8_t* slot;
};

// everything the kernel reads and writes, passed by value
struct Args {
  const unsigned char* src[kPlanes];  // 16-byte aligned source planes
  int code[kPlanes];                  // their dtype codes
  int stage_off[kPlanes];  // each plane's window in shared memory
  const long long* doc_start;  // [D] first source row of each doc
  const int* ends;             // [D] rows of each doc
  const int* writer;           // [D] batch-global actor id of each doc
  const int* lut_off;          // [4, D] offsets in the flat LUTs
  const int* lut[4];           // key, string, float, bigint LUTs
  int lut_len[4];
  int D, Dp, N;
  int tile;  // cells a block covers of its row: threads x kV
  Out out;
  int* ranges;  // [kRanges]
};

// one doc's scalars, read once per block
struct Doc {
  int end;
  int writer;
  long long start;
  long long off[4];
};

struct Fold {
  int vmin = 0, vmax = 0, ctr = 0, seq = 0, inc = 0;
};

__device__ __forceinline__ Doc load_doc(const Args& a, int d) {
  Doc doc{0, 0, 0, {0, 0, 0, 0}};
  if (d < a.D) {
    doc.end = __ldg(&a.ends[d]);
    doc.writer = __ldg(&a.writer[d]);
    doc.start = __ldg(&a.doc_start[d]);
#pragma unroll
    for (int l = 0; l < 4; ++l) doc.off[l] = __ldg(&a.lut_off[l * a.D + d]);
  }
  return doc;
}

// byte offset of the window's first element past its 16-byte-aligned
// superset start
__device__ __forceinline__ int window_misalign(long long s_first, int code) {
  return static_cast<int>((s_first * code_bytes(code)) & 15);
}

// copy every plane's window of n rows from source row s_first into shared
// memory; the block waits for all of it
__device__ void stage_windows(const Args& a, unsigned char* stage,
                              long long s_first, int n) {
  for (int k = 0; k < kPlanes; ++k) {
    const int e = code_bytes(a.code[k]);
    const long long b0 = s_first * e, b1 = (s_first + n) * e;
    const long long a0 = b0 & ~15LL;
    const int chunks = static_cast<int>((((b1 + 15) & ~15LL) - a0) >> 4);
    const unsigned char* g = a.src[k] + a0;
    unsigned char* s = stage + a.stage_off[k];
    for (int j = threadIdx.x; j < chunks; j += blockDim.x)
      __pipeline_memcpy_async(s + 16 * j, g + 16 * j, 16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

template <int Q, int W, int O>
__device__ __forceinline__ void funnel(const uint32_t (&w)[W], int shift,
                                       uint32_t (&o)[O]) {
#pragma unroll
  for (int j = 0; j < O; ++j) o[j] = __funnelshift_r(w[j + Q], w[j + Q + 1], shift);
}

// the 16 E bytes that start m bytes (0..15) past p (16-byte aligned), as
// 4 E words: E + 1 shared 128-bit loads, then a funnel shift
template <int E>
__device__ __forceinline__ void shared_words(const unsigned char* p, int m,
                                             uint32_t (&o)[4 * E]) {
  uint32_t w[4 * E + 4];
  const uint4* v = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int j = 0; j <= E; ++j) {
    const uint4 c = v[j];
    w[4 * j] = c.x;
    w[4 * j + 1] = c.y;
    w[4 * j + 2] = c.z;
    w[4 * j + 3] = c.w;
  }
  const int shift = 8 * (m & 3);
  switch (m >> 2) {
    case 0: funnel<0>(w, shift, o); break;
    case 1: funnel<1>(w, shift, o); break;
    case 2: funnel<2>(w, shift, o); break;
    default: funnel<3>(w, shift, o); break;
  }
}

// a thread's kV staged values of plane k, its cells [c0, c0 + kV) of the
// tile whose first source row is s_first
__device__ __forceinline__ void read_cells(const Args& a,
                                           const unsigned char* stage, int k,
                                           long long s_first, int c0,
                                           int (&x)[kV]) {
  const int code = a.code[k];
  const int m = window_misalign(s_first, code);
  const unsigned char* p = stage + a.stage_off[k] + c0 * code_bytes(code);
  if (code == kCodeI8 || code == kCodeU8) {
    uint32_t o[4];
    shared_words<1>(p, m, o);
#pragma unroll
    for (int i = 0; i < kV; ++i) {
      const uint32_t b = (o[i >> 2] >> (8 * (i & 3))) & 0xff;
      x[i] = code == kCodeI8 ? static_cast<int8_t>(b) : static_cast<int>(b);
    }
  } else if (code == kCodeI16) {
    uint32_t o[8];
    shared_words<2>(p, m, o);
#pragma unroll
    for (int i = 0; i < kV; ++i)
      x[i] = static_cast<int16_t>((o[i >> 1] >> (16 * (i & 1))) & 0xffff);
  } else {
    uint32_t o[16];
    shared_words<4>(p, m, o);
#pragma unroll
    for (int i = 0; i < kV; ++i) x[i] = static_cast<int>(o[i]);
  }
}

// one staged value: plane k at cell c of the tile (the scalar path)
__device__ __forceinline__ int staged_at(const Args& a,
                                         const unsigned char* stage, int k,
                                         long long s_first, int c) {
  const int code = a.code[k];
  const unsigned char* p = stage + a.stage_off[k] +
                           window_misalign(s_first, code) +
                           c * code_bytes(code);
  switch (code) {
    case kCodeI8: return *reinterpret_cast<const int8_t*>(p);
    case kCodeI16: return *reinterpret_cast<const int16_t*>(p);
    case kCodeU8: return *p;
    default: return *reinterpret_cast<const int*>(p);
  }
}

// the reference's `x.astype(rdt) - 1`: cast first, subtract in RowT
template <typename RowT>
__device__ __forceinline__ int cast_minus_one(int x) {
  const RowT r = static_cast<RowT>(x);
  return static_cast<RowT>(r - static_cast<RowT>(1));
}

__device__ __forceinline__ int lut_at(const int* lut, int len, long long i) {
  i = i < 0 ? 0 : (i >= len ? len - 1 : i);
  return __ldg(&lut[i]);
}

// each column's rule for a real row, from its source values
__device__ __forceinline__ int flags_of(int action, int insert) {
  return static_cast<uint8_t>(action | insert << 3);
}

template <typename RowT>
__device__ __forceinline__ int obj_of(int obj_a, int obj_ctr) {
  return obj_a == 0 ? cast_minus_one<RowT>(obj_ctr) : kObjRoot;
}

template <typename RowT>
__device__ __forceinline__ int ref_of(int ref_a, int ref_ctr) {
  return ref_a == 0 ? cast_minus_one<RowT>(ref_ctr)
                    : (ref_a == -2 ? kRefHead : kRefNone);
}

__device__ __forceinline__ int key_of(const Args& a, const Doc& doc, int k) {
  return k >= 0 ? lut_at(a.lut[0], a.lut_len[0], doc.off[0] + k) : -1;
}

// value LUTs 1..3: string, float, bigint table ids (each table picked by
// a select, not an index: the doc's offsets stay in registers)
__device__ __forceinline__ int value_of(const Args& a, const Doc& doc, int vk,
                                        int v) {
  if (vk == kVkStr) return lut_at(a.lut[1], a.lut_len[1], doc.off[1] + v);
  if (vk == kVkFloat) return lut_at(a.lut[2], a.lut_len[2], doc.off[2] + v);
  if (vk == kVkBigint) return lut_at(a.lut[3], a.lut_len[3], doc.off[3] + v);
  return v;
}

template <int S>
struct Unsigned;
template <>
struct Unsigned<1> { using T = uint8_t; };
template <>
struct Unsigned<2> { using T = uint16_t; };
template <>
struct Unsigned<4> { using T = uint32_t; };

// kV values as T, in kV * sizeof(T) / 16 16-byte stores (dst aligned)
template <typename T>
__device__ __forceinline__ void store_vec(void* dst, const int (&v)[kV]) {
  constexpr int kWords = kV * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) w[j] = 0;
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const int byte = i * static_cast<int>(sizeof(T));
    w[byte >> 2] |= static_cast<uint32_t>(
                        static_cast<typename Unsigned<sizeof(T)>::T>(v[i]))
                    << (8 * (byte & 3));
  }
  uint4* p = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int j = 0; j < kWords / 4; ++j)
    p[j] = uint4{w[4 * j], w[4 * j + 1], w[4 * j + 2], w[4 * j + 3]};
}

template <typename T>
__device__ __forceinline__ void store_fill(void* dst, int value) {
  int v[kV];
#pragma unroll
  for (int i = 0; i < kV; ++i) v[i] = value;
  store_vec<T>(dst, v);
}

template <typename T>
__device__ __forceinline__ T* at(void* base, long long o) {
  return static_cast<T*>(base) + o;
}

// kV pad cells from output cell o
template <typename RowT, typename KeyT>
__device__ void store_pads(const Out& out, long long o) {
  store_fill<uint8_t>(out.action + o, kPad);
  store_fill<int>(out.actor + o, 0);
  store_fill<RowT>(at<RowT>(out.ctr, o), 0);
  store_fill<RowT>(at<RowT>(out.seq, o), 0);
  store_fill<RowT>(at<RowT>(out.obj, o), kObjRoot);
  store_fill<KeyT>(at<KeyT>(out.key, o), -1);
  store_fill<RowT>(at<RowT>(out.ref, o), kRefNone);
  store_fill<uint8_t>(out.insert + o, 0);
  store_fill<uint8_t>(out.vkind + o, 0);
  store_fill<int>(out.value + o, 0);
  store_fill<uint8_t>(out.dt + o, 0);
  store_fill<uint8_t>(out.flags + o, kPad);
  store_fill<int8_t>(out.slot + o, 0);
}

__device__ __forceinline__ int imax(int x, int y) { return x > y ? x : y; }

// the vector path: this thread's kV cells [c0, c0 + kV) of the tile at
// tile0 of doc d's row, of which the first n_real of the tile are real
template <typename RowT, typename KeyT>
__device__ void vector_cells(const Args& a, const unsigned char* stage,
                             const Doc& doc, int d, int tile0, int n_real,
                             long long s_first, Fold& f) {
  const int c0 = threadIdx.x * kV;
  if (tile0 + c0 >= a.N) return;  // past the row
  const Out& out = a.out;
  const long long o = static_cast<long long>(d) * a.N + tile0 + c0;
  const int left = n_real - c0;
  const int real = left <= 0 ? 0 : (left < kV ? left : kV);
  if (real == 0) {
    store_pads<RowT, KeyT>(out, o);
    return;
  }
  int x[kV], y[kV], z[kV];
  // action, insert, flags; the INC count
  read_cells(a, stage, kAction, s_first, c0, x);
  read_cells(a, stage, kInsert, s_first, c0, y);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const bool r = i < real;
    x[i] = r ? static_cast<uint8_t>(x[i]) : kPad;
    y[i] = r ? static_cast<uint8_t>(y[i]) : 0;
    z[i] = r ? flags_of(x[i], y[i]) : kPad;
    f.inc += r && x[i] == kInc;
  }
  store_vec<uint8_t>(out.action + o, x);
  store_vec<uint8_t>(out.insert + o, y);
  store_vec<uint8_t>(out.flags + o, z);
  store_fill<int8_t>(out.slot + o, 0);
#pragma unroll
  for (int i = 0; i < kV; ++i) x[i] = i < real ? doc.writer : 0;
  store_vec<int>(out.actor + o, x);
  // ctr and seq: the row type; their maxima
  read_cells(a, stage, kCtr, s_first, c0, x);
  read_cells(a, stage, kSeq, s_first, c0, y);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const bool r = i < real;
    x[i] = r ? static_cast<RowT>(x[i]) : 0;
    y[i] = r ? static_cast<RowT>(y[i]) : 0;
    if (r) {
      f.ctr = imax(f.ctr, x[i]);
      f.seq = imax(f.seq, y[i]);
    }
  }
  store_vec<RowT>(at<RowT>(out.ctr, o), x);
  store_vec<RowT>(at<RowT>(out.seq, o), y);
  // obj and ref rows
  read_cells(a, stage, kObjA, s_first, c0, x);
  read_cells(a, stage, kObjCtr, s_first, c0, y);
#pragma unroll
  for (int i = 0; i < kV; ++i) x[i] = i < real ? obj_of<RowT>(x[i], y[i]) : kObjRoot;
  store_vec<RowT>(at<RowT>(out.obj, o), x);
  read_cells(a, stage, kRefA, s_first, c0, x);
  read_cells(a, stage, kRefCtr, s_first, c0, y);
#pragma unroll
  for (int i = 0; i < kV; ++i) x[i] = i < real ? ref_of<RowT>(x[i], y[i]) : kRefNone;
  store_vec<RowT>(at<RowT>(out.ref, o), x);
  // key
  read_cells(a, stage, kKey, s_first, c0, x);
#pragma unroll
  for (int i = 0; i < kV; ++i) x[i] = i < real ? key_of(a, doc, x[i]) : -1;
  store_vec<KeyT>(at<KeyT>(out.key, o), x);
  // vkind, value and the value range
  read_cells(a, stage, kVkind, s_first, c0, x);
  read_cells(a, stage, kValue, s_first, c0, y);
#pragma unroll
  for (int i = 0; i < kV; ++i) {
    const bool r = i < real;
    y[i] = r ? value_of(a, doc, x[i], y[i]) : 0;
    x[i] = r ? static_cast<uint8_t>(x[i]) : 0;
    if (r) {
      f.vmin = y[i] < f.vmin ? y[i] : f.vmin;
      f.vmax = y[i] > f.vmax ? y[i] : f.vmax;
    }
  }
  store_vec<uint8_t>(out.vkind + o, x);
  store_vec<int>(out.value + o, y);
  read_cells(a, stage, kDt, s_first, c0, x);
#pragma unroll
  for (int i = 0; i < kV; ++i) x[i] = i < real ? static_cast<uint8_t>(x[i]) : 0;
  store_vec<uint8_t>(out.dt + o, x);
}

// the scalar path (N % kV != 0): cells strided over the block's threads
template <typename RowT, typename KeyT>
__device__ void scalar_cells(const Args& a, const unsigned char* stage,
                             const Doc& doc, int d, int tile0, int n_real,
                             long long s_first, Fold& f) {
  const Out& out = a.out;
  for (int c = threadIdx.x; c < a.tile && tile0 + c < a.N; c += blockDim.x) {
    const long long o = static_cast<long long>(d) * a.N + tile0 + c;
    RowT* ctr = at<RowT>(out.ctr, o);
    RowT* seq = at<RowT>(out.seq, o);
    RowT* obj = at<RowT>(out.obj, o);
    RowT* ref = at<RowT>(out.ref, o);
    KeyT* key = at<KeyT>(out.key, o);
    out.slot[o] = 0;
    if (c >= n_real) {
      out.action[o] = kPad;
      out.actor[o] = 0;
      *ctr = 0;
      *seq = 0;
      *obj = static_cast<RowT>(kObjRoot);
      *key = static_cast<KeyT>(-1);
      *ref = static_cast<RowT>(kRefNone);
      out.insert[o] = 0;
      out.vkind[o] = 0;
      out.value[o] = 0;
      out.dt[o] = 0;
      out.flags[o] = kPad;
      continue;
    }
    const int action = static_cast<uint8_t>(staged_at(a, stage, kAction, s_first, c));
    const int insert = static_cast<uint8_t>(staged_at(a, stage, kInsert, s_first, c));
    out.action[o] = static_cast<uint8_t>(action);
    out.insert[o] = static_cast<uint8_t>(insert);
    out.flags[o] = static_cast<uint8_t>(flags_of(action, insert));
    f.inc += action == kInc;
    out.actor[o] = doc.writer;
    *ctr = static_cast<RowT>(staged_at(a, stage, kCtr, s_first, c));
    *seq = static_cast<RowT>(staged_at(a, stage, kSeq, s_first, c));
    f.ctr = imax(f.ctr, *ctr);
    f.seq = imax(f.seq, *seq);
    *obj = static_cast<RowT>(obj_of<RowT>(staged_at(a, stage, kObjA, s_first, c),
                                          staged_at(a, stage, kObjCtr, s_first, c)));
    *ref = static_cast<RowT>(ref_of<RowT>(staged_at(a, stage, kRefA, s_first, c),
                                          staged_at(a, stage, kRefCtr, s_first, c)));
    *key = static_cast<KeyT>(key_of(a, doc, staged_at(a, stage, kKey, s_first, c)));
    const int vk = staged_at(a, stage, kVkind, s_first, c);
    const int v = value_of(a, doc, vk, staged_at(a, stage, kValue, s_first, c));
    out.vkind[o] = static_cast<uint8_t>(vk);
    out.value[o] = v;
    f.vmin = v < f.vmin ? v : f.vmin;
    f.vmax = v > f.vmax ? v : f.vmax;
    out.dt[o] = static_cast<uint8_t>(staged_at(a, stage, kDt, s_first, c));
  }
}

// the block's folds: warp shuffles, then one atomic per warp and range
// where it moves the result
__device__ void fold_ranges(int* ranges, Fold f) {
  for (int s = 16; s > 0; s >>= 1) {
    const int vmin = __shfl_xor_sync(0xffffffffu, f.vmin, s);
    const int vmax = __shfl_xor_sync(0xffffffffu, f.vmax, s);
    const int ctr = __shfl_xor_sync(0xffffffffu, f.ctr, s);
    const int seq = __shfl_xor_sync(0xffffffffu, f.seq, s);
    f.inc += __shfl_xor_sync(0xffffffffu, f.inc, s);
    f.vmin = vmin < f.vmin ? vmin : f.vmin;
    f.vmax = imax(f.vmax, vmax);
    f.ctr = imax(f.ctr, ctr);
    f.seq = imax(f.seq, seq);
  }
  if ((threadIdx.x & 31) != 0) return;
  if (f.vmin < __ldcg(&ranges[kVmin])) atomicMin(&ranges[kVmin], f.vmin);
  if (f.vmax > __ldcg(&ranges[kVmax])) atomicMax(&ranges[kVmax], f.vmax);
  if (f.ctr > __ldcg(&ranges[kCtrMax])) atomicMax(&ranges[kCtrMax], f.ctr);
  if (f.seq > __ldcg(&ranges[kSeqMax])) atomicMax(&ranges[kSeqMax], f.seq);
  if (f.inc) atomicAdd(&ranges[kIncCount], f.inc);
}

template <typename RowT, typename KeyT, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
    pack_prefix_kernel(const __grid_constant__ Args a) {
  extern __shared__ uint4 stage_raw[];
  unsigned char* stage = reinterpret_cast<unsigned char*>(stage_raw);
  Fold f;
  const int tile0 = blockIdx.x * a.tile;
  for (int d = blockIdx.y; d < a.Dp; d += gridDim.y) {
    const Doc doc = load_doc(a, d);
    const int left = doc.end - tile0;
    const int n_real = left <= 0 ? 0 : (left < a.tile ? left : a.tile);
    const long long s_first = doc.start + tile0;
    if (n_real > 0) stage_windows(a, stage, s_first, n_real);
    if (kVec)
      vector_cells<RowT, KeyT>(a, stage, doc, d, tile0, n_real, s_first, f);
    else
      scalar_cells<RowT, KeyT>(a, stage, doc, d, tile0, n_real, s_first, f);
    __syncthreads();  // the next doc's windows reuse the stage
  }
  fold_ranges(a.ranges, f);
}

// the launch shape: threads, tile and shared memory for (Dp, N) on this
// card. Fewer threads a block (more tiles a row) while the grid would
// leave SMs idle.
struct Plan {
  int threads, tile, smem;
  dim3 grid;
};

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != 0 ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != 0)
    return 0;
  return sms;
}

int shared_optin() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != 0 ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != 0)
    return 0;
  return bytes;
}

int stage_bytes(int tile, const int (&code)[kPlanes], int (&off)[kPlanes]) {
  int total = 0;
  for (int k = 0; k < kPlanes; ++k) {
    off[k] = total;
    total += tile * code_bytes(code[k]) + 16;
  }
  return total;
}

template <typename RowT, typename KeyT, bool kVec>
int launch(Args& a, const Plan& p, cudaStream_t stream) {
  auto kernel = pack_prefix_kernel<RowT, KeyT, kVec>;
  if (p.smem > 48 * 1024) {
    const int rc = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem));
    if (rc != 0) return rc;
  }
  kernel<<<p.grid, p.threads, p.smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename RowT, typename KeyT>
int launch_rows(Args& a, const Plan& p, bool vec, cudaStream_t stream) {
  return vec ? launch<RowT, KeyT, true>(a, p, stream)
             : launch<RowT, KeyT, false>(a, p, stream);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The launch shape's limits: which 0, a block's threads at most; 1, the
// cells a thread owns; 2, the card's SM count; 3, the shared memory a
// block may opt into.
extern "C" int hm_pack_prefix_cap(int which) {
  switch (which) {
    case 0: return kMaxThreads;
    case 1: return kV;
    case 2: return sm_count();
    case 3: return shared_optin();
    default: return -1;
  }
}

// src_*: the 12 source planes (device, each 16-byte aligned and readable
// up to the next 16 bytes past its end, as one torch allocation or the
// staged upload's views are); codes: their dtype codes, 2 bits a plane
// (plane k at bit 2k). lut_off is [4, D] (key, string, float, bigint
// offsets of each doc in the flat LUTs). out_*: the 11 [Dp, N] wire
// planes, flags and slot (device). ranges: device int32 [5]; host_ranges:
// host int32 [5], pinned: the entry starts ranges from it, copies the
// result back into it and waits for the stream. Returns -1 on bad
// arguments, else the first non-zero CUDA error.
extern "C" int hm_pack_prefix(
    const void* src_action, const void* src_ctr, const void* src_seq,
    const void* src_obj_ctr, const void* src_obj_a, const void* src_key,
    const void* src_ref_ctr, const void* src_ref_a, const void* src_insert,
    const void* src_vkind, const void* src_value, const void* src_dt,
    int codes, const long long* doc_start, const int* ends, const int* writer,
    const int* lut_off, const int* klut, const int* slut, const int* flut,
    const int* blut, int klen, int slen, int flen, int blen, int D, int Dp,
    int N, int row32, int key32, void* out_action, void* out_actor,
    void* out_ctr, void* out_seq, void* out_obj, void* out_key, void* out_ref,
    void* out_insert, void* out_vkind, void* out_value, void* out_dt,
    void* out_flags, void* out_slot, int* ranges, int* host_ranges,
    void* stream) {
  if (D < 1 || Dp < D || N < 1 || host_ranges == nullptr) return -1;
  const void* srcs[kPlanes] = {
      src_action, src_ctr, src_seq, src_obj_ctr, src_obj_a, src_key,
      src_ref_ctr, src_ref_a, src_insert, src_vkind, src_value, src_dt};
  void* outs[kLanes] = {out_action, out_actor, out_ctr, out_seq, out_obj,
                        out_key, out_ref, out_insert, out_vkind, out_value,
                        out_dt, out_flags, out_slot};
  Args a;
  for (int k = 0; k < kPlanes; ++k) {
    if (!aligned16(srcs[k])) return -1;
    a.src[k] = static_cast<const unsigned char*>(srcs[k]);
    a.code[k] = (codes >> (2 * k)) & 3;
  }
  a.doc_start = doc_start;
  a.ends = ends;
  a.writer = writer;
  a.lut_off = lut_off;
  const int* luts[4] = {klut, slut, flut, blut};
  const int lens[4] = {klen, slen, flen, blen};
  for (int i = 0; i < 4; ++i) {
    if (lens[i] < 1) return -1;
    a.lut[i] = luts[i];
    a.lut_len[i] = lens[i];
  }
  a.D = D;
  a.Dp = Dp;
  a.N = N;
  bool vec = N % kV == 0;
  for (int k = 0; k < kLanes; ++k) vec = vec && aligned16(outs[k]);
  Out& out = a.out;
  out.action = static_cast<uint8_t*>(out_action);
  out.actor = static_cast<int*>(out_actor);
  out.ctr = out_ctr;
  out.seq = out_seq;
  out.obj = out_obj;
  out.key = out_key;
  out.ref = out_ref;
  out.insert = static_cast<uint8_t*>(out_insert);
  out.vkind = static_cast<uint8_t*>(out_vkind);
  out.value = static_cast<int*>(out_value);
  out.dt = static_cast<uint8_t*>(out_dt);
  out.flags = static_cast<uint8_t*>(out_flags);
  out.slot = static_cast<int8_t*>(out_slot);
  a.ranges = ranges;

  // the launch shape from the card: one block row a doc, threads a block
  // no more than the row needs, fewer while the grid leaves SMs idle
  Plan p;
  const int need = (N + kV - 1) / kV;
  p.threads = (need + 31) / 32 * 32;
  if (p.threads > kMaxThreads) p.threads = kMaxThreads;
  const int sms = sm_count();
  while (p.threads > 32 &&
         static_cast<long long>(Dp) * ((N + p.threads * kV - 1) /
                                       (p.threads * kV)) < 2LL * sms)
    p.threads /= 2;
  p.tile = p.threads * kV;
  p.smem = stage_bytes(p.tile, a.code, a.stage_off);
  if (p.smem > shared_optin()) return -1;
  a.tile = p.tile;
  p.grid = dim3((N + p.tile - 1) / p.tile, Dp < 65535 ? Dp : 65535);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the folds' identities: the threads fold 0 in themselves
  const int init[kRanges] = {INT_MAX, INT_MIN, INT_MIN, INT_MIN, 0};
  for (int i = 0; i < kRanges; ++i) host_ranges[i] = init[i];
  const size_t bytes = kRanges * sizeof(int);
  int rc = static_cast<int>(
      cudaMemcpyAsync(ranges, host_ranges, bytes, cudaMemcpyHostToDevice, s));
  if (rc != 0) return rc;
  if (row32)
    rc = key32 ? launch_rows<int32_t, int32_t>(a, p, vec, s)
               : launch_rows<int32_t, int16_t>(a, p, vec, s);
  else
    rc = key32 ? launch_rows<int16_t, int32_t>(a, p, vec, s)
               : launch_rows<int16_t, int16_t>(a, p, vec, s);
  if (rc != 0) return rc;
  rc = static_cast<int>(
      cudaMemcpyAsync(host_ranges, ranges, bytes, cudaMemcpyDeviceToHost, s));
  if (rc == 0) rc = static_cast<int>(cudaStreamSynchronize(s));
  return rc;
}
