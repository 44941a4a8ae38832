// Kernel 3 of the port: the prefix pack's padded-plane emit.
//
// Replaces hypermerge_tpu/ops/pack_kernels.py::_build_pack (the jitted
// program behind device_pack_prefix). For a slab of D single-writer docs
// whose M source rows lie back to back in 12 narrow planes (action, ctr,
// seq, obj_ctr, obj_a, key, ref_ctr, ref_a, insert, vkind, value, dt), it
// writes the 11 padded [Dp, N] wire planes of ops/columnar.py COLUMNS
// (action, actor, ctr, seq, obj, key, ref, insert, vkind, value, dt) and
// folds the value range into minmax[2] (which the caller zeroes, so 0 is
// always in the range, as the reference's min(initial=0) has it).
//
// Design: one gather over the output cells, not the reference's scatter.
// Cell (d, p) is a real row when d < D and p < ends[d]; its source row is
// doc_start[d] + p. Otherwise it takes its column's pad default (action
// PAD, obj -1, key -1, ref REF_NONE, 0 elsewhere). So there is no fill
// pass, no scatter, no scratch slot and no padding of M, and neighbouring
// threads read and write neighbouring addresses of every plane.
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
// (about 12 to 20 bytes) and writes 22 bytes per cell (36 with int32 row
// planes); the per-cell work is a few integer operations. A thread walks
// cells with a grid stride, keeps its value min/max in registers, and
// each block folds them with one atomicMin/atomicMax.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;
constexpr int kPlanes = 12;
constexpr int kPad = 7, kObjRoot = -1, kRefHead = -2, kRefNone = -3;
constexpr int kVkFloat = 2, kVkStr = 3, kVkBigint = 5;

// source plane order (ops/columnar.py _PACK_SRC_PLANES)
enum {
  kAction, kCtr, kSeq, kObjCtr, kObjA, kKey, kRefCtr, kRefA, kInsert,
  kVkind, kValue, kDt
};

// the source planes and their dtype codes: 0 int8, 1 int16, 2 int32, 3 uint8
struct Src {
  const void* p[kPlanes];
  int code[kPlanes];
};

// the output planes, ops/columnar.py COLUMNS order
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
};

__device__ __forceinline__ int load(const Src& s, int plane, long long i) {
  const void* p = s.p[plane];
  switch (s.code[plane]) {
    case 0: return static_cast<const int8_t*>(p)[i];
    case 1: return static_cast<const int16_t*>(p)[i];
    case 3: return static_cast<const uint8_t*>(p)[i];
    default: return static_cast<const int*>(p)[i];
  }
}

// the reference's `x.astype(rdt) - 1`: cast first, subtract in RowT
template <typename RowT>
__device__ __forceinline__ RowT cast_minus_one(int x) {
  const RowT r = static_cast<RowT>(x);
  return static_cast<RowT>(r - static_cast<RowT>(1));
}

__device__ __forceinline__ int lut_at(const int* lut, int len, long long i) {
  i = i < 0 ? 0 : (i >= len ? len - 1 : i);
  return lut[i];
}

// everything the kernel reads and writes (passed by value)
struct Args {
  Src src;
  const long long* doc_start;  // [D] first source row of each doc
  const int* ends;             // [D] rows of each doc
  const int* writer;           // [D] batch-global actor id of each doc
  const int* lut_off;          // [4, D] offsets in the flat LUTs
  const int* lut[4];           // key, string, float, bigint LUTs
  int lut_len[4];
  int D, N;
  long long cells;  // Dp * N
  Out out;
  int* minmax;  // [2] vmin, vmax
};

template <typename RowT, typename KeyT>
__global__ void __launch_bounds__(kThreads) pack_prefix_kernel(Args a) {
  const Out& out = a.out;
  RowT* ctr = static_cast<RowT*>(out.ctr);
  RowT* seq = static_cast<RowT*>(out.seq);
  RowT* obj = static_cast<RowT*>(out.obj);
  RowT* ref = static_cast<RowT*>(out.ref);
  KeyT* key = static_cast<KeyT*>(out.key);
  const int D = a.D, N = a.N;
  int vmin = 0, vmax = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < a.cells; c += stride) {
    const int d = static_cast<int>(c / N);
    const int p = static_cast<int>(c - (long long)d * N);
    if (d < D && p < a.ends[d]) {
      const Src& src = a.src;
      const long long s = a.doc_start[d] + p;
      out.action[c] = static_cast<uint8_t>(load(src, kAction, s));
      out.actor[c] = a.writer[d];
      ctr[c] = static_cast<RowT>(load(src, kCtr, s));
      seq[c] = static_cast<RowT>(load(src, kSeq, s));
      obj[c] = load(src, kObjA, s) == 0
                   ? cast_minus_one<RowT>(load(src, kObjCtr, s))
                   : static_cast<RowT>(kObjRoot);
      const int ref_a = load(src, kRefA, s);
      const int ref_sentinel = ref_a == -2 ? kRefHead : kRefNone;
      ref[c] = ref_a == 0 ? cast_minus_one<RowT>(load(src, kRefCtr, s))
                          : static_cast<RowT>(ref_sentinel);
      const int k = load(src, kKey, s);
      key[c] = k >= 0 ? static_cast<KeyT>(lut_at(a.lut[0], a.lut_len[0],
                                                 (long long)a.lut_off[d] + k))
                      : static_cast<KeyT>(-1);
      const int vk = load(src, kVkind, s);
      int v = load(src, kValue, s);
      // value LUTs 1..3: string, float, bigint table ids
      const int l =
          vk == kVkStr ? 1 : vk == kVkFloat ? 2 : vk == kVkBigint ? 3 : 0;
      if (l)
        v = lut_at(a.lut[l], a.lut_len[l], (long long)a.lut_off[l * D + d] + v);
      out.value[c] = v;
      vmin = v < vmin ? v : vmin;
      vmax = v > vmax ? v : vmax;
      out.insert[c] = static_cast<uint8_t>(load(src, kInsert, s));
      out.vkind[c] = static_cast<uint8_t>(vk);
      out.dt[c] = static_cast<uint8_t>(load(src, kDt, s));
    } else {
      out.action[c] = kPad;
      out.actor[c] = 0;
      ctr[c] = 0;
      seq[c] = 0;
      obj[c] = static_cast<RowT>(-1);
      key[c] = static_cast<KeyT>(-1);
      ref[c] = static_cast<RowT>(kRefNone);
      out.insert[c] = 0;
      out.vkind[c] = 0;
      out.value[c] = 0;
      out.dt[c] = 0;
    }
  }
  // block fold of the value range, then one atomic of each kind
  __shared__ int smin[kThreads];
  __shared__ int smax[kThreads];
  const int t = threadIdx.x;
  smin[t] = vmin;
  smax[t] = vmax;
  __syncthreads();
  for (int w = blockDim.x / 2; w > 0; w >>= 1) {
    if (t < w) {
      smin[t] = smin[t + w] < smin[t] ? smin[t + w] : smin[t];
      smax[t] = smax[t + w] > smax[t] ? smax[t + w] : smax[t];
    }
    __syncthreads();
  }
  if (t == 0) {
    if (smin[0] < 0) atomicMin(&a.minmax[0], smin[0]);
    if (smax[0] > 0) atomicMax(&a.minmax[1], smax[0]);
  }
}

template <typename RowT, typename KeyT>
int launch(const Args& a, cudaStream_t stream) {
  const long long blocks = (a.cells + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  auto kernel = pack_prefix_kernel<RowT, KeyT>;
  kernel<<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src_ptrs/src_codes and out_ptrs are host arrays (12 source planes, 11
// output planes); every other pointer is device memory. lut_off is [4, D]
// (key, string, float, bigint offsets of each doc in the flat LUTs).
extern "C" int hm_pack_prefix(
    const long long* src_ptrs, const int* src_codes,
    const long long* doc_start, const int* ends, const int* writer,
    const int* lut_off, const int* klut, const int* slut, const int* flut,
    const int* blut, int klen, int slen, int flen, int blen, int D, int Dp,
    int N, int row32, int key32, const long long* out_ptrs, int* minmax,
    void* stream) {
  Args a;
  for (int i = 0; i < kPlanes; ++i) {
    a.src.p[i] = reinterpret_cast<const void*>(src_ptrs[i]);
    a.src.code[i] = src_codes[i];
  }
  a.doc_start = doc_start;
  a.ends = ends;
  a.writer = writer;
  a.lut_off = lut_off;
  const int* luts[4] = {klut, slut, flut, blut};
  const int lens[4] = {klen, slen, flen, blen};
  for (int i = 0; i < 4; ++i) {
    a.lut[i] = luts[i];
    a.lut_len[i] = lens[i];
  }
  a.D = D;
  a.N = N;
  a.cells = (long long)Dp * N;
  Out& out = a.out;
  out.action = reinterpret_cast<uint8_t*>(out_ptrs[0]);
  out.actor = reinterpret_cast<int*>(out_ptrs[1]);
  out.ctr = reinterpret_cast<void*>(out_ptrs[2]);
  out.seq = reinterpret_cast<void*>(out_ptrs[3]);
  out.obj = reinterpret_cast<void*>(out_ptrs[4]);
  out.key = reinterpret_cast<void*>(out_ptrs[5]);
  out.ref = reinterpret_cast<void*>(out_ptrs[6]);
  out.insert = reinterpret_cast<uint8_t*>(out_ptrs[7]);
  out.vkind = reinterpret_cast<uint8_t*>(out_ptrs[8]);
  out.value = reinterpret_cast<int*>(out_ptrs[9]);
  out.dt = reinterpret_cast<uint8_t*>(out_ptrs[10]);
  a.minmax = minmax;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (row32)
    return key32 ? launch<int32_t, int32_t>(a, s) : launch<int32_t, int16_t>(a, s);
  return key32 ? launch<int16_t, int32_t>(a, s) : launch<int16_t, int16_t>(a, s);
}
