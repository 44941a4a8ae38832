// hm_native: the host C++ layer of hypermerge_tpu_torch — the port's
// copy of hypermerge_tpu/native/src/hm_native.cpp, cut to what the port
// calls: ed25519 keypairs/signatures, BLAKE2b merkle roots and the
// transport crypto, X25519 and ChaCha20-Poly1305-IETF (libsodium), brotli
// block frames (libbrotli), the columnar pack entries (the bulk cold
// open's host pack route and the device pack's marshal) and the binary
// change-frame codec. The reference's zlib codec is left out (Python's
// zlib module reads and writes "ZL" blocks).
//
// libsodium and libbrotli are dlopen'd at init, so the build needs no
// headers and no libraries beyond libdl. Every entry point degrades:
// callers check hm_caps() and fall back to pure-Python implementations
// when a capability is absent.
//
// Built at first use by hypermerge_tpu_torch/native/__init__.py (g++).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>

// ---------------------------------------------------------------------
// dlopen'd ABIs

typedef int (*fn_sodium_init)(void);
typedef int (*fn_sign_seed_keypair)(unsigned char *, unsigned char *,
                                    const unsigned char *);
typedef int (*fn_sign_detached)(unsigned char *, unsigned long long *,
                                const unsigned char *, unsigned long long,
                                const unsigned char *);
typedef int (*fn_sign_verify_detached)(const unsigned char *,
                                       const unsigned char *,
                                       unsigned long long,
                                       const unsigned char *);
typedef int (*fn_generichash)(unsigned char *, size_t, const unsigned char *,
                              unsigned long long, const unsigned char *,
                              size_t);

typedef int (*fn_scalarmult)(unsigned char *, const unsigned char *,
                             const unsigned char *);
typedef int (*fn_scalarmult_base)(unsigned char *, const unsigned char *);
typedef int (*fn_aead_encrypt)(unsigned char *, unsigned long long *,
                               const unsigned char *, unsigned long long,
                               const unsigned char *, unsigned long long,
                               const unsigned char *, const unsigned char *,
                               const unsigned char *);
typedef int (*fn_aead_decrypt)(unsigned char *, unsigned long long *,
                               unsigned char *, const unsigned char *,
                               unsigned long long, const unsigned char *,
                               unsigned long long, const unsigned char *,
                               const unsigned char *);

typedef int (*fn_brotli_compress)(int, int, int, size_t, const uint8_t *,
                                  size_t *, uint8_t *);
typedef int (*fn_brotli_decompress)(size_t, const uint8_t *, size_t *,
                                    uint8_t *);
typedef size_t (*fn_brotli_bound)(size_t);

static fn_sign_seed_keypair p_seed_keypair = nullptr;
static fn_sign_detached p_sign = nullptr;
static fn_sign_verify_detached p_verify = nullptr;
static fn_generichash p_generichash = nullptr;
static fn_scalarmult p_scalarmult = nullptr;
static fn_scalarmult_base p_scalarmult_base = nullptr;
static fn_aead_encrypt p_aead_encrypt = nullptr;
static fn_aead_decrypt p_aead_decrypt = nullptr;
static fn_brotli_compress p_br_compress = nullptr;
static fn_brotli_decompress p_br_decompress = nullptr;
static fn_brotli_bound p_br_bound = nullptr;

static const int CAP_SODIUM = 1;
static const int CAP_BROTLI = 2;
static int g_caps = -1;

extern "C" {

int hm_init(void) {
  if (g_caps >= 0)
    return g_caps;
  int caps = 0;

  void *sodium = dlopen("libsodium.so.23", RTLD_NOW | RTLD_GLOBAL);
  if (!sodium)
    sodium = dlopen("libsodium.so", RTLD_NOW | RTLD_GLOBAL);
  if (sodium) {
    fn_sodium_init init =
        (fn_sodium_init)dlsym(sodium, "sodium_init");
    p_seed_keypair =
        (fn_sign_seed_keypair)dlsym(sodium, "crypto_sign_seed_keypair");
    p_sign = (fn_sign_detached)dlsym(sodium, "crypto_sign_detached");
    p_verify = (fn_sign_verify_detached)dlsym(
        sodium, "crypto_sign_verify_detached");
    p_generichash = (fn_generichash)dlsym(sodium, "crypto_generichash");
    p_scalarmult = (fn_scalarmult)dlsym(sodium, "crypto_scalarmult");
    p_scalarmult_base =
        (fn_scalarmult_base)dlsym(sodium, "crypto_scalarmult_base");
    p_aead_encrypt = (fn_aead_encrypt)dlsym(
        sodium, "crypto_aead_chacha20poly1305_ietf_encrypt");
    p_aead_decrypt = (fn_aead_decrypt)dlsym(
        sodium, "crypto_aead_chacha20poly1305_ietf_decrypt");
    if (init && init() >= 0 && p_seed_keypair && p_sign && p_verify &&
        p_generichash && p_scalarmult && p_scalarmult_base &&
        p_aead_encrypt && p_aead_decrypt)
      caps |= CAP_SODIUM;
  }

  void *enc = dlopen("libbrotlienc.so.1", RTLD_NOW);
  if (!enc)
    enc = dlopen("libbrotlienc.so", RTLD_NOW);
  void *dec = dlopen("libbrotlidec.so.1", RTLD_NOW);
  if (!dec)
    dec = dlopen("libbrotlidec.so", RTLD_NOW);
  if (enc && dec) {
    p_br_compress = (fn_brotli_compress)dlsym(enc, "BrotliEncoderCompress");
    p_br_bound = (fn_brotli_bound)dlsym(enc, "BrotliEncoderMaxCompressedSize");
    p_br_decompress =
        (fn_brotli_decompress)dlsym(dec, "BrotliDecoderDecompress");
    if (p_br_compress && p_br_decompress && p_br_bound)
      caps |= CAP_BROTLI;
  }

  g_caps = caps;
  return caps;
}

int hm_caps(void) { return hm_init(); }

// -------------------------------------------------------------------
// ed25519 (requires CAP_SODIUM; returns -2 when unavailable)

int hm_ed25519_public(const uint8_t seed[32], uint8_t pub[32]) {
  if (!(hm_init() & CAP_SODIUM))
    return -2;
  uint8_t sk[64];
  return p_seed_keypair(pub, sk, seed) == 0 ? 0 : -1;
}

int hm_ed25519_sign(const uint8_t seed[32], const uint8_t *msg, size_t len,
                    uint8_t sig[64]) {
  if (!(hm_init() & CAP_SODIUM))
    return -2;
  uint8_t pk[32], sk[64];
  if (p_seed_keypair(pk, sk, seed) != 0)
    return -1;
  unsigned long long siglen = 64;
  return p_sign(sig, &siglen, msg, (unsigned long long)len, sk) == 0 ? 0 : -1;
}

int hm_ed25519_verify(const uint8_t pub[32], const uint8_t *msg, size_t len,
                      const uint8_t sig[64]) {
  if (!(hm_init() & CAP_SODIUM))
    return -2;
  return p_verify(sig, msg, (unsigned long long)len, pub) == 0 ? 1 : 0;
}

// -------------------------------------------------------------------
// BLAKE2b (keyed) — discovery keys + merkle nodes

int hm_blake2b(const uint8_t *data, size_t len, const uint8_t *key,
               size_t keylen, uint8_t *out, size_t outlen) {
  if (!(hm_init() & CAP_SODIUM))
    return -2;
  return p_generichash(out, outlen, data, (unsigned long long)len, key,
                       keylen) == 0
             ? 0
             : -1;
}

// -------------------------------------------------------------------
// Merkle root over leaf hashes (32-byte nodes): parent =
// blake2b32(0x01 || left || right); an odd trailing node is promoted.
// Leaf hashing (0x00 || block) is done by the caller per block.

int hm_merkle_root(const uint8_t *leaves, size_t n, uint8_t out[32]) {
  if (!(hm_init() & CAP_SODIUM))
    return -2;
  if (n == 0) {
    memset(out, 0, 32);
    return 0;
  }
  // work buffer: copy of current level
  uint8_t *level = new uint8_t[n * 32];
  memcpy(level, leaves, n * 32);
  size_t count = n;
  uint8_t node[65];
  node[0] = 0x01;
  while (count > 1) {
    size_t next = 0;
    for (size_t i = 0; i + 1 < count; i += 2) {
      memcpy(node + 1, level + i * 32, 32);
      memcpy(node + 33, level + (i + 1) * 32, 32);
      if (p_generichash(level + next * 32, 32, node, 65, nullptr, 0) != 0) {
        delete[] level;
        return -1;
      }
      next++;
    }
    if (count % 2 == 1) { // odd node promoted
      memcpy(level + next * 32, level + (count - 1) * 32, 32);
      next++;
    }
    count = next;
  }
  memcpy(out, level, 32);
  delete[] level;
  return 0;
}

// -------------------------------------------------------------------
// X25519 + ChaCha20-Poly1305-IETF — the transport-encryption primitives
// (net/secure.py builds the kx handshake and per-direction nonce
// counters on top; reference: noise-peer wrapping every PeerConnection,
// src/PeerConnection.ts:36).

int hm_x25519_base(const uint8_t sk[32], uint8_t pk[32]) {
  if (!(hm_init() & CAP_SODIUM))
    return -2;
  return p_scalarmult_base(pk, sk) == 0 ? 0 : -1;
}

int hm_x25519(const uint8_t sk[32], const uint8_t pk[32], uint8_t out[32]) {
  if (!(hm_init() & CAP_SODIUM))
    return -2;
  return p_scalarmult(out, sk, pk) == 0 ? 0 : -1;
}

// out must hold len + 16 bytes; returns ciphertext length or <0
long hm_aead_encrypt(const uint8_t key[32], const uint8_t nonce[12],
                     const uint8_t *msg, size_t len, uint8_t *out) {
  if (!(hm_init() & CAP_SODIUM))
    return -2;
  unsigned long long outlen = 0;
  if (p_aead_encrypt(out, &outlen, msg, (unsigned long long)len, nullptr, 0,
                     nullptr, nonce, key) != 0)
    return -1;
  return (long)outlen;
}

// out must hold len - 16 bytes; returns plaintext length, -1 on auth
// failure, -2 if unavailable
long hm_aead_decrypt(const uint8_t key[32], const uint8_t nonce[12],
                     const uint8_t *ct, size_t len, uint8_t *out) {
  if (!(hm_init() & CAP_SODIUM))
    return -2;
  unsigned long long outlen = 0;
  if (p_aead_decrypt(out, &outlen, nullptr, ct, (unsigned long long)len,
                     nullptr, 0, nonce, key) != 0)
    return -1;
  return (long)outlen;
}

// -------------------------------------------------------------------
// Block codec. codec: 1 = brotli. Returns compressed size,
// -1 on error, -2 if codec unavailable. Caller sizes `out` with
// hm_compress_bound.

size_t hm_compress_bound(size_t len) {
  return (hm_init() & CAP_BROTLI) ? p_br_bound(len) : len + 64;
}

long hm_compress(int codec, int quality, const uint8_t *in, size_t len,
                 uint8_t *out, size_t cap) {
  int caps = hm_init();
  if (codec == 1) {
    if (!(caps & CAP_BROTLI))
      return -2;
    size_t outlen = cap;
    // lgwin 22, mode 0 (generic) — quality per caller (reference iltorb
    // default quality is 11; block packing wants speed, callers pass ~5)
    if (p_br_compress(quality, 22, 0, len, in, &outlen, out) != 1)
      return -1;
    return (long)outlen;
  }
  return -2;
}

long hm_decompress(int codec, const uint8_t *in, size_t len, uint8_t *out,
                   size_t cap) {
  int caps = hm_init();
  if (codec == 1) {
    if (!(caps & CAP_BROTLI))
      return -2;
    size_t outlen = cap;
    if (p_br_decompress(len, in, &outlen, out) != 1)
      return -1;
    return (long)outlen;
  }
  return -2;
}

// -------------------------------------------------------------------
// Columnar pack: the host route of the bulk cold open's prefix pack
// (ops/columnar.py _try_pack_prefix_single under HM_DEVICE_PACK=0), a
// copy of the reference's entries. One pass per column reads each
// feed's narrow source planes directly and writes the padded output
// planes in place — pad cells are written exactly once, real cells
// exactly once, no intermediates. The plain PyTorch pack
// (ops/pack_kernels.py pack_prefix_plain) is its twin, held byte-equal
// by tests/test_torch_native_pack.py. hm_pack_gather is the device
// route's marshal: the same source planes, each doc's window copied
// into one concatenated plane per source (ops/pack_kernels.py
// marshal_pack_inputs). Every entry touches only caller-owned buffers
// (no allocation, no Python objects), so ctypes calls run with the GIL
// released and may run on several threads at once.
//
// dtype codes match storage/colcache.py _V3_DTYPES:
//   0 = int8, 1 = int16, 2 = int32, 3 = uint8
//
// Source plane order (per feed, NP pointers):
//   0 action, 1 ctr, 2 seq, 3 obj_ctr, 4 obj_a, 5 key, 6 ref_ctr,
//   7 ref_a, 8 insert, 9 vkind, 10 value, 11 dt
//
// Output column order (ops/columnar.py COLUMNS):
//   0 action, 1 actor, 2 ctr, 3 seq, 4 obj, 5 key, 6 ref, 7 insert,
//   8 vkind, 9 value, 10 dt

static const int PACK_NP = 12;
static const int PACK_NOUT = 11;

// v3 checkpoint planes sit back-to-back behind 1-byte dtype tags, so a
// plane pointer is usually NOT aligned for its element type: all typed
// loads/stores go through memcpy (compiles to a plain mov on x86/ARM64,
// and is defined behavior everywhere — unlike a misaligned typed deref)
static inline long long pk_ld(const void *p, int dt, long long i) {
  switch (dt) {
  case 0:
    return ((const int8_t *)p)[i];
  case 1: {
    int16_t v;
    memcpy(&v, (const char *)p + i * 2, 2);
    return v;
  }
  case 2: {
    int32_t v;
    memcpy(&v, (const char *)p + i * 4, 4);
    return v;
  }
  default:
    return ((const uint8_t *)p)[i];
  }
}

static inline void pk_st(void *p, int dt, long long i, long long v) {
  switch (dt) {
  case 0:
    ((int8_t *)p)[i] = (int8_t)v;
    break;
  case 1: {
    int16_t w = (int16_t)v;
    memcpy((char *)p + i * 2, &w, 2);
    break;
  }
  case 2: {
    int32_t w = (int32_t)v;
    memcpy((char *)p + i * 4, &w, 4);
    break;
  }
  default:
    ((uint8_t *)p)[i] = (uint8_t)v;
    break;
  }
}

static inline void pk_fill(void *p, int dt, long long start, long long end,
                           long long v) {
  for (long long i = start; i < end; i++)
    pk_st(p, dt, i, v);
}

static inline int pk_itemsize(int dt) { return dt == 1 ? 2 : dt == 2 ? 4 : 1; }

// value kinds that remap through a side table (ops/columnar.py VK_*)
static const int PK_VK_FLOAT = 2;
static const int PK_VK_STR = 3;
static const int PK_VK_BIGINT = 5;

// LUT indices come from DISK (sidecar planes): clamp every gather into
// the table bounds, like the numpy twin's clipped key gather — a
// corrupt sidecar must at worst pack garbage that downstream validation
// rejects, never read out of process memory. On well-formed input the
// clamp is a no-op, so the twins stay bit-identical.
static inline long long pk_lut(const long long *lut, long long len,
                               long long i) {
  if (len <= 0)
    return 0; // empty table (callers pad to >=1, but never trust that)
  if (i < 0)
    i = 0;
  if (i >= len)
    i = len - 1;
  return lut[i];
}

// min/max of the remapped value column over all real rows, folded with 0
// (the numpy twin's .min(initial=0)/.max(initial=0)) — the caller picks
// the wire dtype from this BEFORE allocating outputs.
int hm_pack_value_minmax(
    long long D, const long long *fc_idx, const long long *ends,
    const long long *src_ptrs, const uint8_t *src_dt, const long long *slut,
    const long long *soffs, const long long *flut, const long long *foffs,
    const long long *blut, const long long *boffs,
    const long long *lut_lens /* [4]: klen, slen, flen, blen */,
    long long *out_minmax) {
  long long lo = 0, hi = 0;
  for (long long d = 0; d < D; d++) {
    long long f = fc_idx[d];
    long long n = ends[d];
    const void *vk = (const void *)src_ptrs[f * PACK_NP + 9];
    int vk_dt = src_dt[f * PACK_NP + 9];
    const void *val = (const void *)src_ptrs[f * PACK_NP + 10];
    int val_dt = src_dt[f * PACK_NP + 10];
    long long so = soffs[f], fo = foffs[f], bo = boffs[f];
    for (long long i = 0; i < n; i++) {
      long long k = pk_ld(vk, vk_dt, i);
      long long v = pk_ld(val, val_dt, i);
      if (k == PK_VK_STR)
        v = pk_lut(slut, lut_lens[1], so + v);
      else if (k == PK_VK_FLOAT)
        v = pk_lut(flut, lut_lens[2], fo + v);
      else if (k == PK_VK_BIGINT)
        v = pk_lut(blut, lut_lens[3], bo + v);
      if (v < lo)
        lo = v;
      if (v > hi)
        hi = v;
    }
  }
  out_minmax[0] = lo;
  out_minmax[1] = hi;
  return 0;
}

int hm_pack_prefix(
    long long D, long long Dp, long long N, const long long *fc_idx,
    const long long *ends, const long long *src_ptrs, const uint8_t *src_dt,
    const long long *klut, const long long *koffs, const long long *slut,
    const long long *soffs, const long long *flut, const long long *foffs,
    const long long *blut, const long long *boffs,
    const long long *lut_lens /* [4]: klen, slen, flen, blen */,
    const long long *writer_g, const long long *out_ptrs,
    const uint8_t *out_dt) {
  // defaults per output column (pad rows + pad docs)
  static const long long defaults[PACK_NOUT] = {7, 0, 0, 0, -1, -1,
                                                -3, 0, 0, 0, 0};
  // plain source -> output copies: {out column, source plane}
  static const int plain[][2] = {{0, 0},  {2, 1},  {3, 2}, {7, 8},
                                 {8, 9},  {10, 11}};
  for (long long d = 0; d < D; d++) {
    long long f = fc_idx[d];
    long long n = ends[d];
    if (n < 0 || n > N)
      return -1;
    long long base = d * N;
    const long long *sp = src_ptrs + f * PACK_NP;
    const uint8_t *sd = src_dt + f * PACK_NP;

    for (size_t c = 0; c < sizeof(plain) / sizeof(plain[0]); c++) {
      int oc = plain[c][0], sc = plain[c][1];
      void *out = (void *)out_ptrs[oc];
      if (out_dt[oc] == sd[sc]) {
        memcpy((char *)out + base * pk_itemsize(out_dt[oc]),
               (const char *)sp[sc], (size_t)(n * pk_itemsize(out_dt[oc])));
      } else {
        const void *src = (const void *)sp[sc];
        for (long long i = 0; i < n; i++)
          pk_st(out, out_dt[oc], base + i, pk_ld(src, sd[sc], i));
      }
      pk_fill(out, out_dt[oc], base + n, base + N, defaults[oc]);
    }

    { // actor: the feed writer's batch-global (string-sorted) id
      void *out = (void *)out_ptrs[1];
      pk_fill(out, out_dt[1], base, base + n, writer_g[f]);
      pk_fill(out, out_dt[1], base + n, base + N, defaults[1]);
    }
    { // obj: row index of the container's MAKE op (-1 = root map)
      void *out = (void *)out_ptrs[4];
      const void *oa = (const void *)sp[4];
      const void *oc_ = (const void *)sp[3];
      int oa_dt = sd[4], oc_dt = sd[3];
      for (long long i = 0; i < n; i++) {
        long long a = pk_ld(oa, oa_dt, i);
        pk_st(out, out_dt[4], base + i,
              a == 0 ? pk_ld(oc_, oc_dt, i) - 1 : -1);
      }
      pk_fill(out, out_dt[4], base + n, base + N, defaults[4]);
    }
    { // key: feed-local key idx -> batch-global (-1 = none)
      void *out = (void *)out_ptrs[5];
      const void *kl = (const void *)sp[5];
      int kl_dt = sd[5];
      long long ko = koffs[f];
      for (long long i = 0; i < n; i++) {
        long long k = pk_ld(kl, kl_dt, i);
        pk_st(out, out_dt[5], base + i,
              k >= 0 ? pk_lut(klut, lut_lens[0], ko + k) : -1);
      }
      pk_fill(out, out_dt[5], base + n, base + N, defaults[5]);
    }
    { // ref: dense ctr -> row (-2 HEAD, -3 none)
      void *out = (void *)out_ptrs[6];
      const void *ra = (const void *)sp[7];
      const void *rc = (const void *)sp[6];
      int ra_dt = sd[7], rc_dt = sd[6];
      for (long long i = 0; i < n; i++) {
        long long a = pk_ld(ra, ra_dt, i);
        pk_st(out, out_dt[6], base + i,
              a == 0 ? pk_ld(rc, rc_dt, i) - 1 : a == -2 ? -2 : -3);
      }
      pk_fill(out, out_dt[6], base + n, base + N, defaults[6]);
    }
    { // value: side-table kinds remap through the flat global LUTs
      void *out = (void *)out_ptrs[9];
      const void *vk = (const void *)sp[9];
      const void *val = (const void *)sp[10];
      int vk_dt = sd[9], val_dt = sd[10];
      long long so = soffs[f], fo = foffs[f], bo = boffs[f];
      for (long long i = 0; i < n; i++) {
        long long k = pk_ld(vk, vk_dt, i);
        long long v = pk_ld(val, val_dt, i);
        if (k == PK_VK_STR)
          v = pk_lut(slut, lut_lens[1], so + v);
        else if (k == PK_VK_FLOAT)
          v = pk_lut(flut, lut_lens[2], fo + v);
        else if (k == PK_VK_BIGINT)
          v = pk_lut(blut, lut_lens[3], bo + v);
        pk_st(out, out_dt[9], base + i, v);
      }
      pk_fill(out, out_dt[9], base + n, base + N, defaults[9]);
    }
  }
  // pad docs [D, Dp): every column all-default
  for (int oc = 0; oc < PACK_NOUT; oc++)
    pk_fill((void *)out_ptrs[oc], out_dt[oc], D * N, Dp * N, defaults[oc]);
  return 0;
}

// The device pack's marshal: for every doc d and source plane k, the
// window [0, ends[d]) of feed fc_idx[d]'s plane k copied to
// [doc_start[d], doc_start[d] + ends[d]) of output plane k, converted to
// out_dt[k] where the feed's dtype differs. Returns -1 on a negative
// window end (the caller checks windows against the feeds' rows).
int hm_pack_gather(long long D, const long long *fc_idx,
                   const long long *ends, const long long *doc_start,
                   const long long *src_ptrs, const uint8_t *src_dt,
                   const long long *out_ptrs, const uint8_t *out_dt) {
  for (long long d = 0; d < D; d++) {
    long long n = ends[d];
    if (n < 0)
      return -1;
    const long long *sp = src_ptrs + fc_idx[d] * PACK_NP;
    const uint8_t *sd = src_dt + fc_idx[d] * PACK_NP;
    long long base = doc_start[d];
    for (int k = 0; k < PACK_NP; k++) {
      void *out = (void *)out_ptrs[k];
      if (out_dt[k] == sd[k]) {
        memcpy((char *)out + base * pk_itemsize(out_dt[k]),
               (const char *)sp[k], (size_t)(n * pk_itemsize(out_dt[k])));
      } else {
        const void *src = (const void *)sp[k];
        for (long long i = 0; i < n; i++)
          pk_st(out, out_dt[k], base + i, pk_ld(src, sd[k], i));
      }
    }
  }
  return 0;
}

// -------------------------------------------------------------------
// Change-frame codec: canonical change JSON <-> compact binary frame
// (magic 0xC5 0x01). The contract that keeps the Python twin
// (crdt/codec.py) bit-identical without reimplementing Python's JSON
// string formatter here: string fields are stored as the JSON-ESCAPED
// inner bytes exactly as json.dumps produced them, and op values as
// their full canonical JSON token bytes — this code only SCANS tokens
// on encode and copies them back verbatim on decode, so the only
// bytes it ever formats itself are decimal integers and the fixed
// canonical key skeleton. Input to encode is always
// utils/json_buffer.bufferify output (sort_keys, compact separators);
// anything off-canon returns -1 and the caller falls back to the JSON
// block format. Both entry points touch only caller-owned buffers —
// no allocation, no Python objects — so ctypes calls run GIL-free
// (pinned by codec_drops_gil()).
//
// Frame layout after the 2-byte magic (varint = unsigned LEB128,
// token = varint length + raw bytes) — fields appear in CANONICAL
// JSON KEY ORDER so encode is one forward pass over the input:
//   token actor;
//   varint n_deps; n_deps * (token key, varint seq);
//   token message;
//   varint n_ops; per op: varint action; uint8 flags
//     (1=key 2=ref 4=insert 8=value 16=datatype 32=pred);
//     token obj; [token key] [token ref] [token value-JSON]
//     [token datatype] [varint n_pred + n_pred * token];
//   varint seq, startOp, time.
//
// Return protocol (both entries): bytes required (written only when
// <= cap; caller retries with the returned size), or -1 on
// malformed/unsupported input.

static const uint8_t CH_MAGIC0 = 0xC5;
static const uint8_t CH_MAGIC1 = 0x01;
static const unsigned long long CH_IMAX =
    ((unsigned long long)1 << 63) - 1;

struct ChWr {
  uint8_t *buf;
  size_t cap;
  size_t pos;
};

static inline void ch_put(ChWr *w, uint8_t b) {
  if (w->pos < w->cap)
    w->buf[w->pos] = b;
  w->pos++;
}

static inline void ch_bytes(ChWr *w, const uint8_t *p, size_t n) {
  if (w->pos + n <= w->cap)
    memcpy(w->buf + w->pos, p, n);
  w->pos += n;
}

static inline void ch_str(ChWr *w, const char *s) {
  ch_bytes(w, (const uint8_t *)s, strlen(s));
}

static inline void ch_varint(ChWr *w, unsigned long long v) {
  do {
    uint8_t b = v & 0x7f;
    v >>= 7;
    ch_put(w, b | (v ? 0x80 : 0));
  } while (v);
}

static inline void ch_token(ChWr *w, const uint8_t *p, size_t n) {
  ch_varint(w, n);
  ch_bytes(w, p, n);
}

static inline void ch_decimal(ChWr *w, unsigned long long v) {
  char tmp[24];
  int n = snprintf(tmp, sizeof(tmp), "%llu", v);
  ch_bytes(w, (const uint8_t *)tmp, (size_t)n);
}

// --- encode side: strict scanner over canonical JSON ----------------

struct ChRd {
  const uint8_t *buf;
  size_t len;
  size_t pos;
};

static inline bool ch_lit(ChRd *r, const char *s) {
  size_t n = strlen(s);
  if (r->pos + n > r->len || memcmp(r->buf + r->pos, s, n) != 0)
    return false;
  r->pos += n;
  return true;
}

static inline uint8_t ch_peek(ChRd *r) {
  return r->pos < r->len ? r->buf[r->pos] : 0;
}

// nonnegative decimal integer < 2^63 (canonical json never emits
// leading zeros / signs for the fields this parses)
static bool ch_int(ChRd *r, unsigned long long *out) {
  size_t start = r->pos;
  unsigned long long v = 0;
  while (r->pos < r->len) {
    uint8_t c = r->buf[r->pos];
    if (c < '0' || c > '9')
      break;
    if (v > CH_IMAX / 10)
      return false;
    v = v * 10 + (c - '0');
    if (v > CH_IMAX)
      return false;
    r->pos++;
  }
  if (r->pos == start)
    return false;
  *out = v;
  return true;
}

// JSON string: cursor on the opening quote; yields the inner
// (still-escaped) span
static bool ch_jstr(ChRd *r, size_t *tok, size_t *tok_len) {
  if (ch_peek(r) != '"')
    return false;
  r->pos++;
  size_t start = r->pos;
  while (r->pos < r->len) {
    uint8_t c = r->buf[r->pos];
    if (c == '\\') {
      r->pos += 2;
      continue;
    }
    if (c == '"') {
      *tok = start;
      *tok_len = r->pos - start;
      r->pos++;
      return true;
    }
    r->pos++;
  }
  return false;
}

// one JSON value of any shape (the op "v" payload): raw token span
// ending at the first depth-0 delimiter (',' '}' ']') past the start
static bool ch_jvalue(ChRd *r, size_t *tok, size_t *tok_len) {
  size_t start = r->pos;
  int depth = 0;
  bool in_str = false;
  while (r->pos < r->len) {
    uint8_t c = r->buf[r->pos];
    if (in_str) {
      if (c == '\\') {
        r->pos += 2;
        continue;
      }
      if (c == '"')
        in_str = false;
      r->pos++;
      continue;
    }
    if (depth == 0 && r->pos != start &&
        (c == ',' || c == '}' || c == ']'))
      break; // delimiter belongs to the enclosing op object
    if (c == '"') {
      in_str = true;
    } else if (c == '{' || c == '[') {
      depth++;
    } else if (c == '}' || c == ']') {
      if (depth == 0)
        return false; // value cannot OPEN with a closer
      depth--;
    }
    r->pos++;
  }
  *tok = start;
  *tok_len = r->pos - start;
  return r->pos > start && !in_str && depth == 0;
}

long hm_change_encode(const uint8_t *in, size_t len, uint8_t *out,
                      size_t cap) {
  ChRd r = {in, len, 0};
  ChWr w = {out, cap, 0};
  size_t tok, tn;
  unsigned long long v;

  ch_put(&w, CH_MAGIC0);
  ch_put(&w, CH_MAGIC1);

  if (!ch_lit(&r, "{\"actor\":"))
    return -1;
  if (!ch_jstr(&r, &tok, &tn))
    return -1;
  ch_token(&w, in + tok, tn);

  if (!ch_lit(&r, ",\"deps\":{"))
    return -1;
  {
    // count deps by a lookahead scan (flat object of str:int pairs)
    ChRd s = r;
    unsigned long long ndeps = 0;
    if (ch_peek(&s) == '}') {
      s.pos++;
    } else {
      while (true) {
        if (!ch_jstr(&s, &tok, &tn))
          return -1;
        if (!ch_lit(&s, ":"))
          return -1;
        if (!ch_int(&s, &v))
          return -1;
        ndeps++;
        if (ch_peek(&s) == ',') {
          s.pos++;
          continue;
        }
        if (!ch_lit(&s, "}"))
          return -1;
        break;
      }
    }
    ch_varint(&w, ndeps);
    if (ch_peek(&r) == '}') {
      r.pos++;
    } else {
      while (true) {
        if (!ch_jstr(&r, &tok, &tn))
          return -1;
        ch_token(&w, in + tok, tn);
        if (!ch_lit(&r, ":"))
          return -1;
        if (!ch_int(&r, &v))
          return -1;
        ch_varint(&w, v);
        if (ch_peek(&r) == ',') {
          r.pos++;
          continue;
        }
        if (!ch_lit(&r, "}"))
          return -1;
        break;
      }
    }
  }

  if (!ch_lit(&r, ",\"message\":"))
    return -1;
  if (!ch_jstr(&r, &tok, &tn))
    return -1;
  ch_token(&w, in + tok, tn);

  if (!ch_lit(&r, ",\"ops\":["))
    return -1;
  {
    // ops count via lookahead: count top-level '{' at depth 1 of the
    // array by a light bracket scan (strings skipped)
    ChRd s = r;
    unsigned long long nops = 0;
    int depth = 1; // inside the ops array
    bool in_str = false;
    while (s.pos < s.len && depth > 0) {
      uint8_t c = s.buf[s.pos];
      if (in_str) {
        if (c == '\\')
          s.pos++;
        else if (c == '"')
          in_str = false;
      } else if (c == '"') {
        in_str = true;
      } else if (c == '{' || c == '[') {
        if (depth == 1 && c == '{')
          nops++;
        depth++;
      } else if (c == '}' || c == ']') {
        depth--;
      }
      s.pos++;
    }
    if (depth != 0)
      return -1;
    ch_varint(&w, nops);
  }
  if (ch_peek(&r) == ']') {
    r.pos++;
  } else {
    while (true) {
      if (!ch_lit(&r, "{\"a\":"))
        return -1;
      if (!ch_int(&r, &v))
        return -1;
      ch_varint(&w, v);
      uint8_t flags = 0;
      size_t k_tok = 0, k_tn = 0, r_tok = 0, r_tn = 0;
      size_t v_tok = 0, v_tn = 0, d_tok = 0, d_tn = 0;
      size_t o_tok = 0, o_tn = 0;
      // "a" is always the first key, so every later key (sorted:
      // d, i, k, o, p, r, v; "o" mandatory) arrives comma-prefixed.
      // Collect spans, then emit in flag order.
      bool have_o = false;
      // pred list span (re-scanned at emit time)
      size_t preds_at = 0;
      unsigned long long npred = 0;
      bool have_p = false;
      while (true) {
        if (ch_lit(&r, ",\"d\":")) {
          if (!ch_jstr(&r, &d_tok, &d_tn))
            return -1;
          flags |= 16;
          continue;
        }
        if (ch_lit(&r, ",\"i\":true")) {
          flags |= 4;
          continue;
        }
        if (ch_lit(&r, ",\"k\":")) {
          if (!ch_jstr(&r, &k_tok, &k_tn))
            return -1;
          flags |= 1;
          continue;
        }
        if (ch_lit(&r, ",\"o\":")) {
          if (!ch_jstr(&r, &o_tok, &o_tn))
            return -1;
          have_o = true;
          continue;
        }
        if (ch_lit(&r, ",\"p\":[")) {
          flags |= 32;
          have_p = true;
          preds_at = r.pos;
          npred = 0;
          if (ch_peek(&r) == ']') {
            r.pos++;
          } else {
            while (true) {
              if (!ch_jstr(&r, &tok, &tn))
                return -1;
              npred++;
              if (ch_peek(&r) == ',') {
                r.pos++;
                continue;
              }
              if (!ch_lit(&r, "]"))
                return -1;
              break;
            }
          }
          continue;
        }
        if (ch_lit(&r, ",\"r\":")) {
          if (!ch_jstr(&r, &r_tok, &r_tn))
            return -1;
          flags |= 2;
          continue;
        }
        if (ch_lit(&r, ",\"v\":")) {
          if (!ch_jvalue(&r, &v_tok, &v_tn))
            return -1;
          flags |= 8;
          continue;
        }
        break;
      }
      if (!have_o || !ch_lit(&r, "}"))
        return -1;
      ch_put(&w, flags);
      ch_token(&w, in + o_tok, o_tn);
      if (flags & 1)
        ch_token(&w, in + k_tok, k_tn);
      if (flags & 2)
        ch_token(&w, in + r_tok, r_tn);
      if (flags & 8)
        ch_token(&w, in + v_tok, v_tn);
      if (flags & 16)
        ch_token(&w, in + d_tok, d_tn);
      if (have_p) {
        ch_varint(&w, npred);
        ChRd pr = {in, len, preds_at};
        if (ch_peek(&pr) == ']') {
          pr.pos++;
        } else {
          for (unsigned long long i = 0; i < npred; i++) {
            if (!ch_jstr(&pr, &tok, &tn))
              return -1;
            ch_token(&w, in + tok, tn);
            if (ch_peek(&pr) == ',')
              pr.pos++;
          }
        }
      }
      if (ch_peek(&r) == ',') {
        r.pos++;
        continue;
      }
      if (!ch_lit(&r, "]"))
        return -1;
      break;
    }
  }

  if (!ch_lit(&r, ",\"seq\":"))
    return -1;
  if (!ch_int(&r, &v))
    return -1;
  ch_varint(&w, v);
  if (!ch_lit(&r, ",\"startOp\":"))
    return -1;
  if (!ch_int(&r, &v))
    return -1;
  ch_varint(&w, v);
  if (!ch_lit(&r, ",\"time\":"))
    return -1;
  if (!ch_int(&r, &v))
    return -1;
  ch_varint(&w, v);
  if (!ch_lit(&r, "}") || r.pos != len)
    return -1;
  return (long)w.pos;
}

// --- decode side: binary frame -> canonical JSON --------------------

static bool ch_rd_varint(ChRd *r, unsigned long long *out) {
  unsigned long long v = 0;
  int shift = 0;
  while (r->pos < r->len) {
    uint8_t b = r->buf[r->pos++];
    if (shift >= 63 && (b & 0x7f) > 1)
      return false;
    v |= (unsigned long long)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *out = v;
      return v <= CH_IMAX;
    }
    shift += 7;
    if (shift > 63)
      return false;
  }
  return false;
}

static bool ch_rd_token(ChRd *r, size_t *tok, size_t *tn) {
  unsigned long long n;
  if (!ch_rd_varint(r, &n))
    return false;
  if (n > r->len - r->pos)
    return false;
  *tok = r->pos;
  *tn = (size_t)n;
  r->pos += (size_t)n;
  return true;
}

long hm_change_decode(const uint8_t *in, size_t len, uint8_t *out,
                      size_t cap) {
  ChRd r = {in, len, 0};
  ChWr w = {out, cap, 0};
  size_t tok, tn;
  unsigned long long v, n;

  if (len < 2 || in[0] != CH_MAGIC0 || in[1] != CH_MAGIC1)
    return -1;
  r.pos = 2;

  ch_str(&w, "{\"actor\":\"");
  if (!ch_rd_token(&r, &tok, &tn))
    return -1;
  ch_bytes(&w, in + tok, tn);
  ch_str(&w, "\",\"deps\":{");
  if (!ch_rd_varint(&r, &n) || n > len)
    return -1;
  for (unsigned long long i = 0; i < n; i++) {
    if (i)
      ch_put(&w, ',');
    if (!ch_rd_token(&r, &tok, &tn))
      return -1;
    ch_put(&w, '"');
    ch_bytes(&w, in + tok, tn);
    ch_str(&w, "\":");
    if (!ch_rd_varint(&r, &v))
      return -1;
    ch_decimal(&w, v);
  }
  ch_str(&w, "},\"message\":\"");
  if (!ch_rd_token(&r, &tok, &tn))
    return -1;
  ch_bytes(&w, in + tok, tn);
  ch_str(&w, "\",\"ops\":[");
  if (!ch_rd_varint(&r, &n) || n > len)
    return -1;
  for (unsigned long long i = 0; i < n; i++) {
    if (i)
      ch_put(&w, ',');
    unsigned long long action;
    if (!ch_rd_varint(&r, &action))
      return -1;
    if (r.pos >= r.len)
      return -1;
    uint8_t flags = r.buf[r.pos++];
    if (flags & ~(1 | 2 | 4 | 8 | 16 | 32))
      return -1;
    size_t o_tok, o_tn, k_tok = 0, k_tn = 0, r_tok = 0, r_tn = 0;
    size_t v_tok = 0, v_tn = 0, d_tok = 0, d_tn = 0;
    if (!ch_rd_token(&r, &o_tok, &o_tn))
      return -1;
    if ((flags & 1) && !ch_rd_token(&r, &k_tok, &k_tn))
      return -1;
    if ((flags & 2) && !ch_rd_token(&r, &r_tok, &r_tn))
      return -1;
    if ((flags & 8) && !ch_rd_token(&r, &v_tok, &v_tn))
      return -1;
    if ((flags & 16) && !ch_rd_token(&r, &d_tok, &d_tn))
      return -1;
    ch_str(&w, "{\"a\":");
    ch_decimal(&w, action);
    if (flags & 16) {
      ch_str(&w, ",\"d\":\"");
      ch_bytes(&w, in + d_tok, d_tn);
      ch_put(&w, '"');
    }
    if (flags & 4)
      ch_str(&w, ",\"i\":true");
    if (flags & 1) {
      ch_str(&w, ",\"k\":\"");
      ch_bytes(&w, in + k_tok, k_tn);
      ch_put(&w, '"');
    }
    ch_str(&w, ",\"o\":\"");
    ch_bytes(&w, in + o_tok, o_tn);
    ch_put(&w, '"');
    if (flags & 32) {
      unsigned long long np;
      if (!ch_rd_varint(&r, &np) || np > len)
        return -1;
      ch_str(&w, ",\"p\":[");
      for (unsigned long long j = 0; j < np; j++) {
        if (j)
          ch_put(&w, ',');
        if (!ch_rd_token(&r, &tok, &tn))
          return -1;
        ch_put(&w, '"');
        ch_bytes(&w, in + tok, tn);
        ch_put(&w, '"');
      }
      ch_put(&w, ']');
    }
    if (flags & 2) {
      ch_str(&w, ",\"r\":\"");
      ch_bytes(&w, in + r_tok, r_tn);
      ch_put(&w, '"');
    }
    if (flags & 8) {
      ch_str(&w, ",\"v\":");
      ch_bytes(&w, in + v_tok, v_tn);
    }
    ch_put(&w, '}');
  }
  ch_str(&w, "],\"seq\":");
  if (!ch_rd_varint(&r, &v))
    return -1;
  ch_decimal(&w, v);
  ch_str(&w, ",\"startOp\":");
  if (!ch_rd_varint(&r, &v))
    return -1;
  ch_decimal(&w, v);
  ch_str(&w, ",\"time\":");
  if (!ch_rd_varint(&r, &v))
    return -1;
  ch_decimal(&w, v);
  ch_put(&w, '}');
  if (r.pos != len)
    return -1;
  return (long)w.pos;
}

} // extern "C"
