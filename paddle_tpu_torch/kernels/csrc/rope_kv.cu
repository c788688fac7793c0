// rope_kv_write: rotate-half RoPE on q and k rows (in place, in the
// scratch buffers) and the k/v rows written into the paged pool; without
// RoPE (the GPT layer: LayerArgs::rope 0, learned positions) only the
// k / v rows written into the pool, q and k left as they are.
//
// Part of the decode_block / prefill_block chain (replaces the RoPE and
// paged-append stages of paddle_tpu/ops/pallas/decode_block.py::_kernel
// and the pool scatter after prefill_block.py::_kernel; `meta.rope` off at
// decode_block.py:266 skips the rotation).
//
// The write target of row r:
//   decode  (lengths != 0): pool[bt[r, lengths[r] / BS], lengths[r] % BS]
//   prefill (blk != 0):     pool[blk[r], off[r]]
// and the write is DROPPED — never wrapped onto another page — when the
// page is unmapped (-1: an inactive decode slot), lies past the table, or
// is out of the pool (the engine routes a bucket's padded tail to page
// NB, as the JAX engine does).
//
// Arithmetic: x*cos + rotate_half(x)*sin with each product and the sum
// rounded to T, as the plain version's separate torch ops round them
// (ops/cuda/kernels.py rope_kv_write_ref); __fmul_rn / __fadd_rn keep the
// fp32 instance from contracting them into an FMA, so the kernel equals
// the plain version bit for bit in both dtypes.
//
// What bounds it on an H100: at decode (B 4, llama_7b: 230 KB) one launch
// and one dependent round trip to memory, far above the 0.06 us byte
// bound; at prefill (Ts 256: 14.8 MB) bytes.  Design:
//   * One thread a 16-byte chunk of one head of one row: 16 / sizeof(T)
//     consecutive values of the head's first half and the matching ones of
//     its second half (with the same slices of cos and sin), so a head of
//     D 128 takes 8 lanes in bf16 (16 in fp32), several heads a warp, and
//     the rows' (Hq + Hkv) heads spread over the card in blocks of 64
//     threads (256 head-rows at decode B 4, 16 384 at a Ts 256 prefill
//     chunk; 64 threads a block took 1.98 us at decode where 128 took 2.02
//     and 256 2.41, tools/rope_softmax_ab.py on an NVIDIA H100 80GB HBM3
//     at 700 W).  A kv head's threads also carry its v row.  D off the
//     chunks or an unaligned pointer takes the same kernel one pair a
//     thread.
//   * No loop: each thread issues all of its loads (q / k halves, cos,
//     sin, v, and the pool target: the row's length and then its page, or
//     its blk / off; the lanes of a row read one address) before its
//     first store, and every pointer is __restrict__, so nothing waits on
//     a store.  The target gates only the pool stores.
//   * Without RoPE (the ROPE template flag off; the GPT layer): the
//     threads cover the kv heads only, load no cos / sin, store no q or k
//     rows back, and write k and v into the pool as they are, bit for bit.
//   * An int8 pool (rope_kv_write_q8, counted apart; the kv_quant branches
//     of the TPU kernels, decode_block.py:272 and the prefill scatter) has
//     a kernel of its own, rope_kv_write_q8_kernel, with the sibling's
//     arithmetic before the quantization: after the RoPE (if any), rounded
//     to T as above, a kv head's k row and v row each take scale =
//     max(absmax, 1e-8) / 127 and codes clip(rint(x / scale), -127, 127),
//     equal bit for bit to ops.paged_kv.quantize_kv (two IEEE divisions).
//     Its design (the sibling's layout had taken 1.8x the sibling's time
//     at decode and 2.3x at prefill, one long serial chain a lane: 32 IEEE
//     divisions behind 3 shuffle rounds, q lanes reducing for nothing):
//       - Roles: the kv blocks come first in the grid; q heads (RoPE only)
//         have blocks of their own that rotate and store as the sibling
//         does and run no reduction.
//       - A kv lane holds V = 8 consecutive values of each half of one
//         row (one 16-byte load a half in bf16), of k and v on the same
//         lane with RoPE and of k or v on lanes of their own without (KVS;
//         each the faster in its instance), so a head takes D / 16 lanes,
//         neighbours in the warp (a power of two, aligned), and its absmax
//         takes log2 of that many xor shuffles; a bf16 lane holding k and
//         v shuffles both maxima (bf16 values) as one word.  It issues its
//         loads as the sibling does: the row's length (or blk / off), the
//         data, then the page through the table, so no data load waits
//         behind the table's dependent one (issued first, it had cost
//         0.26 us at llama_7b decode).
//       - The division: the scale is RN(m / 127) from RN(1 / 127) and one
//         FMA correction, and each code's quotient RN(x / s) from y =
//         RN(1 / s) (__frcp_rn, once a lane) and one FMA correction
//         (div_rn: Markstein's theorem, exact where a / b, a, b and the
//         residual are normal).  Where it is not proven the code does not
//         depend on it: |x / s| < 1/2 gives code 0 whatever the last bits
//         (x below 2^-126 included), and for |x / s| >= 1/2, s >= 1e-8 /
//         127 > 2^-34 makes x, the quotient and a nonzero residual (a
//         multiple of ulp(s) ulp(q) >= 2^-82) normal.  rint is one add of
//         1.5 x 2^23 (round half to even), the code the low byte of the
//         sum; clip is dropped as a no-op: |x| <= m makes |x / s| <= 127
//         (1 + 2^-23), which rounds to at most 127.
//       - A lane's codes go out as one 8-byte store a half, the scale from
//         the head's first lane as soon as it exists, under the sibling's
//         dropped-write rule; lanes past the rows return at once (whole
//         heads a warp: the live lanes of a warp are a prefix, and the
//         shuffles name them).
//     Measured (tools/rope_softmax_ab.py, NVIDIA H100 80GB HBM3, 700 W):
//     llama_7b decode 3.67 -> 2.19 us, prefill Ts 256 9.16 -> 4.61;
//     GPT-125M decode 3.00 -> 1.78, Ts 256 2.94 -> 1.97.
#include <stdint.h>

#include "common.cuh"

namespace pt {

constexpr int ROPE_THREADS = 64;

// C values of T as one load / store (16 bytes when C = 16 / sizeof(T))
template <typename T, int C>
struct alignas(C * sizeof(T)) Pack {
  T v[C];
};

struct RopeGeo {
  int M, Hq, Hkv, D, BS, NB, MB;
};

// a*b rounded to T, plus c*d rounded to T, the sum rounded to T
template <typename T>
__device__ __forceinline__ T rope_sum(float a, float b, float c, float d) {
  return from_f<T>(__fadd_rn(rnd<T>(__fmul_rn(a, b)), rnd<T>(__fmul_rn(c, d))));
}

// the int8 pool's scales (rope_kv_write_q8)
struct KvScales {
  float *k, *v;                               // [NB, BS, Hkv]
};

template <typename T, int C, bool ROPE>
__global__ void __launch_bounds__(ROPE_THREADS)
    rope_kv_write_kernel(T *__restrict__ q, T *__restrict__ k,
                         const T *__restrict__ v, const T *__restrict__ cs,
                         const T *__restrict__ sn,
                         const int *__restrict__ bt,
                         const int *__restrict__ lengths,
                         const int *__restrict__ blk,
                         const int *__restrict__ off, void *__restrict__ pk,
                         void *__restrict__ pv, RopeGeo g) {
  typedef Pack<T, C> P;
  // without RoPE the threads cover the kv heads only
  const int D2 = g.D / 2, CH = D2 / C, heads = ROPE ? g.Hq + g.Hkv : g.Hkv;
  const long long total = (long long)g.M * heads * CH;
  const long long slot = (long long)blockIdx.x * ROPE_THREADS + threadIdx.x;
  if (slot >= total) return;
  const long long rh = slot / CH;
  const int d = (int)(slot - rh * CH) * C;
  const int r = (int)(rh / heads), h = (int)(rh - (long long)r * heads);
  const bool isk = !ROPE || h >= g.Hq;
  const int hk = ROPE ? h - g.Hq : h;

  int pos = -1, phys = -1, o = 0;
  if (isk) {
    if (lengths) {
      pos = lengths[r];
    } else {
      phys = blk[r];
      o = off[r];
    }
  }
  T *x = isk ? k + ((size_t)r * g.Hkv + hk) * g.D
             : q + ((size_t)r * g.Hq + h) * g.D;
  const P x1 = *reinterpret_cast<const P *>(x + d);
  const P x2 = *reinterpret_cast<const P *>(x + D2 + d);
  P c1 = {}, c2 = {}, s1 = {}, s2 = {};
  if constexpr (ROPE) {
    const T *cr = cs + (size_t)r * g.D, *sr = sn + (size_t)r * g.D;
    c1 = *reinterpret_cast<const P *>(cr + d);
    c2 = *reinterpret_cast<const P *>(cr + D2 + d);
    s1 = *reinterpret_cast<const P *>(sr + d);
    s2 = *reinterpret_cast<const P *>(sr + D2 + d);
  }
  P v1 = {}, v2 = {};
  if (isk) {
    const T *vr = v + ((size_t)r * g.Hkv + hk) * g.D;
    v1 = *reinterpret_cast<const P *>(vr + d);
    v2 = *reinterpret_cast<const P *>(vr + D2 + d);
    if (lengths && pos >= 0) {
      const int pi = pos / g.BS;
      if (pi < g.MB) phys = bt[(size_t)r * g.MB + pi];
      o = pos % g.BS;
    }
  }

  P y1 = x1, y2 = x2;
  if constexpr (ROPE) {
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float a1 = to_f<T>(x1.v[j]), a2 = to_f<T>(x2.v[j]);
      y1.v[j] = rope_sum<T>(a1, to_f<T>(c1.v[j]), -a2, to_f<T>(s1.v[j]));
      y2.v[j] = rope_sum<T>(a2, to_f<T>(c2.v[j]), a1, to_f<T>(s2.v[j]));
    }
  }
  if constexpr (ROPE) {
    *reinterpret_cast<P *>(x + d) = y1;
    *reinterpret_cast<P *>(x + D2 + d) = y2;
  }
  if (isk && phys >= 0 && phys < g.NB && o >= 0 && o < g.BS) {
    const size_t row = ((size_t)phys * g.BS + o) * g.Hkv + hk;
    const size_t base = row * g.D;
    T *tk = (T *)pk, *tv = (T *)pv;
    *reinterpret_cast<P *>(tk + base + d) = y1;
    *reinterpret_cast<P *>(tk + base + D2 + d) = y2;
    *reinterpret_cast<P *>(tv + base + d) = v1;
    *reinterpret_cast<P *>(tv + base + D2 + d) = v2;
  }
}


// ------------------------------------------------------------------ int8
constexpr int Q8_THREADS = 64;
constexpr float RCP127 = 0x1.020408p-7f;      // RN(1 / 127)

// RN(a / b) from y = RN(1 / b): q = RN(a y) is within an ulp of a / b, the
// residual a - b q is exact in an FMA, and RN(q + (a - b q) y) is the
// rounded quotient (Markstein's theorem; where it holds: the header)
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  const float q = __fmul_rn(a, y);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// rint(x / s) in the low byte (x / s within +-2^22): 1.5 x 2^23 + x / s
// rounded to an integer, half to even
__device__ __forceinline__ unsigned code_word(float x, float s, float y) {
  return __float_as_uint(__fadd_rn(div_rn(x, s, y), 0x1.8p23f));
}

// the V codes of a[0 .. V) as V bytes, four to a word
template <int V>
__device__ __forceinline__ void codes(const float (&a)[V], float s, float y,
                                      unsigned (&w)[V / 4]) {
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const unsigned c0 = code_word(a[4 * i], s, y);
    const unsigned c1 = code_word(a[4 * i + 1], s, y);
    const unsigned c2 = code_word(a[4 * i + 2], s, y);
    const unsigned c3 = code_word(a[4 * i + 3], s, y);
    w[i] = __byte_perm(__byte_perm(c0, c1, 0x0040),
                       __byte_perm(c2, c3, 0x0040), 0x5410);
  }
}

template <int V>
__device__ __forceinline__ void store_codes(signed char *dst,
                                            const unsigned (&w)[V / 4]) {
  static_assert(V == 8 || V == 16, "8 or 16 codes a half");
  if constexpr (V == 16)
    *reinterpret_cast<uint4 *>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2 *>(dst) = make_uint2(w[0], w[1]);
}

// n values of T from p into f (n a multiple of 16 / sizeof(T))
template <typename T, int N>
__device__ __forceinline__ void load_f(const T *p, float (&f)[N]) {
  constexpr int C = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < N / C; ++i) {
    const Pack<T, C> u = reinterpret_cast<const Pack<T, C> *>(p)[i];
#pragma unroll
    for (int j = 0; j < C; ++j) f[i * C + j] = to_f<T>(u.v[j]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store_t(T *p, const float (&f)[N]) {
  constexpr int C = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < N / C; ++i) {
    Pack<T, C> u;
#pragma unroll
    for (int j = 0; j < C; ++j) u.v[j] = from_f<T>(f[i * C + j]);
    reinterpret_cast<Pack<T, C> *>(p)[i] = u;
  }
}

// One launch: blocks [0, kvb) the kv lanes, then (ROPE) the q heads' lanes
// of 16 / sizeof(T) values a half.  A kv lane: V values of each half of
// one head of one row, of k (rotated, stored back, quantized) and of v
// (KVS: k or v, k lanes first; else both).
template <typename T, int V, bool KVS, bool ROPE>
__global__ void __launch_bounds__(Q8_THREADS)
    rope_kv_write_q8_kernel(T *__restrict__ q, T *__restrict__ k,
                            const T *__restrict__ v,
                            const T *__restrict__ cs,
                            const T *__restrict__ sn,
                            const int *__restrict__ bt,
                            const int *__restrict__ lengths,
                            const int *__restrict__ blk,
                            const int *__restrict__ off,
                            signed char *__restrict__ pk,
                            signed char *__restrict__ pv, KvScales ks,
                            RopeGeo g, int kvb) {
  const int D2 = g.D / 2;
  if (ROPE && (int)blockIdx.x >= kvb) {       // a q head: rotate, store
    constexpr int C = 16 / sizeof(T);
    typedef Pack<T, C> P;
    const int CH = D2 / C;
    const long long slot =
        (long long)(blockIdx.x - kvb) * Q8_THREADS + threadIdx.x;
    if (slot >= (long long)g.M * g.Hq * CH) return;
    const long long rh = slot / CH;
    const int d = (int)(slot - rh * CH) * C, r = (int)(rh / g.Hq);
    T *x = q + rh * g.D;
    const T *cr = cs + (size_t)r * g.D, *sr = sn + (size_t)r * g.D;
    const P x1 = *reinterpret_cast<const P *>(x + d);
    const P x2 = *reinterpret_cast<const P *>(x + D2 + d);
    const P c1 = *reinterpret_cast<const P *>(cr + d);
    const P c2 = *reinterpret_cast<const P *>(cr + D2 + d);
    const P s1 = *reinterpret_cast<const P *>(sr + d);
    const P s2 = *reinterpret_cast<const P *>(sr + D2 + d);
    P y1, y2;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float a1 = to_f<T>(x1.v[j]), a2 = to_f<T>(x2.v[j]);
      y1.v[j] = rope_sum<T>(a1, to_f<T>(c1.v[j]), -a2, to_f<T>(s1.v[j]));
      y2.v[j] = rope_sum<T>(a2, to_f<T>(c2.v[j]), a1, to_f<T>(s2.v[j]));
    }
    *reinterpret_cast<P *>(x + d) = y1;
    *reinterpret_cast<P *>(x + D2 + d) = y2;
    return;
  }
  constexpr int NT = KVS ? 1 : 2;              // tensors a lane
  const int L = D2 / V;                        // lanes a head and tensor
  const long long n = (long long)g.M * g.Hkv * L;
  const long long total = KVS ? 2 * n : n;
  const long long slot = (long long)blockIdx.x * Q8_THREADS + threadIdx.x;
  if (slot >= total) return;
  // whole heads a warp: this warp's live lanes are a prefix
  const long long wbase = slot - (threadIdx.x & 31);
  const unsigned live = total - wbase >= 32
                            ? 0xffffffffu
                            : (1u << (unsigned)(total - wbase)) - 1u;
  const bool isv = KVS && slot >= n;           // KVS: a v lane
  const long long sl = isv ? slot - n : slot;
  const long long rh = sl / L;                 // row * Hkv + kv head
  const int d = (int)(sl - rh * L) * V, r = (int)(rh / g.Hkv);
  const int hk = (int)(rh - (long long)r * g.Hkv);
  // the write target as the sibling takes it: the row's length (or blk /
  // off) first, the page through the table once the data loads are out
  int pos = -1, phys = -1, o = 0;
  if (lengths) {
    pos = lengths[r];
  } else {
    phys = blk[r];
    o = off[r];
  }
  // x[t][half]: tensor t of the lane (KVS: k or v; else k, then v)
  float x[NT][2][V];
  T *kr = k + rh * g.D;
  const T *vr = v + rh * g.D;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const T *src = (KVS ? isv : t) ? vr : kr;
    load_f<T, V>(src + d, x[t][0]);
    load_f<T, V>(src + D2 + d, x[t][1]);
  }
  float c1[V], c2[V], s1[V], s2[V];            // k lanes with RoPE
  if (ROPE && !isv) {
    const T *cr = cs + (size_t)r * g.D, *sr = sn + (size_t)r * g.D;
    load_f<T, V>(cr + d, c1);
    load_f<T, V>(cr + D2 + d, c2);
    load_f<T, V>(sr + d, s1);
    load_f<T, V>(sr + D2 + d, s2);
  }
  if (lengths && pos >= 0) {
    const int pi = pos / g.BS;
    if (pi < g.MB) phys = bt[(size_t)r * g.MB + pi];
    o = pos % g.BS;
  }
  if (ROPE && !isv) {                          // k: rotate, store back
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float x1 = x[0][0][j], x2 = x[0][1][j];
      x[0][0][j] = to_f<T>(rope_sum<T>(x1, c1[j], -x2, s1[j]));
      x[0][1][j] = to_f<T>(rope_sum<T>(x2, c2[j], x1, s2[j]));
    }
    store_t<T, V>(kr + d, x[0][0]);
    store_t<T, V>(kr + D2 + d, x[0][1]);
  }
  // each tensor's absmax over the head's L neighbouring lanes
  float m[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    m[t] = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j)
      m[t] = fmaxf(m[t], fmaxf(fabsf(x[t][0][j]), fabsf(x[t][1][j])));
  }
  if constexpr (NT == 2 && sizeof(T) == 2) {
    // both maxima are bf16 values (of bf16 values): one word, one
    // shuffle and one packed max a round
    __nv_bfloat162 mm = __floats2bfloat162_rn(m[0], m[1]);
    for (int w = L / 2; w > 0; w >>= 1)
      mm = __hmax2(mm, __shfl_xor_sync(live, mm, w));
    m[0] = __low2float(mm);
    m[1] = __high2float(mm);
  } else {
    for (int w = L / 2; w > 0; w >>= 1)
#pragma unroll
      for (int t = 0; t < NT; ++t)
        m[t] = fmaxf(m[t], __shfl_xor_sync(live, m[t], w));
  }
  if (phys < 0 || phys >= g.NB || o < 0 || o >= g.BS) return;
  const size_t row = ((size_t)phys * g.BS + o) * g.Hkv + hk;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const bool tv = KVS ? isv : t;
    const float sc = div_rn(fmaxf(m[t], 1e-8f), 127.f, RCP127);
    if (d == 0) (tv ? ks.v : ks.k)[row] = sc;
    const float y = __frcp_rn(sc);
    unsigned w1[V / 4], w2[V / 4];
    codes<V>(x[t][0], sc, y, w1);
    codes<V>(x[t][1], sc, y, w2);
    signed char *dst = (tv ? pv : pk) + row * g.D + d;
    store_codes<V>(dst, w1);
    store_codes<V>(dst + D2, w2);
  }
}

static bool aligned16(const void *p) { return ((uintptr_t)p & 15) == 0; }

// the int8 pool's launch shape: V values a half a lane; k and v on lanes
// of their own (KVS) without RoPE, on the same lanes with it (where a k
// lane also loads cos / sin and rotates): each the faster in its
// instance (tools/rope_softmax_ab.py)
constexpr int Q8_V = 8;
constexpr bool Q8_KVS_PLAIN = true, Q8_KVS_ROPE = false;

template <typename T, bool ROPE>
static cudaError_t q8_launch(const LayerArgs *a, const RopeGeo &g,
                             cudaStream_t s) {
  constexpr int C = 16 / sizeof(T);
  // Q8_V values a half a lane; the lanes of a head a power of two, in one
  // warp (head_dim 32, 64 and 128, all the layer takes)
  const int D2 = a->D / 2, L = D2 / Q8_V;
  if (D2 % Q8_V || L > 32 || (L & (L - 1))) return cudaErrorInvalidValue;
  constexpr bool KVS = ROPE ? Q8_KVS_ROPE : Q8_KVS_PLAIN;
  const long long kv = (long long)a->M * a->Hkv * L * (KVS ? 2 : 1);
  const long long qn = ROPE ? (long long)a->M * a->Hq * (D2 / C) : 0;
  const long long kvb = (kv + Q8_THREADS - 1) / Q8_THREADS;
  const long long qb = (qn + Q8_THREADS - 1) / Q8_THREADS;
  if (kvb + qb > 0x7fffffffLL) return cudaErrorInvalidValue;
  rope_kv_write_q8_kernel<T, Q8_V, KVS, ROPE>
      <<<(unsigned)(kvb + qb), Q8_THREADS, 0, s>>>(
      (T *)a->q, (T *)a->k, (const T *)a->v, (const T *)a->cos,
      (const T *)a->sin, a->block_table, a->lengths, a->blk, a->off,
      (signed char *)a->pool_k, (signed char *)a->pool_v,
      KvScales{a->pool_ks, a->pool_vs}, g, (int)kvb);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t rope_kv_launch(const LayerArgs *a, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool rope = a->rope != 0;
  if (rope && (!a->cos || !a->sin)) return cudaErrorInvalidValue;
  const bool vec = (a->D / 2) % VEC == 0 && aligned16(a->q) &&
                   aligned16(a->k) && aligned16(a->v) &&
                   (!rope || (aligned16(a->cos) && aligned16(a->sin))) &&
                   aligned16(a->pool_k) && aligned16(a->pool_v);
  const RopeGeo g{a->M, a->Hq, a->Hkv, a->D, a->BS, a->NB, a->MB};
  if (a->kv_quant) {
    // whole 16-byte loads, the scales' pools
    if (!vec || !a->pool_ks || !a->pool_vs) return cudaErrorInvalidValue;
    return rope ? q8_launch<T, true>(a, g, s) : q8_launch<T, false>(a, g, s);
  }
  const long long n = (long long)a->M * (rope ? a->Hq + a->Hkv : a->Hkv) *
                      (a->D / 2 / (vec ? VEC : 1));
  const unsigned grid = (unsigned)((n + ROPE_THREADS - 1) / ROPE_THREADS);
  auto kern = rope ? (vec ? rope_kv_write_kernel<T, VEC, true>
                          : rope_kv_write_kernel<T, 1, true>)
              : vec ? rope_kv_write_kernel<T, VEC, false>
                    : rope_kv_write_kernel<T, 1, false>;
  kern<<<grid, ROPE_THREADS, 0, s>>>(
      (T *)a->q, (T *)a->k, (const T *)a->v, (const T *)a->cos,
      (const T *)a->sin, a->block_table, a->lengths, a->blk, a->off,
      a->pool_k, a->pool_v, g);
  return cudaGetLastError();
}

}  // namespace pt

cudaError_t launch_rope_kv_write(const LayerArgs *a, cudaStream_t s) {
  if (a->M <= 0) return cudaSuccess;
  if (a->D <= 0 || a->D % 2) return cudaErrorInvalidValue;
  const cudaError_t e = a->dtype == PT_BF16
                            ? pt::rope_kv_launch<pt::bf16>(a, s)
                            : pt::rope_kv_launch<float>(a, s);
  if (a->kv_quant) return count_launch(CNT_ROPE_KV_WRITE_Q8, e);
  return count_launch(CNT_ROPE_KV_WRITE, e);
}
