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
//     rows back, and write k and v into the pool as they are: bit for bit
//     into a full-width pool (counted as rope_kv_write), or as int8 codes
//     and scales as below (counted as rope_kv_write_q8; the head's D2 / C
//     lanes, 4 at D 64 bf16, are still neighbours aligned in the warp: the
//     slots of a row's head are consecutive and D2 / C is a power of two).
//   * An int8 pool (rope_kv_write_q8, counted apart; the kv_quant branches
//     of the TPU kernels, decode_block.py:272 and the prefill scatter):
//     after the RoPE (if any), rounded to T as above, the lanes of a kv
//     head take the absmax of its k row and of its v row over D by a
//     shuffle (the head's D2 / C lanes are neighbours, aligned in the
//     warp), scale = max(absmax, 1e-8) / 127 and codes clip(rint(x /
//     scale), -127, 127), both IEEE divisions (__fdiv_rn), as
//     ops.paged_kv.quantize_kv: equal to it bit for bit.  A lane stores
//     its 2 C codes (C bytes a half) and the head's first lane the two
//     fp32 scales, at the same (page, offset) and under the same
//     dropped-write rule.  No lane returns before the shuffle; lanes past
//     the rows load the last slot and store nothing.
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

// |x| over the C values of two packs
template <typename T, int C>
__device__ __forceinline__ float absmax2(const Pack<T, C> &a,
                                         const Pack<T, C> &b) {
  float m = 0.f;
#pragma unroll
  for (int j = 0; j < C; ++j)
    m = fmaxf(m, fmaxf(fabsf(to_f<T>(a.v[j])), fabsf(to_f<T>(b.v[j]))));
  return m;
}

// C codes clip(rint(x / s), -127, 127) as C bytes
template <typename T, int C>
__device__ __forceinline__ Pack<signed char, C> codes(const Pack<T, C> &x,
                                                      float s) {
  Pack<signed char, C> out;
#pragma unroll
  for (int j = 0; j < C; ++j)
    out.v[j] = (signed char)fminf(
        fmaxf(rintf(__fdiv_rn(to_f<T>(x.v[j]), s)), -127.f), 127.f);
  return out;
}

template <typename T, int C, bool Q8, bool ROPE>
__global__ void __launch_bounds__(ROPE_THREADS)
    rope_kv_write_kernel(T *__restrict__ q, T *__restrict__ k,
                         const T *__restrict__ v, const T *__restrict__ cs,
                         const T *__restrict__ sn,
                         const int *__restrict__ bt,
                         const int *__restrict__ lengths,
                         const int *__restrict__ blk,
                         const int *__restrict__ off, void *__restrict__ pk,
                         void *__restrict__ pv, KvScales ks, RopeGeo g) {
  typedef Pack<T, C> P;
  // without RoPE the threads cover the kv heads only
  const int D2 = g.D / 2, CH = D2 / C, heads = ROPE ? g.Hq + g.Hkv : g.Hkv;
  const long long total = (long long)g.M * heads * CH;
  long long slot = (long long)blockIdx.x * ROPE_THREADS + threadIdx.x;
  const bool in = slot < total;
  if (!Q8 && !in) return;
  if (!in) slot = total - 1;                   // Q8: loads only
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
  float sk = 0.f, sv = 0.f;
  if constexpr (Q8) {
    // the head's absmax over its CH neighbouring lanes (q heads' lanes
    // shuffle among themselves and store no codes)
    float mk = absmax2(y1, y2), mv = absmax2(v1, v2);
    for (int w = CH / 2; w > 0; w >>= 1) {
      mk = fmaxf(mk, __shfl_xor_sync(0xffffffffu, mk, w));
      mv = fmaxf(mv, __shfl_xor_sync(0xffffffffu, mv, w));
    }
    sk = __fdiv_rn(fmaxf(mk, 1e-8f), 127.f);
    sv = __fdiv_rn(fmaxf(mv, 1e-8f), 127.f);
  }
  if (!in) return;
  if constexpr (ROPE) {
    *reinterpret_cast<P *>(x + d) = y1;
    *reinterpret_cast<P *>(x + D2 + d) = y2;
  }
  if (isk && phys >= 0 && phys < g.NB && o >= 0 && o < g.BS) {
    const size_t row = ((size_t)phys * g.BS + o) * g.Hkv + hk;
    const size_t base = row * g.D;
    if constexpr (Q8) {
      typedef Pack<signed char, C> Q;
      signed char *qk = (signed char *)pk, *qv = (signed char *)pv;
      *reinterpret_cast<Q *>(qk + base + d) = codes(y1, sk);
      *reinterpret_cast<Q *>(qk + base + D2 + d) = codes(y2, sk);
      *reinterpret_cast<Q *>(qv + base + d) = codes(v1, sv);
      *reinterpret_cast<Q *>(qv + base + D2 + d) = codes(v2, sv);
      if (d == 0) {
        ks.k[row] = sk;
        ks.v[row] = sv;
      }
    } else {
      T *tk = (T *)pk, *tv = (T *)pv;
      *reinterpret_cast<P *>(tk + base + d) = y1;
      *reinterpret_cast<P *>(tk + base + D2 + d) = y2;
      *reinterpret_cast<P *>(tv + base + d) = v1;
      *reinterpret_cast<P *>(tv + base + D2 + d) = v2;
    }
  }
}

static bool aligned16(const void *p) { return ((uintptr_t)p & 15) == 0; }

template <typename T>
static cudaError_t rope_kv_launch(const LayerArgs *a, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const bool rope = a->rope != 0;
  if (rope && (!a->cos || !a->sin)) return cudaErrorInvalidValue;
  const bool vec = (a->D / 2) % VEC == 0 && aligned16(a->q) &&
                   aligned16(a->k) && aligned16(a->v) &&
                   (!rope || (aligned16(a->cos) && aligned16(a->sin))) &&
                   aligned16(a->pool_k) && aligned16(a->pool_v);
  // the int8 pool's shuffle needs a head's lanes inside one warp: whole
  // 16-byte chunks, D / 2 / VEC lanes a head
  if (a->kv_quant && (!vec || (a->D / 2) / VEC > 32 || !a->pool_ks ||
                      !a->pool_vs))
    return cudaErrorInvalidValue;
  const RopeGeo g{a->M, a->Hq, a->Hkv, a->D, a->BS, a->NB, a->MB};
  const long long n = (long long)a->M * (rope ? a->Hq + a->Hkv : a->Hkv) *
                      (a->D / 2 / (vec ? VEC : 1));
  const unsigned grid = (unsigned)((n + ROPE_THREADS - 1) / ROPE_THREADS);
  auto kern = a->kv_quant ? (rope ? rope_kv_write_kernel<T, VEC, true, true>
                                  : rope_kv_write_kernel<T, VEC, true, false>)
              : rope      ? (vec ? rope_kv_write_kernel<T, VEC, false, true>
                                 : rope_kv_write_kernel<T, 1, false, true>)
              : vec       ? rope_kv_write_kernel<T, VEC, false, false>
                          : rope_kv_write_kernel<T, 1, false, false>;
  kern<<<grid, ROPE_THREADS, 0, s>>>(
      (T *)a->q, (T *)a->k, (const T *)a->v, (const T *)a->cos,
      (const T *)a->sin, a->block_table, a->lengths, a->blk, a->off,
      a->pool_k, a->pool_v, KvScales{a->pool_ks, a->pool_vs}, g);
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
