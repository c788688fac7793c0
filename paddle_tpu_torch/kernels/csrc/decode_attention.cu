// Decode attention over a contiguous KV cache: one query token per
// sequence against its cache rows [0, lengths[b]), GQA native.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_attention.py
// (_decode_kernel, pallas_call at :106), with its arithmetic: fp32
// scores q.k * scale, an online softmax over blocks of 512 cache rows
// (the Pallas kernel's block_t) in fp32, p rounded to the cache's dtype
// before p @ v with fp32 accumulation, out = acc / max(l, 1e-30) in q's
// dtype.  Within a block the max is taken over the whole block before any
// p is formed, as the Pallas kernel does, so the rounding of p matches
// the plain version (ops/decode_attention.py) exactly, not just to fp32.
//
// Layouts: q [B, Hq, D] contiguous; k, v [B, T, Hkv, D] read in place
// through a batch stride sb and a row stride st (elements; the last two
// dims contiguous), so a layer's slice of the generation cache needs no
// copy; lengths int32 [B]; out [B, Hq, D].
//
// What bounds it on an H100: bytes.  It reads each valid K and V row once
// (generation at llama_7b width, B 8, 256 cached rows: 33.5 MB a layer,
// 10 us at 3.35 TB/s) and does 4 flops per cached element.  Design:
//   * The TPU version pads T to 512 and swaps the cache to [B, Hkv, T, D]
//     with copies; here one block of 8 warps owns one (b, kv head), reads
//     rows in place and stops at lengths[b]: rows past it are never read.
//   * The G = Hq / Hkv query heads of a kv head share each K/V row load:
//     a lane holds D/32 elements of each of the G queries (G <= 8) and of
//     the row, so a warp reads one 128- or 256-byte row in one coalesced
//     load, KU rows at a time per warp to keep loads in flight.
//   * Per block of 512 rows: pass 1 writes the G x 512 fp32 scores to
//     shared memory (a warp-shuffle sum per row), a block reduction gives
//     the block max, pass 2 turns scores into p and sums l, pass 3
//     accumulates bf16(p) * v in fp32 registers (each warp its own rows),
//     rescaled by alpha = exp(m_old - m_new) per block.  The warps'
//     partial accumulators are summed through shared memory at the end.
//   * head_dim 64 and 128 are template instances; the wrapper refuses
//     any other.
#include "common.cuh"

namespace pt {
namespace dattn {

constexpr int THREADS = 256, NWARP = THREADS / 32;
constexpr int BLOCK_T = 512, MAXG = 8, KU = 4;
constexpr float NEG_INF = -1e30f;

// EL consecutive elements of T (one lane's share of a row) as floats
template <typename T, int EL>
__device__ __forceinline__ void load_row(const T *p, float *f) {
  constexpr int BYTES = EL * (int)sizeof(T);
  static_assert(BYTES == 4 || BYTES == 8 || BYTES == 16, "row share");
  if constexpr (BYTES == 16) {
    uint4 u = __ldg(reinterpret_cast<const uint4 *>(p));
    const T *e = reinterpret_cast<const T *>(&u);
#pragma unroll
    for (int i = 0; i < EL; ++i) f[i] = to_f<T>(e[i]);
  } else if constexpr (BYTES == 8) {
    uint2 u = __ldg(reinterpret_cast<const uint2 *>(p));
    const T *e = reinterpret_cast<const T *>(&u);
#pragma unroll
    for (int i = 0; i < EL; ++i) f[i] = to_f<T>(e[i]);
  } else {
    unsigned u = __ldg(reinterpret_cast<const unsigned *>(p));
    const T *e = reinterpret_cast<const T *>(&u);
#pragma unroll
    for (int i = 0; i < EL; ++i) f[i] = to_f<T>(e[i]);
  }
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    decode_attention_kernel(const void *q_, const void *k_, const void *v_,
                            const int *__restrict__ lengths, void *out_,
                            int Hq, int Hkv, int T_, long long sb,
                            long long st, float scale) {
  constexpr int EL = D / 32;
  // scores [MAXG][BLOCK_T] during the blocks, then the warps' partial
  // accumulators [NWARP][MAXG][D] (the larger of the two)
  constexpr int BUF = NWARP * MAXG * D > MAXG * BLOCK_T ? NWARP * MAXG * D
                                                        : MAXG * BLOCK_T;
  __shared__ float buf[BUF];
  __shared__ float red[NWARP][MAXG];
  float(*sc)[BLOCK_T] = reinterpret_cast<float(*)[BLOCK_T]>(buf);

  const T *q = (const T *)q_, *kc = (const T *)k_, *vc = (const T *)v_;
  T *out = (T *)out_;
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), T_);

  float qf[MAXG][EL], acc[MAXG][EL], m[MAXG], l[MAXG];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) qf[g][e] = acc[g][e] = 0.f;
    if (g < G)
      load_row<T, EL>(q + ((size_t)b * Hq + (size_t)h * G + g) * D + lane * EL,
                      qf[g]);
  }
  const size_t base = (size_t)b * sb + (size_t)h * D + lane * EL;

  for (int t0 = 0; t0 < len; t0 += BLOCK_T) {
    const int n = min(BLOCK_T, len - t0);
    // pass 1: scores of this block's valid rows
    for (int i = warp * KU; i < n; i += NWARP * KU) {
      float kf[KU][EL];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (i + u < n)
          load_row<T, EL>(kc + base + (size_t)(t0 + i + u) * st, kf[u]);
        else
#pragma unroll
          for (int e = 0; e < EL; ++e) kf[u][e] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < KU; ++u)
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EL; ++e) s = fmaf(qf[g][e], kf[u][e], s);
          s = warp_sum(s);
          if (lane == 0 && i + u < n) sc[g][i + u] = s * scale;
        }
    }
    __syncthreads();
    // the block max of each query head
    float mx[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      mx[g] = NEG_INF;
      if (g < G)
        for (int i = tid; i < n; i += THREADS) mx[g] = fmaxf(mx[g], sc[g][i]);
      mx[g] = warp_max(mx[g]);
    }
    if (lane == 0)
#pragma unroll
      for (int g = 0; g < MAXG; ++g) red[warp][g] = mx[g];
    __syncthreads();
    float alpha[MAXG], m_new[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float bm = red[0][g];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) bm = fmaxf(bm, red[w][g]);
      m_new[g] = fmaxf(m[g], bm);
      alpha[g] = expf(m[g] - m_new[g]);
    }
    __syncthreads();                      // red is reused for the sums
    // pass 2: p = exp(s - m_new) in place, and its sum
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float ps = 0.f;
      if (g < G)
        for (int i = tid; i < n; i += THREADS) {
          float p = expf(sc[g][i] - m_new[g]);
          sc[g][i] = p;
          ps += p;
        }
      ps = warp_sum(ps);
      if (lane == 0) red[warp][g] = ps;
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      float ps = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) ps += red[w][g];
      l[g] = alpha[g] * l[g] + ps;
      m[g] = m_new[g];
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[g][e] *= alpha[g];
    }
    // pass 3: acc += bf16(p) * v over this warp's rows
    for (int i = warp * KU; i < n; i += NWARP * KU) {
      float vf[KU][EL];
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (i + u < n)
          load_row<T, EL>(vc + base + (size_t)(t0 + i + u) * st, vf[u]);
        else
#pragma unroll
          for (int e = 0; e < EL; ++e) vf[u][e] = 0.f;
      }
#pragma unroll
      for (int u = 0; u < KU; ++u) {
        if (i + u >= n) break;
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float p = rnd<T>(sc[g][i + u]);
#pragma unroll
          for (int e = 0; e < EL; ++e) acc[g][e] = fmaf(p, vf[u][e], acc[g][e]);
        }
      }
    }
    __syncthreads();                      // sc is rewritten by the next block
  }

  // sum the warps' accumulators, normalise, write
  float(*part)[MAXG][D] = reinterpret_cast<float(*)[MAXG][D]>(buf);
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
#pragma unroll
    for (int e = 0; e < EL; ++e) part[warp][g][lane * EL + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += THREADS) {
    const int g = i / D, d = i % D;
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NWARP; ++w) s += part[w][g][d];
    float lg = 0.f;
#pragma unroll
    for (int gg = 0; gg < MAXG; ++gg)
      if (gg == g) lg = l[gg];
    out[((size_t)b * Hq + (size_t)h * G + g) * D + d] =
        from_f<T>(s / fmaxf(lg, 1e-30f));
  }
}

}  // namespace dattn
}  // namespace pt

cudaError_t launch_decode_attention(int dtype, int B, int Hq, int Hkv, int D,
                                    int T, long long sb, long long st,
                                    float scale, const void *q,
                                    const void *k, const void *v,
                                    const int *lengths, void *out,
                                    cudaStream_t s) {
  using namespace pt::dattn;
  if (B <= 0 || Hq <= 0) return cudaSuccess;
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > MAXG) return cudaErrorInvalidValue;
  void (*kern)(const void *, const void *, const void *, const int *, void *,
               int, int, int, long long, long long, float) = nullptr;
  if (dtype == PT_F32 && D == 64) kern = decode_attention_kernel<float, 64>;
  if (dtype == PT_F32 && D == 128) kern = decode_attention_kernel<float, 128>;
  if (dtype == PT_BF16 && D == 64) kern = decode_attention_kernel<pt::bf16, 64>;
  if (dtype == PT_BF16 && D == 128)
    kern = decode_attention_kernel<pt::bf16, 128>;
  if (!kern) return cudaErrorInvalidValue;
  kern<<<dim3(Hkv, B), THREADS, 0, s>>>(q, k, v, lengths, out, Hq, Hkv, T, sb,
                                         st, scale);
  return count_launch(CNT_DECODE_ATTENTION, cudaGetLastError());
}

extern "C" int pt_decode_attention(int dtype, int B, int Hq, int Hkv, int D,
                                   int T, long long sb, long long st,
                                   float scale, const void *q, const void *k,
                                   const void *v, const int *lengths,
                                   void *out, void *stream) {
  return launch_decode_attention(dtype, B, Hq, Hkv, D, T, sb, st, scale, q, k,
                                 v, lengths, out, (cudaStream_t)stream);
}
