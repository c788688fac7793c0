// The incubate fused API's elementwise and row kernels: rope_fwd,
// softmax_mask_fwd, bias_act_fwd and dropout_add_fwd.
//
// Replace the TPU kernels
//   rope_fwd          paddle_tpu/ops/pallas/rope.py  _rope_kernel
//                     (pallas_call at :52, via fused_rope :85); its VJP is
//                     the same kernel with sign -1, and so is the port's
//   softmax_mask_fwd  paddle_tpu/ops/pallas/fused.py _softmax_mask_kernel
//                     (pallas_call at :101, via fused_softmax_mask :92)
//   bias_act_fwd      paddle_tpu/ops/pallas/fused.py _bias_act_kernel
//                     (pallas_call at :141, via fused_bias_act :131)
//   dropout_add_fwd   paddle_tpu/ops/pallas/fused.py _dropout_add_kernel
//                     (pallas_call at :179, via fused_dropout_add :166)
// with their arithmetic: inputs upcast to fp32, the function in fp32 and
// ONE rounding to x's dtype at the output.
//
// Layouts:
//   rope_fwd          x, out [B, S, H, D] contiguous (D even, any even D);
//                     cos, sin fp32 [S, D]; out = x*cos + rotate_half(x) *
//                     (sin*sign), rotate_half(x) = [-x[D/2:], x[:D/2]].  x is
//                     read in place with the token stride H*D (the JAX
//                     package transposes to [B*H, S, D] around its call).
//   softmax_mask_fwd  x, out [R, S] contiguous; the mask read through
//                     strides (SoftmaxArgs), broadcast without a copy.
//   bias_act_fwd      x, out [R, H] contiguous; bias fp32 [H].
//   dropout_add_fwd   x, y, out: n elements contiguous, one dtype.
//
// Dropout bits.  The TPU kernel seeds its PRNG with seed + program_id, so
// its bits depend on the block size and cannot be repeated off the TPU.
// Here element i takes word (i & 1) of Threefry-2x32 (20 rounds, as
// jax.random's) keyed by (seed mod 2^32, seed >> 32) at the counter
// (i >> 1 mod 2^32, i >> 33): only 32-bit adds, rotates and xors, which the
// plain version (paddle_tpu_torch/ops/threefry.py) repeats exactly in
// int64 torch ops, so kernel and plain version agree bit for bit.  x is
// kept where (bits >> 8) * 2^-24 >= p (the TPU kernel's 24-bit rule) and
// scaled by the fp32 `scale` (1 / (1 - p), rounded once by the wrapper);
// the product and the sum use __fmul_rn / __fadd_rn, never contracted into
// an FMA, so they round as the plain version's separate torch ops do.
//
// What bounds them on an H100: bytes.  Each reads its inputs once and
// writes its output once with a few flops per element (rope's cos / sin
// table and softmax's broadcast mask are small and stay in L2); at the
// main path's bf16 shapes (rope q [4, 2048, 32, 128], softmax
// [32, 12, 128, 128] with a [32, 1, 128, 128] fp32 mask, bias_act
// [4096, 3072], dropout_add [4096, 768]) that is 41 / 7.8 / 15 / 5.6 us at
// 3.35 TB/s.  Design:
//   * Elementwise passes (rope, bias_act, dropout_add) are grid-stride
//     loops over 16-byte chunks (8 bf16 or 4 fp32 values a thread) when
//     the widths and pointers allow it, else one value at a time with the
//     same arithmetic; the grid is capped at 16 blocks of 256 threads an
//     SM.  rope's chunk is VEC pairs (d, d + D/2), so both halves of a
//     row are vector loads.
//   * softmax_mask: on the TPU a VMEM block holds whole rows.  Here a row
//     of up to 1024 values stays in registers (softmax_mask_fwd_rows:
//     read once, max and sum of exp by shuffles, written once): LPR lanes
//     a row with NC 16-byte chunks each (8 lanes of 1 or 2 chunks, then
//     32 lanes of 1 to 8), so a warp takes 32 / LPR rows side by side,
//     and each lane group loads the raw chunks of up to 8 rows before the
//     first reduction.  The grid is the card's resident blocks (occupancy
//     API, once per device and instance), each warp walking work items.
//     Where the mask has a leading dim of stride 0 (the padding mask
//     broadcast over the heads), the rows that share a mask row are one
//     warp's item (or an even part of them, when they outnumber a pass):
//     its mask row is loaded once into registers.  Other masks (full,
//     strided, one value a row) load their own row beside x.  The
//     division is v * RN(1 / sum) with one correction, which gives the
//     IEEE quotient; masked values (exp 0) skip it.  A longer row, which
//     would outgrow the registers, takes softmax_mask_fwd_long: one warp
//     a row, three passes over device memory (max, sum of exp, write), so
//     any S >= 1 works.  The mask's leading-dim walk is unrolled, so its
//     strides stay in the parameter bank (a dynamic index spilled the
//     struct to local memory: 0.0746 ms at the main shape).  A row whose
//     mask is all -inf gives NaN, as in JAX.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace pt {
namespace fused {

constexpr int THREADS = 256;
enum { ACT_GELU = 0, ACT_RELU = 1, ACT_SILU = 2, ACT_TANH = 3,
       ACT_SIGMOID = 4 };

static int grid_cap() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return 16 * sms;
}

static int grid_for(long long work) {
  static const int cap = grid_cap();
  const long long blocks = (work + THREADS - 1) / THREADS;
  return (int)(blocks < cap ? (blocks > 0 ? blocks : 1) : cap);
}

static bool aligned16(const void *p) { return ((uintptr_t)p & 15) == 0; }

// VEC = 16 / sizeof(T) values of T at p (16-byte aligned) as fp32
template <typename T>
__device__ __forceinline__ void load16(const T *p, float *v) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 u = *reinterpret_cast<const uint4 *>(p);
  const T *t = reinterpret_cast<const T *>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) v[j] = to_f<T>(t[j]);
}

template <typename T>
__device__ __forceinline__ void store16(T *p, const float *v) {
  constexpr int VEC = 16 / sizeof(T);
  uint4 u;
  T *t = reinterpret_cast<T *>(&u);
#pragma unroll
  for (int j = 0; j < VEC; ++j) t[j] = from_f<T>(v[j]);
  *reinterpret_cast<uint4 *>(p) = u;
}

// N fp32 values at p (16-byte aligned, N a multiple of 4)
template <int N>
__device__ __forceinline__ void load_f32(const float *p, float *v) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    float4 f = *reinterpret_cast<const float4 *>(p + j);
    v[j] = f.x;
    v[j + 1] = f.y;
    v[j + 2] = f.z;
    v[j + 3] = f.w;
  }
}

// ------------------------------------------------------------------ rope
__device__ __forceinline__ void rope_pair(float x1, float x2, float c1,
                                          float c2, float s1, float s2,
                                          float sign, float *o1, float *o2) {
  // JAX: sin * sign first, then x * cos + rot * sin with rot = [-x2, x1]
  *o1 = x1 * c1 + (-x2) * (s1 * sign);
  *o2 = x2 * c2 + x1 * (s2 * sign);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rope_fwd_kernel(const T *__restrict__ x, const float *__restrict__ cosv,
                    const float *__restrict__ sinv, T *__restrict__ out,
                    long long rows, int S, int H, int D, float sign,
                    int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const int half = D / 2;
  const int per_row = vec_ok ? half / VEC : half;
  const long long n = rows * per_row;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long row = i / per_row;
    const int c = (int)(i - row * per_row);
    const long long s = (row / H) % S;
    const T *xr = x + row * D;
    T *orow = out + row * D;
    const float *cr = cosv + s * D, *sr = sinv + s * D;
    if (vec_ok) {
      const int d = c * VEC;
      float x1[VEC], x2[VEC], c1[VEC], c2[VEC], s1[VEC], s2[VEC];
      float o1[VEC], o2[VEC];
      load16<T>(xr + d, x1);
      load16<T>(xr + half + d, x2);
      load_f32<VEC>(cr + d, c1);
      load_f32<VEC>(cr + half + d, c2);
      load_f32<VEC>(sr + d, s1);
      load_f32<VEC>(sr + half + d, s2);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        rope_pair(x1[j], x2[j], c1[j], c2[j], s1[j], s2[j], sign, &o1[j],
                  &o2[j]);
      store16<T>(orow + d, o1);
      store16<T>(orow + half + d, o2);
    } else {
      float o1, o2;
      rope_pair(to_f<T>(xr[c]), to_f<T>(xr[half + c]), cr[c], cr[half + c],
                sr[c], sr[half + c], sign, &o1, &o2);
      orow[c] = from_f<T>(o1);
      orow[half + c] = from_f<T>(o2);
    }
  }
}

template <typename T>
static cudaError_t rope_launch(long long rows, int S, int H, int D,
                               float sign, const void *x, const float *cosv,
                               const float *sinv, void *out,
                               cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec_ok = (D / 2) % VEC == 0 && aligned16(x) && aligned16(out) &&
                     aligned16(cosv) && aligned16(sinv);
  const long long work = rows * (vec_ok ? D / 2 / VEC : D / 2);
  rope_fwd_kernel<T><<<grid_for(work), THREADS, 0, st>>>(
      static_cast<const T *>(x), cosv, sinv, static_cast<T *>(out), rows, S,
      H, D, sign, vec_ok);
  return cudaGetLastError();
}

// ------------------------------------------------------------ softmax
template <int LANES>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LANES / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T> struct Four;
template <> struct Four<float> { typedef uint4 type; };
template <> struct Four<bf16> { typedef uint2 type; };

// the 4 values e0 .. e0 + 3 of a row (those past S read as -inf): x + mask
// in fp32
template <typename T, typename M>
__device__ __forceinline__ void load_row4(const T *__restrict__ xr,
                                          const M *__restrict__ mr,
                                          long long mcol, int e0, int S,
                                          int xvec, int mvec, float *v) {
  float xv[4], mv[4];
  if (xvec && e0 + 4 <= S) {
    typename Four<T>::type u =
        *reinterpret_cast<const typename Four<T>::type *>(xr + e0);
    const T *t = reinterpret_cast<const T *>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) xv[j] = to_f<T>(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      xv[j] = e0 + j < S ? to_f<T>(xr[e0 + j]) : -INFINITY;
  }
  if (mvec && e0 + 4 <= S) {
    typename Four<M>::type u =
        *reinterpret_cast<const typename Four<M>::type *>(mr + e0);
    const M *t = reinterpret_cast<const M *>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) mv[j] = to_f<M>(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      mv[j] = e0 + j < S ? to_f<M>(mr[(e0 + j) * mcol]) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) v[j] = xv[j] + mv[j];
}


// the mask offset of row r: the loop is unrolled so that the argument
// struct's arrays are read with constant indices (a dynamic index would
// copy the struct to local memory); the host keeps R below 2^31, so the
// divisions are 32-bit
__device__ __forceinline__ long long mask_offset(const SoftmaxArgs &a,
                                                 unsigned r) {
  long long off = 0;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    if (i < a.nd) {
      const unsigned n = (unsigned)a.size[i];
      off += (long long)(r % n) * a.mstride[i];
      r /= n;
    }
  }
  return off;
}

// N values of T as one load / store (16-byte loads at most)
template <typename T, int N>
struct alignas(N * sizeof(T) < 16 ? N * sizeof(T) : 16) Vec {
  T v[N];
};

// How the rows are dealt out.  share > 1: the rows ((g / inner) share +
// h) inner + g % inner, h < share, of group g read one mask row (a leading
// dim of the mask with stride 0 and size share, inner rows apart); item i
// is rows [k per, (k + 1) per) of group i / parts, k = i % parts, one
// warp's.  share 1: item i is the BATCH rows from i BATCH.
struct SoftmaxPlan {
  unsigned items, inner;
  int share, parts, per, xvec, mvec;
};

// v / sum rounded to nearest, as the IEEE division gives it, with y =
// RN(1 / sum) taken once a row.  For 2^-90 <= v <= 1 <= sum, q = RN(v y) is
// within an ulp of v / sum and the residual v - sum q is exact in an FMA,
// so RN(q + (v - sum q) y) is the rounded quotient (Markstein's theorem).
// Smaller v take the division itself, except an exp that underflowed to 0
// (a masked value), which stays 0: the division's range check sends a
// zero dividend down its slow path, and a padding mask zeroes half a row.
// tools/rope_softmax_ab.py holds the kernel bit for bit against a build
// that divides every value, which takes 24.5 us at the BERT logits where
// this one takes 12.8 (NVIDIA H100 80GB HBM3, 700 W).
__device__ __forceinline__ float quot(float v, float sum, float y) {
  if (v >= 0x1p-90f) {
    const float q = __fmul_rn(v, y);
    return __fmaf_rn(__fmaf_rn(-sum, q, v), y, q);
  }
  return v == 0.f ? 0.f : v / sum;
}

// the 4 values e0 .. e0 + 3 of a row divided by its sum (y = RN(1 / sum))
template <typename T>
__device__ __forceinline__ void store_row4(T *__restrict__ orow, int e0,
                                           int S, int xvec, const float *v,
                                           float sum, float y) {
  if (xvec && e0 + 4 <= S) {
    typename Four<T>::type u;
    T *t = reinterpret_cast<T *>(&u);
#pragma unroll
    for (int j = 0; j < 4; ++j) t[j] = from_f<T>(quot(v[j], sum, y));
    *reinterpret_cast<typename Four<T>::type *>(orow + e0) = u;
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e0 + j < S) orow[e0 + j] = from_f<T>(quot(v[j], sum, y));
  }
}

// Rows a lane group holds at once, as raw 16-byte chunks: at most 32
// registers of x and, where each row reads its own mask row, its mask
// chunks; 8 rows at most.
template <typename T, typename M, int NC, bool SHARED>
__host__ __device__ constexpr int softmax_rows_u() {
  constexpr int regs =
      NC * (4 + (SHARED ? 0 : 16 / (int)sizeof(T) * (int)sizeof(M) / 4));
  return 32 / regs > 8 ? 8 : (32 / regs < 1 ? 1 : 32 / regs);
}

// the V values of x at e0 of row xr (-inf past S or in a dead row)
template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load_x(const T *__restrict__ xr, int e0,
                                            int S, int xvec, bool live) {
  Vec<T, V> u;
  if (xvec && live && e0 < S) return *reinterpret_cast<const Vec<T, V> *>(
      xr + e0);
#pragma unroll
  for (int j = 0; j < V; ++j)
    u.v[j] = !xvec && live && e0 + j < S ? xr[e0 + j] : from_f<T>(-INFINITY);
  return u;
}

// the V mask values at e0 of mask row mr (0 past S or in a dead row)
template <typename M, int V>
__device__ __forceinline__ Vec<M, V> load_m(const M *__restrict__ mr,
                                            long long mcol, int e0, int S,
                                            int mvec, bool live) {
  Vec<M, V> u;
  if (mvec && live && e0 < S) return *reinterpret_cast<const Vec<M, V> *>(
      mr + e0);
#pragma unroll
  for (int j = 0; j < V; ++j)
    u.v[j] = !mvec && live && e0 + j < S ? mr[(e0 + j) * mcol]
                                         : from_f<M>(0.f);
  return u;
}

// Rows of up to LPR * NC * V values (V = 16 / sizeof(T)), LPR lanes a row,
// 32 / LPR rows a warp side by side, each lane NC chunks of V values of a
// row (one 16-byte x load a chunk).  A persistent grid: each warp walks
// items.  SHARED (the mask has a broadcast leading dim): an item is the
// rows that read one mask row, or an even part of them, and the mask row
// is loaded once into registers; else an item is BATCH rows, each with its
// own mask row.  A pass loads the raw x (and own mask) chunks of U rows a
// lane group, all before any reduction, then reduces row by row.
// Out-of-row values read as x -inf, mask 0: they leave the max alone and
// add exp(-inf) = 0 to the sum (an all -inf row is NaN either way).
template <typename T, typename M, int LPR, int NC, bool SHARED>
__global__ void __launch_bounds__(THREADS)
    softmax_mask_fwd_rows(SoftmaxArgs a, SoftmaxPlan p) {
  constexpr int V = 16 / sizeof(T), RPW = 32 / LPR;
  constexpr int U = softmax_rows_u<T, M, NC, SHARED>(), BATCH = RPW * U;
  typedef Vec<T, V> XV;
  typedef Vec<M, V> MV;
  const int lane = threadIdx.x & 31, grp = lane / LPR, t = lane % LPR;
  const int S = a.S;
  const T *__restrict__ X = static_cast<const T *>(a.x);
  const M *__restrict__ MK = static_cast<const M *>(a.mask);
  T *__restrict__ O = static_cast<T *>(a.out);
  const unsigned nw = gridDim.x * (THREADS / 32);
  for (unsigned it = blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
       it < p.items; it += nw) {
    const unsigned g = it / p.parts;
    const long long base =
        SHARED ? (long long)(g / p.inner) * p.share * p.inner + g % p.inner
               : (long long)it * BATCH;
    const long long step = SHARED ? p.inner : 1;
    const int first = SHARED ? (int)(it % p.parts) * p.per : 0;
    const int end = SHARED ? min(p.share, first + p.per) : BATCH;
    MV mk[NC];
    if (SHARED) {
      const M *mr = MK + mask_offset(a, (unsigned)base);
#pragma unroll
      for (int c = 0; c < NC; ++c)
        mk[c] = load_m<M, V>(mr, a.mcol, (t + LPR * c) * V, S, p.mvec, true);
    }
    for (int h0 = first; h0 < end; h0 += BATCH) {
      XV xr[U][NC];
      MV mo[SHARED ? 1 : U][NC];
      bool live[U];
      long long row[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int h = h0 + u * RPW + grp;
        row[u] = base + h * step;
        live[u] = h < end && row[u] < a.R;
        const T *xrow = X + row[u] * S;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          xr[u][c] = load_x<T, V>(xrow, (t + LPR * c) * V, S, p.xvec,
                                  live[u]);
        if (!SHARED) {
          const M *mr = MK + mask_offset(a, (unsigned)row[u]);
#pragma unroll
          for (int c = 0; c < NC; ++c)
            mo[SHARED ? 0 : u][c] = load_m<M, V>(mr, a.mcol,
                                                 (t + LPR * c) * V, S,
                                                 p.mvec, live[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // rows all past the item (warp-uniform) compute nothing
        if (h0 + u * RPW >= end) continue;
        float v[NC][V], mx = -INFINITY, sum = 0.f;
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < V; ++j) {
            v[c][j] = to_f<T>(xr[u][c].v[j]) +
                      to_f<M>((SHARED ? mk[c] : mo[SHARED ? 0 : u][c]).v[j]);
            mx = fmaxf(mx, v[c][j]);
          }
        mx = group_max<LPR>(mx);
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int j = 0; j < V; ++j) {
            v[c][j] = expf(v[c][j] - mx);
            sum += v[c][j];
          }
        sum = group_sum<LPR>(sum);
        if (!live[u]) continue;
        const float y = __frcp_rn(sum);
        T *orow = O + row[u] * S;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int e0 = (t + LPR * c) * V;
          if (p.xvec) {
            if (e0 < S) {
              XV o;
#pragma unroll
              for (int j = 0; j < V; ++j)
                o.v[j] = from_f<T>(quot(v[c][j], sum, y));
              *reinterpret_cast<XV *>(orow + e0) = o;
            }
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (e0 + j < S)
                orow[e0 + j] = from_f<T>(quot(v[c][j], sum, y));
          }
        }
      }
    }
  }
}

// Rows longer than 1024 values: one warp a row, in three passes over
// device memory (max, sum of exp, write), each a loop over the row.
template <typename T, typename M>
__global__ void __launch_bounds__(THREADS)
    softmax_mask_fwd_long(SoftmaxArgs a, int xvec, int mvec) {
  constexpr int ROWS = THREADS / 32;
  const long long row = (long long)blockIdx.x * ROWS + (threadIdx.x >> 5);
  if (row >= a.R) return;
  const int lane = threadIdx.x & 31, S = a.S;
  const T *xr = static_cast<const T *>(a.x) + row * S;
  const M *mr = static_cast<const M *>(a.mask) + mask_offset(a, (unsigned)row);
  T *orow = static_cast<T *>(a.out) + row * S;
  float mx = -INFINITY, sum = 0.f;
  float v[4];
  for (int e0 = lane * 4; e0 < S; e0 += 128) {
    load_row4<T, M>(xr, mr, a.mcol, e0, S, xvec, mvec, v);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e0 + j < S) mx = fmaxf(mx, v[j]);
  }
  mx = group_max<32>(mx);
  for (int e0 = lane * 4; e0 < S; e0 += 128) {
    load_row4<T, M>(xr, mr, a.mcol, e0, S, xvec, mvec, v);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (e0 + j < S) sum += expf(v[j] - mx);
  }
  sum = warp_sum(sum);
  const float y = __frcp_rn(sum);
  for (int e0 = lane * 4; e0 < S; e0 += 128) {
    load_row4<T, M>(xr, mr, a.mcol, e0, S, xvec, mvec, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = expf(v[j] - mx);
    store_row4<T>(orow, e0, S, xvec, v, sum, y);
  }
}

// blocks of a softmax_mask_fwd_rows instance the card keeps resident, per
// (x, mask dtypes, row shape, device) (a table of this file's own: a
// function-local static of a template would be one object across every
// loaded copy of the library)
constexpr int SM_SHAPES = 6, MAX_DEVICES = 64;
static int g_softmax_resident[4][SM_SHAPES][2][MAX_DEVICES];

template <typename T, typename M, int LPR, int NC, bool SHARED>
static cudaError_t softmax_rows_launch(const SoftmaxArgs *a, SoftmaxPlan p,
                                       int *resident, cudaStream_t st) {
  constexpr int WPB = THREADS / 32;
  constexpr int BATCH = 32 / LPR * softmax_rows_u<T, M, NC, SHARED>();
  void (*kern)(SoftmaxArgs, SoftmaxPlan) =
      softmax_mask_fwd_rows<T, M, LPR, NC, SHARED>;
  int cap = resident ? *resident : 0;
  if (cap == 0) {
    int dev = 0, per = 0, sms = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, THREADS,
                                                        0);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cap = (per > 0 ? per : 1) * sms;
    if (resident) *resident = cap;
  }
  if (SHARED) {
    // the fewest items of one pass: a group's rows over parts warps
    p.parts = (p.share + BATCH - 1) / BATCH;
    p.per = (p.share + p.parts - 1) / p.parts;
    p.parts = (p.share + p.per - 1) / p.per;
    p.items = (unsigned)(a->R / p.share) * p.parts;
  } else {
    p.items = (unsigned)((a->R + BATCH - 1) / BATCH);
  }
  const unsigned want = (p.items + WPB - 1) / WPB;
  kern<<<want < (unsigned)cap ? want : (unsigned)cap, THREADS, 0, st>>>(*a,
                                                                        p);
  return cudaGetLastError();
}

// the instance for row shape k: 1..8 chunks a row on 8 lanes of one chunk,
// 9..16 on 8 lanes of two, then 32 lanes of 1, 2, 4, 8 chunks each (at 16
// chunks, the BERT logits' rows, 8 lanes of two took 12.8-13.0 us, 16
// lanes of one 13.7 at best, 4 lanes of four 21.4: tools/rope_softmax_ab.py
// on an NVIDIA H100 80GB HBM3 at 700 W)
template <typename T, typename M, bool SHARED>
static cudaError_t softmax_rows_shape(const SoftmaxArgs *a, SoftmaxPlan p,
                                      int k, int *res, cudaStream_t st) {
  switch (k) {
    case 0: return softmax_rows_launch<T, M, 8, 1, SHARED>(a, p, res, st);
    case 1: return softmax_rows_launch<T, M, 8, 2, SHARED>(a, p, res, st);
    case 2: return softmax_rows_launch<T, M, 32, 1, SHARED>(a, p, res, st);
    case 3: return softmax_rows_launch<T, M, 32, 2, SHARED>(a, p, res, st);
    case 4: return softmax_rows_launch<T, M, 32, 4, SHARED>(a, p, res, st);
  }
  if constexpr (sizeof(T) == 4)                  // fp32 rows of 513..1024
    return softmax_rows_launch<T, M, 32, 8, SHARED>(a, p, res, st);
  return cudaErrorInvalidValue;
}

template <typename T, typename M>
static cudaError_t softmax_launch(const SoftmaxArgs *a, int which,
                                  cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const int S = a->S;
  SoftmaxPlan p{0, 1, 1, 1, 1, 0, 0};
  if (S > 1024) {
    const int xvec =
        S % 4 == 0 && ((uintptr_t)a->x % (4 * sizeof(T))) == 0;
    int mvec = a->mcol == 1 && ((uintptr_t)a->mask % (4 * sizeof(M))) == 0;
    for (int i = 0; i < a->nd; ++i) mvec = mvec && a->mstride[i] % 4 == 0;
    constexpr int ROWS = THREADS / 32;
    softmax_mask_fwd_long<T, M>
        <<<(unsigned)((a->R + ROWS - 1) / ROWS), THREADS, 0, st>>>(*a, xvec,
                                                                  mvec);
    return cudaGetLastError();
  }
  // the rows that share a mask row: the broadcast (stride-0) leading dim
  // with the most rows
  for (int i = 0; i < a->nd; ++i)
    if (a->mstride[i] == 0 && a->size[i] > p.share) {
      p.share = (int)a->size[i];
      p.inner = 1;
      for (int j = i + 1; j < a->nd; ++j) p.inner *= (unsigned)a->size[j];
    }
  p.xvec = S % V == 0 && ((uintptr_t)a->x & 15) == 0 &&
           ((uintptr_t)a->out & 15) == 0;
  const unsigned malign = V * sizeof(M) < 16 ? V * sizeof(M) : 16;
  p.mvec = S % V == 0 && a->mcol == 1 && (uintptr_t)a->mask % malign == 0;
  for (int i = 0; i < a->nd; ++i) p.mvec = p.mvec && a->mstride[i] % V == 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const int n = (S + V - 1) / V;                 // chunks of V values a row
  const int k = n <= 8 ? 0 : n <= 16 ? 1 : n <= 32 ? 2 : n <= 64 ? 3
              : n <= 128 ? 4 : 5;
  const bool shared = p.share > 1;
  int *res = dev < MAX_DEVICES ? &g_softmax_resident[which][k][shared][dev]
                               : nullptr;
  if (shared) return softmax_rows_shape<T, M, true>(a, p, k, res, st);
  return softmax_rows_shape<T, M, false>(a, p, k, res, st);
}

static cudaError_t softmax_mask(const SoftmaxArgs *a, cudaStream_t st) {
  if (!a || a->R <= 0 || a->R >= (1LL << 31) || a->S <= 0 || a->nd < 0 ||
      a->nd > 4 || !a->x || !a->mask || !a->out ||
      (a->mcol != 0 && a->mcol != 1))
    return cudaErrorInvalidValue;
  for (int i = 0; i < a->nd; ++i)
    if (a->size[i] <= 0 || a->size[i] >= (1LL << 31))
      return cudaErrorInvalidValue;
  const int d = a->dtype, m = a->mask_dtype;
  if (d == PT_BF16 && m == PT_F32) return softmax_launch<bf16, float>(a, 0, st);
  if (d == PT_BF16 && m == PT_BF16) return softmax_launch<bf16, bf16>(a, 1, st);
  if (d == PT_F32 && m == PT_F32) return softmax_launch<float, float>(a, 2, st);
  if (d == PT_F32 && m == PT_BF16) return softmax_launch<float, bf16>(a, 3, st);
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ bias_act
template <int ACT>
__device__ __forceinline__ float act_f(float v) {
  if (ACT == ACT_GELU) {
    // jax.nn.gelu(approximate=True)
    const float k = 0.7978845608028654f;  // sqrt(2 / pi)
    return v * (0.5f * (1.0f + tanhf(k * (v + 0.044715f * (v * v * v)))));
  }
  if (ACT == ACT_RELU) return v > 0.f ? v : 0.f;
  if (ACT == ACT_SILU) return v * (1.0f / (1.0f + expf(-v)));
  if (ACT == ACT_TANH) return tanhf(v);
  return 1.0f / (1.0f + expf(-v));      // ACT_SIGMOID
}

template <typename T, int ACT>
__global__ void __launch_bounds__(THREADS)
    bias_act_fwd_kernel(const T *__restrict__ x,
                        const float *__restrict__ bias, T *__restrict__ out,
                        long long R, int H, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const long long n = R * H;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (vec_ok) {
    for (long long i = tid; i < n / VEC; i += stride) {
      const long long e0 = i * VEC;
      const int col = (int)(e0 % H);
      float v[VEC], b[VEC];
      load16<T>(x + e0, v);
      load_f32<VEC>(bias + col, b);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = act_f<ACT>(v[j] + b[j]);
      store16<T>(out + e0, v);
    }
  } else {
    for (long long i = tid; i < n; i += stride)
      out[i] = from_f<T>(act_f<ACT>(to_f<T>(x[i]) + bias[i % H]));
  }
}

template <typename T, int ACT>
static cudaError_t bias_act_t(long long R, int H, const void *x,
                              const float *bias, void *out, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec_ok =
      H % VEC == 0 && aligned16(x) && aligned16(out) && aligned16(bias);
  bias_act_fwd_kernel<T, ACT>
      <<<grid_for(vec_ok ? R * H / VEC : R * H), THREADS, 0, st>>>(
          static_cast<const T *>(x), bias, static_cast<T *>(out), R, H,
          vec_ok);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t bias_act_d(int act, long long R, int H, const void *x,
                              const float *bias, void *out, cudaStream_t st) {
  switch (act) {
    case ACT_GELU: return bias_act_t<T, ACT_GELU>(R, H, x, bias, out, st);
    case ACT_RELU: return bias_act_t<T, ACT_RELU>(R, H, x, bias, out, st);
    case ACT_SILU: return bias_act_t<T, ACT_SILU>(R, H, x, bias, out, st);
    case ACT_TANH: return bias_act_t<T, ACT_TANH>(R, H, x, bias, out, st);
    case ACT_SIGMOID:
      return bias_act_t<T, ACT_SIGMOID>(R, H, x, bias, out, st);
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------ dropout_add
__device__ __forceinline__ uint32_t rotl32(uint32_t v, int r) {
  return (v << r) | (v >> (32 - r));
}

// Threefry-2x32, 20 rounds (Salmon et al. 2011; jax.random's threefry2x32)
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t *o0, uint32_t *o1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
#define PT_TF_ROUND(r) \
  x0 += x1;            \
  x1 = rotl32(x1, r);  \
  x1 ^= x0;
#define PT_TF_A PT_TF_ROUND(13) PT_TF_ROUND(15) PT_TF_ROUND(26) PT_TF_ROUND(6)
#define PT_TF_B PT_TF_ROUND(17) PT_TF_ROUND(29) PT_TF_ROUND(16) PT_TF_ROUND(24)
  PT_TF_A x0 += k1; x1 += k2 + 1u;
  PT_TF_B x0 += k2; x1 += k0 + 2u;
  PT_TF_A x0 += k0; x1 += k1 + 3u;
  PT_TF_B x0 += k1; x1 += k2 + 4u;
  PT_TF_A x0 += k2; x1 += k0 + 5u;
#undef PT_TF_A
#undef PT_TF_B
#undef PT_TF_ROUND
  *o0 = x0;
  *o1 = x1;
}

// the random words of elements 2c and 2c + 1
__device__ __forceinline__ void pair_bits(uint32_t k0, uint32_t k1,
                                          unsigned long long c, uint32_t *b0,
                                          uint32_t *b1) {
  threefry2x32(k0, k1, (uint32_t)c, (uint32_t)(c >> 32), b0, b1);
}

__device__ __forceinline__ float drop_add(float xv, float yv, uint32_t bits,
                                          int drop, float p, float scale) {
  if (!drop) return __fadd_rn(xv, yv);
  const float u = (float)(bits >> 8) * (1.0f / 16777216.0f);
  return __fadd_rn(u >= p ? __fmul_rn(xv, scale) : 0.f, yv);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    dropout_add_fwd_kernel(const T *__restrict__ x, const T *__restrict__ y,
                           T *__restrict__ out, long long n, int drop,
                           float p, float scale,
                           const long long *__restrict__ seed, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned long long sd = drop ? (unsigned long long)seed[0] : 0ull;
  const uint32_t k0 = (uint32_t)sd, k1 = (uint32_t)(sd >> 32);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vec_ok ? n / VEC : 0;
  for (long long i = tid; i < nvec; i += stride) {
    const long long e0 = i * VEC;
    float xv[VEC], yv[VEC];
    load16<T>(x + e0, xv);
    load16<T>(y + e0, yv);
#pragma unroll
    for (int j = 0; j < VEC; j += 2) {
      uint32_t b0 = 0, b1 = 0;
      if (drop) pair_bits(k0, k1, (unsigned long long)(e0 + j) >> 1, &b0, &b1);
      xv[j] = drop_add(xv[j], yv[j], b0, drop, p, scale);
      xv[j + 1] = drop_add(xv[j + 1], yv[j + 1], b1, drop, p, scale);
    }
    store16<T>(out + e0, xv);
  }
  for (long long i = nvec * VEC + tid; i < n; i += stride) {
    uint32_t b0 = 0, b1 = 0;
    if (drop) pair_bits(k0, k1, (unsigned long long)i >> 1, &b0, &b1);
    out[i] = from_f<T>(drop_add(to_f<T>(x[i]), to_f<T>(y[i]),
                                (i & 1) ? b1 : b0, drop, p, scale));
  }
}

template <typename T>
static cudaError_t dropout_add_t(long long n, int drop, float p, float scale,
                                 const long long *seed, const void *x,
                                 const void *y, void *out, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec_ok = aligned16(x) && aligned16(y) && aligned16(out);
  dropout_add_fwd_kernel<T>
      <<<grid_for(vec_ok ? (n + VEC - 1) / VEC : n), THREADS, 0, st>>>(
          static_cast<const T *>(x), static_cast<const T *>(y),
          static_cast<T *>(out), n, drop, p, scale, seed, vec_ok);
  return cudaGetLastError();
}

}  // namespace fused
}  // namespace pt

extern "C" {

// One rotation of x [rows = B*S*H, D] (token-major [B, S, H, D]) by the
// fp32 [S, D] tables; sign +1 forward, -1 for the VJP.
int pt_rope_fwd(int dtype, long long rows, int S, int H, int D, float sign,
                const void *x, const float *cosv, const float *sinv,
                void *out, void *stream) {
  using namespace pt::fused;
  cudaError_t e = cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (rows > 0 && S > 0 && H > 0 && D > 0 && D % 2 == 0 && x && cosv &&
      sinv && out && rows % ((long long)S * H) == 0) {
    if (dtype == PT_BF16)
      e = rope_launch<pt::bf16>(rows, S, H, D, sign, x, cosv, sinv, out, st);
    else if (dtype == PT_F32)
      e = rope_launch<float>(rows, S, H, D, sign, x, cosv, sinv, out, st);
  }
  return count_launch(CNT_ROPE_FWD, e);
}

int pt_softmax_mask_fwd(const SoftmaxArgs *a, void *stream) {
  return count_launch(CNT_SOFTMAX_MASK_FWD,
                      pt::fused::softmax_mask(a, (cudaStream_t)stream));
}

// act: 0 tanh-GELU, 1 relu, 2 silu, 3 tanh, 4 sigmoid.
int pt_bias_act_fwd(int dtype, int act, long long R, int H, const void *x,
                    const float *bias, void *out, void *stream) {
  using namespace pt::fused;
  cudaError_t e = cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (R > 0 && H > 0 && x && bias && out) {
    if (dtype == PT_BF16)
      e = bias_act_d<pt::bf16>(act, R, H, x, bias, out, st);
    else if (dtype == PT_F32)
      e = bias_act_d<float>(act, R, H, x, bias, out, st);
  }
  return count_launch(CNT_BIAS_ACT_FWD, e);
}

// drop 0: out = x + y; drop 1: the Threefry keep mask of *seed (a device
// scalar) at rate p, kept values times scale.
int pt_dropout_add_fwd(int dtype, long long n, int drop, float p, float scale,
                       const long long *seed, const void *x, const void *y,
                       void *out, void *stream) {
  using namespace pt::fused;
  cudaError_t e = cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (n > 0 && x && y && out && (!drop || seed)) {
    if (dtype == PT_BF16)
      e = dropout_add_t<pt::bf16>(n, drop, p, scale, seed, x, y, out, st);
    else if (dtype == PT_F32)
      e = dropout_add_t<float>(n, drop, p, scale, seed, x, y, out, st);
  }
  return count_launch(CNT_DROPOUT_ADD_FWD, e);
}

}  // extern "C"
