// The logits-free linear + softmax cross-entropy head ("linear-CE") for
// training: the forward (per-row nll and lse of softmax(x @ w^T), never
// storing the [T, V] logits) and the recompute backward (dx, dw).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/linear_ce.py:
//   linear_ce_fwd                  _fwd_kernel  (pallas_call at :152)
//   linear_ce_dz + linear_ce_dx    _dx_kernel   (pallas_call at :253)
//   linear_ce_dz + linear_ce_dw    _dw_kernel   (pallas_call at :270)
// with their arithmetic: fp32 logits z = x w^T from the inputs' own dtypes,
// columns >= V masked, online max / sum-exp / label logit / smoothing sum
// per row, lse = m + log(s), nll = lse - zl (with label smoothing eps:
// lse - (1 - eps) zl - eps / V * sum z), 0 at ignore_index; backward
// dz = g (exp(z - lse) - y) in fp32 with y the (smoothed) one-hot target,
// rounded to w's dtype before dz @ w (dx) and to x's dtype before dz^T @ x
// (dw), fp32 accumulation, dx in x's dtype and dw in w's.
//
// What bounds them on an H100: the products.  At the Llama training shape
// (T 8192 tokens, H 4096, V 32000, bf16) each product 2 T H V is
// 2.15 TFLOP, 2.17 ms at 989 TFLOP/s, against 0.1-0.3 ms to move the
// bytes.  With fp32 x (the GPT step: its final LayerNorm has fp32 gains)
// z and dw run on fp32 operands at 67 TFLOP/s.
//
// Design, in this first version (wgmma and TMA are later work):
//   * The TPU forward walks the vocab chunks of a row block in grid order
//     and carries the row statistics in VMEM scratch.  Here one block of
//     8 warps owns 64 rows and walks the vocab in 128-column tiles itself;
//     the statistics stay in registers (4 threads per row).
//   * The TPU backward keeps a [rows, H] fp32 dx accumulator (1 MB at
//     H 4096) and a [chunk, H] dw accumulator (8 MB at chunk 512) in VMEM,
//     far over the 227 KB of shared memory a block has.  Here the backward
//     sweeps the vocab in slabs of C columns (the op's chunk):
//     linear_ce_dz recomputes z for all T rows of the slab and writes dz
//     to a [T, C] scratch in w's dtype (and in x's where the two differ);
//     linear_ce_dx adds dz @ w_slab into an fp32 [T, H] accumulator (the
//     slabs run in order, so the sum is deterministic; the last slab
//     writes dx); linear_ce_dw writes dw_slab = dz^T @ x.  z is recomputed
//     once per backward, not once for dx and once for dw.  Rows past T and
//     vocab rows past V load as zero, so they add exact zeros.
//   * One tiled product (Mma below) serves all four: 8 warps, 32-deep K
//     slabs staged in shared memory, the next slab prefetched into
//     registers; bf16 x bf16 on tensor cores (nvcuda::wmma 16x16x16, fp32
//     accumulate), any fp32 operand on FMA with bf16 operands converted to
//     fp32 on their way into shared memory.
// The wrapper checks H % 8 == 0 and 16-byte aligned, contiguous operands;
// the dz scratch has a leading dimension ldz rounded up to 8 with zeros in
// its padding columns, so every 16-byte load is either wholly in bounds or
// wholly out.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace pt {
namespace lce {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;               // 8 warps
constexpr int BK = 32;                     // K slab
constexpr int FWD_BM = 64, FWD_BN = 128;   // forward: rows, vocab tile
constexpr int BW_BM = 128, BW_BN = 128;    // backward product tiles

template <typename T>
constexpr bool is_bf16() {
  return std::is_same<T, bf16>::value;
}

__device__ __forceinline__ uint4 load16(const void *src, bool ok) {
  return ok ? *reinterpret_cast<const uint4 *>(src) : make_uint4(0, 0, 0, 0);
}

// 16 bytes of TG values into shared memory of element type S (TG == S, or
// eight bf16 values widened to fp32)
template <typename TG, typename S>
__device__ __forceinline__ void store16(S *dst, uint4 v) {
  if constexpr (std::is_same<TG, S>::value) {
    *reinterpret_cast<uint4 *>(dst) = v;
  } else {
    const bf16 *h = reinterpret_cast<const bf16 *>(&v);
    float4 *d = reinterpret_cast<float4 *>(dst);
    d[0] = make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                       __bfloat162float(h[2]), __bfloat162float(h[3]));
    d[1] = make_float4(__bfloat162float(h[4]), __bfloat162float(h[5]),
                       __bfloat162float(h[6]), __bfloat162float(h[7]));
  }
}

// One block's output tile C[BM x BN] = sum_k A(m, k) B(k, n), written fp32
// to shared memory Cs (leading dimension LDC).  A(m, k) is A[m * lda + k]
// (A_ROW) or A[k * lda + m]; B(k, n) is B[k * ldb + n] (B_ROW) or
// B[n * ldb + k].  Elements with m >= Mv or k >= Ka (A), k >= Kb or n >= Nv
// (B) read as zero; the bound along each operand's contiguous dimension
// must be a multiple of its 16-byte vector.
template <typename TA, typename TB, bool A_ROW, bool B_ROW, int BM, int BN>
struct Mma {
  static constexpr bool TC = is_bf16<TA>() && is_bf16<TB>();
  using S = typename std::conditional<TC, bf16, float>::type;
  static constexpr int VA = 16 / (int)sizeof(TA), VB = 16 / (int)sizeof(TB);
  static constexpr int PAD = 16 / (int)sizeof(S);
  static constexpr int LDA = A_ROW ? BK + PAD : BM + PAD;
  static constexpr int LDB = B_ROW ? BN + PAD : BK + PAD;
  static constexpr int A_ELEMS = (A_ROW ? BM : BK) * LDA;
  static constexpr int B_ELEMS = (B_ROW ? BK : BN) * LDB;
  static constexpr int LDC = BN + 4;
  static constexpr int AB_BYTES = (A_ELEMS + B_ELEMS) * (int)sizeof(S);
  static constexpr int SMEM_BYTES = AB_BYTES + BM * LDC * 4;
  static constexpr int NA = BM * BK / VA / THREADS;   // vectors per thread
  static constexpr int NB = BN * BK / VB / THREADS;
  static_assert(NA * VA * THREADS == BM * BK, "A tile vs threads");
  static_assert(NB * VB * THREADS == BN * BK, "B tile vs threads");
  // tensor cores: 2 x 4 warps, each WTM x WTN of 16 x 16 fragments
  static constexpr int WTM = BM / 2, WTN = BN / 4;
  static constexpr int FM = WTM / 16, FN = WTN / 16;
  // FMA: 16 x 16 threads, each TM x TN outputs strided by 16
  static constexpr int TM = BM / 16, TN = BN / 16;

  // position (row, k) in the tile of A's vector q; likewise (n, k) for B
  __device__ static void a_pos(int q, int &m, int &k) {
    if (A_ROW) {
      m = q / (BK / VA);
      k = (q % (BK / VA)) * VA;
    } else {
      k = q / (BM / VA);
      m = (q % (BM / VA)) * VA;
    }
  }
  __device__ static void b_pos(int q, int &n, int &k) {
    if (B_ROW) {
      k = q / (BN / VB);
      n = (q % (BN / VB)) * VB;
    } else {
      n = q / (BK / VB);
      k = (q % (BK / VB)) * VB;
    }
  }

  __device__ static void run(float *Cs, S *As, S *Bs, const TA *A, size_t lda,
                             int Mv, int Ka, const TB *B, size_t ldb, int Nv,
                             int Kb, int m0, int n0) {
    const int tid = threadIdx.x;
    const int K = Ka > Kb ? Ka : Kb;
    uint4 ra[NA], rb[NB];
    auto load = [&](int k0) {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        int m, k;
        a_pos(tid + i * THREADS, m, k);
        const int gm = m0 + m, gk = k0 + k;
        ra[i] = load16(A + (A_ROW ? (size_t)gm * lda + gk
                                  : (size_t)gk * lda + gm),
                       gm < Mv && gk < Ka);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        int n, k;
        b_pos(tid + i * THREADS, n, k);
        const int gn = n0 + n, gk = k0 + k;
        rb[i] = load16(B + (B_ROW ? (size_t)gk * ldb + gn
                                  : (size_t)gn * ldb + gk),
                       gn < Nv && gk < Kb);
      }
    };
    auto store = [&]() {
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        int m, k;
        a_pos(tid + i * THREADS, m, k);
        store16<TA, S>(As + (A_ROW ? m * LDA + k : k * LDA + m), ra[i]);
      }
#pragma unroll
      for (int i = 0; i < NB; ++i) {
        int n, k;
        b_pos(tid + i * THREADS, n, k);
        store16<TB, S>(Bs + (B_ROW ? k * LDB + n : n * LDB + k), rb[i]);
      }
    };

    if constexpr (TC) {
      using LA = typename std::conditional<A_ROW, wmma::row_major,
                                           wmma::col_major>::type;
      using LB = typename std::conditional<B_ROW, wmma::row_major,
                                           wmma::col_major>::type;
      const int warp = tid >> 5, wm = warp >> 2, wn = warp & 3;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      load(0);
      for (int k0 = 0; k0 < K; k0 += BK) {
        store();
        __syncthreads();
        if (k0 + BK < K) load(k0 + BK);
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> fa[FM];
#pragma unroll
          for (int i = 0; i < FM; ++i) {
            const int mm = wm * WTM + i * 16;
            wmma::load_matrix_sync(
                fa[i], A_ROW ? As + mm * LDA + kk : As + kk * LDA + mm, LDA);
          }
#pragma unroll
          for (int j = 0; j < FN; ++j) {
            const int nn = wn * WTN + j * 16;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
            wmma::load_matrix_sync(
                fb, B_ROW ? Bs + kk * LDB + nn : Bs + nn * LDB + kk, LDB);
#pragma unroll
            for (int i = 0; i < FM; ++i)
              wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::store_matrix_sync(
              Cs + (wm * WTM + i * 16) * LDC + wn * WTN + j * 16, acc[i][j],
              LDC, wmma::mem_row_major);
    } else {
      const int tx = tid & 15, ty = tid >> 4;
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
      load(0);
      for (int k0 = 0; k0 < K; k0 += BK) {
        store();
        __syncthreads();
        if (k0 + BK < K) load(k0 + BK);
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          float av[TM], bv[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int m = ty + 16 * i;
            av[i] = A_ROW ? As[m * LDA + kk] : As[kk * LDA + m];
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) {
            const int n = tx + 16 * j;
            bv[j] = B_ROW ? Bs[kk * LDB + n] : Bs[n * LDB + kk];
          }
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j)
          Cs[(ty + 16 * i) * LDC + tx + 16 * j] = acc[i][j];
    }
  }
};

template <typename M>
struct Smem {
  using S = typename M::S;
  S *As, *Bs;
  float *Cs;
  __device__ explicit Smem(unsigned char *base)
      : As((S *)base), Bs((S *)base + M::A_ELEMS),
        Cs((float *)(base + M::AB_BYTES)) {}
};

// ------------------------------------------------------------- forward
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS) linear_ce_fwd(LceArgs a) {
  using M = Mma<TX, TW, true, false, FWD_BM, FWD_BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<M> sm(smem);
  const int tid = threadIdx.x, r = tid >> 2, part = tid & 3;
  const int m0 = blockIdx.x * FWD_BM, t = m0 + r;
  const int lab = t < a.T ? a.labels[t] : -1;
  const float *row = sm.Cs + r * M::LDC;
  float m = NEG_INF, s = 0.f, zl = 0.f, sz = 0.f;
  for (int v0 = 0; v0 < a.V; v0 += FWD_BN) {
    M::run(sm.Cs, sm.As, sm.Bs, (const TX *)a.x, a.H, a.T, a.H,
           (const TW *)a.w, a.H, a.V, a.H, m0, v0);
    __syncthreads();
    const int nv = min(FWD_BN, a.V - v0);
    float mloc = NEG_INF;
    for (int c = part; c < nv; c += 4) mloc = fmaxf(mloc, row[c]);
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 2));
    const float mn = fmaxf(m, mloc);
    float se = 0.f, zh = 0.f, zs = 0.f;
    for (int c = part; c < nv; c += 4) {
      const float z = row[c];
      se += expf(z - mn);
      zs += z;
      if (v0 + c == lab) zh += z;
    }
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      se += __shfl_xor_sync(0xffffffffu, se, o);
      zh += __shfl_xor_sync(0xffffffffu, zh, o);
      zs += __shfl_xor_sync(0xffffffffu, zs, o);
    }
    s = s * expf(m - mn) + se;
    m = mn;
    zl += zh;
    sz += zs;
    __syncthreads();
  }
  if (part == 0 && t < a.T) {
    const float lse = m + logf(s);
    float nll = a.eps > 0.f
                    ? lse - (1.f - a.eps) * zl - (a.eps / a.V) * sz
                    : lse - zl;
    if (a.has_ignore && lab == a.ignore_index) nll = 0.f;
    a.nll[t] = nll;
    a.lse[t] = lse;
  }
}

// ------------------------------------------ backward: dz of one vocab slab
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS) linear_ce_dz(LceArgs a) {
  using M = Mma<TX, TW, true, false, BW_BM, BW_BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<M> sm(smem);
  const int n0 = blockIdx.x * BW_BN, m0 = blockIdx.y * BW_BM;
  M::run(sm.Cs, sm.As, sm.Bs, (const TX *)a.x, a.H, a.T, a.H,
         (const TW *)a.w + (size_t)a.c0 * a.H, a.H, a.width, a.H, m0, n0);
  __syncthreads();
  const float u = a.eps / a.V;
  for (int e = threadIdx.x; e < BW_BM * BW_BN; e += THREADS) {
    const int r = e / BW_BN, c = e % BW_BN, t = m0 + r, n = n0 + c;
    if (t >= a.T || n >= a.ldz) continue;
    float d = 0.f;                           // padding columns stay zero
    if (n < a.width) {
      const float p = expf(sm.Cs[r * M::LDC + c] - a.lse[t]);
      float y = a.c0 + n == a.labels[t] ? 1.f : 0.f;
      if (a.eps > 0.f) y = (1.f - a.eps) * y + u;
      d = a.g[t] * (p - y);
    }
    const size_t i = (size_t)t * a.ldz + n;
    ((TW *)a.dz_w)[i] = from_f<TW>(d);
    if (a.dz_x != a.dz_w) ((TX *)a.dz_x)[i] = from_f<TX>(d);
  }
}

// ----------------------------------------- backward: dx += dz @ w_slab
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS) linear_ce_dx(LceArgs a) {
  using M = Mma<TW, TW, true, true, BW_BM, BW_BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<M> sm(smem);
  const int n0 = blockIdx.x * BW_BN, m0 = blockIdx.y * BW_BM;
  M::run(sm.Cs, sm.As, sm.Bs, (const TW *)a.dz_w, a.ldz, a.T, a.ldz,
         (const TW *)a.w + (size_t)a.c0 * a.H, a.H, a.H, a.width, m0, n0);
  __syncthreads();
  for (int e = threadIdx.x; e < BW_BM * BW_BN; e += THREADS) {
    const int r = e / BW_BN, c = e % BW_BN, t = m0 + r, h = n0 + c;
    if (t >= a.T || h >= a.H) continue;
    const size_t i = (size_t)t * a.H + h;
    float v = sm.Cs[r * M::LDC + c];
    if (!a.first) v += a.dx_acc[i];
    if (a.last)
      ((TX *)a.dx)[i] = from_f<TX>(v);       // dx is dx_acc for fp32 x
    else
      a.dx_acc[i] = v;
  }
}

// -------------------------------------------- backward: dw_slab = dz^T @ x
template <typename TX, typename TW>
__global__ void __launch_bounds__(THREADS) linear_ce_dw(LceArgs a) {
  using M = Mma<TX, TX, false, true, BW_BM, BW_BN>;
  extern __shared__ __align__(128) unsigned char smem[];
  Smem<M> sm(smem);
  const int n0 = blockIdx.x * BW_BN, m0 = blockIdx.y * BW_BM;
  M::run(sm.Cs, sm.As, sm.Bs, (const TX *)a.dz_x, a.ldz, a.ldz, a.T,
         (const TX *)a.x, a.H, a.H, a.T, m0, n0);
  __syncthreads();
  for (int e = threadIdx.x; e < BW_BM * BW_BN; e += THREADS) {
    const int r = e / BW_BN, c = e % BW_BN, v = m0 + r, h = n0 + c;
    if (v >= a.width || h >= a.H) continue;
    ((TW *)a.dw)[(size_t)(a.c0 + v) * a.H + h] =
        from_f<TW>(sm.Cs[r * M::LDC + c]);
  }
}

// -------------------------------------------------------------- launchers
typedef void (*LceKernel)(LceArgs);

static cudaError_t start(LceKernel fn, dim3 grid, int bytes, const LceArgs *a,
                         cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void *)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  fn<<<grid, THREADS, bytes, s>>>(*a);
  return cudaGetLastError();
}

static int cdiv(int n, int d) { return (n + d - 1) / d; }

template <typename TX, typename TW>
cudaError_t fwd(const LceArgs *a, cudaStream_t s) {
  return start(linear_ce_fwd<TX, TW>, dim3(cdiv(a->T, FWD_BM)),
               Mma<TX, TW, true, false, FWD_BM, FWD_BN>::SMEM_BYTES, a, s);
}

template <typename TX, typename TW>
cudaError_t dz(const LceArgs *a, cudaStream_t s) {
  return start(linear_ce_dz<TX, TW>,
               dim3(cdiv(a->ldz, BW_BN), cdiv(a->T, BW_BM)),
               Mma<TX, TW, true, false, BW_BM, BW_BN>::SMEM_BYTES, a, s);
}

template <typename TX, typename TW>
cudaError_t dx(const LceArgs *a, cudaStream_t s) {
  return start(linear_ce_dx<TX, TW>,
               dim3(cdiv(a->H, BW_BN), cdiv(a->T, BW_BM)),
               Mma<TW, TW, true, true, BW_BM, BW_BN>::SMEM_BYTES, a, s);
}

template <typename TX, typename TW>
cudaError_t dw(const LceArgs *a, cudaStream_t s) {
  return start(linear_ce_dw<TX, TW>,
               dim3(cdiv(a->H, BW_BN), cdiv(a->width, BW_BM)),
               Mma<TX, TX, false, true, BW_BM, BW_BN>::SMEM_BYTES, a, s);
}

// shapes every kernel needs; a backward slab also needs 0 < width,
// c0 + width <= V and width <= ldz with ldz % 8 == 0
static bool bad_shape(const LceArgs *a, bool slab) {
  if (a->T <= 0 || a->H <= 0 || a->H % 8 || a->V <= 0) return true;
  if ((a->x_dtype != PT_F32 && a->x_dtype != PT_BF16) ||
      (a->w_dtype != PT_F32 && a->w_dtype != PT_BF16))
    return true;
  return slab && (a->width <= 0 || a->c0 < 0 || a->c0 + a->width > a->V ||
                  a->ldz < a->width || a->ldz % 8);
}

}  // namespace lce
}  // namespace pt

// the (x dtype, w dtype) instance of FN
#define PT_LCE_PICK(FN, a, s)                                         \
  ((a)->x_dtype == PT_BF16                                            \
       ? ((a)->w_dtype == PT_BF16 ? FN<pt::bf16, pt::bf16>(a, s)      \
                                  : FN<pt::bf16, float>(a, s))        \
       : ((a)->w_dtype == PT_BF16 ? FN<float, pt::bf16>(a, s)         \
                                  : FN<float, float>(a, s)))

cudaError_t launch_linear_ce_fwd(const LceArgs *a, cudaStream_t s) {
  using namespace pt::lce;
  if (bad_shape(a, false)) return cudaErrorInvalidValue;
  return count_launch(CNT_LINEAR_CE_FWD, PT_LCE_PICK(fwd, a, s));
}

cudaError_t launch_linear_ce_dz(const LceArgs *a, cudaStream_t s) {
  using namespace pt::lce;
  if (bad_shape(a, true)) return cudaErrorInvalidValue;
  return count_launch(CNT_LINEAR_CE_DZ, PT_LCE_PICK(dz, a, s));
}

cudaError_t launch_linear_ce_dx(const LceArgs *a, cudaStream_t s) {
  using namespace pt::lce;
  if (bad_shape(a, true)) return cudaErrorInvalidValue;
  return count_launch(CNT_LINEAR_CE_DX, PT_LCE_PICK(dx, a, s));
}

cudaError_t launch_linear_ce_dw(const LceArgs *a, cudaStream_t s) {
  using namespace pt::lce;
  if (bad_shape(a, true)) return cudaErrorInvalidValue;
  return count_launch(CNT_LINEAR_CE_DW, PT_LCE_PICK(dw, a, s));
}

extern "C" {

int pt_linear_ce_fwd(const LceArgs *a, void *stream) {
  return launch_linear_ce_fwd(a, (cudaStream_t)stream);
}

int pt_linear_ce_dz(const LceArgs *a, void *stream) {
  return launch_linear_ce_dz(a, (cudaStream_t)stream);
}

int pt_linear_ce_dx(const LceArgs *a, void *stream) {
  return launch_linear_ce_dx(a, (cudaStream_t)stream);
}

int pt_linear_ce_dw(const LceArgs *a, void *stream) {
  return launch_linear_ce_dw(a, (cudaStream_t)stream);
}

}  // extern "C"
