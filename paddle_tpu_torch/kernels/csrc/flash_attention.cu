// Flash attention for training: forward (out + lse) and the recompute
// backward (dq; dk/dv), [B, S, H, D] layout, GQA, causal (top-left
// aligned), segment ids and an additive fp32 bias [B|1, Hq|1, Sq, Sk].
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
//   flash_fwd      _fwd_kernel      (pallas_call at :269)
//   flash_bwd_dq   _bwd_dq_kernel   (pallas_call at :540)
//   flash_bwd_dkv  _bwd_dkv_kernel  (pallas_call at :588)
// with their arithmetic: fp32 logits and softmax state, masked logits
// set to NEG_INF (-1e30, finite), p rounded to the storage type before
// p @ v (fwd) and p^T @ do (dkv), ds = p (dp - delta) scale rounded to the
// storage type before ds @ k and ds^T @ q, l clamped to 1e-30 and
// lse = m + log(l).  delta = rowsum(out * do) is one torch reduction in
// the wrapper, as the JAX package computes it in XLA outside its kernels.
//
// What bounds them on an H100 at the training slice's shape (B 4, S 2048,
// Hq = Hkv = 32, D 128, causal; one 2 B S^2 H D product is 137.4 GFLOP,
// 68.7 GFLOP under the causal mask): tensor-core operations at
// 989 TFLOP/s bf16.  fwd: 2 products, 137 GFLOP, 0.139 ms (its 268 MB of
// q/k/v/o take 0.080 ms at 3.35 TB/s); dq: 3 products, 0.208 ms; dk/dv:
// 4 products, 0.278 ms.
//
// Design, in this first version (wgmma and TMA are later work):
//   * A TPU grid runs its innermost dimension in order and carries the
//     softmax state in VMEM scratch from one step to the next; here one
//     block of 4 warps owns a row tile and loops over the column tiles
//     itself.  flash_fwd and flash_bwd_dq: one block per (64-row q tile,
//     hq, b), looping over k tiles, and stopping at the diagonal under
//     causal.  flash_bwd_dkv: one block per (64-row k tile, hkv, b),
//     looping over the G q heads of the group and the q tiles from the
//     diagonal on, so dk/dv sum inside the block: no atomics, and the
//     result is deterministic (the TPU's folded nq * G axis).
//   * Each warp owns 16 rows of the block's tile.  bf16 products run on
//     tensor cores (nvcuda::wmma 16x16x16, fp32 accumulate); the fp32
//     lane (the correctness lane) runs plain FMA.  Scores and the fp32
//     accumulators live in shared memory, so the online-softmax rescale is
//     a per-row pass over the warp's own rows.
//   * GQA reads kv head hq / G; the kernels mask k_pos >= Sk and q_pos >=
//     Sq themselves and read [B, S, H, D] rows in place (row stride H * D),
//     so the host makes no padded or transposed copies.
//   * Shared memory: up to ~200 KB a block (fp32, D 128), set with
//     cudaFuncSetAttribute(MaxDynamicSharedMemorySize).  head_dim 64 and
//     128 are template instances; the wrapper refuses any other.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace pt {
namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 128;                // 4 warps of 16 rows each

__host__ __device__ constexpr int a128(long long n) {
  return (int)((n + 127) & ~127LL);
}

// leading dimensions (elements) of the shared-memory tiles of a block that
// owns BR rows and steps over BC columns
template <typename T, int D, int BR, int BC>
struct Layout {
  static constexpr int PT = 16 / (int)sizeof(T);
  static constexpr int LDT = D + PT;        // T rows [.][D]
  static constexpr int LDS = BC + 4;        // fp32 scores [BR][BC]
  static constexpr int LDP = BC + PT;       // T probabilities [BR][BC]
  static constexpr int LDA = D + 4;         // fp32 accumulators [BR][D]
};

template <typename T, int D>
struct FwdSmem {
  static constexpr int BQ = 64, BK = 64, SZ = (int)sizeof(T);
  using L = Layout<T, D, BQ, BK>;
  static constexpr int Q = 0;
  static constexpr int K = Q + a128(BQ * L::LDT * SZ);
  static constexpr int V = K + a128(BK * L::LDT * SZ);
  static constexpr int S = V + a128(BK * L::LDT * SZ);
  static constexpr int P = S + a128(BQ * L::LDS * 4);
  static constexpr int O = P + a128(BQ * L::LDP * SZ);
  static constexpr int SEG = O + a128(BQ * L::LDA * 4);
  static constexpr int BYTES = SEG + a128(BK * 4);
};

template <typename T, int D>
struct DqSmem {
  static constexpr int BQ = 64, BK = 32, SZ = (int)sizeof(T);
  using L = Layout<T, D, BQ, BK>;
  static constexpr int Q = 0;
  static constexpr int DO = Q + a128(BQ * L::LDT * SZ);
  static constexpr int K = DO + a128(BQ * L::LDT * SZ);
  static constexpr int V = K + a128(BK * L::LDT * SZ);
  static constexpr int S = V + a128(BK * L::LDT * SZ);
  static constexpr int DP = S + a128(BQ * L::LDS * 4);
  static constexpr int DS = DP + a128(BQ * L::LDS * 4);
  static constexpr int DQ = DS + a128(BQ * L::LDP * SZ);
  static constexpr int SEG = DQ + a128(BQ * L::LDA * 4);
  static constexpr int BYTES = SEG + a128(BK * 4);
};

template <typename T, int D>
struct DkvSmem {
  static constexpr int BK = 64, BQ = 32, SZ = (int)sizeof(T);
  using L = Layout<T, D, BK, BQ>;
  static constexpr int K = 0;
  static constexpr int V = K + a128(BK * L::LDT * SZ);
  static constexpr int Q = V + a128(BK * L::LDT * SZ);
  static constexpr int DO = Q + a128(BQ * L::LDT * SZ);
  static constexpr int S = DO + a128(BQ * L::LDT * SZ);
  static constexpr int DP = S + a128(BK * L::LDS * 4);
  static constexpr int P = DP + a128(BK * L::LDS * 4);
  static constexpr int DS = P + a128(BK * L::LDP * SZ);
  static constexpr int DK = DS + a128(BK * L::LDP * SZ);
  static constexpr int DV = DK + a128(BK * L::LDA * 4);
  static constexpr int ROW = DV + a128(BK * L::LDA * 4);  // lse, delta, seg
  static constexpr int BYTES = ROW + a128(3 * BQ * 4);
};

// rows [row0, row0 + ROWS) of one head of a [B, S, H, D] tensor (row r at
// src + r * rstride) into shared memory with leading dimension D + 16/sz;
// rows at or past nrows read as zero
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_rows(T *dst, const T *src,
                                          size_t rstride, int row0,
                                          int nrows) {
  constexpr int VEC = 16 / (int)sizeof(T), CPR = D / VEC, LD = D + VEC;
  for (int c = threadIdx.x; c < ROWS * CPR; c += THREADS) {
    const int r = c / CPR, col = (c % CPR) * VEC, g = row0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (g < nrows)
      val = *reinterpret_cast<const uint4 *>(src + (size_t)g * rstride + col);
    *reinterpret_cast<uint4 *>(dst + r * LD + col) = val;
  }
}

// fp32 rows (leading dimension D + 4) to rows [row0, ...) of one head of a
// [B, S, H, D] tensor, rounded to T; rows at or past nrows are not written
template <typename T, int D, int ROWS>
__device__ __forceinline__ void store_rows(T *dst, size_t rstride, int row0,
                                           int nrows, const float *src) {
  constexpr int LD = D + 4;
  for (int c = threadIdx.x; c < ROWS * (D / 4); c += THREADS) {
    const int r = c / (D / 4), col = (c % (D / 4)) * 4, g = row0 + r;
    if (g >= nrows) continue;
    const float *s = src + r * LD + col;
    T *d = dst + (size_t)g * rstride + col;
#pragma unroll
    for (int i = 0; i < 4; ++i) d[i] = from_f<T>(s[i]);
  }
}

// ---- one warp's products on 16 rows ------------------------------------
// C[16 x N] = A[16 x K] . B[N x K]^T, C fp32 in shared memory
template <int N, int K>
__device__ __forceinline__ void warp_abt(float *C, int ldc, const bf16 *A,
                                         int lda, const bf16 *B, int ldb) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[N / 16];
#pragma unroll
  for (int n = 0; n < N / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, A + k, lda);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
      wmma::load_matrix_sync(fb, B + n * 16 * ldb + k, ldb);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < N / 16; ++n)
    wmma::store_matrix_sync(C + n * 16, acc[n], ldc, wmma::mem_row_major);
}

// C[16 x N] += A[16 x K] . B[K x N], C fp32 in shared memory
template <int N, int K>
__device__ __forceinline__ void warp_ab_acc(float *C, int ldc, const bf16 *A,
                                            int lda, const bf16 *B, int ldb) {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[N / 16];
#pragma unroll
  for (int n = 0; n < N / 16; ++n)
    wmma::load_matrix_sync(acc[n], C + n * 16, ldc, wmma::mem_row_major);
#pragma unroll
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, A + k, lda);
#pragma unroll
    for (int n = 0; n < N / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, B + k * ldb + n * 16, ldb);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
#pragma unroll
  for (int n = 0; n < N / 16; ++n)
    wmma::store_matrix_sync(C + n * 16, acc[n], ldc, wmma::mem_row_major);
}

// the fp32 lane: the same two products with FMA
template <int N, int K>
__device__ __forceinline__ void warp_abt(float *C, int ldc, const float *A,
                                         int lda, const float *B, int ldb) {
  for (int e = threadIdx.x & 31; e < 16 * N; e += 32) {
    const int r = e / N, c = e % N;
    const float *x = A + r * lda, *y = B + c * ldb;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(x[k], y[k], s);
    C[r * ldc + c] = s;
  }
}

template <int N, int K>
__device__ __forceinline__ void warp_ab_acc(float *C, int ldc, const float *A,
                                            int lda, const float *B, int ldb) {
  for (int e = threadIdx.x & 31; e < 16 * N; e += 32) {
    const int r = e / N, c = e % N;
    const float *x = A + r * lda;
    float s = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) s = fmaf(x[k], B[k * ldb + c], s);
    C[r * ldc + c] += s;
  }
}

// the logit of (q_pos, k_pos) from its raw product, with the TPU kernel's
// order: scale, + bias, then the causal, padding and segment masks
__device__ __forceinline__ float logit(const FlashArgs &a, const float *bias,
                                       float raw, int qpos, int kpos,
                                       bool same_seg) {
  float v = raw * a.scale;
  if (bias && qpos < a.Sq && kpos < a.Sk)
    v += bias[(size_t)qpos * a.Sk + kpos];
  if (a.causal && qpos < kpos) v = NEG_INF;
  if (kpos >= a.Sk) v = NEG_INF;
  if (!same_seg) v = NEG_INF;
  return v;
}

// ------------------------------------------------------------- forward
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd(FlashArgs a) {
  using SM = FwdSmem<T, D>;
  using L = typename SM::L;
  constexpr int BQ = SM::BQ, BK = SM::BK, HALF = BK / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T *Qs = (T *)(smem + SM::Q), *Ks = (T *)(smem + SM::K);
  T *Vs = (T *)(smem + SM::V), *Ps = (T *)(smem + SM::P);
  float *Ss = (float *)(smem + SM::S), *Os = (float *)(smem + SM::O);
  int *segk = (int *)(smem + SM::SEG);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const size_t qs = (size_t)a.Hq * D, ks = (size_t)a.Hkv * D;
  const T *qp = (const T *)a.q + (size_t)b * a.Sq * qs + (size_t)h * D;
  const T *kp = (const T *)a.k + (size_t)b * a.Sk * ks + (size_t)hk * D;
  const T *vp = (const T *)a.v + (size_t)b * a.Sk * ks + (size_t)hk * D;
  const float *bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                             : nullptr;

  load_rows<T, D, BQ>(Qs, qp, qs, q0, a.Sq);
  for (int i = threadIdx.x; i < BQ * L::LDA; i += THREADS) Os[i] = 0.f;

  const int qpos = q0 + warp * 16 + r;
  const int sq = (a.seg_q && qpos < a.Sq) ? a.seg_q[(size_t)b * a.Sq + qpos]
                                           : 0;
  const T *Qw = Qs + warp * 16 * L::LDT;
  T *Pw = Ps + warp * 16 * L::LDP;
  float *Sw = Ss + warp * 16 * L::LDS, *Ow = Os + warp * 16 * L::LDA;
  float m = NEG_INF, l = 0.f;

  const int nk = (a.Sk + BK - 1) / BK;
  const int nkt = a.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows<T, D, BK>(Ks, kp, ks, k0, a.Sk);
    load_rows<T, D, BK>(Vs, vp, ks, k0, a.Sk);
    if (a.seg_q)
      for (int i = threadIdx.x; i < BK; i += THREADS)
        segk[i] = k0 + i < a.Sk ? a.seg_k[(size_t)b * a.Sk + k0 + i] : 0;
    __syncthreads();
    warp_abt<BK, D>(Sw, L::LDS, Qw, L::LDT, Ks, L::LDT);
    __syncwarp();
    float s[HALF], mloc = NEG_INF;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      s[j] = logit(a, bias, Sw[r * L::LDS + c], qpos, k0 + c,
                   !a.seg_q || sq == segk[c]);
      mloc = fmaxf(mloc, s[j]);
    }
    mloc = fmaxf(mloc, __shfl_xor_sync(0xffffffffu, mloc, 1));
    const float mnew = fmaxf(m, mloc);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float p = expf(s[j] - mnew);
      Pw[r * L::LDP + half * HALF + j] = from_f<T>(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m - mnew);
    l = alpha * l + sum;
    m = mnew;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      Ow[r * L::LDA + c] *= alpha;
    __syncwarp();
    warp_ab_acc<D, BK>(Ow, L::LDA, Pw, L::LDP, Vs, L::LDT);
  }
  __syncwarp();
  const float lc = fmaxf(l, 1e-30f);
  for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
    Ow[r * L::LDA + c] = Ow[r * L::LDA + c] / lc;
  if (half == 0 && qpos < a.Sq)
    a.lse[((size_t)b * a.Hq + h) * a.Sq + qpos] = m + logf(lc);
  __syncthreads();
  store_rows<T, D, BQ>((T *)a.out + (size_t)b * a.Sq * qs + (size_t)h * D,
                       qs, q0, a.Sq, Os);
}

// ------------------------------------------------------------ backward dq
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dq(FlashArgs a) {
  using SM = DqSmem<T, D>;
  using L = typename SM::L;
  constexpr int BQ = SM::BQ, BK = SM::BK, HALF = BK / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T *Qs = (T *)(smem + SM::Q), *DOs = (T *)(smem + SM::DO);
  T *Ks = (T *)(smem + SM::K), *Vs = (T *)(smem + SM::V);
  T *DSs = (T *)(smem + SM::DS);
  float *Ss = (float *)(smem + SM::S), *DPs = (float *)(smem + SM::DP);
  float *DQs = (float *)(smem + SM::DQ);
  int *segk = (int *)(smem + SM::SEG);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);
  const size_t qs = (size_t)a.Hq * D, ks = (size_t)a.Hkv * D;
  const size_t qoff = (size_t)b * a.Sq * qs + (size_t)h * D;
  const T *kp = (const T *)a.k + (size_t)b * a.Sk * ks + (size_t)hk * D;
  const T *vp = (const T *)a.v + (size_t)b * a.Sk * ks + (size_t)hk * D;
  const float *bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                             : nullptr;

  load_rows<T, D, BQ>(Qs, (const T *)a.q + qoff, qs, q0, a.Sq);
  load_rows<T, D, BQ>(DOs, (const T *)a.dout + qoff, qs, q0, a.Sq);
  for (int i = threadIdx.x; i < BQ * L::LDA; i += THREADS) DQs[i] = 0.f;

  const int qpos = q0 + warp * 16 + r;
  const size_t row = ((size_t)b * a.Hq + h) * a.Sq + qpos;
  const float lse = qpos < a.Sq ? a.lse[row] : 0.f;
  const float delta = qpos < a.Sq ? a.delta[row] : 0.f;
  const int sq = (a.seg_q && qpos < a.Sq) ? a.seg_q[(size_t)b * a.Sq + qpos]
                                           : 0;
  const T *Qw = Qs + warp * 16 * L::LDT, *DOw = DOs + warp * 16 * L::LDT;
  T *DSw = DSs + warp * 16 * L::LDP;
  float *Sw = Ss + warp * 16 * L::LDS, *DPw = DPs + warp * 16 * L::LDS;
  float *DQw = DQs + warp * 16 * L::LDA;

  const int nk = (a.Sk + BK - 1) / BK;
  const int nkt = a.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;
  for (int kt = 0; kt < nkt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_rows<T, D, BK>(Ks, kp, ks, k0, a.Sk);
    load_rows<T, D, BK>(Vs, vp, ks, k0, a.Sk);
    if (a.seg_q)
      for (int i = threadIdx.x; i < BK; i += THREADS)
        segk[i] = k0 + i < a.Sk ? a.seg_k[(size_t)b * a.Sk + k0 + i] : 0;
    __syncthreads();
    warp_abt<BK, D>(Sw, L::LDS, Qw, L::LDT, Ks, L::LDT);
    warp_abt<BK, D>(DPw, L::LDS, DOw, L::LDT, Vs, L::LDT);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + j;
      const float s = logit(a, bias, Sw[r * L::LDS + c], qpos, k0 + c,
                            !a.seg_q || sq == segk[c]);
      const float p = expf(s - lse);
      DSw[r * L::LDP + c] =
          from_f<T>(p * (DPw[r * L::LDS + c] - delta) * a.scale);
    }
    __syncwarp();
    warp_ab_acc<D, BK>(DQw, L::LDA, DSw, L::LDP, Ks, L::LDT);
  }
  __syncthreads();
  store_rows<T, D, BQ>((T *)a.dq + qoff, qs, q0, a.Sq, DQs);
}

// --------------------------------------------------------- backward dk/dv
template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_bwd_dkv(FlashArgs a) {
  using SM = DkvSmem<T, D>;
  using L = typename SM::L;
  constexpr int BK = SM::BK, BQ = SM::BQ, HALF = BQ / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  T *Ks = (T *)(smem + SM::K), *Vs = (T *)(smem + SM::V);
  T *Qs = (T *)(smem + SM::Q), *DOs = (T *)(smem + SM::DO);
  T *Ps = (T *)(smem + SM::P), *DSs = (T *)(smem + SM::DS);
  float *Ss = (float *)(smem + SM::S), *DPs = (float *)(smem + SM::DP);
  float *DKs = (float *)(smem + SM::DK), *DVs = (float *)(smem + SM::DV);
  float *lse_s = (float *)(smem + SM::ROW), *delta_s = lse_s + BQ;
  int *segq = (int *)(delta_s + BQ);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r = lane >> 1, half = lane & 1;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const size_t qs = (size_t)a.Hq * D, ks = (size_t)a.Hkv * D;
  const size_t koff = (size_t)b * a.Sk * ks + (size_t)hk * D;

  load_rows<T, D, BK>(Ks, (const T *)a.k + koff, ks, k0, a.Sk);
  load_rows<T, D, BK>(Vs, (const T *)a.v + koff, ks, k0, a.Sk);
  for (int i = threadIdx.x; i < BK * L::LDA; i += THREADS) {
    DKs[i] = 0.f;
    DVs[i] = 0.f;
  }

  const int kpos = k0 + warp * 16 + r;
  const int sk = (a.seg_k && kpos < a.Sk) ? a.seg_k[(size_t)b * a.Sk + kpos]
                                           : 0;
  const T *Kw = Ks + warp * 16 * L::LDT, *Vw = Vs + warp * 16 * L::LDT;
  T *Pw = Ps + warp * 16 * L::LDP, *DSw = DSs + warp * 16 * L::LDP;
  float *Sw = Ss + warp * 16 * L::LDS, *DPw = DPs + warp * 16 * L::LDS;
  float *DKw = DKs + warp * 16 * L::LDA, *DVw = DVs + warp * 16 * L::LDA;

  const int nq = (a.Sq + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const size_t qoff = (size_t)b * a.Sq * qs + (size_t)h * D;
    const size_t roff = ((size_t)b * a.Hq + h) * a.Sq;
    const float *bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                               : nullptr;
    for (int qt = qt0; qt < nq; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();
      load_rows<T, D, BQ>(Qs, (const T *)a.q + qoff, qs, q0, a.Sq);
      load_rows<T, D, BQ>(DOs, (const T *)a.dout + qoff, qs, q0, a.Sq);
      for (int i = threadIdx.x; i < BQ; i += THREADS) {
        const bool in = q0 + i < a.Sq;
        lse_s[i] = in ? a.lse[roff + q0 + i] : 0.f;
        delta_s[i] = in ? a.delta[roff + q0 + i] : 0.f;
        segq[i] = (in && a.seg_q) ? a.seg_q[(size_t)b * a.Sq + q0 + i] : 0;
      }
      __syncthreads();
      warp_abt<BQ, D>(Sw, L::LDS, Kw, L::LDT, Qs, L::LDT);    // s^T
      warp_abt<BQ, D>(DPw, L::LDS, Vw, L::LDT, DOs, L::LDT);  // dp^T
      __syncwarp();
#pragma unroll
      for (int j = 0; j < HALF; ++j) {
        const int c = half * HALF + j, qpos = q0 + c;
        const float s = logit(a, bias, Sw[r * L::LDS + c], qpos, kpos,
                              !a.seg_q || segq[c] == sk);
        const float p = qpos < a.Sq ? expf(s - lse_s[c]) : 0.f;
        Pw[r * L::LDP + c] = from_f<T>(p);
        DSw[r * L::LDP + c] =
            from_f<T>(p * (DPw[r * L::LDS + c] - delta_s[c]) * a.scale);
      }
      __syncwarp();
      warp_ab_acc<D, BQ>(DVw, L::LDA, Pw, L::LDP, DOs, L::LDT);
      warp_ab_acc<D, BQ>(DKw, L::LDA, DSw, L::LDP, Qs, L::LDT);
    }
  }
  __syncthreads();
  store_rows<T, D, BK>((T *)a.dk + koff, ks, k0, a.Sk, DKs);
  store_rows<T, D, BK>((T *)a.dv + koff, ks, k0, a.Sk, DVs);
}

}  // namespace flash
}  // namespace pt

// The kernel instance for (dtype, D) and its shared-memory bytes; any other
// pair returns cudaErrorInvalidValue from the launcher.
#define PT_FLASH_PICK(KERNEL, SMEM, a, fn, bytes)                   \
  do {                                                              \
    using namespace pt::flash;                                      \
    if ((a)->Hkv <= 0 || (a)->Hq % (a)->Hkv) return cudaErrorInvalidValue; \
    if ((a)->dtype == PT_BF16 && (a)->D == 64) {                    \
      fn = KERNEL<pt::bf16, 64>; bytes = SMEM<pt::bf16, 64>::BYTES; \
    } else if ((a)->dtype == PT_BF16 && (a)->D == 128) {            \
      fn = KERNEL<pt::bf16, 128>; bytes = SMEM<pt::bf16, 128>::BYTES; \
    } else if ((a)->dtype == PT_F32 && (a)->D == 64) {              \
      fn = KERNEL<float, 64>; bytes = SMEM<float, 64>::BYTES;       \
    } else if ((a)->dtype == PT_F32 && (a)->D == 128) {             \
      fn = KERNEL<float, 128>; bytes = SMEM<float, 128>::BYTES;     \
    } else {                                                        \
      return cudaErrorInvalidValue;                                 \
    }                                                               \
  } while (0)

typedef void (*FlashKernel)(FlashArgs);

static cudaError_t set_smem(FlashKernel fn, int bytes) {
  return cudaFuncSetAttribute((const void *)fn,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

cudaError_t launch_flash_fwd(const FlashArgs *a, cudaStream_t s) {
  FlashKernel fn;
  int bytes;
  PT_FLASH_PICK(flash_fwd, FwdSmem, a, fn, bytes);
  if (a->B == 0 || a->Sq == 0 || a->Hq == 0) return cudaSuccess;
  cudaError_t e = set_smem(fn, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((a->Sq + pt::flash::FwdSmem<float, 64>::BQ - 1) /
                pt::flash::FwdSmem<float, 64>::BQ,
            a->Hq, a->B);
  fn<<<grid, pt::flash::THREADS, bytes, s>>>(*a);
  return count_launch(CNT_FLASH_FWD, cudaGetLastError());
}

cudaError_t launch_flash_bwd_dq(const FlashArgs *a, cudaStream_t s) {
  FlashKernel fn;
  int bytes;
  PT_FLASH_PICK(flash_bwd_dq, DqSmem, a, fn, bytes);
  if (a->B == 0 || a->Sq == 0 || a->Hq == 0) return cudaSuccess;
  cudaError_t e = set_smem(fn, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((a->Sq + pt::flash::DqSmem<float, 64>::BQ - 1) /
                pt::flash::DqSmem<float, 64>::BQ,
            a->Hq, a->B);
  fn<<<grid, pt::flash::THREADS, bytes, s>>>(*a);
  return count_launch(CNT_FLASH_BWD_DQ, cudaGetLastError());
}

cudaError_t launch_flash_bwd_dkv(const FlashArgs *a, cudaStream_t s) {
  FlashKernel fn;
  int bytes;
  PT_FLASH_PICK(flash_bwd_dkv, DkvSmem, a, fn, bytes);
  if (a->B == 0 || a->Sk == 0 || a->Hkv == 0) return cudaSuccess;
  cudaError_t e = set_smem(fn, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((a->Sk + pt::flash::DkvSmem<float, 64>::BK - 1) /
                pt::flash::DkvSmem<float, 64>::BK,
            a->Hkv, a->B);
  fn<<<grid, pt::flash::THREADS, bytes, s>>>(*a);
  return count_launch(CNT_FLASH_BWD_DKV, cudaGetLastError());
}

extern "C" {

int pt_flash_fwd(const FlashArgs *a, void *stream) {
  return launch_flash_fwd(a, (cudaStream_t)stream);
}

int pt_flash_bwd_dq(const FlashArgs *a, void *stream) {
  return launch_flash_bwd_dq(a, (cudaStream_t)stream);
}

int pt_flash_bwd_dkv(const FlashArgs *a, void *stream) {
  return launch_flash_bwd_dkv(a, (cudaStream_t)stream);
}

}  // extern "C"
