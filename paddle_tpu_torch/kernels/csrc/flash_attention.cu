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
// Design.  A TPU grid runs its innermost dimension in order and carries
// its state in VMEM scratch from one step to the next; here one block owns
// a row tile and loops over the other sequence itself.  flash_fwd and
// flash_bwd_dq: one block per (q tile, hq, b), looping over k tiles and
// stopping at the diagonal under causal.  flash_bwd_dkv: one block per
// (64-row k tile, hkv, b), looping over the G q heads of the group and the
// q tiles from the diagonal on, so dk/dv sum inside the block: no atomics,
// and the result is deterministic (the TPU's folded nq * G axis).  GQA
// reads kv head hq / G; the kernels mask k_pos >= Sk and q_pos >= Sq
// themselves and read [B, S, H, D] rows in place (row stride H * D), so
// the host makes no padded or transposed copies.  head_dim 64 and 128 are
// template instances; the wrapper refuses any other.  Each launcher takes
// its grid, block size and shared-memory bytes from the instance it picks.
//
//   * bf16 backward (flash_bwd_dq_mma, flash_bwd_dkv_mma): 4 warps, 16 of
//     the block's 64 rows each, stepping over the other sequence in tiles
//     of 64 rows, each taken in two passes of 32.  Products are mma.sync
//     m16n8k16 (fp32 accumulate) with operands from ldmatrix (.trans where
//     the shared tile is [k][n]).  The accumulators live in registers for
//     the whole loop: dQ, 16 x D fp32 a warp (64 registers a thread at D
//     128); dK and dV (128).  Scores never touch shared memory: dq computes
//     S = Q K^T and dP = dO V^T into C fragments, p = exp(s - lse) and ds =
//     p (dp - delta) scale on the fragment elements in place (each thread
//     knows its row and column from the m16n8 layout), and packs two
//     neighbouring n8 C tiles of ds, as bf16, into one A fragment of dQ +=
//     dS K.  dkv computes the transposes S^T = K Q^T and dP^T = V dO^T (k
//     rows as M), so P^T and dS^T are the A fragments of dV += P^T dO and
//     dK += dS^T Q as they stand; lse and delta are per column there and
//     are staged with the segment ids beside each Q / dO tile.  The
//     streamed tiles (K, V in dq; Q, dO, lse, delta and segment ids in dkv)
//     arrive by cp.async (16 bytes, 4 for the fp32 / int32 rows, zero-
//     filled past Sq / Sk) into a ring of 2 stages; the next tile's copies
//     are issued, after one barrier, before the current tile's products.
//     Q, dO (dq) and K, V (dkv) are loaded once.  A warp takes a tile's
//     per-element masks only where the tile crosses the causal diagonal of
//     its rows or the Sk (dq) / Sq (dkv) edge, or meets a bias or segment
//     ids, and then skips the passes that add nothing; elsewhere p =
//     exp2(raw * scale log2e - lse log2e) with no compares (MUFU.EX2,
//     denormals flushed).  The two cases are one basic block each, so the
//     scheduler interleaves one pass's score math with the other's
//     products.  Shared memory a block (rows padded by 16 bytes, so the 8
//     row addresses of an ldmatrix fall in distinct banks): dq 104,448 B at
//     D 128 and 55,296 B at D 64; dkv 105,984 B and 56,832 B.
//     __launch_bounds__ asks for 2 blocks (8 warps) an SM at D 128 and 3
//     (12 warps, 168 registers) at D 64.  dq walks its q tiles from the
//     last, so under causal the longest rows start first.
//   * bf16 forward (flash_fwd_mma; the note above it has the details): 4
//     warps own 128 q rows at D 128 (32 a warp, two m16 tiles) and 64 at D
//     64 (16 a warp), with K and V streamed in 32- / 64-row tiles through 2
//     cp.async stages.  mma.sync m16n8k16 with ldmatrix operands; O (fp32:
//     128 / 32 registers a thread), S / P, m and l stay in registers, P
//     goes from S's C fragments straight into the A fragments of O += P V,
//     p = exp2 with the scale folded into one FFMA, and the masks run only
//     on the tiles that need them.  At the slice's shape it takes 0.51 ms
//     on an H100 80GB HBM3 at 700 W, 27 % of its 0.139 ms bound and about
//     2x SDPA's forward (PERF.md, PR 8): latency-bound at 2 blocks (8
//     warps) an SM, which its 255 registers allow, with the softmax, the
//     P V product and the K / V streaming each costing 11-17 % of it.
//   * fp32 (the correctness lane of all three; never timed): the first
//     version's design, plain FMA products with the scores and the fp32
//     accumulators in shared memory; up to ~200 KB a block (D 128), set
//     with cudaFuncSetAttribute(MaxDynamicSharedMemorySize).  wgmma and TMA
//     for the bf16 kernels are later work.
#include "mma.cuh"

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
  static constexpr int ROWS = BQ, THREADS = flash::THREADS;
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
  static constexpr int ROWS = BQ, THREADS = flash::THREADS;
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
  static constexpr int ROWS = BK, THREADS = flash::THREADS;
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

// ---- one warp's products on 16 rows (the fp32 lane: plain FMA)
// C[16 x N] = A[16 x K] . B[N x K]^T, C fp32 in shared memory
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

// C[16 x N] += A[16 x K] . B[K x N], C fp32 in shared memory
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

// ------------------------------------------------ forward (fp32 lane)
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

// ============================================ bf16 kernels (mma.sync)
// (cp_rows, mma_abt, mma_ab, c_to_a and ex2: mma.cuh)

// ============================================== bf16 forward (mma.sync)
// A block owns BR = 16 MT WARPS q rows: each warp 16 MT of them, as MT
// m16 tiles.  K and V stream in BC-row tiles through a ring of 2 cp.async
// stages; the next tile's copies are issued, after the one barrier of a
// tile, before the current tile's products.  Q is loaded once.  For each
// tile a warp computes S = Q K^T into C fragments (BC / 8 n8 tiles of 4
// fp32 a thread per m16 tile: rows g and g + 8, columns 2t, 2t + 1), takes the
// row max over the quad of lanes that share its rows, rescales its running
// state by alpha, packs p, rounded to bf16, into the A fragments of O +=
// P V (V read [k][n] through ldmatrix .trans) and sums the fp32 p into its
// part of l; m, l and O stay in registers for the whole loop.  The logits
// stay in the natural domain (m, and so lse = m + log l, keep the TPU
// kernel's meaning); p = 2^(s log2e - m log2e), one FFMA and one MUFU.EX2
// an element.  A warp takes the per-element masks of logit() only on a
// tile that crosses the causal diagonal of its rows or the Sk edge, or
// meets a bias or segment ids (and skips a tile wholly above its
// diagonal); elsewhere it takes max(raw) * scale as the row max, so no
// compare touches an element.  The two cases are one basic block each.
// At the end l is summed over the quad, out = O / max(l, 1e-30) is
// rounded to bf16 into the warp's own Q rows in shared memory (no other
// warp reads them) and stored in 16-byte row chunks; lse from one lane of
// each quad.  Blocks take their (q tile, head) in launch order, groups of
// GH (batch, head) pairs at a time, longest q tiles first within a group:
// the grid's tail stays short under causal and the K / V of about two
// groups is live in L2 at once.
//
// The shape per head_dim: MT m16 tiles a warp, WARPS warps a block, MINB
// blocks an SM for __launch_bounds__ and BC rows a K / V tile, each the
// fastest measured (PERF.md, PR 8); tools/flash_fwd_ab.py times others
// by rewriting the two FwdShapeOf lines.
template <int MT_, int WARPS_, int MINB_, int BC_>
struct FwdShape {
  static constexpr int MT = MT_, WARPS = WARPS_, MINB = MINB_, BC = BC_;
};
template <int D> struct FwdShapeOf { using T = FwdShape<2, 4, 2, 32>; };
template <> struct FwdShapeOf<64> { using T = FwdShape<1, 4, 4, 64>; };

template <int D>
struct FwdMma : FwdShapeOf<D>::T {
  using S = typename FwdShapeOf<D>::T;
  static constexpr int BC = S::BC;            // a streamed K / V tile
  static constexpr int WR = 16 * S::MT;       // a warp's q rows
  static constexpr int BR = WR * S::WARPS;    // the block's q rows
  static constexpr int THREADS = 32 * S::WARPS, ROWS = BR;
  static constexpr int GH = 16;               // (batch, head) pairs a group
  static constexpr int LD = D + 8;            // bf16 a shared row (16 B pad)
  static constexpr int KV = BR * LD * 2;      // Q, then the stages
  static constexpr int STAGE = 2 * BC * LD * 2;   // K, then V
  static constexpr int BYTES = KV + 2 * STAGE;
};

template <int D>
__global__ void __launch_bounds__(FwdMma<D>::THREADS, FwdMma<D>::MINB)
    flash_fwd_mma(FlashArgs a) {
  using C = FwdMma<D>;
  constexpr int BQ = C::BR, BK = C::BC, LD = C::LD, NTH = C::THREADS;
  constexpr int MT = C::MT, WR = C::WR;
  constexpr int KS = D / 16, NS = BK / 8, ND = D / 8, KP = BK / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Qs = (bf16 *)smem;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this block's (q tile, batch * Hq + head) from its place in launch order
  const int nq = gridDim.x, pairs = gridDim.y * gridDim.z;
  const int id = blockIdx.x + nq * (blockIdx.y + gridDim.y * blockIdx.z);
  const int g0 = id / (C::GH * nq) * C::GH, gn = min(C::GH, pairs - g0);
  const int pair = g0 + (id - g0 * nq) % gn;
  const int q0 = (nq - 1 - (id - g0 * nq) / gn) * BQ;  // longest rows first
  const int wq0 = q0 + warp * WR;                   // the warp's first row
  const int h = pair % a.Hq, b = pair / a.Hq, hk = h / (a.Hq / a.Hkv);
  const size_t qs = (size_t)a.Hq * D, ks = (size_t)a.Hkv * D;
  const size_t qoff = (size_t)b * a.Sq * qs + (size_t)h * D;
  const bf16 *kp = (const bf16 *)a.k + (size_t)b * a.Sk * ks + (size_t)hk * D;
  const bf16 *vp = (const bf16 *)a.v + (size_t)b * a.Sk * ks + (size_t)hk * D;
  const float *bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                             : nullptr;
  const int nk = (a.Sk + BK - 1) / BK;
  const int nkt = a.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  auto stage = [&](int kt) {                  // K, V tile kt: one group
    bf16 *Ks = (bf16 *)(smem + C::KV + (kt & 1) * C::STAGE);
    cp_rows<D, BK, NTH>(Ks, kp, ks, kt * BK, a.Sk);
    cp_rows<D, BK, NTH>(Ks + BK * LD, vp, ks, kt * BK, a.Sk);
    cp_commit();
  };
  cp_rows<D, BQ, NTH>(Qs, (const bf16 *)a.q + qoff, qs, q0, a.Sq);
  if (nkt > 0)
    stage(0);
  else
    cp_commit();

  // this thread's rows: g and g + 8 of each of the warp's m16 tiles
  int sq[MT][2];
  float m[MT][2], l[MT][2], acc[MT][ND][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qpos = wq0 + 16 * mt + g + 8 * i;
      sq[mt][i] = (a.seg_q && qpos < a.Sq)
                      ? a.seg_q[(size_t)b * a.Sq + qpos] : 0;
      m[mt][i] = NEG_INF;
      l[mt][i] = 0.f;                         // this thread's columns only
    }
#pragma unroll
    for (int j = 0; j < ND; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;
  }
  const float sl2 = a.scale * LOG2E;
  // the plain body takes max(raw) * scale as the row max: a positive scale
  const bool always = bias || a.seg_q || !(a.scale > 0.f);

  for (int kt = 0; kt < nkt; ++kt) {
    cp_wait<0>();
    __syncthreads();               // tile kt landed; tile kt - 1 is done
    if (kt + 1 < nkt) stage(kt + 1);
    const bf16 *Ks = (const bf16 *)(smem + C::KV + (kt & 1) * C::STAGE);
    const bf16 *Vs = Ks + BK * LD;
    const int k0 = kt * BK;
    // nothing to add: the warp's rows past Sq, or every key after them
    if (wq0 >= a.Sq || (a.causal && k0 > wq0 + WR - 1)) continue;
    auto body = [&](auto flag) {
      constexpr bool MASK = decltype(flag)::value;
      float s[MT][NS][4];
      mma_abt<MT, NS, KS, LD>(s, Qs + warp * WR * LD, Ks, lane);
      float mx[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (MASK) {
#pragma unroll
          for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1, qpos = wq0 + 16 * mt + g + 8 * i;
              const int kpos = k0 + 8 * j + 2 * t + (e & 1);
              const bool same =
                  !a.seg_q || (kpos < a.Sk &&
                               sq[mt][i] == a.seg_k[(size_t)b * a.Sk + kpos]);
              s[mt][j][e] = logit(a, bias, s[mt][j][e], qpos, kpos, same);
            }
        }
        mx[mt][0] = s[mt][0][0];
        mx[mt][1] = s[mt][0][2];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            mx[mt][e >> 1] = fmaxf(mx[mt][e >> 1], s[mt][j][e]);
      }
      float mc[MT][2];                        // the new m, times log2(e)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x = mx[mt][i];
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
          const float mnew = fmaxf(m[mt][i], MASK ? x : x * a.scale);
          const float alpha = ex2((m[mt][i] - mnew) * LOG2E);
          m[mt][i] = mnew;
          mc[mt][i] = mnew * LOG2E;
          l[mt][i] *= alpha;
#pragma unroll
          for (int j = 0; j < ND; ++j) {
            acc[mt][j][2 * i] *= alpha;
            acc[mt][j][2 * i + 1] *= alpha;
          }
        }
      unsigned pa[MT][KP][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1;
            // masked: (s - m) first, so a row whose every logit so far is
            // NEG_INF gets exp(0) = 1, as in the TPU kernel
            const float p = MASK ? ex2((s[mt][j][e] - m[mt][i]) * LOG2E)
                                 : ex2(fmaf(s[mt][j][e], sl2, -mc[mt][i]));
            s[mt][j][e] = p;
            l[mt][i] += p;
          }
        c_to_a<KP>(pa[mt], s[mt]);
      }
      mma_ab<MT, ND, KP, LD>(acc, pa, Vs, lane);   // O += P V
    };
    if (always || k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > wq0))
      body(Flag<true>());
    else
      body(Flag<false>());
  }
  cp_wait<0>();
  if (nkt == 0) __syncthreads();   // Q landed before the warps reuse it

  bf16 *Ow = Qs + warp * WR * LD;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float lt = l[mt][i];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lc = fmaxf(lt, 1e-30f), inv = 1.f / lc;
      const int r = 16 * mt + g + 8 * i, qpos = wq0 + r;
      if (t == 0 && qpos < a.Sq)
        a.lse[((size_t)b * a.Hq + h) * a.Sq + qpos] = m[mt][i] + logf(lc);
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<unsigned *>(Ow + r * LD + 8 * j + 2 * t) =
            pack_bf16(acc[mt][j][2 * i] * inv, acc[mt][j][2 * i + 1] * inv);
    }
  __syncwarp();
  bf16 *out = (bf16 *)a.out + qoff;
  constexpr int CPR = D / 8;
#pragma unroll
  for (int c = lane; c < WR * CPR; c += 32) {
    const int r = c / CPR, col = (c % CPR) * 8;
    if (wq0 + r < a.Sq)
      *reinterpret_cast<uint4 *>(out + (size_t)(wq0 + r) * qs + col) =
          *reinterpret_cast<const uint4 *>(Ow + r * LD + col);
  }
}

// ============================================= bf16 backward (mma.sync)
// 4 warps own 16 rows each of a block's 64 and step over the other
// sequence in 64-row tiles, streamed through two cp.async stages in shared
// memory and taken in two passes of 32.  Every product is mma.sync
// m16n8k16 with operands from ldmatrix; the fp32 accumulators (dQ; dK and
// dV) stay in registers for the whole loop and are rounded to bf16 once,
// at the store; the score tiles (S, dP and their transposes) live in C
// fragments and become the A fragments of the next product by packing,
// never touching shared memory.
template <int D>
struct BwdMma {
  static constexpr int BR = 64;               // the block's own rows
  static constexpr int BC = 64, PW = 32;      // a streamed tile, a pass
  static constexpr int THREADS = 128, ROWS = BR;
  // blocks an SM: 2 at D 128 (shared memory and 255 registers a thread);
  // 3 at D 64 (168 registers)
  static constexpr int MINB = D == 64 ? 3 : 2;
  static constexpr int LD = D + 8;            // bf16 a shared row (16 B pad)
  static constexpr int TILE = 64 * LD * 2;    // bytes of one 64-row tile
  static constexpr int STAGES = 2;
};

// dq: Q, dO of the block; stage s: K, then V
template <int D>
struct DqMma : BwdMma<D> {
  using B = BwdMma<D>;
  static constexpr int Q = 0, DO = B::TILE, KV = 2 * B::TILE;
  static constexpr int BYTES = KV + B::STAGES * 2 * B::TILE;
};

// dk/dv: K, V of the block; stage s: Q, dO, then lse, delta, segment ids
template <int D>
struct DkvMma : BwdMma<D> {
  using B = BwdMma<D>;
  static constexpr int ROWB = 3 * B::BC * 4;
  static constexpr int STAGE = 2 * B::TILE + ROWB;
  static constexpr int K = 0, V = B::TILE, ST = 2 * B::TILE;
  static constexpr int BYTES = ST + B::STAGES * STAGE;
};

// ds = p (dp - delta) scale in place of dp, with p = exp(s - lse) from the
// raw products in s (C fragments: rows g, g + 8 and columns 2t, 2t + 1 of
// each n8 tile); s receives p.  pos(j, e, ...) gives element e of tile j's
// q and k positions, its lse and delta, and whether its segments match.
// MASK applies logit()'s bias and masks (and p = 0 past Sq); without it
// the logit is raw * scale, with log2(e) folded into scale and lse.
template <bool MASK, int NT, class Pos>
__device__ __forceinline__ void softmax_grad(const FlashArgs &a,
                                             const float *bias, float (*s)[4],
                                             float (*dp)[4], Pos pos) {
  const float sl2 = a.scale * LOG2E;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int qpos, kpos;
      float lse, delta;
      bool same;
      pos(j, e, qpos, kpos, lse, delta, same);
      float p;
      if (MASK) {
        const float v = logit(a, bias, s[j][e], qpos, kpos, same);
        p = qpos < a.Sq ? ex2((v - lse) * LOG2E) : 0.f;
      } else {
        p = ex2(fmaf(s[j][e], sl2, -lse * LOG2E));
      }
      s[j][e] = p;
      dp[j][e] = p * (dp[j][e] - delta) * a.scale;
    }
}

template <int D>
__global__ void __launch_bounds__(128, DqMma<D>::MINB)
    flash_bwd_dq_mma(FlashArgs a) {
  using C = DqMma<D>;
  constexpr int BQ = C::BR, BK = C::BC, PW = C::PW, LD = C::LD;
  constexpr int KS = D / 16, NS = PW / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Qs = (bf16 *)(smem + C::Q), *DOs = (bf16 *)(smem + C::DO);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;   // longest rows first
  const int wq0 = q0 + warp * 16;                   // the warp's first row
  const int h = blockIdx.y, b = blockIdx.z, hk = h / (a.Hq / a.Hkv);
  const size_t qs = (size_t)a.Hq * D, ks = (size_t)a.Hkv * D;
  const size_t qoff = (size_t)b * a.Sq * qs + (size_t)h * D;
  const bf16 *kp = (const bf16 *)a.k + (size_t)b * a.Sk * ks + (size_t)hk * D;
  const bf16 *vp = (const bf16 *)a.v + (size_t)b * a.Sk * ks + (size_t)hk * D;
  const float *bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                             : nullptr;
  const int nk = (a.Sk + BK - 1) / BK;
  const int nkt = a.causal ? min(nk, (q0 + BQ - 1) / BK + 1) : nk;

  auto stage = [&](int kt) {                  // K, V tile kt: one group
    bf16 *Ks = (bf16 *)(smem + C::KV + (kt & 1) * 2 * C::TILE);
    cp_rows<D>(Ks, kp, ks, kt * BK, a.Sk);
    cp_rows<D>(Ks + 64 * LD, vp, ks, kt * BK, a.Sk);
    cp_commit();
  };
  cp_rows<D>(Qs, (const bf16 *)a.q + qoff, qs, q0, a.Sq);
  cp_rows<D>(DOs, (const bf16 *)a.dout + qoff, qs, q0, a.Sq);
  if (nkt > 0) stage(0);
  cp_commit();

  // this thread's two rows (g, g + 8 of the warp's 16)
  int qpos[2], sq[2];
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = wq0 + g + 8 * i;
    const bool in = qpos[i] < a.Sq;
    const size_t row = ((size_t)b * a.Hq + h) * a.Sq + qpos[i];
    lse[i] = in ? a.lse[row] : 0.f;
    delta[i] = in ? a.delta[row] : 0.f;
    sq[i] = (a.seg_q && in) ? a.seg_q[(size_t)b * a.Sq + qpos[i]] : 0;
  }

  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kt = 0; kt < nkt; ++kt) {
    cp_wait<0>();
    __syncthreads();               // tile kt landed; tile kt - 1 is done
    if (kt + 1 < nkt) stage(kt + 1);
    const bf16 *Ks = (const bf16 *)(smem + C::KV + (kt & 1) * 2 * C::TILE);
    const bf16 *Vs = Ks + 64 * LD;
    const int k0 = kt * BK;
    // the tile's two passes, with or without the per-element masks: one
    // basic block each, so one pass's products and score math interleave
    // with the other's
    auto body = [&](auto flag) {
      constexpr bool MASK = decltype(flag)::value;
#pragma unroll
      for (int c0 = 0; c0 < BK; c0 += PW) {
        const int kp0 = k0 + c0;               // the pass's first key
        // nothing to add: every key after every row, or past Sk, or the
        // warp's rows past Sq (an unmasked tile has none of these)
        if (MASK && ((a.causal && kp0 > wq0 + 15) || kp0 >= a.Sk ||
                     wq0 >= a.Sq))
          continue;
        float s[NS][4], dp[NS][4];
        mma_abt<1, NS, KS, LD>(&s, Qs + warp * 16 * LD, Ks + c0 * LD, lane);
        mma_abt<1, NS, KS, LD>(&dp, DOs + warp * 16 * LD, Vs + c0 * LD,
                               lane);
        auto pos = [&](int j, int e, int &qp, int &kpos, float &l, float &dl,
                       bool &same) {
          qp = qpos[e >> 1];
          kpos = kp0 + j * 8 + 2 * t + (e & 1);
          l = lse[e >> 1];
          dl = delta[e >> 1];
          same = !a.seg_q ||
                 (kpos < a.Sk &&
                  sq[e >> 1] == a.seg_k[(size_t)b * a.Sk + kpos]);
        };
        softmax_grad<MASK, NS>(a, bias, s, dp, pos);
        unsigned da[PW / 16][4];
        c_to_a<PW / 16>(da, dp);
        mma_ab<1, ND, PW / 16, LD>(&acc, &da, Ks + c0 * LD, lane);  // += dS K
      }
    };
    if (bias || a.seg_q || k0 + BK > a.Sk || (a.causal && k0 + BK - 1 > wq0))
      body(Flag<true>());
    else
      body(Flag<false>());
  }
  cp_wait<0>();

  bf16 *dq = (bf16 *)a.dq + qoff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qpos[i] >= a.Sq) continue;
    bf16 *row = dq + (size_t)qpos[i] * qs + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<unsigned *>(row + j * 8) =
          pack_bf16(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(128, DkvMma<D>::MINB)
    flash_bwd_dkv_mma(FlashArgs a) {
  using C = DkvMma<D>;
  constexpr int BK = C::BR, BQ = C::BC, PW = C::PW, LD = C::LD;
  constexpr int KS = D / 16, NQ = PW / 8, ND = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Ks = (bf16 *)(smem + C::K), *Vs = (bf16 *)(smem + C::V);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int wk0 = k0 + warp * 16;                   // the warp's first row
  const int G = a.Hq / a.Hkv;
  const size_t qs = (size_t)a.Hq * D, ks = (size_t)a.Hkv * D;
  const size_t koff = (size_t)b * a.Sk * ks + (size_t)hk * D;
  const int nq = (a.Sq + BQ - 1) / BQ;
  const int qt0 = a.causal ? k0 / BQ : 0;
  const int per = max(nq - qt0, 0), total = G * per;   // (q head, q tile)

  auto stage = [&](int it) {     // Q, dO, lse, delta, seg of step it
    const int h = hk * G + it / per, q0 = (qt0 + it % per) * BQ;
    unsigned char *st = smem + C::ST + (it & 1) * C::STAGE;
    const size_t qoff = (size_t)b * a.Sq * qs + (size_t)h * D;
    const size_t roff = ((size_t)b * a.Hq + h) * a.Sq;
    cp_rows<D>((bf16 *)st, (const bf16 *)a.q + qoff, qs, q0, a.Sq);
    cp_rows<D>((bf16 *)(st + C::TILE), (const bf16 *)a.dout + qoff, qs, q0,
               a.Sq);
    float *rows = (float *)(st + 2 * C::TILE);
    const int nr = a.seg_q ? 3 * BQ : 2 * BQ;
    for (int i = threadIdx.x; i < nr; i += 128) {
      const int w = i / BQ, r = i % BQ;
      const bool in = q0 + r < a.Sq;
      const void *src = w == 0 ? (const void *)(a.lse + roff + q0 + r)
                      : w == 1 ? (const void *)(a.delta + roff + q0 + r)
                               : (const void *)(a.seg_q + (size_t)b * a.Sq +
                                                q0 + r);
      cp4(rows + i, in ? src : (const void *)a.lse, in);
    }
    cp_commit();
  };
  cp_rows<D>(Ks, (const bf16 *)a.k + koff, ks, k0, a.Sk);
  cp_rows<D>(Vs, (const bf16 *)a.v + koff, ks, k0, a.Sk);
  if (total > 0) stage(0);
  cp_commit();

  int kpos[2], sk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kpos[i] = wk0 + g + 8 * i;
    sk[i] = (a.seg_k && kpos[i] < a.Sk)
                ? a.seg_k[(size_t)b * a.Sk + kpos[i]] : 0;
  }
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_wait<0>();
    __syncthreads();               // step it landed; step it - 1 is done
    if (it + 1 < total) stage(it + 1);
    const int h = hk * G + it / per, q0 = (qt0 + it % per) * BQ;
    const unsigned char *st = smem + C::ST + (it & 1) * C::STAGE;
    const bf16 *Qs = (const bf16 *)st, *DOs = (const bf16 *)(st + C::TILE);
    const float *lse_s = (const float *)(st + 2 * C::TILE);
    const float *delta_s = lse_s + BQ;
    const int *segq = (const int *)(delta_s + BQ);
    const float *bias = a.bias ? a.bias + b * a.bias_sb + h * a.bias_sh
                               : nullptr;
    auto body = [&](auto flag) {
      constexpr bool MASK = decltype(flag)::value;
#pragma unroll
      for (int c0 = 0; c0 < BQ; c0 += PW) {
        const int qp0 = q0 + c0;               // the pass's first q row
        // nothing to add: every q row before every key, or the warp's rows
        // past Sk (an unmasked tile has none of these)
        if (MASK && ((a.causal && qp0 + PW - 1 < wk0) || wk0 >= a.Sk))
          continue;
        // S^T = K Q^T and dP^T = V dO^T: rows k, columns q
        float s[NQ][4], dp[NQ][4];
        mma_abt<1, NQ, KS, LD>(&s, Ks + warp * 16 * LD, Qs + c0 * LD, lane);
        mma_abt<1, NQ, KS, LD>(&dp, Vs + warp * 16 * LD, DOs + c0 * LD,
                               lane);
        auto pos = [&](int j, int e, int &qpos, int &kp, float &l, float &dl,
                       bool &same) {
          const int c = c0 + j * 8 + 2 * t + (e & 1);
          qpos = q0 + c;
          kp = kpos[e >> 1];
          l = lse_s[c];
          dl = delta_s[c];
          same = !a.seg_q || segq[c] == sk[e >> 1];
        };
        softmax_grad<MASK, NQ>(a, bias, s, dp, pos);
        unsigned pa[PW / 16][4], da[PW / 16][4];
        c_to_a<PW / 16>(pa, s);                         // P^T, bf16
        c_to_a<PW / 16>(da, dp);                        // dS^T, bf16
        mma_ab<1, ND, PW / 16, LD>(&dv, &pa, DOs + c0 * LD, lane);  // += P^T dO
        mma_ab<1, ND, PW / 16, LD>(&dk, &da, Qs + c0 * LD, lane);   // += dS^T Q
      }
    };
    if (bias || a.seg_q || q0 + BQ > a.Sq || (a.causal && q0 < wk0 + 15))
      body(Flag<true>());
    else
      body(Flag<false>());
  }
  cp_wait<0>();

  bf16 *dkp = (bf16 *)a.dk + koff, *dvp = (bf16 *)a.dv + koff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (kpos[i] >= a.Sk) continue;
    const size_t r = (size_t)kpos[i] * ks + 2 * t;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      *reinterpret_cast<unsigned *>(dkp + r + j * 8) =
          pack_bf16(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<unsigned *>(dvp + r + j * 8) =
          pack_bf16(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

}  // namespace flash
}  // namespace pt

namespace {

typedef void (*FlashKernel)(FlashArgs);

// A kernel instance with its block size, the rows of its own sequence that
// one block owns (the grid's x is ceil(S / rows)) and its shared-memory
// bytes, all taken from the layout of the instance picked
struct FlashPick {
  FlashKernel fn;
  int threads, rows, bytes;
};

template <class C>
FlashPick pick_of(FlashKernel fn) {
  return FlashPick{fn, C::THREADS, C::ROWS, C::BYTES};
}

using pt::bf16;
using namespace pt::flash;

// bf16: the mma.sync kernels; fp32 (the correctness lane): the FMA ones
template <int D>
FlashPick pick_fwd(int dtype) {
  return dtype == PT_BF16 ? pick_of<FwdMma<D>>(flash_fwd_mma<D>)
                          : pick_of<FwdSmem<float, D>>(flash_fwd<float, D>);
}
template <int D>
FlashPick pick_dq(int dtype) {
  return dtype == PT_BF16
             ? pick_of<DqMma<D>>(flash_bwd_dq_mma<D>)
             : pick_of<DqSmem<float, D>>(flash_bwd_dq<float, D>);
}
template <int D>
FlashPick pick_dkv(int dtype) {
  return dtype == PT_BF16
             ? pick_of<DkvMma<D>>(flash_bwd_dkv_mma<D>)
             : pick_of<DkvSmem<float, D>>(flash_bwd_dkv<float, D>);
}

// cudaErrorInvalidValue unless (dtype, D) has an instance and Hq is a
// multiple of Hkv
cudaError_t check(const FlashArgs *a) {
  if (a->Hkv <= 0 || a->Hq % a->Hkv) return cudaErrorInvalidValue;
  if (a->dtype != PT_BF16 && a->dtype != PT_F32) return cudaErrorInvalidValue;
  if (a->D != 64 && a->D != 128) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// one launch of p over ceil(S / rows) x H x B blocks; S and H are the
// sequence and the heads the grid walks (q for the forward and dq, kv for
// dk/dv)
cudaError_t run(const FlashPick &p, const FlashArgs *a, int S, int H,
                cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void *)p.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      p.bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid((S + p.rows - 1) / p.rows, H, a->B);
  p.fn<<<grid, p.threads, p.bytes, s>>>(*a);
  return cudaGetLastError();
}

}  // namespace

cudaError_t launch_flash_fwd(const FlashArgs *a, cudaStream_t s) {
  cudaError_t e = check(a);
  if (e != cudaSuccess || a->B == 0 || a->Sq == 0 || a->Hq == 0) return e;
  const FlashPick p = a->D == 64 ? pick_fwd<64>(a->dtype)
                                 : pick_fwd<128>(a->dtype);
  return count_launch(CNT_FLASH_FWD, run(p, a, a->Sq, a->Hq, s));
}

cudaError_t launch_flash_bwd_dq(const FlashArgs *a, cudaStream_t s) {
  cudaError_t e = check(a);
  if (e != cudaSuccess || a->B == 0 || a->Sq == 0 || a->Hq == 0) return e;
  const FlashPick p = a->D == 64 ? pick_dq<64>(a->dtype)
                                 : pick_dq<128>(a->dtype);
  return count_launch(CNT_FLASH_BWD_DQ, run(p, a, a->Sq, a->Hq, s));
}

cudaError_t launch_flash_bwd_dkv(const FlashArgs *a, cudaStream_t s) {
  cudaError_t e = check(a);
  if (e != cudaSuccess || a->B == 0 || a->Sk == 0 || a->Hkv == 0) return e;
  const FlashPick p = a->D == 64 ? pick_dkv<64>(a->dtype)
                                 : pick_dkv<128>(a->dtype);
  return count_launch(CNT_FLASH_BWD_DKV, run(p, a, a->Sk, a->Hkv, s));
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
