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
// bytes.  With fp32 x and a bf16 w (the GPT step: its final LayerNorm has
// fp32 gains, its tied head is bf16) z runs as two bf16 products and dw
// as three (the split below).
//
// The bf16 products (linear_ce_fwd_wg, linear_ce_dz_wg, linear_ce_dx_wg,
// linear_ce_dw_wg): one persistent warp-specialized GEMM for sm_90a, four
// epilogues.  z = x w^T (fwd, dz) has both operands K-major, the layout
// TMA and wgmma take with no transpose; dx = dz w_slab has B = w_slab
// [C, H] MN-major (H contiguous), dw = dz^T x both operands MN-major
// (dz [T, C] read as A(c, t), x [T, H]): wgmma's transpose bits, each
// MN-major operand loaded as boxes of 64 MN columns x 64 K rows.
//   * Tiles of 128 x 256 outputs (x or dz rows by w rows, x or dz rows by
//     H, slab rows by H), K in 64-deep steps; a producer warpgroup keeps a
//     4-stage ring of TMA boxes (16 KB of A, 32 KB of B, 128-byte swizzle)
//     in flight on mbarriers; two consumer warpgroups each run wgmma
//     m64n256k16 with both operands from shared memory into a 64 x 256
//     fp32 accumulator (128 registers a thread; setmaxnreg moves registers
//     from the producer to them).  Rows, columns and K past the tensors
//     are TMA's zero fill, so every H % 8 == 0, T and slab width runs here.
//   * Persistent: one block an SM walks the tiles, 32 row blocks at a
//     time across the vocab, so the blocks in flight share their x and w
//     tiles in L2 (w streams from HBM once a group).  The L2 stream, 3 MB
//     a tile against 268 MFLOP, is about the L2's rate at 989 TFLOP/s: the
//     copies alone take about the forward's time (tools/lce_ab.py; a
//     2-block cluster multicasting each w box, 2 MB a tile, measured
//     slower on the H100).
//   * linear_ce_fwd's epilogue works on the accumulator in registers: per
//     row of the tile its max (a quad shuffle over the 4 threads of a
//     row), sum of exp(z - max), label logit and (smoothing) sum of z,
//     written as one fp32 partial a row and vocab tile.  The block that
//     takes a row block's last ticket (__threadfence, atomicAdd; it resets
//     the ticket) folds that row block's partials in vocab-tile order, so
//     nll and lse do not depend on the schedule; one launch a call.
//   * linear_ce_dz's epilogue forms dz = g (exp(z - lse) - y) in registers
//     and stores bf16 pairs straight from the accumulator layout.
//   * linear_ce_dx's epilogue adds the tile into the fp32 [T, H] dx_acc
//     (reads it unless the slab is the first; the last slab writes dx in
//     x's dtype instead), 32 bytes of a row a thread after a quad
//     transpose; the producer meanwhile loads the next tile's first K
//     steps.  dx_acc moves 268 MB a slab at the Llama head, and the SMs
//     reach their epilogues together, so the epilogue runs at HBM's rate
//     (about a quarter of dx's time); staging the tile in shared memory
//     for TMA's reduce-add in L2 measured only 5 % faster (PERF.md).
//     linear_ce_dw's epilogue stores the tile (slab rows by H) in w's
//     dtype.
//     Routing: linear_ce_fwd and linear_ce_dz run here whenever w is
//     bf16 (fp32 x through the split below), linear_ce_dx whenever w is
//     bf16 (so dz_w is: the Llama head and the GPT head's fp32-x dx),
//     linear_ce_dw whenever x is bf16 (dz_x and x are; fp32 x with bf16 w
//     through the split below); dw is written in w's dtype either way.
//   * fp32 x with bf16 w (linear_ce_fwd_split, linear_ce_dz_split,
//     linear_ce_dw_split): the TPU kernels' dots of fp32 x and of fp32 dz
//     with bf16 w are fp32-accurate, so neither is rounded to bf16.
//     linear_ce_split_x writes xs [2, T, H] bf16, x_hi = bf16(x) and x_lo =
//     bf16(x - x_hi) (x - x_hi is exact in fp32, and the pair holds x to
//     2^-17 of its value), once a forward and once a backward call; z =
//     x_hi w^T + x_lo w^T is two bf16 products, each product exact and the
//     sum in fp32.  The same body reads xs through a 3-D tensor map
//     [2][T][H]: each of 3 stages holds the two halves' boxes of a K step
//     beside one w box (16 + 16 + 32 KB), and the consumers multiply the w
//     box by x_hi, then x_lo, for each k16 into one accumulator, so w
//     streams once for both products: 0.79 MB from L2 a 101 MFLOP tile at
//     H 768, against 1.18 MB were the lo pass to reload it
//     (tools/lce_ab.py's reload_w: 3 % of the forward's time).  dz's
//     epilogue stores dz in halves too: dz_w = bf16(dz) (dx's operand) and
//     beside it dz_lo = bf16(dz - dz_w), one [2, T, ldz] buffer, and
//     linear_ce_dw_split (below) forms dz^T x as dz_hi^T x_hi + dz_hi^T x_lo
//     + dz_lo^T x_hi, three bf16 products with T split over a cluster of
//     blocks (2 at the GPT head).
// Every other instance (fwd and dz with fp32 w; dx with fp32 w; dw with
// fp32 x and w) keeps the first version's design:
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
//   * One tiled product (Mma below) serves them: 8 warps, 32-deep K
//     slabs staged in shared memory, the next slab prefetched into
//     registers, FMA in fp32 with bf16 operands converted to fp32 on their
//     way into shared memory.
// The wrapper checks H % 8 == 0 and 16-byte aligned, contiguous operands;
// the dz scratch has a leading dimension ldz rounded up to 8 with zeros in
// its padding columns, so every 16-byte load is either wholly in bounds or
// wholly out.
#include <atomic>
#include <mutex>
#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace pt {
namespace lce {

constexpr float NEG_INF = -1e30f;
constexpr int THREADS = 256;               // 8 warps
constexpr int BK = 32;                     // K slab
constexpr int FWD_BM = 64, FWD_BN = 128;   // forward: rows, vocab tile
constexpr int BW_BM = 128, BW_BN = 128;    // backward product tiles

__host__ __device__ inline int cdiv(int n, int d) { return (n + d - 1) / d; }

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

// One block's output tile C[BM x BN] = sum_k A(m, k) B(k, n) on FMA,
// written fp32 to shared memory Cs (leading dimension LDC).  A(m, k) is
// A[m * lda + k] (A_ROW) or A[k * lda + m]; B(k, n) is B[k * ldb + n]
// (B_ROW) or B[n * ldb + k].  Elements with m >= Mv or k >= Ka (A),
// k >= Kb or n >= Nv (B) read as zero; the bound along each operand's
// contiguous dimension must be a multiple of its 16-byte vector.  The
// bf16 x bf16 products run on wgmma (Wg below), so at least one operand
// is fp32 here.
template <typename TA, typename TB, bool A_ROW, bool B_ROW, int BM, int BN>
struct Mma {
  static_assert(std::is_same<TA, float>::value ||
                    std::is_same<TB, float>::value,
                "bf16 x bf16 runs on wgmma");
  using S = float;
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
  // 16 x 16 threads, each TM x TN outputs strided by 16
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

// ======================================================== wgmma + TMA
// The bf16 products on one persistent warp-specialized GEMM, one
// epilogue each: z = x w^T with the row statistics (linear_ce_fwd) or dz
// (linear_ce_dz), dx += dz w_slab (linear_ce_dx), dw_slab = dz^T x
// (linear_ce_dw).
enum { EPI_FWD = 0, EPI_DZ = 1, EPI_DX = 2, EPI_DW = 3 };

// the product's output rows (M), columns (N) and depth (K)
struct Gemm {
  int rows, cols, depth;
};
template <int EPI>
__host__ __device__ __forceinline__ Gemm gemm_of(const LceArgs &a) {
  if (EPI == EPI_FWD) return {a.T, a.V, a.H};
  if (EPI == EPI_DZ) return {a.T, a.ldz, a.H};
  if (EPI == EPI_DX) return {a.T, a.H, a.width};
  return {a.width, a.H, a.T};
}

// the tile shape; SPLIT, the fp32-x route: a stage holds the x box of
// both halves of x (x_hi, x_lo) beside the one w box
template <bool SPLIT>
struct WgOf {
  static constexpr int BM = 128, BN = 256, BK = 64;  // tile rows, columns, K
  static constexpr int XT = BM * BK * 2;     // A tile: 16 KB
  static constexpr int WT = BN * BK * 2;     // B tile: 32 KB
  static constexpr int MNB = 64 * BK * 2;    // an MN-major box: 8 KB
  static constexpr int XS = SPLIT ? 2 : 1;   // A tiles a stage
  static constexpr int STAGE = XS * XT + WT;
  static constexpr int STAGES = SPLIT ? 3 : 4;
  static constexpr int THREADS = 384;        // 2 consumer warpgroups + producer
  static constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 232;
  static constexpr int GROUP = 32;           // row blocks a group of the order
  static constexpr int SMEM =
      1024 + STAGES * STAGE + 2 * STAGES * 8 + BM * 16 + 16;
  static_assert(SMEM <= 232448, "one block an SM");
};
using Wg = WgOf<false>;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tile u of the walk -> its row block mb and vocab tile nb: groups of G
// row blocks sweep the vocab together, so the blocks in flight share
// their x and w tiles in L2
__device__ __forceinline__ void tile_of(int u, int MB, int NB, int G, int &mb,
                                        int &nb) {
  const int per = G * NB, grp = u / per, r = u - grp * per;
  const int first = grp * G, gs = min(MB - first, G);
  mb = first + r % gs;
  nb = r / gs;
}

// The last block to finish row block m0's vocab tiles folds their
// partials (m, s, zl, sz) in vocab-tile order: thread h * 128 + r folds
// half h of row r's tiles, half 1 hands its fold to half 0 through `comb`
__device__ __forceinline__ void fold(float4 &acc, float4 p) {
  const float m = fmaxf(acc.x, p.x);
  acc.y = acc.y * expf(acc.x - m) + p.y * expf(p.x - m);
  acc.x = m;
  acc.z += p.z;
  acc.w += p.w;
}
__device__ void merge_rows(const LceArgs &a, const float4 *part, float4 *comb,
                           int m0, int NB, int ctid) {
  const int r = ctid & 127, h = ctid >> 7, t = m0 + r;
  const int half = (NB + 1) / 2, b0 = h * half, b1 = min(NB, b0 + half);
  float4 f = make_float4(NEG_INF, 0.f, 0.f, 0.f);
  if (t < a.T) {
#pragma unroll 4
    for (int b = b0; b < b1; ++b) fold(f, __ldcg(part + (size_t)b * a.T + t));
  }
  if (h) comb[r] = f;
  consumer_sync();
  if (h || t >= a.T) return;
  fold(f, comb[r]);
  const float lse = f.x + logf(f.y);
  const int lab = a.labels[t];
  float nll = a.eps > 0.f
                  ? lse - (1.f - a.eps) * f.z - (a.eps / a.V) * f.w
                  : lse - f.z;
  if (a.has_ignore && lab == a.ignore_index) nll = 0.f;
  a.nll[t] = nll;
  a.lse[t] = lse;
}

constexpr float L2E = 1.4426950408889634f;

// Consumer thread ctid (warp w of 8, lane 4g + tq; warpgroup w >> 2 owns
// rows 64 (w >> 2) of the block's 128) holds D rows r0 = m0 + 16 w + g
// and r0 + 8 (h = 0, 1), acc[4j + 2h + e] at tile column 8j + 2tq + e
// (wgmma.cuh's D layout).
__device__ __forceinline__ void epi_fwd(const LceArgs &a, float (&acc)[128],
                                        int m0, int n0, int nb, int NB, int mb,
                                        int ctid, float4 *comb, int *flag) {
  const int lane = ctid & 31, warp = ctid >> 5, tq = lane & 3;
  const int r0 = m0 + 16 * warp + (lane >> 2);
  const bool edge = n0 + Wg::BN > a.V;
  const int nv = a.V - n0 - 2 * tq;          // column 8j + e in V iff < nv
  float4 *part = reinterpret_cast<float4 *>(a.part);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = r0 + 8 * h;
    const int c = (t < a.T ? a.labels[t] : -1) - n0;  // the label's column
    float zl = 0.f, sz = 0.f;
    if (c >= 0 && c < Wg::BN && c < a.V - n0 && ((c >> 1) & 3) == tq) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if ((c >> 3) == j) zl = (c & 1) ? acc[4 * j + 2 * h + 1] : acc[4 * j + 2 * h];
    }
    if (a.eps > 0.f) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (!edge || 8 * j + e < nv) sz += acc[4 * j + 2 * h + e];
    }
    if (edge) {
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e >= nv) acc[4 * j + 2 * h + e] = NEG_INF;
    }
    float m = NEG_INF;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      m = fmaxf(m, fmaxf(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float mo = -m * L2E;
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      s += ex2(fmaf(acc[4 * j + 2 * h], L2E, mo)) +
           ex2(fmaf(acc[4 * j + 2 * h + 1], L2E, mo));
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      zl += __shfl_xor_sync(0xffffffffu, zl, o);
      sz += __shfl_xor_sync(0xffffffffu, sz, o);
    }
    if (tq == 0 && t < a.T)
      part[(size_t)nb * a.T + t] = make_float4(m, s, zl, sz);
  }
  // the ticket: the block that takes the row block's last one folds it.
  // The barrier orders every thread's partials before thread 0's fence
  // and ticket (release); thread 0's fence after the last ticket orders
  // the other blocks' partials before the barrier and the folds (acquire)
  consumer_sync();
  if (ctid == 0) {
    __threadfence();
    const int last = atomicAdd(a.tickets + mb, 1) == NB - 1;
    if (last) {
      a.tickets[mb] = 0;                     // ready for the next call
      __threadfence();
    }
    *flag = last;
  }
  consumer_sync();
  if (*flag) merge_rows(a, part, comb, m0, NB, ctid);
}

// v[k] of quad lane q becomes lane k's v[q] (a 4 x 4 transpose over the
// lanes tq of a quad): two butterflies, each swapping the words whose
// index bit differs from the lane's
__device__ __forceinline__ void quad_transpose(unsigned (&v)[4], int tq) {
#pragma unroll
  for (int b = 1; b <= 2; b <<= 1) {
    const bool hi = tq & b;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      // the slot of pair m whose bit b is not the lane's
      const int k0 = b == 1 ? 2 * m : m, k1 = k0 + b;
      const unsigned send = hi ? v[k0] : v[k1];
      const unsigned got = __shfl_xor_sync(0xffffffffu, send, b);
      if (hi)
        v[k0] = got;
      else
        v[k1] = got;
    }
  }
}

// the 8 values of D row 8h + g at tile columns 8j .. 8j + 7, j = 4i + tq:
// the quad holds them as pairs, and two quad transposes (even and odd
// columns) hand thread tq all 8
__device__ __forceinline__ void row8(const float (&acc)[128], int h, int i,
                                     int tq, float (&v)[8]) {
  unsigned lo[4], hi[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    lo[k] = __float_as_uint(acc[4 * (4 * i + k) + 2 * h]);
    hi[k] = __float_as_uint(acc[4 * (4 * i + k) + 2 * h + 1]);
  }
  quad_transpose(lo, tq);
  quad_transpose(hi, tq);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[2 * q] = __uint_as_float(lo[q]);
    v[2 * q + 1] = __uint_as_float(hi[q]);
  }
}

__device__ __forceinline__ void store8(float *dst, const float (&v)[8]) {
  float4 *d = reinterpret_cast<float4 *>(dst);
  d[0] = make_float4(v[0], v[1], v[2], v[3]);
  d[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(bf16 *dst, const float (&v)[8]) {
  *reinterpret_cast<uint4 *>(dst) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// dz = g (p - y) into dz_w (bf16) and dz_x: one buffer on the bf16 route
// (x's dtype is w's); on the split route dz_w is dz's high half bf16(dz)
// and dz_x its low half bf16(dz - dz_hi) (the difference is exact in
// fp32; the pair holds dz to 2^-17 of its value), which linear_ce_dw_split
// multiplies by x's halves
template <bool SPLIT>
__device__ __forceinline__ void epi_dz(const LceArgs &a, float (&acc)[128],
                                       int m0, int n0, int ctid) {
  const int lane = ctid & 31, warp = ctid >> 5, tq = lane & 3;
  const int r0 = m0 + 16 * warp + (lane >> 2);
  const bool edge = n0 + Wg::BN > a.width;
  const int nw = a.width - n0 - 2 * tq;      // column 8j + e in the slab iff < nw
  const float u = a.eps / a.V;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = r0 + 8 * h;
    const bool ok = t < a.T;
    const float lz = ok ? a.lse[t] * L2E : 0.f, gg = ok ? a.g[t] : 0.f;
    const int c = (ok ? a.labels[t] : -1) - a.c0 - n0;
    const float gu = gg * u;
#pragma unroll
    for (int j = 0; j < 32; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float &z = acc[4 * j + 2 * h + e];
        z = fmaf(gg, ex2(fmaf(z, L2E, -lz)), -gu);   // g (p - eps / V)
      }
    if (c >= 0 && c < Wg::BN && c < a.width - n0 && ((c >> 1) & 3) == tq) {
      const float gy = gg * (1.f - a.eps);
#pragma unroll
      for (int j = 0; j < 32; ++j)
        if ((c >> 3) == j) {
          if (c & 1)
            acc[4 * j + 2 * h + 1] -= gy;
          else
            acc[4 * j + 2 * h] -= gy;
        }
    }
    if (edge) {                              // padding columns stay zero
#pragma unroll
      for (int j = 0; j < 32; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (8 * j + e >= nw) acc[4 * j + 2 * h + e] = 0.f;
    }
    // the quad's 4 threads hold columns 8j .. 8j + 7 of the row as one
    // bf16 pair each: transpose each group of 4 j among them, so thread tq
    // stores the 16 bytes of j = 4i + tq (a warp: 8 rows x 64 bytes)
    uint4 *pw = reinterpret_cast<uint4 *>((bf16 *)a.dz_w + (size_t)t * a.ldz + n0);
    uint4 *px = reinterpret_cast<uint4 *>((bf16 *)a.dz_x + (size_t)t * a.ldz + n0);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      unsigned v[4], l[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d0 = acc[4 * (4 * i + k) + 2 * h];
        const float d1 = acc[4 * (4 * i + k) + 2 * h + 1];
        v[k] = pack_bf16(d0, d1);
        if constexpr (SPLIT)                 // dz - dz_hi, exact in fp32
          l[k] = pack_bf16(d0 - __uint_as_float(v[k] << 16),
                           d1 - __uint_as_float(v[k] & 0xffff0000u));
      }
      quad_transpose(v, tq);
      if constexpr (SPLIT) quad_transpose(l, tq);
      if (ok && (!edge || 8 * (4 * i + tq) < a.ldz - n0)) {
        const uint4 q = make_uint4(v[0], v[1], v[2], v[3]);
        pw[4 * i + tq] = q;
        if constexpr (SPLIT)
          px[4 * i + tq] = make_uint4(l[0], l[1], l[2], l[3]);
        else if (a.dz_x != a.dz_w)
          px[4 * i + tq] = q;
      }
    }
  }
}

// dx: v = the tile (+ dx_acc, unless the slab is the first); the last
// slab writes v to dx in x's dtype, the others to dx_acc.  Thread tq moves
// 8 columns of a row (32 bytes of dx_acc) at a time; each row half's
// dx_acc loads are all issued before the first store
__device__ __forceinline__ void epi_dx(const LceArgs &a, float (&acc)[128],
                                       int m0, int n0, int ctid) {
  const int lane = ctid & 31, warp = ctid >> 5, tq = lane & 3;
  const int r0 = m0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = r0 + 8 * h;
    float *row = a.dx_acc + (size_t)t * a.H + n0;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 old[16];
#pragma unroll
    for (int i = 0; i < 8; ++i) {            // H % 8: 8 columns in or out
      const bool ok = t < a.T && n0 + 8 * (4 * i + tq) < a.H;
      const float4 *src =
          reinterpret_cast<const float4 *>(row + 8 * (4 * i + tq));
      old[2 * i] = ok && !a.first ? src[0] : zero;
      old[2 * i + 1] = ok && !a.first ? src[1] : zero;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v[8];
      row8(acc, h, i, tq, v);
      const int c = 8 * (4 * i + tq);
      if (t >= a.T || n0 + c >= a.H) continue;
      if (!a.first) {
        v[0] += old[2 * i].x, v[1] += old[2 * i].y;
        v[2] += old[2 * i].z, v[3] += old[2 * i].w;
        v[4] += old[2 * i + 1].x, v[5] += old[2 * i + 1].y;
        v[6] += old[2 * i + 1].z, v[7] += old[2 * i + 1].w;
      }
      const size_t o = (size_t)t * a.H + n0 + c;
      if (!a.last)
        store8(row + c, v);
      else if (a.x_dtype == PT_BF16)
        store8((bf16 *)a.dx + o, v);
      else
        store8((float *)a.dx + o, v);          // dx is dx_acc for fp32 x
    }
  }
}

// dw: slab rows c0 + v < c0 + width, columns h < H, in w's dtype; a
// thread stores 8 columns of a row at a time after the quad transpose
__device__ __forceinline__ void epi_dw(const LceArgs &a, float (&acc)[128],
                                       int m0, int n0, int ctid) {
  const int lane = ctid & 31, warp = ctid >> 5, tq = lane & 3;
  const int r0 = m0 + 16 * warp + (lane >> 2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = r0 + 8 * h;
    const size_t row = (size_t)(a.c0 + v) * a.H + n0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * (4 * i + tq);
      const bool ok = v < a.width && n0 + c < a.H;
      if (a.w_dtype == PT_BF16) {
        unsigned p[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          p[k] = pack_bf16(acc[4 * (4 * i + k) + 2 * h],
                           acc[4 * (4 * i + k) + 2 * h + 1]);
        quad_transpose(p, tq);
        if (ok)
          *reinterpret_cast<uint4 *>((bf16 *)a.dw + row + c) =
              make_uint4(p[0], p[1], p[2], p[3]);
      } else {
        float f[8];
        row8(acc, h, i, tq, f);
        if (ok) store8((float *)a.dw + row + c, f);
      }
    }
  }
}

// A [M, K] and B [K, N] through the tensor maps ta / tb: K-major (z = x
// w^T: boxes of 64 K columns by 128 / 256 rows) or MN-major (B of dx, A
// and B of dw: boxes of 64 MN columns by 64 K rows, two a stage of A,
// four of B).  SPLIT (z = x w^T with fp32 x): ta is the 3-D map of xs
// [2][T][H], a stage holds the x_hi and x_lo boxes, then the w box
template <int EPI, bool SPLIT = false>
__device__ __forceinline__ void wg_body(const LceArgs &a, const CUtensorMap *ta,
                                        const CUtensorMap *tb) {
  using C = WgOf<SPLIT>;
  constexpr bool MN_A = EPI == EPI_DW, MN_B = EPI == EPI_DX || EPI == EPI_DW;
  static_assert(!SPLIT || EPI == EPI_FWD || EPI == EPI_DZ, "z = x w^T only");
  constexpr int BOFF = C::XS * C::XT;        // the B tile in a stage
  extern __shared__ unsigned char smem_raw[];
  unsigned char *smem = reinterpret_cast<unsigned char *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + C::STAGES * C::STAGE);
  uint64_t *empty = full + C::STAGES;
  float4 *comb = reinterpret_cast<float4 *>(empty + C::STAGES);
  int *flag = reinterpret_cast<int *>(comb + C::BM);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Gemm g = gemm_of<EPI>(a);
  const int MB = cdiv(g.rows, C::BM), NB = cdiv(g.cols, C::BN);
  const int tiles = MB * NB, nk = cdiv(g.depth, C::BK);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);               // each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {                           // producer warpgroup
    regs_dec<C::REGS_PRODUCER>();
    if (warp == 8 && lane == 0) {
      int it = 0;
      for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
        int mb, nb;
        tile_of(u, MB, NB, C::GROUP, mb, nb);
        const int m0 = mb * C::BM, n0 = nb * C::BN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int s = it % C::STAGES, round = it / C::STAGES;
          if (round) mbar_wait_or_trap(&empty[s], (round - 1) & 1);
          unsigned char *st = smem + s * C::STAGE;
          mbar_expect_tx(&full[s], C::STAGE);
          if constexpr (SPLIT) {
#pragma unroll
            for (int h = 0; h < C::XS; ++h)  // x_hi, x_lo: slices of xs
              tma_load_3d(st + h * C::XT, ta, kb * C::BK, m0, h, &full[s]);
          } else if constexpr (MN_A) {
            tma_load_2d(st, ta, m0, kb * C::BK, &full[s]);
            tma_load_2d(st + C::MNB, ta, m0 + 64, kb * C::BK, &full[s]);
          } else {
            tma_load_2d(st, ta, kb * C::BK, m0, &full[s]);
          }
          if constexpr (MN_B) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              tma_load_2d(st + BOFF + j * C::MNB, tb, n0 + 64 * j, kb * C::BK,
                          &full[s]);
          } else {
            tma_load_2d(st + BOFF, tb, kb * C::BK, n0, &full[s]);
          }
        }
      }
    }
    return;
  }
  regs_inc<C::REGS_CONSUMER>();

  const int wg = warp >> 2;
  float acc[128];
  auto release = [&](int s) {
    if (lane == 0) mbar_arrive(&empty[s]);
  };
  int it = 0;
  for (int u = blockIdx.x; u < tiles; u += gridDim.x) {
    int mb, nb;
    tile_of(u, MB, NB, C::GROUP, mb, nb);
    const int m0 = mb * C::BM, n0 = nb * C::BN;
    for (int kb = 0; kb < nk; ++kb, ++it) {
      const int s = it % C::STAGES;
      mbar_wait_or_trap(&full[s], (it / C::STAGES) & 1);
      const unsigned char *st = smem + s * C::STAGE;
      // a k16 slice is 32 bytes along a K-major row, 16 rows (2048 bytes)
      // of an MN-major box: 2 or 128 in the descriptor's 16-byte units
      const uint64_t da = MN_A ? desc_sw128_mn(st + wg * C::MNB, C::MNB)
                               : desc_sw128(st + wg * (C::XT / 2));
      const uint64_t db = MN_B ? desc_sw128_mn(st + BOFF, C::MNB)
                               : desc_sw128(st + BOFF);
      // the x_lo box's rows of this warpgroup, C::XT bytes past x_hi's
      const uint64_t dl = SPLIT ? da + (C::XT >> 4) : 0;
      constexpr int SA = MN_A ? 128 : 2, SB = MN_B ? 128 : 2;
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        WgmmaSS256<MN_A, MN_B>::mma(acc, da + SA * kk, db + SB * kk,
                                    kb > 0 || kk > 0);
        if constexpr (SPLIT)                 // x_lo against the same w box
          WgmmaSS256<>::mma(acc, dl + 2 * kk, db + 2 * kk, 1);
      }
      wg_commit();
      wg_wait<1>();
      // the wgmmas of the previous stage have retired: hand its slot back
      if (kb > 0) release((it - 1) % C::STAGES);
    }
    wg_wait<0>();
    fence_regs(acc);
    release((it - 1) % C::STAGES);
    if constexpr (EPI == EPI_FWD)
      epi_fwd(a, acc, m0, n0, nb, NB, mb, tid, comb, flag);
    else if constexpr (EPI == EPI_DZ)
      epi_dz<SPLIT>(a, acc, m0, n0, tid);
    else if constexpr (EPI == EPI_DX)
      epi_dx(a, acc, m0, n0, tid);
    else
      epi_dw(a, acc, m0, n0, tid);
  }
}

__global__ void __launch_bounds__(Wg::THREADS, 1)
    linear_ce_fwd_wg(const LceArgs a, const __grid_constant__ CUtensorMap ta,
                     const __grid_constant__ CUtensorMap tb) {
  wg_body<EPI_FWD>(a, &ta, &tb);
}

__global__ void __launch_bounds__(Wg::THREADS, 1)
    linear_ce_dz_wg(const LceArgs a, const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb) {
  wg_body<EPI_DZ>(a, &ta, &tb);
}

__global__ void __launch_bounds__(Wg::THREADS, 1)
    linear_ce_dx_wg(const LceArgs a, const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb) {
  wg_body<EPI_DX>(a, &ta, &tb);
}

__global__ void __launch_bounds__(Wg::THREADS, 1)
    linear_ce_dw_wg(const LceArgs a, const __grid_constant__ CUtensorMap ta,
                    const __grid_constant__ CUtensorMap tb) {
  wg_body<EPI_DW>(a, &ta, &tb);
}

// fp32 x with bf16 w: ta is the map of xs [2][T][H]
__global__ void __launch_bounds__(Wg::THREADS, 1)
    linear_ce_fwd_split(const LceArgs a, const __grid_constant__ CUtensorMap ta,
                        const __grid_constant__ CUtensorMap tb) {
  wg_body<EPI_FWD, true>(a, &ta, &tb);
}

__global__ void __launch_bounds__(Wg::THREADS, 1)
    linear_ce_dz_split(const LceArgs a, const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb) {
  wg_body<EPI_DZ, true>(a, &ta, &tb);
}

// ------------------------------- the split route's dw: three bf16 products
// dw_slab [C, H] = dz^T x with fp32 x and bf16 w, as dz_hi^T x_hi +
// dz_hi^T x_lo + dz_lo^T x_hi in one fp32 accumulator (each product exact
// in fp32; the dropped dz_lo^T x_lo is at most 2^-16 of |dz x|).  Both
// operands are MN-major: A(c, t) from the dz halves [2][T][ldz], B(t, h)
// from xs [2][T][H], each read through a 3-D tensor map in boxes of 64 MN
// columns x BK rows of T.  A tile is 128 slab rows x 192 columns of H
// (two consumer warpgroups on wgmma m64n192k16, 96 fp32 accumulators a
// thread): at the GPT head (slabs of 2048, H 768) 64 tiles a slab, too
// few and too deep (K = T = 8192) for 132 SMs, so T is split over a
// thread-block cluster of S blocks (grid x; dw_plan picks S from the
// clusters the device keeps resident: S 2, 128 blocks, at the GPT head).
// One tile a cluster, so the ring is idle after the mainloop: each block
// stages its fp32 partial tile there, bulk-copies each peer's 1/S of the
// rows into that peer's receive slots (gemm.cu's fold), and sums its own
// rows over the S partials in split order, so two calls are bit-identical;
// it stores them as bf16 rows of dw.  A stage holds dz_hi, dz_lo (8 KB
// each at BK 32), x_hi and x_lo (12 KB each): per k16 each warpgroup
// issues the three wgmmas on them.  The TMA stream, 10.7 GB from L2 a
// call at the GPT head, takes nearly as long as the products: with dz_hi
// x_hi alone (the loads kept) the kernel keeps most of its time
// (tools/lce_ab.py's dw_one_term, PERF.md section 6).
template <int BK_, int STAGES_>
struct DwSplitOf {
  static constexpr int BM = 128, BN = 192, BK = BK_, STAGES = STAGES_;
  static constexpr int MAX_SPLITS = 4;       // cluster size, K splits
  static constexpr int BOX = 64 * BK * 2;    // 64 MN columns x BK rows
  static constexpr int AT = 2 * BOX;         // one half's A tile (128 rows)
  static constexpr int BT = 3 * BOX;         // one half's B tile (192 columns)
  static constexpr int STAGE = 2 * AT + 2 * BT;
  static constexpr int LDR = BN + 8;         // fp32 words a staged row
  static constexpr int ROWB = LDR * 4;
  static constexpr int RED = BM * ROWB;      // this block's partial tile
  // the peers' row slices, S - 1 slots of ceil(BM / S) rows (<= 96 rows)
  static constexpr int RECV = 96 * ROWB;
  static constexpr int BODY =
      STAGES * STAGE > RED + RECV ? STAGES * STAGE : RED + RECV;
  static constexpr int THREADS = 384;        // 2 consumer warpgroups + producer
  static constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 232;
  static constexpr int SMEM = 1024 + BODY + (2 * STAGES + 1) * 8;
  static_assert(STAGE % 1024 == 0 && BOX % 1024 == 0, "1024-byte aligned");
  static_assert(BK % 16 == 0 && ROWB % 16 == 0, "k16 steps, 16-byte rows");
  static_assert(SMEM <= 232448, "one block an SM");
};
using DwSplit = DwSplitOf<32, 4>;          // 4 stages of 40 KB: measured fastest

// One tile: slab rows m0 = blockIdx.y * BM, H columns n0 = blockIdx.z * BN,
// T split blockIdx.x of gridDim.x (the cluster).  tz maps the dz halves
// [2][T][width] (row stride ldz, the halves dz_x - dz_w bytes apart), tx
// maps xs [2][T][H]; rows of T, slab rows and columns past the tensors
// are TMA's zero fill, stores masked.
template <class C>
__device__ __forceinline__ void dw_split_body(const LceArgs &a,
                                              const CUtensorMap *tz,
                                              const CUtensorMap *tx) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char *smem = reinterpret_cast<unsigned char *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + C::BODY);
  uint64_t *empty = full + C::STAGES;
  uint64_t *recv_bar = empty + C::STAGES;
  float *red = reinterpret_cast<float *>(smem);             // [BM][LDR]
  float *recv = reinterpret_cast<float *>(smem + C::RED);   // [S - 1][R][LDR]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = gridDim.x, rank = blockIdx.x;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.z * C::BN;
  const int nk = cdiv(a.T, C::BK);
  const int kb0 = (int)((long long)nk * rank / S);
  const int kb1 = (int)((long long)nk * (rank + 1) / S);
  // the tile rows this block folds: [r0, r0 + nr), R a rank; peer q's
  // slice of them lands in slot q (q < rank) or q - 1
  const int R = cdiv(C::BM, S), r0 = rank * R;
  const int nr = max(0, min(C::BM, r0 + R) - r0);
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);               // each consumer warp
    }
    mbar_init(recv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {                           // producer warpgroup
    regs_dec<C::REGS_PRODUCER>();
    if (warp == 8 && lane == 0) {
      for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
        const int s = it % C::STAGES, round = it / C::STAGES;
        if (round) mbar_wait_or_trap(&empty[s], (round - 1) & 1);
        unsigned char *st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        const int k = kb * C::BK;
#pragma unroll
        for (int hl = 0; hl < 2; ++hl) {     // the high half, then the low
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tma_load_3d(st + hl * C::AT + j * C::BOX, tz, m0 + 64 * j, k, hl,
                        &full[s]);
#pragma unroll
          for (int j = 0; j < 3; ++j)
            tma_load_3d(st + 2 * C::AT + hl * C::BT + j * C::BOX, tx,
                        n0 + 64 * j, k, hl, &full[s]);
        }
      }
    }
    // the fold's two cluster barriers (below), without its work: code
    // past a merge would be compiled to the producer's 40 registers
    cluster_arrive();
    cluster_wait();
    cluster_arrive_relaxed();
    cluster_wait();
    return;
  }
  regs_inc<C::REGS_CONSUMER>();
  const int wg = warp >> 2;
  float acc[96];
  for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
    const int s = it % C::STAGES;
    mbar_wait_or_trap(&full[s], (it / C::STAGES) & 1);
    const unsigned char *st = smem + s * C::STAGE;
    // this warpgroup's 64 slab rows of dz_hi (dz_lo AT bytes on), the 192
    // columns of x_hi (x_lo BT bytes on), 3 boxes BOX bytes apart; a k16
    // slice is 16 rows of T, 2048 bytes, 128 descriptor units
    const uint64_t ah = desc_sw128_mn(st + wg * C::BOX, C::BOX);
    const uint64_t al = ah + (C::AT >> 4);
    const uint64_t bh = desc_sw128_mn(st + 2 * C::AT, C::BOX);
    const uint64_t bl = bh + (C::BT >> 4);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk) {
      WgmmaSS<192, 1, 1>::mma(acc, ah + 128 * kk, bh + 128 * kk,
                              it > 0 || kk > 0);
      WgmmaSS<192, 1, 1>::mma(acc, ah + 128 * kk, bl + 128 * kk, 1);
      WgmmaSS<192, 1, 1>::mma(acc, al + 128 * kk, bh + 128 * kk, 1);
    }
    wg_commit();
    wg_wait<1>();
    // the wgmmas of the previous stage have retired: hand its slot back
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % C::STAGES]);
  }
  wg_wait<0>();
  fence_regs(acc);
  // both warpgroups are done with the ring: stage the partial tile in it
  // as red[slab row][column] (row 16 warp + g + 8h, register 4j + 2h + e
  // at column 8j + 2tq + e), a float2 a store, for the bulk copies
  consumer_sync();
  {
    const int g = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float *row = red + (16 * warp + g + 8 * h) * C::LDR + 2 * tq;
#pragma unroll
      for (int j = 0; j < C::BN / 8; ++j)
        *reinterpret_cast<float2 *>(row + 8 * j) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  fence_proxy_async_smem();
  if (tid == 0 && S > 1 && nr > 0)
    mbar_expect_tx(recv_bar, (S - 1) * nr * C::ROWB);
  cluster_arrive();             // every partial staged, every ring idle
  cluster_wait();
  if (tid == 0 && S > 1) {
    for (int d = 0; d < S; ++d) {
      const int dn = max(0, min(C::BM, d * R + R) - d * R);
      const int slot = rank < d ? rank : rank - 1;
      if (d != rank && dn > 0)
        bulk_to_peer(peer_u32(recv + slot * R * C::LDR, d),
                     red + d * R * C::LDR, dn * C::ROWB,
                     peer_u32(recv_bar, d));
    }
  }
  if (S > 1 && nr > 0) mbar_wait_or_trap(recv_bar, 0);
  // my slices have landed, so have my peers' reads of my sources: a block
  // leaves once all have (cluster_wait below); nothing to publish, so
  // relaxed
  cluster_arrive_relaxed();
  {
    // my rows, 8 columns (16 bytes of dw) a thread at a time, summed over
    // the S partials in split order
    constexpr int G = C::BN / 8;             // 8-column groups a row
    const int rows = max(0, min(nr, a.width - m0 - r0));
#pragma unroll 1
    for (int p = tid; p < rows * G; p += 256) {
      const int r = p / G, c = 8 * (p - r * G);
      if (n0 + c >= a.H) continue;           // H % 8: 8 columns in or out
      float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll 1
      for (int q = 0; q < S; ++q) {
        const float *src =
            q == rank ? red + (r0 + r) * C::LDR + c
                      : recv + ((q < rank ? q : q - 1) * R + r) * C::LDR + c;
        const float4 x0 = *reinterpret_cast<const float4 *>(src);
        const float4 x1 = *reinterpret_cast<const float4 *>(src + 4);
        v[0] += x0.x, v[1] += x0.y, v[2] += x0.z, v[3] += x0.w;
        v[4] += x1.x, v[5] += x1.y, v[6] += x1.z, v[7] += x1.w;
      }
      store8((bf16 *)a.dw + (size_t)(a.c0 + m0 + r0 + r) * a.H + n0 + c, v);
    }
  }
  cluster_wait();
}

__global__ void __launch_bounds__(DwSplit::THREADS, 1)
    linear_ce_dw_split(const LceArgs a, const __grid_constant__ CUtensorMap tz,
                       const __grid_constant__ CUtensorMap tx) {
  dw_split_body<DwSplit>(a, &tz, &tx);
}

// xs[0] = bf16(x) and xs[1] = bf16(x - xs[0]), both rounded to nearest
// even, as the plain version's two torch conversions: 8 values a thread,
// 32 bytes of x in, 16 bytes of each half out.  x - xs[0] is exact in
// fp32.  Bound by bytes: 4 read and 4 written an element.
constexpr int SPLIT_THREADS = 256;
__global__ void __launch_bounds__(SPLIT_THREADS)
    linear_ce_split_x(const float *__restrict__ x, bf16 *__restrict__ xs,
                      long long n) {
  const long long i =
      8 * ((long long)blockIdx.x * SPLIT_THREADS + threadIdx.x);
  if (i >= n) return;                        // n % 8 == 0 (H % 8 == 0)
  const float4 *src = reinterpret_cast<const float4 *>(x + i);
  const float4 p = src[0], q = src[1];
  const float v[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
  unsigned hi[4], lo[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const bf16 h0 = __float2bfloat16_rn(v[2 * k]);
    const bf16 h1 = __float2bfloat16_rn(v[2 * k + 1]);
    hi[k] = pack_bf16(v[2 * k], v[2 * k + 1]);
    lo[k] = pack_bf16(v[2 * k] - __bfloat162float(h0),
                      v[2 * k + 1] - __bfloat162float(h1));
  }
  *reinterpret_cast<uint4 *>(xs + i) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4 *>(xs + n + i) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
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

typedef void (*WgKernel)(const LceArgs, const CUtensorMap, const CUtensorMap);
static const WgKernel WG_KERNELS[4] = {linear_ce_fwd_wg, linear_ce_dz_wg,
                                       linear_ce_dx_wg, linear_ce_dw_wg};
static const WgKernel SPLIT_KERNELS[2] = {linear_ce_fwd_split,
                                          linear_ce_dz_split};

// per device: the SM count and the clusters of s blocks (s = 1 ..
// MAX_SPLITS) of linear_ce_dw_split it keeps resident
// (cudaOccupancyMaxActiveClusters: a cluster's blocks share one GPC)
struct Device {
  int sms;
  int dw_clusters[DwSplit::MAX_SPLITS + 1];
};

// the current device's table; on the device's first call also the shared
// memory of every wgmma kernel here (once a device and process, not a
// launch)
static cudaError_t wg_setup(const Device **out) {
  constexpr int DEVICES = 64;
  static Device table[DEVICES];
  static std::atomic<bool> ready[DEVICES];      // false: static storage
  static std::mutex mu;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= DEVICES) return cudaErrorInvalidDevice;
  *out = &table[dev];
  if (ready[dev].load(std::memory_order_acquire)) return e;
  std::lock_guard<std::mutex> hold(mu);
  if (ready[dev].load(std::memory_order_acquire)) return e;
  for (WgKernel k : WG_KERNELS) {
    e = cudaFuncSetAttribute((const void *)k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Wg::SMEM);
    if (e != cudaSuccess) return e;
  }
  for (WgKernel k : SPLIT_KERNELS) {
    e = cudaFuncSetAttribute((const void *)k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             WgOf<true>::SMEM);
    if (e != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute((const void *)linear_ce_dw_split,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DwSplit::SMEM);
  if (e != cudaSuccess) return e;
  for (int s = 1; s <= DwSplit::MAX_SPLITS; ++s) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(s);
    cfg.blockDim = dim3(DwSplit::THREADS);
    cfg.dynamicSmemBytes = DwSplit::SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = s;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    // a shape the device cannot hold counts 0 clusters (never chosen)
    if (cudaOccupancyMaxActiveClusters(&table[dev].dw_clusters[s],
                                       (const void *)linear_ce_dw_split,
                                       &cfg) != cudaSuccess) {
      table[dev].dw_clusters[s] = 0;
      cudaGetLastError();
    }
  }
  e = cudaDeviceGetAttribute(&table[dev].sms, cudaDevAttrMultiProcessorCount,
                             dev);
  if (e == cudaSuccess) ready[dev].store(true, std::memory_order_release);
  return e;
}

// grid, block and shared memory from the instance: one block an SM,
// walking the tiles; the tensor maps per call.  Past a tensor the boxes
// fill zeros.  SPLIT: fwd / dz with fp32 x, whose halves xs the wrapper
// had linear_ce_split_x write
template <int EPI, bool SPLIT = false>
cudaError_t launch_wg(const LceArgs *a, cudaStream_t s) {
  using C = WgOf<SPLIT>;
  const Device *dev = nullptr;
  cudaError_t e = wg_setup(&dev);
  if (e != cudaSuccess) return e;
  const int sms = dev->sms;
  const CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const uint64_t ldh = 2 * (uint64_t)a->H, ldz = 2 * (uint64_t)a->ldz;
  const bf16 *w = (const bf16 *)a->w + (size_t)a->c0 * a->H;   // the slab
  CUtensorMap ta, tb;
  if (EPI == EPI_FWD || EPI == EPI_DZ) {
    // x [T, H] (SPLIT: xs [2, T, H]) in boxes of 128 rows x 64 columns, w
    // [V] or its slab [width, H] in boxes of 256 rows
    e = SPLIT ? encode_map_3d(&ta, BF, a->xs, a->H, a->T, 2, ldh,
                              ldh * a->T, C::BK, C::BM)
              : encode_map_2d(&ta, BF, a->x, a->H, a->T, ldh, C::BK, C::BM);
    if (e == cudaSuccess)
      e = EPI == EPI_FWD
              ? encode_map_2d(&tb, BF, a->w, a->H, a->V, ldh, C::BK, C::BN)
              : encode_map_2d(&tb, BF, w, a->H, a->width, ldh, C::BK, C::BN);
  } else if (EPI == EPI_DX) {
    // dz_w [T, width] (leading dim ldz) in boxes of 128 rows x 64 columns
    // of K; w's slab [width, H] in boxes of 64 K rows x 64 columns of H
    e = encode_map_2d(&ta, BF, a->dz_w, a->width, a->T, ldz, C::BK, C::BM);
    if (e == cudaSuccess)
      e = encode_map_2d(&tb, BF, w, a->H, a->width, ldh, 64, C::BK);
  } else {
    // dz_x [T, width] and x [T, H] in boxes of 64 K rows x 64 columns
    e = encode_map_2d(&ta, BF, a->dz_x, a->width, a->T, ldz, 64, C::BK);
    if (e == cudaSuccess)
      e = encode_map_2d(&tb, BF, a->x, a->H, a->T, ldh, 64, C::BK);
  }
  if (e != cudaSuccess) return e;
  const Gemm g = gemm_of<EPI>(*a);
  const long long tiles = (long long)cdiv(g.rows, C::BM) * cdiv(g.cols, C::BN);
  const unsigned grid = (unsigned)(tiles < sms ? tiles : sms);
  WgKernel k = WG_KERNELS[EPI];
  if constexpr (SPLIT) k = SPLIT_KERNELS[EPI];
  k<<<grid, C::THREADS, C::SMEM, s>>>(*a, ta, tb);
  return cudaGetLastError();
}

// linear_ce_dw_split's launch: K splits S (the cluster), slab row tiles
// and H column tiles, 32-row K steps, and the resident clusters of S
struct DwPlan {
  int splits, row_tiles, col_tiles, nk, resident;
};

// S (1 .. MAX_SPLITS, at most the K steps) at the least cost, where a
// block's time goes with its K steps (nk / S) plus FOLD_STEPS for the
// staging and the fold, and the device runs `resident` clusters of S at
// once: waves x (ceil(nk / S) + FOLD_STEPS); ties go to fewer splits
constexpr int FOLD_STEPS = 8;
static DwPlan dw_plan(const LceArgs *a, const Device &dev) {
  using C = DwSplit;
  DwPlan p;
  p.nk = cdiv(a->T, C::BK);
  p.row_tiles = cdiv(a->width, C::BM);
  p.col_tiles = cdiv(a->H, C::BN);
  const long long tiles = (long long)p.row_tiles * p.col_tiles;
  long long best = -1;
  p.splits = 1;
  for (int s = 1; s <= C::MAX_SPLITS && s <= p.nk; ++s) {
    const long long res = dev.dw_clusters[s];
    if (res <= 0) continue;
    const long long cost =
        (tiles + res - 1) / res * ((p.nk + s - 1) / s + FOLD_STEPS);
    if (best < 0 || cost < best) {
      best = cost;
      p.splits = s;
    }
  }
  p.resident = dev.dw_clusters[p.splits];
  return p;
}

// dw with fp32 x and bf16 w: the dz halves are one buffer, the low half
// dz_x a whole [T, ldz] slab or more past dz_w (the wrapper's [2, T,
// round8(chunk)] serves every slab), and xs holds x's halves
static cudaError_t launch_dw_split(const LceArgs *a, cudaStream_t s) {
  using C = DwSplit;
  const Device *dev = nullptr;
  cudaError_t e = wg_setup(&dev);
  if (e != cudaSuccess) return e;
  const uint64_t ldh = 2 * (uint64_t)a->H, ldz = 2 * (uint64_t)a->ldz;
  const uint64_t half = (uintptr_t)a->dz_x - (uintptr_t)a->dz_w;  // bytes
  if (!a->xs || (uintptr_t)a->dz_x < (uintptr_t)a->dz_w ||
      half < ldz * a->T || half % 16)
    return cudaErrorInvalidValue;
  const DwPlan p = dw_plan(a, *dev);
  if (p.row_tiles > 65535 || p.col_tiles > 65535) return cudaErrorInvalidValue;
  const CUtensorMapDataType BF = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap tz, tx;
  e = encode_map_3d(&tz, BF, a->dz_w, a->width, a->T, 2, ldz, half, 64,
                    C::BK);
  if (e == cudaSuccess)
    e = encode_map_3d(&tx, BF, a->xs, a->H, a->T, 2, ldh, ldh * a->T, 64,
                      C::BK);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.row_tiles, p.col_tiles);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.splits > 1;              // unsplit: an implicit cluster
  e = cudaLaunchKernelEx(&cfg, linear_ce_dw_split, *a, tz, tx);
  return e != cudaSuccess ? e : cudaGetLastError();
}

static bool both_bf16(const LceArgs *a) {
  return a->x_dtype == PT_BF16 && a->w_dtype == PT_BF16;
}
// fp32 x with bf16 w: fwd and dz on x's bf16 halves (the split route)
static bool on_split(const LceArgs *a) {
  return a->x_dtype == PT_F32 && a->w_dtype == PT_BF16;
}
// the Mma instances of linear_ce_fwd / linear_ce_dz: fp32 w
static cudaError_t fwd_f32w(const LceArgs *a, cudaStream_t s) {
  return a->x_dtype == PT_BF16 ? fwd<bf16, float>(a, s) : fwd<float, float>(a, s);
}
static cudaError_t dz_f32w(const LceArgs *a, cudaStream_t s) {
  return a->x_dtype == PT_BF16 ? dz<bf16, float>(a, s) : dz<float, float>(a, s);
}
// linear_ce_dx's operands are dz_w and w, linear_ce_dw's dz_x and x: each
// runs on wgmma when its operands are bf16 (dw on the split route: the
// halves of dz and x)
static bool dx_on_wg(const LceArgs *a) { return a->w_dtype == PT_BF16; }
static bool dw_on_wg(const LceArgs *a) { return a->x_dtype == PT_BF16; }
// the Mma instances of linear_ce_dx with fp32 w, linear_ce_dw with fp32 x
// and w
static cudaError_t dx_f32(const LceArgs *a, cudaStream_t s) {
  return a->x_dtype == PT_BF16 ? dx<bf16, float>(a, s) : dx<float, float>(a, s);
}

// the scratch a call needs: fp32 words of the forward's `part` (4 a row
// and vocab tile) and int32 tickets (one a row block), and bf16 elements
// of xs (2 T H, the split route's x halves, for the forward and for the
// backward's dz), each 0 where the instance takes none
static void scratch(const LceArgs *a, long long *part, long long *tickets,
                    long long *xs) {
  const bool ok = a->T > 0 && a->V > 0 && a->H > 0;
  const bool wg = (both_bf16(a) || on_split(a)) && ok;
  *part = wg ? 4LL * cdiv(a->V, Wg::BN) * a->T : 0;
  *tickets = wg ? cdiv(a->T, Wg::BM) : 0;
  *xs = on_split(a) && ok ? 2LL * a->T * a->H : 0;
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

cudaError_t launch_linear_ce_fwd(const LceArgs *a, cudaStream_t s) {
  using namespace pt::lce;
  if (bad_shape(a, false)) return cudaErrorInvalidValue;
  if ((both_bf16(a) || on_split(a)) && (!a->part || !a->tickets))
    return cudaErrorInvalidValue;
  if (on_split(a) && !a->xs) return cudaErrorInvalidValue;
  return count_launch(CNT_LINEAR_CE_FWD,
                      both_bf16(a)  ? launch_wg<EPI_FWD>(a, s)
                      : on_split(a) ? launch_wg<EPI_FWD, true>(a, s)
                                    : fwd_f32w(a, s));
}

cudaError_t launch_linear_ce_dz(const LceArgs *a, cudaStream_t s) {
  using namespace pt::lce;
  if (bad_shape(a, true)) return cudaErrorInvalidValue;
  if (on_split(a) && !a->xs) return cudaErrorInvalidValue;
  return count_launch(CNT_LINEAR_CE_DZ,
                      both_bf16(a)  ? launch_wg<EPI_DZ>(a, s)
                      : on_split(a) ? launch_wg<EPI_DZ, true>(a, s)
                                    : dz_f32w(a, s));
}

// x fp32 [T, H] -> xs bf16 [2, T, H], for the split route only
cudaError_t launch_linear_ce_split_x(const LceArgs *a, cudaStream_t s) {
  using namespace pt::lce;
  if (a->T <= 0 || a->H <= 0 || a->H % 8 || !on_split(a) || !a->x || !a->xs)
    return cudaErrorInvalidValue;
  if ((uintptr_t)a->x % 16 || (uintptr_t)a->xs % 16)
    return cudaErrorMisalignedAddress;
  const long long n = (long long)a->T * a->H;
  const long long blocks = (n / 8 + SPLIT_THREADS - 1) / SPLIT_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  linear_ce_split_x<<<(unsigned)blocks, SPLIT_THREADS, 0, s>>>(
      (const float *)a->x, (pt::bf16 *)a->xs, n);
  return count_launch(CNT_LINEAR_CE_SPLIT_X, cudaGetLastError());
}

cudaError_t launch_linear_ce_dx(const LceArgs *a, cudaStream_t s) {
  using namespace pt::lce;
  if (bad_shape(a, true)) return cudaErrorInvalidValue;
  return count_launch(CNT_LINEAR_CE_DX,
                      dx_on_wg(a) ? launch_wg<EPI_DX>(a, s) : dx_f32(a, s));
}

cudaError_t launch_linear_ce_dw(const LceArgs *a, cudaStream_t s) {
  using namespace pt::lce;
  if (bad_shape(a, true)) return cudaErrorInvalidValue;
  return count_launch(CNT_LINEAR_CE_DW,
                      dw_on_wg(a)   ? launch_wg<EPI_DW>(a, s)
                      : on_split(a) ? launch_dw_split(a, s)
                                    : dw<float, float>(a, s));
}

extern "C" {

int pt_linear_ce_fwd(const LceArgs *a, void *stream) {
  return launch_linear_ce_fwd(a, (cudaStream_t)stream);
}

int pt_linear_ce_scratch(const LceArgs *a, long long *sizes) {
  pt::lce::scratch(a, sizes, sizes + 1, sizes + 2);
  return 0;
}

int pt_linear_ce_split_x(const LceArgs *a, void *stream) {
  return launch_linear_ce_split_x(a, (cudaStream_t)stream);
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
