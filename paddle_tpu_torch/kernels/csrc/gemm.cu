// gemm_xw: Y[M, N] = X[M, K] @ W[K, N] with a fused epilogue.
//
// Part of the decode_block / prefill_block chain: the q/k/v, o-proj and
// FFN products that paddle_tpu/ops/pallas/decode_block.py::_kernel and
// prefill_block.py::_kernel run on VMEM-resident weights.  W keeps the
// JAX layout [in, out], row-major.  Epilogues:
//   EPI_NONE       Y = X @ W                            (q, k, v)
//   EPI_RESID      Y = R + X @ W                        (o-proj, down-proj)
//   EPI_SWIGLU     Y = silu(X @ W) * (X @ W2), two products in one launch
//                  (gate/up)
//   EPI_BIAS       Y = X @ W + B                        (GPT qkv)
//   EPI_BIAS_RESID Y = R + (X @ W + B)                  (GPT proj, fc2)
//   EPI_BIAS_GELU  Y = gelu_tanh(X @ W + B)             (GPT fc1)
// with the reference's rounding: each product rounded to the storage type
// before the bias, the residual add or the activation, a bias sum rounded
// before the residual add or the activation (common.cuh epi_value).  The
// GPT qkv product is stored split (qkv_d > 0): column c of the [M, 3 Hq D]
// product is head c / 3D, part (c % 3D) / D of [q | k | v], stored into
// that part's [M, Hq D] slab at column head D + c % D, so rope_kv_write and
// paged_attention read the rows they read for a Llama layer.  The index is
// taken per stored pair of columns (a 128-column tile spans heads: 3D is
// 192 at D 64); D is even, so a pair never straddles a part.
//
// What bounds it on an H100: the weight bytes at decode (M = batch <= 16:
// a 7B layer streams ~400 MB of bf16 weights, 0.121 ms at 3.35 TB/s) and
// up to M ~ 200; at M 256 the operations come close (the down projection:
// 29 us of bytes against 23 us of operations) and the L2 stream of x
// (re-read by every 128-column tile: 180 MB at the down projection) sets
// the pace.
//
// bf16: one warp-specialized wgmma / TMA body for sm_90a (xw_body), two
// kernel names (gemm_xw_small_m_tma at M <= 16, gemm_xw_tiled_wg above):
//   * Operands swapped: Y^T [N, M] = W^T [N, K] . X^T [K, M].  W's 128
//     columns of a block are wgmma's M side, two warpgroups of 64 (SwiGLU:
//     64 columns of W and the same 64 of W2, so a block's weight bytes are
//     the same in every epilogue), read straight from W's row-major layout
//     as an MN-major A operand: TMA boxes of 64 columns x 64 K rows,
//     128-byte swizzle, so a weight row is read as a 256-byte run.  X
//     [M, K] row-major is a K-major B tile of NX rows (wgmma's N: 8 or 16
//     at decode, 32, 64 or 128 above, padded by TMA's zero fill), re-read
//     from L2 by every column tile; M > 128 runs 128-row tiles side by side
//     (measured faster than 256-row ones, which spill at 168 registers).
//   * A producer warp keeps a ring of stages (16 KB of W + NX x 128 bytes
//     of X; 6 stages at decode, two blocks an SM: ~200 KB of weights in
//     flight an SM) on mbarriers; the consumer warpgroups run
//     wgmma m64nNXk16 from shared memory into fp32 registers and hand a
//     stage back once its wgmmas retire.
//   * K is split over a thread-block cluster of S blocks (grid x).
//     plan_of picks S from the clusters of each size the device keeps
//     resident (cudaOccupancyMaxActiveClusters, once a device): at decode
//     N 4096 runs 32 column tiles x 7, all resident (x 8 would leave 16
//     blocks to a second wave), N 11008 SwiGLU 172 tiles unsplit.
//   * The fold, inside the launch (split_k.cuh, shared with the
//     weight-only decode body): every block stages its fp32 partial tile
//     in its own shared memory and pushes each peer's rows into that
//     peer's receive slots by bulk copies; each block then sums its rows
//     over the S slots in split order, so two calls are bit-identical, and
//     runs the epilogue once (SwiGLU pairs W's and W2's columns there),
//     storing bf16 pairs along N.  No workspace, no second kernel.
//   * Host (split_k.cuh): the shared-memory attribute and the occupancy
//     table are set once a device; the tensor maps are cached by their
//     arguments, so the layer's steady weights cost one lookup each.
// fp32 (the correctness lane) runs plain FMA over 64 x 64 tiles.
// Requirements checked by the wrapper: K % 8 == 0, N % 8 == 0, 16-byte
// aligned pointers.
#include "split_k.cuh"

namespace pt {

// b: SwiGLU's second product (read by the caller), or for the bias
// epilogues unused: the bias is read here
template <typename T>
__device__ __forceinline__ void epilogue(T *Y, const T *R, const T *B,
                                         int epi, int qkv_d, int M, int m,
                                         int n, int N, float a, float b) {
  const size_t i = (size_t)m * N + n;
  const bool resid = epi == EPI_RESID || epi == EPI_BIAS_RESID;
  if (epi >= EPI_BIAS) b = to_f<T>(B[n]);
  Y[out_index(m, n, M, N, qkv_d)] =
      from_f<T>(epi_value<T>(epi, a, b, resid ? to_f<T>(R[i]) : 0.f));
}

// ------------------------------------------------------------ bf16: wgmma
namespace xw {

// NX x rows a tile (wgmma's N), STAGES ring depth, MINB blocks an SM
template <int NX_, int STAGES_, int MINB_> struct Cfg {
  static constexpr int NX = NX_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int BK = 64;                 // K rows a stage
  static constexpr int WBOX = 64 * BK * 2;      // 64 W columns x 64 K rows
  static constexpr int WT = 2 * WBOX;           // 128 W columns
  static constexpr int XT = NX * BK * 2;        // NX x rows x 64 K columns
  static constexpr int STAGE = WT + XT;
  using Fold = splitk::Tile<NX>;                // the staged partial tile
  static constexpr int LDR = Fold::LDR;
  static constexpr int RED = Fold::RED;
  static constexpr int BODY =
      STAGES * STAGE > Fold::BYTES ? STAGES * STAGE : Fold::BYTES;
  static constexpr int THREADS = 384;           // 2 consumer wgs + producer
  static constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 232;
  static constexpr int NACC = NX / 2;           // fp32 accumulators a thread
  static constexpr int SMEM = 1024 + BODY + (2 * STAGES + 1) * 8;
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(MINB * (SMEM + 1024) <= 233472, "MINB blocks an SM");
};

struct Args {
  int M, N, epi, nk;                            // nk: 64-row K steps
  int qkv_d;                                    // > 0: the qkv split
  const bf16 *R, *B;
  bf16 *Y;
};

// One block: weight column tile blockIdx.z (128 columns of W, or 64 of W
// and 64 of W2), x rows from blockIdx.y * NX, K split blockIdx.x of
// gridDim.x (the cluster).  Rows, columns and K past the tensors are
// TMA's zero fill; stores are masked.
template <class C>
__device__ __forceinline__ void xw_body(const Args &a, const CUtensorMap *tw,
                                        const CUtensorMap *tw2,
                                        const CUtensorMap *tx) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char *smem = reinterpret_cast<unsigned char *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + C::BODY);
  uint64_t *empty = full + C::STAGES;
  uint64_t *recv_bar = empty + C::STAGES;
  float *red = reinterpret_cast<float *>(smem);              // [NX][LDR]
  float *recv = reinterpret_cast<float *>(smem + C::RED);    // [S][R][LDR]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool dual = a.epi == EPI_SWIGLU;
  const int S = gridDim.x, rank = blockIdx.x;
  const int m0 = blockIdx.y * C::NX, tile = blockIdx.z;
  const int n0 = dual ? tile * 64 : tile * 128;      // first output column
  const int kb0 = (int)((long long)a.nk * rank / S);
  const int kb1 = (int)((long long)a.nk * (rank + 1) / S);
  // the tile rows this block folds: [r0, r0 + nr), R a rank
  const splitk::Share sh = splitk::share_of<C::NX>(S, rank);
  const int R = sh.R, r0 = sh.r0, nr = sh.nr;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                 // each consumer warp
    }
    mbar_init(recv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {                             // producer warpgroup
    if constexpr (C::MINB == 1) regs_dec<C::REGS_PRODUCER>();
    if (warp == 8 && lane == 0) {
      const int c1 = dual ? n0 : n0 + 64;
      const CUtensorMap *t1 = dual ? tw2 : tw;
      for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
        const int s = it % C::STAGES, round = it / C::STAGES;
        if (round) mbar_wait_or_trap(&empty[s], (round - 1) & 1);
        unsigned char *st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, tw, n0, kb * C::BK, &full[s]);
        tma_load_2d(st + C::WBOX, t1, c1, kb * C::BK, &full[s]);
        tma_load_2d(st + C::WT, tx, kb * C::BK, m0, &full[s]);
      }
    }
    // the fold's cluster barriers (below), without its work: code past a
    // merge would be compiled to the producer's 40 registers
    splitk::idle();
    splitk::done();
    return;
  }
  if constexpr (C::MINB == 1) regs_inc<C::REGS_CONSUMER>();
  const int wg = warp >> 2;
  float acc[C::NACC];
  for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
    const int s = it % C::STAGES;
    mbar_wait_or_trap(&full[s], (it / C::STAGES) & 1);
    const unsigned char *st = smem + s * C::STAGE;
    // A: this warpgroup's 64 W columns, MN-major (a k16 slice is 16 K
    // rows, 2048 bytes on); B: the x rows, K-major (32 bytes on)
    const uint64_t da = desc_sw128_mn(st + wg * C::WBOX, C::WBOX);
    const uint64_t db = desc_sw128(st + C::WT);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaSS<C::NX, 1, 0>::mma(acc, da + 128 * kk, db + 2 * kk,
                                it > 0 || kk > 0);
    wg_commit();
    wg_wait<1>();
    // the wgmmas of the previous stage have retired: hand its slot back
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % C::STAGES]);
  }
  wg_wait<0>();
  fence_regs(acc);
  // both warpgroups are done with the ring: stage the partial tile in
  // it as red[x row][W column] (column 64 wg + 16 w + g + 8h; register
  // 4j + 2h + e holds x row 8j + 2tq + e), for the bulk copies to read
  consumer_sync();
  const int g = lane >> 2, tq = lane & 3;
  const int col = 64 * wg + 16 * (warp & 3) + g;
#pragma unroll
  for (int j = 0; j < C::NX / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        red[(8 * j + 2 * tq + e) * C::LDR + col + 8 * h] =
            acc[4 * j + 2 * h + e];
  fence_proxy_async_smem();
  // the K splits' fold: my rows of every peer's partial into my recv slots
  splitk::push<C::NX>(red, recv, recv_bar, S, rank, tid);
  {
    // the epilogue over my rows, pairs of output columns along N, in
    // rounds of U pairs a thread (the residuals of a round in flight; one
    // pair at decode, where a thread has at most one)
    constexpr int U = C::NX <= 16 ? 1 : 4;
    const bool resid = a.epi == EPI_RESID || a.epi == EPI_BIAS_RESID;
    const bool biased = a.epi >= EPI_BIAS;
    const int lh = dual ? 5 : 6;               // log2(column pairs a row)
    const int P = max(0, min(nr, a.M - m0 - r0)) << lh;
#pragma unroll 1
    for (int p0 = tid; p0 < P; p0 += 256 * U) {
      int off[U];                              // r LDR + c, or -1
      float2 x[U], y[U], res[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int p = p0 + 256 * u, r = p >> lh;
        const int c = 2 * (p & ((1 << lh) - 1));
        const bool ok = p < P && n0 + c < a.N;
        off[u] = ok ? r * C::LDR + c : -1;
        x[u] = y[u] = res[u] = make_float2(0.f, 0.f);
        if (ok && resid)
          res[u] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162 *>(
                  a.R + (size_t)(m0 + r0 + r) * a.N + n0 + c));
        // the bias epilogues take the bias as epi_value's second operand
        if (ok && biased)
          y[u] = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162 *>(a.B + n0 + c));
      }
#pragma unroll 1
      for (int q = 0; q < S; ++q) {
        const float *src = q == rank ? red + r0 * C::LDR
                                     : recv + q * R * C::LDR;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (off[u] >= 0) {
            const float2 v = *reinterpret_cast<const float2 *>(src + off[u]);
            x[u].x += v.x;
            x[u].y += v.y;
            if (dual) {
              const float2 w =
                  *reinterpret_cast<const float2 *>(src + off[u] + 64);
              y[u].x += w.x;
              y[u].y += w.y;
            }
          }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (off[u] >= 0) {
          const int r = off[u] / C::LDR, c = off[u] - r * C::LDR;
          *reinterpret_cast<__nv_bfloat162 *>(
              a.Y + out_index(m0 + r0 + r, n0 + c, a.M, a.N, a.qkv_d)) =
              __floats2bfloat162_rn(
                  epi_value<bf16>(a.epi, x[u].x, y[u].x, res[u].x),
                  epi_value<bf16>(a.epi, x[u].y, y[u].y, res[u].y));
        }
    }
  }
  splitk::done();
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
    gemm_xw_small_m_tma(const Args a, const __grid_constant__ CUtensorMap tw,
                        const __grid_constant__ CUtensorMap tw2,
                        const __grid_constant__ CUtensorMap tx) {
  xw_body<C>(a, &tw, &tw2, &tx);
}

template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
    gemm_xw_tiled_wg(const Args a, const __grid_constant__ CUtensorMap tw,
                     const __grid_constant__ CUtensorMap tw2,
                     const __grid_constant__ CUtensorMap tx) {
  xw_body<C>(a, &tw, &tw2, &tx);
}

// the instances: M <= 8, <= 16 (decode: two blocks an SM, a deep ring),
// <= 32, <= 64 (two an SM), above (one an SM, 128-row tiles: measured
// faster than 256-row ones at M 256, tools/gemm_ab.py)
using S8 = Cfg<8, 6, 2>;
using S16 = Cfg<16, 6, 2>;
using T32 = Cfg<32, 5, 2>;
using T64 = Cfg<64, 4, 2>;
using T128 = Cfg<128, 6, 1>;
constexpr int NINST = 5;

typedef void (*Kernel)(const Args, const CUtensorMap, const CUtensorMap,
                       const CUtensorMap);

struct Inst {
  Kernel fn;
  int nx, minb, smem;
};
template <class C> Inst small() {
  return {gemm_xw_small_m_tma<C>, C::NX, C::MINB, C::SMEM};
}
template <class C> Inst tiled() {
  return {gemm_xw_tiled_wg<C>, C::NX, C::MINB, C::SMEM};
}
static const Inst INSTS[NINST] = {small<S8>(), small<S16>(), tiled<T32>(),
                                  tiled<T64>(), tiled<T128>()};

// the current device's clusters of each size of every instance (once a
// device: split_k.cuh)
static splitk::ResidencyTable<NINST> residency;
static cudaError_t setup(const splitk::Residency<NINST> **occ) {
  splitk::KernelShape ks[NINST];
  for (int i = 0; i < NINST; ++i)
    ks[i] = {(const void *)INSTS[i].fn, 384, INSTS[i].smem};
  return residency.get(ks, occ);
}

static cudaError_t bf16_map(CUtensorMap *map, const void *base,
                            uint64_t cols, uint64_t rows, uint32_t box_cols,
                            uint32_t box_rows) {
  return splitk::cached_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base,
                               cols, rows, 2 * cols, box_cols, box_rows);
}

struct Plan {
  int inst, splits, row_tiles, col_tiles, nk, resident;
};

// K splits at the least modelled cost (splitk::best_split), a K step
// weighed against FOLD_STEPS for the staging and the fold
constexpr int FOLD_STEPS = 12;
static Plan plan_of(int M, int K, int N, int epi,
                    const splitk::Residency<NINST> &occ) {
  Plan p;
  p.inst = M <= 8 ? 0 : M <= 16 ? 1 : M <= 32 ? 2 : M <= 64 ? 3 : 4;
  const Inst &k = INSTS[p.inst];
  p.nk = (K + 63) / 64;
  p.row_tiles = (M + k.nx - 1) / k.nx;
  p.col_tiles = epi == EPI_SWIGLU ? (N + 63) / 64 : (N + 127) / 128;
  p.splits = splitk::best_split((long long)p.row_tiles * p.col_tiles, p.nk,
                                 occ.clusters[p.inst], FOLD_STEPS);
  p.resident = occ.clusters[p.inst][p.splits];
  return p;
}

static cudaError_t launch(int M, int K, int N, int epi, const void *X,
                          const void *W, const void *W2, const void *R,
                          const void *B, void *Y, int qkv_d,
                          cudaStream_t s) {
  const splitk::Residency<NINST> *occ = nullptr;
  cudaError_t e = setup(&occ);
  if (e != cudaSuccess) return e;
  const Plan p = plan_of(M, K, N, epi, *occ);
  const Inst &k = INSTS[p.inst];
  if (p.row_tiles > 65535 || p.col_tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap tw, tw2, tx;
  e = bf16_map(&tw, W, N, K, 64, 64);
  if (e == cudaSuccess)
    e = epi == EPI_SWIGLU ? bf16_map(&tw2, W2, N, K, 64, 64)
                          : (tw2 = tw, cudaSuccess);
  if (e == cudaSuccess) e = bf16_map(&tx, X, K, M, 64, k.nx);
  if (e != cudaSuccess) return e;
  const Args a{M, N, epi, p.nk, qkv_d, (const bf16 *)R, (const bf16 *)B,
               (bf16 *)Y};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.row_tiles, p.col_tiles);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = k.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  // an unsplit launch is an implicit cluster of one: without the
  // attribute it measured 3-5 % faster (tools/gemm_ab.py)
  cfg.numAttrs = p.splits > 1;
  e = cudaLaunchKernelEx(&cfg, k.fn, a, tw, tw2, tx);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace xw

// ------------------------------------------------------------------ fp32
constexpr int F_BM = 64, F_BN = 64, F_BK = 16;

template <bool DUAL>
__global__ void __launch_bounds__(256)
    gemm_f32(const float *__restrict__ X, const float *__restrict__ W,
             const float *__restrict__ W2, const float *__restrict__ R,
             const float *__restrict__ B, float *__restrict__ Y, int M,
             int K, int N, int epi, int qkv_d) {
  constexpr int NW = DUAL ? 2 : 1;
  __shared__ float As[F_BK][F_BM + 4];
  __shared__ float Bs[NW][F_BK][F_BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * F_BM, n0 = blockIdx.x * F_BN;
  const float *Ws[2] = {W, W2};
  float acc[NW][4][4];
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[w][i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += F_BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int e = tid + i * 256, r = e >> 4, kk = e & 15;
      int m = m0 + r, k = k0 + kk;
      As[kk][r] = (m < M && k < K) ? X[(size_t)m * K + k] : 0.f;
    }
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int e = tid + i * 256, kk = e >> 6, c = e & 63;
        int k = k0 + kk, n = n0 + c;
        Bs[w][kk][c] = (k < K && n < N) ? Ws[w][(size_t)k * N + n] : 0.f;
      }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < F_BK; ++kk) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int w = 0; w < NW; ++w)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float b = Bs[w][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[w][i][j] = fmaf(a[i], b, acc[w][i][j]);
        }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < M && n < N)
        epilogue<float>(Y, R, B, epi, qkv_d, M, m, n, N, acc[0][i][j],
                        DUAL ? acc[NW - 1][i][j] : 0.f);
    }
}

}  // namespace pt

cudaError_t launch_gemm_xw(int dtype, int M, int K, int N, int epi,
                           const void *X, const void *W, const void *W2,
                           const void *R, const void *B, void *Y, int qkv_d,
                           cudaStream_t s) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const bool dual = epi == EPI_SWIGLU;
  if (epi < EPI_NONE || epi > EPI_BIAS_GELU || epi == EPI_SWIGLU_R ||
      (dual && !W2) ||
      ((epi == EPI_RESID || epi == EPI_BIAS_RESID) && !R) ||
      (epi >= EPI_BIAS && !B) ||
      (qkv_d && (qkv_d < 0 || qkv_d % 2 || N % (3 * qkv_d) || dual)))
    return cudaErrorInvalidValue;
  if (dtype == PT_F32) {
    dim3 grid((N + pt::F_BN - 1) / pt::F_BN, (M + pt::F_BM - 1) / pt::F_BM);
    auto k = dual ? pt::gemm_f32<true> : pt::gemm_f32<false>;
    k<<<grid, 256, 0, s>>>((const float *)X, (const float *)W,
                           (const float *)W2, (const float *)R,
                           (const float *)B, (float *)Y, M, K, N, epi, qkv_d);
    return count_launch(CNT_GEMM_XW_F32, cudaGetLastError());
  }
  if (dtype != PT_BF16 || K <= 0 || K % 8 || N % 8)
    return cudaErrorInvalidValue;
  const cudaError_t e =
      pt::xw::launch(M, K, N, epi, X, W, W2, R, B, Y, qkv_d, s);
  if (M <= 16) return count_launch(CNT_GEMM_XW_SMALL_M, e);
  return count_launch(CNT_GEMM_XW_TILED, e);
}

// The bf16 launch plan of one gemm_xw call, for tools: out[0] NX (x rows
// a tile), [1] blocks an SM, [2] K splits (the cluster), [3] x row tiles,
// [4] weight column tiles, [5] 64-row K steps, [6] the clusters of this
// shape the device keeps resident.
extern "C" int pt_gemm_xw_plan(int M, int K, int N, int epi, int *out) {
  using namespace pt::xw;
  const pt::splitk::Residency<NINST> *occ = nullptr;
  const cudaError_t e = setup(&occ);
  if (e != cudaSuccess) return e;
  const Plan p = plan_of(M, K, N, epi, *occ);
  const int v[7] = {INSTS[p.inst].nx, INSTS[p.inst].minb, p.splits,
                    p.row_tiles, p.col_tiles, p.nk, p.resident};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return cudaSuccess;
}
