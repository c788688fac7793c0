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
// paged_attention read the rows they read for a Llama layer.
//
// What bounds it on an H100: the weight bytes at decode (M = batch <= 16:
// a 7B layer streams ~400 MB of bf16 weights, 0.121 ms at 3.35 TB/s) and
// up to M ~ 200; at M 256 the operations come close (the down projection:
// 29 us of bytes against 23 us of operations) and the L2 stream of x
// (re-read by every 128-column tile: 180 MB at the down projection) sets
// the pace.  At GPT-125M's widths (M 256, K 768 / 3072, N 768 - 3072) the
// work is 0.7 - 2.1 us; there the grid's shape and the fixed cost of a
// launch (ring fill, fold, epilogue) set the time.
//
// bf16: one warp-specialized wgmma / TMA body for sm_90a (xw_body), two
// kernel names (gemm_xw_small_m_tma at M <= 16, gemm_xw_tiled_wg above):
//   * Operands swapped: Y^T [N, M] = W^T [N, K] . X^T [K, M].  A block's
//     BN W columns (128: two consumer warpgroups of 64; SwiGLU: 64 columns
//     of W and the same 64 of W2, so a block's weight bytes are the same
//     in every epilogue; or 64: one consumer warpgroup) are wgmma's M
//     side, read straight from W's row-major layout as an MN-major A
//     operand: TMA boxes of 64 columns x 64 K rows, 128-byte swizzle, so a
//     weight row is read as a 256-byte run.  X [M, K] row-major is a
//     K-major B tile of NX rows (wgmma's N: 8 or 16 at decode, 32, 64 or
//     128 above, padded by TMA's zero fill), re-read from L2 by every
//     column tile; M > 128 runs 128-row tiles side by side (measured
//     faster than 256-row ones, which spill at 168 registers).
//   * A producer (a warpgroup beside two consumer warpgroups of W columns,
//     else a warp) keeps a ring of stages (BN x 128 bytes of W + NX x 128
//     bytes of X; 6 stages at decode, two blocks an SM: ~200 KB of
//     weights in flight an SM) on mbarriers; the consumer warpgroups run
//     wgmma m64nNk16 from shared memory into fp32 registers and hand a
//     stage back once its wgmmas retire.
//   * K is split over a thread-block cluster of S blocks (grid x).  At
//     M <= 64 plan_of picks S from the clusters of each size the device
//     keeps resident (cudaOccupancyMaxActiveClusters, once a device): at
//     decode N 4096 runs 32 column tiles x 7, all resident (x 8 would
//     leave 16 blocks to a second wave), N 11008 SwiGLU 172 tiles
//     unsplit.  Above M 64 it picks the tile as well (128 W columns x 128
//     x rows, one block an SM, or 64 x 64 on one consumer warpgroup,
//     three an SM) and S (1, 2 or 4) at the least modelled time
//     (plan_of): at M 256 GPT-125M's four products take 64 x 64 tiles,
//     144 of them for the qkv product (the 128 x 128 grid had 36), split
//     in 2 (4 for fc2's 48 K steps); llama_7b's keep 128 x 128 tiles
//     split in 2.
//   * The fold, inside the launch (split_k.cuh, shared with the
//     weight-only decode body): every block stages its fp32 partial tile
//     in its own shared memory and pushes each peer's rows into that
//     peer's receive slots by bulk copies; each block then sums its rows
//     over the S slots in split order, so two calls are bit-identical.
//     No workspace, no second kernel.
//   * The epilogue (every plan, unsplit too): the accumulators are staged
//     in shared memory as [x row][W column], and each consumer thread owns
//     one 8-column chunk of the tile's rows: its bias chunk, and where the
//     chunk is stored (row-major, or its qkv part's slab and column), are
//     worked out once; its residual rows are loaded before the fold's
//     exchange; each row is summed over the splits, run through epi_value
//     (SwiGLU pairs W's and W2's columns) and stored as one 16-byte
//     vector, coalesced along the row.  The qkv split keeps a chunk whole
//     wherever 8 divides D (a chunk never straddles a part); else its four
//     pairs are stored apart.
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

// WG consumer warpgroups of 64 W columns each (BN = 64 WG W columns a
// block), NX x rows a tile (wgmma's N), STAGES ring depth, MINB blocks an
// SM; the epilogue's chunks of V columns a thread (2 at decode: a tile's
// few rows spread over every thread)
template <int WG_, int NX_, int STAGES_, int MINB_> struct Cfg {
  static constexpr int WG = WG_, NX = NX_, STAGES = STAGES_, MINB = MINB_;
  static constexpr int V = NX <= 16 ? 2 : 8;
  static constexpr int BN = 64 * WG;            // W columns a block
  static constexpr int BK = 64;                 // K rows a stage
  static constexpr int WBOX = 64 * BK * 2;      // 64 W columns x 64 K rows
  static constexpr int WT = WG * WBOX;          // BN W columns
  static constexpr int XT = NX * BK * 2;        // NX x rows x 64 K columns
  static constexpr int STAGE = WT + XT;
  using Fold = splitk::Tile<NX, BN>;            // the staged partial tile
  static constexpr int LDR = Fold::LDR;
  static constexpr int RED = Fold::RED;
  static constexpr int BODY =
      STAGES * STAGE > Fold::BYTES ? STAGES * STAGE : Fold::BYTES;
  static constexpr int CONSUMERS = 128 * WG;
  // a producer warpgroup beside two consumer warpgroups, a producer warp
  // beside one
  static constexpr int THREADS = CONSUMERS + (WG == 2 ? 128 : 32);
  // one block an SM with a producer warpgroup: its registers go to the
  // consumers (setmaxnreg)
  static constexpr bool REGS = WG == 2 && MINB == 1;
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

// stages whose weight boxes the producer issues before pdl_wait: under a
// programmatic dependency they load while the kernel ahead runs; without
// one a stage's x box queues behind them, so more than one stage slowed
// every launch (tools/gemm_ab.py, tools/wo_ab.py)
constexpr int PDL_W_STAGES = 1;

// the CONSUMERS threads of the consumer warpgroups (named barrier 1; the
// producer never joins)
template <class C> __device__ __forceinline__ void consumer_bar() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(C::CONSUMERS) : "memory");
}

// One block: weight column tile blockIdx.z (BN columns of W, or 64 of W
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
  const int n0 = dual ? tile * 64 : tile * C::BN;    // first output column
  const int kb0 = (int)((long long)a.nk * rank / S);
  const int kb1 = (int)((long long)a.nk * (rank + 1) / S);
  // the tile rows this block folds: [r0, r0 + nr), R a rank
  const splitk::Share sh = splitk::share_of<C::NX>(S, rank);
  const int R = sh.R, r0 = sh.r0, nr = sh.nr;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * C::WG);         // each consumer warp
    }
    mbar_init(recv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 4 * C::WG) {                     // producer
    if constexpr (C::REGS) regs_dec<C::REGS_PRODUCER>();
    if (warp == 4 * C::WG && lane == 0) {
      const int c1 = dual ? n0 : n0 + 64;
      const CUtensorMap *t1 = dual ? tw2 : tw;
      // the weight boxes of the ring's first PDL_W_STAGES stages, then
      // (once the kernel ahead has finished: common.cuh pdl_wait) their x
      // boxes, then the ring as before; one expect_tx a stage covers both
      const int first = min(kb1 - kb0, min(C::STAGES, PDL_W_STAGES));
      for (int it = 0; it < first; ++it) {
        unsigned char *st = smem + it * C::STAGE;
        mbar_expect_tx(&full[it], C::STAGE);
        tma_load_2d(st, tw, n0, (kb0 + it) * C::BK, &full[it]);
        if constexpr (C::WG == 2)
          tma_load_2d(st + C::WBOX, t1, c1, (kb0 + it) * C::BK, &full[it]);
      }
      pdl_wait();
      for (int it = 0; it < first; ++it)
        tma_load_2d(smem + it * C::STAGE + C::WT, tx, (kb0 + it) * C::BK, m0,
                    &full[it]);
      for (int kb = kb0 + first, it = first; kb < kb1; ++kb, ++it) {
        const int s = it % C::STAGES, round = it / C::STAGES;
        if (round) mbar_wait_or_trap(&empty[s], (round - 1) & 1);
        unsigned char *st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, tw, n0, kb * C::BK, &full[s]);
        if constexpr (C::WG == 2)
          tma_load_2d(st + C::WBOX, t1, c1, kb * C::BK, &full[s]);
        tma_load_2d(st + C::WT, tx, kb * C::BK, m0, &full[s]);
      }
    }
    // the fold's cluster barriers (below), without its work: code past a
    // merge would be compiled to the producer's 40 registers
    splitk::idle();
    splitk::done();
    pdl_trigger();
    return;
  }
  if constexpr (C::REGS) regs_inc<C::REGS_CONSUMER>();
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
  // the last K stage is consumed: the kernel behind may start (a norm
  // under a programmatic dependency); the residual and the stores wait for
  // the kernel ahead
  pdl_trigger();
  pdl_wait();

  // The epilogue: this thread owns the V-column chunk c of the output
  // tile (SwiGLU: of its 64 columns) in rows r = (tid + i CONSUMERS) /
  // chunks-a-row of my share; its bias chunk is loaded before the fold
  // and where its chunk goes is worked out once
  constexpr int V = C::V;
  const int lg = (dual || C::WG == 1 ? 6 : 7) - (V == 2 ? 1 : 3);
  const int c = V * (tid & ((1 << lg) - 1)), n = n0 + c;
  const int rows = n < a.N ? max(0, min(nr, a.M - m0 - r0)) : 0;
  unsigned braw[V / 2] = {};
  if (a.epi >= EPI_BIAS && rows > 0) splitk::ldv<V>(braw, a.B + n);

  // the consumer warpgroups are done with the ring: stage the partial
  // tile in it as red[x row][W column] (column 64 wg + 16 w + g + 8h;
  // register 4j + 2h + e holds x row 8j + 2tq + e), for the bulk copies
  // and the epilogue to read
  consumer_bar<C>();
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
  // the K splits' fold: my rows of every peer's partial into my recv
  // slots (unsplit: the barrier that makes the staged tile whole)
  splitk::push<C::NX, C::BN>(red, recv, recv_bar, S, rank, tid);
  const splitk::ChunkDst<V> dst(n, a.M, a.N, a.qkv_d);
  const bool resid = a.epi == EPI_RESID || a.epi == EPI_BIAS_RESID;
  float bias[V];
  splitk::widen<V>(bias, braw);
  // a row's chunk: its residual chunk loaded first, summed over the splits
  // in split order, through epi_value, stored
#pragma unroll 1
  for (int p = tid; p < rows << lg; p += C::CONSUMERS) {
    const int r = p >> lg;
    unsigned rw[V / 2] = {};
    if (resid) splitk::ldv<V>(rw, a.R + (size_t)(m0 + r0 + r) * a.N + n);
    float x[V], y[V], rv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) x[e] = 0.f, y[e] = bias[e];
#pragma unroll 1
    for (int q = 0; q < S; ++q) {
      const float *src =
          (q == rank ? red + r0 * C::LDR : recv + q * R * C::LDR) +
          r * C::LDR + c;
      splitk::addv<V>(x, src);
      if (dual) splitk::addv<V>(y, src + 64);
    }
    splitk::widen<V>(rv, rw);
    unsigned o[V / 2];
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      o[i] = splitk::bf16x2(
          epi_value<bf16>(a.epi, x[2 * i], y[2 * i], rv[2 * i]),
          epi_value<bf16>(a.epi, x[2 * i + 1], y[2 * i + 1], rv[2 * i + 1]));
    dst.store(a.Y, m0 + r0 + r, o);
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
// <= 32, <= 64 (two an SM); above, 128 W columns x 128 x rows (one an SM:
// measured faster than 256-row tiles at M 256, tools/gemm_ab.py), or 64
// x 64 on one warpgroup (three an SM, a ring for a short K)
using S8 = Cfg<2, 8, 6, 2>;
using S16 = Cfg<2, 16, 6, 2>;
using T32 = Cfg<2, 32, 5, 2>;
using T64 = Cfg<2, 64, 4, 2>;
using T128 = Cfg<2, 128, 6, 1>;
using N64 = Cfg<1, 64, 4, 3>;
constexpr int NINST = 6;
constexpr int I_T128 = 4, I_N64 = 5;

typedef void (*Kernel)(const Args, const CUtensorMap, const CUtensorMap,
                       const CUtensorMap);

struct Inst {
  Kernel fn;
  int nx, bn, minb, smem, threads;
};
template <class C> Inst small() {
  return {gemm_xw_small_m_tma<C>, C::NX, C::BN, C::MINB, C::SMEM,
          C::THREADS};
}
template <class C> Inst tiled() {
  return {gemm_xw_tiled_wg<C>, C::NX, C::BN, C::MINB, C::SMEM, C::THREADS};
}
static const Inst INSTS[NINST] = {small<S8>(),   small<S16>(),
                                  tiled<T32>(),  tiled<T64>(),
                                  tiled<T128>(), tiled<N64>()};

// the current device's clusters of each size of every instance (once a
// device: split_k.cuh)
static splitk::ResidencyTable<NINST> residency;
static cudaError_t setup(const splitk::Residency<NINST> **occ) {
  splitk::KernelShape ks[NINST];
  for (int i = 0; i < NINST; ++i)
    ks[i] = {(const void *)INSTS[i].fn, INSTS[i].threads, INSTS[i].smem};
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

// M <= 64: K splits at the least modelled cost (splitk::best_split), a K
// step weighed against FOLD_STEPS for the staging and the fold
constexpr int FOLD_STEPS = 12;
// M > 64, the tile (T128, or N64 but for SwiGLU) and the split (1, 2 or
// 4), by a model fitted to the card (tools/gemm_ab.py's forced plans at
// GPT-125M's four shapes, NVIDIA H100 80GB HBM3, 700.00 W: its picks came
// within 3 % of the best measured plan of each, among seven tile shapes,
// and it keeps llama_7b's 128 x 128 tiles split in 2): a wave of resident
// clusters takes its busiest SM's K steps, each the bytes its stage
// brings into shared memory (STEP_KB), 3 / 8 more for each block beside
// it on that SM (they share its bandwidth and hide each other's
// latency), and FOLD_KB a split past the first for the staging and the
// exchange; waves x that, the least wins, ties to the earlier instance
// and fewer splits
constexpr int XW_FORCE_INST = -1, XW_FORCE_SPLIT = 0;
constexpr int STEP_KB[NINST] = {0, 0, 0, 0, 32, 16};
constexpr int FOLD_KB = 16;

// the model's cost, in eighths of a KB; -1 where the device cannot hold
// a cluster of s
static long long model(int inst, int s, long long tiles, int nk,
                       const splitk::Residency<NINST> &occ) {
  const long long res = occ.clusters[inst][s], slots = occ.clusters[inst][1];
  if (res <= 0 || slots <= 0) return -1;
  const long long waves = (tiles + res - 1) / res;
  const long long wave = tiles < res ? tiles : res;
  // blocks a wave puts on its busiest SM (slots: SMs x blocks an SM)
  const long long side = (wave * s * INSTS[inst].minb + slots - 1) / slots;
  return waves * ((nk + s - 1) / s * STEP_KB[inst] * (5 + 3 * side) +
                  8 * FOLD_KB * (s - 1));
}

static Plan plan_of(int M, int K, int N, int epi,
                    const splitk::Residency<NINST> &occ) {
  const bool dual = epi == EPI_SWIGLU;
  Plan p;
  p.nk = (K + 63) / 64;
  auto tiles_of = [&](int inst) {
    const Inst &k = INSTS[inst];
    p.row_tiles = (M + k.nx - 1) / k.nx;
    p.col_tiles = dual ? (N + 63) / 64 : (N + k.bn - 1) / k.bn;
    return (long long)p.row_tiles * p.col_tiles;
  };
  if (M <= 64) {
    p.inst = M <= 8 ? 0 : M <= 16 ? 1 : M <= 32 ? 2 : 3;
    p.splits = splitk::best_split(tiles_of(p.inst), p.nk,
                                  occ.clusters[p.inst], FOLD_STEPS);
  } else {
    long long best = -1;
    p.inst = I_T128;
    p.splits = 1;
    for (int inst = I_T128; inst <= (dual ? I_T128 : I_N64); ++inst) {
      if (XW_FORCE_INST >= 0 && inst != XW_FORCE_INST && !dual) continue;
      const long long tiles = tiles_of(inst);
      for (int s = 1; s <= 4 && s <= p.nk; s *= 2) {
        if (XW_FORCE_SPLIT > 0)                // a pinned split, once
          s = XW_FORCE_SPLIT < p.nk ? XW_FORCE_SPLIT : p.nk;
        const long long cost = model(inst, s, tiles, p.nk, occ);
        if (cost >= 0 && (best < 0 || cost < best)) {
          best = cost;
          p.inst = inst;
          p.splits = s;
        }
        if (XW_FORCE_SPLIT > 0) break;
      }
    }
    tiles_of(p.inst);
  }
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
  cfg.blockDim = dim3(k.threads);
  cfg.dynamicSmemBytes = k.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  cfg.attrs = attr;
  // an unsplit launch is an implicit cluster of one: without the
  // attribute it measured 3-5 % faster (tools/gemm_ab.py)
  if (p.splits > 1) {
    attr[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
    attr[cfg.numAttrs].val.clusterDim.x = p.splits;
    attr[cfg.numAttrs].val.clusterDim.y = 1;
    attr[cfg.numAttrs++].val.clusterDim.z = 1;
  }
  if (launch_pdl()) attr[cfg.numAttrs++] = pdl_attr();
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
// shape the device keeps resident, [7] W columns a tile.
extern "C" int pt_gemm_xw_plan(int M, int K, int N, int epi, int *out) {
  using namespace pt::xw;
  const pt::splitk::Residency<NINST> *occ = nullptr;
  const cudaError_t e = setup(&occ);
  if (e != cudaSuccess) return e;
  const Plan p = plan_of(M, K, N, epi, *occ);
  const Inst &k = INSTS[p.inst];
  const int v[8] = {k.nx,        k.minb, p.splits,   p.row_tiles,
                    p.col_tiles, p.nk,   p.resident, k.bn};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}
