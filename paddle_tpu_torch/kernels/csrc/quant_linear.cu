// Weight-only quantized matmul: y [M, N] = x [M, K] @ dequant(w, scale),
// int8 codes [K, N] or int4 codes halves-packed into int8 [ceil(K/2), N],
// fp32 scales per output channel or per group of 64 / 128 rows.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/quant_linear.py:
//   int8  _wo_kernel   (pallas_call at :150)
//   int4  _wo4_kernel  (pallas_call at :264)
// with their arithmetic: codes widened exactly to x's dtype, fp32
// accumulation, and the scale either multiplied in fp32 into each group's
// partial product (per channel and groups of 128: the Pallas kernel's
// `post`) or folded into the weight in x's dtype before the product, the
// scale rounded to that dtype (groups of 64, where the Pallas kernel's
// 128-row block spans two groups: its `tile`; also the int4 groups the
// Pallas kernel refuses).  The output is written in x's dtype.
//
// What bounds it on an H100: at decode (M = batch 8) the code bytes —
// llama_7b's 202 M block weights a layer are 202 MB in int8 and 101 MB in
// int4, 60 / 30 us at 3.35 TB/s, against 4 flops per weight; at prefill
// (M = 1024) the tensor-core operations (2 M K N at 989 TFLOP/s bf16:
// 2048 operations a code byte, far above the card's ~295 a byte); with
// 128-channel tiles x is read from L2 again for every tile, so the
// copies into shared memory (~4 GB a llama_7b layer) come next.  At the
// serving chain's M 256 the operations still bound it (a llama_7b layer's
// 7 GEMMs: 0.105 ms at 989 TFLOP/s against 0.061 ms of code bytes), but
// the grid does not fill the card: (N / 128) x (M / 128) tiles are 64 at
// N 4096 (under half the 132 SMs) and 12-48 at GPT-125M's widths, each
// walking all of K; there the K split below sets the pace, and at the
// GPT widths (2-12 K steps a block) the launch, the ring's first fill and
// the fold's exchange, a few microseconds a launch, are most of it.
// Three kernels, one per regime:
//   * bf16 x, M > 16 (prefill): wo_wgmma, on wgmma.  The operands are
//     swapped, y^T [N, M] = (W s)^T [N, K] . x^T [K, M], so the
//     dequantized weight is wgmma's A operand, taken from registers, and x
//     is B, read by wgmma from shared memory: x [M, K] row-major is
//     exactly a K-major B tile.  A block is 2 consumer warpgroups of 64
//     output channels each (128 channels, one 128-byte code row) by BM x
//     rows (wgmma m64nBMk16), plus a producer warpgroup that gives its
//     registers to the consumers (setmaxnreg 40 / 232).  One producer
//     thread streams x (64-column boxes; int4: one box from each nibble
//     plane's columns) and the codes (64 rows of 128 bytes) by TMA,
//     128-byte swizzled, into a ring of 3-4 stages completed on
//     mbarriers.  Each consumer thread reads its codes with ldmatrix.trans
//     (one x4 gives a thread the k pairs (2t, 2t+1) and (2t+8, 2t+9) of 2
//     channels for two k16 steps) and widens them in registers (int8: the
//     exponent-bias trick, byte ^ 0x80 spliced under 2^23 by one PRMT and
//     one FADD, then the exact top halves packed (mma.cuh widen_i8);
//     int4: a nibble pair masked under bf16 128 by one LOP3 and one
//     bf16x2 FMA), so each code is widened once a block, by one thread,
//     for BM x rows.  A rows are
//     the channels in the order the bytes lie in a 16-byte chunk: row g
//     of a warp is byte 2g, row g + 8 byte 2g + 1, so a thread's two D
//     rows are two neighbouring channels and the epilogue stores bf16
//     pairs straight from the accumulators (32 contiguous bytes a row and
//     warp).  The wgmma of step s runs while the codes of step s + 1 are
//     widened; a stage goes back to the producer once the wgmma that read
//     its x tile has retired.  Per channel the fp32 scale multiplies in
//     the epilogue; grouped `post` scales (BM 128: a second accumulator)
//     start a partial sum (scale-d 0) at each 64-row plane step and add
//     it, times the group's scale, into the total at its end; the `tile`
//     rule multiplies the widened codes by the bf16 scale before the
//     product.
//     Where the grid underfills the card, K is split over a thread-block
//     cluster of S blocks (grid x; 128-row tiles only: the staged fp32
//     partial of 256 rows would not fit beside the ring).  Block s of a
//     cluster walks the s-th of S ranges of whole 64-row steps, so a split
//     boundary falls on a plane step and grouped `post` partials stay
//     whole; each block stages its partial (`tot` for grouped scales) in
//     the idle ring and the fold of split_k.cuh pushes each peer's rows to
//     it by bulk copies; the owner of a row slice sums the S slices in
//     split order (two calls are bit-identical), multiplies the per-channel
//     scale and runs the epilogue once, as unsplit.  The launcher plans x
//     rows a tile (128 or 256) and S (1-8) at the least modelled cost,
//     waves x (K steps a split x a step's cost + the fold), from the
//     clusters of each size the card keeps resident (asked once a device,
//     when the shared-memory attributes are set), and caches the tensor
//     maps by their arguments: at M 256 a llama_7b layer's GEMMs take S 2,
//     GPT-125M's 2-8; M 300 and M 1024 keep their unsplit tiles.  An
//     unsplit plan runs an instance compiled without the fold: with the
//     fold's code beside it the unsplit path ran up to 35 % slower
//     (tools/wo_ab.py, the down projection at M 256 on 128-row tiles).
//   * bf16 x, M <= 16 (decode): wo_dec, the same swapped wgmma with the
//     same widening, shaped for 8 or 16 x rows (wgmma m64n8k16 /
//     m64n16k16, x zero-filled by TMA past M).  A block is 2 consumer
//     warpgroups of 64 channels (128 channels, one 128-byte code row) and
//     one producer warp that keeps a ring of ~100 KB full (stages of 64
//     code rows, 8 KB, and one NX-row x box a nibble plane; two blocks an
//     SM, ~200 KB of codes in flight an SM) over the block's whole K
//     range.  int4 reads each packed byte once: one ldmatrix.trans feeds
//     both planes, the low nibbles against x's low-plane box, then the
//     high ones against the high-plane box.  K is split over a thread-block
//     cluster whose size comes from the clusters the card keeps resident
//     (split_k.cuh: asked once a device, the split at the least modelled
//     cost; N 4096 is only 32 column tiles), and the splits' fp32 partials
//     are folded inside the launch by bulk-copy pushes to the owner of
//     each x row, summed in split order (bit-identical calls), scaled per
//     channel and stored as bf16 pairs.  Scales as in wo_wgmma: grouped
//     `post` scales start a fresh partial at each 64-row plane step and add
//     it, times the group's scale, into a running total; `tile` folds the
//     bf16 scale into the widened codes.  The host sets the shared-memory
//     attribute and asks the residency once a device, and caches the
//     tensor maps by their arguments.
//   * fp32 x (the correctness lane): wo_f32, plain FMA over 64 x 64
//     tiles, dequantizing each weight element in fp32 on its way into
//     shared memory (fp32 rounding either way).
// The serving chain's weight-only layer GEMMs (launch_wo_layer, called by
// layer.cu for a quantized Llama or GPT layer: TPU kernels 1-2's
// weight-only branch, paddle_tpu/ops/pallas/decode_block.py:195-221
// _mm_quant / _mmw) are these same kernels with an epilogue on the product
// rounded to x's dtype (WoArgs::epi, a runtime argument read once a stored
// pair after the main loop), each value rounded as the reference rounds it
// (common.cuh epi_value).  The Llama layer's: EPI_RESID adds the residual
// R (o and down projections), EPI_SWIGLU_R takes R as the gate product of
// the launch before and stores silu(R) * product (the up projection).  The
// GPT layer's add the bias B: EPI_BIAS (qkv, with WoArgs::qkv_d the pair
// stored into its head's q, k or v slab, gemm.cu's split), EPI_BIAS_RESID
// (proj, fc2), EPI_BIAS_GELU (fc1, tanh GELU); a thread's pairs share
// their channels' bias pair (wo_wgmma: loaded once; wo_dec: with each
// pair).  They always take the `post` scale rule, and count apart
// (CNT_WO_LAYER_*).
// Requirements checked here and by the wrapper: N % 16 == 0, ldx and xhi
// multiples of 8, 16-byte aligned x and codes; the wgmma kernels also
// take only group sizes that are powers of two (64, 128, or 1 << 30 per
// channel), and grouped `post` scales only where every group starts on a
// 64-row boundary of its nibble plane (the wrapper's scale_mode gives
// nothing else).
#include "mma.cuh"
#include "split_k.cuh"

namespace pt {
namespace wo {

// stages whose code boxes a producer issues before pdl_wait (gemm.cu's
// PDL_W_STAGES: more than one queued each stage's x box behind them and
// slowed every launch)
constexpr int PDL_W_STAGES = 1;

// ------------------------------------------------------------------ fp32
template <bool INT4>
__global__ void __launch_bounds__(256) wo_f32(const WoArgs a) {
  __shared__ float As[16][64 + 4];
  __shared__ float Bs[16][64];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.y * 64, n0 = blockIdx.x * 64;
  const float *X = (const float *)a.x;
  const int KV = INT4 ? 2 * a.half : a.K;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < KV; k0 += 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256, r = e >> 4, kk = e & 15;
      const int m = m0 + r, k = k0 + kk;
      float v = 0.f;
      if (m < a.M && k < a.K) {
        const int col = (!INT4 || k < a.half) ? k : a.xhi + (k - a.half);
        v = X[(size_t)m * a.ldx + col];
      }
      As[kk][r] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256, kk = e >> 6, c = e & 63;
      const int k = k0 + kk, n = n0 + c;
      float v = 0.f;
      if (k < KV && n < a.N) {
        int q;
        if (INT4) {
          const bool lo = k < a.half;
          const int b = a.w[(size_t)(lo ? k : k - a.half) * a.N + n];
          q = lo ? ((b & 0xF) ^ 8) - 8 : b >> 4;
        } else {
          q = a.w[(size_t)k * a.N + n];
        }
        const int grp = min(k / a.gs, a.G - 1);
        v = (float)q * __ldg(a.scale + (size_t)grp * a.N + n);
      }
      Bs[kk][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 16; ++kk) {
      float av[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
  float *Y = (float *)a.y;
  const float *R = (const float *)a.R, *B = (const float *)a.B;
  const bool rd = epi_reads_r(a.epi), biased = a.epi >= EPI_BIAS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < a.M && n < a.N)
        Y[out_index(m, n, a.M, a.N, a.qkv_d)] = epi_value<float>(
            a.epi, acc[i][j], biased ? B[n] : 0.f,
            rd ? R[(size_t)m * a.N + n] : 0.f);
    }
}

// ------------------------------------------------------- prefill: wgmma
enum { WO_CHANNEL = 0, WO_GROUPED = 1, WO_TILE = 2 };

// SPLIT_: the instance folds K splits (128-row tiles only); an unsplit
// launch takes an instance without the fold's code and staging
template <bool INT4_, int MODE_, int BM_, bool SPLIT_> struct Wg {
  static constexpr bool INT4 = INT4_;
  static constexpr int MODE = MODE_;
  static constexpr int BN = 128;               // channels: 2 warpgroups x 64
  static constexpr int BM = BM_;               // x rows: wgmma's N
  static constexpr int BK = 64;                // code rows a stage
  static constexpr int PLANES = INT4 ? 2 : 1;  // x boxes a stage
  static constexpr int XT = BM * 128;          // x box: BM rows x 64 bf16
  static constexpr int CT = BK * BN;           // code box: 64 rows x 128 B
  static constexpr int STAGE = PLANES * XT + CT;
  static constexpr int STAGES = 4 * STAGE <= 200 * 1024 ? 4 : 3;
  static constexpr int THREADS = 384;          // + a producer warpgroup
  static constexpr int REGS_PRODUCER = 40, REGS_CONSUMER = 232;
  static constexpr int NACC = BM / 2;          // fp32 accumulators a thread
  // K splits: 128-row tiles only (a staged partial of 256 rows and its
  // receive slots take 270 KB, past a block's 227 KB)
  static constexpr bool SPLITS = SPLIT_;
  static_assert(!SPLITS || BM == 128, "K splits fold 128-row tiles");
  using Fold = splitk::Tile<SPLITS ? 128 : 8>;  // the staged partial
  static constexpr int RING = STAGES * STAGE;
  static constexpr int BODY =
      SPLITS && Fold::BYTES > RING ? Fold::BYTES : RING;
  static constexpr int SMEM = 1024 + BODY + (2 * STAGES + 1) * 8;
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(SMEM <= 232448, "one block an SM");
  static_assert(BM == 128 || (BM == 256 && MODE != WO_GROUPED),
                "grouped scales keep two accumulators: 128 rows");
};

// the ldmatrix.trans word r of a thread holds the codes (k, A) (k, B)
// (k + 1, A) (k + 1, B) in its bytes, A and B the thread's two channels:
// widen_i8 (mma.cuh) gives the bf16 pairs (k, k + 1) of channel A (pa) and
// of channel B (pb)
__device__ __forceinline__ unsigned bf2_fma(unsigned a, unsigned b,
                                            unsigned c) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}
// the nibbles at bits 0..3 and 16..19 of v as a bf16 pair of signed codes:
// 0x4300 | (n ^ 8) is 128 + (n ^ 8), minus 136 is (n ^ 8) - 8
__device__ __forceinline__ unsigned nib_pair(unsigned v) {
  return bf2_fma((v & 0x000F000Fu) ^ 0x43084308u, 0x3F803F80u, 0xC308C308u);
}
// as widen_i8 for int4 bytes: the low nibbles (plane 0) or the high ones
__device__ __forceinline__ void widen_i4(unsigned r, int plane, unsigned &pa,
                                         unsigned &pb) {
  const unsigned v = plane ? r >> 4 : r;
  pa = nib_pair(v);
  pb = nib_pair(v >> 8);
}

// One block: channels [128 blockIdx.y, + 128), x rows [BM blockIdx.z, +
// BM), the K steps of split blockIdx.x of gridDim.x (the cluster).  Codes
// past N or K and x rows past M are TMA's zero fill; stores are masked.
// Unsplit, the consumers store straight from their accumulators; split,
// they stage the partial tile in the idle ring and fold it (split_k.cuh).
template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    wo_wgmma(const WoArgs a, const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap txlo,
             const __grid_constant__ CUtensorMap txhi) {
  using F = typename C::Fold;
  extern __shared__ unsigned char smem_raw[];
  unsigned char *smem = reinterpret_cast<unsigned char *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + C::BODY);
  uint64_t *empty = full + C::STAGES;
  uint64_t *recv_bar = empty + C::STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = gridDim.x, rank = blockIdx.x;
  const int n0 = blockIdx.y * C::BN, m0 = blockIdx.z * C::BM;
  const int nt = ((C::INT4 ? a.half : a.K) + C::BK - 1) / C::BK;
  const int kb0 = nt * rank / S, kb1 = nt * (rank + 1) / S;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                 // one arrival a consumer warp
    }
    mbar_init(recv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {                             // producer warpgroup
    regs_dec<C::REGS_PRODUCER>();
    if (warp == 8 && lane == 0) {
      // the code boxes of the ring's first PDL_W_STAGES stages, then (once
      // the kernel ahead has finished: common.cuh pdl_wait) their x boxes,
      // then the ring as before; one expect_tx a stage covers both
      const int first = min(kb1 - kb0, min(C::STAGES, PDL_W_STAGES));
      for (int it = 0; it < first; ++it) {
        mbar_expect_tx(&full[it], C::STAGE);
        tma_load_2d(smem + it * C::STAGE + C::PLANES * C::XT, &tw, n0,
                    (kb0 + it) * C::BK, &full[it]);
      }
      pdl_wait();
      for (int it = 0; it < first; ++it) {
        unsigned char *st = smem + it * C::STAGE;
        tma_load_2d(st, &txlo, (kb0 + it) * C::BK, m0, &full[it]);
        if (C::INT4)
          tma_load_2d(st + C::XT, &txhi, (kb0 + it) * C::BK, m0, &full[it]);
      }
      for (int kb = kb0 + first, it = first; kb < kb1; ++kb, ++it) {
        const int s = it % C::STAGES, round = it / C::STAGES;
        if (round) mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char *st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, &txlo, kb * C::BK, m0, &full[s]);
        if (C::INT4) tma_load_2d(st + C::XT, &txhi, kb * C::BK, m0, &full[s]);
        tma_load_2d(st + C::PLANES * C::XT, &tw, n0, kb * C::BK, &full[s]);
      }
    }
    // split: the fold's cluster barriers, without its work (code past a
    // merge would be compiled to the producer's 40 registers)
    if (C::SPLITS && S > 1) {
      __syncwarp();
      splitk::idle();
      splitk::done();
    }
    pdl_trigger();
    return;
  }
  regs_inc<C::REGS_CONSUMER>();

  // consumer warp `warp` owns the 16 channels of byte chunk `warp` of the
  // code rows: A / D row g of its slice is byte 2g, row g + 8 byte 2g + 1
  const int g = lane >> 2, t = lane & 3;
  const int chA = n0 + 16 * warp + 2 * g;      // D rows g, g + 8: chA, chA + 1
  // ldmatrix row addresses: lane l gives k row l of a 32-row half of the
  // code tile, its chunk swizzled as TMA wrote it
  const unsigned lane_off = lane * 128 + (((warp ^ lane) & 7) << 4);
  const int lg = 31 - __clz(a.gs);             // gs is a power of two
  float acc[C::NACC], tot[C::NACC];            // tot: grouped `post` only
#pragma unroll
  for (int i = 0; i < C::NACC; ++i) acc[i] = tot[i] = 0.f;

  // grouped `post`: tot += acc x the group's fp32 scale, once the wgmmas
  // writing acc have retired; at the end of every 64-row plane step (a
  // group's rows are one or two of them), so that no other instruction
  // writes acc while a wgmma is in flight
  auto flush = [&](int grp) {
    wg_wait<0>();
    fence_regs(acc);
    const float *sg = a.scale + (size_t)grp * a.N;
    const float sA = chA < a.N ? __ldg(sg + chA) : 0.f;
    const float sB = chA < a.N ? __ldg(sg + chA + 1) : 0.f;
#pragma unroll
    for (int j = 0; j < C::NACC; j += 4) {
      tot[j] = fmaf(acc[j], sA, tot[j]);
      tot[j + 1] = fmaf(acc[j + 1], sA, tot[j + 1]);
      tot[j + 2] = fmaf(acc[j + 2], sB, tot[j + 2]);
      tot[j + 3] = fmaf(acc[j + 3], sB, tot[j + 3]);
    }
    fence_regs(tot);                           // read acc before it is reused
  };
  // `tile`: the bf16 scale of (row, channel), as a factor of the codes
  auto tscale = [&](int row, int ch) {
    const int grp = min(row >> lg, a.G - 1);
    return ch < a.N ? __ldg(a.scale + (size_t)grp * a.N + ch) : 0.f;
  };

  for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
    const int s = it % C::STAGES;
    mbar_wait(&full[s], (it / C::STAGES) & 1);
    const unsigned char *st = smem + s * C::STAGE;
    const unsigned char *ct = st + C::PLANES * C::XT;
    unsigned cr[8];                            // k16 steps 0-1, then 2-3
    ldsm_x4_t(cr, ct + lane_off);
    ldsm_x4_t(cr + 4, ct + lane_off + 32 * 128);
    const uint64_t dlo = desc_sw128(st);
    const uint64_t dhi = C::INT4 ? desc_sw128(st + C::XT) : dlo;
#pragma unroll
    for (int v = 0; v < 4 * C::PLANES; ++v) {
      const int step = v & 3, plane = v >> 2;
      unsigned A[4];
      if (C::INT4) {
        widen_i4(cr[2 * step], plane, A[0], A[1]);
        widen_i4(cr[2 * step + 1], plane, A[2], A[3]);
      } else {
        widen_i8(cr[2 * step], A[0], A[1]);
        widen_i8(cr[2 * step + 1], A[2], A[3]);
      }
      const int vr = (plane ? a.half : 0) + kb * C::BK + 16 * step;
      if constexpr (C::MODE == WO_TILE) {
        unsigned sp[4];
        if ((vr >> lg) == ((vr + 15) >> lg)) {   // one group for the step
          const float sA = tscale(vr, chA), sB = tscale(vr, chA + 1);
          sp[0] = sp[2] = pack_bf16(sA, sA);
          sp[1] = sp[3] = pack_bf16(sB, sB);
        } else {
          const int r = vr + 2 * t;            // A rows: r, r + 1, r + 8, r + 9
          sp[0] = pack_bf16(tscale(r, chA), tscale(r + 1, chA));
          sp[1] = pack_bf16(tscale(r, chA + 1), tscale(r + 1, chA + 1));
          sp[2] = pack_bf16(tscale(r + 8, chA), tscale(r + 9, chA));
          sp[3] = pack_bf16(tscale(r + 8, chA + 1), tscale(r + 9, chA + 1));
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) A[i] = bf2_fma(A[i], sp[i], 0x80008000u);
      }
      // grouped: each plane step starts a fresh partial sum (scale-d 0)
      const bool fresh = C::MODE == WO_GROUPED && step == 0;
      fence_regs(A);
      wg_fence();
      WgmmaRS<C::BM>::mma(acc, A, (plane ? dhi : dlo) + 2 * step, !fresh);
      wg_commit();
      wg_wait<1>();
      // the wgmmas of the block's previous stage have retired: hand its
      // slot back
      if (v == 0 && it > 0 && lane == 0)
        mbar_arrive(&empty[(it - 1) % C::STAGES]);
      if constexpr (C::MODE == WO_GROUPED)
        if (step == 3) flush(min(vr >> lg, a.G - 1));
    }
  }
  wg_wait<0>();
  fence_regs(acc);
  // the last K stage is consumed: the kernel behind may start (a norm
  // under a programmatic dependency); the residual and the stores wait for
  // the kernel ahead
  pdl_trigger();
  pdl_wait();
  bf16 *Y = (bf16 *)a.y;
  const bool rd = epi_reads_r(a.epi);
  if (!C::SPLITS || S == 1) {
    if (chA >= a.N) return;
    // registers 4j' + e: D column 8j' + 2t + (e & 1), i.e. x row
    // m0 + 8j' + 2t (+1), of channel chA (e < 2) or chA + 1.
    // The pairs (row m; channels chA, chA + 1) in rounds of 2 UJ: the
    // round's residual / gate pairs loaded first, then its stores (R may be
    // Y itself: a thread reads only the pairs it writes); the bias pair of
    // the thread's two channels, and where its pairs go (column `col` of
    // rows `ld` apart: the qkv split puts them in their head's q, k or v
    // slab), once: an index worked out per store slowed llama_7b's M-256
    // layer GEMMs by ~18 % on an H100
    constexpr int UJ = 4;
    const float2 bias =
        a.epi >= EPI_BIAS
            ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(
                  (const bf16 *)a.B + chA))
            : make_float2(0.f, 0.f);
    const size_t col = out_index(0, chA, a.M, a.N, a.qkv_d);
    const size_t ld = a.qkv_d > 0 ? a.N / 3 : a.N;
    auto store = [&](const float(&v)[C::NACC], float sA, float sB) {
#pragma unroll
      for (int j0 = 0; j0 < C::NACC; j0 += 4 * UJ) {
        float2 r[2 * UJ];
#pragma unroll
        for (int u = 0; u < 2 * UJ; ++u) {
          const int m = m0 + 2 * (j0 + 4 * (u >> 1)) + 2 * t + (u & 1);
          r[u] = make_float2(0.f, 0.f);
          if (rd && m < a.M)
            r[u] = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162 *>(
                    (const bf16 *)a.R + (size_t)m * a.N + chA));
        }
#pragma unroll
        for (int u = 0; u < 2 * UJ; ++u) {
          const int j = j0 + 4 * (u >> 1), e = u & 1;
          const int m = m0 + 2 * j + 2 * t + e;
          if (m >= a.M) continue;
          float v0 = v[j + e] * sA, v1 = v[j + e + 2] * sB;
          if (a.epi != EPI_NONE) {
            v0 = epi_value<bf16>(a.epi, v0, bias.x, r[u].x);
            v1 = epi_value<bf16>(a.epi, v1, bias.y, r[u].y);
          }
          *reinterpret_cast<unsigned *>(Y + col + m * ld) = pack_bf16(v0, v1);
        }
      }
    };
    if constexpr (C::MODE == WO_CHANNEL) {
      store(acc, __ldg(a.scale + chA), __ldg(a.scale + chA + 1));
    } else if constexpr (C::MODE == WO_GROUPED) {
      store(tot, 1.f, 1.f);
    } else {
      store(acc, 1.f, 1.f);
    }
    return;
  }
  if constexpr (C::SPLITS) {
    float *red = reinterpret_cast<float *>(smem);             // [BM][LDR]
    float *recv = reinterpret_cast<float *>(smem + F::RED);   // [S][R][LDR]
    // the fold's operands of this thread, loaded before the staging and
    // the exchange so that their latency hides behind both: its channel
    // pair (tile column c, the same in every row it folds), that pair's
    // scale and bias, and the residual / gate pairs of its tile rows r1,
    // r1 + 4, ... of the block's share (at most BM / 8 rows at S >= 2)
    constexpr int RMAX = C::BM / 8;
    const splitk::Share sh = splitk::share_of<C::BM>(S, rank);
    const int nrow = max(0, min(sh.nr, a.M - m0 - sh.r0));
    const int c = 2 * (tid & 63), n = n0 + c, r1 = tid >> 6;
    const bool nok = n < a.N;
    float2 sc = make_float2(1.f, 1.f), bv = make_float2(0.f, 0.f), rv[RMAX];
    if (nok && C::MODE == WO_CHANNEL)
      sc = make_float2(__ldg(a.scale + n), __ldg(a.scale + n + 1));
    if (nok && a.epi >= EPI_BIAS)
      bv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162 *>((const bf16 *)a.B + n));
#pragma unroll
    for (int i = 0; i < RMAX; ++i) {
      const int r = r1 + 4 * i;
      rv[i] = make_float2(0.f, 0.f);
      if (nok && rd && r < nrow)
        rv[i] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162 *>(
            (const bf16 *)a.R + (size_t)(m0 + sh.r0 + r) * a.N + n));
    }
    // both warpgroups are done with the ring: stage the partial tile in it
    // as red[x row][channel - n0] (register 4j + e: x row 8j + 2t + e of
    // channel chA; 4j + e + 2: of chA + 1), for the bulk copies to read
    consumer_sync();
    const float(&part)[C::NACC] = C::MODE == WO_GROUPED ? tot : acc;
#pragma unroll
    for (int j = 0; j < C::BM / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2 *>(red + (8 * j + 2 * t + e) * F::LDR + chA -
                                    n0) =
            make_float2(part[4 * j + e], part[4 * j + e + 2]);
    fence_proxy_async_smem();
    splitk::push<C::BM>(red, recv, recv_bar, S, rank, tid);
    // my rows over the splits, in split order; per channel the fp32 scale
    // multiplies the sum, then the epilogue, as unsplit; bf16 pairs along N
    float2 x[RMAX];
#pragma unroll
    for (int i = 0; i < RMAX; ++i) x[i] = make_float2(0.f, 0.f);
#pragma unroll 1
    for (int q = 0; q < S; ++q) {
      const float *src =
          (q == rank ? red + sh.r0 * F::LDR : recv + q * sh.R * F::LDR) + c;
#pragma unroll
      for (int i = 0; i < RMAX; ++i)
        if (r1 + 4 * i < nrow) {
          const float2 v =
              *reinterpret_cast<const float2 *>(src + (r1 + 4 * i) * F::LDR);
          x[i].x += v.x;
          x[i].y += v.y;
        }
    }
    if (nok) {
      const size_t col = out_index(0, n, a.M, a.N, a.qkv_d);
      const size_t ld = a.qkv_d > 0 ? a.N / 3 : a.N;
#pragma unroll
      for (int i = 0; i < RMAX; ++i) {
        const int r = r1 + 4 * i;
        if (r >= nrow) continue;
        float v0 = x[i].x * sc.x, v1 = x[i].y * sc.y;
        if (a.epi != EPI_NONE) {
          v0 = epi_value<bf16>(a.epi, v0, bv.x, rv[i].x);
          v1 = epi_value<bf16>(a.epi, v1, bv.y, rv[i].y);
        }
        *reinterpret_cast<unsigned *>(Y + col + (size_t)(m0 + sh.r0 + r) *
                                                    ld) = pack_bf16(v0, v1);
      }
    }
    splitk::done();
  }
}

typedef void (*WoKernel)(const WoArgs, const CUtensorMap, const CUtensorMap,
                         const CUtensorMap);
struct WoInst {
  WoKernel fn;
  int smem;
};
template <bool INT4, int MODE, int BM, bool SPLIT> WoInst wg() {
  using C = Wg<INT4, MODE, BM, SPLIT>;
  return {wo_wgmma<C>, C::SMEM};
}
// instance 8 int4 + 3 mode + (128 rows unsplit, 128 rows split, 256 rows;
// grouped scales have no 256-row tiles)
constexpr int WG_INSTS = 16;
static const WoInst WG[WG_INSTS] = {
    wg<false, WO_CHANNEL, 128, false>(), wg<false, WO_CHANNEL, 128, true>(),
    wg<false, WO_CHANNEL, 256, false>(), wg<false, WO_GROUPED, 128, false>(),
    wg<false, WO_GROUPED, 128, true>(),  wg<false, WO_TILE, 128, false>(),
    wg<false, WO_TILE, 128, true>(),     wg<false, WO_TILE, 256, false>(),
    wg<true, WO_CHANNEL, 128, false>(),  wg<true, WO_CHANNEL, 128, true>(),
    wg<true, WO_CHANNEL, 256, false>(),  wg<true, WO_GROUPED, 128, false>(),
    wg<true, WO_GROUPED, 128, true>(),   wg<true, WO_TILE, 128, false>(),
    wg<true, WO_TILE, 128, true>(),      wg<true, WO_TILE, 256, false>()};
inline int wg_inst(bool int4, int mode, int bm, bool split) {
  const int i = mode == WO_CHANNEL ? (bm == 256 ? 2 : split)
                : mode == WO_GROUPED ? 3 + split
                                     : (bm == 256 ? 7 : 5 + split);
  return (int4 ? 8 : 0) + i;
}

// the current device's clusters of each size of every instance (once a
// device: split_k.cuh, which also sets the shared-memory attribute)
static splitk::ResidencyTable<WG_INSTS> wg_residency;

// The launch plan: x rows a tile (BM) and K splits (the cluster) at the
// least modelled cost, waves x (K steps a split x a step's cost + the
// fold): a 128-row tile's K step costs WG_STEP_128 / WG_STEP_256 of a
// 256-row one's (~0.6 measured at llama_7b widths), the staging and the
// fold WG_FOLD; ties go to 256 rows, then to fewer splits.  A split may
// take at most one wave more than the unsplit 128-row launch: each wave
// also pays a fixed 5-8 us (launch, ring fill, fold, epilogue) that the
// cost leaves out, and llama_7b's down projection at M 300 ran slower on
// 8 splits in 7 waves than unsplit in 1 (tools/wo_ab.py).  WG_FORCE_BM /
// WG_FORCE_SPLIT (0: planned) pin one choice (the tunings of
// tools/wo_ab.py).
constexpr int WG_STEP_128 = 6, WG_STEP_256 = 10, WG_FOLD = 8;
constexpr int WG_FORCE_BM = 0, WG_FORCE_SPLIT = 0;
struct WgPlan {
  int inst, bm, splits, row_tiles, col_tiles, nk, resident;
};
static WgPlan wg_plan(const WoArgs *a, int mode,
                      const splitk::Residency<WG_INSTS> &occ) {
  WgPlan best = {-1, 0, 0, 0, 0, 0, 0};
  const int rows = a->int4 ? a->half : a->K;   // code rows
  const int nk = (rows + 63) / 64, cols = (a->N + 127) / 128;
  long long best_cost = -1;
  for (int bm = 256; bm >= 128; bm -= 128) {
    // a pinned tile height binds where the scale rule allows both
    if ((bm == 256 && mode == WO_GROUPED) ||
        (WG_FORCE_BM && bm != WG_FORCE_BM && mode != WO_GROUPED))
      continue;
    const int rt = (a->M + bm - 1) / bm;
    const long long tiles = (long long)rt * cols;
    long long waves1 = tiles;                  // the unsplit launch's waves
    const int smax = bm == 128 ? splitk::MAX_SPLITS : 1;
    for (int s = 1; s <= smax && s <= nk; ++s) {
      if (WG_FORCE_SPLIT && s != (WG_FORCE_SPLIT < nk ? WG_FORCE_SPLIT : nk))
        continue;
      const int inst = wg_inst(a->int4, mode, bm, s > 1);
      const long long r = occ.clusters[inst][s];
      if (r <= 0) continue;
      const long long waves = (tiles + r - 1) / r;
      if (s == 1) waves1 = waves;
      else if (waves > waves1 + 1 && !WG_FORCE_SPLIT) continue;
      const long long cost =
          waves * ((long long)(nk + s - 1) / s * (bm == 128 ? WG_STEP_128
                                                            : WG_STEP_256) +
                   (s > 1 ? WG_FOLD : 0));
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = {inst, bm, s, rt, cols, nk, (int)r};
      }
    }
  }
  return best;
}

static cudaError_t wg_setup(const splitk::Residency<WG_INSTS> **occ) {
  splitk::KernelShape ks[WG_INSTS];
  for (int i = 0; i < WG_INSTS; ++i)
    ks[i] = {(const void *)WG[i].fn, 384, WG[i].smem};
  return wg_residency.get(ks, occ);
}

// the scale rule of a call (WO_*), or -1 where the wgmma kernels refuse it
int mode_of(const WoArgs *a) {
  if (a->gs & (a->gs - 1)) return -1;
  if (a->tile_dq || a->G == 1) return a->tile_dq ? WO_TILE : WO_CHANNEL;
  // grouped `post`: a group covers whole 64-row plane steps
  if (a->gs < 64 || (a->int4 && a->half % a->gs)) return -1;
  return WO_GROUPED;
}

// the plan of a prefill call (M > 16), or inst -1 where none fits
static cudaError_t plan_prefill(const WoArgs *a, WgPlan *p) {
  const int mode = mode_of(a);
  if (mode < 0) return cudaErrorInvalidValue;
  const splitk::Residency<WG_INSTS> *occ = nullptr;
  const cudaError_t e = wg_setup(&occ);
  if (e != cudaSuccess) return e;
  *p = wg_plan(a, mode, *occ);
  return p->inst < 0 || p->row_tiles > 65535 || p->col_tiles > 65535
             ? cudaErrorInvalidValue
             : cudaSuccess;
}

cudaError_t launch_prefill(const WoArgs *a, cudaStream_t s) {
  WgPlan p;
  cudaError_t e = plan_prefill(a, &p);
  if (e != cudaSuccess) return e;
  // codes [rows, N] in boxes of 64 rows x 128 bytes; x [M, cols] in boxes
  // of BM rows x 64 columns, int4's high plane from column xhi; cached by
  // their arguments (split_k.cuh)
  const int rows = a->int4 ? a->half : a->K;
  const bf16 *x = (const bf16 *)a->x;
  CUtensorMap tw, txlo, txhi;
  e = splitk::cached_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a->w, a->N,
                            rows, a->N, 128, 64);
  if (e == cudaSuccess)
    e = splitk::cached_map_2d(&txlo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x,
                              rows, a->M, 2 * (uint64_t)a->ldx, 64, p.bm);
  if (e == cudaSuccess && a->int4)
    e = splitk::cached_map_2d(&txhi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              x + a->xhi, a->K > a->half ? a->K - a->half : 1,
                              a->M, 2 * (uint64_t)a->ldx, 64, p.bm);
  if (e != cudaSuccess) return e;
  if (!a->int4) txhi = txlo;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.splits, p.col_tiles, p.row_tiles);
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = WG[p.inst].smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  cfg.attrs = attr;
  if (p.splits > 1) {                          // else a cluster of one
    attr[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
    attr[cfg.numAttrs].val.clusterDim.x = p.splits;
    attr[cfg.numAttrs].val.clusterDim.y = 1;
    attr[cfg.numAttrs++].val.clusterDim.z = 1;
  }
  if (launch_pdl()) attr[cfg.numAttrs++] = pdl_attr();
  e = cudaLaunchKernelEx(&cfg, WG[p.inst].fn, *a, tw, txlo, txhi);
  return e != cudaSuccess ? e : cudaGetLastError();
}


// -------------------------------------------------------- decode: wgmma
// x rows NX (wgmma's N: 8 or 16); a ring of ~100 KB, two blocks an SM
constexpr int DEC_THREADS = 288;               // 8 consumer warps + producer
template <bool INT4_, int MODE_, int NX_> struct Dec {
  static constexpr bool INT4 = INT4_;
  static constexpr int MODE = MODE_, NX = NX_;
  static constexpr int BN = 128;               // channels: 2 warpgroups x 64
  static constexpr int BK = 64;                // code rows a stage
  static constexpr int PLANES = INT4 ? 2 : 1;  // x boxes a stage
  static constexpr int CT = BK * BN;           // code box: 64 rows x 128 B
  static constexpr int XT = NX * 128;          // x box: NX rows x 64 bf16
  static constexpr int STAGE = CT + PLANES * XT;
  static constexpr int MINB = 2;               // blocks an SM
  static constexpr int RING = 100 * 1024;      // stage bytes a block
  static constexpr int STAGES = RING / STAGE;
  static constexpr int THREADS = DEC_THREADS;
  static constexpr int NACC = NX / 2;          // fp32 accumulators a thread
  using Fold = splitk::Tile<NX>;               // the staged partial tile
  static constexpr int BODY =
      STAGES * STAGE > Fold::BYTES ? STAGES * STAGE : Fold::BYTES;
  static constexpr int SMEM = 1024 + BODY + (2 * STAGES + 1) * 8;
  static_assert(STAGE % 1024 == 0, "stages stay 1024-byte aligned");
  static_assert(MINB * (SMEM + 1024) <= 233472, "MINB blocks an SM");
};

// wgmma's A fragment for k16 step `step` of a code tile from its
// ldmatrix.trans words (two a step): the int8 codes, or one int4 plane
template <bool INT4>
__device__ __forceinline__ void widen_step(const unsigned (&cr)[8], int step,
                                           int plane, unsigned (&A)[4]) {
  if (INT4) {
    widen_i4(cr[2 * step], plane, A[0], A[1]);
    widen_i4(cr[2 * step + 1], plane, A[2], A[3]);
  } else {
    widen_i8(cr[2 * step], A[0], A[1]);
    widen_i8(cr[2 * step + 1], A[2], A[3]);
  }
}

// `tile`: A times the bf16 scales of its codes, rows vr + (2t, 2t + 1,
// 2t + 8, 2t + 9) of channels ch (A[0], A[2]) and ch + 1 (A[1], A[3]) (as
// wo_wgmma's inline code, left as it is so its SASS stays byte-identical)
__device__ __forceinline__ void tile_scale(const WoArgs &a, int lg, int vr,
                                           int ch, int t, unsigned (&A)[4]) {
  auto sc = [&](int row, int c) {
    const int grp = min(row >> lg, a.G - 1);
    return c < a.N ? __ldg(a.scale + (size_t)grp * a.N + c) : 0.f;
  };
  unsigned sp[4];
  if ((vr >> lg) == ((vr + 15) >> lg)) {       // one group for the step
    const float sA = sc(vr, ch), sB = sc(vr, ch + 1);
    sp[0] = sp[2] = pack_bf16(sA, sA);
    sp[1] = sp[3] = pack_bf16(sB, sB);
  } else {
    const int r = vr + 2 * t;
    sp[0] = pack_bf16(sc(r, ch), sc(r + 1, ch));
    sp[1] = pack_bf16(sc(r, ch + 1), sc(r + 1, ch + 1));
    sp[2] = pack_bf16(sc(r + 8, ch), sc(r + 9, ch));
    sp[3] = pack_bf16(sc(r + 8, ch + 1), sc(r + 9, ch + 1));
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) A[i] = bf2_fma(A[i], sp[i], 0x80008000u);
}

// One block: channels [128 blockIdx.y, + 128), all M <= NX rows of x, K
// split blockIdx.x of gridDim.x (the cluster).  Codes past N or K and x
// rows past M are TMA's zero fill; stores are masked.
template <class C>
__global__ void __launch_bounds__(C::THREADS, C::MINB)
    wo_dec(const WoArgs a, const __grid_constant__ CUtensorMap tw,
           const __grid_constant__ CUtensorMap txlo,
           const __grid_constant__ CUtensorMap txhi) {
  using F = typename C::Fold;
  extern __shared__ unsigned char smem_raw[];
  unsigned char *smem = reinterpret_cast<unsigned char *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + C::BODY);
  uint64_t *empty = full + C::STAGES;
  uint64_t *recv_bar = empty + C::STAGES;
  float *red = reinterpret_cast<float *>(smem);              // [NX][LDR]
  float *recv = reinterpret_cast<float *>(smem + F::RED);    // [S][R][LDR]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int S = gridDim.x, rank = blockIdx.x, n0 = blockIdx.y * C::BN;
  const int nk = ((C::INT4 ? a.half : a.K) + C::BK - 1) / C::BK;
  const int kb0 = nk * rank / S, kb1 = nk * (rank + 1) / S;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                 // one arrival a consumer warp
    }
    mbar_init(recv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {                             // producer warp
    if (lane == 0) {
      // the code boxes of the ring's first PDL_W_STAGES stages, then (once
      // the kernel ahead has finished: common.cuh pdl_wait) their x boxes,
      // then the ring as before; one expect_tx a stage covers both
      const int first = min(kb1 - kb0, min(C::STAGES, PDL_W_STAGES));
      for (int it = 0; it < first; ++it) {
        mbar_expect_tx(&full[it], C::STAGE);
        tma_load_2d(smem + it * C::STAGE, &tw, n0, (kb0 + it) * C::BK,
                    &full[it]);
      }
      pdl_wait();
      for (int it = 0; it < first; ++it) {
        unsigned char *st = smem + it * C::STAGE;
        tma_load_2d(st + C::CT, &txlo, (kb0 + it) * C::BK, 0, &full[it]);
        if (C::INT4)
          tma_load_2d(st + C::CT + C::XT, &txhi, (kb0 + it) * C::BK, 0,
                      &full[it]);
      }
      for (int kb = kb0 + first, it = first; kb < kb1; ++kb, ++it) {
        const int s = it % C::STAGES, round = it / C::STAGES;
        if (round) mbar_wait_or_trap(&empty[s], (round - 1) & 1);
        unsigned char *st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, &tw, n0, kb * C::BK, &full[s]);
        tma_load_2d(st + C::CT, &txlo, kb * C::BK, 0, &full[s]);
        if (C::INT4)
          tma_load_2d(st + C::CT + C::XT, &txhi, kb * C::BK, 0, &full[s]);
      }
    }
    __syncwarp();
    splitk::idle();
    splitk::done();
    pdl_trigger();
    return;
  }

  // consumer warp `warp` owns the 16 channels of byte chunk `warp` of the
  // code rows: A / D row g of its slice is byte 2g, row g + 8 byte 2g + 1
  const int g = lane >> 2, t = lane & 3;
  const int chA = n0 + 16 * warp + 2 * g;      // D rows g, g + 8: chA, chA + 1
  // ldmatrix row addresses: lane l gives k row l of a 32-row half of the
  // code tile, its chunk swizzled as TMA wrote it
  const unsigned lane_off = lane * 128 + (((warp ^ lane) & 7) << 4);
  const int lg = 31 - __clz(a.gs);             // gs is a power of two
  // acc: written first by a wgmma with scale-d 0 (best_split gives every
  // block a K step); tot: grouped `post` only
  float acc[C::NACC], tot[C::NACC];
#pragma unroll
  for (int i = 0; i < C::NACC; ++i) tot[i] = 0.f;

  for (int kb = kb0, it = 0; kb < kb1; ++kb, ++it) {
    const int s = it % C::STAGES;
    mbar_wait_or_trap(&full[s], (it / C::STAGES) & 1);
    const unsigned char *st = smem + s * C::STAGE;
    unsigned cr[8];                            // k16 steps 0-1, then 2-3
    ldsm_x4_t(cr, st + lane_off);
    ldsm_x4_t(cr + 4, st + lane_off + 32 * 128);
    const uint64_t dlo = desc_sw128(st + C::CT);
    const uint64_t dhi = C::INT4 ? desc_sw128(st + C::CT + C::XT) : dlo;
#pragma unroll
    for (int v = 0; v < 4 * C::PLANES; ++v) {
      const int step = v & 3, plane = v >> 2;
      const int vr = (plane ? a.half : 0) + kb * C::BK + 16 * step;
      unsigned A[4];
      widen_step<C::INT4>(cr, step, plane, A);
      if constexpr (C::MODE == WO_TILE) tile_scale(a, lg, vr, chA, t, A);
      // the block's first wgmma, and grouped each plane step's, starts a
      // fresh partial sum (scale-d 0)
      const int keep = C::MODE == WO_GROUPED ? step != 0 : it > 0 || v > 0;
      fence_regs(A);
      wg_fence();
      WgmmaRS<C::NX>::mma(acc, A, (plane ? dhi : dlo) + 2 * step, keep);
      wg_commit();
      wg_wait<1>();
      // the wgmmas of the block's previous stage have retired: hand its
      // slot back
      if (v == 0 && it > 0 && lane == 0)
        mbar_arrive(&empty[(it - 1) % C::STAGES]);
      if constexpr (C::MODE == WO_GROUPED)
        if (step == 3) {                       // tot += acc x group scale
          wg_wait<0>();
          fence_regs(acc);
          const float *sg = a.scale + (size_t)min(vr >> lg, a.G - 1) * a.N;
          const float sA = chA < a.N ? __ldg(sg + chA) : 0.f;
          const float sB = chA < a.N ? __ldg(sg + chA + 1) : 0.f;
#pragma unroll
          for (int j = 0; j < C::NACC; j += 4) {
            tot[j] = fmaf(acc[j], sA, tot[j]);
            tot[j + 1] = fmaf(acc[j + 1], sA, tot[j + 1]);
            tot[j + 2] = fmaf(acc[j + 2], sB, tot[j + 2]);
            tot[j + 3] = fmaf(acc[j + 3], sB, tot[j + 3]);
          }
          fence_regs(tot);                     // read acc before its reuse
        }
    }
  }
  wg_wait<0>();
  fence_regs(acc);
  // the last K stage is consumed: the kernel behind may start (a norm
  // under a programmatic dependency); the residual and the stores wait for
  // the kernel ahead
  pdl_trigger();
  pdl_wait();
  // both warpgroups are done with the ring: stage the partial tile in it
  // as red[x row][channel - n0] (register 4j + e: x row 8j + 2t + e of
  // channel chA; 4j + e + 2: of chA + 1), for the bulk copies to read
  consumer_sync();
  const float(&part)[C::NACC] = C::MODE == WO_GROUPED ? tot : acc;
#pragma unroll
  for (int j = 0; j < C::NX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2 *>(red + (8 * j + 2 * t + e) * F::LDR + chA -
                                  n0) =
          make_float2(part[4 * j + e], part[4 * j + e + 2]);
  fence_proxy_async_smem();
  splitk::push<C::NX>(red, recv, recv_bar, S, rank, tid);
  // The epilogue: this thread owns the pair of channels c of rows r =
  // tid / 64 + 4 i of my share, summed over the splits in split order;
  // its scales (per channel the fp32 scale multiplies the sum), bias and
  // destination (the qkv split's slab and column) are taken once, not per
  // stored pair.  The loops stay rolled: unrolled, the int8 8-row
  // instance took 80 registers against 46 and its llama_7b decode GEMMs
  // ~3 % longer (tools/wo_ab.py, NVIDIA H100 80GB HBM3 at 700 W)
  const splitk::Share sh = splitk::share_of<C::NX>(S, rank);
  const int c = 2 * (tid & 63), n = n0 + c;
  const int rows = n < a.N ? max(0, min(sh.nr, a.M - sh.r0)) : 0;
  float2 sc = make_float2(1.f, 1.f);
  if (C::MODE == WO_CHANNEL && rows > 0)
    sc = make_float2(__ldg(a.scale + n), __ldg(a.scale + n + 1));
  unsigned bw[1] = {0u};
  if (a.epi >= EPI_BIAS && rows > 0)
    splitk::ldv<2>(bw, (const bf16 *)a.B + n);
  float bv[2];
  splitk::widen<2>(bv, bw);
  const splitk::ChunkDst<2> dst(n, a.M, a.N, a.qkv_d);
#pragma unroll 1
  for (int p = tid; p < rows << 6; p += 256) {
    const int r = p >> 6, m = sh.r0 + r;
    float y[2] = {0.f, 0.f}, rv[2];
#pragma unroll 1
    for (int q = 0; q < S; ++q)
      splitk::addv<2>(y, (q == rank ? red + sh.r0 * F::LDR
                                    : recv + q * sh.R * F::LDR) +
                             r * F::LDR + c);
    y[0] *= sc.x;
    y[1] *= sc.y;
    if (a.epi != EPI_NONE) {
      unsigned rw[1] = {0u};
      if (epi_reads_r(a.epi))
        splitk::ldv<2>(rw, (const bf16 *)a.R + (size_t)m * a.N + n);
      splitk::widen<2>(rv, rw);
      y[0] = epi_value<bf16>(a.epi, y[0], bv[0], rv[0]);
      y[1] = epi_value<bf16>(a.epi, y[1], bv[1], rv[1]);
    }
    const unsigned o[1] = {splitk::bf16x2(y[0], y[1])};
    dst.store((bf16 *)a.y, m, o);
  }
  splitk::done();
}

typedef void (*DecKernel)(const WoArgs, const CUtensorMap, const CUtensorMap,
                          const CUtensorMap);
struct DecInst {
  DecKernel fn;
  int smem;
};
template <bool INT4, int MODE, int NX> DecInst dec() {
  return {wo_dec<Dec<INT4, MODE, NX>>, Dec<INT4, MODE, NX>::SMEM};
}
// instance ((3 int4 + mode) x 2 + (M > 8))
constexpr int DEC_INSTS = 12;
static const DecInst DEC[DEC_INSTS] = {
    dec<false, WO_CHANNEL, 8>(), dec<false, WO_CHANNEL, 16>(),
    dec<false, WO_GROUPED, 8>(), dec<false, WO_GROUPED, 16>(),
    dec<false, WO_TILE, 8>(),    dec<false, WO_TILE, 16>(),
    dec<true, WO_CHANNEL, 8>(),  dec<true, WO_CHANNEL, 16>(),
    dec<true, WO_GROUPED, 8>(),  dec<true, WO_GROUPED, 16>(),
    dec<true, WO_TILE, 8>(),     dec<true, WO_TILE, 16>()};

// the current device's clusters of each size of every instance (once a
// device: split_k.cuh)
static splitk::ResidencyTable<DEC_INSTS> dec_residency;

// K splits at the least modelled cost (splitk::best_split), a 64-row step
// of codes weighed against FOLD_STEPS for the staging and the fold
constexpr int FOLD_STEPS = 12;

struct DecPlan {
  int inst, nx, splits, tiles, nk, resident;
};
static cudaError_t plan_decode(const WoArgs *a, DecPlan *p) {
  const int mode = mode_of(a);
  if (mode < 0) return cudaErrorInvalidValue;
  splitk::KernelShape ks[DEC_INSTS];
  for (int i = 0; i < DEC_INSTS; ++i)
    ks[i] = {(const void *)DEC[i].fn, DEC_THREADS, DEC[i].smem};
  const splitk::Residency<DEC_INSTS> *occ = nullptr;
  const cudaError_t e = dec_residency.get(ks, &occ);
  if (e != cudaSuccess) return e;
  p->inst = ((a->int4 ? 3 : 0) + mode) * 2 + (a->M > 8);
  p->nx = a->M > 8 ? 16 : 8;
  const int rows = a->int4 ? a->half : a->K;         // code rows
  p->nk = (rows + 63) / 64;
  p->tiles = (a->N + 127) / 128;
  const int *res = occ->clusters[p->inst];
  p->splits = splitk::best_split(p->tiles, p->nk, res, FOLD_STEPS);
  p->resident = res[p->splits];
  return cudaSuccess;
}

cudaError_t launch_decode(const WoArgs *a, cudaStream_t s) {
  DecPlan p;
  cudaError_t e = plan_decode(a, &p);
  if (e != cudaSuccess) return e;
  const int inst = p.inst, nx = p.nx, splits = p.splits, tiles = p.tiles;
  const int rows = a->int4 ? a->half : a->K;         // code rows
  // codes [rows, N] in boxes of 64 rows x 128 bytes; x [M, cols] in boxes
  // of nx rows x 64 columns, int4's high plane from column xhi
  const bf16 *x = (const bf16 *)a->x;
  CUtensorMap tw, txlo, txhi;
  e = splitk::cached_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a->w, a->N,
                            rows, a->N, 128, 64);
  if (e == cudaSuccess)
    e = splitk::cached_map_2d(&txlo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x,
                              rows, a->M, 2 * (uint64_t)a->ldx, 64, nx);
  if (e == cudaSuccess && a->int4)
    e = splitk::cached_map_2d(&txhi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                              x + a->xhi, a->K > a->half ? a->K - a->half : 1,
                              a->M, 2 * (uint64_t)a->ldx, 64, nx);
  if (e != cudaSuccess) return e;
  if (!a->int4) txhi = txlo;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, tiles);
  cfg.blockDim = dim3(DEC_THREADS);
  cfg.dynamicSmemBytes = DEC[inst].smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[2];
  cfg.attrs = attr;
  if (splits > 1) {                            // else a cluster of one
    attr[cfg.numAttrs].id = cudaLaunchAttributeClusterDimension;
    attr[cfg.numAttrs].val.clusterDim.x = splits;
    attr[cfg.numAttrs].val.clusterDim.y = 1;
    attr[cfg.numAttrs++].val.clusterDim.z = 1;
  }
  if (launch_pdl()) attr[cfg.numAttrs++] = pdl_attr();
  e = cudaLaunchKernelEx(&cfg, DEC[inst].fn, *a, tw, txlo, txhi);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace wo
}  // namespace pt

// the arguments every regime takes (0), or cudaErrorInvalidValue: any
// epilogue but EPI_SWIGLU (two products), R where it reads R, B with the
// bias epilogues; the qkv split with EPI_NONE / EPI_BIAS, an even head dim
// dividing N / 3
static cudaError_t check_wo(const WoArgs *a) {
  if (a->N % 16 || a->ldx % 8 || a->xhi % 8 || a->gs <= 0 || a->G <= 0 ||
      (a->x_dtype != PT_F32 && a->x_dtype != PT_BF16) ||
      a->epi < EPI_NONE || a->epi > EPI_BIAS_GELU || a->epi == EPI_SWIGLU ||
      (pt::epi_reads_r(a->epi) && !a->R) ||
      (a->epi >= EPI_BIAS && !a->B) ||
      (a->qkv_d && (a->qkv_d < 0 || a->qkv_d % 2 || a->N % (3 * a->qkv_d) ||
                    (a->epi != EPI_NONE && a->epi != EPI_BIAS))))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

static cudaError_t launch_f32(const WoArgs *a, cudaStream_t s) {
  using namespace pt::wo;
  const dim3 grid((a->N + 63) / 64, (a->M + 63) / 64);
  auto k = a->int4 ? wo_f32<true> : wo_f32<false>;
  k<<<grid, 256, 0, s>>>(*a);
  return cudaGetLastError();
}

cudaError_t launch_weight_only_matmul(const WoArgs *a, cudaStream_t s) {
  using namespace pt::wo;
  if (a->M <= 0 || a->N <= 0) return cudaSuccess;
  const cudaError_t e = check_wo(a);
  if (e != cudaSuccess) return e;
  if (a->x_dtype == PT_F32) return count_launch(CNT_WO_F32, launch_f32(a, s));
  if (a->M <= 16) {
    if (a->int4)
      return count_launch(CNT_WO_INT4_SMALL_M, launch_decode(a, s));
    return count_launch(CNT_WO_INT8_SMALL_M, launch_decode(a, s));
  }
  if (a->int4)
    return count_launch(CNT_WO_INT4_TILED, launch_prefill(a, s));
  return count_launch(CNT_WO_INT8_TILED, launch_prefill(a, s));
}

// the serving chain's layer GEMMs: the same kernels, the `post` scale rule
// only, an epilogue, counted apart
cudaError_t launch_wo_layer(const WoArgs *a, cudaStream_t s) {
  using namespace pt::wo;
  if (a->M <= 0 || a->N <= 0) return cudaSuccess;
  const cudaError_t e = a->tile_dq ? cudaErrorInvalidValue : check_wo(a);
  if (e != cudaSuccess) return e;
  if (a->x_dtype == PT_F32)
    return count_launch(CNT_WO_LAYER_F32, launch_f32(a, s));
  if (a->M <= 16) {
    if (a->int4)
      return count_launch(CNT_WO_LAYER_INT4_SMALL_M, launch_decode(a, s));
    return count_launch(CNT_WO_LAYER_INT8_SMALL_M, launch_decode(a, s));
  }
  if (a->int4)
    return count_launch(CNT_WO_LAYER_INT4_TILED, launch_prefill(a, s));
  return count_launch(CNT_WO_LAYER_INT8_TILED, launch_prefill(a, s));
}

// The launch plan of a bf16 call into out[8]: x rows a tile, K splits
// (the cluster), x row tiles, channel tiles, 64-row K steps, the clusters
// of this shape the device keeps resident, dynamic shared memory, blocks
// an SM (prefill, M > 16: wo_wgmma; decode: wo_dec); nothing launched.
// Not bound by build.py: tools/wo_ab.py and chip_smoke.py read it.
extern "C" int pt_wo_plan(const WoArgs *a, int *out) {
  using namespace pt::wo;
  const cudaError_t e = a->x_dtype == PT_BF16 ? check_wo(a)
                                              : cudaErrorInvalidValue;
  if (e != cudaSuccess) return e;
  if (a->M <= 16) {
    DecPlan p;
    const cudaError_t f = plan_decode(a, &p);
    if (f != cudaSuccess) return f;
    const int v[8] = {p.nx,       p.splits, 1, p.tiles, p.nk, p.resident,
                      DEC[p.inst].smem, Dec<false, WO_CHANNEL, 8>::MINB};
    for (int i = 0; i < 8; ++i) out[i] = v[i];
    return cudaSuccess;
  }
  WgPlan p;
  const cudaError_t f = plan_prefill(a, &p);
  if (f != cudaSuccess) return f;
  const int v[8] = {p.bm,       p.splits,   p.row_tiles,     p.col_tiles,
                    p.nk,       p.resident, WG[p.inst].smem, 1};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return cudaSuccess;
}

extern "C" int pt_weight_only_matmul(const WoArgs *a, void *stream) {
  return launch_weight_only_matmul(a, (cudaStream_t)stream);
}

// one layer GEMM of the quantized chain alone (timed and checked by
// chip_smoke.py)
extern "C" int pt_wo_layer(const WoArgs *a, void *stream) {
  return launch_wo_layer(a, (cudaStream_t)stream);
}
