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
// copies into shared memory (~4 GB a llama_7b layer) come next.
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
//     one FADD, then the exact top halves packed; int4: a nibble pair
//     masked under bf16 128 by one LOP3 and one bf16x2 FMA), so each code
//     is widened once a block, by one thread, for BM x rows.  A rows are
//     the channels in the order the bytes lie in a 16-byte chunk: row g
//     of a warp is byte 2g, row g + 8 byte 2g + 1, so a thread's two D
//     rows are two neighbouring channels and the epilogue stores bf16
//     pairs straight from the accumulators (32 contiguous bytes a row and
//     warp).  The wgmma of step s runs while the codes of step s + 1 are
//     widened; a stage goes back to the producer once the wgmma that read
//     its x tile has retired.  BM is 256 (half the widening a code of
//     128) unless 128-row tiles fill the SMs in clearly fewer waves (small
//     M).  Per channel the fp32 scale multiplies in the epilogue; grouped
//     `post` scales (BM 128: a second accumulator) start a partial sum
//     (scale-d 0) at each 64-row plane step and add it, times the group's
//     scale, into the total at its end; the `tile` rule multiplies the
//     widened codes by the bf16 scale before the product.
//   * bf16 x, M <= 16 (decode): wo_mma<SmallM>, mma.sync m16n8k16 over
//     16 x 128 output tiles (a code row's 128 bytes are one cache line),
//     4 warps of 16 x 32, 4 cp.async stages of 64 code rows, K split over
//     a thread block cluster of 8 (N = 4096: 32 column tiles x 8 = 256
//     blocks).  The B fragments are built in registers from the code bytes
//     in shared memory with the same exponent-bias trick; the columns of
//     each n8 fragment are permuted (fragment column c of tile j is
//     physical column NT * c + j), so one 4-byte shared load gives a
//     thread its codes for all NT tiles.  int4 reads each packed byte once
//     for both nibble planes.  The 8 blocks sum their fp32 partial tiles
//     through distributed shared memory, in split order, and write the
//     bf16 output: one launch, no workspace, deterministic.
//   * fp32 x (the correctness lane): wo_f32, plain FMA over 64 x 64
//     tiles, dequantizing each weight element in fp32 on its way into
//     shared memory (fp32 rounding either way).
// Requirements checked here and by the wrapper: N % 16 == 0, ldx and xhi
// multiples of 8, 16-byte aligned x and codes; the prefill kernel also
// takes only group sizes that are powers of two (64, 128, or 1 << 30 per
// channel), and grouped `post` scales only where every group starts on a
// 64-row boundary of its nibble plane (the wrapper's scale_mode gives
// nothing else).
#include <cooperative_groups.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace cg = cooperative_groups;

namespace pt {
namespace wo {

// code j (0..3) of the 4-byte word w as an exact float: int8 codes, or the
// low / high int4 nibbles; 0x4B000000 | u is 2^23 + u
template <bool INT4>
__device__ __forceinline__ float code_f(unsigned w, int j, bool hi) {
  if (INT4) {
    const unsigned nib = (hi ? w >> 4 : w) & 0x0F0F0F0Fu;
    return __int_as_float(
               __byte_perm(nib ^ 0x08080808u, 0x4B000000u, 0x7440 | j)) -
           8388616.f;                                   // 2^23 + 8
  }
  return __int_as_float(
             __byte_perm(w ^ 0x80808080u, 0x4B000000u, 0x7440 | j)) -
         8388736.f;                                     // 2^23 + 128
}

// the k rows 2t + {0, 1, 8, 9} of a B fragment: r = 0..3
__device__ __forceinline__ int roff(int r) { return (r & 1) + 8 * (r >> 1); }

template <int WM_, int WN_, int MT_, int NT_, int STEPS_, int STAGES_,
          int SPLITS_, bool INT4_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, MT = MT_, NT = NT_,
                       STEPS = STEPS_, STAGES = STAGES_, SPLITS = SPLITS_;
  static constexpr bool INT4 = INT4_;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  static constexpr int BKV = STEPS * 16;               // virtual k rows
  static constexpr int BKR = INT4 ? BKV / 2 : BKV;     // code rows
  static constexpr int LDX = BKV + 8;                  // bf16 per x row
  static constexpr int LDC = BN + 16;                  // bytes per code row
  static constexpr int XB = (BM * LDX * 2 + 127) / 128 * 128;
  static constexpr int CB = (BKR * LDC + 127) / 128 * 128;
  static constexpr int STAGE = XB + CB;
  static constexpr int SMEM =
      STAGES * STAGE > BM * BN * 4 ? STAGES * STAGE : BM * BN * 4;
  static_assert(NT == 4 || NT == 8, "4 or 8 n8 tiles a warp");
  static_assert(SPLITS > 1 && (BM * BN) % (SPLITS * THREADS) == 0,
                "the cluster's blocks share the tile's sum evenly");
};

// decode (M <= 16): 16 x 128 output tiles (a code row's 128 bytes are one
// cache line) over 64 code rows a stage, K split over a cluster of 8
// blocks
template <bool INT4>
using SmallM = Cfg<1, 4, 1, 4, INT4 ? 8 : 4, 4, 8, INT4>;

template <class C>
__global__ void __launch_bounds__(C::THREADS) wo_mma(const WoArgs a) {
  constexpr int WN = C::WN, MT = C::MT, NT = C::NT;
  constexpr bool INT4 = C::INT4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % WN, wm = warp / WN;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const bf16 *X = (const bf16 *)a.x;
  const signed char *W = a.w;
  const int R = INT4 ? a.half : a.K;                   // code rows
  const int ntiles = (R + C::BKR - 1) / C::BKR;
  // this block's code tiles: split blockIdx.z of C::SPLITS over K
  const int per = (ntiles + C::SPLITS - 1) / C::SPLITS;
  const int kt0 = blockIdx.z * per;
  const int nt = max(min(ntiles, kt0 + per) - kt0, 0);
  const int ncol0 = n0 + wn * NT * 8;                  // the warp's columns

  auto load_tile = [&](int tile, int stage) {
    unsigned char *base = smem + stage * C::STAGE;
    bf16 *xs = (bf16 *)base;
    unsigned char *cs = base + C::XB;
    const int r0 = tile * C::BKR;
    constexpr int CPR = C::BN / 16;                    // 16-byte chunks/row
    for (int c = tid; c < C::BKR * CPR; c += C::THREADS) {
      const int r = c / CPR, col = n0 + (c % CPR) * 16;
      const bool ok = r0 + r < R && col < a.N;
      cp16(cs + r * C::LDC + (c % CPR) * 16,
           ok ? W + (size_t)(r0 + r) * a.N + col : W, ok);
    }
    constexpr int XPR = C::BKV / 8;
    for (int c = tid; c < C::BM * XPR; c += C::THREADS) {
      const int m = c / XPR, vc = (c % XPR) * 8;
      int rel, col, lim;
      if (!INT4 || vc < C::BKR) {
        rel = r0 + vc;
        col = rel;
        lim = INT4 ? a.half : a.K;
      } else {
        rel = r0 + vc - C::BKR;
        col = a.xhi + rel;
        lim = a.K - a.half;
      }
      const bool ok = m0 + m < a.M && rel < lim;
      cp16(xs + m * C::LDX + vc, ok ? X + (size_t)(m0 + m) * a.ldx + col : X,
           ok);
    }
  };

  float part[MT][NT][4], tot[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][j][e] = tot[i][j][e] = 0.f;

  // tot += part * scale[grp] (1 when the scale is folded into the tile)
  auto flush = [&](int grp) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = ncol0 + NT * (2 * t + h) + j;
        const float s =
            a.tile_dq ? 1.f
                      : (n < a.N ? __ldg(a.scale + (size_t)grp * a.N + n)
                                 : 0.f);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          tot[i][j][h] = fmaf(part[i][j][h], s, tot[i][j][h]);
          tot[i][j][h + 2] = fmaf(part[i][j][h + 2], s, tot[i][j][h + 2]);
          part[i][j][h] = part[i][j][h + 2] = 0.f;
        }
      }
  };

  int cur = 0;                                         // current scale group
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < nt) load_tile(kt0 + s, s);
    cp_commit();
  }
  for (int lt = 0; lt < nt; ++lt) {
    const int it = kt0 + lt;
    cp_wait<C::STAGES - 2>();
    __syncthreads();
    {
      const int nx = lt + C::STAGES - 1;
      if (nx < nt) load_tile(kt0 + nx, nx % C::STAGES);
      cp_commit();
    }
    const unsigned char *base = smem + (lt % C::STAGES) * C::STAGE;
    const bf16 *xs = (const bf16 *)base;
    const unsigned char *cs = base + C::XB;
#pragma unroll
    for (int s = 0; s < C::STEPS; ++s) {
      const int vk = s * 16;                           // virtual row in tile
      const bool hi = INT4 && vk >= C::BKR;
      const int crow = hi ? vk - C::BKR : vk;          // code row in tile
      const int orow = (hi ? a.half : 0) + it * C::BKR + crow;
      if (!a.tile_dq) {
        const int grp = min(orow / a.gs, a.G - 1);
        if (grp != cur) {
          flush(cur);
          cur = grp;
        }
      }
      unsigned af[MT][4];
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bf16 *p = xs + (wm * MT * 16 + i * 16 + g) * C::LDX + vk + 2 * t;
        af[i][0] = *reinterpret_cast<const unsigned *>(p);
        af[i][1] = *reinterpret_cast<const unsigned *>(p + 8 * C::LDX);
        af[i][2] = *reinterpret_cast<const unsigned *>(p + 8);
        af[i][3] = *reinterpret_cast<const unsigned *>(p + 8 * C::LDX + 8);
      }
      unsigned wd[4][NT / 4];
      const unsigned char *cp =
          cs + (crow + 2 * t) * C::LDC + wn * NT * 8 + NT * g;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if constexpr (NT == 8) {
          const uint2 u =
              *reinterpret_cast<const uint2 *>(cp + roff(r) * C::LDC);
          wd[r][0] = u.x;
          wd[r][NT / 4 - 1] = u.y;
        } else {
          wd[r][0] = *reinterpret_cast<const unsigned *>(cp + roff(r) * C::LDC);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float f[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) f[r] = code_f<INT4>(wd[r][j / 4], j % 4, hi);
        if (a.tile_dq) {
          const int n = ncol0 + NT * g + j;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int grp = min((orow + 2 * t + roff(r)) / a.gs, a.G - 1);
            const float sv =
                n < a.N ? __ldg(a.scale + (size_t)grp * a.N + n) : 0.f;
            f[r] *= rnd<bf16>(sv);
          }
        }
        const unsigned b0 = pack_bf16(f[0], f[1]), b1 = pack_bf16(f[2], f[3]);
#pragma unroll
        for (int i = 0; i < MT; ++i) mma_bf16(part[i][j], af[i], b0, b1);
      }
    }
  }
  flush(cur);

  // each thread owns 2 NT contiguous columns of rows g and g + 8 of each
  // m16 tile: column nb + o holds n8 tile o % NT, fragment column
  // 2t + o / NT
  const int nb = ncol0 + 2 * NT * t;
  // the cluster's blocks hold one column tile's K splits: each puts its
  // fp32 partial tile in its shared memory; then each sums 1/SPLITS of
  // the tile over all of them, in split order, and writes it
  cp_wait<0>();
  __syncthreads();
  float *red = reinterpret_cast<float *>(smem);      // [BM][BN]
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int o = 0; o < 2 * NT; ++o) {
      const int row = wm * MT * 16 + i * 16 + g, col = nb - n0 + o;
      red[row * C::BN + col] = tot[i][o % NT][o / NT];
      red[(row + 8) * C::BN + col] = tot[i][o % NT][2 + o / NT];
    }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int PER = C::BM * C::BN / C::SPLITS;
  const int rank = (int)cluster.block_rank();
  bf16 *Y = (bf16 *)a.y;
  for (int idx = rank * PER + tid; idx < (rank + 1) * PER;
       idx += C::THREADS) {
    float acc = 0.f;
#pragma unroll
    for (int z = 0; z < C::SPLITS; ++z)
      acc += cluster.map_shared_rank(red, z)[idx];
    const int m = m0 + idx / C::BN, n = n0 + idx % C::BN;
    if (m < a.M && n < a.N) Y[(size_t)m * a.N + n] = __float2bfloat16(acc);
  }
  cluster.sync();           // the peers' shared memory stays until read
}

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
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty + 16 * i, n = n0 + tx + 16 * j;
      if (m < a.M && n < a.N) Y[(size_t)m * a.N + n] = acc[i][j];
    }
}

// the K splits of a column tile run as one cluster
template <class C>
cudaError_t launch_mma(const WoArgs *a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      wo_mma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a->N + C::BN - 1) / C::BN, (a->M + C::BM - 1) / C::BM,
                     C::SPLITS);
  cfg.blockDim = dim3(C::THREADS);
  cfg.dynamicSmemBytes = C::SMEM;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = C::SPLITS;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wo_mma<C>, *a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// ------------------------------------------------------- prefill: wgmma
enum { WO_CHANNEL = 0, WO_GROUPED = 1, WO_TILE = 2 };

template <bool INT4_, int MODE_, int BM_> struct Wg {
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
  static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
  static_assert(SMEM <= 232448, "one block an SM");
  static_assert(BM == 128 || (BM == 256 && MODE != WO_GROUPED),
                "grouped scales keep two accumulators: 128 rows");
};

// the ldmatrix.trans word r of a thread holds the codes (k, A) (k, B)
// (k + 1, A) (k + 1, B) in its bytes, A and B the thread's two channels;
// -> the bf16 pairs (k, k + 1) of channel A (pa) and of channel B (pb)
__device__ __forceinline__ void widen_i8(unsigned r, unsigned &pa,
                                         unsigned &pb) {
  const unsigned u = r ^ 0x80808080u;
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)),
              f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)),
              f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)),
              f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443));
  // 2^23 + 128 + code - (2^23 + 128): the exact code, whose fp32 bits
  // below the top 16 are zero, so the top halves are its bf16
  pa = __byte_perm(__float_as_uint(f0 - 8388736.f),
                   __float_as_uint(f2 - 8388736.f), 0x7632);
  pb = __byte_perm(__float_as_uint(f1 - 8388736.f),
                   __float_as_uint(f3 - 8388736.f), 0x7632);
}
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

template <class C>
__global__ void __launch_bounds__(C::THREADS, 1)
    wo_wgmma(const WoArgs a, const __grid_constant__ CUtensorMap tw,
             const __grid_constant__ CUtensorMap txlo,
             const __grid_constant__ CUtensorMap txhi) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char *smem = reinterpret_cast<unsigned char *>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t *full = reinterpret_cast<uint64_t *>(smem + C::STAGES * C::STAGE);
  uint64_t *empty = full + C::STAGES;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * C::BN, m0 = blockIdx.y * C::BM;
  const int nt = ((C::INT4 ? a.half : a.K) + C::BK - 1) / C::BK;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);                 // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= 8) {                             // producer warpgroup
    regs_dec<C::REGS_PRODUCER>();
    if (warp == 8 && lane == 0) {
      for (int kb = 0; kb < nt; ++kb) {
        const int s = kb % C::STAGES, round = kb / C::STAGES;
        if (round) mbar_wait(&empty[s], (round - 1) & 1);
        unsigned char *st = smem + s * C::STAGE;
        mbar_expect_tx(&full[s], C::STAGE);
        tma_load_2d(st, &txlo, kb * C::BK, m0, &full[s]);
        if (C::INT4) tma_load_2d(st + C::XT, &txhi, kb * C::BK, m0, &full[s]);
        tma_load_2d(st + C::PLANES * C::XT, &tw, n0, kb * C::BK, &full[s]);
      }
    }
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
    const float *S = a.scale + (size_t)grp * a.N;
    const float sA = chA < a.N ? __ldg(S + chA) : 0.f;
    const float sB = chA < a.N ? __ldg(S + chA + 1) : 0.f;
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

  for (int kb = 0; kb < nt; ++kb) {
    const int s = kb % C::STAGES;
    mbar_wait(&full[s], (kb / C::STAGES) & 1);
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
      // the wgmmas of stage kb - 1 have retired: hand its slot back
      if (v == 0 && kb > 0 && lane == 0)
        mbar_arrive(&empty[(kb - 1) % C::STAGES]);
      if constexpr (C::MODE == WO_GROUPED)
        if (step == 3) flush(min(vr >> lg, a.G - 1));
    }
  }
  wg_wait<0>();
  fence_regs(acc);
  if (chA >= a.N) return;
  // registers 4j' + e: D column 8j' + 2t + (e & 1), i.e. x row
  // m0 + 8j' + 2t (+1), of channel chA (e < 2) or chA + 1
  bf16 *Y = (bf16 *)a.y;
  auto store = [&](const float(&v)[C::NACC], float sA, float sB) {
#pragma unroll
    for (int j = 0; j < C::NACC; j += 4) {
      const int m = m0 + 2 * j + 2 * t;
      if (m < a.M)
        *reinterpret_cast<unsigned *>(Y + (size_t)m * a.N + chA) =
            pack_bf16(v[j] * sA, v[j + 2] * sB);
      if (m + 1 < a.M)
        *reinterpret_cast<unsigned *>(Y + (size_t)(m + 1) * a.N + chA) =
            pack_bf16(v[j + 1] * sA, v[j + 3] * sB);
    }
  };
  if constexpr (C::MODE == WO_CHANNEL) {
    store(acc, __ldg(a.scale + chA), __ldg(a.scale + chA + 1));
  } else if constexpr (C::MODE == WO_GROUPED) {
    store(tot, 1.f, 1.f);
  } else {
    store(acc, 1.f, 1.f);
  }
}

template <class C>
cudaError_t launch_wgmma(const WoArgs *a, cudaStream_t s) {
  const bf16 *x = (const bf16 *)a->x;
  CUtensorMap tw, txlo, txhi;
  // codes [R, N] in boxes of 64 rows x 128 bytes; x [M, cols] in boxes of
  // BM rows x 64 columns, int4's high plane from column xhi
  cudaError_t e = encode_map_2d(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, a->w,
                                a->N, C::INT4 ? a->half : a->K, a->N, C::BN,
                                C::BK);
  if (e == cudaSuccess)
    e = encode_map_2d(&txlo, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x,
                      C::INT4 ? a->half : a->K, a->M, 2 * (uint64_t)a->ldx,
                      64, C::BM);
  if (e == cudaSuccess && C::INT4)
    e = encode_map_2d(&txhi, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x + a->xhi,
                      a->K > a->half ? a->K - a->half : 1, a->M,
                      2 * (uint64_t)a->ldx,
                      64, C::BM);
  if (e != cudaSuccess) return e;
  if (!C::INT4) txhi = txlo;
  e = cudaFuncSetAttribute(
      wo_wgmma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((a->N + C::BN - 1) / C::BN, (a->M + C::BM - 1) / C::BM);
  wo_wgmma<C><<<grid, C::THREADS, C::SMEM, s>>>(*a, tw, txlo, txhi);
  return cudaGetLastError();
}

template <bool INT4, int MODE>
cudaError_t launch_rows(bool narrow, const WoArgs *a, cudaStream_t s) {
  return narrow ? launch_wgmma<Wg<INT4, MODE, 128>>(a, s)
                : launch_wgmma<Wg<INT4, MODE, 256>>(a, s);
}

template <bool INT4>
cudaError_t launch_prefill(const WoArgs *a, cudaStream_t s) {
  if (a->gs & (a->gs - 1)) return cudaErrorInvalidValue;
  if (!a->tile_dq && a->G > 1) {
    // grouped `post`: a group covers whole 64-row plane steps
    if (a->gs < 64 || (INT4 && a->half % a->gs)) return cudaErrorInvalidValue;
    return launch_wgmma<Wg<INT4, WO_GROUPED, 128>>(a, s);
  }
  // 256 x rows a block widen each code half as often as 128, but a small
  // grid leaves SMs idle: take 128 rows where they need fewer than 5/3 the
  // waves of 256 (a 128-row tile takes ~0.55-0.65 the time of a 256-row
  // one, measured at llama_7b widths)
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long cols = (a->N + 127) / 128;
  auto waves = [&](int bm) {
    return ((a->M + bm - 1) / bm * cols + sms - 1) / sms;
  };
  const bool narrow = 3 * waves(128) < 5 * waves(256);
  if (a->tile_dq) return launch_rows<INT4, WO_TILE>(narrow, a, s);
  return launch_rows<INT4, WO_CHANNEL>(narrow, a, s);
}

}  // namespace wo
}  // namespace pt

cudaError_t launch_weight_only_matmul(const WoArgs *a, cudaStream_t s) {
  using namespace pt::wo;
  if (a->M <= 0 || a->N <= 0) return cudaSuccess;
  if (a->N % 16 || a->ldx % 8 || a->xhi % 8 || a->gs <= 0 || a->G <= 0)
    return cudaErrorInvalidValue;
  if (a->x_dtype == PT_F32) {
    const dim3 grid((a->N + 63) / 64, (a->M + 63) / 64);
    auto k = a->int4 ? wo_f32<true> : wo_f32<false>;
    k<<<grid, 256, 0, s>>>(*a);
    return count_launch(CNT_WO_F32, cudaGetLastError());
  }
  if (a->x_dtype != PT_BF16) return cudaErrorInvalidValue;
  if (a->M <= 16) {
    if (a->int4)
      return count_launch(CNT_WO_INT4_SMALL_M, launch_mma<SmallM<true>>(a, s));
    return count_launch(CNT_WO_INT8_SMALL_M, launch_mma<SmallM<false>>(a, s));
  }
  if (a->int4)
    return count_launch(CNT_WO_INT4_TILED, launch_prefill<true>(a, s));
  return count_launch(CNT_WO_INT8_TILED, launch_prefill<false>(a, s));
}

extern "C" int pt_weight_only_matmul(const WoArgs *a, void *stream) {
  return launch_weight_only_matmul(a, (cudaStream_t)stream);
}
