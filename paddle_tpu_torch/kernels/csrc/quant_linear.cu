// Weight-only quantized matmul: y [M, N] = x [M, K] @ dequant(w, scale),
// int8 codes [K, N] or int4 codes halves-packed into int8 [ceil(K/2), N],
// fp32 scales per output channel or per group of 64 / 128 rows.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/quant_linear.py:
//   int8  _wo_kernel   (pallas_call at :150)
//   int4  _wo4_kernel  (pallas_call at :264)
// with their arithmetic: codes widened to x's dtype, fp32 accumulation,
// and the scale either multiplied in fp32 into each group's partial
// product (per-channel and groups of 128: the Pallas kernel's `post`) or
// folded into the weight in x's dtype before the product, the scale
// rounded to that dtype (groups of 64, where the Pallas kernel's 128-row
// block spans two groups: its `tile`; also the int4 groups the Pallas
// kernel refuses).  The output is written in x's dtype.
//
// What bounds it on an H100: at decode (M = batch 8) the code bytes —
// llama_7b's 202 M block weights a layer are 202 MB in int8 and 101 MB in
// int4, 60 / 30 us at 3.35 TB/s, against 4 flops per weight; at prefill
// (M = 1024) the tensor-core operations (2 M K N at 989 TFLOP/s bf16).
// Design, in this first version (wgmma and TMA are later work):
//   * bf16 x runs on tensor cores through mma.sync m16n8k16 (fp32
//     accumulators in registers).  The codes and x stream through a ring
//     of shared-memory stages filled with cp.async (16-byte copies, rows
//     past K / N and columns past the valid x zero-filled).  The B
//     fragments are built in registers straight from the code bytes in
//     shared memory — no dequantized tile is stored — with the
//     exponent-bias trick (byte ^ 0x80 spliced under 2^23 by one PRMT, one
//     FADD) in place of integer-to-float conversions.  The columns of each
//     n8 fragment are permuted (fragment column c of tile j is physical
//     column NT * c + j), so one 4- or 8-byte shared load gives a thread
//     its codes for all NT tiles and the epilogue stores 2 NT contiguous
//     columns per thread.
//   * int4 keeps the Pallas layout: a tile of packed rows [p0, p0 + BKR)
//     is two virtual k blocks, the low nibbles against x columns
//     [p0, p0 + BKR) and the high nibbles against x columns
//     [xhi + p0, ...), so each packed byte is read from memory once.
//   * The per-group fp32 scale ("post") keeps a second accumulator: when a
//     k16 step enters a new group the partial sums are scaled into the
//     total (per-channel: once, at the end).
//   * Two regimes, each its own kernel instance.  M <= 16 (decode) takes
//     16 x 128 output tiles, so each code row a block reads is one
//     128-byte line, 4 warps of 16 x 32, 4 stages of 64 code rows; K is
//     split over a thread block cluster of 8 (N = 4096: 32 column tiles
//     x 8 = 256 blocks).  The 8 blocks sum their fp32 partial tiles
//     through distributed shared memory, in split order, and write the
//     bf16 output: one launch, no workspace, deterministic.  M > 16 (prefill)
//     takes 64 x 128 tiles, 4 warps of 32 x 64, 3 stages of 64 virtual k
//     rows.
//   * fp32 x (the correctness lane) runs plain FMA over 64 x 64 tiles,
//     dequantizing each weight element in fp32 on its way into shared
//     memory (fp32 rounding either way).
// Requirements checked by the wrapper: N % 16 == 0, ldx and xhi multiples
// of 8, 16-byte aligned pointers.
#include <cooperative_groups.h>

#include "mma.cuh"

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
  static_assert(SPLITS == 1 || (BM * BN) % (SPLITS * THREADS) == 0,
                "the cluster's blocks share the tile's sum evenly");
};

// decode (M <= 16): 16 x 128 output tiles (a code row's 128 bytes are one
// cache line) over 64 code rows a stage, K split over a cluster of 8
// blocks; prefill (M > 16): 64 x 128 tiles, 4 warps of 32 x 64, 64
// virtual k rows a stage
template <bool INT4>
using SmallM = Cfg<1, 4, 1, 4, INT4 ? 8 : 4, 4, 8, INT4>;
template <bool INT4>
using Tiled = Cfg<2, 2, 2, 8, 4, 3, 1, INT4>;

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
  if constexpr (C::SPLITS > 1) {
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
  } else {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int m = m0 + wm * MT * 16 + i * 16 + g + 8 * h2;
        if (m >= a.M || nb >= a.N) continue;
        float v[2 * NT];
#pragma unroll
        for (int o = 0; o < 2 * NT; ++o)
          v[o] = tot[i][o % NT][2 * h2 + o / NT];
        uint4 *dst = reinterpret_cast<uint4 *>((bf16 *)a.y +
                                               (size_t)m * a.N + nb);
#pragma unroll
        for (int q = 0; q < NT / 4; ++q)
          dst[q] = make_uint4(pack_bf16(v[8 * q], v[8 * q + 1]),
                              pack_bf16(v[8 * q + 2], v[8 * q + 3]),
                              pack_bf16(v[8 * q + 4], v[8 * q + 5]),
                              pack_bf16(v[8 * q + 6], v[8 * q + 7]));
      }
  }
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

template <class C>
cudaError_t launch_mma(const WoArgs *a, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      wo_mma<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((a->N + C::BN - 1) / C::BN, (a->M + C::BM - 1) / C::BM,
                  C::SPLITS);
  if (C::SPLITS == 1) {
    wo_mma<C><<<grid, C::THREADS, C::SMEM, s>>>(*a);
    return cudaGetLastError();
  }
  // the K splits of a column tile run as one cluster
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
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
    return count_launch(CNT_WO_INT4_TILED, launch_mma<Tiled<true>>(a, s));
  return count_launch(CNT_WO_INT8_TILED, launch_mma<Tiled<false>>(a, s));
}

extern "C" int pt_weight_only_matmul(const WoArgs *a, void *stream) {
  return launch_weight_only_matmul(a, (cudaStream_t)stream);
}
