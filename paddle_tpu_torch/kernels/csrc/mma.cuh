// Tensor-core and async-copy building blocks shared by the bf16 kernels
// (quant_linear.cu, flash_attention.cu, decode_attention.cu,
// paged_attention.cu): 16-, 8- and 4-byte cp.async copies with zero fill,
// their commit / wait, mma.sync m16n8k16 bf16 with fp32 accumulators,
// ldmatrix x4 (plain and transposed), bf16 packing and the exact widening
// of int8 codes; and the attention
// kernels' row copies into padded tiles, the two products on ldmatrix
// operands (S = Q K^T, O += P V), C-to-A fragment packing and exp2.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane >> 2, t = lane & 3):
//   A 16 x 16 row-major, 4 regs of 2 bf16: a0 (row g, cols 2t, 2t+1),
//     a1 (row g+8, same cols), a2 (row g, cols 2t+8, 2t+9), a3 (row g+8,
//     cols 2t+8, 2t+9);
//   B 16 x 8 (k x n), 2 regs: b0 (k rows 2t, 2t+1, col g), b1 (k rows
//     2t+8, 2t+9, col g);
//   C 16 x 8 fp32, 4 regs: c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8).
// So two neighbouring n8 C tiles, packed to bf16, are one A fragment:
// a0 = pack(C[j][0..1]), a1 = pack(C[j][2..3]), a2 = pack(C[j+1][0..1]),
// a3 = pack(C[j+1][2..3]).
#pragma once

#include "common.cuh"

namespace pt {

// 16 bytes global -> shared, asynchronous; `ok` false writes 16 zero bytes
// and reads nothing (src must still be a valid address)
__device__ __forceinline__ void cp16(void *dst, const void *src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 16 : 0));
}
// 8 bytes, as cp16
__device__ __forceinline__ void cp8(void *dst, const void *src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 8 : 0));
}
// 4 bytes, as cp16 (for fp32 / int32 rows without 16-byte alignment)
__device__ __forceinline__ void cp4(void *dst, const void *src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N committed groups of this thread are in flight
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// c += a . b on one m16n8k16 tile
__device__ __forceinline__ void mma_bf16(float *c, const unsigned *a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 in one register, lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned *>(&h);
}

// four 8 x 8 bf16 matrices from shared memory; lanes 8i .. 8i+7 give the
// row addresses of matrix i, register i receives it (lane l: row l >> 2,
// columns 2 (l & 3), +1).  The .trans form gives the transpose (lane l:
// rows 2 (l & 3), +1 of column l >> 2).
__device__ __forceinline__ void ldsm_x4(unsigned *r, const void *p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x4_t(unsigned *r, const void *p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// Per-lane shared-memory addresses for ldmatrix x4 on a tile of bf16 rows
// with leading dimension ld (elements), for lane l:
//   A fragment of the 16 x 16 block at (r0, c0), rows = m:
__device__ __forceinline__ int ldsm_a(int lane, int ld) {
  return (lane & 15) * ld + (lane >> 4) * 8;
}
//   B fragments of two n8 tiles (n 0..15) x k16 from rows = n, cols = k
//   (B^T stored row-major, no transpose): regs b0, b1 of tile 0, b0, b1
//   of tile 1
__device__ __forceinline__ int ldsm_bt(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}
//   the same from rows = k, cols = n (B stored row-major; use ldsm_x4_t)
__device__ __forceinline__ int ldsm_b(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// Pieces the forward and the backward share: cp.async row copies, the two
// products on ldmatrix operands, C-to-A fragment packing and exp2.
constexpr float LOG2E = 1.4426950408889634f;

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// rows [row0, row0 + ROWS) of one head of a [B, S, H, D] bf16 tensor (row
// r at src + r * rstride) into a shared tile of leading dimension D + 8,
// asynchronously, by a block of NTH threads; rows at or past nrows are
// zero-filled.  Thread x copies 16 bytes at column 8 (x % (D / 8)) of rows
// x / (D / 8) + i NTH / (D / 8): a fixed count, one pointer stepped by a
// fixed stride.
template <int D, int ROWS = 64, int NTH = 128>
__device__ __forceinline__ void cp_rows(bf16 *dst, const bf16 *src,
                                        size_t rstride, int row0,
                                        int nrows) {
  constexpr int CPR = D / 8, LD = D + 8, RS = NTH / CPR;
  static_assert(NTH % CPR == 0 && ROWS % RS == 0, "uneven row copy");
  const int r = row0 + threadIdx.x / CPR, col = threadIdx.x % CPR * 8;
  const bf16 *s = src + (size_t)r * rstride + col;
  const size_t step = RS * rstride;
  bf16 *d = dst + (r - row0) * LD + col;
#pragma unroll
  for (int i = 0; i < ROWS / RS; ++i, s += step) {
    const bool ok = r + i * RS < nrows;
    cp16(d + i * RS * LD, ok ? s : src, ok);
  }
}

// c[MT][NT] = A . Bt^T on MT m16 tiles: A 16 MT rows of a shared tile, Bt
// 8 NT rows of another, both [row][k] over 16 KS values of k, leading dim
// LD; each B fragment feeds all MT tiles
template <int MT, int NT, int KS, int LD>
__device__ __forceinline__ void mma_abt(float (*c)[NT][4], const bf16 *A,
                                        const bf16 *Bt, int lane) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      c[mt][j][0] = c[mt][j][1] = c[mt][j][2] = c[mt][j][3] = 0.f;
  const bf16 *pa = A + ldsm_a(lane, LD), *pb = Bt + ldsm_bt(lane, LD);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    unsigned af[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      ldsm_x4(af[mt], pa + mt * 16 * LD + kk * 16);
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      unsigned bf[4];
      ldsm_x4(bf, pb + n2 * 16 * LD + kk * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(c[mt][2 * n2], af[mt], bf[0], bf[1]);
        mma_bf16(c[mt][2 * n2 + 1], af[mt], bf[2], bf[3]);
      }
    }
  }
}

// c[MT][NT] += A . B: A in registers (MT x KS A fragments), B 16 KS rows of
// a shared tile [k][n], leading dim LD
template <int MT, int NT, int KS, int LD>
__device__ __forceinline__ void mma_ab(float (*c)[NT][4],
                                       unsigned (*a)[KS][4], const bf16 *B,
                                       int lane) {
  const bf16 *pb = B + ldsm_b(lane, LD);
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
      unsigned bf[4];
      ldsm_x4_t(bf, pb + kk * 16 * LD + n2 * 16);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        mma_bf16(c[mt][2 * n2], a[mt][kk], bf[0], bf[1]);
        mma_bf16(c[mt][2 * n2 + 1], a[mt][kk], bf[2], bf[3]);
      }
    }
}

// 2 KS neighbouring C tiles, rounded to bf16, as KS A fragments
template <int KS>
__device__ __forceinline__ void c_to_a(unsigned (*a)[4], const float (*c)[4]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    a[kk][0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
    a[kk][1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
    a[kk][2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    a[kk][3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// int8 codes widened exactly by the exponent-bias trick: a code byte ^ 0x80
// (code + 128) spliced under the fp32 exponent of 2^23 by one PRMT is the
// float 2^23 + 128 + code; one FADD of -(2^23 + 128) leaves the code.
// widen_f32: the four codes of word r (byte i -> f[i]) as floats;
// widen_i8: as bf16 pairs, bytes (0, 2) in pa and (1, 3) in pb, lo first
// (a code's fp32 bits below the top 16 are zero, so the top halves are
// its bf16)
__device__ __forceinline__ void widen_f32(unsigned r, float *f) {
  const unsigned u = r ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}
__device__ __forceinline__ void widen_i8(unsigned r, unsigned &pa,
                                         unsigned &pb) {
  float f[4];
  widen_f32(r, f);
  pa = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  pb = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

// 2^x in one MUFU.EX2 (denormal results flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace pt
