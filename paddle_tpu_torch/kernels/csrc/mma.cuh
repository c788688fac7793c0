// Tensor-core and async-copy building blocks shared by the bf16 kernels
// (quant_linear.cu, flash_attention.cu): 16- and 4-byte cp.async copies
// with zero fill, their commit / wait, mma.sync m16n8k16 bf16 with fp32
// accumulators, ldmatrix x4 (plain and transposed) and bf16 packing.
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

}  // namespace pt
