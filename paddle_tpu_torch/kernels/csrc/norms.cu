// Row normalisations of the eager training path: rms_norm_fwd,
// layer_norm_fwd and bias_residual_ln_fwd.
//
// Replace the TPU kernels of paddle_tpu/ops/pallas/norms.py:
//   rms_norm_fwd          _rms_kernel  (pallas_call at :52)
//   layer_norm_fwd        _ln_kernel   (pallas_call at :121)
//   bias_residual_ln_fwd  _bdrl_kernel (pallas_call at :274), its p = 0
//                         body: the JAX package never runs the kernel with
//                         dropout (training with p > 0 takes a composed
//                         path with an explicit mask, and so does the port)
// with their arithmetic: x (and bias, residual) upcast to fp32, fp32 sums,
// the two-pass variance mean((x - mean)^2), inv = 1 / sqrt(. + eps), the
// affine in fp32 and ONE rounding to x's dtype at the output.  Each kernel
// also writes the fp32 row statistics the backward reads: inv (rms_norm)
// or mean and inv (the two LayerNorms).  bias_residual_ln_fwd writes the
// pre-norm sum add = (x + bias) + residual rounded to x's dtype beside
// out, and normalises the fp32 sum (not the rounded one).
//
// Layouts: x, residual, out, add [R, H] contiguous in x's dtype (fp32 or
// bf16); the gains, LayerNorm bias and the residual bias fp32 [H] (the
// wrapper upcasts bf16 ones: exact, and the kernels upcast anyway); mean
// and inv fp32 [R].
//
// What bounds them on an H100: bytes.  Each reads x (and residual) once
// and writes out (and add) once, a few flops per element; at the eager
// path's shapes (Llama [8192, 4096], GPT [8192, 768], bf16) that is
// 40 / 7.5 / 15 us at 3.35 TB/s.  Design:
//   * One block per row.  The row is held in registers: a thread owns NV
//     chunks of 16 bytes (8 bf16 or 4 fp32 values), chunk c = threadIdx.x
//     + k * blockDim.x, so a warp's loads are coalesced and x is read from
//     device memory once; both reductions (the sum, then the centred sum
//     of squares) run over the registers.  NV is 1, 2, 4 or 8 and the block
//     at most 512 threads: rows up to 32768 bf16 / 16384 fp32 values.
//   * 16-byte loads and stores when H is a multiple of the chunk and every
//     pointer is 16-byte aligned (vec_ok); otherwise each chunk's values
//     are loaded one by one with a bound check, so any H works.
//   * Block sums: a warp shuffle, one shared slot per warp, and every warp
//     sums the slots itself (one barrier per reduction).
#include <stdint.h>

#include "common.cuh"

namespace pt {
namespace norms {

enum { RMS = 0, LN = 1, BRLN = 2 };
constexpr int MAX_THREADS = 512;

template <typename T>
__device__ __forceinline__ void load_chunk(const T *__restrict__ row, int c,
                                           int H, int vec_ok, float *v) {
  constexpr int VEC = 16 / sizeof(T);
  const int e0 = c * VEC;
  if (vec_ok && e0 + VEC <= H) {
    uint4 u = *reinterpret_cast<const uint4 *>(row + e0);
    const T *t = reinterpret_cast<const T *>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f<T>(t[j]);
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      v[j] = e0 + j < H ? to_f<T>(row[e0 + j]) : 0.f;
  }
}

// VEC fp32 values of an [H] vector at chunk c of a row of T (VEC of T's)
template <typename T>
__device__ __forceinline__ void load_vec_f32(const float *__restrict__ p,
                                             int c, int H, int vec_ok,
                                             float *v) {
  constexpr int VEC = 16 / sizeof(T);
  const int e0 = c * VEC;
  if (vec_ok && e0 + VEC <= H) {
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      float4 f = *reinterpret_cast<const float4 *>(p + e0 + j);
      v[j] = f.x;
      v[j + 1] = f.y;
      v[j + 2] = f.z;
      v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = e0 + j < H ? p[e0 + j] : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(T *__restrict__ row, int c, int H,
                                            int vec_ok, const float *v) {
  constexpr int VEC = 16 / sizeof(T);
  const int e0 = c * VEC;
  if (vec_ok && e0 + VEC <= H) {
    uint4 u;
    T *t = reinterpret_cast<T *>(&u);
#pragma unroll
    for (int j = 0; j < VEC; ++j) t[j] = from_f<T>(v[j]);
    *reinterpret_cast<uint4 *>(row + e0) = u;
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (e0 + j < H) row[e0 + j] = from_f<T>(v[j]);
  }
}

// The block's sum of v, returned to every thread.
__device__ __forceinline__ float block_sum(float v, float *red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();  // the slots of an earlier call have been read
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < nwarps ? red[lane] : 0.f);
}

template <typename T, int NV, int MODE>
__global__ void __launch_bounds__(MAX_THREADS)
    norm_fwd_kernel(NormArgs a, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[32];
  const int H = a.H;
  const size_t off = (size_t)blockIdx.x * H;
  const T *xr = static_cast<const T *>(a.x) + off;
  float v[NV][VEC];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    load_chunk<T>(xr, c, H, vec_ok, v[k]);
    if (MODE == BRLN) {
      float rv[VEC], bv[VEC];
      load_chunk<T>(static_cast<const T *>(a.res) + off, c, H, vec_ok, rv);
      load_vec_f32<T>(a.bias, c, H, vec_ok, bv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[k][j] = (v[k][j] + bv[j]) + rv[j];
      store_chunk<T>(static_cast<T *>(a.add) + off, c, H, vec_ok, v[k]);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      s += MODE == RMS ? v[k][j] * v[k][j] : v[k][j];
  }
  s = block_sum(s, red);
  float mean = 0.f, inv;
  if (MODE == RMS) {
    inv = 1.0f / sqrtf(s / (float)H + a.eps);
  } else {
    mean = s / (float)H;
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int e0 = (threadIdx.x + k * blockDim.x) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float d = v[k][j] - mean;
        ss += e0 + j < H ? d * d : 0.f;
      }
    }
    inv = 1.0f / sqrtf(block_sum(ss, red) / (float)H + a.eps);
  }
  T *orow = static_cast<T *>(a.out) + off;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c * VEC >= H) break;
    float wv[VEC], o[VEC];
    load_vec_f32<T>(a.w, c, H, vec_ok, wv);
    if (MODE == RMS) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = v[k][j] * inv * wv[j];
    } else {
      float bv[VEC];
      load_vec_f32<T>(a.b, c, H, vec_ok, bv);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o[j] = (v[k][j] - mean) * inv * wv[j] + bv[j];
    }
    store_chunk<T>(orow, c, H, vec_ok, o);
  }
  if (threadIdx.x == 0) {
    a.inv[blockIdx.x] = inv;
    if (MODE != RMS) a.mean[blockIdx.x] = mean;
  }
}

// threads per block and chunks per thread for a row of H values
static inline void shape_of(int H, int vec, int *threads, int *nv) {
  const int chunks = (H + vec - 1) / vec;
  int n = 1;
  while (n < 8 && (chunks + n - 1) / n > 256) n *= 2;
  const int t = (chunks + n - 1) / n;
  *nv = n;
  *threads = (t + 31) / 32 * 32;
}

static inline bool aligned16(const void *p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

template <typename T, int MODE>
static cudaError_t launch_t(const NormArgs *a, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  int threads, nv;
  shape_of(a->H, VEC, &threads, &nv);
  if (threads > MAX_THREADS) return cudaErrorInvalidValue;
  const int vec_ok = a->H % VEC == 0 && aligned16(a->x) && aligned16(a->res) &&
                     aligned16(a->out) && aligned16(a->add) &&
                     aligned16(a->bias) && aligned16(a->w) && aligned16(a->b);
  void (*kern)(NormArgs, int) =
      nv == 1   ? norm_fwd_kernel<T, 1, MODE>
      : nv == 2 ? norm_fwd_kernel<T, 2, MODE>
      : nv == 4 ? norm_fwd_kernel<T, 4, MODE>
                : norm_fwd_kernel<T, 8, MODE>;
  kern<<<a->R, threads, 0, s>>>(*a, vec_ok);
  return cudaGetLastError();
}

template <int MODE>
static cudaError_t launch_mode(const NormArgs *a, cudaStream_t s) {
  if (a->R <= 0 || a->H <= 0) return cudaErrorInvalidValue;
  if (!a->x || !a->w || !a->out || !a->inv) return cudaErrorInvalidValue;
  if (MODE != RMS && (!a->b || !a->mean)) return cudaErrorInvalidValue;
  if (MODE == BRLN && (!a->res || !a->bias || !a->add))
    return cudaErrorInvalidValue;
  if (a->dtype == PT_BF16) return launch_t<bf16, MODE>(a, s);
  if (a->dtype == PT_F32) return launch_t<float, MODE>(a, s);
  return cudaErrorInvalidValue;
}

}  // namespace norms
}  // namespace pt

extern "C" {

int pt_rms_norm_fwd(const NormArgs *a, void *stream) {
  return count_launch(CNT_RMS_NORM_FWD,
                      pt::norms::launch_mode<pt::norms::RMS>(
                          a, (cudaStream_t)stream));
}

int pt_layer_norm_fwd(const NormArgs *a, void *stream) {
  return count_launch(CNT_LAYER_NORM_FWD,
                      pt::norms::launch_mode<pt::norms::LN>(
                          a, (cudaStream_t)stream));
}

int pt_bias_residual_ln_fwd(const NormArgs *a, void *stream) {
  return count_launch(CNT_BIAS_RESIDUAL_LN_FWD,
                      pt::norms::launch_mode<pt::norms::BRLN>(
                          a, (cudaStream_t)stream));
}

}  // extern "C"
