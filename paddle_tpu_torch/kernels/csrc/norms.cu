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
// 40 / 7.5 / 15 us at 3.35 TB/s.  Design of the two LayerNorms:
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
// rms_norm_fwd (rms_fwd_kernel) keeps the arithmetic and the register-held
// row in a persistent grid: as many blocks as the card keeps resident
// (fewer with fewer rows), each looping over rows blockIdx.x + k gridDim.x,
// up to 512 threads a row (one 16-byte chunk a thread at H 4096 bf16).  A
// one-row-a-block body read the fp32 gain (16 KB at H 4096) from L2 for
// every row, after the block reduction; here each thread loads its slice
// of the gain into registers once.  The next row's x is loaded (16-byte
// chunks into registers, evict-first) before the current row reduces, so
// a block keeps two rows in flight; one barrier a row (the reduction's
// slots alternate between two sets), out stored evict-first, inv written
// per row.  Rows off the 16-byte chunks take the scalar loads without the
// prefetch.  (tools/pattn_ab.py on an NVIDIA H100 80GB HBM3 at 700 W, [8192,
// 4096] bf16: 256 threads with plain loads 0.0526 ms, evict-first loads
// 0.0509, and 512 threads 0.0499; a second row ahead 0.0502.)
#include <stdint.h>

#include "common.cuh"

namespace pt {
namespace norms {

enum { RMS = 0, LN = 1, BRLN = 2 };
constexpr int MAX_THREADS = 512;
// rms_norm_fwd's threads a row before two chunks a thread (512: one 16-byte
// chunk a thread at H 4096 bf16; the LayerNorms keep 256)
constexpr int RMS_PER = 512;

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
    for (int j = 0; j < VEC; ++j) s += v[k][j];
  }
  s = block_sum(s, red);
  const float mean = s / (float)H;
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
  const float inv = 1.0f / sqrtf(block_sum(ss, red) / (float)H + a.eps);
  T *orow = static_cast<T *>(a.out) + off;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    if (c * VEC >= H) break;
    float wv[VEC], o[VEC];
    load_vec_f32<T>(a.w, c, H, vec_ok, wv);
    float bv[VEC];
    load_vec_f32<T>(a.b, c, H, vec_ok, bv);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o[j] = (v[k][j] - mean) * inv * wv[j] + bv[j];
    store_chunk<T>(orow, c, H, vec_ok, o);
  }
  if (threadIdx.x == 0) {
    a.inv[blockIdx.x] = inv;
    a.mean[blockIdx.x] = mean;
  }
}

// rms_norm_fwd: the persistent row loop (see the note at the top)
template <typename T, int NV>
__global__ void __launch_bounds__(MAX_THREADS)
    rms_fwd_kernel(NormArgs a, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[2][32];
  const int H = a.H, R = a.R, step = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  const T *x = static_cast<const T *>(a.x);
  T *out = static_cast<T *>(a.out);
  float wv[NV][VEC];
#pragma unroll
  for (int k = 0; k < NV; ++k)
    load_vec_f32<T>(a.w, threadIdx.x + k * blockDim.x, H, vec_ok, wv[k]);
  // the next row's chunks (the 16-byte path)
  uint4 nxt[NV];
  auto fetch = [&](int r) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int e0 = (threadIdx.x + k * blockDim.x) * VEC;
      if (e0 < H)
        nxt[k] = __ldcs(reinterpret_cast<const uint4 *>(x + (size_t)r * H +
                                                        e0));
    }
  };
  int r = blockIdx.x;
  if (vec_ok && r < R) fetch(r);
  for (int it = 0; r < R; r += step, ++it) {
    float v[NV][VEC];
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (vec_ok) {
        const T *t = reinterpret_cast<const T *>(&nxt[k]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          v[k][j] = c * VEC < H ? to_f<T>(t[j]) : 0.f;
      } else {
        load_chunk<T>(x + (size_t)r * H, c, H, 0, v[k]);
      }
    }
    if (vec_ok && r + step < R) fetch(r + step);
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[k][j] * v[k][j];
    // the block sum: this row's slots are the other set from the last
    // row's, which every thread has read before this row's barrier
    s = warp_sum(s);
    if (lane == 0) red[it & 1][warp] = s;
    __syncthreads();
    s = warp_sum(lane < nwarps ? red[it & 1][lane] : 0.f);
    const float inv = 1.0f / sqrtf(s / (float)H + a.eps);
    T *orow = out + (size_t)r * H;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = threadIdx.x + k * blockDim.x;
      if (c * VEC >= H) break;
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = v[k][j] * inv * wv[k][j];
      if (vec_ok) {
        uint4 u;
        T *t = reinterpret_cast<T *>(&u);
#pragma unroll
        for (int j = 0; j < VEC; ++j) t[j] = from_f<T>(o[j]);
        __stcs(reinterpret_cast<uint4 *>(orow + c * VEC), u);
      } else {
        store_chunk<T>(orow, c, H, 0, o);
      }
    }
    if (threadIdx.x == 0) a.inv[r] = inv;
  }
}

// threads per block and chunks per thread for a row of H values, at most
// `per` threads before a thread takes twice the chunks
static inline void shape_of(int H, int vec, int *threads, int *nv,
                            int per) {
  const int chunks = (H + vec - 1) / vec;
  int n = 1;
  while (n < 8 && (chunks + n - 1) / n > per) n *= 2;
  const int t = (chunks + n - 1) / n;
  *nv = n;
  *threads = (t + 31) / 32 * 32;
}

static inline bool aligned16(const void *p) {
  return p == nullptr || ((uintptr_t)p & 15) == 0;
}

// blocks of an rms_fwd_kernel instance (dtype, NV) the card keeps resident
// at a block of 32 (w + 1) threads, per device (a table of this file's own:
// a function-local static of a template would be one object across every
// loaded copy of the library)
constexpr int MAX_DEVICES = 64;
static int g_resident[8][MAX_THREADS / 32][MAX_DEVICES];

template <typename T, int MODE>
static cudaError_t launch_t(const NormArgs *a, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  int threads, nv;
  shape_of(a->H, VEC, &threads, &nv, MODE == RMS ? RMS_PER : 256);
  if (threads > MAX_THREADS) return cudaErrorInvalidValue;
  const int vec_ok = a->H % VEC == 0 && aligned16(a->x) && aligned16(a->res) &&
                     aligned16(a->out) && aligned16(a->add) &&
                     aligned16(a->bias) && aligned16(a->w) && aligned16(a->b);
  const int k = nv == 1 ? 0 : nv == 2 ? 1 : nv == 4 ? 2 : 3;
  if constexpr (MODE == RMS) {
    void (*kern)(NormArgs, int) =
        k == 0 ? rms_fwd_kernel<T, 1> : k == 1 ? rms_fwd_kernel<T, 2>
        : k == 2 ? rms_fwd_kernel<T, 4> : rms_fwd_kernel<T, 8>;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    int *res = dev < MAX_DEVICES
                   ? &g_resident[4 * (VEC == 8) + k][threads / 32 - 1][dev]
                   : nullptr;
    int blocks = res ? *res : 0;
    if (blocks == 0) {
      int sms = 0, per = 0;
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kern, threads,
                                                          0);
      if (e != cudaSuccess) return e;
      blocks = sms * (per > 0 ? per : 1);
      if (res) *res = blocks;
    }
    kern<<<a->R < blocks ? a->R : blocks, threads, 0, s>>>(*a, vec_ok);
  } else {
    void (*kern)(NormArgs, int) =
        k == 0 ? norm_fwd_kernel<T, 1, MODE> : k == 1 ? norm_fwd_kernel<T, 2, MODE>
        : k == 2 ? norm_fwd_kernel<T, 4, MODE> : norm_fwd_kernel<T, 8, MODE>;
    kern<<<a->R, threads, 0, s>>>(*a, vec_ok);
  }
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
