// swiglu_fwd: out = silu(x) * y = x * sigmoid(x) * y.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused.py (_swiglu_kernel,
// pallas_call at :47, via swiglu :60) with its arithmetic: x and y upcast
// to fp32, (x * sigmoid(x)) * y in fp32 with sigmoid = 1 / (1 + exp(-x)),
// ONE rounding to x's dtype.  The backward is torch ops (the JAX VJP,
// _swiglu_bwd, is jnp too).
//
// Layouts: x, y, out contiguous, n elements each, one dtype (fp32 or bf16).
//
// What bounds it on an H100: bytes (two reads and one write per element;
// the Llama eager step's [8192, 11008] bf16 is 541 MB, 0.16 ms at 3.35
// TB/s).  Design: a grid-stride elementwise pass, 16-byte loads and stores
// (8 bf16 or 4 fp32 values a thread per iteration) when all three pointers
// are 16-byte aligned, the n % VEC tail (or everything, unaligned) one
// value at a time; the grid is capped at 16 blocks of 256 threads an SM.
#include <stdint.h>

#include "common.cuh"

namespace pt {
namespace swiglu {

constexpr int THREADS = 256;

__device__ __forceinline__ float silu_mul(float a, float b) {
  return a * (1.0f / (1.0f + expf(-a))) * b;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    swiglu_fwd_kernel(const T *__restrict__ x, const T *__restrict__ y,
                      T *__restrict__ out, long long n, int vec_ok) {
  constexpr int VEC = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nvec = vec_ok ? n / VEC : 0;
  for (long long i = tid; i < nvec; i += stride) {
    uint4 ua = reinterpret_cast<const uint4 *>(x)[i];
    uint4 ub = reinterpret_cast<const uint4 *>(y)[i];
    uint4 uo;
    const T *ta = reinterpret_cast<const T *>(&ua);
    const T *tb = reinterpret_cast<const T *>(&ub);
    T *to = reinterpret_cast<T *>(&uo);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      to[j] = from_f<T>(silu_mul(to_f<T>(ta[j]), to_f<T>(tb[j])));
    reinterpret_cast<uint4 *>(out)[i] = uo;
  }
  for (long long i = nvec * VEC + tid; i < n; i += stride)
    out[i] = from_f<T>(silu_mul(to_f<T>(x[i]), to_f<T>(y[i])));
}

static int grid_cap() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return 16 * sms;
}

template <typename T>
static cudaError_t launch_t(long long n, const void *x, const void *y,
                            void *out, cudaStream_t s) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec_ok = ((uintptr_t)x & 15) == 0 && ((uintptr_t)y & 15) == 0 &&
                     ((uintptr_t)out & 15) == 0;
  const long long work = vec_ok ? (n + VEC - 1) / VEC : n;
  static const int cap = grid_cap();
  const long long blocks = (work + THREADS - 1) / THREADS;
  swiglu_fwd_kernel<T><<<(int)(blocks < cap ? blocks : cap), THREADS, 0, s>>>(
      static_cast<const T *>(x), static_cast<const T *>(y),
      static_cast<T *>(out), n, vec_ok);
  return cudaGetLastError();
}

static cudaError_t launch(int dtype, long long n, const void *x,
                          const void *y, void *out, cudaStream_t s) {
  if (n <= 0 || !x || !y || !out) return cudaErrorInvalidValue;
  if (dtype == PT_BF16) return launch_t<bf16>(n, x, y, out, s);
  if (dtype == PT_F32) return launch_t<float>(n, x, y, out, s);
  return cudaErrorInvalidValue;
}

}  // namespace swiglu
}  // namespace pt

extern "C" int pt_swiglu_fwd(int dtype, long long n, const void *x,
                             const void *y, void *out, void *stream) {
  return count_launch(CNT_SWIGLU_FWD,
                      pt::swiglu::launch(dtype, n, x, y, out,
                                         (cudaStream_t)stream));
}
