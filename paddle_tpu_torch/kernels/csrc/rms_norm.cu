// rms_norm_rows: out[r] = (x[r] * rsqrt(mean(x[r]^2) + eps)) * w;
// layer_norm_rows: out[r] = ((x[r] - mean) * rsqrt(var + eps)) * w + b.
//
// The row norms of the decode_block / prefill_block chain (replace the
// norm stage of paddle_tpu/ops/pallas/decode_block.py::_kernel and
// prefill_block.py::_kernel: `_norm_rows`, decode_block.py:170-179, RMS
// for the Llama layer, LayerNorm with bias for the GPT layer).  The
// statistics run in fp32 and the scale is applied with the reference's
// rounding (ops/decode_block.py make_norm): RMS multiplies x by the fp32
// inverse rounded to the storage type and rounds each product to it;
// LayerNorm takes the mean and then the variance of the held row in fp32
// (two passes over registers), rounds (x - mean) * inverse (fp32) to the
// storage type, then the gain product and the bias sum each to it.  The
// eager path's layer_norm_fwd (norms.cu) is not reused: it rounds the
// mean and variance to x's dtype first (the JAX model's LayerNorm), where
// the serving reference keeps them in fp32.
//
// What bounds it on an H100: at the chain's rows (M 4 at decode, 256 in
// a prefill chunk) not bytes (32 KB at [4, 4096] bf16) but the latency of
// one row's pass: loads, block reductions, stores.  Design: one block a
// row holds the row in registers, each thread one to eight 16-byte
// vectors of x and of w (and b; H 4096 bf16: 512 threads x 8 elements,
// GPT-125M's H 768: 96 threads x 8), so x is read once and out written
// once, with every load of the row in flight together; a sum is reduced by
// warp shuffles and one shared-memory stage behind a single
// __syncthreads (RMS: one sum; LayerNorm: the sum, then the sum of squared
// deviations, each into its own stage).  Where H is not a multiple of a
// vector (8 bf16, 4 fp32), a pointer is not 16-byte aligned, or the row
// does not fit in 512 threads x 8 vectors, the same kernel takes a scalar
// path that reads x again for each pass.
#include <stdint.h>

#include "common.cuh"

namespace pt {
namespace rmsn {

constexpr int MAX_THREADS = 512, SCALAR_THREADS = 256, MAXV = 8;

// the block's sum of v (every thread gets it), through `stage`
__device__ __forceinline__ float block_sum(float v, float *stage) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  if (lane == 0) stage[warp] = v;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < nwarps; ++i) tot += stage[i];
  return tot;
}

// one row: LN false the RMS norm (b unused), true the LayerNorm
template <typename T, int V, bool LN>
__device__ __forceinline__ void norm_row(const T *__restrict__ x,
                                         const T *__restrict__ w,
                                         const T *__restrict__ b,
                                         T *__restrict__ out, int H,
                                         float eps, bool vec) {
  constexpr int E = 16 / (int)sizeof(T);
  __shared__ float red[2][MAX_THREADS / 32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t row = (size_t)blockIdx.x * H;
  const int nv = H / E;
  uint4 xv[V], wv[V], bv[LN ? V : 1];
  float s1 = 0.f;                  // RMS: sum of squares; LN: sum
  // LayerNorm (launched under a programmatic dependency in the GPT chain):
  // the next kernel may start now; the gains and biases are loaded, then x
  // once the kernel ahead has finished (common.cuh pdl_wait)
  if constexpr (LN) pdl_trigger();
  if (vec) {
    const uint4 *xr = reinterpret_cast<const uint4 *>(x + row);
    const uint4 *wr = reinterpret_cast<const uint4 *>(w);
    if constexpr (LN) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int i = tid + v * nt;
        if (i < nv) {
          wv[v] = __ldg(wr + i);
          bv[v] = __ldg(reinterpret_cast<const uint4 *>(b) + i);
        }
      }
      pdl_wait();
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * nt;
      if (i < nv) {
        xv[v] = __ldg(xr + i);
        if constexpr (!LN) wv[v] = __ldg(wr + i);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (tid + v * nt < nv) {
        const T *e = reinterpret_cast<const T *>(&xv[v]);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float f = to_f<T>(e[k]);
          s1 = LN ? s1 + f : fmaf(f, f, s1);
        }
      }
  } else {
    if constexpr (LN) pdl_wait();
    for (int i = tid; i < H; i += nt) {
      const float f = to_f<T>(x[row + i]);
      s1 = LN ? s1 + f : fmaf(f, f, s1);
    }
  }
  const float tot = block_sum(s1, red[0]);
  float mu = 0.f, inv;
  if constexpr (LN) {
    mu = tot / (float)H;
    float s2 = 0.f;
    if (vec) {
#pragma unroll
      for (int v = 0; v < V; ++v)
        if (tid + v * nt < nv) {
          const T *e = reinterpret_cast<const T *>(&xv[v]);
#pragma unroll
          for (int k = 0; k < E; ++k) {
            const float d = to_f<T>(e[k]) - mu;
            s2 = fmaf(d, d, s2);
          }
        }
    } else {
      for (int i = tid; i < H; i += nt) {
        const float d = to_f<T>(x[row + i]) - mu;
        s2 = fmaf(d, d, s2);
      }
    }
    inv = 1.0f / sqrtf(block_sum(s2, red[1]) / (float)H + eps);
  } else {
    inv = rnd<T>(1.0f / sqrtf(tot / (float)H + eps));
  }
  // the scaled value with the reference's rounding
  auto scaled = [&](float xf, float wf, float bf) {
    if constexpr (LN)
      return from_f<T>(__fadd_rn(
          rnd<T>(__fmul_rn(rnd<T>(__fmul_rn(xf - mu, inv)), wf)), bf));
    else
      return from_f<T>(rnd<T>(xf * inv) * wf);
  };
  if (vec) {
    uint4 *orow = reinterpret_cast<uint4 *>(out + row);
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * nt;
      if (i < nv) {
        const T *xe = reinterpret_cast<const T *>(&xv[v]);
        const T *we = reinterpret_cast<const T *>(&wv[v]);
        const T *be = reinterpret_cast<const T *>(&bv[LN ? v : 0]);
        uint4 o;
        T *oe = reinterpret_cast<T *>(&o);
#pragma unroll
        for (int k = 0; k < E; ++k)
          oe[k] = scaled(to_f<T>(xe[k]), to_f<T>(we[k]),
                         LN ? to_f<T>(be[k]) : 0.f);
        orow[i] = o;
      }
    }
  } else {
    for (int i = tid; i < H; i += nt)
      out[row + i] = scaled(to_f<T>(x[row + i]), to_f<T>(w[i]),
                            LN ? to_f<T>(b[i]) : 0.f);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    rms_norm_rows_kernel(const T *__restrict__ x, const T *__restrict__ w,
                         T *__restrict__ out, int H, float eps, bool vec) {
  norm_row<T, V, false>(x, w, nullptr, out, H, eps, vec);
}

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    layer_norm_rows_kernel(const T *__restrict__ x, const T *__restrict__ w,
                           const T *__restrict__ b, T *__restrict__ out,
                           int H, float eps, bool vec) {
  norm_row<T, V, true>(x, w, b, out, H, eps, vec);
}

// a LayerNorm under launch_pdl() carries the programmatic-serialization
// attribute, so it may start before the kernel ahead of it ends
template <typename T, int V>
static void start(bool ln, int M, int nt, const T *x, const T *w, const T *b,
                  T *out, int H, float eps, bool vec, cudaStream_t s) {
  if (ln && launch_pdl()) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(M);
    cfg.blockDim = dim3(nt);
    cfg.stream = s;
    cudaLaunchAttribute attr[1] = {pdl_attr()};
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaLaunchKernelEx(&cfg, layer_norm_rows_kernel<T, V>, x, w, b, out, H,
                       eps, vec);
  } else if (ln) {
    layer_norm_rows_kernel<T, V><<<M, nt, 0, s>>>(x, w, b, out, H, eps, vec);
  } else {
    rms_norm_rows_kernel<T, V><<<M, nt, 0, s>>>(x, w, out, H, eps, vec);
  }
}

template <typename T>
cudaError_t launch(bool ln, int M, int H, const void *x, const void *w,
                   const void *b, void *out, float eps, cudaStream_t s) {
  constexpr int E = 16 / (int)sizeof(T);
  const bool aligned = (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out |
                         (ln ? (uintptr_t)b : 0)) & 15) == 0;
  const int nv = H / E;
  const bool vec = aligned && H % E == 0 && nv <= MAX_THREADS * MAXV;
  const T *xt = (const T *)x, *wt = (const T *)w, *bt = (const T *)b;
  T *ot = (T *)out;
  if (!vec) {
    start<T, 1>(ln, M, SCALAR_THREADS, xt, wt, bt, ot, H, eps, false, s);
    return cudaGetLastError();
  }
  const int V = nv <= MAX_THREADS ? 1 : nv <= 2 * MAX_THREADS ? 2
              : nv <= 4 * MAX_THREADS ? 4 : 8;
  const int per = (nv + V - 1) / V;
  const int nt = per < 32 ? 32 : (per + 31) / 32 * 32;
  if (V == 1)
    start<T, 1>(ln, M, nt, xt, wt, bt, ot, H, eps, true, s);
  else if (V == 2)
    start<T, 2>(ln, M, nt, xt, wt, bt, ot, H, eps, true, s);
  else if (V == 4)
    start<T, 4>(ln, M, nt, xt, wt, bt, ot, H, eps, true, s);
  else
    start<T, 8>(ln, M, nt, xt, wt, bt, ot, H, eps, true, s);
  return cudaGetLastError();
}

}  // namespace rmsn
}  // namespace pt

cudaError_t launch_rms_norm_rows(int dtype, int M, int H, const void *x,
                                 const void *w, void *out, float eps,
                                 cudaStream_t s) {
  if (M <= 0) return cudaSuccess;
  const cudaError_t e =
      dtype == PT_BF16
          ? pt::rmsn::launch<pt::bf16>(false, M, H, x, w, nullptr, out, eps, s)
          : pt::rmsn::launch<float>(false, M, H, x, w, nullptr, out, eps, s);
  return count_launch(CNT_RMS_NORM_ROWS, e);
}

cudaError_t launch_layer_norm_rows(int dtype, int M, int H, const void *x,
                                   const void *w, const void *b, void *out,
                                   float eps, cudaStream_t s) {
  if (M <= 0) return cudaSuccess;
  if (!b) return cudaErrorInvalidValue;
  const cudaError_t e =
      dtype == PT_BF16
          ? pt::rmsn::launch<pt::bf16>(true, M, H, x, w, b, out, eps, s)
          : pt::rmsn::launch<float>(true, M, H, x, w, b, out, eps, s);
  return count_launch(CNT_LAYER_NORM_ROWS, e);
}
