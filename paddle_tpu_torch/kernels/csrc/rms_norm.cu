// rms_norm_rows: out[r] = (x[r] * rsqrt(mean(x[r]^2) + eps)) * w.
//
// Part of the decode_block / prefill_block chain (replaces the norm stage
// of paddle_tpu/ops/pallas/decode_block.py::_kernel and
// prefill_block.py::_kernel).  The sum of squares runs in fp32 and the
// scale is applied with the reference's rounding (the fp32 inverse
// rounded to the storage type, each product rounded to it).
//
// What bounds it on an H100: at the chain's rows (M 4 at decode, 256 in
// a prefill chunk) not bytes (32 KB at [4, 4096] bf16) but the latency of
// one row's pass: loads, a block reduction, stores.  Design: one block a
// row holds the row in registers, each thread one to eight 16-byte
// vectors of x and of w (H 4096 bf16: 512 threads x 8 elements), so x is
// read once and out written once, with every load of the row in flight
// together; the sum of squares is reduced by warp shuffles and one
// shared-memory stage behind a single __syncthreads.  Where H is not a
// multiple of a vector (8 bf16, 4 fp32), a pointer is not 16-byte
// aligned, or the row does not fit in 512 threads x 8 vectors, the same
// kernel takes a scalar path that reads x twice (once for the sum, once
// for the output).
#include <stdint.h>

#include "common.cuh"

namespace pt {
namespace rmsn {

constexpr int MAX_THREADS = 512, SCALAR_THREADS = 256, MAXV = 8;

template <typename T, int V>
__global__ void __launch_bounds__(MAX_THREADS)
    rms_norm_rows_kernel(const T *__restrict__ x, const T *__restrict__ w,
                         T *__restrict__ out, int H, float eps, bool vec) {
  constexpr int E = 16 / (int)sizeof(T);
  __shared__ float red[MAX_THREADS / 32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nt + 31) >> 5;
  const size_t row = (size_t)blockIdx.x * H;
  float ss = 0.f;
  uint4 xv[V], wv[V];
  if (vec) {
    const uint4 *xr = reinterpret_cast<const uint4 *>(x + row);
    const uint4 *wr = reinterpret_cast<const uint4 *>(w);
    const int nv = H / E;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * nt;
      if (i < nv) {
        xv[v] = __ldg(xr + i);
        wv[v] = __ldg(wr + i);
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v)
      if (tid + v * nt < nv) {
        const T *e = reinterpret_cast<const T *>(&xv[v]);
#pragma unroll
        for (int k = 0; k < E; ++k) {
          const float f = to_f<T>(e[k]);
          ss = fmaf(f, f, ss);
        }
      }
  } else {
    for (int i = tid; i < H; i += nt) {
      const float f = to_f<T>(x[row + i]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = warp_sum(ss);
  if (lane == 0) red[warp] = ss;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < nwarps; ++i) tot += red[i];
  const float inv = rnd<T>(1.0f / sqrtf(tot / (float)H + eps));
  if (vec) {
    uint4 *orow = reinterpret_cast<uint4 *>(out + row);
    const int nv = H / E;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      const int i = tid + v * nt;
      if (i < nv) {
        const T *xe = reinterpret_cast<const T *>(&xv[v]);
        const T *we = reinterpret_cast<const T *>(&wv[v]);
        uint4 o;
        T *oe = reinterpret_cast<T *>(&o);
#pragma unroll
        for (int k = 0; k < E; ++k)
          oe[k] = from_f<T>(rnd<T>(to_f<T>(xe[k]) * inv) * to_f<T>(we[k]));
        orow[i] = o;
      }
    }
  } else {
    for (int i = tid; i < H; i += nt)
      out[row + i] = from_f<T>(rnd<T>(to_f<T>(x[row + i]) * inv) *
                               to_f<T>(w[i]));
  }
}

template <typename T>
cudaError_t launch(int M, int H, const void *x, const void *w, void *out,
                   float eps, cudaStream_t s) {
  constexpr int E = 16 / (int)sizeof(T);
  const bool aligned =
      (((uintptr_t)x | (uintptr_t)w | (uintptr_t)out) & 15) == 0;
  const int nv = H / E;
  const bool vec = aligned && H % E == 0 && nv <= MAX_THREADS * MAXV;
  const T *xt = (const T *)x, *wt = (const T *)w;
  T *ot = (T *)out;
  if (!vec) {
    rms_norm_rows_kernel<T, 1><<<M, SCALAR_THREADS, 0, s>>>(xt, wt, ot, H,
                                                            eps, false);
    return cudaGetLastError();
  }
  const int V = nv <= MAX_THREADS ? 1 : nv <= 2 * MAX_THREADS ? 2
              : nv <= 4 * MAX_THREADS ? 4 : 8;
  const int per = (nv + V - 1) / V;
  const int nt = per < 32 ? 32 : (per + 31) / 32 * 32;
  if (V == 1)
    rms_norm_rows_kernel<T, 1><<<M, nt, 0, s>>>(xt, wt, ot, H, eps, true);
  else if (V == 2)
    rms_norm_rows_kernel<T, 2><<<M, nt, 0, s>>>(xt, wt, ot, H, eps, true);
  else if (V == 4)
    rms_norm_rows_kernel<T, 4><<<M, nt, 0, s>>>(xt, wt, ot, H, eps, true);
  else
    rms_norm_rows_kernel<T, 8><<<M, nt, 0, s>>>(xt, wt, ot, H, eps, true);
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
          ? pt::rmsn::launch<pt::bf16>(M, H, x, w, out, eps, s)
          : pt::rmsn::launch<float>(M, H, x, w, out, eps, s);
  return count_launch(CNT_RMS_NORM_ROWS, e);
}
