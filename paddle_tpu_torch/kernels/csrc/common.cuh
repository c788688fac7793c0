// Shared declarations of the port's hand-written Hopper kernels.
//
// Every kernel takes fp32 or bf16 storage (`dtype` PT_F32 / PT_BF16) and
// accumulates in fp32.  Host launch helpers return the cudaError_t of the
// launch (cudaGetLastError); the extern "C" entry points in layer.cu pass
// it on to the ctypes wrapper, which raises on anything but 0.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum { PT_F32 = 0, PT_BF16 = 1 };
// EPI_SWIGLU: Y = silu(X @ W) * (X @ W2), one launch (gemm_xw);
// EPI_SWIGLU_R: Y = silu(R) * (X @ W), R the gate product already stored in
// the model dtype (the weight-only chain's up projection, after its gate);
// the GPT layer's (gemm_xw and the weight-only launch_wo_layer, B the bias
// [N] in the model dtype):
// EPI_BIAS: Y = X @ W + B (qkv); EPI_BIAS_RESID: Y = R + (X @ W + B) (proj,
// fc2); EPI_BIAS_GELU: Y = gelu_tanh(X @ W + B) (fc1)
enum {
  EPI_NONE = 0,
  EPI_RESID = 1,
  EPI_SWIGLU = 2,
  EPI_SWIGLU_R = 3,
  EPI_BIAS = 4,
  EPI_BIAS_RESID = 5,
  EPI_BIAS_GELU = 6
};
// LayerArgs::norm and ::ffn
enum { NORM_RMS = 0, NORM_LN = 1 };
enum { FFN_SWIGLU = 0, FFN_GELU = 1 };

// One layer's launch description, shared by the decode and the prefill
// entry points: a Llama layer (norm NORM_RMS, ffn FFN_SWIGLU, rope 1,
// fused_qkv 0, bias 0; weights ln1_w .. down_w) or a GPT layer (NORM_LN,
// FFN_GELU, rope 0, fused_qkv 1, bias 1; weights ln1_w, ln1_b, qkv_w,
// qkv_b, proj_w, proj_b, ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b).  Each
// flag selects its stage on its own; the wrapper passes one of the two
// layouts.  Weight-only quantized (wq), either layout's matmul weights are
// codes and each has its fp32 scales (q_s .. down_s, or qkv_s .. fc2_s);
// the norm gains and the biases stay in `dtype`.  Mirrored field for field
// by the ctypes Structure in paddle_tpu_torch/kernels/build.py.
struct LayerArgs {
  int dtype;                  // PT_F32 | PT_BF16
  int M;                      // rows: decode batch B, or prefill chunk Ts
  int H, Hq, Hkv, D, F;       // hidden, q heads, kv heads, head dim, ffn
  int BS, NB, MB;             // page size, pool pages, table width
  int start;                  // prefill: position of row 0
  int wq;                     // matmul weights: 0 in `dtype`; 1 int8 codes
                              // [K, N]; 2 int4 codes halves-packed [K/2, N]
  int gs;                     // wq: rows a scale group (1 << 30: per channel)
  int kv_quant;               // 1: int8 pools with fp32 scale pools
  int norm;                   // NORM_RMS | NORM_LN (with ln1_b, ln2_b)
  int ffn;                    // FFN_SWIGLU | FFN_GELU (fc1 / fc2 + biases)
  int rope;                   // 1: rotate q and k by cos / sin; 0: no RoPE
  int fused_qkv;              // 1: one qkv product (qkv_w, qkv_b) stored
                              // into q, k, v = three consecutive [M, Hq D]
                              // slabs of one buffer; proj_w for o
  int bias;                   // 1: proj_b on the out-projection
  float eps, scale;
  const void *x, *ln1_w, *q_w, *k_w, *v_w, *o_w, *ln2_w, *gate_w, *up_w,
      *down_w;                // norm gains in `dtype`; matmuls [in, out]
  const float *q_s, *k_s, *v_s, *o_s, *gate_s, *up_s,
      *down_s;                // wq: the matmuls' scales [ceil(K / gs), N]
  const void *ln1_b, *ln2_b;  // NORM_LN biases [H]
  const void *qkv_w, *qkv_b;  // fused_qkv: [H, 3 Hq D], [3 Hq D]
  const void *proj_w, *proj_b;   // fused_qkv: [Hq D, H]; bias: [H]
  const void *fc1_w, *fc1_b, *fc2_w,
      *fc2_b;                 // FFN_GELU: [H, F], [F], [F, H], [H]
  const float *qkv_s, *proj_s, *fc1_s,
      *fc2_s;                 // wq: the GPT matmuls' scales [ceil(K / gs), N]
  const void *cos, *sin;      // rope: [M, D]
  const int *block_table;     // decode [M, MB]; prefill [MB]
  const int *lengths;         // decode [M] tokens already stored; prefill 0
  const int *blk, *off;       // prefill [M] write targets; decode 0
  void *pool_k, *pool_v;      // [NB, BS, Hkv, D] (kv_quant: int8 codes),
                              // written in place
  float *pool_ks, *pool_vs;   // kv_quant: [NB, BS, Hkv] scales, in place
  void *y, *q, *k, *v, *attn, *x_mid, *hbuf;   // scratch
  void *out;                  // [M, H]
};

// One flash-attention launch (flash_attention.cu).  Tensors are contiguous
// [B, S, H, D] (q, out, dout, dq: Sq x Hq; k, v, dk, dv: Sk x Hkv); lse
// and delta fp32 [B, Hq, Sq]; segment ids int32 [B, Sq] / [B, Sk] (both or
// neither); bias fp32 [B|1, Hq|1, Sq, Sk] with element strides bias_sb /
// bias_sh for its batch and head (0 where broadcast).  Mirrored field for
// field by the ctypes Structure in paddle_tpu_torch/kernels/build.py.
struct FlashArgs {
  int dtype;                  // PT_F32 | PT_BF16
  int B, Sq, Sk, Hq, Hkv, D;
  int causal;                 // top-left aligned: q_pos >= k_pos
  long long bias_sb, bias_sh;
  float scale;
  const void *q, *k, *v, *dout;
  const float *delta, *bias;
  const int *seg_q, *seg_k;
  float *lse;                 // written by flash_fwd, read by the backward
  void *out, *dq, *dk, *dv;
};

// One launch of the linear-CE head (linear_ce.cu).  x [T, H] in x_dtype,
// w [V, H] in w_dtype, both contiguous; labels int32 [T]; nll, lse, g fp32
// [T]; part, tickets and xs as pt_linear_ce_scratch sizes them.  The
// backward kernels work on the vocab slab [c0, c0 + width) with dz
// scratch [T, ldz] (ldz = width rounded up to 8).  Mirrored field for
// field by the ctypes Structure in paddle_tpu_torch/kernels/build.py.
struct LceArgs {
  int x_dtype, w_dtype;       // PT_F32 | PT_BF16
  int T, H, V;
  int c0, width, ldz;         // backward: the slab and dz's leading dim
  int has_ignore, ignore_index;
  int first, last;            // linear_ce_dx: first slab / last slab
  float eps;                  // label smoothing
  const void *x, *w;
  const int *labels;
  const float *g;             // cotangent of nll, 0 at ignore_index
  float *nll, *lse;           // written by linear_ce_fwd; lse read back
  // dz in w's / x's dtype (one buffer if equal); fp32 x with a bf16 w:
  // dz_w = bf16(dz) and dz_x = bf16(dz - dz_w), the halves of one bf16
  // buffer, dz_x at least T ldz elements past dz_w
  void *dz_w, *dz_x;
  float *dx_acc;              // [T, H] fp32 accumulator over the slabs
  void *dx;                   // [T, H] x's dtype (dx_acc itself for fp32 x)
  void *dw;                   // [V, H] w's dtype
  // bf16 linear_ce_fwd: the row partials (m, s, zl, sz) of each vocab
  // tile and one ticket a row block, zero between calls
  float *part;
  int *tickets;
  // fp32 x with a bf16 w: x split into bf16 halves [2, T, H], x_hi =
  // bf16(x) and x_lo = bf16(x - x_hi), written by linear_ce_split_x and
  // read by linear_ce_fwd, linear_ce_dz and linear_ce_dw
  void *xs;
};

// One weight-only matmul launch (quant_linear.cu): y [M, N] = x [M, K] @
// dequant(w, scale), y in x's dtype.  w int8 [K, N], or int4 halves-packed
// into int8 [half, N] (half = ceil(K/2): the low nibble holds row p, the
// high nibble row half + p).  x rows have stride ldx (a multiple of 8);
// for int4 the x columns of rows [half, K) start at column xhi (a
// multiple of 8), those of rows [0, half) at 0.  scale fp32 [G, N], one
// row per gs rows of w (G 1 and gs 1 << 30 per output channel).
// tile_dq 1: the weight is dequantized in x's dtype (scale rounded to it)
// before the product; 0: each group's fp32 partial product is multiplied
// by its fp32 scale.  epi applies the serving chain's epilogue to the
// product rounded to x's dtype: EPI_RESID, EPI_SWIGLU_R (the Llama layer)
// with R [M, N] in x's dtype (R may be y itself: each element is read
// before it is written, by the same thread); EPI_BIAS, EPI_BIAS_RESID,
// EPI_BIAS_GELU (the GPT layer) with the bias B [N] in x's dtype (and R
// for EPI_BIAS_RESID).  qkv_d > 0 (EPI_NONE / EPI_BIAS only): y holds three
// [M, N / 3] slabs, stored as launch_gemm_xw's qkv split stores them (the
// GPT layer's fused qkv).  Mirrored field for field by the ctypes
// Structure in paddle_tpu_torch/kernels/build.py.
struct WoArgs {
  int int4;                   // 0: int8 codes [K, N]; 1: packed int4
  int x_dtype;                // PT_F32 | PT_BF16
  int M, K, N, half;
  int ldx, xhi;
  int gs, G, tile_dq;
  int epi;
  int qkv_d;                  // > 0: the qkv split's head dim
  const void *x;
  const signed char *w;
  const float *scale;
  void *y;
  const void *R;
  const void *B;
};

// One row-normalisation launch (norms.cu): x, res, out, add [R, H]
// contiguous in `dtype`; bias (added to x before the residual), w and b
// fp32 [H]; mean and inv fp32 [R].  rms_norm_fwd reads x, w and writes
// out, inv; layer_norm_fwd also reads b and writes mean;
// bias_residual_ln_fwd also reads res, bias and writes add.  Mirrored
// field for field by the ctypes Structure in
// paddle_tpu_torch/kernels/build.py.
struct NormArgs {
  int dtype;                  // PT_F32 | PT_BF16
  int R, H;
  float eps;
  const void *x, *res;
  const float *bias, *w, *b;
  void *out, *add;
  float *mean, *inv;
};

// One softmax(x + mask) launch (fused_ops.cu): x, out [R, S] contiguous
// in `dtype`; the mask in `mask_dtype`, row r's values at mask +
// sum_i idx_i * mstride[i] + j * mcol (j < S), where idx_0 .. idx_{nd-1}
// are r's indices over the leading sizes size[0 .. nd-1] (row-major, their
// product R): a mask broadcast to x is read in place, with stride 0 on its
// broadcast dims and mcol 0 when it is broadcast along the row.  Mirrored
// field for field by the ctypes Structure in
// paddle_tpu_torch/kernels/build.py.
struct SoftmaxArgs {
  int dtype, mask_dtype;      // PT_F32 | PT_BF16 each
  int S, nd;                  // row length; leading dims (0..4)
  long long R;                // rows
  long long size[4], mstride[4];
  long long mcol;             // 1, or 0 (one mask value per row)
  const void *x, *mask;
  void *out;
};

namespace pt {

typedef __nv_bfloat16 bf16;

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<bf16>(bf16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// round a float through the storage type (the reference rounds every op
// result to its input dtype)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

// jax.nn.gelu(approximate=True) in fp32 (fused_ops.cu bias_act_fwd's)
__device__ __forceinline__ float gelu_tanh(float v) {
  const float k = 0.7978845608028654f;  // sqrt(2 / pi)
  return v * (0.5f * (1.0f + tanhf(k * (v + 0.044715f * (v * v * v)))));
}

// the serving chain's epilogues on a product `a` with the reference's
// rounding: each product rounded to T before the bias, the residual add or
// the activation, and a bias sum rounded to T before the residual add or
// the activation.  `b`: SwiGLU's second product, or the bias of the bias
// epilogues (a value of T); `r`: the residual, or EPI_SWIGLU_R's gate.
template <typename T>
__device__ __forceinline__ float epi_value(int epi, float a, float b,
                                           float r) {
  if (epi == EPI_SWIGLU || epi == EPI_SWIGLU_R) {
    const bool two = epi == EPI_SWIGLU;
    float g = rnd<T>(two ? a : r), u = rnd<T>(two ? b : a);
    float s = rnd<T>(g / (1.0f + expf(-g)));
    return s * u;
  }
  if (epi == EPI_RESID) return r + rnd<T>(a);
  if (epi >= EPI_BIAS) {
    const float z = rnd<T>(__fadd_rn(rnd<T>(a), b));
    if (epi == EPI_BIAS_RESID) return __fadd_rn(r, z);
    return epi == EPI_BIAS_GELU ? gelu_tanh(z) : z;
  }
  return a;
}

// where element (m, n) of an [M, N] product is stored: row-major, or with
// qkv_d > 0 the qkv split (one [M, N / 3] slab a part: column n is part
// (n % 3 qkv_d) / qkv_d of head n / (3 qkv_d)); an even qkv_d keeps a
// pair (n, n + 1) at even n in one part of one head
__device__ __forceinline__ size_t out_index(int m, int n, int M, int N,
                                            int qkv_d) {
  if (qkv_d <= 0) return (size_t)m * N + n;
  const int d3 = 3 * qkv_d, head = n / d3, c = n - head * d3;
  const int part = c / qkv_d;
  return (size_t)part * M * (N / 3) + (size_t)m * (N / 3) + head * qkv_d +
         (c - part * qkv_d);
}

// whether epilogue `epi` reads R (the residual, or EPI_SWIGLU_R's gate)
__host__ __device__ __forceinline__ bool epi_reads_r(int epi) {
  return epi == EPI_RESID || epi == EPI_SWIGLU_R || epi == EPI_BIAS_RESID;
}

// Programmatic dependent launch (Hopper).  A kernel launched with
// cudaLaunchAttributeProgrammaticStreamSerialization may start before the
// kernel ahead of it in the stream has finished; pdl_wait() returns once
// that kernel has completed and its memory is visible (at once in a
// kernel launched without the attribute), so no thread reads an
// activation or writes global memory before it.  pdl_trigger() lets the
// kernel behind this one start early where that one carries the
// attribute (a no-op elsewhere).
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void pdl_trigger() {
  asm volatile("griddepcontrol.launch_dependents;\n" :::);
}

// the launch attribute that lets a kernel start under pdl_wait()
inline cudaLaunchAttribute pdl_attr() {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  a.val.programmaticStreamSerializationAllowed = 1;
  return a;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace pt

// Launch counters: one per __global__ kernel (its fp32/bf16 and epilogue
// template instances count together; the three modes of norms.cu's kernel
// apart) and one per layer entry point.  The quantized serving chain's
// variants count apart (seven): the weight-only GEMMs with the chain's
// epilogues (quant_linear.cu launch_wo_layer; both layers' epilogues), the
// RoPE / KV write into an int8 pool (rotated or not) and the attention over
// one; then the GPT chain's LayerNorm (rms_norm.cu layer_norm_rows).
// Kept in layer.cu, read and reset through pt_launch_counts /
// pt_reset_launch_counts; the names in paddle_tpu_torch/ops/cuda/layer.py
// (KERNELS) follow this order.
enum {
  CNT_DECODE_BLOCK,
  CNT_PREFILL_BLOCK,
  CNT_RMS_NORM_ROWS,
  CNT_GEMM_XW_SMALL_M,
  CNT_GEMM_XW_TILED,
  CNT_GEMM_XW_F32,
  CNT_ROPE_KV_WRITE,
  CNT_PAGED_ATTENTION,
  CNT_FLASH_FWD,
  CNT_FLASH_BWD_DQ,
  CNT_FLASH_BWD_DKV,
  CNT_LINEAR_CE_FWD,
  CNT_LINEAR_CE_DZ,
  CNT_LINEAR_CE_DX,
  CNT_LINEAR_CE_DW,
  CNT_LINEAR_CE_SPLIT_X,
  CNT_DECODE_ATTENTION,
  CNT_WO_INT8_SMALL_M,
  CNT_WO_INT8_TILED,
  CNT_WO_INT4_SMALL_M,
  CNT_WO_INT4_TILED,
  CNT_WO_F32,
  CNT_RMS_NORM_FWD,
  CNT_LAYER_NORM_FWD,
  CNT_BIAS_RESIDUAL_LN_FWD,
  CNT_SWIGLU_FWD,
  CNT_ROPE_FWD,
  CNT_SOFTMAX_MASK_FWD,
  CNT_BIAS_ACT_FWD,
  CNT_DROPOUT_ADD_FWD,
  CNT_WO_LAYER_INT8_SMALL_M,
  CNT_WO_LAYER_INT8_TILED,
  CNT_WO_LAYER_INT4_SMALL_M,
  CNT_WO_LAYER_INT4_TILED,
  CNT_WO_LAYER_F32,
  CNT_ROPE_KV_WRITE_Q8,
  CNT_PAGED_ATTENTION_Q8,
  CNT_LAYER_NORM_ROWS,
  CNT_NUM
};

// Adds one to counter `c` when `e` (the launch's cudaGetLastError) is
// cudaSuccess; returns `e`.  Called right after each <<<...>>> launch.
cudaError_t count_launch(int c, cudaError_t e);
// Whether the launch being made is to carry the programmatic-serialization
// attribute (pt::pdl_attr): true only while layer.cu queues the GPT
// layer's LayerNorms and the products right after them (kept in layer.cu,
// one flag a host thread), so every launcher keeps its signature
bool launch_pdl();

cudaError_t launch_rms_norm_rows(int dtype, int M, int H, const void *x,
                                 const void *w, void *out, float eps,
                                 cudaStream_t s);
cudaError_t launch_layer_norm_rows(int dtype, int M, int H, const void *x,
                                   const void *w, const void *b, void *out,
                                   float eps, cudaStream_t s);
// qkv_d > 0: Y holds three [M, N / 3] slabs, and column c of the product
// (head c / (3 qkv_d), part (c % (3 qkv_d)) / qkv_d, offset c % qkv_d) is
// stored into slab `part` at column head * qkv_d + offset (the GPT layer's
// fused qkv split per head as [q | k | v]); 0: Y is [M, N]
cudaError_t launch_gemm_xw(int dtype, int M, int K, int N, int epi,
                           const void *X, const void *W, const void *W2,
                           const void *R, const void *B, void *Y, int qkv_d,
                           cudaStream_t s);
cudaError_t launch_rope_kv_write(const LayerArgs *a, cudaStream_t s);
cudaError_t launch_paged_attention(const LayerArgs *a, cudaStream_t s);
cudaError_t launch_flash_fwd(const FlashArgs *a, cudaStream_t s);
cudaError_t launch_flash_bwd_dq(const FlashArgs *a, cudaStream_t s);
cudaError_t launch_flash_bwd_dkv(const FlashArgs *a, cudaStream_t s);
cudaError_t launch_linear_ce_fwd(const LceArgs *a, cudaStream_t s);
cudaError_t launch_linear_ce_dz(const LceArgs *a, cudaStream_t s);
cudaError_t launch_linear_ce_dx(const LceArgs *a, cudaStream_t s);
cudaError_t launch_linear_ce_dw(const LceArgs *a, cudaStream_t s);
cudaError_t launch_linear_ce_split_x(const LceArgs *a, cudaStream_t s);
cudaError_t launch_decode_attention(int dtype, int B, int Hq, int Hkv, int D,
                                    int T, long long sb, long long st,
                                    long long sh, float scale, const void *q,
                                    const void *k, const void *v,
                                    const int *lengths, void *out,
                                    cudaStream_t s);
cudaError_t launch_weight_only_matmul(const WoArgs *a, cudaStream_t s);
cudaError_t launch_wo_layer(const WoArgs *a, cudaStream_t s);
