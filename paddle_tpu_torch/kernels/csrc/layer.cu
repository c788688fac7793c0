// The C entry points of the port's kernels (plain C ABI, loaded with
// ctypes by paddle_tpu_torch/kernels/build.py).
//
// pt_decode_block / pt_prefill_block run ONE layer as a chain of
// hand-written kernels on the caller's stream.  A Llama layer:
//   rms_norm_rows -> gemm_xw q, k, v -> rope_kv_write -> paged_attention
//   -> gemm_xw o (+ residual) -> rms_norm_rows -> gemm_xw gate/up (SwiGLU)
//   -> gemm_xw down (+ residual)
// A GPT layer (LayerNorm with bias, fused qkv, biases, GELU, no RoPE):
//   layer_norm_rows -> gemm_xw qkv (+ bias, stored split into q, k, v) ->
//   rope_kv_write (no rotation: k, v into the pool) -> paged_attention ->
//   gemm_xw proj (+ bias + residual) -> layer_norm_rows -> gemm_xw fc1
//   (+ bias, GELU) -> gemm_xw fc2 (+ bias + residual)
// Each of LayerArgs' norm, ffn, rope, fused_qkv and bias flags picks its
// stage.  Weight-only quantized (LayerArgs::wq), either layer takes the
// weight-only kernels for its matmuls (quant_linear.cu launch_wo_layer,
// the same epilogues and the same qkv split; a Llama layer's SwiGLU as
// gate, then up with silu(gate) * up in its epilogue); an int8 KV pool
// (kv_quant) takes rope_kv_write's and paged_attention's int8 variants,
// rotated or not.
// They replace the TPU megakernels paddle_tpu/ops/pallas/decode_block.py
// (_kernel, pallas_call at :535) and prefill_block.py (_kernel,
// pallas_call at :435), which keep a whole layer's weights in VMEM.  A 7B
// layer's ~400 MB of bf16 weights (GPT-125M's ~14 MB) cannot stay in
// 227 KB of shared memory, so on Hopper the weights stream through the SMs
// once per GEMM and the residual stream makes a few round trips through
// device memory between the kernels (small next to the weights at
// decode).
//
// Every function returns a cudaError_t (0 = success); the wrapper raises
// on anything else.  Nothing here synchronises or allocates.
//
// The launch counters live here: each launch_* adds one to its kernel's
// counter right after a successful <<<...>>> launch, and each layer entry
// point to its own after its whole chain was queued.
#include <atomic>

#include "common.cuh"

#define PT_TRY(call)                   \
  do {                                 \
    cudaError_t e_ = (call);           \
    if (e_ != cudaSuccess) return e_;  \
  } while (0)

static std::atomic<long long> g_launches[CNT_NUM];

cudaError_t count_launch(int c, cudaError_t e) {
  if (e == cudaSuccess) g_launches[c].fetch_add(1, std::memory_order_relaxed);
  return e;
}

// launch_pdl()'s flag (common.cuh), one a host thread
static thread_local bool g_pdl = false;

bool launch_pdl() { return g_pdl; }

// Programmatic dependent launch at the GPT layer's two norm boundaries.
// layer_norm_rows and the product right after it (qkv, fc1: gemm_xw or the
// weight-only kernels) are launched with the programmatic-serialization
// attribute, so each may start while the kernel ahead of it still runs:
// the norm loads its gains and biases, the product its first ring round
// of weights, while the one ahead finishes; the products ahead of the
// norms (proj, fc2) let them start once their last K stage is consumed.
// Why this is safe: a kernel so launched reads no activation and writes no
// global memory before griddepcontrol.wait (common.cuh pdl_wait), which
// every block runs and which returns only once the kernel ahead has
// completed and its writes are visible; that kernel, if it was launched so
// too, waited the same way for its own predecessor.  So when a kernel
// passes its wait, every kernel queued before it on the stream has
// completed, as with plain stream order, and a block cannot finish
// without passing it.  A kernel launched without the attribute passes the
// wait at once: the Llama chain, rms_norm_rows and every other launch keep
// plain stream order.  GPT_NORM_PDL false (a tool's switch) launches the
// GPT chain in plain stream order too.
constexpr bool GPT_NORM_PDL = true;

// f()'s launches with the attribute where `on` (launch_pdl)
template <class F> static cudaError_t under_pdl(bool on, F f) {
  g_pdl = on;
  const cudaError_t e = f();
  g_pdl = false;
  return e;
}

// one weight-only layer GEMM: Y [M, N] = epi(X [M, K] @ dequant(W, S), R,
// B), stored split with qkv_d > 0
static cudaError_t wo_mm(const LayerArgs *a, int K, int N, int epi,
                         const void *X, const void *W, const float *S,
                         const void *R, const void *B, void *Y, int qkv_d,
                         cudaStream_t s) {
  WoArgs w = {};
  w.int4 = a->wq == 2;
  w.x_dtype = a->dtype;
  w.M = a->M;
  w.K = K;
  w.N = N;
  w.half = w.int4 ? (K + 1) / 2 : 0;
  w.ldx = K;
  w.xhi = w.half;
  w.gs = a->gs;
  w.G = (K + a->gs - 1) / a->gs;
  w.epi = epi;
  w.qkv_d = qkv_d;
  w.x = X;
  w.w = (const signed char *)W;
  w.scale = S;
  w.y = Y;
  w.R = R;
  w.B = B;
  return launch_wo_layer(&w, s);
}

// the layer's row norm of x into y: RMS, or LayerNorm with bias b
static cudaError_t row_norm(const LayerArgs *a, const void *x, const void *w,
                            const void *b, cudaStream_t s) {
  if (a->norm == NORM_LN)
    return launch_layer_norm_rows(a->dtype, a->M, a->H, x, w, b, a->y,
                                  a->eps, s);
  return launch_rms_norm_rows(a->dtype, a->M, a->H, x, w, a->y, a->eps, s);
}

// whether every matmul of the layer's stages has its scales (wq)
static bool has_scales(const LayerArgs *a) {
  const bool qkv = a->fused_qkv ? a->qkv_s && a->proj_s
                                : a->q_s && a->k_s && a->v_s && a->o_s;
  const bool ffn = a->ffn == FFN_GELU ? a->fc1_s && a->fc2_s
                                      : a->gate_s && a->up_s && a->down_s;
  return qkv && ffn;
}

static cudaError_t layer_forward(const LayerArgs *a, cudaStream_t s) {
  if (a->kv_quant && (!a->pool_ks || !a->pool_vs))
    return cudaErrorInvalidValue;
  if (a->wq && (a->wq > 2 || a->gs <= 0 || !has_scales(a)))
    return cudaErrorInvalidValue;
  const int dt = a->dtype, M = a->M, H = a->H, F = a->F;
  const int QD = a->Hq * a->D, KD = a->Hkv * a->D;
  const size_t slab = (size_t)M * QD * (dt == PT_BF16 ? 2 : 4);
  // the fused qkv product stores q, k, v as consecutive slabs of one buffer
  if (a->fused_qkv &&
      (a->Hq != a->Hkv || (const char *)a->k != (const char *)a->q + slab ||
       (const char *)a->v != (const char *)a->k + slab))
    return cudaErrorInvalidValue;
  // one matmul of the layer, W [K, N] with its scales S (wq) or in `dtype`
  auto mm = [&](int K, int N, int epi, const void *X, const void *W,
                const float *S, const void *R, const void *B, void *Y,
                int qkv_d) {
    return a->wq ? wo_mm(a, K, N, epi, X, W, S, R, B, Y, qkv_d, s)
                 : launch_gemm_xw(dt, M, K, N, epi, X, W, 0, R, B, Y, qkv_d,
                                  s);
  };
  // the GPT layer's LayerNorms and the products right after them go under
  // programmatic dependencies (GPT_NORM_PDL)
  const bool pdl = GPT_NORM_PDL && a->norm == NORM_LN;
  PT_TRY(under_pdl(pdl, [&] {
    return row_norm(a, a->x, a->ln1_w, a->ln1_b, s);
  }));
  if (a->fused_qkv) {
    PT_TRY(under_pdl(pdl, [&] {
      return mm(H, 3 * QD, EPI_BIAS, a->y, a->qkv_w, a->qkv_s, 0, a->qkv_b,
                a->q, a->D);
    }));
  } else {
    PT_TRY(mm(H, QD, EPI_NONE, a->y, a->q_w, a->q_s, 0, 0, a->q, 0));
    PT_TRY(mm(H, KD, EPI_NONE, a->y, a->k_w, a->k_s, 0, 0, a->k, 0));
    PT_TRY(mm(H, KD, EPI_NONE, a->y, a->v_w, a->v_s, 0, 0, a->v, 0));
  }
  PT_TRY(launch_rope_kv_write(a, s));
  PT_TRY(launch_paged_attention(a, s));
  PT_TRY(mm(QD, H, a->bias ? EPI_BIAS_RESID : EPI_RESID, a->attn,
            a->fused_qkv ? a->proj_w : a->o_w,
            a->fused_qkv ? a->proj_s : a->o_s, a->x,
            a->bias ? a->proj_b : 0, a->x_mid, 0));
  PT_TRY(under_pdl(pdl, [&] {
    return row_norm(a, a->x_mid, a->ln2_w, a->ln2_b, s);
  }));
  if (a->ffn == FFN_GELU) {
    PT_TRY(under_pdl(pdl, [&] {
      return mm(H, F, EPI_BIAS_GELU, a->y, a->fc1_w, a->fc1_s, 0, a->fc1_b,
                a->hbuf, 0);
    }));
    PT_TRY(mm(F, H, EPI_BIAS_RESID, a->hbuf, a->fc2_w, a->fc2_s, a->x_mid,
              a->fc2_b, a->out, 0));
  } else {
    if (a->wq) {
      // the gate, then the up projection with silu(gate) * up in its
      // epilogue (the weight-only kernels take one product a launch)
      PT_TRY(mm(H, F, EPI_NONE, a->y, a->gate_w, a->gate_s, 0, 0, a->hbuf,
                0));
      PT_TRY(mm(H, F, EPI_SWIGLU_R, a->y, a->up_w, a->up_s, a->hbuf, 0,
                a->hbuf, 0));
    } else {
      PT_TRY(launch_gemm_xw(dt, M, H, F, EPI_SWIGLU, a->y, a->gate_w,
                            a->up_w, 0, 0, a->hbuf, 0, s));
    }
    PT_TRY(mm(F, H, EPI_RESID, a->hbuf, a->down_w, a->down_s, a->x_mid, 0,
              a->out, 0));
  }
  return cudaSuccess;
}

extern "C" {

// One decode token per sequence: rows are slots, positions lengths[r].
int pt_decode_block(const LayerArgs *a, void *stream) {
  if (!a->lengths || a->blk || a->off) return cudaErrorInvalidValue;
  return count_launch(CNT_DECODE_BLOCK,
                      layer_forward(a, (cudaStream_t)stream));
}

// One prompt chunk of one sequence: rows at positions start + r, written
// to (blk[r], off[r]).
int pt_prefill_block(const LayerArgs *a, void *stream) {
  if (a->lengths || !a->blk || !a->off) return cudaErrorInvalidValue;
  return count_launch(CNT_PREFILL_BLOCK,
                      layer_forward(a, (cudaStream_t)stream));
}

// Copies the first min(n, CNT_NUM) launch counters into out; returns
// CNT_NUM.
int pt_launch_counts(long long *out, int n) {
  for (int i = 0; i < n && i < CNT_NUM; ++i) out[i] = g_launches[i].load();
  return CNT_NUM;
}

void pt_reset_launch_counts() {
  for (int i = 0; i < CNT_NUM; ++i) g_launches[i].store(0);
}

// The chain's kernels one at a time (timed and checked on their own by
// chip_smoke.py).
int pt_rms_norm_rows(int dtype, int M, int H, const void *x, const void *w,
                     void *out, float eps, void *stream) {
  return launch_rms_norm_rows(dtype, M, H, x, w, out, eps,
                              (cudaStream_t)stream);
}

int pt_layer_norm_rows(int dtype, int M, int H, const void *x, const void *w,
                       const void *b, void *out, float eps, void *stream) {
  return launch_layer_norm_rows(dtype, M, H, x, w, b, out, eps,
                                (cudaStream_t)stream);
}

int pt_gemm_xw(int dtype, int M, int K, int N, int epi, const void *X,
               const void *W, const void *W2, const void *R, const void *B,
               void *Y, int qkv_d, void *stream) {
  return launch_gemm_xw(dtype, M, K, N, epi, X, W, W2, R, B, Y, qkv_d,
                        (cudaStream_t)stream);
}

int pt_rope_kv_write(const LayerArgs *a, void *stream) {
  return launch_rope_kv_write(a, (cudaStream_t)stream);
}

int pt_paged_attention(const LayerArgs *a, void *stream) {
  return launch_paged_attention(a, (cudaStream_t)stream);
}

}  // extern "C"
