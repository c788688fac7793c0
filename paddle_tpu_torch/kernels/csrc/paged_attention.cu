// paged_attention: causal attention of each query row over its sequence's
// pages, read through the block table.
//
// Part of the decode_block / prefill_block chain (replaces the
// online-softmax page walk of paddle_tpu/ops/pallas/decode_block.py::
// _kernel (:229, pallas_call at :535) and prefill_block.py::_kernel (:131,
// pallas_call at :435)).  Row r at absolute position p_r attends pool
// positions 0..p_r of its sequence:
//   decode  (lengths != 0): p_r = lengths[r] (the token just appended),
//                           table row bt[r]
//   prefill:                p_r = start + r, table row bt
// Unmapped table entries (-1) read page 0, as the reference does (the
// positions behind them are never live for a row the engine reads); the
// walk stops at the row's own position and at the table's end, never past
// them.  q head h reads kv head h / G (G = Hq / Hkv <= 8); head_dim 32, 64
// or 128 (the wrapper refuses others).
//
// What bounds it on an H100: bytes.  A decode call reads each live K and V
// row once per kv head (llama_7b, B 4, lengths 1000/37/0/517: 25.5 MB,
// 7.6 us at 3.35 TB/s) and does 4 G flops an element of it; a prefill chunk
// reads its sequence's K and V once per kv head (plus L2 re-reads by the
// other row tiles and q heads) and its 4 Ts (start + Ts / 2) D flops a head
// run on the tensor cores.  Two bodies, one launch a call:
//
//   * paged_attention_rows<T, D, GM>: decode in both dtypes, fp32 prefill
//     and bf16 chunks of <= 16 rows whose walk ends past MMA16_MAX
//     positions.  Grid (S, Hkv, rows); the S blocks of a (kv head, row)
//     are one thread-block cluster.  Block s
//     takes the s-th of S contiguous ranges of whole pages of its row's
//     live pages (ceil(pages / S) pages each; a range past the row's length
//     is empty) for all G q heads of its kv head, so a K / V row is read
//     once per kv head, as the TPU kernel reads it.  S = min(8, ceil(pages
//     / 2)), pages the most a row of the call can hold (the table's width at
//     decode, start + Ts at prefill: the lengths stay on the card; 8 splits
//     beat 4 at the engine's decode, tools/pattn_ab.py).  The block reads its page indices from
//     the table once into shared memory, then gathers its positions' K and
//     V rows with 16-byte cp.async into a ring of NSTG chunks of CHP
//     positions (8 KB each, three in flight while one is used).  A lane
//     owns one 16-byte chunk of a row (q's chunk of each head in fp32
//     registers); a warp scores STEPS x RPW rows of a chunk (FMAs, a
//     shuffle sum over the row's lanes), takes one max a chunk per head,
//     rescales, and adds p v into its fp32 accumulators: logits, softmax
//     and p v in fp32, as the plain version.  At the end the warps' states
//     fold in shared memory, each block stores its (acc[G][D], m[G], l[G])
//     into rank 0's slot s (st.shared::cluster; a cluster barrier split
//     across the walk makes sure every block has started first), and after
//     a second cluster barrier rank 0 folds the slots in rank order and
//     writes out: calls are bit-identical.
//   * paged_attention_prefill<D, WARPS>: bf16 prefill, flash_fwd_mma's
//     structure (flash_attention.cu) over the page table.  Grid (ceil(Ts /
//     BQ), Hq): a block owns BQ = 16 WARPS query rows of one q head, a warp
//     16 of them (WARPS 4; one warp for a chunk of <= 16 rows whose walk
//     ends within MMA16_MAX positions: past that the rows body, split
//     over a cluster, is faster); K and V stream in BK-row tiles (4
//     pages at BS 16) gathered through the block's page indices (read once
//     into shared memory) by 16-byte cp.async into a ring of NSTG padded
//     tiles.  S = Q K^T and O += P V run on mma.sync m16n8k16 with fp32
//     accumulators, the online softmax in registers; P is rounded to bf16
//     for P V (as the JAX prefill reference rounds the probabilities), l
//     sums the fp32 p.  Causal at the bottom-right offset: row r sees
//     positions <= start + r; a block's walk ends at start plus its last
//     row, a warp skips the tiles wholly past its rows and masks only those
//     that cross its diagonal or the walk's end.
//
// An int8 pool (LayerArgs::kv_quant: codes [NB, BS, Hkv, D] and fp32 scales
// [NB, BS, Hkv] a pool; the kv_quant branches of the TPU kernels,
// decode_block.py:310 / :335 and prefill_block.py:213 / :237) takes the
// same two bodies with Q8 set, counted apart (paged_attention_q8).  Its
// bytes are half of bf16's (a code a value, a 4-byte scale a position and
// kv head), so the arithmetic that turns codes into values must cost less
// than the bytes it saves; an int8 -> fp32 conversion instruction runs at
// an eighth of the FMA rate, so the codes are widened instead by the
// exponent-bias trick (widen_f32 of mma.cuh: one PRMT and one FADD a code;
// widen_h2 below, into fp16: one PRMT and one HSUB2 a pair; both exact)
// and the scales are taken out of the inner sums:
//   * rows: a lane's chunk is 16 codes (8 where GM 8 would spill its q and
//     acc registers), so a 16-byte copy brings twice the positions of a
//     bf16 one, and a stage holds CHP positions' codes plus their K and V
//     scales (one 4-byte cp.async each; copying a page's [BS, Hkv] scale
//     slab instead would read Hkv times the scale bytes the block needs).
//     Decode and fp32 chunks: score = s_k (q . c) and acc += (p s_v) c,
//     one scalar a row for each, with c the exact codes; the reference
//     dequantizes to fp32 there (code x scale, then the products), so
//     this reassociates fp32 products and stays within the fp32 1e-4
//     check.  A bf16 prefill chunk on this body keeps code x scale
//     rounded to bf16 value by value, as the reference rounds the gathered
//     pages to the model dtype.
//   * prefill: the tile's raw codes and scales land in a ring of 3 (rows
//     padded to D + 16 bytes: conflict-free ldmatrix) and the products
//     read them there, with no second pass and no extra barrier, on fp16
//     operands (mma.sync f16: a code widens into fp16 in one PRMT and one
//     HSUB2 a pair, half of bf16's cost, which matters since each of the
//     block's 4 warps widens every code of the tile it reads): S = Q K^T
//     takes K's B fragments from ldmatrix words of codes widened in
//     registers (a word holds a key's codes k 4t .. 4t + 3, so q's columns
//     are stored reordered in the Q tile to match, q8_q_tile, and q is
//     taken to fp16 once), then each key column times its K scale; O += P
//     V takes V's B fragments from ldmatrix.trans words widened the same
//     way (two n8 tiles a word), with each key's p times its V scale before
//     P is rounded to fp16.  So the rounding differs from the reference's
//     (which rounds code x scale to bf16 for both products and P to bf16):
//     S keeps the exact codes, q (exact in fp16 inside its range) and the
//     fp32 scales, and P s_v is rounded once to fp16 (11 bits; values held
//     to fp16's finite range, and below 2^-14 rounded to its subnormal
//     step); held by the bf16 rule, 2e-2 or no further from the fp32
//     result than 1.5 x the plain version.  Measured against the same
//     products on bf16 operands and against one widening pass a tile into
//     a shared bf16 tile (tools/pattn_ab.py), fp16 took the least time.
// Logits, softmax and P V are otherwise the full-width bodies'.  What
// bounds them at the chain's shapes: at decode (B 4, lengths 1000 / 37 /
// 0 / 517) the bytes are 4 us at 3.35 TB/s, so the walk's latency (page
// indices, the ring's first chunks, two cluster barriers, the fold) sets
// the pace; the Ts 256 prefill chunk is bound by its tensor-core work
// (2.7 us at 989 TFLOP/s), the blocks' serial walk over 9 K / V tiles and
// the widening beside the mma.sync.
#include <type_traits>

#include "mma.cuh"
#include "wgmma.cuh"

namespace pt {
namespace pattn {

constexpr int NT = 128, NW = NT / 32;   // rows body: 4 warps
constexpr int MAXS = 8, MINP = 2;       // splits at most; pages a split aims at
constexpr int MAXG = 8;                 // q heads a kv head
constexpr int Q8_BASE = 32;             // allow_smem instances of the Q8 bodies

constexpr int NSTG = 4, STEPS = 2;      // ring chunks; warp steps a chunk
// bf16 chunks of <= 16 rows take the one-warp tensor-core body while their
// walk ends within this many positions (tools/pattn_ab.py on an NVIDIA H100
// 80GB HBM3 at 700 W, Ts 16 after 37, 300 and 1000 positions: 7.2 / 30.4 /
// 94.4 us there, 9.3 / 37.4 / 75.5 us on the rows body)
constexpr int MMA16_MAX = 512;
constexpr float NEG_INF = -1e30f;

// rows body: a lane owns EPC elements of a row (16 bytes of T; of int8
// codes 16, or 8 at GM 8), CPR lanes a row, a warp step RPW rows, a chunk
// CHP positions of K then V (8 KB), then with Q8 their K and V scales
template <typename T, int D, int GM, bool Q8> struct Rows {
  using P = typename std::conditional<Q8, signed char, T>::type;
  static constexpr int EPC = Q8 ? (GM <= 4 ? 16 : 8) : 16 / (int)sizeof(T);
  static constexpr int CB = EPC * (int)sizeof(P);     // bytes a lane's chunk
  static constexpr int CPR = D / EPC;
  static constexpr int RPW = 32 / CPR;
  static constexpr int CHP = STEPS * NW * RPW;
  static constexpr int CODES = 2 * CHP * D * (int)sizeof(P);
  static constexpr int STAGE = CODES + (Q8 ? 2 * CHP * 4 : 0);   // bytes
  static constexpr size_t RING = (size_t)NSTG * STAGE;
};

// a lane's chunk global -> shared: 16 or 8 bytes
template <int CB>
__device__ __forceinline__ void cp_chunk(void *dst, const void *src,
                                         bool ok) {
  if constexpr (CB == 16)
    cp16(dst, src, ok);
  else
    cp8(dst, src, ok);
}

// N values of T (N sizeof(T) a multiple of 16 bytes) as floats
template <typename T, int N>
__device__ __forceinline__ void load_f(const T *p, float *f) {
  constexpr int PER = 16 / (int)sizeof(T);
#pragma unroll
  for (int c = 0; c < N / PER; ++c) {
    const uint4 u = reinterpret_cast<const uint4 *>(p)[c];
    const T *e = reinterpret_cast<const T *>(&u);
#pragma unroll
    for (int i = 0; i < PER; ++i) f[c * PER + i] = to_f<T>(e[i]);
  }
}

// EPC int8 codes of shared memory as exact floats (widen_f32: a PRMT and
// an FADD a code, where a conversion instruction runs at a fraction of the
// FMA rate)
template <int EPC>
__device__ __forceinline__ void codes_w(const signed char *p, float *f) {
  unsigned w[EPC / 4];
  if constexpr (EPC == 16) {
    const uint4 u = *reinterpret_cast<const uint4 *>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2 *>(p);
    w[0] = u.x, w[1] = u.y;
  }
#pragma unroll
  for (int i = 0; i < EPC / 4; ++i) widen_f32(w[i], f + 4 * i);
}

// a row's table row and its live positions [0, n)
struct RowOf {
  const int *bt;
  int n;
};
__device__ __forceinline__ RowOf row_of(const LayerArgs &a, int r) {
  const int pos = a.lengths ? a.lengths[r] : a.start + r;
  return {a.lengths ? a.block_table + (size_t)r * a.MB : a.block_table,
          min(max(pos, 0) + 1, a.MB * a.BS)};
}

// one 16-byte chunk of shared memory as floats
template <typename T, int EPC>
__device__ __forceinline__ void chunk_f(const T *p, float *f) {
  const uint4 u = *reinterpret_cast<const uint4 *>(p);
  const T *e = reinterpret_cast<const T *>(&u);
#pragma unroll
  for (int i = 0; i < EPC; ++i) f[i] = to_f<T>(e[i]);
}

template <typename T, int D, int GM, bool Q8>
__global__ void __launch_bounds__(NT)
    paged_attention_rows(LayerArgs a, int pmax) {
  using R = Rows<T, D, GM, Q8>;
  using P = typename R::P;
  constexpr int EPC = R::EPC, CPR = R::CPR, RPW = R::RPW, CHP = R::CHP;
  static_assert(R::RING >= sizeof(float) * NW * GM * (D + 2),
                "the warps' fold overlays the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char *ring = smem;
  int *pidx = reinterpret_cast<int *>(smem + R::RING);
  float *recv = reinterpret_cast<float *>(pidx + ((pmax + 3) & ~3));
  const int S = gridDim.x, s = blockIdx.x, hk = blockIdx.y, r = blockIdx.z;
  const int G = a.Hq / a.Hkv, BS = a.BS;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch = lane % CPR, ro = lane / CPR;
  // every block of the cluster has started before any stores into rank
  // 0's shared memory (this arrival's wait comes before the fold)
  cluster_arrive_relaxed();

  // this block's pages [pg0, pg0 + npg) and positions [p0, p0 + cnt)
  const RowOf row = row_of(a, r);
  const int np = (row.n + BS - 1) / BS, pps = (np + S - 1) / S;
  const int pg0 = min(s * pps, np), npg = min(pps, np - pg0);
  const int p0 = pg0 * BS, cnt = max(min(npg * BS, row.n - p0), 0);
  for (int i = tid; i < npg; i += NT) pidx[i] = max(row.bt[pg0 + i], 0);

  float qf[GM][EPC], acc[GM][EPC], m[GM], l[GM];
  const T *qb =
      (const T *)a.q + ((size_t)r * a.Hq + (size_t)hk * G) * D + ch * EPC;
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    if (g < G) {
      load_f<T, EPC>(qb + g * D, qf[g]);
    } else {
#pragma unroll
      for (int i = 0; i < EPC; ++i) qf[g][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < EPC; ++i) acc[g][i] = 0.f;
  }
  __syncthreads();                                   // pidx

  const P *pk = (const P *)a.pool_k, *pv = (const P *)a.pool_v;
  const size_t rs = (size_t)a.Hkv * D;               // a pool position
  // Q8: dequantized codes rounded to T (a bf16 prefill chunk: the
  // reference dequantizes the gathered pages to the model dtype), each
  // code x scale on its own; else (decode, fp32) the scales come out of
  // the sums: score = s_k (q . c), acc += (p s_v) c
  const bool rounded = Q8 && !a.lengths && !std::is_same<T, float>::value;
  // chunk c's K rows, then its V rows (then, Q8, their K and V scales),
  // into ring stage c % NSTG; rows past cnt are zero-filled
  auto issue = [&](int c) {
    unsigned char *st = ring + (c % NSTG) * R::STAGE;
    P *dst = reinterpret_cast<P *>(st);
    for (int i = tid; i < CHP * CPR; i += NT) {
      const int ri = i / CPR, cc = i % CPR, p = c * CHP + ri;
      const bool ok = p < cnt;
      const size_t off =
          ok ? ((size_t)pidx[p / BS] * BS + p % BS) * rs + (size_t)hk * D +
                   cc * EPC
             : 0;
      cp_chunk<R::CB>(dst + ri * D + cc * EPC, pk + off, ok);
      cp_chunk<R::CB>(dst + (CHP + ri) * D + cc * EPC, pv + off, ok);
    }
    if constexpr (Q8) {
      float *sc = reinterpret_cast<float *>(st + R::CODES);
      for (int i = tid; i < CHP; i += NT) {
        const int p = c * CHP + i;
        const bool ok = p < cnt;
        const size_t so =
            ok ? ((size_t)pidx[p / BS] * BS + p % BS) * a.Hkv + hk : 0;
        cp4(sc + i, a.pool_ks + so, ok);
        cp4(sc + CHP + i, a.pool_vs + so, ok);
      }
    }
  };
  const int nch = (cnt + CHP - 1) / CHP;
#pragma unroll
  for (int c = 0; c < NSTG - 1; ++c) {
    if (c < nch) issue(c);
    cp_commit();
  }
  for (int c = 0; c < nch; ++c) {
    cp_wait<NSTG - 2>();
    __syncthreads();            // chunk c landed; chunk c - 1 is done
    if (c + NSTG - 1 < nch) issue(c + NSTG - 1);
    cp_commit();
    const unsigned char *st = ring + (c % NSTG) * R::STAGE;
    const P *kt = reinterpret_cast<const P *>(st), *vt = kt + CHP * D;
    const float *ksc = reinterpret_cast<const float *>(st + R::CODES);
    // this warp's rows (st NW + warp) RPW + ro of the chunk: scores
    float sc[STEPS][GM];
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int i = (st * NW + warp) * RPW + ro;
      const bool live = c * CHP + i < cnt;
      float kf[EPC], sk = 1.f;
      if constexpr (Q8) {
        codes_w<EPC>(kt + i * D + ch * EPC, kf);
        if (rounded) {
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[e] = rnd<T>(kf[e] * ksc[i]);
        } else {
          sk = ksc[i];
        }
      } else {
        chunk_f<T, EPC>(kt + i * D + ch * EPC, kf);
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPC; ++e) d = fmaf(qf[g][e], kf[e], d);
#pragma unroll
        for (int o = CPR / 2; o > 0; o >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, o);
        if constexpr (Q8) d *= sk;
        sc[st][g] = live ? d * a.scale : -INFINITY;
      }
    }
    // one max a chunk per head (over the warp's rows), then p and p v
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float mx = sc[0][g];
#pragma unroll
      for (int st = 1; st < STEPS; ++st) mx = fmaxf(mx, sc[st][g]);
#pragma unroll
      for (int o = CPR; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[g], mx), al = expf(m[g] - mn);
      m[g] = mn;
      l[g] *= al;
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[g][e] *= al;
    }
#pragma unroll
    for (int st = 0; st < STEPS; ++st) {
      const int i = (st * NW + warp) * RPW + ro;
      float vf[EPC], sv = 1.f;
      if constexpr (Q8) {
        codes_w<EPC>(vt + i * D + ch * EPC, vf);
        if (rounded) {
#pragma unroll
          for (int e = 0; e < EPC; ++e) vf[e] = rnd<T>(vf[e] * ksc[CHP + i]);
        } else {
          sv = ksc[CHP + i];
        }
      } else {
        chunk_f<T, EPC>(vt + i * D + ch * EPC, vf);
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float p = expf(sc[st][g] - m[g]);
        l[g] += p;
        float pv = p;
        if constexpr (Q8) pv *= sv;            // one scalar a row
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
      }
    }
  }
  cp_wait<0>();

  // the warp's state: l and acc summed over its row lanes (m is the same in
  // every lane); then the warps' states fold through shared memory (the
  // ring, done with), and the block's goes into rank 0's slot s
#pragma unroll
  for (int o = CPR; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
    }
  __syncthreads();                                   // the ring is free
  float *part = reinterpret_cast<float *>(smem);     // [NW][GM][D]
  float *pm = part + NW * GM * D, *pl = pm + NW * GM;
  if (ro == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g)
#pragma unroll
      for (int e = 0; e < EPC; ++e)
        part[(warp * GM + g) * D + ch * EPC + e] = acc[g][e];
  if (lane == 0)
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      pm[warp * GM + g] = m[g];
      pl[warp * GM + g] = l[g];
    }
  __syncthreads();
  const int RS = G * D + 2 * G;                      // a slot: acc, m, l
  cluster_wait();
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    float mx = pm[g];
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, pm[w * GM + g]);
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      v += part[(w * GM + g) * D + i % D] * expf(pm[w * GM + g] - mx);
    st_peer_f32(peer_u32(recv + s * RS + i, 0), v);
  }
  if (tid < G) {
    float mx = pm[tid], v = 0.f;
#pragma unroll
    for (int w = 1; w < NW; ++w) mx = fmaxf(mx, pm[w * GM + tid]);
#pragma unroll
    for (int w = 0; w < NW; ++w)
      v += pl[w * GM + tid] * expf(pm[w * GM + tid] - mx);
    st_peer_f32(peer_u32(recv + s * RS + G * D + tid, 0), mx);
    st_peer_f32(peer_u32(recv + s * RS + G * D + G + tid, 0), v);
  }
  cluster_arrive();
  cluster_wait();
  if (s != 0) return;
  T *out = (T *)a.attn + ((size_t)r * a.Hq + (size_t)hk * G) * D;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    float mx = recv[G * D + g];
    for (int k = 1; k < S; ++k) mx = fmaxf(mx, recv[k * RS + G * D + g]);
    float num = 0.f, den = 0.f;
    for (int k = 0; k < S; ++k) {
      const float w = expf(recv[k * RS + G * D + g] - mx);
      num += recv[k * RS + i] * w;
      den += recv[k * RS + G * D + G + g] * w;
    }
    out[i] = from_f<T>(num / den);
  }
}

// prefill body: BQ query rows a block (16 a warp), BK-row K / V tiles in a
// ring of NSTG, rows padded to LD (16 bytes past D: conflict-free ldmatrix);
// Q8: the ring holds the raw codes (K, V; rows padded to LDC, 16 bytes past
// D) and scales (K, V) of NSTG tiles, read by ldmatrix and widened in
// registers
template <int D, int WARPS, bool Q8> struct Pre {
  static constexpr int BQ = 16 * WARPS, NTH = 32 * WARPS;
  static constexpr int BK = 64, NSTG = Q8 ? 3 : 2, LD = D + 8, LDC = D + 16;
  static constexpr int QB = BQ * LD * 2;                  // Q tile bytes
  static constexpr int STAGE = 2 * BK * LD * 2;           // K, then V
  static constexpr int RAW = 2 * BK * LDC + 2 * BK * 4;   // Q8: codes, scales
  static constexpr int RING = QB + NSTG * (Q8 ? RAW : STAGE);
};

// Q8's products run on fp16 operands: an int8 code widens into fp16 in
// half the instructions of bf16 (fp16's 10-bit mantissa holds 1024 + 128 +
// code, bf16's 7 bits do not: widen_i8 goes through fp32), and each warp
// widens every code of the tile it reads.  widen_h2: fp16 pairs of the
// codes, bytes (0, 2) in pa and (1, 3) in pb (as widen_i8): code ^ 0x80
// spliced under the fp16 exponent of 1024 by one PRMT, one HSUB2 of 1152
// leaves the code
__device__ __forceinline__ unsigned hsub2(unsigned a, unsigned b) {
  unsigned d;
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ void widen_h2(unsigned r, unsigned &pa,
                                         unsigned &pb) {
  const unsigned u = r ^ 0x80808080u;
  pa = hsub2(__byte_perm(u, 0x64646464u, 0x4240), 0x64806480u);
  pb = hsub2(__byte_perm(u, 0x64646464u, 0x4341), 0x64806480u);
}
// two floats rounded to fp16 in one register, lo in the low half, held to
// fp16's finite range (a q or p s_v past 65504 stays finite)
__device__ __forceinline__ unsigned pack_f16(float lo, float hi) {
  unsigned d;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n"
      : "=r"(d)
      : "f"(fminf(fmaxf(hi, -65504.f), 65504.f)),
        "f"(fminf(fmaxf(lo, -65504.f), 65504.f)));
  return d;
}
// a bf16 pair as an fp16 pair
__device__ __forceinline__ unsigned bf2_to_h2(unsigned b) {
  return pack_f16(__uint_as_float(b << 16), __uint_as_float(b & 0xFFFF0000u));
}
// c += a . b on one m16n8k16 tile, fp16 operands
__device__ __forceinline__ void mma_f16(float *c, const unsigned *a,
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Q8: the Q rows [q0, q0 + BQ) of head h into the shared tile with each
// 16-column block's columns reordered, evens then odds (rows past M zero):
// the A fragment's columns (2t, 2t + 1, 2t + 8, 2t + 9) of a k16 step are
// then q's (4t, 4t + 2, 4t + 1, 4t + 3), the order in which one ldmatrix
// word of codes (k 4t .. 4t + 3 of a key) widens into the B fragment
// (widen_h2: bytes 0, 2 then 1, 3)
template <int D, int BQ, int LD, int NTH>
__device__ __forceinline__ void q8_q_tile(bf16 *Qs, const bf16 *q, size_t qs,
                                          int q0, int M) {
  for (int i = threadIdx.x; i < BQ * (D / 16); i += NTH) {
    const int rr = i / (D / 16), blk = i % (D / 16), row = q0 + rr;
    uint4 lo = make_uint4(0, 0, 0, 0), hi = lo;
    if (row < M) {
      const uint4 *src =
          reinterpret_cast<const uint4 *>(q + (size_t)row * qs + blk * 16);
      lo = src[0];
      hi = src[1];
    }
    uint4 *dst = reinterpret_cast<uint4 *>(Qs + rr * LD + blk * 16);
    dst[0] = make_uint4(__byte_perm(lo.x, lo.y, 0x5410),
                        __byte_perm(lo.z, lo.w, 0x5410),
                        __byte_perm(hi.x, hi.y, 0x5410),
                        __byte_perm(hi.z, hi.w, 0x5410));
    dst[1] = make_uint4(__byte_perm(lo.x, lo.y, 0x7632),
                        __byte_perm(lo.z, lo.w, 0x7632),
                        __byte_perm(hi.x, hi.y, 0x7632),
                        __byte_perm(hi.z, hi.w, 0x7632));
  }
}

// Q8: s[NS] (16 q rows x 8 NS keys) = Q . K^T over KS k16 steps, Q from its
// fp16 A fragments qa (q8_q_tile's column order), K from int8 code rows LDC
// bytes apart: one ldmatrix x4 gives a lane row g's codes k 4t .. 4t + 3 of
// four (n8 tile, k16 step) blocks, widened into B fragments in registers
template <int NS, int KS, int LDC>
__device__ __forceinline__ void qk_q8(float (*s)[4], const unsigned (*qa)[4],
                                      const unsigned char *Kc, int lane) {
  constexpr int KQ = KS < 4 ? KS : 4, JQ = 4 / KQ;
  const int mi = lane >> 3;                  // the matrix this lane points
  const unsigned char *pb =
      Kc + (8 * (mi / KQ) + (lane & 7)) * LDC + (mi % KQ) * 16;
#pragma unroll
  for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int j0 = 0; j0 < NS; j0 += JQ)
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += KQ) {
      unsigned w[4];
      ldsm_x4(w, pb + 8 * j0 * LDC + k0 * 16);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        unsigned b0, b1;
        widen_h2(w[m], b0, b1);
        mma_f16(s[j0 + m / KQ], qa[k0 + m % KQ], b0, b1);
      }
    }
}

// Q8: c[ND] (16 rows x D) += P . V over KP k16 steps of keys, P's fp16 A
// fragments pa, V from int8
// code rows LDC bytes apart: one ldmatrix.trans x4 gives a lane keys (2t,
// 2t + 1) and (2t + 8, 2t + 9) of columns 2g, 2g + 1 of two 16-column
// blocks, widened into the B fragments of two n8 tiles a block: tile 2b
// holds columns 16 b + 4t + {0, 2}, tile 2b + 1 columns 16 b + 4t + {1, 3}
template <int ND, int KP, int LDC>
__device__ __forceinline__ void pv_q8(float (*c)[4], const unsigned (*pa)[4],
                                      const unsigned char *Vc, int lane) {
  const unsigned char *pb =
      Vc + ((lane & 7) + ((lane >> 3) & 1) * 8) * LDC + (lane >> 4) * 16;
#pragma unroll
  for (int kk = 0; kk < KP; ++kk)
#pragma unroll
    for (int b2 = 0; b2 < ND / 4; ++b2) {
      unsigned w[4], e0, o0, e1, o1;
      ldsm_x4_t(w, pb + kk * 16 * LDC + b2 * 32);
      widen_h2(w[0], e0, o0);
      widen_h2(w[1], e1, o1);
      mma_f16(c[4 * b2], pa[kk], e0, e1);
      mma_f16(c[4 * b2 + 1], pa[kk], o0, o1);
      widen_h2(w[2], e0, o0);
      widen_h2(w[3], e1, o1);
      mma_f16(c[4 * b2 + 2], pa[kk], e0, e1);
      mma_f16(c[4 * b2 + 3], pa[kk], o0, o1);
    }
}

template <int D, int WARPS, bool Q8>
__global__ void __launch_bounds__(Pre<D, WARPS, Q8>::NTH)
    paged_attention_prefill(LayerArgs a) {
  using C = Pre<D, WARPS, Q8>;
  constexpr int BQ = C::BQ, BK = C::BK, LD = C::LD, LDC = C::LDC;
  constexpr int NTH = C::NTH;
  constexpr int KS = D / 16, NS = BK / 8, ND = D / 8, KP = BK / 16;
  constexpr int CPR = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16 *Qs = reinterpret_cast<bf16 *>(smem);
  int *pidx = reinterpret_cast<int *>(smem + C::RING);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, hk = h / (a.Hq / a.Hkv);
  const int wq0 = q0 + warp * 16;                    // the warp's first row
  const int BS = a.BS;
  // positions this block reads: [0, kend), the last row's and the table's
  const int kend = min(a.start + min(q0 + BQ, a.M), a.MB * BS);
  const int nkt = (kend + BK - 1) / BK, np = (kend + BS - 1) / BS;
  for (int i = threadIdx.x; i < np; i += NTH)
    pidx[i] = max(a.block_table[i], 0);
  const size_t qs = (size_t)a.Hq * D, rs = (size_t)a.Hkv * D;
  if constexpr (Q8)
    q8_q_tile<D, BQ, LD, NTH>(Qs, (const bf16 *)a.q + (size_t)h * D, qs, q0,
                              a.M);
  else
    cp_rows<D, BQ, NTH>(Qs, (const bf16 *)a.q + (size_t)h * D, qs, q0, a.M);
  __syncthreads();                                   // pidx (Q8: and Q)
  const bf16 *pk = (const bf16 *)a.pool_k, *pv = (const bf16 *)a.pool_v;
  const signed char *qk = (const signed char *)a.pool_k,
                    *qv = (const signed char *)a.pool_v;
  constexpr int CPR8 = D / 16;                       // Q8: 16 codes a copy
  auto raw_of = [&](int kt) { return smem + C::QB + (kt % C::NSTG) * C::RAW; };
  auto stage = [&](int kt) {                         // K, V tile kt
    if constexpr (Q8) {
      unsigned char *raw = raw_of(kt);
      float *sc = reinterpret_cast<float *>(raw + 2 * BK * LDC);
      for (int i = threadIdx.x; i < BK * CPR8; i += NTH) {
        const int ri = i / CPR8, col = i % CPR8 * 16, p = kt * BK + ri;
        const bool ok = p < kend;
        const size_t off =
            ok ? ((size_t)pidx[p / BS] * BS + p % BS) * rs +
                     (size_t)hk * D + col
               : 0;
        cp16(raw + ri * LDC + col, qk + off, ok);
        cp16(raw + (BK + ri) * LDC + col, qv + off, ok);
      }
      for (int i = threadIdx.x; i < BK; i += NTH) {
        const int p = kt * BK + i;
        const bool ok = p < kend;
        const size_t so =
            ok ? ((size_t)pidx[p / BS] * BS + p % BS) * a.Hkv + hk : 0;
        cp4(sc + i, a.pool_ks + so, ok);
        cp4(sc + BK + i, a.pool_vs + so, ok);
      }
      return;
    }
    bf16 *Ks = reinterpret_cast<bf16 *>(smem + C::QB +
                                        (kt % C::NSTG) * C::STAGE);
    for (int i = threadIdx.x; i < BK * CPR; i += NTH) {
      const int ri = i / CPR, col = i % CPR * 8, p = kt * BK + ri;
      const bool ok = p < kend;
      const size_t off =
          ok ? ((size_t)pidx[p / BS] * BS + p % BS) * rs + (size_t)hk * D + col
             : 0;
      cp16(Ks + ri * LD + col, pk + off, ok);
      cp16(Ks + (BK + ri) * LD + col, pv + off, ok);
    }
  };
#pragma unroll
  for (int kt = 0; kt < C::NSTG - 1; ++kt) {         // Q rides in group 0
    if (kt < nkt) stage(kt);
    cp_commit();
  }

  float m[2], l[2], acc[1][ND][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;                                       // this thread's columns
  }
#pragma unroll
  for (int j = 0; j < ND; ++j)
    acc[0][j][0] = acc[0][j][1] = acc[0][j][2] = acc[0][j][3] = 0.f;
  // Q8: the warp's Q A fragments as fp16 pairs, once (the Q tile stays the
  // same)
  unsigned qa[Q8 ? KS : 1][4];
  if constexpr (Q8)
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldsm_x4(qa[kk], Qs + warp * 16 * LD + ldsm_a(lane, LD) + kk * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kk][i] = bf2_to_h2(qa[kk][i]);
    }
  const float sl2 = a.scale * LOG2E;
  // the plain body takes max(raw) * scale as the row max: a positive scale
  const bool always = !(a.scale > 0.f);
  const int qp0 = a.start + wq0;                     // the warp's first pos

  for (int kt = 0; kt < nkt; ++kt) {
    cp_wait<C::NSTG - 2>();
    __syncthreads();               // tile kt landed; tile kt - 1 is done
    if (kt + C::NSTG - 1 < nkt) stage(kt + C::NSTG - 1);
    cp_commit();
    const bf16 *Ks = reinterpret_cast<const bf16 *>(
        smem + C::QB + (Q8 ? 0 : (kt % C::NSTG) * C::STAGE));
    const bf16 *Vs = Ks + BK * LD;
    // Q8: tile kt's codes and K / V scales
    const unsigned char *Kc = raw_of(kt), *Vc = Kc + BK * LDC;
    const float *ksc = reinterpret_cast<const float *>(Kc + 2 * BK * LDC);
    const float *vsc = ksc + BK;
    const int k0 = kt * BK;
    // nothing to add: the warp's rows past Ts, or every key after them
    if (wq0 >= a.M || k0 > qp0 + 15) continue;
    auto body = [&](auto flag) {
      constexpr bool MASK = decltype(flag)::value;
      float s[1][NS][4];
      if constexpr (Q8) {
        // S = s_k (Q . c): each key column times its K scale
        qk_q8<NS, KS, LDC>(s[0], qa, Kc, lane);
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float2 sk =
              *reinterpret_cast<const float2 *>(ksc + 8 * j + 2 * t);
          s[0][j][0] *= sk.x;
          s[0][j][1] *= sk.y;
          s[0][j][2] *= sk.x;
          s[0][j][3] *= sk.y;
        }
      } else {
        mma_abt<1, NS, KS, LD>(s, Qs + warp * 16 * LD, Ks, lane);
      }
      if (MASK)
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qpos = qp0 + g + 8 * (e >> 1);
            const int kpos = k0 + 8 * j + 2 * t + (e & 1);
            s[0][j][e] = kpos <= qpos && kpos < kend ? s[0][j][e] * a.scale
                                                     : NEG_INF;
          }
      float mx[2] = {s[0][0][0], s[0][0][2]};
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          mx[e >> 1] = fmaxf(mx[e >> 1], s[0][j][e]);
      float mc[2];                           // the new m, times log2(e)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float x = mx[i];
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
        const float mnew = fmaxf(m[i], MASK ? x : x * a.scale);
        const float alpha = ex2((m[i] - mnew) * LOG2E);
        m[i] = mnew;
        mc[i] = mnew * LOG2E;
        l[i] *= alpha;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[0][j][2 * i] *= alpha;
          acc[0][j][2 * i + 1] *= alpha;
        }
      }
      unsigned pa[1][KP][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const float p = MASK ? ex2((s[0][j][e] - m[i]) * LOG2E)
                               : ex2(fmaf(s[0][j][e], sl2, -mc[i]));
          s[0][j][e] = p;
          l[i] += p;
        }
      if constexpr (Q8) {
        // O += (P s_v) c: each key's p times its V scale, then rounded to
        // fp16
#pragma unroll
        for (int j = 0; j < NS; ++j) {
          const float2 sv =
              *reinterpret_cast<const float2 *>(vsc + 8 * j + 2 * t);
          s[0][j][0] *= sv.x;
          s[0][j][1] *= sv.y;
          s[0][j][2] *= sv.x;
          s[0][j][3] *= sv.y;
        }
#pragma unroll
        for (int kk = 0; kk < KP; ++kk) {       // c_to_a, in fp16
          pa[0][kk][0] = pack_f16(s[0][2 * kk][0], s[0][2 * kk][1]);
          pa[0][kk][1] = pack_f16(s[0][2 * kk][2], s[0][2 * kk][3]);
          pa[0][kk][2] = pack_f16(s[0][2 * kk + 1][0], s[0][2 * kk + 1][1]);
          pa[0][kk][3] = pack_f16(s[0][2 * kk + 1][2], s[0][2 * kk + 1][3]);
        }
        pv_q8<ND, KP, LDC>(acc[0], pa[0], Vc, lane);
      } else {
        c_to_a<KP>(pa[0], s[0]);
        mma_ab<1, ND, KP, LD>(acc, pa, Vs, lane);    // O += P V
      }
    };
    if (always || k0 + BK > kend || k0 + BK - 1 > qp0)
      body(Flag<true>());
    else
      body(Flag<false>());
  }
  cp_wait<0>();

  // out = O / l, rounded to bf16 into the warp's own Q rows (no other warp
  // reads them), then stored in 16-byte row chunks
  bf16 *Ow = Qs + warp * 16 * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float lt = l[i];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const float inv = 1.f / fmaxf(lt, 1e-30f);
    const int rr = g + 8 * i;
    if constexpr (Q8) {
      // tiles 2b, 2b + 1: columns 16 b + 4t + {0, 2}, {1, 3} (pv_q8)
#pragma unroll
      for (int b = 0; b < ND / 2; ++b)
        *reinterpret_cast<uint2 *>(Ow + rr * LD + 16 * b + 4 * t) =
            make_uint2(pack_bf16(acc[0][2 * b][2 * i] * inv,
                                 acc[0][2 * b + 1][2 * i] * inv),
                       pack_bf16(acc[0][2 * b][2 * i + 1] * inv,
                                 acc[0][2 * b + 1][2 * i + 1] * inv));
    } else {
#pragma unroll
      for (int j = 0; j < ND; ++j)
        *reinterpret_cast<unsigned *>(Ow + rr * LD + 8 * j + 2 * t) =
            pack_bf16(acc[0][j][2 * i] * inv, acc[0][j][2 * i + 1] * inv);
    }
  }
  __syncwarp();
  bf16 *out = (bf16 *)a.attn + (size_t)h * D;
#pragma unroll
  for (int c = lane; c < 16 * CPR; c += 32) {
    const int rr = c / CPR, col = c % CPR * 8;
    if (wq0 + rr < a.M)
      *reinterpret_cast<uint4 *>(out + (size_t)(wq0 + rr) * qs + col) =
          *reinterpret_cast<const uint4 *>(Ow + rr * LD + col);
  }
}

// the largest dynamic shared memory each instance may take, per device (a
// table of this file's own: a function-local static of a template would be
// one object across every loaded copy of the library)
constexpr int MAX_DEVICES = 64, INSTANCES = 2 * Q8_BASE;
static int g_smem[INSTANCES][MAX_DEVICES];

template <class K>
cudaError_t allow_smem(K kern, int inst, size_t bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && g_smem[inst][dev] >= (int)bytes) return e;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < MAX_DEVICES) g_smem[inst][dev] = (int)bytes;
  return e;
}

// PLAN_N values of a call's plan (pt_paged_attention_plan): body (0 rows,
// 1 prefill), splits S, grid x, y, z, threads, dynamic shared memory
constexpr int PLAN_N = 7;

// pages the longest row of the call may hold
inline int pages_of(const LayerArgs *a) {
  const int n = a->lengths ? a->MB * a->BS
                           : (a->start + a->M < a->MB * a->BS
                                  ? a->start + a->M
                                  : a->MB * a->BS);
  return (n + a->BS - 1) / a->BS;
}

template <typename T, int D, int GM, bool Q8>
cudaError_t launch_rows(const LayerArgs *a, int inst, cudaStream_t st,
                        int *plan) {
  using R = Rows<T, D, GM, Q8>;
  const int pages = pages_of(a);
  int S = (pages + MINP - 1) / MINP;
  S = S < 1 ? 1 : S > MAXS ? MAXS : S;
  const int pmax = (pages + S - 1) / S, G = a->Hq / a->Hkv;
  const size_t part = sizeof(float) * NW * GM * (D + 2);
  const size_t smem = (R::RING > part ? R::RING : part) +
                      sizeof(int) * ((pmax + 3) & ~3) +
                      sizeof(float) * S * (G * D + 2 * G);
  auto kern = paged_attention_rows<T, D, GM, Q8>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, a->Hkv, a->M);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (plan) {
    const int p[PLAN_N] = {0, S, S, a->Hkv, a->M, NT, (int)smem};
    for (int i = 0; i < PLAN_N; ++i) plan[i] = p[i];
    return cudaSuccess;
  }
  cudaError_t e = allow_smem(kern, inst, smem);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kern, *a, pmax);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <int D, int WARPS, bool Q8>
cudaError_t launch_prefill(const LayerArgs *a, int inst, cudaStream_t st,
                           int *plan) {
  using C = Pre<D, WARPS, Q8>;
  const size_t smem = C::RING + sizeof(int) * ((pages_of(a) + 3) & ~3);
  const dim3 grid((a->M + C::BQ - 1) / C::BQ, a->Hq);
  if (plan) {
    const int p[PLAN_N] = {1, 1, (int)grid.x, (int)grid.y, 1, C::NTH,
                           (int)smem};
    for (int i = 0; i < PLAN_N; ++i) plan[i] = p[i];
    return cudaSuccess;
  }
  auto kern = paged_attention_prefill<D, WARPS, Q8>;
  cudaError_t e = allow_smem(kern, inst, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, C::NTH, smem, st>>>(*a);
  return cudaGetLastError();
}

// rows body of group size GM; instance index 4 x (dtype, D) + group
template <typename T, int D, bool Q8>
cudaError_t launch_rows_g(const LayerArgs *a, int inst, cudaStream_t st,
                          int *plan) {
  const int G = a->Hq / a->Hkv;
  return G <= 1   ? launch_rows<T, D, 1, Q8>(a, 4 * inst, st, plan)
         : G <= 2 ? launch_rows<T, D, 2, Q8>(a, 4 * inst + 1, st, plan)
         : G <= 4 ? launch_rows<T, D, 4, Q8>(a, 4 * inst + 2, st, plan)
                  : launch_rows<T, D, 8, Q8>(a, 4 * inst + 3, st, plan);
}

// one call, or its plan (`plan` non-null: nothing launched); instances
// 0-29 over full-width pools, Q8_BASE + the same over int8 pools
template <bool Q8>
cudaError_t paged_attention_pool(const LayerArgs *a, cudaStream_t st,
                                 int *plan) {
  const int D = a->D, q = Q8 ? Q8_BASE : 0;
  if (a->dtype == PT_BF16 && !a->lengths && a->M > 16) {
    // instances 24-29: the prefill body, 64 rows a block, or one warp of
    // 16 for a chunk of <= 16 rows
    return D == 32    ? launch_prefill<32, 4, Q8>(a, q + 24, st, plan)
           : D == 64  ? launch_prefill<64, 4, Q8>(a, q + 25, st, plan)
           : D == 128 ? launch_prefill<128, 4, Q8>(a, q + 26, st, plan)
                      : cudaErrorInvalidValue;
  }
  if (a->dtype == PT_BF16 && !a->lengths && a->start + a->M <= MMA16_MAX)
    return D == 32    ? launch_prefill<32, 1, Q8>(a, q + 27, st, plan)
           : D == 64  ? launch_prefill<64, 1, Q8>(a, q + 28, st, plan)
           : D == 128 ? launch_prefill<128, 1, Q8>(a, q + 29, st, plan)
                      : cudaErrorInvalidValue;
  if (a->dtype == PT_BF16)
    return D == 32    ? launch_rows_g<bf16, 32, Q8>(a, q / 4 + 0, st, plan)
           : D == 64  ? launch_rows_g<bf16, 64, Q8>(a, q / 4 + 1, st, plan)
           : D == 128 ? launch_rows_g<bf16, 128, Q8>(a, q / 4 + 2, st, plan)
                      : cudaErrorInvalidValue;
  if (a->dtype == PT_F32)
    return D == 32    ? launch_rows_g<float, 32, Q8>(a, q / 4 + 3, st, plan)
           : D == 64  ? launch_rows_g<float, 64, Q8>(a, q / 4 + 4, st, plan)
           : D == 128 ? launch_rows_g<float, 128, Q8>(a, q / 4 + 5, st, plan)
                      : cudaErrorInvalidValue;
  return cudaErrorInvalidValue;
}

cudaError_t paged_attention(const LayerArgs *a, cudaStream_t st, int *plan) {
  if (a->Hkv <= 0 || a->Hq % a->Hkv || a->Hq / a->Hkv > MAXG || a->BS <= 0)
    return cudaErrorInvalidValue;
  if (!a->kv_quant) return paged_attention_pool<false>(a, st, plan);
  if (!a->pool_ks || !a->pool_vs) return cudaErrorInvalidValue;
  return paged_attention_pool<true>(a, st, plan);
}

}  // namespace pattn
}  // namespace pt

cudaError_t launch_paged_attention(const LayerArgs *a, cudaStream_t s) {
  if (a->M <= 0) return cudaSuccess;
  const cudaError_t e = pt::pattn::paged_attention(a, s, nullptr);
  if (a->kv_quant) return count_launch(CNT_PAGED_ATTENTION_Q8, e);
  return count_launch(CNT_PAGED_ATTENTION, e);
}

// the plan of a call into out[PLAN_N] (body, splits, grid x / y / z,
// threads, dynamic shared memory); nothing launched or counted.  Not bound
// by build.py; tools/pattn_ab.py reads it.
extern "C" int pt_paged_attention_plan(const LayerArgs *a, int *out) {
  return pt::pattn::paged_attention(a, nullptr, out);
}
