// Decode attention over a contiguous KV cache: one query token per
// sequence against its cache rows [0, lengths[b]), GQA native.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_attention.py
// (_decode_kernel, pallas_call at :106), with its arithmetic: fp32
// scores q.k * scale, an online softmax over blocks of 512 cache rows
// (the Pallas kernel's block_t) in fp32, p rounded to the cache's dtype
// before p @ v with fp32 accumulation, out = acc / max(l, 1e-30) in q's
// dtype.  Within a block the max is taken over the whole block before any
// p is formed, as the Pallas kernel does, so the rounding of p matches
// the plain version (ops/decode_attention.py) exactly, not just to fp32.
// A row with length 0 has every score masked to NEG_INF, so, as in the
// plain version and the Pallas kernel, every one of its T cache rows gets
// p = exp(0) = 1: its output is the mean of v over the T rows.
//
// Layouts: q [B, Hq, D] contiguous; k, v [B, T, Hkv, D] read in place
// through a batch stride sb, a row stride st and a head stride sh
// (elements, multiples of 16 bytes; the last dim contiguous), so a
// layer's slice of the generation cache (sh = D) and a head-major
// [B, Hkv, T, D] cache seen as [B, T, Hkv, D] (Paddle's MMHA cache
// cache_kv[0] of [2, B, H, T_max, D]: sb = H T D, st = D, sh = T D, each
// (b, h) one contiguous run of rows) need no copy; lengths int32 [B];
// out [B, Hq, D].
//
// What bounds it on an H100: bytes.  It reads each valid K and V row once
// (generation at llama_7b width, B 8, 256 cached rows: 33.5 MB a layer,
// 10 us at 3.35 TB/s) and does 4 flops per cached element.  What held the
// one-block-per-(b, kv head) design back was latency: 256 blocks, each
// requesting V only after every score of a 512-row block existed, with a
// few 8-byte loads in flight a warp.  Design:
//   * The rows of each (b, kv head) are split over a thread-block cluster
//     of S blocks (grid (S, Hkv, B), cluster (S, 1, 1), S = min(8,
//     ceil(min(T, 512) / ROWS)), ROWS 128): block r takes rows [t0 + r c,
//     t0 + (r+1) c) of every 512-row block t0 (c = ceil(min(T, 512) / S)
//     <= 128), clipped to the length.  At generation's T 256: S 2, 512
//     blocks of 128 rows, all resident at once (5 an SM); 64 rows a block
//     (S 4) left 32 of 1024 blocks to a second round, since the card keeps
//     248 clusters of 4 resident, and waited longer at each cluster
//     barrier (tools/dattn_ab.py).
//   * Each block copies its K rows and V's first 16 rows into shared
//     memory with 16-byte cp.async up front (chunks swizzled, chunk k of
//     row i at k ^ (i & 7), for conflict-free ldmatrix); once K is scored
//     its tile takes V's other rows, whose copies overlap the exchange.
//     With more than one 512-row block the next one's K and first V rows
//     go into a second stage meanwhile.
//   * bf16: both products on the tensor cores (mma.sync m16n8k16, fp32
//     accumulators): scores = K q^T, 16 rows by up to 8 heads a tile;
//     p = exp(s - m) once for each (row, head) into shared memory, bf16;
//     O^T += V^T P with each warp owning D / 4 output columns.  fp32: FMAs,
//     a lane one 16-byte chunk of a row, shuffles across the row's lanes.
//   * The 512-row max: each warp writes its maxes per head to its own
//     shared memory (double-buffered by the parity of the 512-row block);
//     the cluster barrier's arrival publishes them, its wait follows this
//     block's V copies, and lanes then read the S x 4 warps' maxes of all
//     blocks (mapa / ld.shared::cluster), so every p is formed with the
//     max of the whole 512-row block, as the plain version does.
//   * The fold: each block sums its (l[G], acc[G][D]) in a fixed order and
//     stores it into rank 0's slot r (st.shared::cluster); after a cluster
//     barrier (which also keeps every block's maxes alive until its peers
//     have read them) rank 0 sums the slots in rank order and writes out.
//     Repeated calls are bit-identical; one launch a call.
//   * head_dim 64 and 128 and the group sizes 1, 2, 4 and 8 (G <= 8
//     rounded up) are template instances; the wrapper refuses any other
//     head_dim and G > 8.  pt_decode_attention_plan reports a call's
//     cluster size, rows a block, shared memory and residency.
#include <type_traits>

#include "mma.cuh"
#include "wgmma.cuh"

namespace pt {
namespace dattn {

constexpr int NT = 128, NW = NT / 32;
// ROWS: the rows a block aims to take of a 512-row block (S = min(MAXS,
// ceil(min(T, 512) / ROWS))); CH: the most it can take
constexpr int BLOCK_T = 512, ROWS = 128, MAXS = 8, CH = 128;
static_assert(ROWS <= CH && BLOCK_T / MAXS <= CH, "rows a block <= CH");
constexpr int MAXG = 8;
constexpr float NEG_INF = -1e30f;

template <typename T, int D> struct Shape {
  static constexpr int EPC = 16 / (int)sizeof(T);   // elements a chunk
  static constexpr int CPR = D / EPC;               // chunks a row (>= 8)
  static constexpr int RPW = 32 / CPR;              // rows a warp step
  static constexpr int RPS = NW * RPW;              // rows a block step
  static constexpr int QW = D / 2 + 4;              // words a q row (bf16)
};

// tile rows: c rounded up to the 16-row mma tiles; V's first VT rows
// have a tile of their own, the rest take K's tile once it is scored
constexpr int VT = 16;
__host__ __device__ inline int rows16(int c) { return (c + 15) / 16 * 16; }

// shared memory: NS stages of a K tile of rows16(c) rows and a V tile of
// VT rows, rows of D elements with their 16-byte chunks swizzled
// (chunk k of row i at k ^ (i & 7)); the warps' final sums reuse stage 0
// (at least FOLD bytes).  Then the scores [GM][CH] (fp32), bf16 p
// [GM][CH] (bf16), q [GM][QW] (bf16), the warps' maxes [2][NW][GM] and
// the blocks' sums [S][G D + G] (rank 0's).
template <int D, int GM>
constexpr size_t FOLD = sizeof(float) * NW * GM * (D + 1);
template <typename T, int D, int GM> size_t tiles_bytes(int NS, int c) {
  const size_t t = (size_t)NS * (rows16(c) + VT) * D * sizeof(T);
  return ((t > FOLD<D, GM> ? t : FOLD<D, GM>) + 15) & ~(size_t)15;
}
template <typename T, int D, int GM>
size_t smem_bytes(int NS, int c, int S, int G) {
  return tiles_bytes<T, D, GM>(NS, c) +
         sizeof(float) * (GM * CH + GM * CH / 2 + GM * Shape<T, D>::QW +
                          2 * NW * GM +
                          (size_t)S * (G * D + G));
}

// element offset of chunk k of row i in a swizzled tile
template <int D, int EPC> __device__ __forceinline__ int swz(int i, int k) {
  return i * D + ((k ^ (i & 7)) * EPC);
}

// one 16-byte chunk of shared memory as floats
template <typename T, int EPC>
__device__ __forceinline__ void chunk_f(const T *p, float *f) {
  const uint4 u = *reinterpret_cast<const uint4 *>(p);
  const T *e = reinterpret_cast<const T *>(&u);
#pragma unroll
  for (int i = 0; i < EPC; ++i) f[i] = to_f<T>(e[i]);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T, int D, int GM>
__global__ void __launch_bounds__(NT)
    decode_attention_kernel(const T *__restrict__ q, const T *__restrict__ kc,
                            const T *__restrict__ vc,
                            const int *__restrict__ lengths,
                            T *__restrict__ out, int Hq, int Hkv, int T_,
                            long long sb, long long st, long long sh,
                            float scale, int c,
                            int NS, int tiles_b) {
  using Sh = Shape<T, D>;
  constexpr int EPC = Sh::EPC, CPR = Sh::CPR, RPW = Sh::RPW, RPS = Sh::RPS;
  constexpr int QW = Sh::QW;
  // bf16 runs both products on the tensor cores (mma.sync m16n8k16, fp32
  // accumulators); fp32 on FMAs
  constexpr bool MMA = std::is_same<T, bf16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  T *tiles = reinterpret_cast<T *>(smem);
  float *sc = reinterpret_cast<float *>(smem + tiles_b);
  bf16 *pb = reinterpret_cast<bf16 *>(sc + GM * CH);
  unsigned *qs = reinterpret_cast<unsigned *>(sc + GM * CH + GM * CH / 2);
  float *pmax = reinterpret_cast<float *>(qs + GM * QW);
  float *recv = pmax + 2 * NW * GM;

  const int S = gridDim.x, r = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ch = lane % CPR, ro = lane / CPR;      // FMA: chunk, row
  const int t4 = lane & 3, hr = lane >> 2;         // MMA: fragment indices
  const int len = min(max(lengths[b], 0), T_);
  const bool none = len == 0;           // every row masked: p = 1 each
  const int rows = none ? T_ : len;
  const int nblk = (rows + BLOCK_T - 1) / BLOCK_T;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const int kr = rows16(c), vh = VT;

  // this block's rows of 512-row block j: [lo, lo + n), n may be <= 0
  auto lo_of = [&](int j) { return j * BLOCK_T + r * c; };
  auto n_of = [&](int j) {
    const int lo = lo_of(j);
    return min(min(lo + c, j * BLOCK_T + BLOCK_T), rows) - lo;
  };
  // rows [r0, r1) of `src` (K or V) into `dst` with 16-byte copies; rows
  // [r1, r2) are zero-filled (a 16-row tile's tail, which p . v reads)
  auto copy = [&](T *dst, const T *src, int lo, int r0, int r1, int r2) {
    for (int i = tid; i < (r2 - r0) * CPR; i += NT) {
      const int row = i / CPR, cc = i % CPR;
      const bool ok = r0 + row < r1;
      cp16(dst + swz<D, EPC>(row, cc),
           src + base + (size_t)(ok ? lo + r0 + row : 0) * st + cc * EPC,
           ok);
    }
  };
  auto stage = [&](int j) { return tiles + (size_t)(j % NS) * (kr + vh) * D; };
  // K into stage j % NS, then V's rows [0, vh) after it: two commit groups
  // (K's empty when no score is needed)
  auto issue = [&](int j) {
    T *kt = stage(j);
    const int lo = lo_of(j), n = max(n_of(j), 0);
    if (!none) copy(kt, kc, lo, 0, n, n);
    cp_commit();
    copy(kt + kr * D, vc, lo, 0, min(n, vh), min(rows16(n), vh));
    cp_commit();
  };

  if (nblk > 0) issue(0);
  // fp32: q's chunk ch of each head in registers; bf16: q in shared memory
  // as bf16 pairs, the heads past G zero
  float qf[GM][EPC], acc[GM][EPC], m[GM], l[GM];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    const T *qg = q + ((size_t)b * Hq + (size_t)h * G + g) * D;
#pragma unroll
    for (int e = 0; e < EPC; ++e) {
      acc[g][e] = 0.f;
      qf[g][e] = !MMA && g < G ? to_f<T>(qg[ch * EPC + e]) : 0.f;
    }
  }
  if (MMA)
    for (int i = tid; i < GM * D / 2; i += NT) {
      const int g = i / (D / 2), w = i % (D / 2);
      const unsigned short *qg = reinterpret_cast<const unsigned short *>(
          q + ((size_t)b * Hq + (size_t)h * G + g) * D);
      qs[g * QW + w] = g < G ? qg[2 * w] | (unsigned)qg[2 * w + 1] << 16 : 0u;
    }
  // bf16: warp w's columns [w D / NW, (w + 1) D / NW) of O^T [D][heads]
  // in the fragments of MT m16n8 tiles (lane: d 16 mt + hr (+8), heads
  // 2 t4, 2 t4 + 1)
  constexpr int MT = MMA ? D / 16 / NW : 1;
  float oacc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[mt][e] = 0.f;

  for (int j = 0; j < nblk; ++j) {
    const bool more = j + 1 < nblk;
    T *kt = stage(j);
    const T *vt = kt + kr * D;
    const int n = n_of(j);
    cp_wait<1>();                      // this block's K (V may be in flight)
    __syncthreads();

    // scores of this block's rows into sc, and their max per head, by
    // warp (bf16: 16-row tiles warp, warp + NW, ...; a lane holds rows
    // hr, hr + 8 of a tile for heads 2 t4, 2 t4 + 1)
    if constexpr (MMA) {
      float mh[2] = {NEG_INF, NEG_INF};
      for (int r0 = 16 * warp; r0 < n; r0 += 16 * NW) {
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
        if (!none)
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            unsigned a[4];
            ldsm_x4(a, kt + swz<D, EPC>(r0 + (lane & 15),
                                        2 * kk + (lane >> 4)));
            const unsigned b0 = hr < G ? qs[hr * QW + kk * 8 + t4] : 0u;
            const unsigned b1 = hr < G ? qs[hr * QW + kk * 8 + t4 + 4] : 0u;
            mma_bf16(s4, a, b0, b1);
          }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + hr + (e >> 1) * 8, hd = 2 * t4 + (e & 1);
          const float sv = none ? NEG_INF : s4[e] * scale;
          if (row < n && hd < G) {
            sc[hd * CH + row] = sv;
            mh[e & 1] = fmaxf(mh[e & 1], sv);
          }
        }
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          mh[k] = fmaxf(mh[k], __shfl_xor_sync(0xffffffffu, mh[k], o));
      if (lane < 4)
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (2 * lane + k < G)
            pmax[((j & 1) * NW + warp) * GM + 2 * lane + k] = mh[k];
    } else {
      float mloc[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) mloc[g] = NEG_INF;
      for (int i0 = 0; i0 < n; i0 += RPS) {
        const int i = i0 + warp * RPW + ro;
        const bool live = i < n;
        float kf[EPC];
        if (live && !none)
          chunk_f<T, EPC>(kt + swz<D, EPC>(i, ch), kf);
        else
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[e] = 0.f;
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < EPC; ++e) s = fmaf(qf[g][e], kf[e], s);
#pragma unroll
          for (int o = CPR / 2; o > 0; o >>= 1)
            s += __shfl_xor_sync(0xffffffffu, s, o);
          s = none ? NEG_INF : s * scale;
          if (live) {
            if (ch == 0) sc[g * CH + i] = s;
            mloc[g] = fmaxf(mloc[g], s);
          }
        }
      }
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float v = warp_max(mloc[g]);
        if (lane == 0) pmax[((j & 1) * NW + warp) * GM + g] = v;
      }
    }
    // K is scored: its tile takes V's rows [vh, n), then the next 512-row
    // block's K and V start into the other stage (the one block j - 1 used)
    __syncthreads();
    {
      const int nn = max(n, 0);
      copy(kt, vc, lo_of(j), vh, max(nn, vh), max(rows16(nn), vh));
    }
    cp_commit();
    if (more) issue(j + 1);
    // the 512-row block's max from the S x NW warps' maxes: the cluster
    // barrier's arrival publishes pmax, its wait comes after this block's
    // V has landed; then lane rr NW + w (< S NW) of every warp reads warp
    // w's of peer rr
    cluster_arrive();
    if (more) cp_wait<2>(); else cp_wait<0>();     // this block's V
    __syncthreads();
    cluster_wait();

    float alpha[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) alpha[g] = 1.f;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float v =
          lane < S * NW
              ? ld_peer_f32(peer_u32(
                    pmax + ((j & 1) * NW + lane % NW) * GM + g, lane / NW))
              : NEG_INF;
      const float mn = fmaxf(m[g], warp_max(v));
      alpha[g] = expf(m[g] - mn);
      m[g] = mn;
    }
    if constexpr (MMA) {
      // p = exp(s - m) once for each row and head: l sums it, bf16(p) (0
      // past n, to the 16-row tile's end) goes into pb [head][row], the B
      // fragments of O^T += V^T P over all rows
      float al[2] = {1.f, 1.f};
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int k = 0; k < 2; ++k)
          if (g == 2 * t4 + k) al[k] = alpha[g];
        if (g >= G) continue;
        l[g] *= alpha[g];
        for (int row = tid; row < rows16(n); row += NT) {
          const float p = row < n ? expf(sc[g * CH + row] - m[g]) : 0.f;
          l[g] += p;
          pb[g * CH + row] = __float2bfloat16(p);
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[mt][e] *= al[e & 1];
      __syncthreads();
      const unsigned *pw = reinterpret_cast<const unsigned *>(pb);
      for (int k0 = 0; k0 < n; k0 += 16) {
        const unsigned b0 = hr < G ? pw[(hr * CH + k0) / 2 + t4] : 0u;
        const unsigned b1 = hr < G ? pw[(hr * CH + k0) / 2 + t4 + 4] : 0u;
        const T *vb = k0 < vh ? vt : kt;
        const int vr = (k0 < vh ? k0 : k0 - vh) + (lane & 7) +
                       ((lane >> 4) & 1) * 8;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          unsigned a[4];
          ldsm_x4_t(a, vb + swz<D, EPC>(vr, 2 * (warp * MT + mt) +
                                                ((lane >> 3) & 1)));
          mma_bf16(oacc[mt], a, b0, b1);
        }
      }
    } else {
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        l[g] *= alpha[g];
#pragma unroll
        for (int e = 0; e < EPC; ++e) acc[g][e] *= alpha[g];
      }
      // acc += rnd(p) * v over this lane's rows; l += p (one lane a row)
      for (int i0 = 0; i0 < n; i0 += RPS) {
        const int i = i0 + warp * RPW + ro;
        if (i >= n) break;
        float vf[EPC];
        chunk_f<T, EPC>(i < vh ? vt + swz<D, EPC>(i, ch)
                               : kt + swz<D, EPC>(i - vh, ch),
                        vf);
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          if (g >= G) break;
          const float p = expf(sc[g * CH + i] - m[g]);
          if (ch == 0) l[g] += p;
          const float pr = rnd<T>(p);
#pragma unroll
          for (int e = 0; e < EPC; ++e)
            acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
        }
      }
    }
    __syncthreads();                  // the stage and the scores are reused
  }

  // this block's (l, acc): the lanes, then the warps (bf16: l only; each
  // warp holds its own columns of acc), summed in a fixed order (the
  // warps' through stage 0) and stored into rank 0's slot r;
  // after a cluster barrier (which also keeps every block's pmax alive
  // until its peers have read it) rank 0 sums the slots in rank order and
  // writes out, and the others leave.
  float *part = reinterpret_cast<float *>(smem);   // [NW][GM][D], tiles
  float *partl = part + NW * GM * D;               // [NW][GM]
  const int RS = G * D + G;                        // a slot: acc, then l
  if constexpr (MMA) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (g >= G) break;
      const float v = warp_sum(l[g]);
      if (lane == 0) partl[warp * GM + g] = v;
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hd = 2 * t4 + (e & 1);
        if (hd < G)
          part[hd * D + 16 * (warp * MT + mt) + hr + (e >> 1) * 8] =
              oacc[mt][e];
      }
  } else {
#pragma unroll
    for (int o = CPR; o < 32; o <<= 1)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
        l[g] += __shfl_xor_sync(0xffffffffu, l[g], o);
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], o);
      }
    if (ro == 0)
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        if (g >= G) break;
#pragma unroll
        for (int e = 0; e < EPC; ++e)
          part[(warp * GM + g) * D + ch * EPC + e] = acc[g][e];
        if (ch == 0) partl[warp * GM + g] = l[g];
      }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D, d = i % D;
    float s = 0.f;
    if constexpr (MMA)
      s = part[i];                      // one warp's columns
    else
#pragma unroll
      for (int w = 0; w < NW; ++w) s += part[(w * GM + g) * D + d];
    st_peer_f32(peer_u32(recv + r * RS + i, 0), s);
  }
  if (tid < G) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) s += partl[w * GM + tid];
    st_peer_f32(peer_u32(recv + r * RS + G * D + tid, 0), s);
  }
  cluster_arrive();
  cluster_wait();
  if (r != 0) return;
  for (int i = tid; i < G * D; i += NT) {
    const int g = i / D;
    float s = 0.f, ls = 0.f;
    for (int rr = 0; rr < S; ++rr) {
      s += recv[rr * RS + i];
      ls += recv[rr * RS + G * D + g];
    }
    out[((size_t)b * Hq + (size_t)h * G) * D + i] =
        from_f<T>(s / fmaxf(ls, 1e-30f));
  }
}

// whether an instance (dtype, head_dim, group) has its shared-memory
// limit raised on a device; a table of this file's own (a function-local
// static of a template would be one object across every loaded copy of
// the library)
constexpr int MAX_DEVICES = 64;
static bool g_ready[2][2][4][MAX_DEVICES];

// PLAN_N values of a call's plan (pt_decode_attention_plan): cluster
// size S, rows a block c, stages NS, dynamic shared memory, blocks an SM
// and clusters the device keeps resident
constexpr int PLAN_N = 6;

// launches one call, or with `plan` fills it and launches nothing
template <typename T, int D, int GM>
cudaError_t launch(int B, int Hq, int Hkv, int T_, long long sb,
                   long long st, long long sh, float scale, const void *q,
                   const void *k,
                   const void *v, const int *lengths, void *out,
                   cudaStream_t s, int *plan) {
  auto kern = decode_attention_kernel<T, D, GM>;
  // the largest footprint (two stages of CH rows) is allowed once a device
  bool *ready = g_ready[sizeof(T) == 2][D == 128][GM == 1   ? 0
                                                 : GM == 2 ? 1
                                                 : GM == 4 ? 2
                                                           : 3];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= MAX_DEVICES || !ready[dev]) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<T, D, GM>(2, CH, MAXS, GM));
    if (e != cudaSuccess) return e;
    if (dev < MAX_DEVICES) ready[dev] = true;
  }
  const int n = T_ < BLOCK_T ? T_ : BLOCK_T;
  int S = (n + ROWS - 1) / ROWS;
  S = S < 1 ? 1 : S > MAXS ? MAXS : S;
  const int c = (n + S - 1) / S;           // <= CH
  const int NS = T_ > BLOCK_T ? 2 : 1;
  const int tiles_b = (int)tiles_bytes<T, D, GM>(NS, c);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, Hkv, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem_bytes<T, D, GM>(NS, c, S, Hq / Hkv);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (plan) {
    plan[0] = S, plan[1] = c, plan[2] = NS;
    plan[3] = (int)cfg.dynamicSmemBytes;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &plan[4], kern, NT, cfg.dynamicSmemBytes);
    return e != cudaSuccess ? e
                            : cudaOccupancyMaxActiveClusters(&plan[5], kern,
                                                             &cfg);
  }
  e = cudaLaunchKernelEx(&cfg, kern, (const T *)q, (const T *)k,
                         (const T *)v, lengths, (T *)out, Hq, Hkv, T_, sb, st,
                         sh, scale, c, NS, tiles_b);
  return e != cudaSuccess ? e : cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, int B, int Hq, int Hkv, int T_, long long sb,
                     long long st, long long sh, float scale, const void *q,
                     const void *k, const void *v, const int *lengths,
                     void *out, cudaStream_t s, int *plan) {
  auto f = G <= 1 ? launch<T, D, 1>
           : G <= 2 ? launch<T, D, 2>
           : G <= 4 ? launch<T, D, 4>
                    : launch<T, D, 8>;
  return f(B, Hq, Hkv, T_, sb, st, sh, scale, q, k, v, lengths, out, s,
           plan);
}

}  // namespace dattn
}  // namespace pt

// one call, or its plan (`plan` non-null: nothing launched or counted)
static cudaError_t decode_attention(int dtype, int B, int Hq, int Hkv, int D,
                                    int T, long long sb, long long st,
                                    long long sh, float scale, const void *q,
                                    const void *k, const void *v,
                                    const int *lengths, void *out,
                                    cudaStream_t s, int *plan) {
  using namespace pt::dattn;
  if (Hkv <= 0 || Hq % Hkv || Hq / Hkv > MAXG || T < 0)
    return cudaErrorInvalidValue;
  const int esz = dtype == PT_BF16 ? 2 : 4;
  if ((sb * esz) % 16 || (st * esz) % 16 || (sh * esz) % 16)
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  auto f = dtype == PT_F32 && D == 64     ? launch_g<float, 64>
           : dtype == PT_F32 && D == 128  ? launch_g<float, 128>
           : dtype == PT_BF16 && D == 64  ? launch_g<pt::bf16, 64>
           : dtype == PT_BF16 && D == 128 ? launch_g<pt::bf16, 128>
                                          : nullptr;
  if (!f) return cudaErrorInvalidValue;
  return f(G, B, Hq, Hkv, T, sb, st, sh, scale, q, k, v, lengths, out, s,
           plan);
}

cudaError_t launch_decode_attention(int dtype, int B, int Hq, int Hkv, int D,
                                    int T, long long sb, long long st,
                                    long long sh, float scale, const void *q,
                                    const void *k, const void *v,
                                    const int *lengths, void *out,
                                    cudaStream_t s) {
  if (B <= 0 || Hq <= 0) return cudaSuccess;
  return count_launch(CNT_DECODE_ATTENTION,
                      decode_attention(dtype, B, Hq, Hkv, D, T, sb, st, sh,
                                       scale, q, k, v, lengths, out, s,
                                       nullptr));
}

extern "C" int pt_decode_attention(int dtype, int B, int Hq, int Hkv, int D,
                                   int T, long long sb, long long st,
                                   long long sh, float scale, const void *q,
                                   const void *k, const void *v,
                                   const int *lengths, void *out,
                                   void *stream) {
  return launch_decode_attention(dtype, B, Hq, Hkv, D, T, sb, st, sh, scale,
                                 q, k, v, lengths, out, (cudaStream_t)stream);
}

// the plan of a call of this shape into out[PLAN_N]: caches [B, T, Hkv, D]
// with head stride sh (D: contiguous; T D: head-major [B, Hkv, T, D]).
// Not bound by build.py; tools/dattn_ab.py and chip_smoke.py read it.
extern "C" int pt_decode_attention_plan(int dtype, int B, int Hq, int Hkv,
                                        int D, int T, long long sh,
                                        int *out) {
  const bool heads_major = sh != D;
  return decode_attention(dtype, B, Hq, Hkv, D, T, (long long)T * Hkv * D,
                          heads_major ? (long long)D : (long long)Hkv * D, sh,
                          1.f, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, out);
}
