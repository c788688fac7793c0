// A K split over a thread-block cluster, folded inside the launch by
// pushes, and the epilogues' chunk stores; shared by gemm.cu's serving
// GEMMs (xw_body) and quant_linear.cu's weight-only decode body (wo_dec).
//
// Device: the S blocks of a cluster hold the K ranges of one output tile of
// NX rows by COLS (128, or 64) columns.  Each stages its fp32 partial tile
// in its own shared memory as [NX][LDR] (the ring, now idle); after a
// cluster barrier
// thread 0 bulk-copies (cp.async.bulk shared::cta -> shared::cluster) each
// peer's 1/S of the rows into that peer's receive slots, on the peer's
// mbarrier; each block then sums its rows over the S slots in split order,
// so two calls are bit-identical.  No workspace, no second kernel.
// (Reading the peers' partials through distributed shared memory instead
// cost 25-36 us a launch at M 256, tools/gemm_ab.py.)
//
// Host: the clusters of each size a kernel keeps resident (asked once a
// device), the split at the least modelled cost, and tensor maps cached by
// their arguments (a map is a pure function of them, so the cache is never
// stale, even shared by several loaded builds: a layer's steady weights
// cost one lookup each).
#pragma once

#include <atomic>
#include <mutex>
#include <unordered_map>

#include "wgmma.cuh"

namespace pt {
namespace splitk {

constexpr int MAX_SPLITS = 8;                   // portable cluster size

// the staged partial tile of NX rows x COLS fp32 columns and the receive
// slots of the peers' slices, overlaid on the idle ring
template <int NX, int COLS = 128> struct Tile {
  static constexpr int LDR = COLS + 4;          // fp32 words a staged row
  static constexpr int ROWB = LDR * 4;
  static constexpr int RED = NX * ROWB;         // this block's partial tile
  static constexpr int RECV = (NX + MAX_SPLITS) * ROWB;  // peers' slices
  static constexpr int BYTES = RED + RECV;
};

// the tile rows block `rank` of S folds: [r0, r0 + nr), R a rank
struct Share {
  int R, r0, nr;
};
template <int NX>
__device__ __forceinline__ Share share_of(int S, int rank) {
  const int R = (NX + S - 1) / S, r0 = rank * R;
  return {R, r0, max(0, min(NX, r0 + R) - r0)};
}

// The fold's exchange, called by every thread that staged part of `red`
// (each after its own fence_proxy_async_smem), thread 0 among them: block
// q sends rows [d R, d R + R) of its partial to block d's recv slot q (one
// bulk copy a peer, on d's recv_bar), then waits for its own slots.  The
// block's other threads call idle() instead; all end with done().
template <int NX, int COLS = 128>
__device__ __forceinline__ void push(const float *red, float *recv,
                                     uint64_t *recv_bar, int S, int rank,
                                     int tid) {
  using T = Tile<NX, COLS>;
  const Share sh = share_of<NX>(S, rank);
  if (tid == 0 && S > 1 && sh.nr > 0)
    mbar_expect_tx(recv_bar, (S - 1) * sh.nr * T::ROWB);
  cluster_arrive();             // every partial staged, every ring idle
  cluster_wait();
  if (tid == 0 && S > 1) {
    for (int d = 0; d < S; ++d) {
      const int dn = max(0, min(NX, d * sh.R + sh.R) - d * sh.R);
      if (d != rank && dn > 0)
        bulk_to_peer(peer_u32(recv + rank * sh.R * T::LDR, d),
                     red + d * sh.R * T::LDR, dn * T::ROWB,
                     peer_u32(recv_bar, d));
    }
  }
  if (S > 1 && sh.nr > 0) mbar_wait_or_trap(recv_bar, 0);
  // my slices have landed, so have my peers' reads of my sources: a block
  // leaves once all have (done); nothing to publish, so relaxed
  cluster_arrive_relaxed();
}
// push's two cluster barriers without its work (a producer's threads:
// code past a merge would be compiled to their registers)
__device__ __forceinline__ void idle() {
  cluster_arrive();
  cluster_wait();
  cluster_arrive_relaxed();
}
// the end of the fold: every block's slices have been read
__device__ __forceinline__ void done() { cluster_wait(); }

// The epilogues' chunks of V (2 or 8) columns: a thread owns one chunk
// column of the staged tile's rows.  V staged fp32 summed into s; V bf16
// loaded as V / 2 packed words, widened; two values rounded and packed
template <int V>
__device__ __forceinline__ void addv(float (&s)[V], const float *p) {
  static_assert(V == 2 || V == 8, "chunks of 2 or 8 columns");
  if constexpr (V == 2) {
    const float2 u = *reinterpret_cast<const float2 *>(p);
    s[0] += u.x, s[1] += u.y;
  } else {
    const float4 u = *reinterpret_cast<const float4 *>(p);
    const float4 v = *reinterpret_cast<const float4 *>(p + 4);
    s[0] += u.x, s[1] += u.y, s[2] += u.z, s[3] += u.w;
    s[4] += v.x, s[5] += v.y, s[6] += v.z, s[7] += v.w;
  }
}
template <int V>
__device__ __forceinline__ void ldv(unsigned (&w)[V / 2], const bf16 *p) {
  if constexpr (V == 2) {
    w[0] = *reinterpret_cast<const unsigned *>(p);
  } else {
    const uint4 u = *reinterpret_cast<const uint4 *>(p);
    w[0] = u.x, w[1] = u.y, w[2] = u.z, w[3] = u.w;
  }
}
template <int V>
__device__ __forceinline__ void widen(float (&f)[V],
                                      const unsigned (&w)[V / 2]) {
#pragma unroll
  for (int i = 0; i < V / 2; ++i) {
    const float2 p = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162 *>(&w[i]));
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned *>(&h);
}

// Where the V-column chunk at column n (n % V == 0) of an [M, N] product
// goes, worked out once a thread: row m's chunk at col + m ld, row-major,
// or with qkv_d > 0 in its head's q, k or v slab (common.cuh out_index).
// A pair never straddles a part (qkv_d is even), nor does an 8-column
// chunk where 8 divides qkv_d: one store; else its four pairs apart.
template <int V> struct ChunkDst {
  size_t col[V / 2], ld;
  bool whole;
  __device__ __forceinline__ ChunkDst(int n, int M, int N, int qkv_d) {
    col[0] = out_index(0, n, M, N, qkv_d);
    ld = qkv_d > 0 ? N / 3 : N;
    whole = V == 2 || qkv_d <= 0 || qkv_d % 8 == 0;
#pragma unroll
    for (int p = 1; p < V / 2; ++p)
      col[p] = whole ? col[0] + 2 * p : out_index(0, n + 2 * p, M, N, qkv_d);
  }
  __device__ __forceinline__ void store(bf16 *Y, int m,
                                        const unsigned (&o)[V / 2]) const {
    const size_t row = (size_t)m * ld;
    if constexpr (V == 2) {
      *reinterpret_cast<unsigned *>(Y + col[0] + row) = o[0];
    } else if (whole) {
      *reinterpret_cast<uint4 *>(Y + col[0] + row) =
          make_uint4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int p = 0; p < V / 2; ++p)
        *reinterpret_cast<unsigned *>(Y + col[p] + row) = o[p];
    }
  }
};

// ------------------------------------------------------------------ host
// A kernel whose clusters the device is asked about: its threads and
// dynamic shared memory a block.
struct KernelShape {
  const void *fn;
  int threads, smem;
};

// The clusters of s blocks (s = 1 .. MAX_SPLITS) of each of N kernels that
// the device keeps resident (cudaOccupancyMaxActiveClusters: a cluster's
// blocks share one GPC, so this is below SMs x blocks an SM / s).
template <int N> struct Residency {
  int clusters[N][MAX_SPLITS + 1];
};

// A Residency a device, filled on the device's first get(), which also
// sets each kernel's shared-memory attribute (once a device and process).
// Each source keeps its own at file scope (`static`): a function-local
// static in a template would be one object across every copy of the
// library a process loads (tools load several builds side by side).
template <int N> class ResidencyTable {
 public:
  cudaError_t get(const KernelShape (&ks)[N], const Residency<N> **out) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= DEVICES) return cudaErrorInvalidDevice;
    *out = &table_[dev];
    if (ready_[dev].load(std::memory_order_acquire)) return e;
    std::lock_guard<std::mutex> hold(mu_);
    if (ready_[dev].load(std::memory_order_acquire)) return e;
    for (int i = 0; i < N; ++i) {
      const KernelShape &k = ks[i];
      e = cudaFuncSetAttribute(
          k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, k.smem);
      if (e != cudaSuccess) return e;
      for (int s = 1; s <= MAX_SPLITS; ++s) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(s);
        cfg.blockDim = dim3(k.threads);
        cfg.dynamicSmemBytes = k.smem;
        cudaLaunchAttribute attr[1];
        attr[0].id = cudaLaunchAttributeClusterDimension;
        attr[0].val.clusterDim.x = s;
        attr[0].val.clusterDim.y = 1;
        attr[0].val.clusterDim.z = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
        // a shape the device cannot hold counts 0 clusters (never chosen)
        if (cudaOccupancyMaxActiveClusters(&table_[dev].clusters[i][s],
                                           k.fn, &cfg) != cudaSuccess) {
          table_[dev].clusters[i][s] = 0;
          cudaGetLastError();
        }
      }
    }
    ready_[dev].store(true, std::memory_order_release);
    return e;
  }

 private:
  static constexpr int DEVICES = 64;
  Residency<N> table_[DEVICES];
  std::atomic<bool> ready_[DEVICES];           // false: static storage
  std::mutex mu_;
};

// K splits: S (1 .. MAX_SPLITS, at most the K steps nk) at the least cost,
// where a block's time goes with its K steps (nk / S) plus `fold_steps` for
// the staging and the fold, and the device runs res[S] clusters of S at
// once: waves x (ceil(nk / S) + fold_steps); ties go to fewer splits
inline int best_split(long long tiles, int nk, const int *res,
                      int fold_steps) {
  long long best = -1;
  int splits = 1;
  for (int s = 1; s <= MAX_SPLITS && s <= nk; ++s) {
    const long long r = res[s];
    if (r <= 0) continue;
    const long long cost =
        (tiles + r - 1) / r * ((nk + s - 1) / s + fold_steps);
    if (best < 0 || cost < best) {
      best = cost;
      splits = s;
    }
  }
  return splits;
}

// A 2-D map as encode_map_2d's, from a cache keyed by all its arguments (a
// model's few hundred maps; emptied past MAX_MAPS, e.g. when scratch
// pointers keep changing).
struct MapKey {
  const void *base;
  uint64_t cols, rows, ld;
  uint32_t box_cols, box_rows;
  int dtype;
  bool operator==(const MapKey &o) const {
    return base == o.base && cols == o.cols && rows == o.rows &&
           ld == o.ld && box_cols == o.box_cols && box_rows == o.box_rows &&
           dtype == o.dtype;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey &k) const {
    return std::hash<const void *>()(k.base) ^
           std::hash<uint64_t>()(k.cols * 0x9E3779B97F4A7C15ull + k.rows) ^
           std::hash<uint64_t>()(k.ld * 31 + k.dtype) ^
           (size_t)k.box_rows << 48;
  }
};
inline cudaError_t cached_map_2d(CUtensorMap *map, CUtensorMapDataType dt,
                                 const void *base, uint64_t cols,
                                 uint64_t rows, uint64_t ld_bytes,
                                 uint32_t box_cols, uint32_t box_rows) {
  constexpr size_t MAX_MAPS = 4096;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  static std::mutex mu;
  const MapKey k{base, cols, rows, ld_bytes, box_cols, box_rows, (int)dt};
  std::lock_guard<std::mutex> hold(mu);
  const auto hit = cache.find(k);
  if (hit != cache.end()) {
    *map = hit->second;
    return cudaSuccess;
  }
  const cudaError_t e =
      encode_map_2d(map, dt, base, cols, rows, ld_bytes, box_cols, box_rows);
  if (e == cudaSuccess) {
    if (cache.size() >= MAX_MAPS) cache.clear();
    cache.emplace(k, *map);
  }
  return e;
}

}  // namespace splitk
}  // namespace pt
