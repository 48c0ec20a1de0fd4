// Dense tropical (min,+) product, with or without its first-occurrence
// argmin.
//
// Replaces two TPU kernels:
//   B5  `minplus_pallas`        (src/repro/kernels/minplus/minplus.py:43,
//                                body `_minplus_kernel` :31-39);
//   B4  `minplus_argmin_pallas` (minplus.py:107, body
//                                `_minplus_argmin_kernel` :85-103).
//
// What it computes, for every row b and target t:
//
//   out[b,t] = min_s dist[b,s] + W_b[s,t]
//   arg[b,t] = the first s that attains it (kept only by the argmin variant)
//
// with W_b = W + b * w_stride.  A batch stride of 0 is the TPU kernel's
// contract: one [S, T] matrix shared by every row (minplus_vecmat,
// minplus_matmat, the layered relaxation of one scenario).  A batch stride
// of S*T (or the layer stride of a [B, L, S, T] stack) gives each row its
// own matrix: the batched dense engines run one launch per layer for a
// whole chunk of scenarios, and every row computes exactly what the TPU
// kernel computes for it.
//
// A non-finite input (+inf, -inf or NaN, in dist or in W) is a missing
// edge, as the TPU kernel's `where(isfinite(x), x, BIG)` makes it.  Missing
// values become +inf before the add, so every candidate is one IEEE add of
// two values in finite U {+inf} and is finite or +inf.  The scan runs over
// ascending s from (+inf, -1) and takes a candidate only when it is
// strictly smaller: that is np.argmin's first occurrence, and the TPU
// kernel's tie order across its S tiles (strict < there too).  So out is
// +inf and arg -1 exactly where no finite candidate reaches t; the TPU
// kernel's BIG sentinel and its clean-up pass are not needed.  Built with
// -fmad=false (no multiply here to contract, but the flag keeps it so):
// the float64 instantiation is bit-equal to the reference's float64 numpy
// dense engines, and the float32 one to the TPU kernel's single float32
// add per candidate.
//
// Bound: bytes.  Each row must read dist (S values), the rows of its W
// that can reach a target, and write out (and arg).  A W row s can change
// row b's result only where dist[b,s] is finite; the solver's layers reach
// few states (10.8% of them at the dense path's largest launch), so the
// bytes this data needs are a tenth of W.  Two operations (an add and a
// compare) per candidate: 0.25 operations per byte of W in float64, far
// below the card's balance point.  At one scenario (B = 1, a Table VII
// layer of S = T = 390) those bytes are a few kB: the launch, one round of
// dependent loads and the merge set the time, so the design spreads the
// few live W rows over as many SMs as it can.
//
// One kernel, `minplus_live_kernel<T, R, kArg, kSplit>`, serves B5 (kArg
// false) and B4 (kArg true).  A block owns R rows (8 when W is shared, so each
// W[s,t] load serves 8 rows; 1 when each row has its own W), a tile of
// `per` consecutive targets (one a thread) and a slice of the sources:
//   * Compaction.  For each chunk of its slice the block loads its rows'
//     dist and compacts the s where any of them is finite into a list in
//     shared memory, in ascending order: a warp ballot per 32 sources and
//     a popc prefix over the block's warps (no atomics, which would lose
//     the order).  With a shared W the list is the union of the rows' live
//     sources; a row that is non-finite at such an s gets +inf from edge()
//     and adds nothing.
//   * Walk.  Each thread walks only the listed s, in list order, for its
//     target t: c = dist + W[s,t], taken when c < best.  Skipping an s
//     whose dist is +inf, -inf or NaN cannot change the result: every such
//     candidate is +inf, never < the +inf the scan starts from, and never
//     < a finite best; the listed s stay in ascending order, so the first
//     s that attains the min is the one the full scan finds.
//   * Split.  The wrapper's plan (ops.dense_plan) gives a large batch one
//     block per (row group, tile of up to 256 targets) and the whole
//     source range: at 20,480 rows x T = 130 that is one block of 160
//     threads a row.  A small batch (fewer such blocks than SMs) gets
//     one-warp target tiles and its sources cut into Q contiguous slices,
//     one block each, launched as a thread-block cluster of Q (up to 16,
//     the non-portable size; a slice fits one chunk of the block's
//     threads where it can): at B = 1, S = T = 390 that is 13 tiles x 13
//     slices = 169 blocks, at S = T = 165 6 x 15 = 90.
//   * Merge.  The blocks of a cluster hold their partial (best, arg) in
//     shared memory; after a cluster barrier each block folds a share of
//     the tile's targets over the Q partials through distributed shared
//     memory (all Q loads in flight at once, then the fold), in ascending
//     slice order with the same strict <, and writes out.  The min over
//     finite U {+inf} values does not depend on order, and the ascending
//     fold keeps the first s of a tie, so B5's values and B4's argmins are
//     the bits of the unsplit scan.  No float atomics.
// (best, arg) stay in registers; the TPU kernel's (8, 128, 128) VMEM blocks
// and its padding are dropped.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSharedRows = 8;
constexpr int kMaxThreads = 256;   // targets (and sources) of a block
constexpr int kMaxCluster = 16;    // source slices of a tile
constexpr int kPortableCluster = 8;

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }

// Missing (non-finite) values become +inf.
template <typename T>
__device__ __forceinline__ T edge(T x) {
  return isfinite(x) ? x : pos_inf<T>();
}

// out / arg of R rows over a tile of `per` targets, from the sources of
// this block's slice at which one of the rows' dist is finite (see the note
// at the top); with kSplit the gridDim.z slices of a tile merge over the
// cluster.  The unsplit launch is its own instantiation, so the merge's
// registers do not lower the occupancy of a large batch.
template <typename T, int R, bool kArg, bool kSplit>
__global__ void __launch_bounds__(kMaxThreads)
minplus_live_kernel(const T* __restrict__ dist, const T* __restrict__ W,
                    T* __restrict__ out, int* __restrict__ arg, int B, int S,
                    int Tn, long long w_stride, int per, int tiles,
                    int slice) {
  __shared__ int live_s[kMaxThreads];        // a chunk's live sources
  __shared__ T live_d[R][kMaxThreads];       // their dist; then the partials
  __shared__ int part_a[R][kArg ? kMaxThreads : 1];
  __shared__ unsigned warp_live[kMaxThreads / 32];
  const long long g = blockIdx.x / tiles;
  const int tile = static_cast<int>(blockIdx.x - g * tiles);
  const long long b0 = g * R;
  const long long left = B - b0;
  const int nb = left < R ? static_cast<int>(left) : R;
  // R > 1 only with a shared W (w_stride == 0)
  const T* w = W + b0 * w_stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int x = threadIdx.x;                 // the thread's target in the tile
  const int t = tile * per + x;
  const bool own = x < per && t < Tn;
  const int s_lo = blockIdx.z * slice;
  const int s_hi = S - s_lo < slice ? S : s_lo + slice;

  T best[R];
  int a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = pos_inf<T>();
    a[r] = -1;
  }
  for (int s0 = s_lo; s0 < s_hi; s0 += blockDim.x) {   // source chunks
    // compact the chunk's live sources, in ascending order
    const int s = s0 + threadIdx.x;
    T d[R];
    bool live = false;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      d[r] = r < nb && s < s_hi ? edge(dist[(b0 + r) * S + s])
                                : pos_inf<T>();
      live |= d[r] < pos_inf<T>();
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_live[warp] = mask;
    __syncthreads();
    int at = __popc(mask & ((1u << lane) - 1u));
    int n = 0;
    for (int i = 0; i < nwarps; ++i) {
      const int c = __popc(warp_live[i]);
      at += i < warp ? c : 0;
      n += c;
    }
    if (live) {
      live_s[at] = s;
#pragma unroll
      for (int r = 0; r < R; ++r) live_d[r][at] = d[r];
    }
    __syncthreads();
    // walk them for this thread's target
    if (own) {
      const T* wt = w + t;
#pragma unroll 8
      for (int i = 0; i < n; ++i) {
        const int si = live_s[i];
        const T wv = edge(wt[static_cast<long long>(si) * Tn]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T c = live_d[r][i] + wv;
          if (c < best[r]) {
            best[r] = c;
            if (kArg) a[r] = si;
          }
        }
      }
    }
    __syncthreads();   // the list is consumed before the next chunk
  }

  if constexpr (!kSplit) {
    if (own) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nb) {
          const long long o = (b0 + r) * Tn + t;
          out[o] = best[r];
          if (kArg) arg[o] = a[r];
        }
      }
    }
  } else {
    // the block's partials into its shared memory (the list is consumed),
    // then each block folds its share of the tile over the cluster's slices
    // in ascending order
#pragma unroll
    for (int r = 0; r < R; ++r) {
      live_d[r][x] = best[r];
      if (kArg) part_a[r][x] = a[r];
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = static_cast<int>(cluster.block_rank());  // blockIdx.z
    const int items = R * per;
    const int Q = gridDim.z;
    const int share = (items + Q - 1) / Q;
    for (int i = threadIdx.x; i < share; i += blockDim.x) {
      const int j = rank * share + i;
      if (j >= items) break;
      const int r = j / per, xj = j - r * per;
      const int tj = tile * per + xj;
      if (r >= nb || tj >= Tn) continue;
      // every peer's partial in flight at once, then the ordered fold
      T c[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q)
        if (q < Q) c[q] = *cluster.map_shared_rank(&live_d[r][xj], q);
      T v = pos_inf<T>();
      int win = -1;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (q < Q && c[q] < v) {
          v = c[q];
          win = q;
        }
      }
      const long long o = (b0 + r) * Tn + tj;
      out[o] = v;
      if (kArg)
        arg[o] = win < 0 ? -1 : *cluster.map_shared_rank(&part_a[r][xj], win);
    }
    cluster.sync();   // the peers have read this block's partials
  }
}

template <typename T, int R, bool kArg>
int launch_live(const void* dist, const void* W, void* out, void* arg, int B,
                int S, int Tn, long long w_stride, int per, int Q,
                cudaStream_t stream) {
  const int tiles = (Tn + per - 1) / per;
  const long long groups = (static_cast<long long>(B) + R - 1) / R;
  if (groups * tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slice = (S + Q - 1) / Q;
  auto kernel = Q > 1 ? minplus_live_kernel<T, R, kArg, true>
                      : minplus_live_kernel<T, R, kArg, false>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(groups * tiles), 1,
                     static_cast<unsigned>(Q));
  cfg.blockDim = dim3(static_cast<unsigned>((per + 31) / 32 * 32));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = static_cast<unsigned>(Q);
  cfg.attrs = attr;
  cfg.numAttrs = Q > 1 ? 1 : 0;
  if (Q > kPortableCluster) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(dist),
                         static_cast<const T*>(W), static_cast<T*>(out),
                         static_cast<int*>(arg), B, S, Tn, w_stride, per,
                         tiles, slice);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kArg>
int launch_minplus(const void* dist, const void* W, void* out, void* arg,
                   int B, int S, int Tn, int w_stride, int per, int Q,
                   void* stream) {
  if (B <= 0 || Tn <= 0) return 0;
  if (S < 1 || w_stride < 0 || per < 1 || per > kMaxThreads || Q < 1
      || Q > kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_stride == 0 && B > 1) {
    return launch_live<T, kSharedRows, kArg>(dist, W, out, arg, B, S, Tn, 0,
                                             per, Q, st);
  }
  return launch_live<T, 1, kArg>(dist, W, out, arg, B, S, Tn, w_stride, per,
                                 Q, st);
}

}  // namespace

// Plain C entry points, bound with ctypes.  Pointers are device pointers:
// dist [B,S] contiguous; W's row b starts at W + b * w_stride and is a
// contiguous [S,T] matrix; out [B,T] contiguous; arg [B,T] int32 contiguous
// (not read or written by the min-only entry points, may be null there).
// per: targets a block (1..256); Q: source slices a tile, the cluster size
// (1..16); both from ops.dense_plan.  Returns the cudaError_t of the launch.
extern "C" int minplus_f64(const void* dist, const void* W, void* out,
                           void* arg, int B, int S, int Tn, int w_stride,
                           int per, int Q, void* stream) {
  return launch_minplus<double, false>(dist, W, out, arg, B, S, Tn, w_stride,
                                       per, Q, stream);
}

extern "C" int minplus_f32(const void* dist, const void* W, void* out,
                           void* arg, int B, int S, int Tn, int w_stride,
                           int per, int Q, void* stream) {
  return launch_minplus<float, false>(dist, W, out, arg, B, S, Tn, w_stride,
                                      per, Q, stream);
}

extern "C" int minplus_argmin_f64(const void* dist, const void* W, void* out,
                                  void* arg, int B, int S, int Tn,
                                  int w_stride, int per, int Q, void* stream) {
  return launch_minplus<double, true>(dist, W, out, arg, B, S, Tn, w_stride,
                                      per, Q, stream);
}

extern "C" int minplus_argmin_f32(const void* dist, const void* W, void* out,
                                  void* arg, int B, int S, int Tn,
                                  int w_stride, int per, int Q, void* stream) {
  return launch_minplus<float, true>(dist, W, out, arg, B, S, Tn, w_stride,
                                     per, Q, stream);
}
