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
// below the card's balance point.
//
// B5 (`minplus_kernel<T, R, false>`): a block owns a tile of 128
// consecutive targets t (one per thread) and R rows (8 when W is shared, so
// each W[s,t] load serves 8 rows, 1 when each row has its own W).  Each
// thread walks every s = 0..S-1 in ascending order; dist comes from a chunk
// staged in shared memory and W[s,t] is read coalesced across the warp.
// It reads every W row, reached or not, and at T = 130 the second target
// tile holds 2 live threads of 128; the next redesign moves it onto B4's.
//
// B4 (`minplus_argmin_kernel<T, R>`), redesigned for this card: read only
// the W rows that can reach a target.
//   * Compaction.  A block first loads its R rows' dist for a chunk of
//     sources and compacts the s where any of them is finite into a list
//     in shared memory, in ascending order: a warp ballot per 32 sources
//     and a popc prefix over the block's warps (no atomics, which would
//     lose the order).  With a shared W (R = 8) the list is the union of
//     the rows' live sources; a row that is non-finite at such an s gets
//     +inf from edge() and adds nothing.
//   * Walk.  Each thread walks only the listed s, in list order, for its
//     target t: c = dist + W[s,t], taken when c < best.  Skipping an s
//     whose dist is +inf, -inf or NaN cannot change the result: every such
//     candidate is +inf (edge() makes the dist +inf), never < the +inf the
//     scan starts from, and never < a finite best; the listed s stay in
//     ascending order, so the first s that attains the min is the one the
//     full scan finds.  Values and argmins stay bit-equal.
//   * Targets.  The block has T threads rounded up to a warp (split into
//     passes of at most 512 threads for a long T, each pass re-walking the
//     list, so each needed W byte is still read once): at T = 130 one block
//     of 160 threads covers a row, and the grid is one block per row (per 8
//     rows with a shared W).
// (best, arg) stay in registers; the TPU kernel's (8, 128, 128) VMEM blocks
// and its padding are dropped.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 128;    // B5: targets a block, one a thread
constexpr int kChunk = 256;   // B5: source states of dist staged per pass
constexpr int kSharedRows = 8;
constexpr int kMaxTiles = 65535;   // B5: gridDim.y
constexpr int kMaxThreads = 512;   // B4: targets (and sources) of a pass

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

template <typename T, int R, bool kArg>
__global__ void minplus_kernel(const T* __restrict__ dist,
                               const T* __restrict__ W, T* __restrict__ out,
                               int* __restrict__ arg, int B, int S, int Tn,
                               long long w_stride) {
  __shared__ T d_s[R][kChunk];
  const long long b0 = static_cast<long long>(blockIdx.x) * R;
  const long long left = B - b0;
  const int nb = left < R ? static_cast<int>(left) : R;
  const int t = blockIdx.y * kTile + threadIdx.x;
  // R > 1 only with a shared W (w_stride == 0)
  const T* w = W + b0 * w_stride + t;

  T best[R];
  int a[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = pos_inf<T>();
    a[r] = -1;
  }
  for (int s0 = 0; s0 < S; s0 += kChunk) {
    const int ns = S - s0 < kChunk ? S - s0 : kChunk;
    __syncthreads();   // the previous chunk is consumed
    for (int i = threadIdx.x; i < R * kChunk; i += blockDim.x) {
      const int r = i / kChunk;
      const int s = i - r * kChunk;
      T v = pos_inf<T>();
      if (r < nb && s < ns) v = edge(dist[(b0 + r) * S + s0 + s]);
      d_s[r][s] = v;
    }
    __syncthreads();
    if (t < Tn) {
      const T* wp = w + static_cast<long long>(s0) * Tn;
#pragma unroll 4
      for (int s = 0; s < ns; ++s) {
        const T wv = edge(wp[static_cast<long long>(s) * Tn]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const T c = d_s[r][s] + wv;
          if (c < best[r]) {
            best[r] = c;
            if (kArg) a[r] = s0 + s;
          }
        }
      }
    }
  }
  if (t >= Tn) return;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r < nb) {
      const long long o = (b0 + r) * Tn + t;
      out[o] = best[r];
      if (kArg) arg[o] = a[r];
    }
  }
}

// B4: out / arg of R rows over every target, walking only the sources at
// which one of the rows' dist is finite (see the note at the top).
template <typename T, int R>
__global__ void __launch_bounds__(kMaxThreads)
minplus_argmin_kernel(const T* __restrict__ dist, const T* __restrict__ W,
                      T* __restrict__ out, int* __restrict__ arg, int B,
                      int S, int Tn, long long w_stride) {
  __shared__ int live_s[kMaxThreads];        // a chunk's live sources
  __shared__ T live_d[R][kMaxThreads];       // the rows' dist at them
  __shared__ unsigned warp_live[kMaxThreads / 32];
  const long long b0 = static_cast<long long>(blockIdx.x) * R;
  const long long left = B - b0;
  const int nb = left < R ? static_cast<int>(left) : R;
  // R > 1 only with a shared W (w_stride == 0)
  const T* w = W + b0 * w_stride;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int t0 = 0; t0 < Tn; t0 += blockDim.x) {       // target passes
    const int t = t0 + threadIdx.x;
    T best[R];
    int a[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      best[r] = pos_inf<T>();
      a[r] = -1;
    }
    for (int s0 = 0; s0 < S; s0 += blockDim.x) {      // source chunks
      // compact the chunk's live sources, in ascending order
      const int s = s0 + threadIdx.x;
      T d[R];
      bool live = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        d[r] = r < nb && s < S ? edge(dist[(b0 + r) * S + s]) : pos_inf<T>();
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
      if (t < Tn) {
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
              a[r] = si;
            }
          }
        }
      }
      __syncthreads();   // the list is consumed before the next chunk
    }
    if (t < Tn) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r < nb) {
          const long long o = (b0 + r) * Tn + t;
          out[o] = best[r];
          arg[o] = a[r];
        }
      }
    }
  }
}

template <typename T, int R>
int launch_argmin(const void* dist, const void* W, void* out, void* arg,
                  int B, int S, int Tn, long long w_stride,
                  cudaStream_t stream) {
  // T threads rounded up to a warp, in passes of at most kMaxThreads
  const int passes = (Tn + kMaxThreads - 1) / kMaxThreads;
  const int per = (Tn + passes - 1) / passes;
  const int threads = (per + 31) / 32 * 32;
  minplus_argmin_kernel<T, R><<<static_cast<unsigned int>((B + R - 1) / R),
                                threads, 0, stream>>>(
      static_cast<const T*>(dist), static_cast<const T*>(W),
      static_cast<T*>(out), static_cast<int*>(arg), B, S, Tn, w_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int R, bool kArg>
int launch_rows(const void* dist, const void* W, void* out, void* arg, int B,
                int S, int Tn, long long w_stride, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned int>((B + R - 1) / R),
                  static_cast<unsigned int>((Tn + kTile - 1) / kTile));
  minplus_kernel<T, R, kArg><<<grid, kTile, 0, stream>>>(
      static_cast<const T*>(dist), static_cast<const T*>(W),
      static_cast<T*>(out), static_cast<int*>(arg), B, S, Tn, w_stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kArg>
int launch_minplus(const void* dist, const void* W, void* out, void* arg,
                   int B, int S, int Tn, int w_stride, void* stream) {
  if (B <= 0 || Tn <= 0) return 0;
  if (S < 0 || w_stride < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool shared = w_stride == 0 && B > 1;
  if constexpr (kArg) {
    if (shared) {
      return launch_argmin<T, kSharedRows>(dist, W, out, arg, B, S, Tn, 0,
                                           st);
    }
    return launch_argmin<T, 1>(dist, W, out, arg, B, S, Tn, w_stride, st);
  } else {
    if ((Tn + kTile - 1) / kTile > kMaxTiles) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (shared) {
      return launch_rows<T, kSharedRows, false>(dist, W, out, arg, B, S, Tn,
                                                0, st);
    }
    return launch_rows<T, 1, false>(dist, W, out, arg, B, S, Tn, w_stride,
                                    st);
  }
}

}  // namespace

// Plain C entry points, bound with ctypes.  Pointers are device pointers:
// dist [B,S] contiguous; W's row b starts at W + b * w_stride and is a
// contiguous [S,T] matrix; out [B,T] contiguous; arg [B,T] int32 contiguous
// (not read or written by the min-only entry points, may be null there).
// Returns the cudaError_t of the launch.
extern "C" int minplus_f64(const void* dist, const void* W, void* out,
                           void* arg, int B, int S, int Tn, int w_stride,
                           void* stream) {
  return launch_minplus<double, false>(dist, W, out, arg, B, S, Tn, w_stride,
                                       stream);
}

extern "C" int minplus_f32(const void* dist, const void* W, void* out,
                           void* arg, int B, int S, int Tn, int w_stride,
                           void* stream) {
  return launch_minplus<float, false>(dist, W, out, arg, B, S, Tn, w_stride,
                                      stream);
}

extern "C" int minplus_argmin_f64(const void* dist, const void* W, void* out,
                                  void* arg, int B, int S, int Tn,
                                  int w_stride, void* stream) {
  return launch_minplus<double, true>(dist, W, out, arg, B, S, Tn, w_stride,
                                      stream);
}

extern "C" int minplus_argmin_f32(const void* dist, const void* W, void* out,
                                  void* arg, int B, int S, int Tn,
                                  int w_stride, void* stream) {
  return launch_minplus<float, true>(dist, W, out, arg, B, S, Tn, w_stride,
                                     stream);
}
