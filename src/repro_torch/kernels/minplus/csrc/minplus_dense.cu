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
// Bound: bytes.  Each row must read dist (S values) and its W (S*T values,
// or one shared W for all rows) and write out (and arg): two operations
// (an add and a compare) per candidate, 2*B*S*T in all.  With a W per row
// that is 2 operations per 8 bytes of W in float64, 0.25 operations per
// byte, far below the card's balance point (about 10 for float64); with a
// shared W it is 2*B operations per W value, still below it for the
// batches the path passes (B <= 8 rows a block share one W load).
//
// Design against that bound: each byte of W crosses device memory once.  A
// block owns a tile of 128 consecutive targets t (one per thread) and R
// rows: R = 8 when W is shared, so each W[s,t] load serves 8 rows, and
// R = 1 when each row has its own W.  Each thread walks s = 0..S-1 in
// ascending order; dist[b,s] comes from a tile staged in shared memory
// (read as a broadcast), and W[s,t] is read coalesced across the warp.
// (best, arg) stay in registers.  The TPU kernel's (8, 128, 128) VMEM
// blocks and its padding are dropped.  Making it fast (several targets a
// thread, vector loads, the second T tile of S = 130 folded into the
// first) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 128;    // targets a block, one a thread
constexpr int kChunk = 256;   // source states of dist staged per pass
constexpr int kSharedRows = 8;
constexpr int kMaxTiles = 65535;   // gridDim.y

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
  if ((Tn + kTile - 1) / kTile > kMaxTiles || S < 0 || w_stride < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_stride == 0 && B > 1) {
    return launch_rows<T, kSharedRows, kArg>(dist, W, out, arg, B, S, Tn, 0,
                                             st);
  }
  return launch_rows<T, 1, kArg>(dist, W, out, arg, B, S, Tn, w_stride, st);
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
