// Chained depth-banded (min,+) relaxation with first-occurrence argmin parents.
//
// Replaces the TPU kernel `banded_minplus_chain_pallas`
// (src/repro/kernels/minplus/minplus.py:329, body `_banded_chain_kernel`
// :183-210).  Launched with B = 1 and L = 1 it is also the port of the
// one-layer unit `banded_minplus_pallas` (minplus.py:385, body :156-180).
//
// What it computes, for each scenario b and layer l = 0..L-1, with d the
// (N, G+1) grid after layer l-1 (the init grid for l = 0):
//
//   hist[b,l,m,g] = min_n d[n, g - st[b,l,n,m]] + E[b,l,n,m]
//
// over the source nodes n with g - st >= 0 that pass the lambda window
// (lo < 0, or g >= lo, or st == 0).  arg[b,l,m,g] is the first n that
// attains the min: the scan runs over ascending n from (+inf, -1) and takes
// a candidate only when it is strictly smaller, so arg is -1 exactly where
// no candidate is finite.  Every candidate is one IEEE add and the min does
// not depend on the order of the scan, so the float64 instantiation is
// bit-equal to the float64 numpy engine of the reference and the float32
// instantiation to its float32 engines.  Pruned edges carry E = +inf (and
// any st); the kernel needs no other mask and no BIG sentinel.
//
// Bound: bytes.  Per scenario the kernel must read the init grid
// (N*(G+1) values), E and st (L*N*N each) and write hist and arg
// (L*N*(G+1) each).  It does two operations per candidate (one add, one
// compare), 2*L*N*N*(G+1) in all.  At the solver's width (N = 5, G+1 = 26,
// L = 4) that is 8,480 bytes against 5,200 operations per scenario in
// float64, about 0.6 operations per byte, far below the card's balance
// point, so device memory bounds it.
//
// Design against that bound: each input and output byte crosses device
// memory once.  A block holds a few scenarios.  Their (N, G+1) grids live in
// shared memory, double-buffered across the L layers (the TPU kernel kept
// the grid in VMEM), and each layer's E and st are staged in shared memory
// before use.  One thread per target state (m, g); consecutive threads take
// consecutive depths, so the hist and arg stores of a layer are contiguous.
// The TPU's 8x128 node/depth padding is dropped.  Making it fast (several
// scenarios per warp, int8 parents, TMA staging) is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// Threads a block aims for; a block takes as many whole scenarios as fit.
constexpr int kThreadTarget = 512;
constexpr int kMaxThreads = 1024;
// Static shared memory a launch may use without opting in.
constexpr size_t kDefaultSmem = 48 * 1024;

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }

template <typename T>
__global__ void banded_chain_kernel(const T* __restrict__ init,
                                    const T* __restrict__ E,
                                    const int* __restrict__ st,
                                    T* __restrict__ hist,
                                    int* __restrict__ arg,
                                    int B, int L, int N, int Gp1, int lo,
                                    int spb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int states = N * Gp1;
  const int nn = N * N;
  T* cur = reinterpret_cast<T*>(smem_raw);            // [spb][N][Gp1]
  T* nxt = cur + spb * states;                        // [spb][N][Gp1]
  T* e_s = nxt + spb * states;                        // [spb][N][N]
  int* st_s = reinterpret_cast<int*>(e_s + spb * nn); // [spb][N][N]

  const long long b0 = static_cast<long long>(blockIdx.x) * spb;
  const long long left = B - b0;
  const int nb = left < spb ? static_cast<int>(left) : spb;
  const int work = nb * states;

  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    cur[t] = init[b0 * states + t];
  }
  for (int l = 0; l < L; ++l) {
    for (int t = threadIdx.x; t < nb * nn; t += blockDim.x) {
      const int s = t / nn;
      const long long src = ((b0 + s) * L + l) * nn + (t - s * nn);
      e_s[t] = E[src];
      st_s[t] = st[src];
    }
    __syncthreads();
    for (int t = threadIdx.x; t < work; t += blockDim.x) {
      const int s = t / states;
      const int r = t - s * states;
      const int m = r / Gp1;
      const int g = r - m * Gp1;
      const T* d = cur + s * states;
      const T* e = e_s + s * nn;
      const int* sv = st_s + s * nn;
      T best = pos_inf<T>();
      int a = -1;
      for (int n = 0; n < N; ++n) {
        const int k = sv[n * N + m];
        const int gs = g - k;
        if (gs >= 0 && (lo < 0 || g >= lo || k == 0)) {
          const T c = d[n * Gp1 + gs] + e[n * N + m];
          if (c < best) {
            best = c;
            a = n;
          }
        }
      }
      nxt[t] = best;
      const long long o = ((b0 + s) * L + l) * states + r;
      hist[o] = best;
      arg[o] = a;
    }
    __syncthreads();
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename T>
int launch_banded_chain(const void* init, const void* E, const void* st,
                        void* hist, void* arg, int B, int L, int N, int Gp1,
                        int lo, void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const int states = N * Gp1;
  int spb = kThreadTarget / states;
  if (spb < 1) spb = 1;
  if (spb > B) spb = B;
  int threads = ((spb * states + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = static_cast<size_t>(spb) *
      (2 * states * sizeof(T) + static_cast<size_t>(N) * N * (sizeof(T) + sizeof(int)));
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>((B + spb - 1) / spb);
  banded_chain_kernel<T><<<blocks, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(init), static_cast<const T*>(E),
      static_cast<const int*>(st), static_cast<T*>(hist),
      static_cast<int*>(arg), B, L, N, Gp1, lo, spb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, one per dtype, bound with ctypes.  Pointers are
// device pointers of contiguous tensors: init [B,N,Gp1], E [B,L,N,N],
// st [B,L,N,N] int32, hist [B,L,N,Gp1], arg [B,L,N,Gp1] int32.  lo < 0
// means no lambda window.  Returns the cudaError_t of the launch.
extern "C" int banded_chain_f64(const void* init, const void* E,
                                const void* st, void* hist, void* arg, int B,
                                int L, int N, int Gp1, int lo, void* stream) {
  return launch_banded_chain<double>(init, E, st, hist, arg, B, L, N, Gp1, lo,
                                     stream);
}

extern "C" int banded_chain_f32(const void* init, const void* E,
                                const void* st, void* hist, void* arg, int B,
                                int L, int N, int Gp1, int lo, void* stream) {
  return launch_banded_chain<float>(init, E, st, hist, arg, B, L, N, Gp1, lo,
                                    stream);
}
