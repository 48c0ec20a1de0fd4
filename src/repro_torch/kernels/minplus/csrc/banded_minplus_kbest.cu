// Chained depth-banded k-slot (min,+) relaxation: the K cheapest paths per
// state, with (source node, source slot) parents.
//
// Replaces the TPU kernel `banded_minplus_chain_kbest_pallas`
// (src/repro/kernels/minplus/minplus.py:263, body
// `_banded_chain_kbest_kernel` :213-259).
//
// What it computes, for each scenario b and layer l = 0..L-1, with d the
// (N, G+1, K) k-slot grid after layer l-1 (for l = 0: the init grid in slot
// 0 and +inf in slots 1..K-1):
//
//   the pool of target state (m, g) is every candidate
//     d[n, g - st[b,l,n,m], k] + E[b,l,n,m]
//   over the admissible source nodes n (g - st >= 0, and the lambda window
//   lo < 0, g >= lo or st == 0) and slots k, in source-node-major,
//   slot-minor order; hist[b,l,m,g,:] holds its K smallest finite values in
//   the order of a stable ascending sort of the pool, par_n / par_k the
//   node and slot each came from, and (+inf, -1, -1) in unused slots.
//
// That is the contract of the reference's float64 numpy engine
// (`bellman_ford.batched_banded_relax_kbest`: stable argsort of the pool,
// keep the first K) and of the TPU kernel (iterated first-occurrence argmin
// plus mask).  Each thread owns one target state and builds its K-slot row
// by insertion: it scans n ascending, then k ascending, and places each
// candidate after every entry <= it; a candidate enters only if it is
// strictly below slot K-1.  Insertion in pool order behind equal entries is
// a stable sort, so ties come out in the reference's order, and an infinite
// candidate never enters.  A source's slots are ascending and E is the same
// for all of them, so the scan of source n stops at the first slot whose
// candidate does not enter (the reference's Python oracle prunes the same
// way).  Every candidate is one IEEE add (-fmad=false), so the float64
// instantiation is bit-equal to the numpy engine and the float32 one to
// float32 adds in the same order.
//
// Bound: bytes.  Per scenario the kernel must read the init grid (N*(G+1)
// values), E and st (L*N*N each) and write hist, par_n and par_k
// (L*N*(G+1)*K each).  It does one add and one compare per candidate with a
// finite source slot, at most 2*L*N*N*(G+1)*K, and the insertion moves.  At
// the solver's width (N = 5, G+1 = 26, L = 4, K = 4) that is about 35 KB
// against at most 21 K operations per scenario in float64, below one
// operation per byte, so device memory bounds it.
//
// Design against that bound: B1's layout.  A block holds whole scenarios;
// their k-slot grids live in shared memory, double-buffered across the L
// layers, slot-major ([K][N][G+1]) so that neighbouring threads (neighbouring
// depths) touch neighbouring words; each layer's E and st are staged in
// shared memory.  The pool index of each slot's parent sits beside the
// grid.  After each layer the block writes hist / par_n / par_k once, K
// innermost, with consecutive threads on consecutive addresses.  No BIG
// sentinel and no 8/128 padding.  Making it fast is later work.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

// Threads a block aims for; a block takes as many whole scenarios as fit.
constexpr int kThreadTarget = 512;
constexpr int kMaxThreads = 1024;
// Static shared memory a launch may use without opting in, and the most a
// block may opt into on Hopper (227 KB).
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }

// Shared memory of one scenario: two k-slot grids, the parents' pool
// indices, and one layer's E and st.
template <typename T>
size_t smem_per_scenario(int N, int Gp1, int K) {
  const size_t slots = static_cast<size_t>(N) * Gp1 * K;
  const size_t nn = static_cast<size_t>(N) * N;
  return slots * (2 * sizeof(T) + sizeof(int)) + nn * (sizeof(T) + sizeof(int));
}

template <typename T>
__global__ void banded_chain_kbest_kernel(const T* __restrict__ init,
                                          const T* __restrict__ E,
                                          const int* __restrict__ st,
                                          T* __restrict__ hist,
                                          int* __restrict__ par_n,
                                          int* __restrict__ par_k,
                                          int B, int L, int N, int Gp1, int K,
                                          int lo, int spb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int states = N * Gp1;
  const int slots = states * K;
  const int nn = N * N;
  T* cur = reinterpret_cast<T*>(smem_raw);              // [spb][K][N][Gp1]
  T* nxt = cur + spb * slots;                           // [spb][K][N][Gp1]
  T* e_s = nxt + spb * slots;                           // [spb][N][N]
  int* src_s = reinterpret_cast<int*>(e_s + spb * nn);  // [spb][K][N][Gp1]
  int* st_s = src_s + spb * slots;                      // [spb][N][N]

  const long long b0 = static_cast<long long>(blockIdx.x) * spb;
  const long long left = B - b0;
  const int nb = left < spb ? static_cast<int>(left) : spb;
  const int work = nb * states;

  for (int t = threadIdx.x; t < nb * slots; t += blockDim.x) {
    const int s = t / slots;
    const int r = t - s * slots;                        // k * states + state
    cur[t] = r < states ? init[(b0 + s) * states + r] : pos_inf<T>();
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
      const T* d = cur + s * slots;
      const T* e = e_s + s * nn;
      const int* sv = st_s + s * nn;
      T* v = nxt + s * slots + r;                       // slot j: v[j * states]
      int* p = src_s + s * slots + r;
      for (int j = 0; j < K; ++j) {
        v[j * states] = pos_inf<T>();
        p[j * states] = -1;
      }
      T worst = pos_inf<T>();                           // slot K-1
      for (int n = 0; n < N; ++n) {
        const int kk = sv[n * N + m];
        const int gs = g - kk;
        if (gs < 0 || !(lo < 0 || g >= lo || kk == 0)) continue;
        const T w = e[n * N + m];
        const T* col = d + n * Gp1 + gs;                // slot k: col[k * states]
        for (int k = 0; k < K; ++k) {
          const T c = col[k * states] + w;
          if (!(c < worst)) break;    // this and every later slot stay out
          int j = K - 1;
          while (j > 0) {
            const T prev = v[(j - 1) * states];
            if (!(prev > c)) break;   // behind every entry <= c: stable
            v[j * states] = prev;
            p[j * states] = p[(j - 1) * states];
            --j;
          }
          v[j * states] = c;
          p[j * states] = n * K + k;
          worst = v[(K - 1) * states];
        }
      }
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nb * slots; t += blockDim.x) {
      const int s = t / slots;
      const int r = t - s * slots;                      // state * K + k
      const int state = r / K;
      const int k = r - state * K;
      const int i = s * slots + k * states + state;
      const long long o = ((b0 + s) * L + l) * slots + r;
      const int src = src_s[i];
      hist[o] = nxt[i];
      par_n[o] = src < 0 ? -1 : src / K;
      par_k[o] = src < 0 ? -1 : src - (src / K) * K;
    }
    // the next layer's staging sync orders these reads of nxt / src_s
    // before its writes
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename T>
int launch_banded_chain_kbest(const void* init, const void* E, const void* st,
                              void* hist, void* par_n, void* par_k, int B,
                              int L, int N, int Gp1, int K, int lo,
                              void* stream) {
  if (B <= 0 || L <= 0) return 0;
  const size_t per = smem_per_scenario<T>(N, Gp1, K);
  if (K < 1 || per > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int states = N * Gp1;
  int spb = kThreadTarget / states;
  if (spb < 1) spb = 1;
  const int fit = static_cast<int>(kMaxSmem / per);
  if (spb > fit) spb = fit;
  if (spb > B) spb = B;
  int threads = ((spb * states + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t smem = spb * per;
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_chain_kbest_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>((B + spb - 1) / spb);
  banded_chain_kbest_kernel<T><<<blocks, threads, smem,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(init), static_cast<const T*>(E),
      static_cast<const int*>(st), static_cast<T*>(hist),
      static_cast<int*>(par_n), static_cast<int*>(par_k), B, L, N, Gp1, K, lo,
      spb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, one per dtype, bound with ctypes.  Pointers are
// device pointers of contiguous tensors: init [B,N,Gp1], E [B,L,N,N],
// st [B,L,N,N] int32, hist [B,L,N,Gp1,K], par_n and par_k [B,L,N,Gp1,K]
// int32.  lo < 0 means no lambda window.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue when one scenario's grids do not fit in a
// block's shared memory).
extern "C" int banded_chain_kbest_f64(const void* init, const void* E,
                                      const void* st, void* hist, void* par_n,
                                      void* par_k, int B, int L, int N,
                                      int Gp1, int K, int lo, void* stream) {
  return launch_banded_chain_kbest<double>(init, E, st, hist, par_n, par_k, B,
                                           L, N, Gp1, K, lo, stream);
}

extern "C" int banded_chain_kbest_f32(const void* init, const void* E,
                                      const void* st, void* hist, void* par_n,
                                      void* par_k, int B, int L, int N,
                                      int Gp1, int K, int lo, void* stream) {
  return launch_banded_chain_kbest<float>(init, E, st, hist, par_n, par_k, B,
                                          L, N, Gp1, K, lo, stream);
}
