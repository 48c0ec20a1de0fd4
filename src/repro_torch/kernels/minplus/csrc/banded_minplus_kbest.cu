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
// plus mask).
//
// The merge.  A source's slots d[n, gs, 0..K-1] are ascending with a +inf
// tail (layer 0: one value, then +inf; later layers: this kernel's own
// output), and IEEE addition of one w is monotone, so the run
// d[n, gs, :] + w is ascending too.  A stable sort of the node-major,
// slot-minor pool is then the N-way merge of these runs with ties to the
// lower n (inside one run the lower k comes first anyway).  Each thread
// owns one target state and keeps one head per admissible source in
// registers (the head's candidate, and its depth and slot packed in one
// int).  At each of the K output steps it takes the head with the
// smallest candidate under a strict < in ascending n, writes (value, n,
// slot) and advances that head by one slot; at the first +inf every head
// is spent and the rest of the row is (+inf, -1, -1).  That is O(K * N)
// compares and one shared-memory load a step, with no shifts and no
// divide; the parents come straight from the merge.  Every candidate is
// one IEEE add (-fmad=false), so the float64 instantiation is bit-equal to
// the numpy engine and the float32 one to float32 adds in the same order.
// The node count is a template parameter up to 8 (the solver's N = 5), so
// the heads stay in registers; 16 and 32 take the wider node counts.
//
// Bound: bytes.  Per scenario the kernel must read the init grid (N*(G+1)
// values), E and st (L*N*N each) and write hist, par_n and par_k
// (L*N*(G+1)*K each).  It does one add and one compare per candidate with a
// finite source slot.  At the solver's width (N = 5, G+1 = 26, L = 4,
// K = 4) that is about 35 KB against at most 21 K operations per scenario
// in float64, below one operation per byte, so device memory bounds it,
// and the writes are 94% of the bytes.
//
// Layout against that bound.  A block holds whole scenarios (the count is
// the wrapper's `kbest_plan`: one scenario a block at the solver's
// widths); one thread owns one target state.  Shared memory holds, per
// scenario, two k-slot grids, K-innermost (the layout of one scenario's
// layer in hist) with an odd row stride K | 1: the source grid the layer
// reads, and the grid it writes, which is both the output staged for the
// copy-out and the next layer's source grid (it is never read back from
// device memory).  The odd stride puts neighbouring threads' rows on
// distinct banks, so the merge's loads and stores meet no bank conflict
// when the threads' heads agree.  Beside them: the staged parents packed
// in 16 bits (n | k << 5, the same row stride) and two layers' E and st;
// 2 * 8 + 2 bytes a grid entry in float64.  Layer l+1's E and st are
// loaded into registers before layer l's merge and stored after it, so
// their device-memory latency hides behind the merge.  After each layer
// the block copies the staged rows out with consecutive threads on
// consecutive 16-byte pieces of hist / par_n / par_k where K is a
// multiple of 4, one slot a thread otherwise, so every warp store is
// contiguous whatever K is; stores do not stall the threads, so they
// drain while the block's warps merge the next layer.  A layer costs two
// barriers: before the merge (E / st staged, the last copy-out done with
// the parents) and before the copy-out.  Storing each thread's row
// straight from registers instead writes 16-byte pieces K * 8 bytes apart
// (256 at K = 32, several times slower there); a bulk asynchronous copy
// needs a contiguous image of the output, which the odd stride is not.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
// Dynamic shared memory a launch may use without opting in, and the most a
// block may opt into on Hopper (227 KB).
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;
// a head packs its source depth above 10 bits of slot (G+1 <= 256), and a
// staged parent its slot above 5 bits of node (N <= 32): K <= 1024
constexpr int kMaxK = 1024;
constexpr int kMaxNodes = 32;

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }

// Shared-memory geometry of one scenario, in elements: the row stride of
// the grids and parents, and per-scenario strides rounded so that every
// region and every scenario's part of it starts on 16 bytes.
struct Geometry {
  int rs, gs, ps, ns;
  __host__ __device__ Geometry(int N, int Gp1, int K)
      : rs(K | 1),
        gs((N * Gp1 * (K | 1) + 3) & ~3),
        ps((N * Gp1 * (K | 1) + 7) & ~7),
        ns((N * N + 3) & ~3) {}
};

// Shared memory of one scenario: two k-slot grids, the staged parents and
// two layers' E and st.  The wrapper's `kbest_smem_bytes` computes the
// same.
template <typename T>
size_t smem_per_scenario(int N, int Gp1, int K) {
  const Geometry geo(N, Gp1, K);
  return 2 * static_cast<size_t>(geo.gs) * sizeof(T) +
         static_cast<size_t>(geo.ps) * sizeof(int16_t) +
         2 * static_cast<size_t>(geo.ns) * (sizeof(T) + sizeof(int));
}

// One target state's K-slot row: the merge of its admissible sources' runs.
// d: the scenario's source grid (row n * Gp1 + g at d[row * rs]); e / sv:
// the layer's E and st [N][N]; v / p: the state's staged values and packed
// parents.
template <typename T, int NH>
__device__ __forceinline__ void merge_row(const T* __restrict__ d,
                                          const T* __restrict__ e,
                                          const int* __restrict__ sv,
                                          T* __restrict__ v,
                                          int16_t* __restrict__ p, int N,
                                          int Gp1, int K, int rs, int lo,
                                          int m, int g) {
  T c[NH];     // the head's candidate, +inf once the run is spent
  int hd[NH];  // the head's source depth << 10 | its slot
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    c[n] = pos_inf<T>();
    hd[n] = 0;
    if (n < N) {
      const int kk = sv[n * N + m];
      const int gs = g - kk;
      if (gs >= 0 && (lo < 0 || g >= lo || kk == 0)) {
        hd[n] = gs << 10;
        c[n] = d[(n * Gp1 + gs) * rs] + e[n * N + m];
      }
    }
  }
  for (int j = 0; j < K; ++j) {
    T best = c[0];
    int bn = 0;
#pragma unroll
    for (int n = 1; n < NH; ++n) {
      if (c[n] < best) {  // strict: a tie stays with the lower node
        best = c[n];
        bn = n;
      }
    }
    if (!(best < pos_inf<T>())) {  // every head spent: the rest is unused
      for (; j < K; ++j) {
        v[j] = pos_inf<T>();
        p[j] = -1;
      }
      return;
    }
    int h = hd[0];
#pragma unroll
    for (int n = 1; n < NH; ++n) h = n == bn ? hd[n] : h;
    const int k = h & (kMaxK - 1);
    v[j] = best;
    p[j] = static_cast<int16_t>(bn | (k << 5));
    if (j + 1 < K) {  // advance the head (not after the last slot)
      const T next =
          k + 1 < K ? d[(bn * Gp1 + (h >> 10)) * rs + k + 1] + e[bn * N + m]
                    : pos_inf<T>();
#pragma unroll
      for (int n = 0; n < NH; ++n) {
        if (n == bn) {
          c[n] = next;
          hd[n] = h + 1;
        }
      }
    }
  }
}

__device__ __forceinline__ int par_node(int p) { return p < 0 ? -1 : p & 31; }
__device__ __forceinline__ int par_slot(int p) { return p >> 5; }  // -1 -> -1

__device__ __forceinline__ void store4(double* dst, const double* v) {
  reinterpret_cast<double2*>(dst)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(dst)[1] = make_double2(v[2], v[3]);
}
__device__ __forceinline__ void store4(float* dst, const float* v) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// One layer's E and st of the block's scenarios into shared memory.
template <typename T>
__device__ __forceinline__ void stage_layer(const T* __restrict__ E,
                                            const int* __restrict__ st,
                                            T* e_s, int* st_s, long long b0,
                                            int nb, int L, int l, int nn,
                                            int ns) {
  for (int t = threadIdx.x; t < nb * nn; t += blockDim.x) {
    const int s = t / nn;
    const int i = t - s * nn;
    const long long src = ((b0 + s) * L + l) * nn + i;
    e_s[s * ns + i] = E[src];
    st_s[s * ns + i] = st[src];
  }
}

template <typename T, int NH>
__global__ void __launch_bounds__(kMaxThreads)
    banded_chain_kbest_kernel(const T* __restrict__ init,
                              const T* __restrict__ E,
                              const int* __restrict__ st,
                              T* __restrict__ hist, int* __restrict__ par_n,
                              int* __restrict__ par_k, int B, int L, int N,
                              int Gp1, int K, int lo, int spb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int states = N * Gp1;
  const int slots = states * K;
  const int nn = N * N;
  const Geometry geo(N, Gp1, K);
  const int rs = geo.rs;
  T* cur = reinterpret_cast<T*>(smem_raw);                // [spb][gs]
  T* nxt = cur + spb * geo.gs;                            // [spb][gs]
  T* e_s = nxt + spb * geo.gs;                          // [2][spb][ns]
  int* st_s = reinterpret_cast<int*>(e_s + 2 * spb * geo.ns);  // [2][spb][ns]
  int16_t* par = reinterpret_cast<int16_t*>(st_s + 2 * spb * geo.ns);
                                                           // [spb][ps]

  const long long b0 = static_cast<long long>(blockIdx.x) * spb;
  const long long left = B - b0;
  const int nb = left < spb ? static_cast<int>(left) : spb;
  const int work = nb * states;
  // the copy-out: a thread takes w consecutive slots of a row, kq a row
  const int w = (K & 3) == 0 ? 4 : 1;
  const int kq = K / w;
  const int pieces = states * kq;
  // the thread's first merge item and copy-out piece, split once: at the
  // solver's widths no thread has a second
  const int ms0 = threadIdx.x / states;
  const int mr0 = threadIdx.x - ms0 * states;
  const int mm0 = mr0 / Gp1;
  const int cs0 = threadIdx.x / pieces;
  const int cq0 = threadIdx.x - cs0 * pieces;
  const int cr0 = cq0 / kq;

  for (int t = threadIdx.x; t < work; t += blockDim.x) {
    const int s = t / states;
    const int r = t - s * states;
    T* row = cur + s * geo.gs + r * rs;
    row[0] = init[(b0 + s) * states + r];
    for (int k = 1; k < K; ++k) row[k] = pos_inf<T>();
  }
  stage_layer(E, st, e_s, st_s, b0, nb, L, 0, nn, geo.ns);
  // Layer l+1's E / st are loaded into registers before layer l's merge
  // and stored into the other buffer after it, so their device-memory
  // latency hides behind the merge (a block whose E / st outnumber its
  // threads stages them after the merge instead).
  const bool prefetch = nb * nn <= static_cast<int>(blockDim.x);
  const int ps_ = threadIdx.x / nn;
  const int pi_ = threadIdx.x - ps_ * nn;
  for (int l = 0; l < L; ++l) {
    const int buf = l & 1;
    __syncthreads();  // E / st of layer l staged; the last copy-out is done
    T e_next = T(0);
    int st_next = 0;
    const bool mine = prefetch && l + 1 < L && ps_ < nb;
    if (mine) {
      const long long src = ((b0 + ps_) * L + l + 1) * nn + pi_;
      e_next = E[src];
      st_next = st[src];
    }
    const T* el = e_s + buf * spb * geo.ns;
    const int* sl = st_s + buf * spb * geo.ns;
    for (int t = threadIdx.x; t < work; t += blockDim.x) {
      int s = ms0, r = mr0, m = mm0;
      if (t != static_cast<int>(threadIdx.x)) {
        s = t / states;
        r = t - s * states;
        m = r / Gp1;
      }
      merge_row<T, NH>(cur + s * geo.gs, el + s * geo.ns, sl + s * geo.ns,
                       nxt + s * geo.gs + r * rs, par + s * geo.ps + r * rs,
                       N, Gp1, K, rs, lo, m, r - m * Gp1);
    }
    // the other buffer was last read by merge l-1, before the last barrier
    T* e_o = e_s + (buf ^ 1) * spb * geo.ns;
    int* st_o = st_s + (buf ^ 1) * spb * geo.ns;
    if (mine) {
      e_o[ps_ * geo.ns + pi_] = e_next;
      st_o[ps_ * geo.ns + pi_] = st_next;
    } else if (!prefetch && l + 1 < L) {
      stage_layer(E, st, e_o, st_o, b0, nb, L, l + 1, nn, geo.ns);
    }
    __syncthreads();  // the layer is merged: copy it out
    for (int t = threadIdx.x; t < nb * pieces; t += blockDim.x) {
      int s = cs0, q = cq0, r = cr0;
      if (t != static_cast<int>(threadIdx.x)) {
        s = t / pieces;
        q = t - s * pieces;
        r = q / kq;
      }
      const int k = (q - r * kq) * w;
      const T* src = nxt + s * geo.gs + r * rs + k;
      const int16_t* ps = par + s * geo.ps + r * rs + k;
      const long long o = ((b0 + s) * L + l) * slots + r * K + k;
      if (w == 4) {
        T v[4];
        int pn[4], pk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = src[i];
          pn[i] = par_node(ps[i]);
          pk[i] = par_slot(ps[i]);
        }
        store4(hist + o, v);
        *reinterpret_cast<int4*>(par_n + o) =
            make_int4(pn[0], pn[1], pn[2], pn[3]);
        *reinterpret_cast<int4*>(par_k + o) =
            make_int4(pk[0], pk[1], pk[2], pk[3]);
      } else {
        hist[o] = src[0];
        par_n[o] = par_node(ps[0]);
        par_k[o] = par_slot(ps[0]);
      }
    }
    // the staged output is the next layer's source grid, not copied again;
    // the next layer's first barrier orders this copy-out before its merge
    // overwrites par and the old source grid
    T* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

template <typename T, int NH>
int launch_nh(const void* init, const void* E, const void* st, void* hist,
              void* par_n, void* par_k, int B, int L, int N, int Gp1, int K,
              int lo, int spb, int threads, size_t smem, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_chain_kbest_kernel<T, NH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const unsigned int blocks = static_cast<unsigned int>((B + spb - 1) / spb);
  banded_chain_kbest_kernel<T, NH><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(init), static_cast<const T*>(E),
      static_cast<const int*>(st), static_cast<T*>(hist),
      static_cast<int*>(par_n), static_cast<int*>(par_k), B, L, N, Gp1, K, lo,
      spb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_banded_chain_kbest(const void* init, const void* E, const void* st,
                              void* hist, void* par_n, void* par_k, int B,
                              int L, int N, int Gp1, int K, int lo, int spb,
                              int threads, void* stream_ptr) {
  if (B <= 0 || L <= 0) return 0;
  const size_t smem = spb * smem_per_scenario<T>(N, Gp1, K);
  if (K < 1 || K > kMaxK || N < 1 || N > kMaxNodes || spb < 1 ||
      threads < 1 || threads > kMaxThreads || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define KBEST_LAUNCH(NH)                                                     \
  return launch_nh<T, NH>(init, E, st, hist, par_n, par_k, B, L, N, Gp1, K, \
                          lo, spb, threads, smem, s)
  switch (N) {
    case 1: KBEST_LAUNCH(1);
    case 2: KBEST_LAUNCH(2);
    case 3: KBEST_LAUNCH(3);
    case 4: KBEST_LAUNCH(4);
    case 5: KBEST_LAUNCH(5);
    case 6: KBEST_LAUNCH(6);
    case 7: KBEST_LAUNCH(7);
    case 8: KBEST_LAUNCH(8);
    default:
      if (N <= 16) KBEST_LAUNCH(16);
      KBEST_LAUNCH(32);
  }
#undef KBEST_LAUNCH
}

}  // namespace

// Plain C entry points, one per dtype, bound with ctypes.  Pointers are
// device pointers of contiguous tensors: init [B,N,Gp1], E [B,L,N,N],
// st [B,L,N,N] int32, hist [B,L,N,Gp1,K], par_n and par_k [B,L,N,Gp1,K]
// int32.  lo < 0 means no lambda window; spb scenarios a block and threads
// a block are the wrapper's `kbest_plan`.  Returns the cudaError_t of the
// launch (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int banded_chain_kbest_f64(const void* init, const void* E,
                                      const void* st, void* hist, void* par_n,
                                      void* par_k, int B, int L, int N,
                                      int Gp1, int K, int lo, int spb,
                                      int threads, void* stream) {
  return launch_banded_chain_kbest<double>(init, E, st, hist, par_n, par_k, B,
                                           L, N, Gp1, K, lo, spb, threads,
                                           stream);
}

extern "C" int banded_chain_kbest_f32(const void* init, const void* E,
                                      const void* st, void* hist, void* par_n,
                                      void* par_k, int B, int L, int N,
                                      int Gp1, int K, int lo, int spb,
                                      int threads, void* stream) {
  return launch_banded_chain_kbest<float>(init, E, st, hist, par_n, par_k, B,
                                          L, N, Gp1, K, lo, spb, threads,
                                          stream);
}
