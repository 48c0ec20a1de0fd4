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
// any st); the kernel needs no other mask and no BIG sentinel.  With
// init_row set, hist is [B, L+1, N, G+1] with the init grid as row 0 (the
// solver's history), written from shared memory in the same pass.
//
// Bound: bytes.  Per scenario the kernel must read the init grid
// (N*(G+1) values), E and st (L*N*N each) and write hist and arg
// (L*N*(G+1) each).  It does two operations per candidate (one add, one
// compare), 2*L*N*N*(G+1) in all.  At the solver's width (N = 5, G+1 = 26,
// L = 4) that is 8,480 bytes against 5,200 operations per scenario in
// float64, about 0.6 operations per byte, far below the card's balance
// point, so device memory bounds it, and the writes are 74% of the bytes.
//
// Design against that bound.  The first design (one thread a state, E and
// st staged a layer at a time, one device-memory round trip a layer) ran
// at a third of it.  Loading each group once through a ring alone did not
// help: with its loads served from L2 and no stores, such a kernel kept
// most of its time.  The relax itself (about a hundred instructions a
// state a layer, its shared-memory reads compiled to generic loads) set
// the pace.  So:
//
// - One load phase a group.  A block takes a group of consecutive
//   scenarios (the wrapper's `chain_plan`: 7 at the solver's widths),
//   whose init grids, E and st each form one contiguous run in device
//   memory.  All three runs are issued together as cp.async copies before
//   the first layer: 16-byte pieces, 4-byte words at a ragged head and
//   tail.  Each run lands in shared memory at its device address's phase
//   (address mod 16; every region has 16 bytes of room for it), so an f32
//   run that starts at an odd scenario still moves in 16-byte pieces.
//   After that the L layers read shared memory only.
// - Persistent blocks with a two-stage ring.  The grid is as many blocks
//   as the SMs hold at once; each walks groups blockIdx.x, + gridDim.x, ...
//   and group i+1's copies are in flight while group i relaxes.
// - Two depths a thread.  A thread owns one target node m and the depths
//   g0 and g0 + ceil((G+1) / 2) of it (kDepths), so each source's E and st
//   are read once for both, and a scenario takes N * 13 threads at G+1 =
//   26 (65; seven scenarios fill 15 warps).  A source's admissibility
//   folds into one threshold a depth is compared with, and an
//   inadmissible candidate reads a +inf slot instead of branching, so the
//   source loop (unrolled: the node count is a template parameter up to 8)
//   has no branch.  Every shared-memory access is a byte offset from the
//   block's one shared array, which keeps it an LDS / STS.
// - The carry stays in shared memory: two grids a scenario, the layer's
//   source and the one it writes; layer 0 reads the staged init.
// - Stores go straight from registers: consecutive threads hold
//   consecutive depths of a node, so a warp writes runs of 13 consecutive
//   values of hist and of arg.  Staging the group's whole hist / arg slab
//   in shared memory and copying it out as contiguous 16-byte pieces
//   measured slower: the copy-out is serial work of the block's threads.
// - With init_row set, the threads of layer 0 also write the init grid they
//   read from shared memory as hist row 0, so the solver needs no copy.
//
// Where a group of one scenario does not fit (large N * (G+1) and L), the
// block takes one scenario at a time through a per-layer ring: two (N, G+1)
// grids and two layers' E and st, the next layer's loaded by cp.async
// behind the relax.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
// Dynamic shared memory a launch may use without opting in, and the most a
// block may opt into on Hopper (227 KB).
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr long long kMaxSmem = 232448;
constexpr int kMaxNodes = 32;
// Depths a thread relaxes for one target node (the wrapper's
// CHAIN_DEPTHS): the node's E and st are loaded once for all of them.
constexpr int kDepths = 2;

template <typename T>
__device__ __forceinline__ T pos_inf();
template <>
__device__ __forceinline__ double pos_inf<double>() { return CUDART_INF; }
template <>
__device__ __forceinline__ float pos_inf<float>() { return CUDART_INF_F; }

// Bytes of a shared-memory region that holds a run of x bytes: x rounded up
// to 16, and 16 more, so that the run can start at the phase (address mod
// 16) of its device-memory counterpart.
__host__ __device__ __forceinline__ long long pad16(long long x) {
  return ((x + 15) & ~15LL) + 16;
}

// Shared memory of a block of spb scenarios: a +inf slot, then, whole, two
// input stages (a group's init grids, E and st) and two grids a scenario
// (the layer's source and the one it writes); else (spb = 1) the
// per-layer ring: two grids and two layers' E and st.  The wrapper's
// `chain_smem_bytes` computes the same.
__host__ __device__ __forceinline__ long long chain_smem_bytes(
    long long spb, long long L, long long N, long long Gp1, long long item,
    bool whole) {
  const long long states = N * Gp1, nn = N * N;
  if (whole)
    return 16 + 2 * (pad16(spb * states * item) + pad16(spb * L * nn * item) +
                     pad16(spb * L * nn * 4)) +
           2 * pad16(spb * states * item);
  return 16 + 2 * pad16(states * item) +
         2 * (pad16(nn * item) + pad16(nn * 4));
}

__device__ __forceinline__ int phase(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's committed copy groups are
// still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// The pieces of a run of n bytes (a multiple of 4) whose source and
// destination share their phase ps: nh head words up to a 16-byte
// boundary, nb 16-byte pieces, nt tail words.
struct Pieces {
  int head, nh, nb, nt;
  __device__ __forceinline__ Pieces(int ps, int n) {
    head = min((16 - ps) & 15, n);
    nh = head >> 2;
    nb = (n - head) >> 4;
    nt = (n - head - (nb << 4)) >> 2;
  }
  __device__ __forceinline__ int count() const { return nh + nb + nt; }
  // byte offset of piece i, and whether it is a 16-byte piece
  __device__ __forceinline__ int offset(int i, bool& wide) const {
    wide = i >= nh && i < nh + nb;
    if (i < nh) return i << 2;
    if (wide) return head + ((i - nh) << 4);
    return head + (nb << 4) + ((i - nh - nb) << 2);
  }
};

// Issue the asynchronous copy of n bytes from device memory to shared
// memory at the same phase (every caller places dst at src's address mod
// 16), the block's threads together.
__device__ __forceinline__ void load_run(void* dst, const void* src, int n) {
  unsigned char* d = static_cast<unsigned char*>(dst);
  const unsigned char* s = static_cast<const unsigned char*>(src);
  const Pieces p(phase(s), n);
  for (int i = threadIdx.x; i < p.count(); i += blockDim.x) {
    bool wide;
    const int o = p.offset(i, wide);
    if (wide)
      cp_async16(d + o, s + o);
    else
      cp_async4(d + o, s + o);
  }
}

// A thread's work item: node m of scenario s at depths g0 + j * Td for
// j < kDepths, Td = ceil((G+1) / kDepths) threads a node; r0 = m * (G+1) +
// g0, its first state.  Split once for a thread's first item.
struct Item {
  int s, m, g0, r0;
  __device__ __forceinline__ Item(int t, int tps, int Td, int Gp1) {
    s = t / tps;
    const int q = t - s * tps;
    m = q / Td;
    g0 = q - m * Td;
    r0 = m * Gp1 + g0;
  }
};

// One layer of one item, and its stores.  Offsets are bytes of the
// block's shared memory sm: d the scenario's source grid, e / sv the
// layer's E and st at [0][m] (row n at + n * N), o the grid the layer
// writes (the next layer's source; < 0: none).  hp / ap: the item's first
// state in the layer's hist and arg rows (hp - states: the init row, which
// row0 writes from the source grid).
//
// Each source's E and st are loaded once for all the item's depths, and
// its admissibility folds into one threshold: depth g takes source n iff
// g >= kk, kk = 0 for a flat edge (st == 0) and max(st, lo) otherwise (lo <
// 0: no window).  An inadmissible candidate reads the +inf slot at byte 0
// instead of branching: +inf + w is never below +inf, nor below a finite
// best.  The scan keeps the first n that attains the min.
template <typename T, int NH>
__device__ __forceinline__ void relax_item(unsigned char* sm, int d,
                                           int e, int sv, int o, bool row0,
                                           const Item& it, int Td, int N,
                                           int Gp1, int lo, int states,
                                           T* __restrict__ hp,
                                           int* __restrict__ ap) {
  constexpr int item = sizeof(T);
  int g[kDepths], gb[kDepths];  // g = -1 past the last depth
  T best[kDepths];
  int a[kDepths];
#pragma unroll
  for (int j = 0; j < kDepths; ++j) {
    g[j] = it.g0 + j * Td < Gp1 ? it.g0 + j * Td : -1;
    gb[j] = g[j] * item;
    best[j] = pos_inf<T>();
    a[j] = -1;
  }
  int row = d;  // source row n
#pragma unroll
  for (int n = 0; n < NH; ++n) {
    if (n < N) {
      const int k = *reinterpret_cast<const int*>(sm + sv + n * N * 4);
      const T w = *reinterpret_cast<const T*>(sm + e + n * N * item);
      const int kk = k == 0 ? 0 : max(k, lo);
      const int rk = row - k * item;
#pragma unroll
      for (int j = 0; j < kDepths; ++j) {
        const T c =
            *reinterpret_cast<const T*>(sm + (g[j] >= kk ? rk + gb[j] : 0)) +
            w;
        const bool lt = c < best[j];  // strict: a tie stays with the lower node
        best[j] = lt ? c : best[j];
        a[j] = lt ? n : a[j];
      }
      row += Gp1 * item;
    }
  }
#pragma unroll
  for (int j = 0; j < kDepths; ++j) {
    if (g[j] >= 0) {
      const int r = it.r0 + j * Td;
      if (row0)
        hp[j * Td - states] = *reinterpret_cast<const T*>(sm + d + r * item);
      if (o >= 0)
        *reinterpret_cast<T*>(sm + o + r * item) = best[j];
      hp[j * Td] = best[j];
      ap[j * Td] = a[j];
    }
  }
}

// Groups of spb scenarios in shared memory, through a two-stage input ring.
// Shared memory (bytes): the +inf slot [0, 16), then two stages of (init,
// E, st) runs, then two grids of spb scenarios.
template <typename T, int NH>
__device__ __forceinline__ void chain_whole(
    const T* __restrict__ init, const T* __restrict__ E,
    const int* __restrict__ st, T* __restrict__ hist, int* __restrict__ arg,
    int B, int L, int N, int Gp1, int lo, int init_row, int spb,
    unsigned char* smem) {
  constexpr int item = sizeof(T);
  const int states = N * Gp1;
  const int nn = N * N;
  const int R = L + init_row;  // hist rows a scenario
  const int Td = (Gp1 + kDepths - 1) / kDepths;
  const int tps = N * Td;  // threads a scenario
  const int in_b = static_cast<int>(pad16(1LL * spb * states * item));
  const int e_b = static_cast<int>(pad16(1LL * spb * L * nn * item));
  const int s_b = static_cast<int>(pad16(1LL * spb * L * nn * 4));
  const int stage_b = in_b + e_b + s_b;
  const int grid_b = 16 + 2 * stage_b;  // grid 0; grid 1 follows at in_b
  const long long groups = (B + spb - 1) / spb;
  const Item first(threadIdx.x, tps, Td, Gp1);
  if (threadIdx.x == 0) *reinterpret_cast<T*>(smem) = pos_inf<T>();

  // every input run of group gi into stage k
  auto issue = [&](long long gi, int k) {
    const long long b0 = gi * spb;
    const long long left = B - b0;
    const int nb = left < spb ? static_cast<int>(left) : spb;
    unsigned char* base = smem + 16 + k * stage_b;
    const T* si = init + b0 * states;
    const T* se = E + b0 * L * nn;
    const int* ss = st + b0 * L * nn;
    load_run(base + phase(si), si, nb * states * item);
    load_run(base + in_b + phase(se), se, nb * L * nn * item);
    load_run(base + in_b + e_b + phase(ss), ss, nb * L * nn * 4);
  };

  if (blockIdx.x < groups) issue(blockIdx.x, 0);
  cp_async_commit();
  int k = 0;
  for (long long gi = blockIdx.x; gi < groups; gi += gridDim.x, k ^= 1) {
    // the other stage was last read before the previous group's last
    // barrier
    if (gi + gridDim.x < groups) issue(gi + gridDim.x, k ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this group's copies (this thread's) have landed
    __syncthreads();     // and every thread's
    const long long b0 = gi * spb;
    const long long left = B - b0;
    const int nb = left < spb ? static_cast<int>(left) : spb;
    const int base = 16 + k * stage_b;
    const int in_s = base + phase(init + b0 * states);
    const int e_s = base + in_b + phase(E + b0 * L * nn);
    const int s_s = base + in_b + e_b + phase(st + b0 * L * nn);
    // the first item's rows, advanced a layer at a time
    const bool mine = first.s < nb;
    T* hp = hist + ((b0 + first.s) * R + init_row) * states + first.r0;
    int* ap = arg + (b0 + first.s) * L * states + first.r0;
    for (int l = 0; l < L; ++l) {
      const int src = l == 0 ? in_s : grid_b + ((l - 1) & 1) * in_b;
      const int dst = l + 1 < L ? grid_b + (l & 1) * in_b : -1;
      const int sl = (l * nn) * 4, el = (l * nn) * item;
      if (mine) {
        const Item& it = first;
        relax_item<T, NH>(smem, src + it.s * states * item,
                          e_s + (it.s * L * nn + it.m) * item + el,
                          s_s + (it.s * L * nn + it.m) * 4 + sl,
                          dst < 0 ? -1 : dst + it.s * states * item,
                          l == 0 && init_row, it, Td, N, Gp1, lo, states, hp,
                          ap);
      }
      hp += states;
      ap += states;
      for (int t = threadIdx.x + blockDim.x; t < nb * tps; t += blockDim.x) {
        const Item it(t, tps, Td, Gp1);
        relax_item<T, NH>(
            smem, src + it.s * states * item,
            e_s + (it.s * L * nn + it.m) * item + el,
            s_s + (it.s * L * nn + it.m) * 4 + sl,
            dst < 0 ? -1 : dst + it.s * states * item, l == 0 && init_row,
            it, Td, N, Gp1, lo, states,
            hist + ((b0 + it.s) * R + l + init_row) * states + it.r0,
            arg + ((b0 + it.s) * L + l) * states + it.r0);
      }
      __syncthreads();  // layer l written: the next layer's source
    }
  }
  cp_async_wait<0>();
}

// One scenario at a time through the per-layer ring, for chains whose
// group does not fit.  Shared memory (bytes): the +inf slot [0, 16), two
// grids, two layers' (E, st) runs.
template <typename T, int NH>
__device__ __forceinline__ void chain_layered(
    const T* __restrict__ init, const T* __restrict__ E,
    const int* __restrict__ st, T* __restrict__ hist, int* __restrict__ arg,
    int B, int L, int N, int Gp1, int lo, int init_row,
    unsigned char* smem) {
  constexpr int item = sizeof(T);
  const int states = N * Gp1;
  const int nn = N * N;
  const int R = L + init_row;
  const int Td = (Gp1 + kDepths - 1) / kDepths;
  const int tps = N * Td;
  const int g_b = static_cast<int>(pad16(1LL * states * item));
  const int es_b = static_cast<int>(pad16(1LL * nn * item));
  const int ss_b = static_cast<int>(pad16(1LL * nn * 4));
  const int eslot = 16 + 2 * g_b;  // [2][es_b + ss_b]
  if (threadIdx.x == 0) *reinterpret_cast<T*>(smem) = pos_inf<T>();

  auto issue_layer = [&](long long b, int l) {
    unsigned char* base = smem + eslot + (l & 1) * (es_b + ss_b);
    const T* se = E + (b * L + l) * nn;
    const int* ss = st + (b * L + l) * nn;
    load_run(base + phase(se), se, nn * item);
    load_run(base + es_b + phase(ss), ss, nn * 4);
  };

  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const T* si = init + b * states;
    load_run(smem + 16 + phase(si), si, states * item);
    issue_layer(b, 0);
    cp_async_commit();
    for (int l = 0; l < L; ++l) {
      const int j = l & 1;
      cp_async_wait<0>();
      __syncthreads();  // layer l's inputs have landed; layer l-1 is done
      if (l + 1 < L) issue_layer(b, l + 1);  // into the slot l-1 read
      cp_async_commit();
      // layer l reads grid j (the init, at its phase, for l = 0) and
      // writes grid j ^ 1, which layer l - 1 read before the barrier
      const int d = 16 + j * g_b + (l == 0 ? phase(si) : 0);
      const int o = l + 1 < L ? 16 + (j ^ 1) * g_b : -1;
      const int base = eslot + j * (es_b + ss_b);
      const int e_s = base + phase(E + (b * L + l) * nn);
      const int s_s = base + es_b + phase(st + (b * L + l) * nn);
      for (int t = threadIdx.x; t < tps; t += blockDim.x) {
        const Item it(t, tps, Td, Gp1);
        relax_item<T, NH>(smem, d, e_s + it.m * item, s_s + it.m * 4, o,
                          l == 0 && init_row, it, Td, N, Gp1, lo, states,
                          hist + (b * R + l + init_row) * states + it.r0,
                          arg + (b * L + l) * states + it.r0);
      }
    }
    __syncthreads();  // every read of this scenario's grids is done
  }
  cp_async_wait<0>();
}

template <typename T, int NH>
__global__ void __launch_bounds__(kMaxThreads)
    banded_chain_kernel(const T* __restrict__ init, const T* __restrict__ E,
                        const int* __restrict__ st, T* __restrict__ hist,
                        int* __restrict__ arg, int B, int L, int N_, int Gp1,
                        int lo, int init_row, int spb, int whole) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int N = NH <= 8 ? NH : N_;  // a compile-time node count up to 8
  if (whole)
    chain_whole<T, NH>(init, E, st, hist, arg, B, L, N, Gp1, lo, init_row,
                       spb, smem_raw);
  else
    chain_layered<T, NH>(init, E, st, hist, arg, B, L, N, Gp1, lo, init_row,
                         smem_raw);
}

template <typename T, int NH>
int launch_nh(const void* init, const void* E, const void* st, void* hist,
              void* arg, int B, int L, int N, int Gp1, int lo, int init_row,
              int spb, int threads, int blocks, int whole, size_t smem,
              cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        banded_chain_kernel<T, NH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  banded_chain_kernel<T, NH><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(init), static_cast<const T*>(E),
      static_cast<const int*>(st), static_cast<T*>(hist),
      static_cast<int*>(arg), B, L, N, Gp1, lo, init_row, spb, whole);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_banded_chain(const void* init, const void* E, const void* st,
                        void* hist, void* arg, int B, int L, int N, int Gp1,
                        int lo, int init_row, int spb, int threads,
                        int blocks, void* stream_ptr) {
  if (B <= 0 || L <= 0) return 0;
  const long long item = sizeof(T);
  const bool whole =
      chain_smem_bytes(spb, L, N, Gp1, item, true) <= kMaxSmem;
  const long long smem = chain_smem_bytes(spb, L, N, Gp1, item, whole);
  if (N < 1 || N > kMaxNodes || Gp1 < 1 || spb < 1 || (!whole && spb != 1) ||
      threads < 32 || threads > kMaxThreads || blocks < 1 || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream_ptr);
#define CHAIN_LAUNCH(NH)                                                    \
  return launch_nh<T, NH>(init, E, st, hist, arg, B, L, N, Gp1, lo,         \
                          init_row ? 1 : 0, spb, threads, blocks,           \
                          whole ? 1 : 0, static_cast<size_t>(smem), s)
  switch (N) {
    case 1: CHAIN_LAUNCH(1);
    case 2: CHAIN_LAUNCH(2);
    case 3: CHAIN_LAUNCH(3);
    case 4: CHAIN_LAUNCH(4);
    case 5: CHAIN_LAUNCH(5);
    case 6: CHAIN_LAUNCH(6);
    case 7: CHAIN_LAUNCH(7);
    case 8: CHAIN_LAUNCH(8);
    default:
      if (N <= 16) CHAIN_LAUNCH(16);
      CHAIN_LAUNCH(32);
  }
#undef CHAIN_LAUNCH
}

}  // namespace

// Plain C entry points, one per dtype, bound with ctypes.  Pointers are
// device pointers of contiguous tensors: init [B,N,Gp1], E [B,L,N,N],
// st [B,L,N,N] int32, hist [B,L,N,Gp1] ([B,L+1,N,Gp1] with the init grid
// as row 0 where init_row != 0), arg [B,L,N,Gp1] int32.  lo < 0 means no
// lambda window; spb scenarios a group, threads a block and blocks are the
// wrapper's `chain_plan`.  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for a plan the kernel does not take).
extern "C" int banded_chain_f64(const void* init, const void* E,
                                const void* st, void* hist, void* arg, int B,
                                int L, int N, int Gp1, int lo, int init_row,
                                int spb, int threads, int blocks,
                                void* stream) {
  return launch_banded_chain<double>(init, E, st, hist, arg, B, L, N, Gp1, lo,
                                     init_row, spb, threads, blocks, stream);
}

extern "C" int banded_chain_f32(const void* init, const void* E,
                                const void* st, void* hist, void* arg, int B,
                                int L, int N, int Gp1, int lo, int init_row,
                                int spb, int threads, int blocks,
                                void* stream) {
  return launch_banded_chain<float>(init, E, st, hist, arg, B, L, N, Gp1, lo,
                                    init_row, spb, threads, blocks, stream);
}
