// The experts' SwiGLU of the MoE FFN's gather dispatch, in two launches.
//
// Replaces no TPU kernel: it computes the stage of the reference's
// `_moe_gather` (src/repro/models/moe.py:63-100) between its routing and
// its scatter-add, which the reference leaves to XLA as three einsums:
//
//   xe = xg[g, top_idx] * valid                       [G, E, Ck, d]
//   h  = dtype( silu(f32(xe @ w_gate[e])) * f32(xe @ w_up[e]) )
//   ye = f32(h @ w_down[e]) * (top_w * valid)         [G, E, Ck, d] float32
//
// with the weights in the parameters' own layout, w_gate / w_up [E, d, ff]
// and w_down [E, ff, d], row-major.  The slots of an expert are its rows
// r = g * Ck + c (M = G * Ck of them); h lives in a scratch [E, M, ff] in
// the model's dtype between the two launches:
//
//   moe_up    gathers each slot's row of xg by top_idx itself (a dead slot
//             counts as a zero row, or in the tiles regime as its group's
//             first row, its result discarded), runs the gate and up
//             products on that one row tile with two float32 accumulators,
//             and rounds silu(gate) * up (float32, silu = x / (1 + expf(-x)))
//             to the model dtype;
//   moe_down  runs h @ w_down with a float32 accumulator; its epilogue
//             multiplies a live slot's row by top_w and writes an exact zero
//             for a dead one.
//
// Dead work is skipped on the device, without a host sync: a block (an
// item, in the tiles regime) first reads the valid flags of its rows; one
// with none reads no weight byte (moe_up leaves its rows of h unwritten,
// moe_down writes zeros).  A dead row inside a live tile reads no input
// either (zero-filled; the tiles regime gives it its group's first token
// row instead, see below), and comes out an exact zero in ye whatever its
// h row holds.  No atomics and no split of K across blocks: every output
// element is summed by one thread (one warpgroup's wgmma chain) in a
// fixed order, so two runs give the same bits.
//
// What bounds it, and the design against it, by regime (the wrapper, ops.py,
// picks the regime from the rows an expert and the dtype):
//
// * stream (bf16, M <= 16: the decode step, 4 groups of one token): the
//   bytes of the live experts' weights (604 MB an expert at mixtral's
//   widths).  The weight's columns go on the M side of mma.sync m16n8k16 and
//   the <= 16 slots on N (A and B swapped: out^T = W^T x^T, W^T's fragments
//   by ldmatrix.trans from the stored [k][n] tile).  A block owns 64 output
//   columns of one expert over all of K (128-byte runs of each weight row),
//   streamed through a ring of cp.async stages (up 6 of 18 KB, down 8 of
//   10 KB); its 8 warps split the columns in 16s and K in 2 interleaved
//   parts, summed through shared memory in a fixed order at the end.
//   ff = 16,384 and d = 6,144 give 2,048 and 768 blocks without splitting
//   K across blocks.  (32-column down blocks, 64-byte runs of a row, read
//   their weights at a lower rate on the card.)
// * tiles (bf16, M > 16: prefill): operations, on the tensor cores.  Two
//   persistent launches of one block an SM, warp-specialised: a producer
//   warpgroup (setmaxnreg 56) and two consumer warpgroups (224), each
//   consumer 64 rows of a 128-row slot tile with a 64 x 256 float32
//   accumulator on wgmma m64n256k16.  An item is (expert, slot tile,
//   column block): up 128 rows x (128 gate + 128 up columns of the same ff
//   columns, adjacent in shared memory, so one n256 product runs both),
//   down 128 rows x 256 d columns.  Its 64-deep k-tiles stream through a
//   4-stage ring (16 KB of slot rows + 32 KB of weights) on full / empty
//   mbarriers.  The weights keep their stored [E, K, N] layout: TMA loads
//   64 x 64 boxes in the 128-byte swizzle and wgmma reads them through its
//   transpose (MN-major) bit; K and N tails are zero-filled by TMA.  down
//   reads h's slot tile by TMA too ([E, M, ff], rows past M zero-filled).
//   up reads its slot rows from xe [E, M, d], which its own blocks first
//   gather from xg by top_idx (a live slot's row; a dead slot of a live
//   tile its group's first token row, whose products moe_down discards
//   for the slot's exact zero; the rows of dead tiles untouched) into ye's
//   memory, free until moe_down overwrites every element of it (xe in
//   bf16 takes half of ye's float32 bytes), before a barrier of every
//   block: so no third launch and no other scratch.  The pass moves 2 x
//   113 MB at mixtral's prefill (~0.07 ms of bytes).  On the card, which
//   runs these products at its power limit, the two ways of gathering in
//   the producer were slower than this: cp.async 16-byte chunks straight
//   into the swizzled layout (a request each), and one 128-byte TMA box a
//   slot row (bound by the TMA issue rate).  Each block first builds,
//   from the valid flags, the table of live (expert, slot tile) pairs; the
//   walk visits the live items expert by expert, column block by column
//   block, the slot tile fastest (the blocks sharing a weight tile run
//   together and share it in L2), strided over the blocks, so dead tiles
//   cost no block a turn; moe_down then visits the dead items, writing
//   their zeros.  Two item buffers of the rows' offsets and weights on
//   mbarriers of their own let the producer load the next item during an
//   epilogue.
// * simt (float32, any M): the float32 paths are parity checks, so one
//   plain tiled design on the CUDA cores (TF32 stays off): 64 x 64 tiles
//   (x2 for up), a 4 x 4 register tile a thread, k-tiles of 16 double
//   buffered through registers.
//
// Both launches run on the caller's stream; the C entry points return the
// first launch error (0 when both launched).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWgThreads = 384;   // tiles: a producer, two consumers
constexpr int kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;   // a block's opt-in shared memory

// regimes (ops.py's REGIMES)
constexpr int kStream = 0;
constexpr int kTiles = 1;
constexpr int kSimt = 2;

// stream: at most 16 slots an expert, k-tiles of 64
constexpr int kStreamMaxRows = 16;
constexpr int kSK = 64;
// tiles: 128 rows x 256 columns (up: 128 gate + 128 up) x 64 deep, 4 stages
constexpr int kBM = 128;
constexpr int kBN = 256;
constexpr int kBK = 64;
constexpr int kTileStages = 4;
// simt: 64 rows x 64 columns (a matrix) x 16 deep
constexpr int kFM = 64;
constexpr int kFN = 64;
constexpr int kFK = 16;

struct Problem {
  const void* xg;            // [G, t, d]
  const int64_t* top_idx;    // [G, E, Ck]
  const uint8_t* valid;      // [G, E, Ck] bool
  const float* top_w;        // [G, E, Ck]
  const void* w_gate;        // [E, d, ff]
  const void* w_up;          // [E, d, ff]
  const void* w_down;        // [E, ff, d]
  void* h;                   // [E, M, ff] scratch
  float* ye;                 // [G, E, Ck, d]
  int G, t, d, E, Ck, ff, M;
};

// The slot (g, e, c) of an expert's row r, as an index of [G, E, Ck].
__device__ __forceinline__ int64_t slot_of(const Problem& p, int e, int r) {
  const int g = r / p.Ck;
  const int c = r - g * p.Ck;
  return (static_cast<int64_t>(g) * p.E + e) * p.Ck + c;
}

// The element offset of row r's input: xg's gathered row (up) or h's row
// (down); -1 for a dead slot or a row past M.  (The tiles regime reads
// its rows by TMA; for it this is the row's liveness and gather source.)
template <bool UP>
__device__ __forceinline__ int64_t row_source(const Problem& p, int e,
                                              int r) {
  if (r >= p.M) return -1;
  const int64_t s = slot_of(p, e, r);
  if (!p.valid[s]) return -1;
  if (UP) {
    const int g = r / p.Ck;
    return (static_cast<int64_t>(g) * p.t + p.top_idx[s]) * p.d;
  }
  return (static_cast<int64_t>(e) * p.M + r) * p.ff;
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, asynchronously, through L2 only; zero-filled
// (nothing read) when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four (two) 8x8 b16 matrices from shared memory; lanes 8j..8j+7 give the
// row addresses of matrix j; .trans transposes each.
__device__ __forceinline__ void ldsm_x4_t(const void* row, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldsm_x2(const void* row, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_addr(row)));
}

// c (16 x 8 float32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col).
__device__ __forceinline__ void mma16816(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// XOR swizzle of 16-byte chunks in rows of 128 bytes (or more: the low
// three bits of the chunk) by row % 8: eight rows read at one logical chunk
// (ldmatrix) hit eight bank groups.
__device__ __forceinline__ int swz128(int row, int ch) {
  return (ch & ~7) | ((ch ^ row) & 7);
}

// ---------------------------------------------------------------------------
// stream: bf16, M <= 16 slots an expert; weight streaming
// ---------------------------------------------------------------------------

template <bool UP>
struct StreamShape {
  static constexpr int kMats = UP ? 2 : 1;
  static constexpr int kCols = 64;                 // output columns a block
  static constexpr int kSub = kCols / 16;           // 16-column warp tiles
  static constexpr int kSplit = 8 / kSub;           // K parts
  static constexpr int kSteps = 4 / kSplit;         // k16 steps a part a stage
  static constexpr int kStages = UP ? 6 : 8;
  static constexpr int kWElems = kMats * kSK * kCols;
};

template <bool UP, int NT>
__host__ __device__ constexpr int stream_stage_elems() {
  return StreamShape<UP>::kWElems + NT * 8 * kSK;
}

// Dynamic shared memory of a stream block (ops.py's smem_bytes mirrors it):
// the ring, then the rows' source offsets, output offsets and weights.
template <bool UP, int NT>
constexpr size_t stream_smem() {
  return static_cast<size_t>(StreamShape<UP>::kStages) *
             stream_stage_elems<UP, NT>() * 2 +
         kStreamMaxRows * (8 + 8 + 4);
}

template <bool UP, int NT>
__global__ void __launch_bounds__(kThreads)
    moe_stream_kernel(const Problem p) {
  using S = StreamShape<UP>;
  extern __shared__ __align__(128) unsigned char smem[];
  auto* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* sSrc = reinterpret_cast<int64_t*>(
      smem + static_cast<size_t>(S::kStages) * stream_stage_elems<UP, NT>() *
                 2);
  int64_t* sOut = sSrc + kStreamMaxRows;
  auto* sWt = reinterpret_cast<float*>(sOut + kStreamMaxRows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.y;
  const int N = UP ? p.ff : p.d;                    // output columns
  const int K = UP ? p.d : p.ff;
  const int n0 = blockIdx.x * S::kCols;

  bool live = false;
  if (tid < kStreamMaxRows) {
    const int64_t src = row_source<UP>(p, e, tid);
    sSrc[tid] = src;
    live = src >= 0;
    if (!UP) {
      const bool in = tid < p.M;
      const int64_t s = in ? slot_of(p, e, tid) : 0;
      sOut[tid] = in ? s * p.d : -1;
      sWt[tid] = live ? p.top_w[s] : 0.0f;
    }
  }
  if (!__syncthreads_or(live)) {
    // a dead expert: no weight byte is read; down writes its zeros
    if (!UP) {
      for (int i = tid; i < p.M * S::kCols; i += kThreads) {
        const int r = i / S::kCols, col = n0 + i % S::kCols;
        if (col < N) p.ye[sOut[r] + col] = 0.0f;
      }
    }
    return;
  }

  const auto* x = static_cast<const __nv_bfloat16*>(UP ? p.xg : p.h);
  const __nv_bfloat16* wm[2] = {
      static_cast<const __nv_bfloat16*>(UP ? p.w_gate : p.w_down) +
          static_cast<int64_t>(e) * K * N,
      static_cast<const __nv_bfloat16*>(UP ? p.w_up : p.w_down) +
          static_cast<int64_t>(e) * K * N};
  const int nk = (K + kSK - 1) / kSK;

  // a stage: the weights' [64 k][kCols] tiles, then the slots' [NT*8][64 k]
  auto load = [&](int kt, int stage) {
    __nv_bfloat16* st = ring + stage * stream_stage_elems<UP, NT>();
    const int k0 = kt * kSK;
    constexpr int kChunksRow = S::kCols / 8;
    constexpr int kWChunks = S::kMats * kSK * kChunksRow;
    for (int i = tid; i < kWChunks; i += kThreads) {
      const int mat = i / (kSK * kChunksRow);
      const int rem = i - mat * kSK * kChunksRow;
      const int kr = rem / kChunksRow, ch = rem % kChunksRow;
      const int k = k0 + kr, col = n0 + ch * 8;
      const bool ok = k < K && col < N;
      cp_async16(st + mat * kSK * S::kCols + kr * S::kCols +
                     swz128(kr, ch) * 8,
                 ok ? wm[mat] + static_cast<int64_t>(k) * N + col : wm[mat],
                 ok);
    }
    __nv_bfloat16* sx = st + S::kWElems;
    if (tid < NT * 8 * 8) {
      const int r = tid >> 3, ch = tid & 7;
      const int64_t src = sSrc[r];
      const bool ok = src >= 0 && k0 + ch * 8 < K;
      cp_async16(sx + r * kSK + swz128(r, ch) * 8,
                 ok ? x + src + k0 + ch * 8 : x, ok);
    }
  };

  const int sub = warp % S::kSub, part = warp / S::kSub;
  float acc[S::kMats][NT][4];
#pragma unroll
  for (int m = 0; m < S::kMats; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][nt][i] = 0.0f;

#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S::kStages - 2>();
    __syncthreads();
    const int nxt = kt + S::kStages - 1;
    if (nxt < nk) load(nxt, nxt % S::kStages);
    cp_async_commit();
    const __nv_bfloat16* st =
        ring + (kt % S::kStages) * stream_stage_elems<UP, NT>();
    const __nv_bfloat16* sx = st + S::kWElems;
#pragma unroll
    for (int i = 0; i < S::kSteps; ++i) {
      const int kk = part * S::kSteps + i;          // k16 step of the stage
      // A = W^T (16 columns x 16 k) by ldmatrix.trans of the [k][n] tile
      const int j = lane >> 3, r8 = lane & 7;
      const int kr = kk * 16 + r8 + (j >> 1) * 8;
      const int ch = sub * 2 + (j & 1);
      unsigned a[S::kMats][4];
#pragma unroll
      for (int m = 0; m < S::kMats; ++m)
        ldsm_x4_t(st + m * kSK * S::kCols + kr * S::kCols + swz128(kr, ch) * 8,
                  a[m]);
      // B = x^T (16 k x 8 slots): the slot rows as stored
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int xr = nt * 8 + r8;
        const int xch = kk * 2 + ((lane >> 3) & 1);
        unsigned b[2];
        ldsm_x2(sx + xr * kSK + swz128(xr, xch) * 8, b);
#pragma unroll
        for (int m = 0; m < S::kMats; ++m) mma16816(acc[m][nt], a[m], b[0], b[1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // the K parts' sums, in part order, through the ring
  auto* red = reinterpret_cast<float*>(smem);
  constexpr int kVals = S::kMats * NT * 4;
#pragma unroll
  for (int m = 0; m < S::kMats; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        red[(warp * kVals + (m * NT + nt) * 4 + i) * 32 + lane] =
            acc[m][nt][i];
  __syncthreads();
  if (part != 0) return;
#pragma unroll
  for (int m = 0; m < S::kMats; ++m)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float v = 0.0f;
        for (int q = 0; q < S::kSplit; ++q)
          v += red[((sub + q * S::kSub) * kVals + (m * NT + nt) * 4 + i) * 32 +
                   lane];
        acc[m][nt][i] = v;
      }
  // c0, c1: column sub*16 + lane/4, slots 2 (lane%4) and + 1; c2, c3: the
  // column 8 further
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = nt * 8 + t2 + (i & 1);
      const int col = n0 + sub * 16 + g + (i >> 1) * 8;
      if (r >= p.M || col >= N) continue;
      if (UP) {
        const float hv = silu(acc[0][nt][i]) * acc[S::kMats - 1][nt][i];
        static_cast<__nv_bfloat16*>(p.h)[(static_cast<int64_t>(e) * p.M + r) *
                                             p.ff +
                                         col] = __float2bfloat16(hv);
      } else {
        p.ye[sOut[r] + col] = sSrc[r] >= 0 ? acc[0][nt][i] * sWt[r] : 0.0f;
      }
    }
}

// ---------------------------------------------------------------------------
// tiles: bf16, M > 16; warp-specialised wgmma tiles fed by TMA
// ---------------------------------------------------------------------------

constexpr int kABytes = kBM * kBK * 2;            // a slot tile's k-tile
constexpr int kBoxBytes = kBK * 128;              // 64 k-rows x 64 columns
constexpr int kBBytes = 4 * kBoxBytes;            // the weights' k-tile
constexpr int kStageBytes = kABytes + kBBytes;
// registers a thread after setmaxnreg: 128 * 56 + 256 * 224 = 64,512 of
// the SM's 65,536 (the launch gives each of the 384 threads 168)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;

// Dynamic shared memory of a tiles block (ref.py's smem_bytes mirrors
// it): the alignment slack, the ring, two items' row arrays (source
// offset, output offset, weight), the mbarriers and the live-pair count,
// then the table of (expert, slot tile) pairs: the live pairs before each
// expert, the pairs, their flags.
constexpr size_t kTilesFixedSmem =
    1024 + static_cast<size_t>(kTileStages) * kStageBytes +
    2 * kBM * (8 + 8 + 4) + (2 * kTileStages + 4) * 8 + 16;
size_t tiles_smem(int E, int n_mt) {
  return kTilesFixedSmem + 4 * (static_cast<size_t>(E) + 1) +
         5 * static_cast<size_t>(E) * n_mt;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// an arrival that also arms the barrier with the bytes TMA loads bring
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA: the box of `map` at the given coordinates (innermost first) global
// -> shared, zero-filled outside the tensor, counted on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// global writes of the generic proxy (the gather's stores) and reads of
// the async proxy (TMA) on either side of it are ordered
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A barrier of every block of the launch (moe_up's gather before its
// products): the blocks are all resident (one an SM, no more than the
// SMs).  The arrival count resets itself and the generation only grows,
// so the module's two words serve every launch, one at a time (calls on
// one device run in stream order; the port has no concurrent MoE call).
__device__ unsigned int g_grid_arrived;
__device__ unsigned int g_grid_generation;

__device__ __forceinline__ void grid_barrier() {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* generation = &g_grid_generation;
    const unsigned int seen = *generation;
    __threadfence();
    if (atomicAdd(&g_grid_arrived, 1u) == gridDim.x - 1) {
      atomicExch(&g_grid_arrived, 0u);
      __threadfence();
      atomicAdd(&g_grid_generation, 1u);
    } else {
      while (*generation == seen) __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
}

// wgmma's shared-memory matrix descriptor of a tile in the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units).
// K-major (the slot tile): the stride offset steps 8 rows (1,024 bytes),
// the leading one is unused.  MN-major (the weights): the leading offset
// steps from one 64-column atom to the next, the stride offset 8 k-rows.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFFu) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFFu) << 32)
         | (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most N of the warpgroup's committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving a use or a definition of the
// accumulators across a wgmma fence, issue or wait (an operand defined
// after the fence serializes the products)
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, float32) (+)= A (64 x 16, the slot tile, K-major) * B (16 x
// 256: four 64-column atoms of the weights' tile, MN-major: the transpose
// bit set), a 16-deep step; accumulate = 0 starts the sum.
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}
// The table of (expert, slot tile) pairs a block builds: pairs
// p = e * n_mt + tile, the live ones (a valid slot among the tile's rows)
// first in (expert, tile) order, then the dead ones; off[e] live pairs
// before expert e (off[E] = n_live).
struct Table {
  const int* off;
  const int* pair;
  int E, n_mt, n_nb, n_live;
};

struct Item {
  int e, tile, nb;
};

// Work item w of the walk: the live items, expert by expert, column block
// by column block, the slot tile fastest (the blocks that read one weight
// tile run together and share it in L2); then (moe_down only) the dead
// ones, which write zeros.
__device__ __forceinline__ Item item_of(const Table& t, int w) {
  if (w < t.n_live * t.n_nb) {
    const int u = w / t.n_nb;
    int lo = 0, hi = t.E - 1;          // the last expert with off[e] <= u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (t.off[mid] <= u) lo = mid;
      else hi = mid - 1;
    }
    const int n = t.off[lo + 1] - t.off[lo];
    const int rem = w - t.off[lo] * t.n_nb;
    const int nb = rem / n;
    return {lo, t.pair[t.off[lo] + rem - nb * n] - lo * t.n_mt, nb};
  }
  const int wd = w - t.n_live * t.n_nb;
  const int n_dead = t.E * t.n_mt - t.n_live;
  const int nb = wd / n_dead;
  const int q = t.pair[t.n_live + wd - nb * n_dead];
  return {q / t.n_mt, q % t.n_mt, nb};
}

// One launch of the tiles regime: a persistent block an SM.  Warpgroup 0
// is the producer (one warp; its lane 0 issues the TMA loads, the other
// three warps leave after giving up their registers), warpgroups 1 and 2
// the consumers (64 rows of the 128-row slot tile each, float32
// accumulators of 64 x 256).  An item's k-tiles stream through a ring of
// kTileStages stages on full / empty mbarriers; its rows' arrays through
// two item buffers on full / empty mbarriers of their own, so that the
// producer loads the next item while the consumers run this one's
// epilogue.
// up:   first the gather pass: xe [E, M, d] in ye's memory (bf16; moe_down
//       overwrites every element of ye) takes each live slot's row of xg
//       and its group's first row for a dead slot of a live tile (h's row
//       of a dead slot is discarded by moe_down), the rows dealt to
//       the launch's warps, then a barrier of every block; A = xe's slot
//       tile, B = w_gate's and w_up's 128 columns of the item (two TMA
//       boxes each); h = bf16(silu(gate) * up).
// down: A = h's slot tile, B = w_down's 256 columns; ye = acc * top_w at a
//       live row, an exact zero at a dead one.
template <bool UP>
__global__ void __launch_bounds__(kWgThreads, 1)
    moe_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b0,
                     const __grid_constant__ CUtensorMap tm_b1,
                     const Problem p, const int n_mt, const int n_nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  auto* sSrc = reinterpret_cast<int64_t*>(ring + kTileStages * kStageBytes);
  int64_t* sOut = sSrc + 2 * kBM;
  auto* sWt = reinterpret_cast<float*>(sOut + 2 * kBM);
  auto* full = reinterpret_cast<uint64_t*>(sWt + 2 * kBM);
  uint64_t* empty = full + kTileStages;
  uint64_t* ifull = empty + kTileStages;
  uint64_t* iempty = ifull + 2;
  auto* sNLive = reinterpret_cast<int*>(iempty + 2);
  int* sOff = sNLive + 4;
  int* sPair = sOff + p.E + 1;
  auto* sFlag = reinterpret_cast<uint8_t*>(sPair + p.E * n_mt);
  const int tid = threadIdx.x;
  const int n_pairs = p.E * n_mt;

  // which pairs hold a valid slot: every block reads the E * M flags
  for (int i = tid; i < n_pairs; i += kWgThreads) sFlag[i] = 0;
  if (tid == 0) {
    for (int s = 0; s < kTileStages; ++s) {
      mbar_init(&full[s], 1);        // the TMA loads' issuer
      mbar_init(&empty[s], 8);       // lane 0 of each consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ifull[i], 32);      // every lane of the producer warp
      mbar_init(&iempty[i], 256);    // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int64_t n_slots = static_cast<int64_t>(p.G) * p.E * p.Ck;
  for (int64_t s = tid; s < n_slots; s += kWgThreads) {
    if (p.valid[s]) {
      const int c = static_cast<int>(s % p.Ck);
      const int64_t ge = s / p.Ck;
      const int e = static_cast<int>(ge % p.E);
      const int g = static_cast<int>(ge / p.E);
      sFlag[e * n_mt + (g * p.Ck + c) / kBM] = 1;
    }
  }
  __syncthreads();
  if (tid < 32) {
    // the live pairs in order, then the dead ones, by warp ballots
    const unsigned below = (1u << tid) - 1u;
    int n_live = 0;
    for (int q0 = 0; q0 < n_pairs; q0 += 32) {
      const int q = q0 + tid;
      const bool live = q < n_pairs && sFlag[q];
      const unsigned bal = __ballot_sync(0xffffffffu, live);
      const int at = n_live + __popc(bal & below);
      if (q < n_pairs && q % n_mt == 0) sOff[q / n_mt] = at;
      if (live) sPair[at] = q;
      n_live += __popc(bal);
    }
    int n_done = n_live;
    for (int q0 = 0; q0 < n_pairs; q0 += 32) {
      const int q = q0 + tid;
      const bool dead = q < n_pairs && !sFlag[q];
      const unsigned bal = __ballot_sync(0xffffffffu, dead);
      if (dead) sPair[n_done + __popc(bal & below)] = q;
      n_done += __popc(bal);
    }
    if (tid == 0) {
      sOff[p.E] = n_live;
      *sNLive = n_live;
    }
  }
  __syncthreads();
  if (UP) {
    // the gather pass, a warp a row of xe (16-byte chunks; the rows of a
    // dead tile are never read, so never written).  A dead slot of a live
    // tile takes its group's first token row: its products are discarded
    // (moe_down writes the slot's exact zero), and on the card the
    // products ran slower over such tiles with zero rows than with rows
    // of data.
    constexpr int kWarps = kWgThreads / 32;
    auto* xe = reinterpret_cast<uint4*>(p.ye);
    const auto* xs = static_cast<const uint4*>(p.xg);
    const int chunks = p.d / 8, warp = tid >> 5, lane = tid & 31;
    const int64_t n_rows = static_cast<int64_t>(p.E) * p.M;
    for (int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
         row < n_rows; row += static_cast<int64_t>(gridDim.x) * kWarps) {
      const int e = static_cast<int>(row / p.M);
      const int r = static_cast<int>(row - static_cast<int64_t>(e) * p.M);
      if (!sFlag[e * n_mt + r / kBM]) continue;
      const int64_t src = row_source<true>(p, e, r);
      const uint4* from =
          xs + (src >= 0 ? src : static_cast<int64_t>(r / p.Ck) * p.t * p.d) /
                   8;
      uint4* dst = xe + row * chunks;
      for (int c = lane; c < chunks; c += 32) dst[c] = from[c];
    }
    fence_proxy_async_global();
    grid_barrier();
    fence_proxy_async_global();
  }
  const Table tab{sOff, sPair, p.E, n_mt, n_nb, *sNLive};
  const int n_live_items = tab.n_live * n_nb;
  const int n_items = UP ? n_live_items : n_pairs * n_nb;
  const int K = UP ? p.d : p.ff;
  const int nk = (K + kBK - 1) / kBK;

  if (tid < 128) {
    // ---- producer: one warp of the warpgroup (lane 0 issues the loads)
    setmaxnreg_dec<kProducerRegs>();
    if (tid >= 32) return;
    const int lane = tid;
    int st = 0, item = 0;
    unsigned ph = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++item) {
      const Item it = item_of(tab, w);
      const int ib = item & 1;
      const int m0 = it.tile * kBM;
      mbar_wait(&iempty[ib], ((item >> 1) & 1) ^ 1);
      if (!UP) {
        // down: each row's liveness, output offset and weight
        for (int rr = lane; rr < kBM; rr += 32) {
          const int r = m0 + rr;
          const int64_t src = row_source<false>(p, it.e, r);
          const bool in = r < p.M;
          const int64_t s = in ? slot_of(p, it.e, r) : 0;
          sSrc[ib * kBM + rr] = src;
          sOut[ib * kBM + rr] = in ? s * p.d : -1;
          sWt[ib * kBM + rr] = src >= 0 ? p.top_w[s] : 0.0f;
        }
      }
      mbar_arrive(&ifull[ib]);
      if (w >= n_live_items) continue;   // a dead item reads no weight byte
      // B: up, the item's 128 gate then 128 up columns; down, 256 columns
      const int n0 = it.nb * (UP ? kBN / 2 : kBN);
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&empty[st], ph ^ 1);
        if (lane == 0) {
          unsigned char* sa = ring + st * kStageBytes;
          unsigned char* sb = sa + kABytes;
          const int k0 = kt * kBK;
          mbar_arrive_expect(&full[st], kStageBytes);
          tma_load_3d(sa, &tm_a, k0, m0, it.e, &full[st]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            tma_load_3d(sb + j * kBoxBytes, UP && j >= 2 ? &tm_b1 : &tm_b0,
                        n0 + 64 * (UP ? j & 1 : j), k0, it.e, &full[st]);
        }
        __syncwarp();
        if (++st == kTileStages) {
          st = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of a tile
  setmaxnreg_inc<kConsumerRegs>();
  const int ct = tid - 128;
  const int cw = ct >> 7, lane = ct & 31;
  const int t4 = lane & 3;
  // the thread's rows of the tile: accumulator rows lane / 4 and + 8 of
  // its warp; acc[4 nb + e] is column 8 nb + 2 t4 + (e & 1) of row rw
  // (e < 2) or rw + 8 (e >= 2)
  const int rw = cw * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  const unsigned ring_addr = smem_addr(ring);
  float acc[128];
  int st = 0, item = 0;
  unsigned ph = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++item) {
    const Item it = item_of(tab, w);
    const int ib = item & 1;
    const int m0 = it.tile * kBM;
    mbar_wait(&ifull[ib], (item >> 1) & 1);
    if (w < n_live_items) {
      int pst = 0;
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[st], ph);
        const unsigned sa = ring_addr + st * kStageBytes;
        hold(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          wgmma_256(acc, smem_desc(sa + cw * 64 * 128 + kk * 32, 16, 1024),
                    smem_desc(sa + kABytes + kk * 16 * 128, kBoxBytes, 1024),
                    kt > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<1>();               // k-tile kt - 1's products landed
        hold(acc);
        if (kt > 0 && lane == 0) mbar_arrive(&empty[pst]);
        pst = st;
        if (++st == kTileStages) {
          st = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      hold(acc);
      if (lane == 0) mbar_arrive(&empty[pst]);
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int rr = rw + 8 * hf;
        const int r = m0 + rr;
        if (r >= p.M) continue;
        if (UP) {
          // gate columns in acc[0, 64), up columns in acc[64, 128)
          const int n0 = it.nb * (kBN / 2);
          auto* hrow = static_cast<__nv_bfloat16*>(p.h) +
                       (static_cast<int64_t>(it.e) * p.M + r) * p.ff;
#pragma unroll
          for (int nb = 0; nb < 16; ++nb) {
            const int col = n0 + nb * 8 + 2 * t4;
            if (col >= p.ff) continue;
            const float h0 = silu(acc[4 * nb + 2 * hf]) *
                             acc[64 + 4 * nb + 2 * hf];
            const float h1 = silu(acc[4 * nb + 2 * hf + 1]) *
                             acc[64 + 4 * nb + 2 * hf + 1];
            *reinterpret_cast<unsigned*>(hrow + col) = pack_bf16(h0, h1);
          }
        } else {
          const int n0 = it.nb * kBN;
          const bool ok = sSrc[ib * kBM + rr] >= 0;
          const float wt = sWt[ib * kBM + rr];
          float* yrow = p.ye + sOut[ib * kBM + rr];
#pragma unroll
          for (int nb = 0; nb < 32; ++nb) {
            const int col = n0 + nb * 8 + 2 * t4;
            if (col >= p.d) continue;
            *reinterpret_cast<float2*>(yrow + col) =
                ok ? make_float2(acc[4 * nb + 2 * hf] * wt,
                                 acc[4 * nb + 2 * hf + 1] * wt)
                   : make_float2(0.0f, 0.0f);
          }
        }
      }
    } else if (!UP) {
      // a dead item of moe_down: its rows' zeros, no weight byte read
      const int n0 = it.nb * kBN;
      for (int i = ct; i < kBM * (kBN / 4); i += 256) {
        const int rr = i / (kBN / 4), col = n0 + (i % (kBN / 4)) * 4;
        if (m0 + rr < p.M && col < p.d)
          *reinterpret_cast<float4*>(p.ye + sOut[ib * kBM + rr] + col) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    mbar_arrive(&iempty[ib]);
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link to
// the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 3-D bf16 tensor map [n2][n1][n0] (row-major, n0 innermost) with a box
// of 64 x rows x 1 in the 128-byte swizzle (elements outside the tensor
// read as zeros).
bool bf16_map(CUtensorMap* map, const void* base, int n0, int n1, int n2,
              int rows) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n0),
                              static_cast<cuuint64_t>(n1),
                              static_cast<cuuint64_t>(n2)};
  const cuuint64_t strides[2] = {n0 * e, static_cast<cuuint64_t>(n0) * n1 * e};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

template <bool UP>
cudaError_t launch_wgmma(const CUtensorMap& a, const CUtensorMap& b0,
                         const CUtensorMap& b1, const Problem& p, int n_mt,
                         int n_nb, size_t smem, int sms, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      moe_wgmma_kernel<UP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long items = static_cast<long long>(p.E) * n_mt * n_nb;
  const int grid = items < sms ? static_cast<int>(items) : sms;
  moe_wgmma_kernel<UP><<<grid, kWgThreads, smem, stream>>>(a, b0, b1, p,
                                                           n_mt, n_nb);
  return cudaGetLastError();
}

// The two launches of the tiles regime: a persistent block an SM each,
// the weights (and h) through TMA maps over [E, K, N] ([E, M, ff]).
cudaError_t launch_tiles(const Problem& p, cudaStream_t stream) {
  const int n_mt = (p.M + kBM - 1) / kBM;
  const int up_nb = (p.ff + kBN / 2 - 1) / (kBN / 2);
  const int down_nb = (p.d + kBN - 1) / kBN;
  const size_t smem = tiles_smem(p.E, n_mt);
  const int sms = sm_count();
  const long long pairs = static_cast<long long>(p.E) * n_mt;
  if (sms <= 0 || smem > kMaxSmem || pairs * up_nb >= INT_MAX ||
      pairs * down_nb >= INT_MAX)
    return cudaErrorInvalidValue;
  CUtensorMap xe, gate, up, down, h;
  if (!bf16_map(&xe, p.ye, p.d, p.M, p.E, kBM) ||
      !bf16_map(&gate, p.w_gate, p.ff, p.d, p.E, kBK) ||
      !bf16_map(&up, p.w_up, p.ff, p.d, p.E, kBK) ||
      !bf16_map(&down, p.w_down, p.d, p.ff, p.E, kBK) ||
      !bf16_map(&h, p.h, p.ff, p.M, p.E, kBM))
    return cudaErrorInvalidValue;
  const cudaError_t err = launch_wgmma<true>(xe, gate, up, p, n_mt, up_nb,
                                             smem, sms, stream);
  if (err != cudaSuccess) return err;
  return launch_wgmma<false>(h, down, down, p, n_mt, down_nb, smem, sms,
                             stream);
}

// ---------------------------------------------------------------------------
// simt: float32, any M; CUDA cores
// ---------------------------------------------------------------------------

template <bool UP>
__global__ void __launch_bounds__(kThreads) moe_simt_kernel(const Problem p) {
  constexpr int kMats = UP ? 2 : 1;
  constexpr int kLd = kFM + 4;                      // transposed A, padded
  __shared__ __align__(16) float sA[2][kFK][kLd];
  __shared__ __align__(16) float sB[2][kMats][kFK][kFN];
  __shared__ int64_t sSrc[kFM];
  __shared__ int64_t sOut[kFM];
  __shared__ float sWt[kFM];

  const int tid = threadIdx.x;
  const int e = blockIdx.z;
  const int N = UP ? p.ff : p.d;
  const int K = UP ? p.d : p.ff;
  const int m0 = blockIdx.x * kFM;
  const int n0 = blockIdx.y * kFN;

  bool live = false;
  if (tid < kFM) {
    const int r = m0 + tid;
    const int64_t src = row_source<UP>(p, e, r);
    sSrc[tid] = src;
    live = src >= 0;
    if (!UP) {
      const bool in = r < p.M;
      const int64_t s = in ? slot_of(p, e, r) : 0;
      sOut[tid] = in ? s * p.d : -1;
      sWt[tid] = live ? p.top_w[s] : 0.0f;
    }
  }
  if (!__syncthreads_or(live)) {
    if (!UP) {
      for (int i = tid; i < kFM * (kFN / 4); i += kThreads) {
        const int rr = i / (kFN / 4), col = n0 + (i % (kFN / 4)) * 4;
        if (m0 + rr < p.M && col < N)
          *reinterpret_cast<float4*>(p.ye + sOut[rr] + col) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    return;
  }

  const auto* x = static_cast<const float*>(UP ? p.xg : p.h);
  const float* w[2] = {
      static_cast<const float*>(UP ? p.w_gate : p.w_down) +
          static_cast<int64_t>(e) * K * N,
      static_cast<const float*>(UP ? p.w_up : p.w_down) +
          static_cast<int64_t>(e) * K * N};
  const int nk = (K + kFK - 1) / kFK;
  // loads: A row tid / 4, k tid % 4 * 4 (a float4 along k); B k-row
  // tid / 16, columns tid % 16 * 4
  const int a_r = tid >> 2, a_k = (tid & 3) * 4;
  const int b_k = tid >> 4, b_c = (tid & 15) * 4;
  const int64_t a_src = sSrc[a_r];
  const bool b_in = n0 + b_c < N;
  float4 ra, rb[kMats];
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto fetch = [&](int kt) {
    const int k0 = kt * kFK;
    ra = a_src >= 0 && k0 + a_k < K
             ? *reinterpret_cast<const float4*>(x + a_src + k0 + a_k)
             : zero;
#pragma unroll
    for (int m = 0; m < kMats; ++m)
      rb[m] = b_in && k0 + b_k < K
                  ? *reinterpret_cast<const float4*>(
                        w[m] + static_cast<int64_t>(k0 + b_k) * N + n0 + b_c)
                  : zero;
  };
  auto store = [&](int buf) {
    sA[buf][a_k + 0][a_r] = ra.x;
    sA[buf][a_k + 1][a_r] = ra.y;
    sA[buf][a_k + 2][a_r] = ra.z;
    sA[buf][a_k + 3][a_r] = ra.w;
#pragma unroll
    for (int m = 0; m < kMats; ++m)
      *reinterpret_cast<float4*>(&sB[buf][m][b_k][b_c]) = rb[m];
  };

  const int tx = tid & 15, ty = tid >> 4;
  float acc[kMats][4][4];
#pragma unroll
  for (int m = 0; m < kMats; ++m)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.0f;

  fetch(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch(kt + 1);
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[buf][k][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int m = 0; m < kMats; ++m) {
        const float4 b =
            *reinterpret_cast<const float4*>(&sB[buf][m][k][tx * 4]);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[m][i][j] += av[i] * bv[j];
      }
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }

  const int col = n0 + tx * 4;
  if (col >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int rr = ty * 4 + i;
    const int r = m0 + rr;
    if (r >= p.M) continue;
    float v[4];
    if (UP) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = silu(acc[0][i][j]) * acc[kMats - 1][i][j];
      *reinterpret_cast<float4*>(static_cast<float*>(p.h) +
                                 (static_cast<int64_t>(e) * p.M + r) * p.ff +
                                 col) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      const bool ok = sSrc[rr] >= 0;
      const float wt = sWt[rr];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = ok ? acc[0][i][j] * wt : 0.0f;
      *reinterpret_cast<float4*>(p.ye + sOut[rr] + col) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t smem,
                       const Problem& p, cudaStream_t stream) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_stream(const Problem& p, cudaStream_t stream) {
  cudaError_t err = launch_one(
      moe_stream_kernel<true, NT>,
      dim3((p.ff + StreamShape<true>::kCols - 1) / StreamShape<true>::kCols,
           p.E),
      stream_smem<true, NT>(), p, stream);
  if (err != cudaSuccess) return err;
  return launch_one(
      moe_stream_kernel<false, NT>,
      dim3((p.d + StreamShape<false>::kCols - 1) / StreamShape<false>::kCols,
           p.E),
      stream_smem<false, NT>(), p, stream);
}

int run(const Problem& p, int regime, bool bf16, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const int align = bf16 ? 8 : 4;                   // 16-byte rows
  if (p.G <= 0 || p.t <= 0 || p.E <= 0 || p.Ck <= 0 || p.d <= 0 ||
      p.ff <= 0 || p.d % align != 0 || p.ff % align != 0 ||
      p.E > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (regime == kStream && bf16) {
    if (p.M > kStreamMaxRows) return static_cast<int>(cudaErrorInvalidValue);
    err = p.M <= 8 ? launch_stream<1>(p, st) : launch_stream<2>(p, st);
  } else if (regime == kTiles && bf16) {
    err = launch_tiles(p, st);
  } else if (regime == kSimt && !bf16) {
    const unsigned mt = static_cast<unsigned>((p.M + kFM - 1) / kFM);
    err = launch_one(moe_simt_kernel<true>,
                     dim3(mt, (p.ff + kFN - 1) / kFN, p.E), 0, p, st);
    if (err == cudaSuccess)
      err = launch_one(moe_simt_kernel<false>,
                       dim3(mt, (p.d + kFN - 1) / kFN, p.E), 0, p, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

Problem problem(const void* xg, const void* top_idx, const void* valid,
                const void* top_w, const void* w_gate, const void* w_up,
                const void* w_down, void* h, void* ye, int G, int t, int d,
                int E, int Ck, int ff) {
  Problem p;
  p.xg = xg;
  p.top_idx = static_cast<const int64_t*>(top_idx);
  p.valid = static_cast<const uint8_t*>(valid);
  p.top_w = static_cast<const float*>(top_w);
  p.w_gate = w_gate;
  p.w_up = w_up;
  p.w_down = w_down;
  p.h = h;
  p.ye = static_cast<float*>(ye);
  p.G = G;
  p.t = t;
  p.d = d;
  p.E = E;
  p.Ck = Ck;
  p.ff = ff;
  p.M = G * Ck;
  return p;
}

}  // namespace

// xg [G, t, d]; top_idx [G, E, Ck] int64; valid [G, E, Ck] bool; top_w
// [G, E, Ck] float32; w_gate, w_up [E, d, ff]; w_down [E, ff, d]; h [E,
// G*Ck, ff] scratch in xg's dtype; ye [G, E, Ck, d] float32.  regime: 0
// stream, 1 tiles (bf16), 2 simt (float32).  Returns the first launch's
// cudaError_t (0 when both launched).
extern "C" int moe_ffn_f32(const void* xg, const void* top_idx,
                           const void* valid, const void* top_w,
                           const void* w_gate, const void* w_up,
                           const void* w_down, void* h, void* ye, int G,
                           int t, int d, int E, int Ck, int ff, int regime,
                           void* stream) {
  return run(problem(xg, top_idx, valid, top_w, w_gate, w_up, w_down, h, ye,
                     G, t, d, E, Ck, ff),
             regime, false, stream);
}

extern "C" int moe_ffn_bf16(const void* xg, const void* top_idx,
                            const void* valid, const void* top_w,
                            const void* w_gate, const void* w_up,
                            const void* w_down, void* h, void* ye, int G,
                            int t, int d, int E, int Ck, int ff, int regime,
                            void* stream) {
  return run(problem(xg, top_idx, valid, top_w, w_gate, w_up, w_down, h, ye,
                     G, t, d, E, Ck, ff),
             regime, true, stream);
}
