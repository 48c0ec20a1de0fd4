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
//             reads nothing and counts as a zero row), runs the gate and up
//             products on that one row tile with two float32 accumulators,
//             and rounds silu(gate) * up (float32, silu = x / (1 + expf(-x)))
//             to the model dtype;
//   moe_down  runs h @ w_down with a float32 accumulator; its epilogue
//             multiplies a live slot's row by top_w and writes an exact zero
//             for a dead one.
//
// Dead work is skipped on the device, without a host sync: a block first
// reads the valid flags of its rows; a block with none reads no weight
// byte (moe_up leaves its rows of h unwritten, moe_down writes zeros).  A
// dead row inside a live tile reads no input either (zero-filled), and
// comes out zero.  No atomics: every output element is summed by one
// thread in a fixed order, so two runs give the same bits.
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
// * tiles (bf16, M > 16: prefill): operations, on the tensor cores.  A block
//   computes a 128-row x 256-column tile (up: 128 gate + 128 up columns, the
//   same ff columns) with 8 warps of 64 x 64 (mma.sync, 128 float32
//   accumulators a thread), fed by a 4-stage cp.async ring of 64-deep
//   k-tiles in XOR-swizzled rows (ldmatrix without bank conflicts).  Row
//   tiles are the grid's fastest axis, so the blocks that read one weight
//   tile run together and share it in L2.
// * simt (float32, any M): the float32 paths are parity checks, so one
//   plain tiled design on the CUDA cores (TF32 stays off): 64 x 64 tiles
//   (x2 for up), a 4 x 4 register tile a thread, k-tiles of 16 double
//   buffered through registers.
//
// Both launches run on the caller's stream; the C entry points return the
// first launch error (0 when both launched).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kDefaultSmem = 48 * 1024;

// regimes (ops.py's REGIMES)
constexpr int kStream = 0;
constexpr int kTiles = 1;
constexpr int kSimt = 2;

// stream: at most 16 slots an expert, k-tiles of 64
constexpr int kStreamMaxRows = 16;
constexpr int kSK = 64;
// tiles: 128 rows x 256 columns x 64 deep, 4 stages
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
// (down); -1 for a dead slot or a row past M.
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
__device__ __forceinline__ void ldsm_x4(const void* row, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}
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
// tiles: bf16, M > 16; tensor-core tiles
// ---------------------------------------------------------------------------

constexpr int kTileStageElems = kBM * kBK + kBK * kBN;

// Dynamic shared memory of a tiles block (ops.py's smem_bytes mirrors it):
// the ring, then the rows' source offsets, output offsets and weights.
constexpr size_t tiles_smem() {
  return static_cast<size_t>(kTileStages) * kTileStageElems * 2 +
         kBM * (8 + 8 + 4);
}

template <bool UP>
__global__ void __launch_bounds__(kThreads, 1)
    moe_tiles_kernel(const Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  auto* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* sSrc = reinterpret_cast<int64_t*>(
      smem + static_cast<size_t>(kTileStages) * kTileStageElems * 2);
  int64_t* sOut = sSrc + kBM;
  auto* sWt = reinterpret_cast<float*>(sOut + kBM);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int e = blockIdx.z;
  const int N = UP ? p.ff : p.d;
  const int K = UP ? p.d : p.ff;
  const int m0 = blockIdx.x * kBM;
  // up: gate and up columns n0 .. n0 + 127 of each; down: n0 .. n0 + 255
  const int n0 = blockIdx.y * (UP ? kBN / 2 : kBN);

  bool live = false;
  if (tid < kBM) {
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
    if (!UP) {   // a dead slot tile: zeros, no weight byte read
      for (int i = tid; i < kBM * (kBN / 4); i += kThreads) {
        const int rr = i / (kBN / 4), col = n0 + (i % (kBN / 4)) * 4;
        if (m0 + rr < p.M && col < N)
          *reinterpret_cast<float4*>(p.ye + sOut[rr] + col) =
              make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    return;
  }

  const auto* x = static_cast<const __nv_bfloat16*>(UP ? p.xg : p.h);
  const auto* wa = static_cast<const __nv_bfloat16*>(UP ? p.w_gate : p.w_down) +
                   static_cast<int64_t>(e) * K * N;
  const auto* wb = static_cast<const __nv_bfloat16*>(UP ? p.w_up : p.w_down) +
                   static_cast<int64_t>(e) * K * N;
  const int nk = (K + kBK - 1) / kBK;

  // this thread's chunks: A rows (tid / 8) + 32 i, chunk tid % 8; B k-rows
  // (tid / 32) + 8 i, chunk tid % 32 (a 16-byte column run)
  const int a_ch = tid & 7, b_ch = tid & 31;
  int b_col;
  const __nv_bfloat16* b_src;
  if (UP) {
    b_col = n0 + (b_ch & 15) * 8;
    b_src = b_ch < 16 ? wa : wb;
  } else {
    b_col = n0 + b_ch * 8;
    b_src = wa;
  }
  const bool b_in = b_col < N;

  auto load = [&](int kt, int stage) {
    __nv_bfloat16* sa = ring + stage * kTileStageElems;
    __nv_bfloat16* sb = sa + kBM * kBK;
    const int k0 = kt * kBK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = (tid >> 3) + 32 * i;
      const int64_t src = sSrc[r];
      const bool ok = src >= 0 && k0 + a_ch * 8 < K;
      cp_async16(sa + r * kBK + swz128(r, a_ch) * 8,
                 ok ? x + src + k0 + a_ch * 8 : x, ok);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int kr = (tid >> 5) + 8 * i;
      const bool ok = b_in && k0 + kr < K;
      cp_async16(sb + kr * kBN + swz128(kr, b_ch) * 8,
                 ok ? b_src + static_cast<int64_t>(k0 + kr) * N + b_col : wa,
                 ok);
    }
  };

  const int wm = warp >> 2, wn = warp & 3;
  // the shared column of the warp's n8 tile j
  auto tile_col = [&](int j) {
    if (UP) return j < 4 ? wn * 32 + j * 8 : kBN / 2 + wn * 32 + (j - 4) * 8;
    return wn * 64 + j * 8;
  };
  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
  for (int s = 0; s < kTileStages - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kTileStages - 2>();
    __syncthreads();
    const int nxt = kt + kTileStages - 1;
    if (nxt < nk) load(nxt, nxt % kTileStages);
    cp_async_commit();
    const __nv_bfloat16* sa = ring + (kt % kTileStages) * kTileStageElems;
    const __nv_bfloat16* sb = sa + kBM * kBK;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      unsigned a[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = wm * 64 + i * 16 + (lane & 15);
        const int ch = kk * 2 + (lane >> 4);
        ldsm_x4(sa + r * kBK + swz128(r, ch) * 8, a[i]);
      }
      unsigned b[8][2];
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        const int jm = lane >> 3;
        const int kr = kk * 16 + (lane & 7) + (jm & 1) * 8;
        const int ch = tile_col(2 * jp + (jm >> 1)) >> 3;
        unsigned r4[4];
        ldsm_x4_t(sb + kr * kBN + swz128(kr, ch) * 8, r4);
        b[2 * jp][0] = r4[0];
        b[2 * jp][1] = r4[1];
        b[2 * jp + 1][0] = r4[2];
        b[2 * jp + 1][1] = r4[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) mma16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: c0, c1 at row lane/4, columns 2 (lane%4) and + 1; c2, c3 at
  // the row 8 further
  const int g = lane >> 2, t2 = (lane & 3) * 2;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int rr = wm * 64 + i * 16 + g + hf * 8;
      const int r = m0 + rr;
      if (r >= p.M) continue;
      if (UP) {
        auto* hrow = static_cast<__nv_bfloat16*>(p.h) +
                     (static_cast<int64_t>(e) * p.M + r) * p.ff;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + wn * 32 + j * 8 + t2;
          if (col >= N) continue;
          const float h0 = silu(acc[i][j][2 * hf]) * acc[i][j + 4][2 * hf];
          const float h1 =
              silu(acc[i][j][2 * hf + 1]) * acc[i][j + 4][2 * hf + 1];
          *reinterpret_cast<unsigned*>(hrow + col) = pack_bf16(h0, h1);
        }
      } else {
        const bool ok = sSrc[rr] >= 0;
        const float w = sWt[rr];
        float* yrow = p.ye + sOut[rr];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = n0 + wn * 64 + j * 8 + t2;
          if (col >= N) continue;
          *reinterpret_cast<float2*>(yrow + col) =
              ok ? make_float2(acc[i][j][2 * hf] * w,
                               acc[i][j][2 * hf + 1] * w)
                 : make_float2(0.0f, 0.0f);
        }
      }
    }
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
    const unsigned mt = static_cast<unsigned>((p.M + kBM - 1) / kBM);
    err = launch_one(moe_tiles_kernel<true>,
                     dim3(mt, (p.ff + kBN / 2 - 1) / (kBN / 2), p.E),
                     tiles_smem(), p, st);
    if (err == cudaSuccess)
      err = launch_one(moe_tiles_kernel<false>,
                       dim3(mt, (p.d + kBN - 1) / kBN, p.E), tiles_smem(), p,
                       st);
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
