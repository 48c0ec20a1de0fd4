// The Mamba-2 SSD chunked scan: the full-sequence state-space mixer's
// recurrence, chunk by chunk, in float32.
//
// Replaces no TPU kernel: it computes the reference's `_ssd_scan`
// (src/repro/models/ssm.py:87, body :87-140), which the reference leaves
// to XLA as a scan over chunks.  It exists because that program is on
// measured paths of the port (every SSM layer of `prefill` and
// `forward_train`), where its plain PyTorch version took 4.41 ms a call at
// mamba2-1.3b's 4,096-token prefill, 22.6 times its bound.
//
// What it computes, for each sequence b and head h, over chunks of Q rows
// (the last one may be shorter: the reference's zero padding, a_log = 0,
// dt = 0, x = 0, leaves y and the state as they are without it):
//
//   la[q]        = a_log[0] + ... + a_log[q] within the chunk (log decays)
//   xdt[s,p]     = x[s,p] * dt[s]
//   G[q,s]       = C[q,:] . B[s,:]                  (shared by every head)
//   y[q,p]       = sum_{s <= q} G[q,s] exp(la[q] - la[s]) xdt[s,p]
//                  + exp(la[q]) sum_n C[q,n] state[p,n]
//   chunk[p,n]   = sum_s xdt[s,p] exp(la_last - la[s]) B[s,n]
//   state        <- state * exp(la_last) + chunk    (carried across chunks)
//
// all in float32 as the reference (`preferred_element_type=F32` over
// float32 operands: rounding M or xdt to bf16, or TF32, would change its
// result), each decay an exp of a difference (never exp(la_q) *
// exp(-la_s), which overflows on long chunks), y rounded once to x's
// dtype, and the final state float32 [B, H, P, N].
//
// Bound: operations, float32 on the CUDA cores (67 TFLOP/s): at the
// 4,096-token prefill (H = 64, P = 64, N = 128, Q = 256) the causal half of
// each chunk's dual form, the inter-chunk product and the chunk states take
// 0.196 ms, against 0.02 ms for the bytes (x, B, C, dt, a_log and y once,
// the state once).  The design against it, in three launches:
//
// 1. Chunk states and G, in parallel over (b, chunk): one block per
//    (head, 64 columns of P) computes its chunk state as a float32 tile
//    product (xdt * decay)^T B over the chunk's rows, after a block scan
//    of the chunk's log decays (which it keeps for launch 3); further
//    blocks of the same grid compute G = C B^T once per (b, chunk), in
//    128 x 64 tiles of its causal half, for all heads.
// 2. The sequential pass over chunks, in parallel over (b, h, N, P), four
//    state elements a thread as one 16-byte word, the next chunk's word
//    and decay loaded before the dependent multiply-add: state <- state *
//    exp(la_last) + chunk state, leaving in each chunk's slot the state
//    that enters it, and the final state.
// 3. The chunk outputs, in parallel over (b, chunk, head, 128 rows, 64
//    columns of P): (G o seg) xdt over the causal columns plus
//    (C exp(la)) state_in, one float32 accumulator, rounded once.
//
// Each product is a 128 x 64 output tile of a block of 128 threads, an
// 8 x 8 register tile a thread (rows 8 ty .. 8 ty + 7, columns 4 tx .. + 3
// and 32 + 4 tx .. + 3) fed by four 16-byte shared loads for its 64 FMA a
// k (conflict-free: a warp reads 4 row words and 8 consecutive column
// words).  Its operands are staged 16 rows deep (k-major) through two
// shared buffers: a stage's global loads are issued into registers before
// the tile product of the one before, and transformed (bf16 -> float32,
// x * dt, the decays' exps, the causal mask) and stored into the other
// buffer after it, so one barrier a stage remains and no exp or bounds test
// sits in the FMA loop.  (cp.async would copy the raw operands only; each
// one is transformed on its way in.)  The output pass skips, a warp at a
// time, the stages of the zero upper triangle of G o seg past its 32 rows.
// The scratch is every chunk's state, [B, n_chunks, H, N, P] float32 (33.5
// MB at the 4,096-token prefill), G [B, n_chunks, Q, Q] and the log
// decays.
//
// Takes Q <= 256, P <= 128, N <= 128 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 128;        // 16 x 8 threads
constexpr int kTM = 128;             // output rows of a block
constexpr int kTN = 64;              // output columns of a block
constexpr int kKB = 16;              // depth of a staged k-block
constexpr int kStage = kKB * (kTM + kTN);   // floats of one buffer: A, B
constexpr int kMaxQ = 256;           // a chunk's decays: two a thread
// blocks an SM the register budget aims at (170 registers a thread)
constexpr int kBlocksPerSM = 3;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}
__device__ __forceinline__ void stf(float* p, float x) { *p = x; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
// the output column of register j of thread column tx
__device__ __forceinline__ int col_of(int j, int tx) {
  return j < 4 ? 4 * tx + j : 32 + 4 * tx + (j - 4);
}

// acc[i][j] += sum over the stage's kKB k of A[k][8 ty + i] * B[k][col j]
__device__ __forceinline__ void tile_step(float (&acc)[8][8], const float* sA,
                                          const float* sB, int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kKB; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(sA + kk * kTM + 8 * ty);
    const float4 a1 =
        *reinterpret_cast<const float4*>(sA + kk * kTM + 8 * ty + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(sB + kk * kTN + 4 * tx);
    const float4 b1 =
        *reinterpret_cast<const float4*>(sB + kk * kTN + 32 + 4 * tx);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

// acc += A B over k in [k0, k1), staged kKB deep through the two buffers
// of `smem`: fetch(k) loads stage k into the caller's registers, put(sA,
// sB) transforms and stores them.  A warp whose rows all lie before k
// (k > k_last) skips that stage's products.
template <class Fetch, class Put>
__device__ __forceinline__ void staged_product(float (&acc)[8][8],
                                               float* smem, int k0, int k1,
                                               int k_last, int ty, int tx,
                                               Fetch fetch, Put put) {
  if (k0 >= k1) return;
  fetch(k0);
  put(smem, smem + kKB * kTM);
  __syncthreads();
  int buf = 0;
  for (int k = k0; k < k1; k += kKB) {
    const bool more = k + kKB < k1;
    if (more) fetch(k + kKB);   // in flight during this stage's products
    const float* cur = smem + buf * kStage;
    if (k <= k_last) tile_step(acc, cur, cur + kKB * kTM, ty, tx);
    if (more) {
      float* nxt = smem + (buf ^ 1) * kStage;
      put(nxt, nxt + kKB * kTM);
    }
    __syncthreads();
    buf ^= 1;
  }
}

// sLa[s] = a[0] + ... + a[s] for s < Lc (a[s] = a_log_h[s * H]; rows past
// Lc repeat the total), by a block scan (rows tid and 128 + tid).
__device__ __forceinline__ void chunk_cumsum(const float* a_log_h, int H,
                                             int Lc, float* sLa,
                                             float* sWarp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float x[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = h * kThreads + tid;
    x[h] = s < Lc ? a_log_h[static_cast<size_t>(s) * H] : 0.0f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, x[h], off);
      if (lane >= off) x[h] += y;
    }
    if (lane == 31) sWarp[h * 4 + warp] = x[h];
  }
  __syncthreads();
  float pre0 = 0.0f, pre1 = 0.0f;
  for (int w = 0; w < 4; ++w) {
    pre1 += sWarp[w];
    if (w < warp) {
      pre0 += sWarp[w];
      pre1 += sWarp[4 + w];
    }
  }
  sLa[tid] = x[0] + pre0;
  sLa[kThreads + tid] = x[1] + pre1;
  __syncthreads();
}

// Launch 1: blocks x < H * n_pt take the chunk state of head x / n_pt for
// columns p in [64 (x % n_pt), +64): states[b, c, h, n, p]; the others a
// 128 x 64 tile (s rows, q columns) of G's causal half: gt[b, c, s, q] =
// C[q] . B[s].  blockIdx.y is the chunk, blockIdx.z the sequence.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
ssd_chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, const float* __restrict__ dt,
                       const float* __restrict__ a_log,
                       float* __restrict__ states, float* __restrict__ gt,
                       float* __restrict__ la_out,
                       float* __restrict__ la_last_out, int S, int H, int P,
                       int N, int Q, int n_pt) {
  __shared__ __align__(16) float smem[2 * kStage];
  __shared__ float sLa[kMaxQ];
  __shared__ float sWarp[8];
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int Lc = min(Q, S - c * Q);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  float acc[8][8] = {};
  if (static_cast<int>(blockIdx.x) < H * n_pt) {
    const int h = blockIdx.x / n_pt, p0 = (blockIdx.x % n_pt) * kTN;
    chunk_cumsum(a_log + row0 * H + h, H, Lc, sLa, sWarp);
    const float la_last = sLa[Lc - 1];
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    if (p0 == 0) {
      for (int s = tid; s < Q; s += kThreads)
        la_out[bch * Q + s] = s < Lc ? sLa[s] : la_last;
      if (tid == 0) la_last_out[bch] = la_last;
    }
    // A[s][n] = B[s][n]: 4 words a thread (row u / 32, columns 4 (u % 32)
    // ..); B[s][p] = xdt[s][p] * exp(la_last - la[s]): 2 words
    T ra[4][4], rb[2][4];
    float rdt[2];
    auto fetch = [&](int k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = tid + kThreads * i, s = k + u / 32, n = 4 * (u % 32);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ra[i][e] = s < Lc && n + e < N ? Bm[(row0 + s) * N + n + e]
                                         : zero<T>();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = tid + kThreads * i, s = k + u / 16,
                  p = p0 + 4 * (u % 16);
        const size_t r = (row0 + s) * H + h;
        rdt[i] = s < Lc ? dt[r] : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rb[i][e] = s < Lc && p + e < P ? x[r * P + p + e]
                                         : zero<T>();
      }
    };
    int kcur = 0;
    auto put = [&](float* sA, float* sB) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = tid + kThreads * i;
        const float v[4] = {to_f(ra[i][0]), to_f(ra[i][1]), to_f(ra[i][2]),
                            to_f(ra[i][3])};
        st4(sA + (u / 32) * kTM + 4 * (u % 32), v);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = tid + kThreads * i, s = kcur + u / 16;
        const float d = s < Lc ? expf(la_last - sLa[s]) : 0.0f;
        const float v[4] = {to_f(rb[i][0]) * rdt[i] * d,
                            to_f(rb[i][1]) * rdt[i] * d,
                            to_f(rb[i][2]) * rdt[i] * d,
                            to_f(rb[i][3]) * rdt[i] * d};
        st4(sB + (u / 16) * kTN + 4 * (u % 16), v);
      }
      kcur += kKB;
    };
    staged_product(acc, smem, 0, Lc, INT_MAX, ty, tx, fetch, put);
    float* dst = states + bch * N * P;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = 8 * ty + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = p0 + col_of(j, tx);
        if (n < N && p < P) dst[static_cast<size_t>(n) * P + p] = acc[i][j];
      }
    }
  } else {
    // the causal tile (st, qt), qt * 64 + 63 >= st * 128, of G
    const int n_q64 = (Q + kTN - 1) / kTN;
    int g = blockIdx.x - H * n_pt, st = 0;
    while (g >= n_q64 - 2 * st) {
      g -= n_q64 - 2 * st;
      ++st;
    }
    const int sr0 = st * kTM, q0 = (2 * st + g) * kTN;
    // A[n][s] = B[sr0 + s][n], B[n][q] = C[q0 + q][n]: row r and 4 n from
    // n0 a thread and word (4 words of A, 2 of B), so 4 threads read a
    // row's 16 n of the stage together
    const int r = tid >> 2, n0 = 4 * (tid & 3);
    T ra[4][4], rb[2][4];
    auto fetch = [&](int k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = sr0 + r + 32 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ra[i][e] = s < Lc && k + n0 + e < N
                         ? Bm[(row0 + s) * N + k + n0 + e]
                         : zero<T>();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int q = q0 + r + 32 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rb[i][e] = q < Lc && k + n0 + e < N
                         ? Cm[(row0 + q) * N + k + n0 + e]
                         : zero<T>();
      }
    };
    auto put = [&](float* sA, float* sB) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sA[(n0 + e) * kTM + r + 32 * i] = to_f(ra[i][e]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sB[(n0 + e) * kTN + r + 32 * i] = to_f(rb[i][e]);
      }
    };
    staged_product(acc, smem, 0, N, INT_MAX, ty, tx, fetch, put);
    float* dst = gt + (static_cast<size_t>(b) * nc + c) * Q * Q;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int s = sr0 + 8 * ty + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = q0 + col_of(j, tx);
        if (s < Lc && q < Lc) dst[static_cast<size_t>(s) * Q + q] = acc[i][j];
      }
    }
  }
}

// Launch 2: four consecutive elements (b, h, n, p) of the state a thread
// (kVec = 4 when N * P is a multiple of 4, else 1), in order over the
// chunks: each chunk's slot takes the state entering the chunk, and
// final_state[b, h, p, n] the state after the last.  The next chunk's
// values and decay are loaded before this chunk's dependent update.
template <int kVec>
__global__ void __launch_bounds__(256)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ la_last,
                      float* __restrict__ final_state, int nc, int H, int P,
                      int N, long long total) {
  using Word = typename std::conditional<kVec == 4, float4, float>::type;
  const long long i =
      (static_cast<long long>(blockIdx.x) * 256 + threadIdx.x) * kVec;
  if (i >= total) return;
  const int NP = N * P;
  const long long bh = i / NP;
  const int e0 = static_cast<int>(i - bh * NP);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  auto slot = [&](int c) {
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    return reinterpret_cast<Word*>(states + bch * NP + e0);
  };
  auto decay = [&](int c) {
    return la_last[(static_cast<size_t>(b) * nc + c) * H + h];
  };
  float st[kVec] = {};
  Word cur = *slot(0);
  float dl = decay(0);
  for (int c = 0; c < nc; ++c) {
    Word nxt = cur;
    float dn = 0.0f;
    if (c + 1 < nc) {
      nxt = *slot(c + 1);
      dn = decay(c + 1);
    }
    float in[kVec];
    Word out;
    float* o = reinterpret_cast<float*>(&out);
    const float* ch = reinterpret_cast<const float*>(&cur);
    const float ex = expf(dl);
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      o[v] = st[v];
      in[v] = ch[v];
      st[v] = st[v] * ex + in[v];
    }
    *slot(c) = out;
    cur = nxt;
    dl = dn;
  }
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int e = e0 + v, n = e / P, p = e - n * P;
    final_state[(static_cast<size_t>(bh) * P + p) * N + n] = st[v];
  }
}

// Launch 3: one block per (head, (chunk, 128-row tile, 64-column tile),
// sequence): y of its rows and columns, (G o seg) xdt over the causal
// columns plus (C exp(la)) state_in.
template <typename T>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
ssd_output_kernel(const T* __restrict__ x, const T* __restrict__ Cm,
                  const float* __restrict__ dt,
                  const float* __restrict__ states,
                  const float* __restrict__ gt,
                  const float* __restrict__ la_in, T* __restrict__ y, int S,
                  int H, int P, int N, int Q, int n_qt, int n_pt) {
  __shared__ __align__(16) float smem[2 * kStage];
  __shared__ float sLa[kMaxQ];
  const int h = blockIdx.x, b = blockIdx.z;
  const int per = n_qt * n_pt;
  const int c = blockIdx.y / per, r = blockIdx.y % per;
  const int q0 = (r / n_pt) * kTM, p0 = (r % n_pt) * kTN;
  const int nc = gridDim.y / per;
  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int Lc = min(Q, S - c * Q);
  if (q0 >= Lc) return;   // the whole block: a tile past a short chunk
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
  for (int s = tid; s < Lc; s += kThreads) sLa[s] = la_in[bch * Q + s];
  __syncthreads();
  float acc[8][8] = {};
  // the warp's rows q0 + 32 w .. + 31: stages past them are all zero
  const int k_last = q0 + 32 * (tid >> 5) + 31;

  // intra-chunk: A[s][q] = G[q][s] exp(la[q] - la[s]) for s <= q (4 words
  // a thread: row u / 32, columns 4 (u % 32) ..); B[s][p] = xdt[s][p]
  // (2 words: row u / 16, columns 4 (u % 16) ..)
  const float* g = gt + (static_cast<size_t>(b) * nc + c) * Q * Q;
  {
    float ra[4][4], rdt[2];
    T rb[2][4];
    int kcur = 0;
    auto fetch = [&](int k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = tid + kThreads * i, s = k + u / 32,
                  q = q0 + 4 * (u % 32);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ra[i][e] = s < Lc && q + e < Lc && s <= q + e
                         ? g[static_cast<size_t>(s) * Q + q + e]
                         : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = tid + kThreads * i, s = k + u / 16,
                  p = p0 + 4 * (u % 16);
        const size_t rr = (row0 + s) * H + h;
        rdt[i] = s < Lc ? dt[rr] : 0.0f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rb[i][e] = s < Lc && p + e < P ? x[rr * P + p + e]
                                         : zero<T>();
      }
    };
    auto put = [&](float* sA, float* sB) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = tid + kThreads * i, s = kcur + u / 32,
                  q = q0 + 4 * (u % 32);
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = s < Lc && q + e < Lc && s <= q + e
                     ? ra[i][e] * expf(sLa[q + e] - sLa[s])
                     : 0.0f;
        st4(sA + (u / 32) * kTM + 4 * (u % 32), v);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = tid + kThreads * i;
        const float v[4] = {to_f(rb[i][0]) * rdt[i], to_f(rb[i][1]) * rdt[i],
                            to_f(rb[i][2]) * rdt[i], to_f(rb[i][3]) * rdt[i]};
        st4(sB + (u / 16) * kTN + 4 * (u % 16), v);
      }
      kcur += kKB;
    };
    staged_product(acc, smem, 0, min(Lc, q0 + kTM), k_last, ty, tx, fetch,
                   put);
  }
  // inter-chunk: A[n][q] = C[q][n] exp(la[q]) (row r + 32 i and 4 n from
  // n0 a thread and word, so 4 threads read a row's 16 n of the stage
  // together); B[n][p] = state_in[n][p] (2 words: row u / 16, columns
  // 4 (u % 16) ..)
  {
    const float* s_in = states + bch * N * P;
    const int r = tid >> 2, n0 = 4 * (tid & 3);
    float eq[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + r + 32 * i;
      eq[i] = q < Lc ? expf(sLa[q]) : 0.0f;
    }
    T ra[4][4];
    float rb[2][4];
    auto fetch = [&](int k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + r + 32 * i;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ra[i][e] = q < Lc && k + n0 + e < N
                         ? Cm[(row0 + q) * N + k + n0 + e]
                         : zero<T>();
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = tid + kThreads * i, n = k + u / 16,
                  p = p0 + 4 * (u % 16);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          rb[i][e] = n < N && p + e < P
                         ? s_in[static_cast<size_t>(n) * P + p + e]
                         : 0.0f;
      }
    };
    auto put = [&](float* sA, float* sB) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sA[(n0 + e) * kTM + r + 32 * i] = to_f(ra[i][e]) * eq[i];
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int u = tid + kThreads * i;
        st4(sB + (u / 16) * kTN + 4 * (u % 16), rb[i]);
      }
    };
    staged_product(acc, smem, 0, N, INT_MAX, ty, tx, fetch, put);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int qq = q0 + 8 * ty + i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = p0 + col_of(j, tx);
      if (qq < Lc && p < P) stf(y + ((row0 + qq) * H + h) * P + p, acc[i][j]);
    }
  }
}

template <typename T>
int launch(const void* x, const void* Bm, const void* Cm, const void* dt,
           const void* a_log, void* y, void* final_state, void* states,
           void* gt, void* la, void* la_last, int B, int S, int H, int P,
           int N, int Q, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || P > 128 || N <= 0 || N > 128
      || Q <= 0 || Q > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int nc = (S + Q - 1) / Q;
  const int n_qt = (Q + kTM - 1) / kTM;
  const int n_pt = (P + kTN - 1) / kTN;
  // G's causal tiles: s-tile st (128 rows) with the 64-column q tiles from
  // 2 st on
  const int n_q64 = (Q + kTN - 1) / kTN;
  int n_g = 0;
  for (int st_ = 0; st_ * kTM < Q; ++st_) n_g += n_q64 - 2 * st_;
  const auto* xt = static_cast<const T*>(x);
  const auto* bt = static_cast<const T*>(Bm);
  const auto* ct = static_cast<const T*>(Cm);
  const auto* dtf = static_cast<const float*>(dt);
  auto* sf = static_cast<float*>(states);
  auto* gf = static_cast<float*>(gt);
  auto* laf = static_cast<float*>(la);
  auto* llf = static_cast<float*>(la_last);
  ssd_chunk_state_kernel<T><<<dim3(H * n_pt + n_g, nc, B), kThreads, 0, st>>>(
      xt, bt, ct, dtf, static_cast<const float*>(a_log), sf, gf, laf, llf, S,
      H, P, N, Q, n_pt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * H * N * P;
  auto* fs = static_cast<float*>(final_state);
  if ((N * P) % 4 == 0)
    ssd_state_pass_kernel<4>
        <<<static_cast<unsigned>((total / 4 + 255) / 256), 256, 0, st>>>(
            sf, llf, fs, nc, H, P, N, total);
  else
    ssd_state_pass_kernel<1>
        <<<static_cast<unsigned>((total + 255) / 256), 256, 0, st>>>(
            sf, llf, fs, nc, H, P, N, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<T><<<dim3(H, nc * n_qt * n_pt, B), kThreads, 0, st>>>(
      xt, ct, dtf, sf, gf, laf, static_cast<T*>(y), S, H, P, N, Q, n_qt,
      n_pt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xh [B, S, H, P], Bm / Cm [B, S, N] in one dtype; dt, a_log [B, S, H]
// float32; y [B, S, H, P] in xh's dtype; final_state [B, H, P, N] float32;
// float32 scratch states [B, nc, H, N, P], gt [B, nc, Q, Q], la
// [B, nc, H, Q], la_last [B, nc, H] (nc = ceil(S / Q)).  Three launches on
// `stream`; returns the first failing one's cudaError_t (0 on success).
extern "C" int ssd_scan_f32(const void* xh, const void* Bm, const void* Cm,
                            const void* dt, const void* a_log, void* y,
                            void* final_state, void* states, void* gt,
                            void* la, void* la_last, int B, int S, int H,
                            int P, int N, int Q, void* stream) {
  return launch<float>(xh, Bm, Cm, dt, a_log, y, final_state, states, gt, la,
                       la_last, B, S, H, P, N, Q, stream);
}

extern "C" int ssd_scan_bf16(const void* xh, const void* Bm, const void* Cm,
                             const void* dt, const void* a_log, void* y,
                             void* final_state, void* states, void* gt,
                             void* la, void* la_last, int B, int S, int H,
                             int P, int N, int Q, void* stream) {
  return launch<__nv_bfloat16>(xh, Bm, Cm, dt, a_log, y, final_state, states,
                               gt, la, la_last, B, S, H, P, N, Q, stream);
}
