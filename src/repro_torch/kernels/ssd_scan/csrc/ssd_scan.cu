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
//    (head, 64 rows of N) computes its chunk state as a float32 tile
//    product (xdt * decay)^T B over the chunk's rows, after a block scan
//    of the chunk's log decays (which it keeps for launch 3); further
//    blocks of the same grid compute G = C B^T once per (b, chunk), in
//    64 x 64 tiles of its causal half, for all heads.
// 2. The sequential pass over chunks, in parallel over (b, h, N, P):
//    state <- state * exp(la_last) + chunk state, leaving in each chunk's
//    slot the state that enters it, and the final state.
// 3. The chunk outputs, in parallel over (b, chunk, head, 64 rows):
//    (G o seg) xdt over the causal columns plus (C exp(la)) state_in, one
//    float32 accumulator, rounded once.
//
// Each product is a 64 x (up to 128) tile of a block of 256 threads, a
// 4 x 8 register tile a thread, its operands staged through shared memory
// 32 rows deep (k-major, padded against bank conflicts).  The scratch is
// every chunk's state, [B, n_chunks, H, N, P] float32 (33.5 MB at the
// 4,096-token prefill), G [B, n_chunks, Q, Q] and the log decays.
//
// Takes Q <= 256, P <= 128, N <= 128 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // output rows of a block
constexpr int kKB = 32;             // depth of a staged k-block
constexpr int kMaxQ = 256;          // a chunk's decays: one a thread
constexpr int kLdA = kTile + 1;     // k-major A rows, padded
constexpr int kLdB = 128 + 1;       // k-major B rows (<= 128 columns)

__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void stf(float* p, float x) { *p = x; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// acc[i][j] (rows ty + 16 i, columns tx + 16 j, j < nj) += sum over the
// first `depth` k of sA[k][row] * sB[k][column].
__device__ __forceinline__ void tile_fma(float (&acc)[4][8], const float* sA,
                                         const float* sB, int depth, int nj,
                                         int ty, int tx) {
  for (int kk = 0; kk < depth; ++kk) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = sA[kk * kLdA + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      b[j] = j < nj ? sB[kk * kLdB + tx + 16 * j] : 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < nj) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }
}

// sLa[s] = a[0] + ... + a[s] for s < Lc (a[s] = a_log_h[s * H]), by a
// block scan (one row a thread).
__device__ __forceinline__ void chunk_cumsum(const float* a_log_h, int H,
                                             int Lc, float* sLa,
                                             float* sWarp) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float x = tid < Lc ? a_log_h[static_cast<size_t>(tid) * H] : 0.0f;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) sWarp[warp] = x;
  __syncthreads();
  float pre = 0.0f;
  for (int w = 0; w < warp; ++w) pre += sWarp[w];
  sLa[tid] = x + pre;
  __syncthreads();
}

// Launch 1: blocks x < H * n_nt take the chunk state of head x / n_nt for
// state rows n in [64 (x % n_nt), +64): states[b, c, h, n, p]; the others
// a 64 x 64 tile (s rows, q columns) of G's causal half: gt[b, c, s, q] =
// C[q] . B[s].  blockIdx.y is the chunk, blockIdx.z the sequence.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                       const T* __restrict__ Cm, const float* __restrict__ dt,
                       const float* __restrict__ a_log,
                       float* __restrict__ states, float* __restrict__ gt,
                       float* __restrict__ la_out,
                       float* __restrict__ la_last_out, int S, int H, int P,
                       int N, int Q, int n_nt) {
  __shared__ float sA[kKB * kLdA];
  __shared__ float sB[kKB * kLdB];
  __shared__ float sLa[kMaxQ];
  __shared__ float sWarp[kThreads / 32];
  const int c = blockIdx.y, b = blockIdx.z, nc = gridDim.y;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int Lc = min(Q, S - c * Q);
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  float acc[4][8] = {};
  if (static_cast<int>(blockIdx.x) < H * n_nt) {
    const int h = blockIdx.x / n_nt, n0 = (blockIdx.x % n_nt) * kTile;
    chunk_cumsum(a_log + row0 * H + h, H, Lc, sLa, sWarp);
    const float la_last = sLa[Lc - 1];
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    if (n0 == 0) {
      for (int s = tid; s < Q; s += kThreads)
        la_out[bch * Q + s] = s < Lc ? sLa[s] : la_last;
      if (tid == 0) la_last_out[bch] = la_last;
    }
    const int nj = (P + 15) / 16;
    for (int k0 = 0; k0 < Lc; k0 += kKB) {
      // A[kk][n] = B[s][n0 + n]; B[kk][p] = xdt[s][p] * exp(la_last - la[s])
      for (int i = tid; i < kKB * kTile; i += kThreads) {
        const int kk = i / kTile, n = i - kk * kTile, s = k0 + kk;
        sA[kk * kLdA + n] = s < Lc && n0 + n < N
                                ? ldf(Bm + (row0 + s) * N + n0 + n)
                                : 0.0f;
      }
      for (int i = tid; i < kKB * nj * 16; i += kThreads) {
        const int kk = i / (nj * 16), p = i - kk * nj * 16, s = k0 + kk;
        float val = 0.0f;
        if (s < Lc && p < P) {
          const size_t r = (row0 + s) * H + h;
          val = ldf(x + r * P + p) * dt[r] * expf(la_last - sLa[s]);
        }
        sB[kk * kLdB + p] = val;
      }
      __syncthreads();
      tile_fma(acc, sA, sB, min(kKB, Lc - k0), nj, ty, tx);
      __syncthreads();
    }
    float* dst = states + bch * N * P;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int n = n0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = tx + 16 * j;
        if (n < N && j < nj && p < P)
          dst[static_cast<size_t>(n) * P + p] = acc[i][j];
      }
    }
  } else {
    // the causal tile (qt, st), st <= qt, of G
    int g = blockIdx.x - H * n_nt, qt = 0;
    while (g > qt) {
      g -= qt + 1;
      ++qt;
    }
    const int q0 = qt * kTile, sr0 = g * kTile;
    for (int k0 = 0; k0 < N; k0 += kKB) {
      // A[kk][s] = B[sr0 + s][k0 + kk]; B[kk][q] = C[q0 + q][k0 + kk]
      for (int i = tid; i < kKB * kTile; i += kThreads) {
        const int r = i / kKB, kk = i - r * kKB, n = k0 + kk;
        sA[kk * kLdA + r] = sr0 + r < Lc && n < N
                                ? ldf(Bm + (row0 + sr0 + r) * N + n)
                                : 0.0f;
        sB[kk * kLdB + r] = q0 + r < Lc && n < N
                                ? ldf(Cm + (row0 + q0 + r) * N + n)
                                : 0.0f;
      }
      __syncthreads();
      tile_fma(acc, sA, sB, min(kKB, N - k0), 4, ty, tx);
      __syncthreads();
    }
    float* dst = gt + (static_cast<size_t>(b) * nc + c) * Q * Q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = sr0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + tx + 16 * j;
        if (s < Lc && q < Lc) dst[static_cast<size_t>(s) * Q + q] = acc[i][j];
      }
    }
  }
}

// Launch 2: one thread an element (b, h, n, p) of the state, in order over
// the chunks: each chunk's slot takes the state entering the chunk, and
// final_state[b, h, p, n] the state after the last.
__global__ void __launch_bounds__(kThreads)
ssd_state_pass_kernel(float* __restrict__ states,
                      const float* __restrict__ la_last,
                      float* __restrict__ final_state, int nc, int H, int P,
                      int N, long long total) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int NP = N * P;
  const long long bh = i / NP;
  const int e = static_cast<int>(i - bh * NP);
  const int b = static_cast<int>(bh / H), h = static_cast<int>(bh % H);
  float st = 0.0f;
  for (int c = 0; c < nc; ++c) {
    const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
    float* slot = states + bch * NP + e;
    const float chunk = *slot;
    *slot = st;
    st = st * expf(la_last[bch]) + chunk;
  }
  const int n = e / P, p = e - n * P;
  final_state[(static_cast<size_t>(bh) * P + p) * N + n] = st;
}

// Launch 3: one block per (head, chunk x 64-row tile, sequence): y of its
// rows, (G o seg) xdt over the causal columns plus (C exp(la)) state_in.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_output_kernel(const T* __restrict__ x, const T* __restrict__ Cm,
                  const float* __restrict__ dt,
                  const float* __restrict__ states,
                  const float* __restrict__ gt,
                  const float* __restrict__ la_in, T* __restrict__ y, int S,
                  int H, int P, int N, int Q, int n_qt) {
  __shared__ float sA[kKB * kLdA];
  __shared__ float sB[kKB * kLdB];
  __shared__ float sLa[kMaxQ];
  const int h = blockIdx.x, b = blockIdx.z;
  const int c = blockIdx.y / n_qt, q0 = (blockIdx.y % n_qt) * kTile;
  const int nc = gridDim.y / n_qt;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int Lc = min(Q, S - c * Q);
  if (q0 >= Lc) return;   // the whole block: a tile past a short chunk
  const size_t row0 = static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
  const size_t bch = (static_cast<size_t>(b) * nc + c) * H + h;
  for (int s = tid; s < Lc; s += kThreads) sLa[s] = la_in[bch * Q + s];
  __syncthreads();
  const int nj = (P + 15) / 16;
  float acc[4][8] = {};
  // intra-chunk: A[kk][q] = G[q][s] exp(la[q] - la[s]) for s <= q;
  // B[kk][p] = xdt[s][p]
  const float* g = gt + (static_cast<size_t>(b) * nc + c) * Q * Q;
  const int s_end = min(Lc, q0 + kTile);
  for (int k0 = 0; k0 < s_end; k0 += kKB) {
    for (int i = tid; i < kKB * kTile; i += kThreads) {
      const int kk = i / kTile, q = i - kk * kTile, s = k0 + kk, qq = q0 + q;
      sA[kk * kLdA + q] =
          s < Lc && qq < Lc && s <= qq
              ? g[static_cast<size_t>(s) * Q + qq] * expf(sLa[qq] - sLa[s])
              : 0.0f;
    }
    for (int i = tid; i < kKB * nj * 16; i += kThreads) {
      const int kk = i / (nj * 16), p = i - kk * nj * 16, s = k0 + kk;
      float val = 0.0f;
      if (s < Lc && p < P) {
        const size_t r = (row0 + s) * H + h;
        val = ldf(x + r * P + p) * dt[r];
      }
      sB[kk * kLdB + p] = val;
    }
    __syncthreads();
    tile_fma(acc, sA, sB, min(kKB, s_end - k0), nj, ty, tx);
    __syncthreads();
  }
  // inter-chunk: A[kk][q] = C[q][n] exp(la[q]); B[kk][p] = state_in[n][p]
  const float* s_in = states + bch * N * P;
  for (int k0 = 0; k0 < N; k0 += kKB) {
    for (int i = tid; i < kKB * kTile; i += kThreads) {
      const int q = i / kKB, kk = i - q * kKB, n = k0 + kk, qq = q0 + q;
      sA[kk * kLdA + q] = qq < Lc && n < N
                              ? ldf(Cm + (row0 + qq) * N + n) * expf(sLa[qq])
                              : 0.0f;
    }
    for (int i = tid; i < kKB * nj * 16; i += kThreads) {
      const int kk = i / (nj * 16), p = i - kk * nj * 16, n = k0 + kk;
      sB[kk * kLdB + p] =
          n < N && p < P ? s_in[static_cast<size_t>(n) * P + p] : 0.0f;
    }
    __syncthreads();
    tile_fma(acc, sA, sB, min(kKB, N - k0), nj, ty, tx);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qq = q0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int p = tx + 16 * j;
      if (qq < Lc && j < nj && p < P)
        stf(y + ((row0 + qq) * H + h) * P + p, acc[i][j]);
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
  const int n_qt = (Q + kTile - 1) / kTile;
  const int n_nt = (N + kTile - 1) / kTile;
  const int n_g = n_qt * (n_qt + 1) / 2;
  const auto* xt = static_cast<const T*>(x);
  const auto* bt = static_cast<const T*>(Bm);
  const auto* ct = static_cast<const T*>(Cm);
  const auto* dtf = static_cast<const float*>(dt);
  auto* sf = static_cast<float*>(states);
  auto* gf = static_cast<float*>(gt);
  auto* laf = static_cast<float*>(la);
  auto* llf = static_cast<float*>(la_last);
  ssd_chunk_state_kernel<T><<<dim3(H * n_nt + n_g, nc, B), kThreads, 0, st>>>(
      xt, bt, ct, dtf, static_cast<const float*>(a_log), sf, gf, laf, llf, S,
      H, P, N, Q, n_nt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * H * N * P;
  ssd_state_pass_kernel<<<static_cast<unsigned>((total + kThreads - 1)
                                                / kThreads),
                          kThreads, 0, st>>>(
      sf, llf, static_cast<float*>(final_state), nc, H, P, N, total);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<T><<<dim3(H, nc * n_qt, B), kThreads, 0, st>>>(
      xt, ct, dtf, sf, gf, laf, static_cast<T*>(y), S, H, P, N, Q, n_qt);
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
