// The Mamba-2 decode step's recurrent core (B14): one token a row through
// one SSM layer, from the in_proj output to the gated y the mixer's
// rmsnorm takes, the conv cache and the float32 state updated in place.
//
// Replaces no TPU kernel: it computes the middle of the reference's
// `ssm_decode_step` (src/repro/models/ssm.py:197-224), which the reference
// leaves to XLA as plain jnp.  It exists because that step is the serving
// path of every SSM layer, where the port's plain version ran it as ~37
// eager PyTorch operations with ~8 passes over the float32 state.
//
// What it computes for row b, zxbcdt = [z (di) | conv_in (C = di + 2N) |
// dt_raw (H)], di = H P, T the activation dtype (float32 or bfloat16):
//
//   conv[c]   = T(sum_{i<w} f32(hist[i][c]) * f32(conv_w[i][c])) + conv_b[c]
//               hist = [cache (w-1 rows) ; conv_in], the sum from 0 in
//               order i = 0 .. w-1, the add in float32 rounded to T
//   u[c]      = T(silu(f32(conv[c])))              u = [x (di) | B (N) | C (N)]
//   cache     <- hist[1:]
//   dt[h]     = softplus(f32(dt_raw[h]) + dt_bias[h])      (logaddexp(., 0))
//   a[h]      = exp(-exp(A_log[h]) * dt[h])
//   state[h,p,n] <- state[h,p,n] * a[h] + (x[h,p] * dt[h]) * B[n]
//   y[h,p]    = T(sum_n C[n] state[h,p,n] + x[h,p] * D[h])
//   out[h,p]  = T(y[h,p] * T(silu(f32(z[h,p]))))
//
// with the plain version's rounding points: every product and sum rounded
// apart (`__fmul_rn` / `__fadd_rn`, built with -fmad=false besides), silu
// as x / (1 + exp(-x)) and softplus as max(v, 0) + log1p(exp(-|v|)), as
// PyTorch computes them, so the state and the conv cache come out equal to
// the plain version's; y's sum over N runs in the order below, not
// cuBLAS's.
//
// Bound: bytes.  At mamba2-1.3b's 256 rows (H = 64, P = 64, N = 128, w = 4)
// the float32 state read and written is 1.074 GB of the call's 1.094 GB
// (the conv tail read and written, z, the conv inputs and dt read, the
// gated y written, the conv weights and per-head vectors): 0.3265 ms at
// 3.35 TB/s.  The operations (~5 a state element) are 0.7 GFLOP, nothing
// beside them.  The design streams the state once:
//
// 1. `ssm_decode_conv`, a thread a (row, channel): the conv over the
//    cached taps and the new input, the cache's shift (the thread owns its
//    channel's taps, so the in-place shift cannot race), silu, into the
//    scratch row u [B, C] (4.5 MB at that shape).  B and C are conv
//    channels that every head of a row reads, so the state pass cannot
//    shift them itself: this launch runs first.
// 2. `ssm_decode_state`, a block of 128 threads a (row, head): a state row of
//    N floats lies on L = min(32, N/4) lanes as 16-byte words (CH = N/4L
//    words a lane), neighbouring lanes on neighbouring addresses; a warp
//    holds 32/L rows at once.  A thread starts all its streaming loads
//    (`ld.global.cs`) of a batch (16 words, 256 bytes) before it uses
//    one, and writes each back by a streaming store (`st.global.cs`): the
//    state is touched once a step, and the hint keeps it from evicting the
//    rows' u, z and the weights from L2.  Each element is read once and
//    written once by the same thread.  B and C are a lane's own words of
//    the row, in registers, loaded once a block; dt and a are computed by
//    every thread (three transcendentals).  y's contraction over N: each
//    lane sums its 4 CH products in order, then the row's L lanes by an
//    xor butterfly of warp shuffles (lanes l and l + L/2 first), a fixed
//    order (ref.py's `ssm_decode_mirror` repeats it).  16,384 blocks at
//    that shape, four an SM by the register bound (128 a thread), so each
//    SM keeps ~128 KB of loads in flight.
//
// Two launches a call, one C entry point.  Takes N in {16, 32, 64, 128,
// 256}, a conv of 1..8 taps, B < 2^16 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;        // state pass: 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 16;           // 16-byte state words a thread a batch
constexpr int kConvThreads = 256;    // conv step: a thread a channel
constexpr int kMaxConv = 8;          // conv taps held in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 round_to<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// PyTorch's silu: x / (1 + exp(-x)), each step rounded
__device__ __forceinline__ float silu(float x) {
  return __fdiv_rn(x, __fadd_rn(1.0f, expf(-x)));
}

// Launch 1: the conv step of channel c of row b (blockIdx.y), its cache
// shifted, silu, into u.
template <typename T>
__global__ void __launch_bounds__(kConvThreads)
    ssm_decode_conv(const T* __restrict__ zxbcdt, T* __restrict__ cache,
                     const T* __restrict__ conv_w,
                     const T* __restrict__ conv_b, T* __restrict__ u, int di,
                     int C, int w, int row) {
  const int c = blockIdx.x * kConvThreads + threadIdx.x;
  if (c >= C) return;
  const int b = blockIdx.y;
  T* tail = cache + static_cast<size_t>(b) * (w - 1) * C + c;
  const T cur = zxbcdt[static_cast<size_t>(b) * row + di + c];
  T hist[kMaxConv];
#pragma unroll
  for (int i = 0; i < kMaxConv; ++i) {
    if (i < w - 1) hist[i] = tail[static_cast<size_t>(i) * C];
  }
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < kMaxConv; ++i) {
    if (i < w) {
      const T v = i < w - 1 ? hist[i] : cur;
      acc = __fadd_rn(acc, __fmul_rn(to_f(v), to_f(conv_w[static_cast<size_t>(i) * C + c])));
    }
  }
#pragma unroll
  for (int i = 0; i + 1 < kMaxConv; ++i) {
    if (i < w - 1) tail[static_cast<size_t>(i) * C] = i + 1 < w - 1 ? hist[i + 1] : cur;
  }
  const float v = to_f(round_to<T>(__fadd_rn(to_f(round_to<T>(acc)),
                                             to_f(conv_b[c]))));
  u[static_cast<size_t>(b) * C + c] = round_to<T>(silu(v));
}

// Starts the streaming loads of a batch: the words of row passes k0 ..
// k0 + U - 1 that this thread holds.
template <int U, int CH, int L, int RB, int NV>
__device__ __forceinline__ void load_words(float4 (&hv)[U][CH],
                                           const float4* st, int k0,
                                           int passes, int P, int r0,
                                           int sl) {
#pragma unroll
  for (int k = 0; k < U; ++k) {
    const int p = (k0 + k) * RB + r0;
    if (k0 + k < passes && p < P) {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        hv[k][c] = __ldcs(st + static_cast<size_t>(p) * NV + c * L + sl);
    }
  }
}

// Launch 2: the state rows of head h of row b (blockIdx.x = b H + h), y,
// and its gate.  NV = N / 4 words a state row.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, 4)
    ssm_decode_state(const T* __restrict__ zxbcdt, const T* __restrict__ u,
                 float* __restrict__ state, const float* __restrict__ A_log,
                 const float* __restrict__ Dh,
                 const float* __restrict__ dt_bias, T* __restrict__ out,
                 int H, int P, int row) {
  constexpr int N = 4 * NV;
  constexpr int L = NV < 32 ? NV : 32;   // lanes of a state row
  constexpr int CH = NV / L;             // words a lane of a row
  constexpr int R = 32 / L;              // rows a warp holds at once
  constexpr int RB = kWarps * R;         // rows a block holds at once
  constexpr int U = kWords / CH;         // row passes a batch
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int di = H * P;
  const int lane = threadIdx.x & 31;
  const int sl = lane % L;
  const int r0 = (threadIdx.x >> 5) * R + lane / L;
  const int passes = (P + RB - 1) / RB;
  float4* st = reinterpret_cast<float4*>(state) + static_cast<size_t>(bh) * P * NV;
  const T* urow = u + static_cast<size_t>(b) * (di + 2 * N);
  const T* zrow = zxbcdt + static_cast<size_t>(b) * row;

  float4 hv[U][CH];
  load_words<U, CH, L, RB, NV>(hv, st, 0, passes, P, r0, sl);

  const float v = __fadd_rn(to_f(zrow[2 * di + 2 * N + h]), dt_bias[h]);
  const float dt = __fadd_rn(fmaxf(v, 0.0f), log1pf(expf(-fabsf(v))));
  const float a = expf(__fmul_rn(-expf(A_log[h]), dt));
  const float d = Dh[h];
  float Bv[CH][4], Cv[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * (c * L + sl) + j;
      Bv[c][j] = to_f(urow[di + n]);
      Cv[c][j] = to_f(urow[di + N + n]);
    }
  }

  for (int k0 = 0; k0 < passes; k0 += U) {
    if (k0) load_words<U, CH, L, RB, NV>(hv, st, k0, passes, P, r0, sl);
    float part[U], xs[U];
#pragma unroll
    for (int k = 0; k < U; ++k) {
      const int p = (k0 + k) * RB + r0;
      part[k] = 0.0f;
      xs[k] = 0.0f;
      if (k0 + k < passes && p < P) {
        const float x = to_f(urow[h * P + p]);
        const float xdt = __fmul_rn(x, dt);
        float acc = 0.0f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 s = hv[k][c];
          float4 o;
          o.x = __fadd_rn(__fmul_rn(s.x, a), __fmul_rn(xdt, Bv[c][0]));
          o.y = __fadd_rn(__fmul_rn(s.y, a), __fmul_rn(xdt, Bv[c][1]));
          o.z = __fadd_rn(__fmul_rn(s.z, a), __fmul_rn(xdt, Bv[c][2]));
          o.w = __fadd_rn(__fmul_rn(s.w, a), __fmul_rn(xdt, Bv[c][3]));
          __stcs(st + static_cast<size_t>(p) * NV + c * L + sl, o);
          acc = __fadd_rn(acc, __fmul_rn(Cv[c][0], o.x));
          acc = __fadd_rn(acc, __fmul_rn(Cv[c][1], o.y));
          acc = __fadd_rn(acc, __fmul_rn(Cv[c][2], o.z));
          acc = __fadd_rn(acc, __fmul_rn(Cv[c][3], o.w));
        }
        part[k] = acc;
        xs[k] = x;
      }
    }
    // every lane of the warp takes part: the loop bounds are the block's
#pragma unroll
    for (int k = 0; k < U; ++k) {
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        part[k] = __fadd_rn(part[k], __shfl_xor_sync(0xffffffffu, part[k], o));
    }
    if (sl == 0) {
#pragma unroll
      for (int k = 0; k < U; ++k) {
        const int p = (k0 + k) * RB + r0;
        if (k0 + k < passes && p < P) {
          const T y = round_to<T>(__fadd_rn(part[k], __fmul_rn(xs[k], d)));
          const T g = round_to<T>(silu(to_f(zrow[h * P + p])));
          out[static_cast<size_t>(b) * di + h * P + p] =
              round_to<T>(__fmul_rn(to_f(y), to_f(g)));
        }
      }
    }
  }
}

template <typename T, int NV>
cudaError_t launch_state(int B, int H, int P, int row, const T* zxbcdt,
                         const T* u, float* state, const float* A_log,
                         const float* D, const float* dt_bias, T* out,
                         cudaStream_t st) {
  ssm_decode_state<T, NV><<<static_cast<unsigned>(B) * H, kThreads, 0, st>>>(
      zxbcdt, u, state, A_log, D, dt_bias, out, H, P, row);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* zxbcdt_, void* conv_, void* state_,
           const void* conv_w_, const void* conv_b_, const void* A_log,
           const void* D, const void* dt_bias, void* u_, void* out_, int B,
           int H, int P, int N, int w, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto zxbcdt = static_cast<const T*>(zxbcdt_);
  const auto u = static_cast<T*>(u_);
  const auto out = static_cast<T*>(out_);
  const auto state = static_cast<float*>(state_);
  const auto a_log = static_cast<const float*>(A_log);
  const auto d = static_cast<const float*>(D);
  const auto bias = static_cast<const float*>(dt_bias);
  if (w < 1 || w > kMaxConv) return cudaErrorInvalidValue;
  const int di = H * P;
  const int C = di + 2 * N;
  const int row = 2 * di + 2 * N + H;
  ssm_decode_conv<T><<<dim3((C + kConvThreads - 1) / kConvThreads, B),
                        kConvThreads, 0, st>>>(
      zxbcdt, static_cast<T*>(conv_), static_cast<const T*>(conv_w_),
      static_cast<const T*>(conv_b_), u, di, C, w, row);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (N) {
    case 16:
      return launch_state<T, 4>(B, H, P, row, zxbcdt, u, state, a_log, d, bias, out, st);
    case 32:
      return launch_state<T, 8>(B, H, P, row, zxbcdt, u, state, a_log, d, bias, out, st);
    case 64:
      return launch_state<T, 16>(B, H, P, row, zxbcdt, u, state, a_log, d, bias, out, st);
    case 128:
      return launch_state<T, 32>(B, H, P, row, zxbcdt, u, state, a_log, d, bias, out, st);
    case 256:
      return launch_state<T, 64>(B, H, P, row, zxbcdt, u, state, a_log, d, bias, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// zxbcdt [B, 1, 2 di + 2N + H], conv cache [B, w-1, di + 2N], state
// [B, H, P, N] float32, conv_w [w, di + 2N], conv_b [di + 2N], A_log, D,
// dt_bias [H] float32, scratch u [B, di + 2N], out [B, 1, di] | B, H, P, N,
// w | stream.  Two launches on the stream.
extern "C" int ssm_decode_f32(const void* zxbcdt, void* conv, void* state,
                              const void* conv_w, const void* conv_b,
                              const void* A_log, const void* D,
                              const void* dt_bias, void* u, void* out, int B,
                              int H, int P, int N, int w, void* stream) {
  return launch<float>(zxbcdt, conv, state, conv_w, conv_b, A_log, D, dt_bias,
                       u, out, B, H, P, N, w, stream);
}

extern "C" int ssm_decode_bf16(const void* zxbcdt, void* conv, void* state,
                               const void* conv_w, const void* conv_b,
                               const void* A_log, const void* D,
                               const void* dt_bias, void* u, void* out, int B,
                               int H, int P, int N, int w, void* stream) {
  return launch<__nv_bfloat16>(zxbcdt, conv, state, conv_w, conv_b, A_log, D,
                               dt_bias, u, out, B, H, P, N, w, stream);
}
