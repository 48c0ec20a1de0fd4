// Flash-decode GQA attention: one new query token over a KV cache.
//
// Replaces the TPU kernel `decode_attn_pallas`
// (src/repro/kernels/decode_attn/decode_attn.py:72, body
// `_decode_attn_kernel` :31), whose oracle is the serving path's
// `models.attention.decode_attention` (src/repro/models/attention.py:193).
//
// What it computes, for each sequence b and query head h = kv*G + g
// (G = H / KV query heads share the kv-head kv):
//
//   s[t]    = (q[b,h,:] . k[b,t,kv,:]) * D^-0.5   where slot t is live:
//             cache_pos[t] >= 0, cache_pos[t] <= pos and, with a sliding
//             window, cache_pos[t] > pos - window; NEG = -3e38 elsewhere
//   out[b,h,:] = sum_t softmax(s)[t] * v[b,t,kv,:]
//
// float32 or bfloat16 in, float32 arithmetic throughout, output in q's
// dtype.  The softmax is taken online over tiles of the cache: a running
// max m, sum l and accumulator acc[G][D] per (b, kv), rescaled by
// exp(m_old - m_new) as the max grows; out = acc / max(l, 1e-30).  A slot
// that is masked adds exp(NEG - m) = 0 once any slot is live; if none is,
// every slot weighs 1, the uniform average the oracle's softmax over -1e30
// gives too.  The oracle rounds the probabilities to q's dtype before the
// PV product and this kernel keeps them in float32, so bf16 agrees to
// 2e-2 and float32 to 2e-5, not bit for bit.
//
// Bound: bytes.  Per call the kernel must read K and V once
// (2 * B*T*KV*D elements: 2.62 MB in bf16 at qwen3-4b's B = 4, T = 256,
// KV = 8, D = 80), q, cache_pos, and write out; it does about 4 operations
// per cache element per query head of the group (dot product and PV), with
// G = 4 that is about 4 operations per byte, below the card's balance
// point.  2.66 MB is 0.79 us at 3.35 TB/s: at the serving path's size the
// launch and the serial tile loop, not the bytes, set the time.
//
// Design against that bound: one block per (b, kv-head), so the G queries
// of a group share every K/V row the block loads (K and V cross device
// memory once).  A loop over T tiles of 32 slots takes the place of the
// TPU grid's sequential T axis: a tile of K and V is staged in shared
// memory as float32 (K rows padded by one word against bank conflicts),
// one thread per (g, t) computes a score, one warp per g updates the
// running max and sum, and one thread per (g, d) updates the accumulator.
// D need not be a power of two (qwen3-4b has D = 80).  There is no split
// of T over blocks (no second pass): at T = 256 that leaves B*KV = 32 of
// 132 SMs busy, and splitting T is the first step to make it fast.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;
constexpr float kNeg = -3.0e38f;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Dynamic shared memory of one block, in floats.
__host__ __device__ inline size_t smem_floats(int G, int D) {
  return static_cast<size_t>(G) * D * 2          // q, acc
         + static_cast<size_t>(kTile) * (D + 1)  // K tile (padded rows)
         + static_cast<size_t>(kTile) * D        // V tile
         + static_cast<size_t>(G) * kTile        // scores / probabilities
         + static_cast<size_t>(G) * 3;           // m, l, rescale
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const int* __restrict__ cache_pos,
                   T* __restrict__ out, int Tn, int H, int KV, int D, int pos,
                   int window) {
  extern __shared__ __align__(16) float smem[];
  const int G = H / KV;
  const int b = blockIdx.x / KV;
  const int kv = blockIdx.x % KV;
  const int Dp = D + 1;
  float* sQ = smem;                       // [G][D]
  float* sAcc = sQ + G * D;               // [G][D]
  float* sK = sAcc + G * D;               // [kTile][D + 1]
  float* sV = sK + kTile * Dp;            // [kTile][D]
  float* sS = sV + kTile * D;             // [G][kTile]
  float* sM = sS + G * kTile;             // [G]
  float* sL = sM + G;                     // [G]
  float* sCorr = sL + G;                  // [G]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(D)));

  const size_t q0 = (static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G)
                    * D;
  for (int i = tid; i < G * D; i += kThreads) {
    sQ[i] = to_float(q[q0 + i]);
    sAcc[i] = 0.0f;
  }
  for (int g = tid; g < G; g += kThreads) {
    sM[g] = kNeg;
    sL[g] = 0.0f;
  }
  __syncthreads();

  for (int t0 = 0; t0 < Tn; t0 += kTile) {
    const int n = min(kTile, Tn - t0);
    for (int i = tid; i < n * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const size_t off =
          ((static_cast<size_t>(b) * Tn + t0 + t) * KV + kv) * D + d;
      sK[t * Dp + d] = to_float(k[off]);
      sV[t * D + d] = to_float(v[off]);
    }
    __syncthreads();
    // scores: one thread per (g, t)
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, t = i % kTile;
      float s = -CUDART_INF_F;            // beyond the cache: weighs 0
      if (t < n) {
        const int c = cache_pos[t0 + t];
        bool ok = c >= 0 && c <= pos;
        if (window > 0) ok = ok && c > pos - window;
        if (ok) {
          float dot = 0.0f;
          const float* qg = sQ + g * D;
          const float* kt = sK + t * Dp;
          for (int d = 0; d < D; ++d) dot += qg[d] * kt[d];
          s = dot * scale;
        } else {
          s = kNeg;
        }
      }
      sS[i] = s;
    }
    __syncthreads();
    // online softmax: one warp per query head of the group
    for (int g = warp; g < G; g += kWarps) {
      float* sg = sS + g * kTile;
      float mt = -CUDART_INF_F;
      for (int t = lane; t < kTile; t += 32) mt = fmaxf(mt, sg[t]);
      for (int off = 16; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = sM[g];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.0f;
      for (int t = lane; t < kTile; t += 32) {
        const float p = expf(sg[t] - m_new);
        sg[t] = p;
        sum += p;
      }
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        sL[g] = sL[g] * corr + sum;
        sM[g] = m_new;
        sCorr[g] = corr;
      }
    }
    __syncthreads();
    // accumulator: one thread per (g, d)
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pg = sS + g * kTile;
      float a = sAcc[i] * sCorr[g];
      for (int t = 0; t < n; ++t) a += pg[t] * sV[t * D + d];
      sAcc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    out[q0 + i] = from_float<T>(sAcc[i] / fmaxf(sL[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cache_pos,
           void* out, int B, int Tn, int H, int KV, int D, int pos,
           int window, void* stream) {
  if (B <= 0 || Tn <= 0 || KV <= 0 || D <= 0 || H % KV != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats(H / KV, D) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  decode_attn_kernel<T><<<B * KV, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(cache_pos),
      static_cast<T*>(out), Tn, H, KV, D, pos, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, D]; k, v [B, T, KV, D]; cache_pos [T] int32; out [B, H, D] in
// q's dtype.  window <= 0 means full attention.  Returns the launch's
// cudaError_t (0 on success).
extern "C" int decode_attn_f32(const void* q, const void* k, const void* v,
                               const void* cache_pos, void* out, int B, int T,
                               int H, int KV, int D, int pos, int window,
                               void* stream) {
  return launch<float>(q, k, v, cache_pos, out, B, T, H, KV, D, pos, window,
                       stream);
}

extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v,
                                const void* cache_pos, void* out, int B,
                                int T, int H, int KV, int D, int pos,
                                int window, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cache_pos, out, B, T, H, KV, D, pos,
                               window, stream);
}
