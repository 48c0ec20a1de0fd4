// Fused early-exit confidence gate: max softmax probability and argmax.
//
// Replaces the TPU kernel `ee_gate_pallas`
// (src/repro/kernels/ee_gate/ee_gate.py:60, body `_ee_gate_kernel` :28).
//
// What it computes, for each row b of a logits matrix [B, V] (float32 or
// bfloat16, a padded vocab tail may be -inf):
//
//   x        = max(logits[b, :], NEG)          (NEG = -3.0e38: -inf adds 0)
//   m        = max_v x[v]
//   conf[b]  = 1 / sum_v exp(x[v] - m)         (= exp(m - logsumexp x))
//   arg[b]   = the first v with x[v] == m      (int32)
//
// without writing the softmax anywhere.  The sum is carried flash-style: a
// running (max, sum) pair is rescaled by exp(m_old - m_new) when the max
// grows, and two partial pairs merge as s = s_a*exp(m_a - m) +
// s_b*exp(m_b - m).  The argmax keeps the lower index on a tie, which is
// the first occurrence that `jnp.argmax` and the TPU kernel's strict `>`
// across tiles give.  The sums run in another order than the reference's,
// so conf agrees to a relative 1e-5, not bit for bit; arg is exact.
//
// Bound: bytes.  A row is read once (V * 4 bytes in float32: 614,400 B at
// the qwen3-4b padded vocab of 153,600) and 8 bytes are written; the work
// is one compare, one subtract and one exp per element, about 3 operations
// per 4-byte element, far below the card's balance point.  At B = 4 the
// whole call moves 2.46 MB, 0.73 us at 3.35 TB/s.  So the card's memory
// rate, not one SM's, has to carry the call: at the serving B = 4 a block
// a row would leave 128 of 132 SMs idle.
//
// Design against that bound:
//   * Split.  Each row is cut into P contiguous slices of `per` elements
//     (a multiple of 8), one 256-thread block each; the wrapper's plan
//     (ops.gate_plan) takes P so that B*P is about one block an SM with at
//     least 2,048 elements a block: P = 33 at [4, 153,600], P = 1 once
//     B >= the SM count.
//   * Loads.  A block reads its slice as 16-byte vectors (4 float32 or 8
//     bf16 a thread a load), with a scalar head up to the first 16-byte
//     boundary and a scalar tail, so rows that are not 16-byte aligned
//     (V = 4097 in float32) work.  Each thread visits its elements in
//     ascending order and keeps its own (max, sum, first argmax); a warp
//     shuffle tree, then one over the block's warps, merges them.
//   * Merge.  With P > 1 each block writes its partial (m, s, a) to a
//     slot of a device-global scratch, fences, and counts itself in at
//     the row's arrival counter (atomicInc with the limit P - 1, so the
//     last arrival finds P - 1 and leaves the counter at 0 for the next
//     call).  The last block of the row reads the P partials and merges
//     them by index: M = the max of the m_p, arg = the lowest a_p with
//     m_p = M, s = sum_p s_p * exp(m_p - M) added in ascending block
//     order.  The shape of every merge is fixed, so a repeat call gives
//     the same bits, whichever block arrives last.  An empty slice is the
//     identity (NEG, 0, INT_MAX).
// The scratch is one per device: calls on one device must run in stream
// order (the port launches every gate on the device's current stream).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSplit = 256;     // blocks a row
constexpr int kMaxSlots = 8192;    // partials of one call (B * P)
constexpr int kMaxRows = 1024;     // rows of a split call
constexpr float kNeg = -3.0e38f;
constexpr int kNone = 0x7fffffff;

__device__ float g_part_m[kMaxSlots];
__device__ float g_part_s[kMaxSlots];
__device__ int g_part_a[kMaxSlots];
__device__ unsigned g_arrived[kMaxRows];

struct Gate {
  float m;  // running max
  float s;  // running sum of exp(x - m)
  int a;    // index of the first max (kNone: no element yet)
};

// Take element v of value x; a thread's first element always starts its
// state (so an all -inf row still yields its first index).
__device__ __forceinline__ void take(Gate& g, float x, int v) {
  const float xv = fmaxf(x, kNeg);
  if (xv > g.m || g.a == kNone) {      // strict: the first max stays
    g.s = g.s * expf(g.m - xv) + 1.0f;
    g.m = xv;
    g.a = v;
  } else {
    g.s += expf(xv - g.m);
  }
}

// Merge b into a; on an equal max the lower index wins.
__device__ __forceinline__ Gate merge(Gate a, Gate b) {
  const float m = fmaxf(a.m, b.m);
  Gate out;
  out.m = m;
  out.s = a.s * expf(a.m - m) + b.s * expf(b.m - m);
  out.a = a.m > b.m ? a.a : (b.m > a.m ? b.a : min(a.a, b.a));
  return out;
}

__device__ __forceinline__ Gate warp_merge(Gate g) {
  for (int off = 16; off > 0; off >>= 1) {
    Gate o;
    o.m = __shfl_down_sync(0xffffffffu, g.m, off);
    o.s = __shfl_down_sync(0xffffffffu, g.s, off);
    o.a = __shfl_down_sync(0xffffffffu, g.a, off);
    g = merge(g, o);
  }
  return g;
}

template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static float get(const uint4& w, int e) {
    const unsigned u = e == 0 ? w.x : e == 1 ? w.y : e == 2 ? w.z : w.w;
    return __uint_as_float(u);
  }
  __device__ __forceinline__ static float scalar(float x) { return x; }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static float get(const uint4& w, int e) {
    const unsigned u = (e >> 1) == 0 ? w.x : (e >> 1) == 1 ? w.y
                       : (e >> 1) == 2 ? w.z : w.w;
    // bf16 is the high half of a float32
    return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));
  }
  __device__ __forceinline__ static float scalar(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ee_gate_kernel(const T* __restrict__ logits, float* __restrict__ conf,
               int* __restrict__ arg, int V, int P, int per) {
  constexpr int kVec = Vec<T>::kN;
  const int row = blockIdx.x / P;
  const int part = blockIdx.x - row * P;
  const T* x = logits + static_cast<size_t>(row) * V;
  const int lo = min(V, part * per);
  const int hi = min(V, lo + per);
  // scalar head up to the first 16-byte boundary, vectors, scalar tail
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(x + lo) & 15);
  const int head = min(hi - lo, mis ? (16 - mis) / static_cast<int>(sizeof(T))
                                    : 0);
  const int body = lo + head;
  const int nvec = (hi - body) / kVec;
  const int tail = body + nvec * kVec;

  Gate g{kNeg, 0.0f, kNone};
  const int tid = threadIdx.x;
  if (tid < head) take(g, Vec<T>::scalar(x[lo + tid]), lo + tid);
  const uint4* xv = reinterpret_cast<const uint4*>(x + body);
#pragma unroll 4
  for (int i = tid; i < nvec; i += kThreads) {
    const uint4 w = __ldg(xv + i);
#pragma unroll
    for (int e = 0; e < kVec; ++e)
      take(g, Vec<T>::get(w, e), body + i * kVec + e);
  }
  if (tail + tid < hi) take(g, Vec<T>::scalar(x[tail + tid]), tail + tid);

  // the block's threads, merged by a fixed tree
  g = warp_merge(g);
  __shared__ Gate warp_part[kWarps];
  const int warp = tid / 32, lane = tid % 32;
  if (lane == 0) warp_part[warp] = g;
  __syncthreads();
  if (warp != 0) return;
  g = lane < kWarps ? warp_part[lane] : Gate{kNeg, 0.0f, kNone};
  g = warp_merge(g);
  if (P == 1) {
    if (lane == 0) {
      conf[row] = 1.0f / g.s;
      arg[row] = g.a;
    }
    return;
  }

  // P > 1: publish the partial; the row's last block merges all P
  const int base = row * P;
  unsigned prev = 0;
  if (lane == 0) {
    g_part_m[base + part] = g.m;
    g_part_s[base + part] = g.s;
    g_part_a[base + part] = g.a;
    __threadfence();
    prev = atomicInc(&g_arrived[row], static_cast<unsigned>(P - 1));
  }
  prev = __shfl_sync(0xffffffffu, prev, 0);
  if (prev != static_cast<unsigned>(P - 1)) return;
  __threadfence();
  __shared__ float term[kMaxSplit];
  float M = kNeg;
  for (int p = lane; p < P; p += 32) M = fmaxf(M, __ldcg(g_part_m + base + p));
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  int a = kNone;
  for (int p = lane; p < P; p += 32) {
    const float mp = __ldcg(g_part_m + base + p);
    if (mp == M) a = min(a, __ldcg(g_part_a + base + p));
    term[p] = __ldcg(g_part_s + base + p) * expf(mp - M);
  }
  for (int off = 16; off > 0; off >>= 1)
    a = min(a, __shfl_xor_sync(0xffffffffu, a, off));
  __syncwarp();
  if (lane == 0) {
    float s = 0.0f;
    for (int p = 0; p < P; ++p) s += term[p];    // ascending block order
    conf[row] = 1.0f / s;
    arg[row] = a;
  }
}

template <typename T>
int launch(const void* logits, void* conf, void* arg, int B, int V, int P,
           void* stream) {
  if (B <= 0 || V <= 0 || P < 1 || P > kMaxSplit)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P > 1 && (B > kMaxRows || static_cast<long long>(B) * P > kMaxSlots))
    return static_cast<int>(cudaErrorInvalidValue);
  // slices of a multiple of 8 elements: whole 16-byte vectors in both types
  const int per = ((V + P - 1) / P + 7) / 8 * 8;
  const long long blocks = static_cast<long long>(B) * P;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  ee_gate_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), static_cast<float*>(conf),
      static_cast<int*>(arg), V, P, per);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits [B, V] row-major; conf [B] float32; arg [B] int32; P the blocks a
// row (1..256, from ops.gate_plan; B * P <= 8192 and B <= 1024 when
// P > 1).  Returns the launch's cudaError_t (0 on success).
extern "C" int ee_gate_f32(const void* logits, void* conf, void* arg, int B,
                           int V, int P, void* stream) {
  return launch<float>(logits, conf, arg, B, V, P, stream);
}

extern "C" int ee_gate_bf16(const void* logits, void* conf, void* arg, int B,
                            int V, int P, void* stream) {
  return launch<__nv_bfloat16>(logits, conf, arg, B, V, P, stream);
}
