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
// whole call moves 2.46 MB, 0.73 us at 3.35 TB/s.
//
// Design against that bound: one block of 512 threads per row; the threads
// stride the row so that each warp's loads are contiguous (coalesced), and
// each thread keeps its own (max, sum, argmax).  A warp-shuffle reduction,
// then one across the block's warps in shared memory, merges them.  Each
// logit crosses device memory once.  At the serving path's B = 4 only four
// SMs work, so one SM's load rate, not the card's, bounds the call: a
// split of each row over several blocks with a second merging pass is the
// first step to make it fast, and is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Gate {
  float m;  // running max
  float s;  // running sum of exp(x - m)
  int a;    // index of the first max
};

// Merge b into a; on an equal max the lower index wins.
__device__ __forceinline__ Gate merge(Gate a, Gate b) {
  const float m = fmaxf(a.m, b.m);
  Gate out;
  out.m = m;
  out.s = a.s * expf(a.m - m) + b.s * expf(b.m - m);
  out.a = a.m > b.m ? a.a : (b.m > a.m ? b.a : min(a.a, b.a));
  return out;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ee_gate_kernel(const T* __restrict__ logits, float* __restrict__ conf,
               int* __restrict__ arg, int V) {
  const int row = blockIdx.x;
  const T* x = logits + static_cast<size_t>(row) * V;
  // every thread starts at its first index, so a row of equal values (all
  // NEG) still returns index 0 after the min-index merge
  Gate g{kNeg, 0.0f, static_cast<int>(threadIdx.x)};
  for (int v = threadIdx.x; v < V; v += kThreads) {
    const float xv = fmaxf(to_float(x[v]), kNeg);
    if (xv > g.m) {                      // strict: the first max stays
      g.s = g.s * expf(g.m - xv) + 1.0f;
      g.m = xv;
      g.a = v;
    } else {
      g.s += expf(xv - g.m);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    Gate o;
    o.m = __shfl_down_sync(0xffffffffu, g.m, off);
    o.s = __shfl_down_sync(0xffffffffu, g.s, off);
    o.a = __shfl_down_sync(0xffffffffu, g.a, off);
    g = merge(g, o);
  }
  __shared__ Gate part[kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) part[warp] = g;
  __syncthreads();
  if (warp == 0) {
    g = lane < kWarps ? part[lane] : Gate{kNeg, 0.0f, 0x7fffffff};
    for (int off = 16; off > 0; off >>= 1) {
      Gate o;
      o.m = __shfl_down_sync(0xffffffffu, g.m, off);
      o.s = __shfl_down_sync(0xffffffffu, g.s, off);
      o.a = __shfl_down_sync(0xffffffffu, g.a, off);
      g = merge(g, o);
    }
    if (lane == 0) {
      conf[row] = 1.0f / g.s;
      arg[row] = g.a;
    }
  }
}

template <typename T>
int launch(const void* logits, void* conf, void* arg, int B, int V,
           void* stream) {
  if (B <= 0 || V <= 0) return static_cast<int>(cudaErrorInvalidValue);
  ee_gate_kernel<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(logits), static_cast<float*>(conf),
      static_cast<int*>(arg), V);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// logits [B, V] row-major; conf [B] float32; arg [B] int32.  Returns the
// launch's cudaError_t (0 on success).
extern "C" int ee_gate_f32(const void* logits, void* conf, void* arg, int B,
                           int V, void* stream) {
  return launch<float>(logits, conf, arg, B, V, stream);
}

extern "C" int ee_gate_bf16(const void* logits, void* conf, void* arg, int B,
                            int V, void* stream) {
  return launch<__nv_bfloat16>(logits, conf, arg, B, V, stream);
}
