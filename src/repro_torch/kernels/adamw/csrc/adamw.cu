// The train step's optimizer programs over a whole tree of leaves:
// the gradients' global norm and clip scale (B12) and AdamW's update with
// the clip folded into its load (B13).
//
// Replaces the XLA programs of the reference's train step
// (src/repro/runtime/steps.py:35-44): `global_norm` / the scale of
// `clip_by_global_norm` (src/repro/optim/adamw.py:73-81) and the body
// `upd` of `AdamW.update` (src/repro/optim/adamw.py:51-63).  Neither is a
// Pallas kernel; XLA fuses each into a few loops inside the jitted step,
// where the port ran about 15 eager elementwise ops a leaf.
//
// The tree is described by a table the wrapper builds on the host at each
// call (ref.chunk_table) and copies to the device, int64 throughout:
//
//   leaf l   (8 words): p, g, m, v addresses (0 where absent), elements,
//                       head, dtype code, first chunk
//   chunk c  (4 words): leaf, start, end, 0           (after the L leaves)
//
// A leaf's chunks cover [0, n) in order: chunk 0 is [0, head + CHUNK) and
// chunk k >= 1 starts at head + k * CHUNK, so every chunk but the first
// starts where each of the leaf's tensors is 16-byte aligned.  `head` is
// the first element from which 8 elements of every tensor of the leaf
// are 16-byte vectors (one of bf16, two of float32), or -1 when the
// tensors' misalignments disagree: that leaf runs element by element.
// A chunk's elements are a scalar head [start, vs), 8-element vectors
// [vs, ve) and a scalar tail [ve, end).
//
// B12, bound by bytes (each gradient read once: 8.13 GB at [train]'s
// qwen3-4b in bf16, 2.43 ms at 3.35 TB/s):
//   * norm_partials: one 256-thread block a chunk.  A thread keeps a
//     float32 sum of squares (one rounded product, one rounded add an
//     element) over its scalar head elements, its vectors and its tail
//     elements, in that order; a shuffle tree and then one over the
//     warps reduce the block to one partial a chunk, in a fixed order.
//   * norm_finish: one block.  Each leaf's chunk partials are summed in
//     float64 (warp w takes leaves w, w + 32, ...; lane i the chunks i,
//     i + 32, ...; a fixed shuffle tree) and rounded to float32: the
//     leaf's sum of squares.  Thread 0 then adds the leaf sums in the
//     tree's flatten order in float32, as the plain version does, takes
//     the IEEE square root and the scale min(1, max_norm / (n + 1e-9)).
//     Mode 1 stops after the leaf sums (a DTensor tree sums each over
//     its ranks outside), mode 2 starts from leaf sums given to it.
//   Nothing depends on which block runs first: no atomics, the same bits
//   on every call.
//
// B13, bound by bytes (22 B a parameter at bf16 p and g with float32 m
// and v: 89.45 GB at [train], 26.7 ms at 3.35 TB/s): one 256-thread block
// a chunk, every load and store a 16-byte vector (streaming cache hints:
// each byte is touched once), the scalars lr, bc1, bc2 and the clip scale
// read from the device.  An element gets exactly the plain version's
// float32 operations, each rounded on its own (IEEE division and square
// root, no contraction into FMAs: the intrinsics below, and the library
// is built with -fmad=false), so p, m and v come out bit-equal:
//
//   g'    = to_dtype(g)(float(g) * scale)        (when a scale is given)
//   m_new = b1 * m + (1 - b1) * g'
//   v_new = b2 * v + ((1 - b2) * g') * g'
//   delta = (m_new / bc1) / (sqrt(v_new / bc2) + eps) + wd * p
//   p_new = p - lr * delta
//
// with the Python constants rounded to float32 as a tensor-scalar op
// rounds them, and p, m, v stored rounded to nearest even in their own
// dtypes.  The gradients are not written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kFinishThreads = 1024;
constexpr int kVec = 8;                 // elements a thread takes a step

// dtype code bits of a leaf
constexpr int kPBf16 = 1, kGBf16 = 2, kMvBf16 = 4;

struct Leaf {
  int64_t p, g, m, v, n, head, code, first;
};
struct Chunk {
  int64_t leaf, start, end, pad;
};

struct Region {
  int64_t s, vs, ve, e;   // scalar [s, vs), vectors [vs, ve), scalar [ve, e)
};

__device__ __forceinline__ Region region(const Leaf& lf, const Chunk& c) {
  Region r;
  r.s = c.start;
  r.e = c.end;
  if (lf.head < 0) {
    r.vs = r.ve = r.e;
    return r;
  }
  r.vs = c.start < lf.head ? (lf.head < c.end ? lf.head : c.end) : c.start;
  r.ve = r.vs + (r.e - r.vs) / kVec * kVec;
  return r;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <bool BF>
struct Ty {
  using T = float;
};
template <>
struct Ty<true> {
  using T = __nv_bfloat16;
};

// 8 consecutive elements at a 16-byte aligned address, as float32
template <typename T>
struct V8;
template <>
struct V8<float> {
  __device__ __forceinline__ static void load(const float* p, float (&x)[8]) {
    const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
    const float4 b = __ldcs(reinterpret_cast<const float4*>(p) + 1);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  }
  __device__ __forceinline__ static void store(float* p, const float (&x)[8]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(x[0], x[1], x[2], x[3]));
    __stcs(reinterpret_cast<float4*>(p) + 1,
           make_float4(x[4], x[5], x[6], x[7]));
  }
};
template <>
struct V8<__nv_bfloat16> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p,
                                              float (&x)[8]) {
    const uint4 w = __ldcs(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {     // element 2i in the low half
      x[2 * i] = __uint_as_float(u[i] << 16);
      x[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p,
                                               const float (&x)[8]) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      u[i] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i])) |
             ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x[2 * i + 1]))
              << 16);
    }
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(u[0], u[1], u[2], u[3]));
  }
};

// ---------------------------------------------------------------------------
// B12
// ---------------------------------------------------------------------------

template <typename G>
__device__ __forceinline__ float chunk_sumsq(const Leaf& lf, const Region r) {
  const G* g = reinterpret_cast<const G*>(lf.g);
  float acc = 0.0f;
  for (int64_t i = r.s + threadIdx.x; i < r.vs; i += kThreads) {
    const float x = to_f(g[i]);
    acc = __fadd_rn(acc, __fmul_rn(x, x));
  }
  const int64_t groups = (r.ve - r.vs) / kVec;
#pragma unroll 4
  for (int64_t k = threadIdx.x; k < groups; k += kThreads) {
    float x[kVec];
    V8<G>::load(g + r.vs + k * kVec, x);
#pragma unroll
    for (int j = 0; j < kVec; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j], x[j]));
  }
  for (int64_t i = r.ve + threadIdx.x; i < r.e; i += kThreads) {
    const float x = to_f(g[i]);
    acc = __fadd_rn(acc, __fmul_rn(x, x));
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    norm_partials_kernel(const int64_t* __restrict__ table, int L,
                         float* __restrict__ partials) {
  __shared__ float warp_sum[kWarps];
  const Leaf* leaves = reinterpret_cast<const Leaf*>(table);
  const Chunk ch = reinterpret_cast<const Chunk*>(table + 8 * (int64_t)L)
      [blockIdx.x];
  const Leaf lf = leaves[ch.leaf];
  const Region r = region(lf, ch);
  float acc = (lf.code & kGBf16) ? chunk_sumsq<__nv_bfloat16>(lf, r)
                                 : chunk_sumsq<float>(lf, r);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sum[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? warp_sum[lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
    if (lane == 0) partials[blockIdx.x] = acc;
  }
}

__global__ void __launch_bounds__(kFinishThreads)
    norm_finish_kernel(const int64_t* __restrict__ table,
                       const float* __restrict__ partials,
                       float* __restrict__ leaf_sums, float* __restrict__ norm,
                       float* __restrict__ scale, int L, int C, int mode,
                       float max_norm, float tiny) {
  const Leaf* leaves = reinterpret_cast<const Leaf*>(table);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (mode != 2) {
    for (int l = warp; l < L; l += kFinishThreads / 32) {
      const int64_t c0 = leaves[l].first;
      const int64_t c1 = l + 1 < L ? leaves[l + 1].first : C;
      double acc = 0.0;
      for (int64_t c = c0 + lane; c < c1; c += 32)
        acc = __dadd_rn(acc, (double)partials[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc = __dadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
      if (lane == 0) leaf_sums[l] = __double2float_rn(acc);
    }
  }
  if (mode == 1) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int l = 0; l < L; ++l) total = __fadd_rn(total, leaf_sums[l]);
    const float n = __fsqrt_rn(total);
    const float s = __fdiv_rn(max_norm, __fadd_rn(n, tiny));
    *norm = n;
    *scale = s > 1.0f ? 1.0f : s;     // a NaN stays, as torch.clamp keeps it
  }
}

// ---------------------------------------------------------------------------
// B13
// ---------------------------------------------------------------------------

struct Consts {
  float b1, omb1, b2, omb2, eps, wd;
};

struct Scalars {
  float lr, bc1, bc2, scale;
  bool clip;
};

// One element through the plain version's operations, each rounded alone.
template <typename G>
__device__ __forceinline__ void adamw_elem(float g, float& p, float& m,
                                           float& v, const Scalars& s,
                                           const Consts& c) {
  const float gf = s.clip ? to_f(from_f<G>(__fmul_rn(g, s.scale))) : g;
  const float m_new = __fadd_rn(__fmul_rn(c.b1, m), __fmul_rn(c.omb1, gf));
  const float v_new =
      __fadd_rn(__fmul_rn(c.b2, v), __fmul_rn(__fmul_rn(c.omb2, gf), gf));
  const float mh = __fdiv_rn(m_new, s.bc1);
  const float vh = __fdiv_rn(v_new, s.bc2);
  float delta = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), c.eps));
  delta = __fadd_rn(delta, __fmul_rn(c.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, delta));
  m = m_new;
  v = v_new;
}

template <typename P, typename G, typename M>
__device__ __forceinline__ void adamw_scalar(const Leaf& lf, int64_t i,
                                             const Scalars& s,
                                             const Consts& c) {
  P* p = reinterpret_cast<P*>(lf.p);
  const G* g = reinterpret_cast<const G*>(lf.g);
  M* m = reinterpret_cast<M*>(lf.m);
  M* v = reinterpret_cast<M*>(lf.v);
  float pf = to_f(p[i]), mf = to_f(m[i]), vf = to_f(v[i]);
  adamw_elem<G>(to_f(g[i]), pf, mf, vf, s, c);
  p[i] = from_f<P>(pf);
  m[i] = from_f<M>(mf);
  v[i] = from_f<M>(vf);
}

template <typename P, typename G, typename M>
__device__ __forceinline__ void adamw_chunk(const Leaf& lf, const Region r,
                                            const Scalars& s,
                                            const Consts& c) {
  for (int64_t i = r.s + threadIdx.x; i < r.vs; i += kThreads)
    adamw_scalar<P, G, M>(lf, i, s, c);
  P* p = reinterpret_cast<P*>(lf.p) + r.vs;
  const G* g = reinterpret_cast<const G*>(lf.g) + r.vs;
  M* m = reinterpret_cast<M*>(lf.m) + r.vs;
  M* v = reinterpret_cast<M*>(lf.v) + r.vs;
  const int64_t groups = (r.ve - r.vs) / kVec;
#pragma unroll 2
  for (int64_t k = threadIdx.x; k < groups; k += kThreads) {
    float gx[kVec], px[kVec], mx[kVec], vx[kVec];
    V8<G>::load(g + k * kVec, gx);
    V8<P>::load(p + k * kVec, px);
    V8<M>::load(m + k * kVec, mx);
    V8<M>::load(v + k * kVec, vx);
#pragma unroll
    for (int j = 0; j < kVec; ++j) adamw_elem<G>(gx[j], px[j], mx[j], vx[j], s, c);
    V8<P>::store(p + k * kVec, px);
    V8<M>::store(m + k * kVec, mx);
    V8<M>::store(v + k * kVec, vx);
  }
  for (int64_t i = r.ve + threadIdx.x; i < r.e; i += kThreads)
    adamw_scalar<P, G, M>(lf, i, s, c);
}

template <int CODE>
__device__ __forceinline__ void adamw_code(const Leaf& lf, const Region r,
                                           const Scalars& s, const Consts& c) {
  using P = typename Ty<(CODE & kPBf16) != 0>::T;
  using G = typename Ty<(CODE & kGBf16) != 0>::T;
  using M = typename Ty<(CODE & kMvBf16) != 0>::T;
  adamw_chunk<P, G, M>(lf, r, s, c);
}

__global__ void __launch_bounds__(kThreads)
    adamw_kernel(const int64_t* __restrict__ table, int L,
                 const float* __restrict__ lr, const float* __restrict__ bc1,
                 const float* __restrict__ bc2,
                 const float* __restrict__ scale, Consts c) {
  const Leaf* leaves = reinterpret_cast<const Leaf*>(table);
  const Chunk ch = reinterpret_cast<const Chunk*>(table + 8 * (int64_t)L)
      [blockIdx.x];
  const Leaf lf = leaves[ch.leaf];
  const Region r = region(lf, ch);
  Scalars s;
  s.lr = *lr;
  s.bc1 = *bc1;
  s.bc2 = *bc2;
  s.clip = scale != nullptr;
  s.scale = s.clip ? *scale : 1.0f;
  switch (lf.code) {
    case 0: adamw_code<0>(lf, r, s, c); break;
    case 1: adamw_code<1>(lf, r, s, c); break;
    case 2: adamw_code<2>(lf, r, s, c); break;
    case 3: adamw_code<3>(lf, r, s, c); break;
    case 4: adamw_code<4>(lf, r, s, c); break;
    case 5: adamw_code<5>(lf, r, s, c); break;
    case 6: adamw_code<6>(lf, r, s, c); break;
    case 7: adamw_code<7>(lf, r, s, c); break;
  }
}

}  // namespace

extern "C" {

// B12's first pass: one partial sum of squares a chunk of the C chunks.
int adamw_norm_partials(const void* table, void* partials, int L, int C,
                        void* stream) {
  if (C <= 0) return 0;
  norm_partials_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)table, L, (float*)partials);
  return (int)cudaGetLastError();
}

// B12's second pass: leaf sums (mode 0 and 1), then (mode 0 and 2) the
// norm and the clip scale.  max_norm and the 1e-9 guard arrive as doubles
// and are rounded to float32 here, as a tensor-scalar op rounds them.
int adamw_norm_finish(const void* table, const void* partials,
                      void* leaf_sums, void* norm, void* scale, int L, int C,
                      int mode, double max_norm, double tiny, void* stream) {
  norm_finish_kernel<<<1, kFinishThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)table, (const float*)partials, (float*)leaf_sums,
      (float*)norm, (float*)scale, L, C, mode, (float)max_norm, (float)tiny);
  return (int)cudaGetLastError();
}

// B13: the update of every chunk; scale may be null (no clip).  The six
// constants arrive as doubles (the Python floats) and are rounded here.
int adamw_update(const void* table, const void* lr, const void* bc1,
                 const void* bc2, const void* scale, int L, int C, double b1,
                 double omb1, double b2, double omb2, double eps, double wd,
                 void* stream) {
  if (C <= 0) return 0;
  const Consts c{(float)b1, (float)omb1, (float)b2,
                 (float)omb2, (float)eps, (float)wd};
  adamw_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(
      (const int64_t*)table, L, (const float*)lr, (const float*)bc1,
      (const float*)bc2, (const float*)scale, c);
  return (int)cudaGetLastError();
}

}  // extern "C"
