// Flash-prefill GQA attention: every query of a sequence against its keys,
// with the running (max, sum, acc) of an online softmax in float32.
//
// Replaces no TPU kernel: it computes the reference's full-sequence
// attention `chunked_attention` (src/repro/models/attention.py:73, body
// :60-113), which the reference leaves to XLA as a scan over KV chunks.
// It exists because that program is on measured paths of the port (every
// attention layer of `prefill`, `forward_train` and `encode`), where its
// plain PyTorch version took 37.9 ms a call at mixtral's prefill against
// 1.64 ms for one library call (scaled_dot_product_attention).
//
// What it computes, for each sequence b, query row i and query head
// h = kv*G + g (G = H / KV query heads share the kv-head kv):
//
//   s[j]      = (q[b,i,h,:] . k[b,j,kv,:]) * D^-0.5  (float32) where key j
//               is live: k_pos[j] >= 0, k_pos[j] <= q_pos[i] if causal and
//               k_pos[j] > q_pos[i] - window if window > 0
//   out[b,i,h,:] = sum_j softmax(s)[j] * v[b,j,kv,:] over the live keys
//
// The reference masks a key with the finite -1e30 and runs its softmax in
// chunks; once a row has a live key, a masked key weighs exp(-1e30 - m) = 0
// and a masked chunk before the first live one is wiped by
// corr = exp(-1e30 - m) = 0, so the live keys alone give its result, which
// this kernel computes (a masked score is -inf here).  A row with no live
// key at all (a dead row) is the exception: there the reference weighs
// every key 1, the zero-padded slots of its last chunk too, so its output
// is sum_{j < Sk} v[j] / (ceil(Sk / chunk) * chunk) (`n_pad`); the block
// computes that sum for its dead rows after its tiles.  Like the reference,
// bf16 probabilities are rounded to bf16 before the PV product (here the
// unnormalised ones of a tile, the reference's those of a chunk), the sum l
// keeps them unrounded, and out = acc / max(l, 1e-30) in q's dtype.
//
// Bound: operations.  A call does 4 * D flops for each live (query head,
// key) pair: 0.26 ms at 989 TFLOP/s (bf16 tensor cores) at mixtral's
// prefill (H = 48, D = 128, 4,608 tokens, window 4,096), against 0.03 ms
// for its bytes (q, k, v and out once).  The design against it:
//
// * bf16: both products on the tensor cores, mma.sync m16n8k16 with
//   float32 accumulators (bf16 x bf16 products are exact in float32, so
//   only the order of the sums differs from the reference's).  A warp owns
//   16 query rows of the block's 64; q's A fragments stay in registers for
//   the whole sequence, K fragments come by ldmatrix, and the score
//   fragments, rounded, are P's A fragments as they stand (no trip through
//   shared memory); V^T comes by ldmatrix.trans.  float32: the same
//   fragment layout on CUDA-core FMA (no TF32: the reference's float32
//   products are float32); its PV takes a quad's probabilities by shuffles.
// * Loads: K / V tiles (64 keys in bf16, 32 in float32) by cp.async into a
//   two-stage ring in shared memory, rows padded by 16 bytes so ldmatrix
//   reads 8 rows on 8 distinct bank groups; the next live tile streams in
//   while this one is consumed; the ragged edge past Sk is zero-filled and
//   masked, never padded by a copy.
// * Skipped tiles: a first launch builds a bit map, for each 64-query tile,
//   of the key tiles holding a key that may be live for some of its rows
//   (k_pos >= 0, k_pos <= the tile's largest q_pos if causal, k_pos > its
//   smallest q_pos - window): a tile outside it is masked for every row, so
//   skipping it is exact, and a causal or windowed prefill does about half
//   or less of the full square.  A second map marks the tiles whose every
//   key is live for every row (the interior of a causal or windowed band),
//   which skip the per-score mask; with the scale folded into the exp2's
//   argument that took 2.57 to 2.43 ms at mixtral's prefill and 0.175 to
//   0.143 ms at hubert's encode (bf16, an H100 SXM at 700 W).
// * Grid: one block per (query head, 64-query tile, sequence), heads
//   fastest, so a kv-group's G heads read the same K / V tiles from L2 at
//   about the same time (mixtral's K and V of one layer, 18.9 MB, stay in
//   the 50 MB L2), and the longest (last) causal query tiles start first.
//
// Takes D a multiple of 16 up to 128, 16-byte aligned q, K and V, int32
// positions and n_pad < 2^31 (the wrapper checks).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps, 16 query rows each
constexpr int kBQ = 64;         // query rows of a block
constexpr int kMapThreads = 256;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
// 4 bytes global -> shared, asynchronously; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory (lanes 8j..8j+7 give the row
// addresses of matrix j); .trans transposes each.
__device__ __forceinline__ void ldmatrix_x4(const void* row, unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(const void* row,
                                                  unsigned* r) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// c (16 x 8, float32) += A (16 x 16 bf16, a[0..3]) * B (16 x 8 bf16,
// b0, b1).  c[0], c[1]: row lane/4, columns 2*(lane%4) + {0, 1}; c[2],
// c[3]: the same columns of row lane/4 + 8.
__device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values as one register of bf16 (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// Two output values of one row at (p, p + 1).
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ bool is_live(int kp, int qp, int causal,
                                        int window) {
  return kp >= 0 && (!causal || kp <= qp)
         && (window <= 0
             || static_cast<long long>(kp)
                    > static_cast<long long>(qp) - window);
}


// The tile maps, two of n_qt rows of n_words words.  In the first, bit kt
// of row qt is set when key tile kt holds a key that may be live for a row
// of query tile qt (k_pos >= 0, <= the tile's largest q_pos if causal, >
// its smallest q_pos - window): a clear bit is a tile masked for every row
// of the query tile.  In the second it is set when every key of the tile
// (a whole one, within Sk) is live for every row (<= the smallest q_pos if
// causal, > the largest - window): such a tile needs no mask.  One block a
// query tile; lane i of warp w decides tile 32*word + i of the words w,
// w + 8, ...
__global__ void __launch_bounds__(kMapThreads)
tile_map_kernel(const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                unsigned* __restrict__ map, int Sq, int Sk, int causal,
                int window, int bk, int n_words) {
  __shared__ int s_lo[kMapThreads / 32], s_hi[kMapThreads / 32];
  const int qt = blockIdx.x, tid = threadIdx.x, warp = tid >> 5,
            lane = tid & 31;
  int lo = INT_MAX, hi = INT_MIN;
  if (tid < kBQ && qt * kBQ + tid < Sq) {
    lo = hi = q_pos[qt * kBQ + tid];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (lane == 0) {
    s_lo[warp] = lo;
    s_hi[warp] = hi;
  }
  __syncthreads();
  lo = INT_MAX;
  hi = INT_MIN;
  for (int w = 0; w < kMapThreads / 32; ++w) {
    lo = min(lo, s_lo[w]);
    hi = max(hi, s_hi[w]);
  }
  const int n_kt = (Sk + bk - 1) / bk;
  for (int word = warp; word < n_words; word += kMapThreads / 32) {
    const int kt = word * 32 + lane;
    bool any = false, all = kt < n_kt && (kt + 1) * bk <= Sk;
    if (kt < n_kt) {
      const int j1 = min(Sk, (kt + 1) * bk);
      for (int j = kt * bk; j < j1; ++j) {
        const int kp = k_pos[j];
        any = any || (is_live(kp, hi, causal, 0)
                      && (window <= 0 || is_live(kp, lo, 0, window)));
        all = all && is_live(kp, lo, causal, 0)
              && (window <= 0 || is_live(kp, hi, 0, window));
      }
    }
    const unsigned bits = __ballot_sync(0xffffffffu, any);
    const unsigned whole = __ballot_sync(0xffffffffu, all);
    if (lane == 0) {
      map[static_cast<size_t>(qt) * n_words + word] = bits;
      map[(static_cast<size_t>(gridDim.x) + qt) * n_words + word] = whole;
    }
  }
}


// Dynamic shared memory of one block, in bytes: q's tile, then two stages
// of K and of V tiles (rows of D + 16 bytes), then the stages' key
// positions.  (ops.py's smem_bytes mirrors it.)
template <typename T, int kBK>
size_t smem_bytes(int D) {
  const size_t ld = D + 16 / sizeof(T);
  return (kBQ + 4 * kBK) * ld * sizeof(T) + 2 * kBK * sizeof(int);
}

template <typename T, int kBK, int kMaxD>
__global__ void __launch_bounds__(kThreads)
prefill_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ q_pos,
                    const int* __restrict__ k_pos,
                    const unsigned* __restrict__ map, T* __restrict__ out,
                    int Sq, int Sk, int H, int KV, int D, int causal,
                    int window, int n_pad, int n_words) {
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kNB = kBK / 8;          // 8-key column blocks of a tile
  constexpr int kE = 16 / sizeof(T);    // elements of a 16-byte word
  static_assert(kBK % 16 == 0, "whole 16-key mma steps");
  extern __shared__ __align__(16) unsigned char smem[];
  const int h = blockIdx.x;
  const int qt = gridDim.y - 1 - blockIdx.y;   // the longest tiles first
  const int b = blockIdx.z;
  const int kv = h / (H / KV);
  const int q0 = qt * kBQ;
  const int ld = D + kE;                // row pitch in shared memory
  const int words = D / kE;             // 16-byte words of a row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t qstride = static_cast<size_t>(H) * D;
  const size_t kstride = static_cast<size_t>(KV) * D;
  const T* qb = q + static_cast<size_t>(b) * Sq * qstride
                + static_cast<size_t>(h) * D;
  const T* kb = k + static_cast<size_t>(b) * Sk * kstride
                + static_cast<size_t>(kv) * D;
  const T* vb = v + static_cast<size_t>(b) * Sk * kstride
                + static_cast<size_t>(kv) * D;
  T* sQ = reinterpret_cast<T*>(smem);                 // [kBQ][ld]
  T* sK = sQ + kBQ * ld;                              // [2][kBK][ld]
  T* sV = sK + 2 * kBK * ld;                          // [2][kBK][ld]
  int* sKp = reinterpret_cast<int*>(sV + 2 * kBK * ld);   // [2][kBK]
  // scores in the log2 domain: s * log2(e), so that exp(s - m) is one
  // exp2 of a difference
  const float scale =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));

  // q's tile (rows past Sq zero-filled), one cp.async group
  for (int i = tid; i < kBQ * words; i += kThreads) {
    const int r = i / words, c = i - r * words;
    const bool ok = q0 + r < Sq;
    cp_async16(sQ + r * ld + c * kE,
               qb + static_cast<size_t>(ok ? q0 + r : 0) * qstride + c * kE,
               ok);
  }
  cp_async_commit();

  const int n_kt = (Sk + kBK - 1) / kBK;
  const unsigned* row_map = map + static_cast<size_t>(qt) * n_words;
  const unsigned* full_map =
      map + (static_cast<size_t>(gridDim.y) + qt) * n_words;
  auto next_live = [&](int t) {   // the first mapped key tile >= t
    while (t < n_kt) {
      const unsigned w = __ldg(row_map + (t >> 5)) >> (t & 31);
      if (w) return t + __ffs(w) - 1;
      t = (t | 31) + 1;
    }
    return n_kt;
  };
  auto issue = [&](int t, int st) {   // key tile t -> stage st
    const int j0 = t * kBK;
    T* dk = sK + st * kBK * ld;
    T* dv = sV + st * kBK * ld;
    for (int i = tid; i < kBK * words; i += kThreads) {
      const int r = i / words, c = i - r * words;
      const bool ok = j0 + r < Sk;
      const size_t off =
          static_cast<size_t>(ok ? j0 + r : 0) * kstride + c * kE;
      cp_async16(dk + r * ld + c * kE, kb + off, ok);
      cp_async16(dv + r * ld + c * kE, vb + off, ok);
    }
    for (int r = tid; r < kBK; r += kThreads)
      cp_async4(sKp + st * kBK + r, k_pos + (j0 + r < Sk ? j0 + r : 0),
                j0 + r < Sk);
  };

  int t = next_live(0);
  if (t < n_kt) issue(t, 0);
  cp_async_commit();

  // the thread's two query rows (fragment rows g and g + 8 of its warp)
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const int qp0 = r0 < Sq ? q_pos[r0] : 0;
  const int qp1 = r1 < Sq ? q_pos[r1] : 0;

  // bf16: q's A fragments, one x4 ldmatrix per 16 dims
  unsigned qa[kMaxD / 16][4];
  cp_async_wait<1>();   // q's tile (the first key tile may still fly)
  __syncthreads();
  if constexpr (kMma) {
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) {
      if (kk * 16 < D)
        ldmatrix_x4(sQ + (warp * 16 + (lane & 15)) * ld + kk * 16
                        + (lane >> 4) * 8,
                    qa[kk]);
    }
  }

  // running max (log2 domain), sum and accumulator fragments of rows r0
  // (o[nd][0..1]) and r1 (o[nd][2..3]), columns nd*8 + 2*t4 + {0, 1}
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.0f, l1 = 0.0f;
  float o[kMaxD / 8][4];
#pragma unroll
  for (int nd = 0; nd < kMaxD / 8; ++nd)
    o[nd][0] = o[nd][1] = o[nd][2] = o[nd][3] = 0.0f;

  int st = 0;
  while (t < n_kt) {
    const int tn = next_live(t + 1);
    if (tn < n_kt) issue(tn, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();   // tile t has landed
    __syncthreads();
    const T* tk = sK + st * kBK * ld;
    const T* tv = sV + st * kBK * ld;
    const int* kp = sKp + st * kBK;
    const int j0 = t * kBK;

    // S = Q K^T: s[nb][e] is key nb*8 + 2*t4 + (e & 1) of row r0 (e < 2)
    // or r1 (e >= 2)
    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.0f;
    if constexpr (kMma) {
      const int mat = lane >> 3;   // ldmatrix: lane -> a row of matrix mat
#pragma unroll
      for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk * 16 < D) {
#pragma unroll
          for (int np = 0; np < kNB / 2; ++np) {
            unsigned bk4[4];
            ldmatrix_x4(tk + ((2 * np + (mat >> 1)) * 8 + (lane & 7)) * ld
                            + (mat & 1) * 8 + kk * 16,
                        bk4);
            mma_bf16(s[2 * np], qa[kk], bk4[0], bk4[1]);
            mma_bf16(s[2 * np + 1], qa[kk], bk4[2], bk4[3]);
          }
        }
      }
    } else {
      const float* qr0 =
          reinterpret_cast<const float*>(sQ) + (warp * 16 + g) * ld;
      const float* qr1 = qr0 + 8 * ld;
      const float* kf = reinterpret_cast<const float*>(tk);
      for (int c = 0; c < D; c += 4) {
        const float4 a = *reinterpret_cast<const float4*>(qr0 + c);
        const float4 a1 = *reinterpret_cast<const float4*>(qr1 + c);
#pragma unroll
        for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float4 kx = *reinterpret_cast<const float4*>(
                kf + (nb * 8 + 2 * t4 + e) * ld + c);
            s[nb][e] += a.x * kx.x + a.y * kx.y + a.z * kx.z + a.w * kx.w;
            s[nb][2 + e] +=
                a1.x * kx.x + a1.y * kx.y + a1.z * kx.z + a1.w * kx.w;
          }
        }
      }
    }

    // the mask (a tile live for every row needs none) and the online
    // softmax of rows r0 and r1; the scale is applied inside the exp2's
    // argument, fmaf(s, scale, -m)
    if (!((__ldg(full_map + (t >> 5)) >> (t & 31)) & 1u)) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nb * 8 + 2 * t4 + (e & 1);
          if (!(j0 + c < Sk
                && is_live(kp[c], e < 2 ? qp0 : qp1, causal, window)))
            s[nb][e] = -CUDART_INF_F;
        }
      }
    }
    float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0 * scale), mn1 = fmaxf(m1, mx1 * scale);
    // a row with no live key so far subtracts 0: exp2(-inf - 0) = 0, and
    // never -inf - -inf = NaN
    const float mu0 = mn0 == -CUDART_INF_F ? 0.0f : mn0;
    const float mu1 = mn1 == -CUDART_INF_F ? 0.0f : mn1;
    float ps0 = 0.0f, ps1 = 0.0f;
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      s[nb][0] = exp2f(fmaf(s[nb][0], scale, -mu0));
      s[nb][1] = exp2f(fmaf(s[nb][1], scale, -mu0));
      s[nb][2] = exp2f(fmaf(s[nb][2], scale, -mu1));
      s[nb][3] = exp2f(fmaf(s[nb][3], scale, -mu1));
      ps0 += s[nb][0] + s[nb][1];
      ps1 += s[nb][2] + s[nb][3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    const float c0 = exp2f(m0 - mu0), c1 = exp2f(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    l0 = l0 * c0 + ps0;
    l1 = l1 * c1 + ps1;
#pragma unroll
    for (int nd = 0; nd < kMaxD / 8; ++nd) {
      o[nd][0] *= c0;
      o[nd][1] *= c0;
      o[nd][2] *= c1;
      o[nd][3] *= c1;
    }

    // O += P V
    if constexpr (kMma) {
      const int mat = lane >> 3;
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {   // 16 keys a k-step
        const unsigned pa[4] = {pack_bf16(s[2 * ks][0], s[2 * ks][1]),
                                pack_bf16(s[2 * ks][2], s[2 * ks][3]),
                                pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]),
                                pack_bf16(s[2 * ks + 1][2],
                                          s[2 * ks + 1][3])};
        const T* vaddr = tv + (ks * 16 + (mat & 1) * 8 + (lane & 7)) * ld
                         + (mat >> 1) * 8;
#pragma unroll
        for (int kk = 0; kk < kMaxD / 16; ++kk) {
          if (kk * 16 < D) {
            unsigned bv4[4];
            ldmatrix_x4_trans(vaddr + kk * 16, bv4);
            mma_bf16(o[2 * kk], pa, bv4[0], bv4[1]);
            mma_bf16(o[2 * kk + 1], pa, bv4[2], bv4[3]);
          }
        }
      }
    } else {
      const float* vf = reinterpret_cast<const float*>(tv);
      const int quad0 = lane & ~3;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
#pragma unroll
        for (int tp = 0; tp < 4; ++tp) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p0 = __shfl_sync(0xffffffffu, s[nb][e], quad0 | tp);
            const float p1 =
                __shfl_sync(0xffffffffu, s[nb][2 + e], quad0 | tp);
            const float* vr = vf + (nb * 8 + 2 * tp + e) * ld + 2 * t4;
#pragma unroll
            for (int nd = 0; nd < kMaxD / 8; ++nd) {
              if (nd * 8 < D) {
                const float2 x = *reinterpret_cast<const float2*>(vr + nd * 8);
                o[nd][0] += p0 * x.x;
                o[nd][1] += p0 * x.y;
                o[nd][2] += p1 * x.x;
                o[nd][3] += p1 * x.y;
              }
            }
          }
        }
      }
    }
    __syncthreads();   // stage st is free for the tile after next
    t = tn;
    st ^= 1;
  }

  // live rows: out = acc / max(l, 1e-30)
  const bool dead0 = r0 < Sq && m0 == -CUDART_INF_F;
  const bool dead1 = r1 < Sq && m1 == -CUDART_INF_F;
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  T* ob = out + static_cast<size_t>(b) * Sq * qstride
          + static_cast<size_t>(h) * D + 2 * t4;
#pragma unroll
  for (int nd = 0; nd < kMaxD / 8; ++nd) {
    if (nd * 8 < D) {
      if (r0 < Sq && !dead0)
        store2(ob + static_cast<size_t>(r0) * qstride + nd * 8,
               o[nd][0] / d0, o[nd][1] / d0);
      if (r1 < Sq && !dead1)
        store2(ob + static_cast<size_t>(r1) * qstride + nd * 8,
               o[nd][2] / d1, o[nd][3] / d1);
    }
  }

  // dead rows (no live key): the reference's sum of every v over n_pad
  if (__syncthreads_or(dead0 || dead1)) {
    float* vsum = reinterpret_cast<float*>(smem);   // q's tile is done
    for (int d = tid; d < D; d += kThreads) {
      float a = 0.0f;
      for (int j = 0; j < Sk; ++j)
        a += to_float(vb[static_cast<size_t>(j) * kstride + d]);
      vsum[d] = a;
    }
    __syncthreads();
    const float den = static_cast<float>(n_pad);
#pragma unroll
    for (int nd = 0; nd < kMaxD / 8; ++nd) {
      if (nd * 8 < D) {
        const float a = vsum[nd * 8 + 2 * t4] / den;
        const float c = vsum[nd * 8 + 2 * t4 + 1] / den;
        if (dead0) store2(ob + static_cast<size_t>(r0) * qstride + nd * 8,
                          a, c);
        if (dead1) store2(ob + static_cast<size_t>(r1) * qstride + nd * 8,
                          a, c);
      }
    }
  }
}

template <typename T, int kBK, int kMaxD>
int launch_attn(const T* q, const T* k, const T* v, const int* q_pos,
                const int* k_pos, const unsigned* map, T* out, int B, int Sq,
                int Sk, int H, int KV, int D, int causal, int window,
                int n_pad, int n_words, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, kBK>(D);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        prefill_attn_kernel<T, kBK, kMaxD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>(H),
                  static_cast<unsigned>((Sq + kBQ - 1) / kBQ),
                  static_cast<unsigned>(B));
  prefill_attn_kernel<T, kBK, kMaxD><<<grid, kThreads, smem, stream>>>(
      q, k, v, q_pos, k_pos, map, out, Sq, Sk, H, KV, D, causal, window,
      n_pad, n_words);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* q_pos,
           const void* k_pos, void* map, void* out, int B, int Sq, int Sk,
           int H, int KV, int D, int causal, int window, int n_pad,
           void* stream) {
  // key rows of a tile: 64 in bf16, 32 in float32 (whose padded rows are
  // twice as wide), so that two blocks fit an SM at D = 128
  constexpr int kBK = std::is_same<T, __nv_bfloat16>::value ? 64 : 32;
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || D <= 0
      || D > 128 || D % 16 != 0 || n_pad < Sk || B > 65535
      || (Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int n_words = ((Sk + kBK - 1) / kBK + 31) / 32;
  auto* m = static_cast<unsigned*>(map);
  tile_map_kernel<<<n_qt, kMapThreads, 0, st>>>(
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), m, Sq,
      Sk, causal, window, kBK, n_words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* qp = static_cast<const int*>(q_pos);
  const auto* kp = static_cast<const int*>(k_pos);
  auto* ot = static_cast<T*>(out);
  // registers for q's and the output's fragments up to the head's width
  if (D <= 64)
    return launch_attn<T, kBK, 64>(qt, kt, vt, qp, kp, m, ot, B, Sq, Sk, H,
                                   KV, D, causal, window, n_pad, n_words,
                                   st);
  return launch_attn<T, kBK, 128>(qt, kt, vt, qp, kp, m, ot, B, Sq, Sk, H,
                                  KV, D, causal, window, n_pad, n_words, st);
}

}  // namespace

// q [B, Sq, H, D]; k, v [B, Sk, KV, D]; q_pos [Sq], k_pos [Sk] int32; map
// int32 scratch of 2 * ceil(Sq / 64) * ceil(ceil(Sk / kBK) / 32) words; out
// [B, Sq, H, D] in q's dtype.  causal 0 / 1; window <= 0 means none; n_pad
// = ceil(Sk / chunk) * chunk.  Two launches (the tile map, the attention)
// on `stream`; returns the first failing one's cudaError_t (0 on success).
extern "C" int prefill_attn_f32(const void* q, const void* k, const void* v,
                                const void* q_pos, const void* k_pos,
                                void* map, void* out, int B, int Sq, int Sk,
                                int H, int KV, int D, int causal, int window,
                                int n_pad, void* stream) {
  return launch<float>(q, k, v, q_pos, k_pos, map, out, B, Sq, Sk, H, KV, D,
                       causal, window, n_pad, stream);
}

extern "C" int prefill_attn_bf16(const void* q, const void* k, const void* v,
                                 const void* q_pos, const void* k_pos,
                                 void* map, void* out, int B, int Sq, int Sk,
                                 int H, int KV, int D, int causal, int window,
                                 int n_pad, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, q_pos, k_pos, map, out, B, Sq, Sk, H,
                               KV, D, causal, window, n_pad, stream);
}
