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
// for its bytes (q, k, v and out once).  Two designs, by dtype.
//
// bf16 (the serving, prefill and encode paths): warp-specialised blocks on
// wgmma, fed by TMA.
// * A kv-group's heads in one block: the rows of a block's 128-row tile are
//   (query position, head) pairs of one kv head, the G heads of a position
//   side by side (q[b, i, kv*G : (kv+1)*G, :] is G*D contiguous elements),
//   so each K / V tile is read once for all G heads.  A tile holds
//   Pt = 128 / G whole positions (126 rows at G = 6, 96 at G = 48; the rest
//   stay zero); G > 128 is cut into chunks of 128 heads.  One 5D TMA box
//   (64 columns, G heads, 1 kv head, Pt positions, 1 sequence) loads it;
//   positions past Sq are zero-filled.  Each row carries its own q_pos, so
//   the masks stay exact.
// * Roles: warpgroup 0 is the producer (one warp issues; it gives up
//   registers with setmaxnreg), warpgroups 1 and 2 the consumers, 64 rows
//   each (setmaxnreg to 232).  The producer keeps TMA loads of 128-key K
//   and V tiles in flight through two-stage rings of full / empty
//   mbarriers, one for K and one for V (a consumer frees tile j's K after
//   its softmax and its V after its P V, which lands in iteration j + 1),
//   q's tile double-buffered, and decides itself which key
//   tiles to issue: a warp reads a tile's 128 key positions (from shared
//   memory, where the block copies k_pos once when it fits), tests each
//   against the tile's smallest and largest q_pos (the float32 design's
//   tile map, with no launch of its own) and skips a tile masked for every
//   row; it passes the positions and a "whole" flag (every key live for
//   every row: no mask) with the stage, and ends a work item with a stage
//   that carries no tile.
// * Both products on wgmma with float32 accumulators (bf16 x bf16 products
//   are exact in float32): S = Q K^T (m64n128k16) reads q's tile and the K
//   tile from shared memory in the 128-byte swizzle TMA writes; O += P V
//   (m64nNk16, N = D rounded up to 64, 80 or 128) takes P from registers,
//   the score fragments rounded to bf16
//   in place (the accumulator's layout is the A fragment's), and V through
//   the descriptor's transpose (MN-major) bit.
// * D = 80: the 128-byte swizzle atom is 64 bf16 wide, so a row of D > 64
//   columns is two 64-column boxes, the second zero-filled past D by TMA
//   (the tensor map's innermost extent is D).  S = Q K^T runs ceil(D / 16)
//   16-deep steps (5 at D = 80: the zero columns are never read); O += P V
//   is one m64n80k16 whose N crosses from the first atom to the second
//   (the descriptor's leading offset).
// * Grid: persistent, one block an SM, walking the (sequence, kv head,
//   head chunk, tile) work items with the latest positions (the longest
//   causal tiles) first, so a short problem (hubert's encode: 256 items)
//   runs no second, nearly empty wave.
//
// float32 (the [prefill] and [train_parity] parity paths): CUDA-core FMA
// (no TF32: the reference's float32 products are float32), a block of 4
// warps a (query head, 64-query tile, sequence), 16 rows a warp in the mma
// fragment layout, K / V tiles of 32 keys by cp.async into a two-stage
// ring (rows padded by 16 bytes), after a first launch that builds the
// tile maps (key tiles that may hold a live key for a query tile; key
// tiles live for every row, which skip the mask).  Folding the scale into
// the exp2's argument and skipping the mask on whole tiles took the first
// bf16 design from 2.57 to 2.43 ms at mixtral's prefill (an H100 SXM at
// 700 W), so the score-wise work is a minor share.
//
// Takes D a multiple of 16 up to 128, 16-byte aligned q, K and V, int32
// positions and n_pad < 2^31 (the wrapper checks).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <climits>

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
  constexpr int kNB = kBK / 8;          // 8-key column blocks of a tile
  constexpr int kE = 16 / sizeof(T);    // elements of a 16-byte word
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

  cp_async_wait<1>();   // q's tile (the first key tile may still fly)
  __syncthreads();

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

int launch_f32(const void* q, const void* k, const void* v,
               const void* q_pos, const void* k_pos, void* map, void* out,
               int B, int Sq, int Sk, int H, int KV, int D, int causal,
               int window, int n_pad, cudaStream_t st) {
  // key rows of a tile: 32 (the padded float32 rows are 528 bytes at
  // D = 128), so that two blocks fit an SM
  constexpr int kBK = 32;
  if ((Sq + kBQ - 1) / kBQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int n_words = ((Sk + kBK - 1) / kBK + 31) / 32;
  auto* m = static_cast<unsigned*>(map);
  tile_map_kernel<<<n_qt, kMapThreads, 0, st>>>(
      static_cast<const int*>(q_pos), static_cast<const int*>(k_pos), m, Sq,
      Sk, causal, window, kBK, n_words);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* qt = static_cast<const float*>(q);
  const auto* kt = static_cast<const float*>(k);
  const auto* vt = static_cast<const float*>(v);
  const auto* qp = static_cast<const int*>(q_pos);
  const auto* kp = static_cast<const int*>(k_pos);
  auto* ot = static_cast<float*>(out);
  // registers for q's and the output's fragments up to the head's width
  if (D <= 64)
    return launch_attn<float, kBK, 64>(qt, kt, vt, qp, kp, m, ot, B, Sq, Sk,
                                       H, KV, D, causal, window, n_pad,
                                       n_words, st);
  return launch_attn<float, kBK, 128>(qt, kt, vt, qp, kp, m, ot, B, Sq, Sk,
                                      H, KV, D, causal, window, n_pad,
                                      n_words, st);
}


// ---------------------------------------------------------------------------
// bf16: the warp-specialised wgmma kernel.

constexpr int kWgThreads = 384;   // a producer and two consumer warpgroups
constexpr int kRows = 128;        // packed (position, head) rows of a tile
constexpr int kBN = 128;          // keys of a K / V tile
constexpr int kStages = 2;        // the K / V ring
constexpr int kBox = 64;          // bf16 columns of a 128-byte swizzle atom
constexpr int kBoxBytes = 128 * 128;   // 64 columns of 128 rows
// registers a thread after setmaxnreg: 128 * 40 + 256 * 232 = 64,512 of
// the SM's 65,536 (the launch gives each of the 384 threads 168)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr size_t kMaxSmem = 232448;   // a block's opt-in shared memory

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
// an arrival that also arms the barrier with the bytes a TMA load brings
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
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(smem_addr(bar))
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2, int c3,
                                            int c4, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(smem_addr(bar))
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

// Named barriers 1 and 2 order the two consumer warpgroups' products:
// warpgroup w waits on 1 + w for its turn and hands the turn to the other
// once its products are issued (256 threads: both warpgroups).
__device__ __forceinline__ void turn_wait(int cw) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + cw) : "memory");
}
__device__ __forceinline__ void turn_pass(int cw) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - cw) : "memory");
}

// wgmma's shared-memory matrix descriptor of a tile in the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units).
// K-major (q, K): the stride offset steps 8 rows (1,024 bytes), the leading
// one is unused.  MN-major (V): the leading offset steps from one 64-column
// atom to the next, the stride offset 8 keys.
__device__ __forceinline__ uint64_t smem_desc(const void* p, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((smem_addr(p) >> 4) & 0x3FFFu)
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
// keeps the compiler from moving a use or a definition of a wgmma's
// registers across a wgmma fence, issue or wait (an operand defined after
// the fence serializes the products)
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(unsigned (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
  }
}

// d (64 x 128, float32) (+)= A (64 x 16, q's tile in shared memory) *
// B (16 x 128, K's tile, K-major): S = Q K^T a 16-deep step.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x N, float32) += A (64 x 16 bf16, in registers: P's fragments) *
// B (16 x N, V's tile, MN-major: the transpose bit set): O += P V a
// 16-key step, N = the head dim rounded up to 64, 80 or 128.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const unsigned (&a)[4], uint64_t db);

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32],
                                            const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<80>(float (&d)[40],
                                            const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                            const unsigned (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


struct WgArgs {
  const int* q_pos;
  const int* k_pos;
  const __nv_bfloat16* v;   // the dead rows' sums
  __nv_bfloat16* out;
  int B, Sq, Sk, H, KV, D, G;
  int Gs;       // heads of a tile (G, or 128 for G > 128)
  int Pt;       // positions of a tile: 128 / Gs
  int n_mt, n_gc, n_work;
  int causal, window, n_pad;
  int kpos_cached;   // k_pos copied to shared memory after the mbarriers
};

// Work item w: its sequence, kv head, first head and first position; the
// tiles of the latest positions (the longest causal ones) first.
struct Work {
  int b, kv, g0, p0;
};
__device__ __forceinline__ Work work_item(const WgArgs& a, int w) {
  const int per = a.B * a.KV * a.n_gc;
  const int mt = a.n_mt - 1 - w / per;
  int r = w % per;
  const int gc = r % a.n_gc;
  r /= a.n_gc;
  return {r / a.KV, r % a.KV, gc * a.Gs, mt * a.Pt};
}

// kD: the head dim rounded up to 64, 80 or 128 (the columns past D read
// as zeros).  Shared memory: two q tiles, the K and V rings (each tile
// kNBox boxes of 64 columns x 128 rows), the stages' key positions and
// (key tile, whole) words, and the mbarriers; 1,024-byte aligned for the
// swizzle.
template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
prefill_attn_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const WgArgs a) {
  constexpr int kNBox = kD > kBox ? 2 : 1;
  constexpr int kTile = kNBox * kBoxBytes;    // q's tile, a K or a V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* sK = sQ + 2 * kTile;
  unsigned char* sV = sK + kStages * kTile;
  int* sKp = reinterpret_cast<int*>(sV + kStages * kTile);
  int2* sInfo = reinterpret_cast<int2*>(sKp + kStages * kBN);
  uint64_t* full_k = reinterpret_cast<uint64_t*>(sInfo + kStages);
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;
  uint64_t* empty_v = empty_k + kStages;
  uint64_t* qfull = empty_v + kStages;
  uint64_t* qempty = qfull + 2;
  int* sKpos = reinterpret_cast<int*>(qempty + 2);   // [Sk] if cached
  const int tid = threadIdx.x;
  const int n_kt = (a.Sk + kBN - 1) / kBN;

  // the rows past Gs * Pt of q's tiles never get a TMA write: zeros
  for (int i = tid; i < 2 * kTile / 16; i += kWgThreads)
    reinterpret_cast<uint4*>(sQ)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 32);     // the producer warp's lanes, K's bytes
      mbar_init(&full_v[s], 1);      // V's bytes
      mbar_init(&empty_k[s], 256);   // every consumer thread
      mbar_init(&empty_v[s], 256);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&qfull[i], 1);
      mbar_init(&qempty[i], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the key positions, which the producer tests for every key tile of
  // every item, once from device memory when they fit
  if (a.kpos_cached) {
    for (int j = tid; j < a.Sk; j += kWgThreads) sKpos[j] = a.k_pos[j];
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int* kpos = a.kpos_cached ? sKpos : a.k_pos;

  if (tid < 128) {
    // ---- producer: one warp
    setmaxnreg_dec<kProducerRegs>();
    if (tid >= 32) return;
    const int lane = tid;
    int st = 0, item = 0;
    unsigned ph = 0;
    for (int w = blockIdx.x; w < a.n_work; w += gridDim.x, ++item) {
      const Work wk = work_item(a, w);
      int lo = INT_MAX, hi = INT_MIN;
      for (int i = lane; i < a.Pt && wk.p0 + i < a.Sq; i += 32) {
        const int p = a.q_pos[wk.p0 + i];
        lo = min(lo, p);
        hi = max(hi, p);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      const int qb = item & 1;
      if (lane == 0) {
        mbar_wait(&qempty[qb], ((item >> 1) & 1) ^ 1);
        mbar_arrive_expect(&qfull[qb], kNBox * 128 * a.Gs * a.Pt);
        for (int x = 0; x < kNBox; ++x)
          tma_load_5d(sQ + qb * kTile + x * kBoxBytes, &tm_q, x * kBox, wk.g0,
                      wk.kv, wk.p0, wk.b, &qfull[qb]);
      }
      for (int kt = 0; kt < n_kt; ++kt) {
        // lane i tests keys 4i..4i+3 of the tile (-1 past Sk)
        int kp[4];
        bool any = false, all = true;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = kt * kBN + lane * 4 + e;
          kp[e] = j < a.Sk ? kpos[j] : -1;
          any = any || (is_live(kp[e], hi, a.causal, 0)
                        && (a.window <= 0 || is_live(kp[e], lo, 0, a.window)));
          all = all && is_live(kp[e], lo, a.causal, 0)
                && (a.window <= 0 || is_live(kp[e], hi, 0, a.window));
        }
        if (!__any_sync(0xffffffffu, any)) continue;   // masked for every row
        const bool whole = __all_sync(0xffffffffu, all);
        // K (with the tile's positions and word) and V fill rings of their
        // own, freed at different times: K once the tile's softmax has
        // read its scores, V once its P V has landed
        mbar_wait(&empty_k[st], ph ^ 1);
#pragma unroll
        for (int e = 0; e < 4; ++e) sKp[st * kBN + lane * 4 + e] = kp[e];
        if (lane == 0) {
          sInfo[st] = make_int2(kt, whole ? 1 : 0);
          mbar_arrive_expect(&full_k[st], kTile);
          for (int x = 0; x < kNBox; ++x)
            tma_load_4d(sK + st * kTile + x * kBoxBytes, &tm_k, x * kBox,
                        wk.kv, kt * kBN, wk.b, &full_k[st]);
        } else {
          mbar_arrive(&full_k[st]);
        }
        if (lane == 0) {
          mbar_wait(&empty_v[st], ph ^ 1);
          mbar_arrive_expect(&full_v[st], kTile);
          for (int x = 0; x < kNBox; ++x)
            tma_load_4d(sV + st * kTile + x * kBoxBytes, &tm_v, x * kBox,
                        wk.kv, kt * kBN, wk.b, &full_v[st]);
        }
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
      // the item's end: a stage with no tile (V's barriers pass a phase
      // too, in step with K's)
      mbar_wait(&empty_k[st], ph ^ 1);
      if (lane == 0) {
        sInfo[st] = make_int2(-1, 0);
        mbar_wait(&empty_v[st], ph ^ 1);
        mbar_arrive(&full_v[st]);
      }
      mbar_arrive(&full_k[st]);
      if (++st == kStages) {
        st = 0;
        ph ^= 1;
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of a tile
  setmaxnreg_inc<kConsumerRegs>();
  const int ct = tid - 128;
  const int cw = ct >> 7, warp = (ct >> 5) & 3, lane = ct & 31;
  const int t4 = lane & 3;
  // the thread's two rows (accumulator rows lane / 4 and + 8 of its warp)
  const int r0 = cw * 64 + warp * 16 + (lane >> 2);
  // scores in the log2 domain: s * log2(e), so that exp(s - m) is one
  // exp2 of a difference
  const float scale =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(a.D)));
  int st = 0, item = 0;
  unsigned ph = 0;
  if (cw == 1) turn_pass(0);   // warpgroup 0 issues first
  auto advance = [&]() {
    if (++st == kStages) {
      st = 0;
      ph ^= 1;
    }
  };
  for (int w = blockIdx.x; w < a.n_work; w += gridDim.x, ++item) {
    const Work wk = work_item(a, w);
    int pr[2], hr[2], qp[2];
    bool ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const int gg = wk.g0 + r % a.Gs;
      pr[i] = wk.p0 + r / a.Gs;
      hr[i] = wk.kv * a.G + gg;
      ok[i] = r < a.Gs * a.Pt && pr[i] < a.Sq && gg < a.G;
      qp[i] = ok[i] ? a.q_pos[pr[i]] : 0;
    }
    // running max (log2 domain), sum and accumulator of the two rows:
    // o[4 nb + e] is column 8 nb + 2 t4 + (e & 1) of row r0 (e < 2) or
    // r0 + 8 (e >= 2)
    float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F, l0 = 0.0f, l1 = 0.0f;
    float o[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) o[i] = 0.0f;
    const int qb = item & 1;
    mbar_wait(&qfull[qb], (item >> 1) & 1);
    const unsigned char* qa = sQ + qb * kTile + cw * 64 * 128;

    // S = Q K^T of stage t's tile: s[4 nb + e] is key 8 nb + 2 t4 + (e & 1)
    float s[64];
    auto issue_qk = [&](int t) {
      const unsigned char* tk = sK + t * kTile;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        wgmma_qk(s, smem_desc(qa + (kk >> 2) * kBoxBytes + (kk & 3) * 32, 16,
                              1024),
                 smem_desc(tk + (kk >> 2) * kBoxBytes + (kk & 3) * 32, 16,
                           1024),
                 kk > 0);
      wgmma_commit();
    };
    // O += P V of stage t's tile (16 keys a step)
    unsigned pa[kBN / 16][4];
    auto issue_pv = [&](int t) {
      const unsigned char* tv = sV + t * kTile;
#pragma unroll
      for (int ks = 0; ks < kBN / 16; ++ks)
        wgmma_pv<kD>(o, pa[ks], smem_desc(tv + ks * 16 * 128, kBoxBytes,
                                          1024));
      wgmma_commit();
    };
    // the mask of stage t's tile (a tile live for every row needs none;
    // keys past Sk have position -1) and the online softmax of its
    // scores, the scale inside the exp2's argument, fmaf(s, scale, -m):
    // the new running max and sum, the factor c0 / c1 for the output so
    // far, and the unnormalised probabilities in s
    float c0, c1;
    auto softmax = [&](int t, bool whole) {
      if (!whole) {
        const int* kp = sKp + t * kBN;
#pragma unroll
        for (int nb = 0; nb < kBN / 8; ++nb) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (!is_live(kp[nb * 8 + 2 * t4 + (e & 1)], qp[e >> 1], a.causal,
                         a.window))
              s[4 * nb + e] = -CUDART_INF_F;
          }
        }
      }
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < kBN / 8; ++nb) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * nb], s[4 * nb + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * nb + 2], s[4 * nb + 3]));
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
      for (int nb = 0; nb < kBN / 8; ++nb) {
        s[4 * nb] = exp2f(fmaf(s[4 * nb], scale, -mu0));
        s[4 * nb + 1] = exp2f(fmaf(s[4 * nb + 1], scale, -mu0));
        s[4 * nb + 2] = exp2f(fmaf(s[4 * nb + 2], scale, -mu1));
        s[4 * nb + 3] = exp2f(fmaf(s[4 * nb + 3], scale, -mu1));
        ps0 += s[4 * nb] + s[4 * nb + 1];
        ps1 += s[4 * nb + 2] + s[4 * nb + 3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
        ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
      }
      c0 = exp2f(m0 - mu0);
      c1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;
      l0 = l0 * c0 + ps0;
      l1 = l1 * c1 + ps1;
      hold(s);   // the exps before the wait for the product in flight
    };
    // once the last product has landed: the output so far rescaled, and
    // the probabilities rounded to bf16 into P's A fragments as they stand
    // (the accumulator's layout is the A fragment's)
    auto rescale = [&]() {
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
        o[4 * nb] *= c0;
        o[4 * nb + 1] *= c0;
        o[4 * nb + 2] *= c1;
        o[4 * nb + 3] *= c1;
      }
#pragma unroll
      for (int ks = 0; ks < kBN / 16; ++ks) {
        pa[ks][0] = pack_bf16(s[8 * ks], s[8 * ks + 1]);
        pa[ks][1] = pack_bf16(s[8 * ks + 2], s[8 * ks + 3]);
        pa[ks][2] = pack_bf16(s[8 * ks + 4], s[8 * ks + 5]);
        pa[ks][3] = pack_bf16(s[8 * ks + 6], s[8 * ks + 7]);
      }
    };

    // Tile j's S = Q K^T is issued before tile j - 1's O += P V, and its
    // softmax runs while that product is in flight; the output is
    // rescaled once the product has landed.  The two warpgroups take
    // turns to issue (ping-pong), so one's softmax runs while the other's
    // products keep the tensor cores busy.
    mbar_wait(&full_k[st], ph);
    int2 info = sInfo[st];
    if (info.x >= 0) {
      turn_wait(cw);
      wgmma_fence();
      issue_qk(st);
      turn_pass(cw);
      wgmma_wait<0>();
      hold(s);
      softmax(st, info.y != 0);
      mbar_arrive(&empty_k[st]);
      rescale();
      int pst = st;
      unsigned pph = ph;
      advance();
      while (true) {
        mbar_wait(&full_k[st], ph);
        info = sInfo[st];
        if (info.x < 0) break;
        hold(o);
        hold(pa);
        turn_wait(cw);
        wgmma_fence();
        issue_qk(st);
        mbar_wait(&full_v[pst], pph);
        issue_pv(pst);
        turn_pass(cw);
        wgmma_wait<1>();   // S has landed; O += P V may still fly
        hold(s);
        softmax(st, info.y != 0);
        mbar_arrive(&empty_k[st]);    // tile j's K, positions and word
        wgmma_wait<0>();
        hold(o);
        mbar_arrive(&empty_v[pst]);   // tile j - 1's V
        rescale();
        pst = st;
        pph = ph;
        advance();
      }
      mbar_wait(&full_v[pst], pph);
      hold(o);
      hold(pa);
      turn_wait(cw);
      wgmma_fence();
      issue_pv(pst);
      turn_pass(cw);
      wgmma_wait<0>();
      hold(o);
      mbar_arrive(&empty_v[pst]);
    }
    // the item's last stage, which has no tile
    mbar_arrive(&empty_k[st]);
    mbar_arrive(&empty_v[st]);
    advance();
    mbar_arrive(&qempty[qb]);   // q's tile is read

    // out = acc / max(l, 1e-30); a row with no live key (a dead row) takes
    // the reference's sum of every v over n_pad
    const bool dead0 = ok[0] && m0 == -CUDART_INF_F;
    const bool dead1 = ok[1] && m1 == -CUDART_INF_F;
    float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    if (dead0 || dead1) {
      const size_t kstride = static_cast<size_t>(a.KV) * a.D;
      const __nv_bfloat16* vb = a.v + static_cast<size_t>(wk.b) * a.Sk * kstride
                                + static_cast<size_t>(wk.kv) * a.D + 2 * t4;
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float sum = 0.0f;
          for (int j = 0; nb * 8 < a.D && j < a.Sk; ++j)
            sum += __bfloat162float(vb[j * kstride + nb * 8 + e]);
          if (dead0) o[4 * nb + e] = sum;
          if (dead1) o[4 * nb + 2 + e] = sum;
        }
      }
      if (dead0) d0 = static_cast<float>(a.n_pad);
      if (dead1) d1 = static_cast<float>(a.n_pad);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!ok[i]) continue;
      const float d = i ? d1 : d0;
      __nv_bfloat16* orow =
          a.out + (static_cast<size_t>(wk.b) * a.Sq + pr[i]) *
                      (static_cast<size_t>(a.H) * a.D)
          + static_cast<size_t>(hr[i]) * a.D + 2 * t4;
#pragma unroll
      for (int nb = 0; nb < kD / 8; ++nb) {
        if (nb * 8 < a.D)
          store2(orow + nb * 8, o[4 * nb + 2 * i] / d,
                 o[4 * nb + 2 * i + 1] / d);
      }
    }
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
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess
        && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map in the 128-byte swizzle (elements outside the tensor
// read as zeros).
bool bf16_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode != nullptr
         && encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   static_cast<cuuint32_t>(rank), const_cast<void*>(base),
                   dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
                == CUDA_SUCCESS;
}

// Dynamic shared memory of the wgmma kernel, in bytes (ops.py's
// smem_bytes mirrors it): the alignment slack, two q tiles and the K / V
// rings, the stages' key positions and words, the mbarriers.
size_t wg_smem_bytes(int D) {
  const size_t tile = (D > kBox ? 2 : 1) * static_cast<size_t>(kBoxBytes);
  return 1024 + (2 + 2 * kStages) * tile + kStages * kBN * sizeof(int)
         + kStages * sizeof(int2) + (4 * kStages + 4) * sizeof(uint64_t);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      n = 0;
  }
  return n;
}

template <int kD>
int launch_wgmma(const void* q, const void* k, const void* v,
                 const void* q_pos, const void* k_pos, void* out, int B,
                 int Sq, int Sk, int H, int KV, int D, int causal,
                 int window, int n_pad, cudaStream_t stream) {
  const int G = H / KV, Gs = G < kRows ? G : kRows, Pt = kRows / Gs;
  const int n_gc = (G + Gs - 1) / Gs;
  const long long n_mt = (Sq + Pt - 1) / Pt;
  const long long n_work = n_mt * B * KV * n_gc;
  const int sms = sm_count();
  if (n_work >= INT_MAX || sms <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // q as [B][Sq][KV][G][D]: a box is 64 columns of Gs heads of one kv head
  // at Pt positions of one sequence; K / V as [B][Sk][KV][D]: 64 columns of
  // 128 keys of one kv head
  const cuuint64_t e = sizeof(__nv_bfloat16);
  const cuuint64_t qdims[5] = {static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(G),
                               static_cast<cuuint64_t>(KV),
                               static_cast<cuuint64_t>(Sq),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t qstrides[4] = {D * e, G * D * e, H * D * e,
                                  static_cast<cuuint64_t>(Sq) * H * D * e};
  const cuuint32_t qbox[5] = {kBox, static_cast<cuuint32_t>(Gs), 1,
                              static_cast<cuuint32_t>(Pt), 1};
  const cuuint64_t kdims[4] = {static_cast<cuuint64_t>(D),
                               static_cast<cuuint64_t>(KV),
                               static_cast<cuuint64_t>(Sk),
                               static_cast<cuuint64_t>(B)};
  const cuuint64_t kstrides[3] = {D * e, KV * D * e,
                                  static_cast<cuuint64_t>(Sk) * KV * D * e};
  const cuuint32_t kbox[4] = {kBox, 1, kBN, 1};
  CUtensorMap tm_q, tm_k, tm_v;
  if (!bf16_map(&tm_q, q, 5, qdims, qstrides, qbox)
      || !bf16_map(&tm_k, k, 4, kdims, kstrides, kbox)
      || !bf16_map(&tm_v, v, 4, kdims, kstrides, kbox))
    return static_cast<int>(cudaErrorInvalidValue);
  // the key positions join the tiles in shared memory when they fit
  const size_t kpos_bytes = static_cast<size_t>(Sk) * sizeof(int);
  const bool cached = wg_smem_bytes(kD) + kpos_bytes <= kMaxSmem;
  const size_t smem = wg_smem_bytes(kD) + (cached ? kpos_bytes : 0);
  cudaError_t err = cudaFuncSetAttribute(
      prefill_attn_wgmma_kernel<kD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const WgArgs args{static_cast<const int*>(q_pos),
                    static_cast<const int*>(k_pos),
                    static_cast<const __nv_bfloat16*>(v),
                    static_cast<__nv_bfloat16*>(out),
                    B, Sq, Sk, H, KV, D, G, Gs, Pt,
                    static_cast<int>(n_mt), n_gc,
                    static_cast<int>(n_work), causal, window, n_pad,
                    cached ? 1 : 0};
  const int grid = n_work < sms ? static_cast<int>(n_work) : sms;
  prefill_attn_wgmma_kernel<kD><<<grid, kWgThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, args);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16(const void* q, const void* k, const void* v,
                const void* q_pos, const void* k_pos, void* out, int B,
                int Sq, int Sk, int H, int KV, int D, int causal, int window,
                int n_pad, cudaStream_t st) {
  // three widths of the accumulator and of O += P V's N: 64 (D <= 64),
  // 80 (D = 80: qwen3-4b, hubert-xlarge) and 128 (mixtral, jamba,
  // granite); the columns past D are zeros and are not stored
  if (D <= 64)
    return launch_wgmma<64>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H, KV, D,
                            causal, window, n_pad, st);
  if (D <= 80)
    return launch_wgmma<80>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H, KV, D,
                            causal, window, n_pad, st);
  return launch_wgmma<128>(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H, KV, D,
                           causal, window, n_pad, st);
}

bool valid(int B, int Sq, int Sk, int H, int KV, int D, int n_pad) {
  return B > 0 && Sq > 0 && Sk > 0 && KV > 0 && H % KV == 0 && D > 0
         && D <= 128 && D % 16 == 0 && n_pad >= Sk && B <= 65535;
}

}  // namespace

// q [B, Sq, H, D]; k, v [B, Sk, KV, D]; q_pos [Sq], k_pos [Sk] int32; out
// [B, Sq, H, D] in q's dtype.  causal 0 / 1; window <= 0 means none; n_pad
// = ceil(Sk / chunk) * chunk.  float32: `map` is int32 scratch of
// 2 * ceil(Sq / 64) * ceil(ceil(Sk / 32) / 32) words, and a call is two
// launches (the tile map, the attention); bf16: `map` is unused, and a call
// is one launch.  On `stream`; returns the first failing launch's
// cudaError_t (0 on success).
extern "C" int prefill_attn_f32(const void* q, const void* k, const void* v,
                                const void* q_pos, const void* k_pos,
                                void* map, void* out, int B, int Sq, int Sk,
                                int H, int KV, int D, int causal, int window,
                                int n_pad, void* stream) {
  if (!valid(B, Sq, Sk, H, KV, D, n_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_f32(q, k, v, q_pos, k_pos, map, out, B, Sq, Sk, H, KV, D,
                    causal, window, n_pad, static_cast<cudaStream_t>(stream));
}

extern "C" int prefill_attn_bf16(const void* q, const void* k, const void* v,
                                 const void* q_pos, const void* k_pos,
                                 void* map, void* out, int B, int Sq, int Sk,
                                 int H, int KV, int D, int causal, int window,
                                 int n_pad, void* stream) {
  (void)map;
  if (!valid(B, Sq, Sk, H, KV, D, n_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_bf16(q, k, v, q_pos, k_pos, out, B, Sq, Sk, H, KV, D, causal,
                     window, n_pad, static_cast<cudaStream_t>(stream));
}
