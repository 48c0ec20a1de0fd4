// Flash-decode GQA attention: one new query token over a KV cache, the
// cache split over the blocks of a thread-block cluster.
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
// float32 or bfloat16 in, float32 scores, softmax and accumulation, output
// in q's dtype.  (The scores are kept in the log2 domain, s * log2(e), so
// that each weight is one exp2.)  A masked slot adds exp(NEG - m) = 0 once
// any slot is live; if none is, every slot weighs 1, the uniform average
// the oracle's softmax over -1e30 gives too.  The oracle rounds the
// normalised probabilities to q's dtype before the PV product; in bf16
// this kernel rounds the unnormalised ones (they feed the tensor cores),
// in float32 it keeps them, so bf16 agrees to 2e-2 and float32 to 2e-5,
// not bit for bit.
//
// Bound: bytes.  A call must read K and V once (2 * B*T*KV*D elements:
// 2.62 MB in bf16 at qwen3-4b's B = 4, T = 256, KV = 8, D = 80; 83.9 MB at
// T = 8192, 335.5 MB at T = 32,768), q and cache_pos, and write out: 0.1 ms
// at T = 32,768 on an H100.  The arithmetic is about 4 operations a cache
// byte at G = 4, but in CUDA-core code each costs more than one
// instruction (bf16 unpacking, q reloads, shuffles), and on the card that
// was a limit: in an all-FMA form of this design float32, twice the bytes
// through the same arithmetic, took far less than twice bf16's time.  So
// in bf16 both products go to the tensor cores
// (mma.sync m16n8k16 with q's heads as the A rows: 4 of 16 rows live at
// G = 4, where wgmma's 64-row tile would be 94% padding); float32 stays on
// the FMA pipe.  The other limit was the loads: per-thread cp.async stalled
// the warps that issued it for most of a tile, so the tiles come by TMA.
//
// Design against that bound:
//
// * T split over a cluster.  The grid is B*KV*ceil(G/4) clusters of P
//   blocks (P <= 8, the portable cluster size, chosen by the wrapper's
//   `split_plan`: about 99 blocks, three quarters of the SMs, where T
//   allows, with no range shorter than one tile; on the card 96 blocks
//   streamed a long cache faster than 64, 128 or 256).  A cluster takes
//   up to 4 query heads of one kv-group (G = 4 on the serving path: one
//   cluster a kv-head), and block r of it the slots [r*T/P, (r+1)*T/P),
//   so every byte of K and V crosses device memory once and the group's
//   heads share it.
// * Loads.  Each tile of K and of V (8 warps x kSlots slots: 256 in bf16
//   at D <= 80) is one TMA box of the cache seen as a 2D tensor
//   [B*T, KV*D], issued by one thread and counted on the stage's mbarrier,
//   into a ring of two stages: the next tile streams in while this one is
//   consumed.  Rows past the tensor come as zeros; rows past the range are
//   real data that weigh 0.  One barrier a tile, which frees the stage
//   read a tile earlier; cache_pos comes by cp.async beside it.
// * Scores and the online softmax, warp by warp.  Each warp owns kSlots
//   slots of every tile and keeps its own flash state (running max m and
//   sum l per head).  bf16: two m16n8k16 products per 16 dims and 16 slots
//   (q in A fragments held in registers, ldmatrix'd K rows as B); a head's
//   scores land in one lane quad, whose shuffles give the tile's max and
//   sum.  float32: four lanes a slot, each reading its 16-byte words of K
//   once for all 4 heads; shuffles finish the dot products and the tile's
//   max and sum.
// * PV.  bf16: the score fragments, rounded, are P's A fragments as they
//   stand (no trip through shared memory) and V^T comes by ldmatrix.trans
//   into accumulator fragments.  float32: lane (16-byte word c, slot group
//   j) accumulates acc[4 heads][c's values] in registers over its slots,
//   reading each V word once for all 4 heads; the groups are summed once,
//   after the range.  No block barrier inside a tile.
// * Merge.  After the range the block merges its 8 warps' states, and
//   after a cluster.sync() (every block past its range, so rank 0's ring
//   is free) pushes (acc, m, l) into rank 0's shared memory through
//   distributed shared memory (map_shared_rank); after a second
//   cluster.sync() rank 0 merges the blocks in rank order with 2^(m_r - M)
//   weights and writes out.  (Rank 0 pulling from its peers took several
//   microseconds more.)
//   A state with m = -inf (no slot) weighs 0, and its own updates use 0 in
//   place of m, so no 2^(-inf - -inf) = NaN arises.  One launch, no scratch
//   in device memory, no memset, no atomics: the merge order is fixed and
//   a repeat call gives the same bits.
//
// Takes D * sizeof(T) a multiple of 16 bytes, D <= 128 and, in bf16, D a
// multiple of 16; 16-byte aligned q, K and V and B*T < 2^31 (the wrapper
// checks).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 2;             // smem ring of K / V tiles
constexpr int kHeads = 4;              // query heads a cluster takes
constexpr int kMaxD = 128;
constexpr int kMaxWords = kMaxD / 16;  // float32 16-byte words a lane reads
constexpr int kMaxCluster = 8;
constexpr float kNeg = -3.0e38f;
constexpr size_t kDefaultSmem = 48 * 1024;
static_assert(kHeads == 4, "a slot's probabilities are one float4");


// A 16-byte word of a K or V row as float32 values.
template <typename T>
struct Word;
template <>
struct Word<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& w, float* f) {
    f[0] = __uint_as_float(w.x);
    f[1] = __uint_as_float(w.y);
    f[2] = __uint_as_float(w.z);
    f[3] = __uint_as_float(w.w);
  }
};
template <>
struct Word<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& w, float* f) {
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
};

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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
// mbarrier of a ring stage: armed with the bytes its tile brings, passed
// when they have landed.
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// TMA: the box of `map` at (column c0, row c1) global -> shared (rows
// past the tensor filled with zeros), counted on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// Four 8x8 b16 matrices from shared memory (lanes 8j..8j+7 give the row
// addresses of matrix j), as mma.sync B fragments; .trans transposes each.
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

// c[0..1] += rows 0..7 of A (16 x 16 bf16, rows 8..15 zero) * B (16 x 8
// bf16), float32: the lane's two values of row lane/4 (rows 8..15 of the
// product are zero and dropped).
__device__ __forceinline__ void mma_bf16(float* c, unsigned a0, unsigned a2,
                                         unsigned b0, unsigned b1) {
  float d2, d3;
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %11, %12, %13};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(d2), "=f"(d3)
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1), "f"(c[0]),
        "f"(c[1]), "f"(0.0f), "f"(0.0f));
  (void)d2;
  (void)d3;
}

// Two float32 values as one register of bf16 (lo in the low half).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ bool is_live(int cp, int pos, int window) {
  return cp >= 0 && cp <= pos && (window <= 0 || cp > pos - window);
}


// Dynamic shared memory of one block, in bytes: 128 bytes to align the
// ring, the K / V ring (dense rows, as TMA writes them), its mbarriers and
// cache_pos, then (all float32) q of the cluster's heads and the warps'
// probabilities of a tile (both float32 inputs only), and the warps' max
// and sum after the range.  The warps' accumulators and the blocks' merged
// states, which rank 0 gathers, reuse the ring after the range.  (ops.py's
// smem_bytes mirrors it.)
template <typename T, int kSlots>
size_t smem_bytes(int D) {
  constexpr int kTile = kWarps * kSlots;
  return 128
         + static_cast<size_t>(kStages)
               * (2 * kTile * D * sizeof(T) + sizeof(uint64_t)
                  + kTile * sizeof(int))
         + sizeof(float)
               * (static_cast<size_t>(kHeads) * D
                  + kWarps * (kSlots + 2) * kHeads);
}

template <typename T, int kSlots>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const int* __restrict__ cache_pos, T* __restrict__ out,
                   int Tn, int H, int KV, int D, int pos, int window, int P) {
  using W = Word<T>;
  constexpr int kVec = W::kN;
  constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  constexpr int kTile = kWarps * kSlots;
  static_assert(kSlots % (kMma ? 16 : 8) == 0, "whole mma k-steps / quads");
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = H / KV;
  const int chunks = (G + kHeads - 1) / kHeads;
  const int cid = blockIdx.x / P;
  const int h0 = (cid % chunks) * kHeads;     // first head of the cluster
  const int bk = cid / chunks;
  const int b = bk / KV, kv = bk % KV;
  const int nheads = min(kHeads, G - h0);
  const int nvec = D / kVec;                  // 16-byte words of a row
  const int ld = D;                           // ring row pitch, elements
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int quad = lane >> 2, qlane = lane & 3;
  const int lo = static_cast<int>(static_cast<long long>(rank) * Tn / P);
  const int hi = static_cast<int>(static_cast<long long>(rank + 1) * Tn / P);
  // scores in the log2 domain: s * log2(e), so that exp(s - m) is one
  // exp2 of a difference
  const float scale =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(D)));

  const size_t tile = static_cast<size_t>(kTile) * ld;   // elements
  // [kStages][K, V][kTile][ld], 128-byte aligned for TMA
  T* ring = reinterpret_cast<T*>(
      smem + ((128 - (smem_addr(smem) & 127)) & 127));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * 2 * tile);
  int* sCpos = reinterpret_cast<int*>(full + kStages);   // [kStages][kTile]
  // q of the cluster's heads (float32 only; bf16 holds q in registers)
  float* sQ = reinterpret_cast<float*>(sCpos + kStages * kTile);
  float* sP = sQ + kHeads * D;                   // [kWarps][slot][kHeads]
  float* sM = sP + kWarps * kSlots * kHeads;     // [kWarps][kHeads]
  float* sL = sM + kWarps * kHeads;              // [kWarps][kHeads]
  float* wP = sP + warp * kSlots * kHeads;       // [slot][kHeads]
  // after the range, in the ring: the warps' accumulators, then (rank 0's)
  // every block's merged (acc, m, l), pushed there by the block
  float* sPart = reinterpret_cast<float*>(ring);  // [kWarps][kHeads][D]
  float* sRed = sPart + kWarps * kHeads * D;     // [P][kHeads * (D + 2)]
  const int red = kHeads * (D + 2);              // floats of one block's

  const size_t q0 =
      (static_cast<size_t>(b) * H + static_cast<size_t>(kv) * G + h0) * D;
  if constexpr (!kMma) {
    for (int i = tid; i < kHeads * D; i += kThreads)
      sQ[i] = i / D < nheads ? q[q0 + i] : 0.0f;
  }

  // K / V loads: thread 0 arms the stage's mbarrier with the tile's bytes
  // and issues one TMA box of K and one of V (kTile rows of [B*T, KV*D]
  // from row b*T + t0, columns kv*D..+D); the first kTile threads bring
  // cache_pos
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(full + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {   // tile `it` -> stage it % kStages
    const int t0 = lo + it * kTile;
    if (t0 < hi) {
      const int st = it % kStages;
      if (tid == 0) {
        T* dk = ring + static_cast<size_t>(st) * 2 * tile;
        mbar_expect(full + st,
                    2 * kTile * D * static_cast<int>(sizeof(T)));
        tma_load_2d(dk, &tm_k, kv * D, b * Tn + t0, full + st);
        tma_load_2d(dk + tile, &tm_v, kv * D, b * Tn + t0, full + st);
      }
      for (int row = tid; row < kTile; row += kThreads)
        cp_async4(sCpos + st * kTile + row,
                  cache_pos + (t0 + row < hi ? t0 + row : lo), t0 + row < hi);
    }
    cp_async_commit();   // an empty group past the range keeps the count
  };
  const int n_tiles = (hi - lo + kTile - 1) / kTile;
  for (int it = 0; it < kStages - 1; ++it) issue(it);

  // bf16: q's heads as mma A fragments, rows 0..7 (the first nheads live;
  // rows 8..15 are zero), one pair of registers per 16 dims
  unsigned qa[kMaxD / 16][2];
  if constexpr (kMma) {
    const unsigned* q32 = reinterpret_cast<const unsigned*>(q + q0);
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) {
      const bool ok = kk * 16 < D && quad < nheads;
      const int col = kk * 16 + 2 * qlane;
      qa[kk][0] = ok ? q32[(quad * D + col) / 2] : 0u;
      qa[kk][1] = ok ? q32[(quad * D + col + 8) / 2] : 0u;
    }
  }

  // PV (float32): lane -> (16-byte word pc, slot group pj)
  const int groups = 32 / nvec;
  const int pj = lane / nvec, pc = lane - pj * nvec;

  // the warp's flash state and this lane's share of its accumulator.  bf16:
  // m[0], l[0] of head `quad` (the lanes of a quad agree) and o, the
  // accumulator fragments of head `quad`, dims nd*8 + 2*qlane + {0, 1};
  // float32: m, l of every head (all lanes agree) and acc, 4 heads x the
  // values of word pc summed over slot group pj
  float m[kHeads], l[kHeads], acc[kHeads][kVec], o[kMaxD / 8][2];
#pragma unroll
  for (int h = 0; h < kHeads; ++h) {
    m[h] = -CUDART_INF_F;
    l[h] = 0.0f;
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[h][e] = 0.0f;
  }
#pragma unroll
  for (int nd = 0; nd < kMaxD / 8; ++nd) o[nd][0] = o[nd][1] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStages;
    cp_async_wait<kStages - 2>();   // this thread's cache_pos of tile `it`
    mbar_wait(full + st, (it / kStages) & 1);     // the tile's K and V
    __syncthreads();                // all cache_pos; stage (it-1) is free
    issue(it + kStages - 1);
    const T* tk = ring + static_cast<size_t>(st) * 2 * tile
                  + static_cast<size_t>(warp) * kSlots * ld;
    const T* tv = tk + tile;
    const int* cpw = sCpos + st * kTile + warp * kSlots;
    const int t_warp = lo + it * kTile + warp * kSlots;

    if constexpr (kMma) {
      // S (heads x kSlots slots) = Q K^T: c[nb][e] is slot nb*8 + 2*qlane
      // + e of head `quad`; one ldmatrix.x4 gives two n-blocks' B fragments
      float c[kSlots / 8][2] = {};
      const int mat = lane >> 3;    // ldmatrix: lane -> a row of matrix mat
#pragma unroll
      for (int kk = 0; kk < kMaxD / 16; ++kk) {
        if (kk * 16 < D) {
#pragma unroll
          for (int np = 0; np < kSlots / 16; ++np) {
            unsigned bk4[4];
            ldmatrix_x4(tk + static_cast<size_t>((2 * np + (mat >> 1)) * 8
                                                 + (lane & 7)) * ld
                            + (mat & 1) * 8 + kk * 16,
                        bk4);
            mma_bf16(c[2 * np], qa[kk][0], qa[kk][1], bk4[0], bk4[1]);
            mma_bf16(c[2 * np + 1], qa[kk][0], qa[kk][1], bk4[2], bk4[3]);
          }
        }
      }
      float s[kSlots / 4], mt = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kSlots / 4; ++i) {
        const int j = (i >> 1) * 8 + 2 * qlane + (i & 1);   // slot
        float x = -CUDART_INF_F;      // beyond the range: weighs 0
        if (t_warp + j < hi)
          x = is_live(cpw[j], pos, window) ? c[i >> 1][i & 1] * scale : kNeg;
        s[i] = x;
        mt = fmaxf(mt, x);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[0], mt);
      const float m_use = m_new == -CUDART_INF_F ? 0.0f : m_new;
      float ps = 0.0f;
#pragma unroll
      for (int i = 0; i < kSlots / 4; ++i) {
        s[i] = exp2f(s[i] - m_use);
        ps += s[i];
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      const float corr = exp2f(m[0] - m_use);
      m[0] = m_new;
      l[0] = l[0] * corr + ps;

      // O += P V: the score fragments are P's A fragments (rounded to bf16,
      // as the oracle rounds its probabilities), V^T comes by ldmatrix.trans
#pragma unroll
      for (int nd = 0; nd < kMaxD / 8; ++nd) {
        o[nd][0] *= corr;
        o[nd][1] *= corr;
      }
#pragma unroll
      for (int ks = 0; ks < kSlots / 16; ++ks) {  // 16 slots a k-step
        const unsigned pa0 = pack_bf16(s[4 * ks], s[4 * ks + 1]);
        const unsigned pa2 = pack_bf16(s[4 * ks + 2], s[4 * ks + 3]);
        const T* vaddr =
            tv + static_cast<size_t>(ks * 16 + (mat & 1) * 8 + (lane & 7))
                     * ld + (mat >> 1) * 8;
#pragma unroll
        for (int kk = 0; kk < kMaxD / 16; ++kk) {
          if (kk * 16 < D) {
            unsigned bv4[4];
            ldmatrix_x4_trans(vaddr + kk * 16, bv4);
            mma_bf16(o[2 * kk], pa0, pa2, bv4[0], bv4[1]);
            mma_bf16(o[2 * kk + 1], pa0, pa2, bv4[2], bv4[3]);
          }
        }
      }
    } else {
      // four lanes a slot: slots quad + 8i of the warp's
      constexpr int kRounds = kSlots / 8;
      float dot[kRounds][kHeads] = {};
#pragma unroll
      for (int j = 0; j < kMaxWords; ++j) {
        const int c = qlane + 4 * j;
        if (c < nvec) {
          float kf[kRounds][kVec];
#pragma unroll
          for (int i = 0; i < kRounds; ++i)
            W::unpack(*reinterpret_cast<const uint4*>(
                          tk + static_cast<size_t>(quad + 8 * i) * ld
                          + c * kVec),
                      kf[i]);
#pragma unroll
          for (int h = 0; h < kHeads; ++h) {
            const float4 qv =
                *reinterpret_cast<const float4*>(sQ + h * D + c * kVec);
#pragma unroll
            for (int i = 0; i < kRounds; ++i)
              dot[i][h] += qv.x * kf[i][0] + qv.y * kf[i][1]
                           + qv.z * kf[i][2] + qv.w * kf[i][3];
          }
        }
      }
      float s[kRounds][kHeads], mt[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) mt[h] = -CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < kRounds; ++i) {
        const int j = quad + 8 * i;
        const bool in_range = t_warp + j < hi;
        const bool live = in_range && is_live(cpw[j], pos, window);
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
          float d = dot[i][h];
          d += __shfl_xor_sync(0xffffffffu, d, 1);
          d += __shfl_xor_sync(0xffffffffu, d, 2);
          s[i][h] = !in_range ? -CUDART_INF_F : (live ? d * scale : kNeg);
          mt[h] = fmaxf(mt[h], s[i][h]);
        }
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int h = 0; h < kHeads; ++h)
          mt[h] = fmaxf(mt[h], __shfl_xor_sync(0xffffffffu, mt[h], off));
      }
      float ps[kHeads], corr[kHeads];
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        const float m_new = fmaxf(m[h], mt[h]);
        const float m_use = m_new == -CUDART_INF_F ? 0.0f : m_new;
        ps[h] = 0.0f;
#pragma unroll
        for (int i = 0; i < kRounds; ++i) {
          s[i][h] = exp2f(s[i][h] - m_use);
          ps[h] += s[i][h];
        }
        corr[h] = exp2f(m[h] - m_use);
        m[h] = m_new;
      }
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
        for (int h = 0; h < kHeads; ++h)
          ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], off);
      }
#pragma unroll
      for (int h = 0; h < kHeads; ++h) l[h] = l[h] * corr[h] + ps[h];
      if (qlane == 0) {
#pragma unroll
        for (int i = 0; i < kRounds; ++i)
          *reinterpret_cast<float4*>(wP + (quad + 8 * i) * kHeads) =
              make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
      }
      __syncwarp();

      // PV for this lane's word and slot group, skipping the rescale when
      // no head's max moved
      if (corr[0] != 1.0f || corr[1] != 1.0f || corr[2] != 1.0f
          || corr[3] != 1.0f) {
#pragma unroll
        for (int h = 0; h < kHeads; ++h) {
#pragma unroll
          for (int e = 0; e < kVec; ++e) acc[h][e] *= corr[h];
        }
      }
      if (pj < groups) {
        for (int r = pj; r < kSlots; r += groups) {
          float vf[kVec];
          W::unpack(*reinterpret_cast<const uint4*>(
                        tv + static_cast<size_t>(r) * ld + pc * kVec),
                    vf);
          const float4 pr =
              *reinterpret_cast<const float4*>(wP + r * kHeads);
          const float prs[kHeads] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
          for (int h = 0; h < kHeads; ++h) {
#pragma unroll
            for (int e = 0; e < kVec; ++e) acc[h][e] += prs[h] * vf[e];
          }
        }
      }
    }
  }

  // the warp's state into shared memory (the ring is free: every tile
  // issued was waited for)
  __syncthreads();
  if constexpr (kMma) {
    if (quad < kHeads) {
#pragma unroll
      for (int nd = 0; nd < kMaxD / 8; ++nd) {
        if (nd * 8 < D) {
          float* dst = sPart + (warp * kHeads + quad) * D + nd * 8 + 2 * qlane;
          dst[0] = o[nd][0];
          dst[1] = o[nd][1];
        }
      }
      if (qlane == 0) {
        sM[warp * kHeads + quad] = m[0];
        sL[warp * kHeads + quad] = l[0];
      }
    }
  } else {
    // acc: the slot groups summed in group order
#pragma unroll
    for (int h = 0; h < kHeads; ++h) {
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        float a = acc[h][e];
        for (int g = 1; g < groups; ++g)
          a += __shfl_sync(0xffffffffu, acc[h][e], (lane + g * nvec) & 31);
        if (lane < nvec)
          sPart[(warp * kHeads + h) * D + lane * kVec + e] = a;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int h = 0; h < kHeads; ++h) {
        sM[warp * kHeads + h] = m[h];
        sL[warp * kHeads + h] = l[h];
      }
    }
  }
  __syncthreads();

  // the block's state, its warps' merged in warp order, pushed into rank
  // 0's shared memory once every block of the cluster is past its range
  cluster.sync();
  float* dst = cluster.map_shared_rank(sRed, 0) + rank * red;
  for (int item = tid; item < kHeads * D; item += kThreads) {
    const int h = item / D;
    float M = -CUDART_INF_F;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sM[w * kHeads + h]);
    const float Mu = M == -CUDART_INF_F ? 0.0f : M;
    float a = 0.0f, lb = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(sM[w * kHeads + h] - Mu);
      a += f * sPart[w * kHeads * D + item];
      lb += f * sL[w * kHeads + h];
    }
    dst[item] = a;
    if (item - h * D == 0) {
      dst[kHeads * D + h] = M;
      dst[kHeads * (D + 1) + h] = lb;
    }
  }
  cluster.sync();   // the pushes have landed; the other blocks may leave

  // rank 0 merges the blocks in rank order and writes out
  if (rank == 0) {
    for (int item = tid; item < nheads * D; item += kThreads) {
      const int h = item / D;
      float M = -CUDART_INF_F;
      for (int r = 0; r < P; ++r) M = fmaxf(M, sRed[r * red + kHeads * D + h]);
      const float Mu = M == -CUDART_INF_F ? 0.0f : M;
      float a = 0.0f, lb = 0.0f;
      for (int r = 0; r < P; ++r) {
        const float* part = sRed + r * red;
        const float f = exp2f(part[kHeads * D + h] - Mu);
        a += f * part[item];
        lb += f * part[kHeads * (D + 1) + h];
      }
      out[q0 + item] = from_float<T>(a / fmaxf(lb, 1e-30f));
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

// The K or V cache as a 2D tensor [B*T rows, KV*D columns] whose boxes are
// one kv-head's D columns of `rows` consecutive slots.
template <typename T>
bool tensor_map(CUtensorMap* map, const T* base, int B, int Tn, int KV,
                int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(KV) * D,
                              static_cast<cuuint64_t>(B) * Tn};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(KV) * D * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(D),
                             static_cast<cuuint32_t>(rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map,
                std::is_same<T, __nv_bfloat16>::value
                    ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, const_cast<T*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
         == CUDA_SUCCESS;
}

template <typename T, int kSlots>
int launch_slots(const T* q, const T* k, const T* v, const int* cache_pos,
                 T* out, int B, int Tn, int H, int KV, int D, int pos,
                 int window, int P, cudaStream_t stream) {
  CUtensorMap tm_k, tm_v;
  if (!tensor_map(&tm_k, k, B, Tn, KV, D, kWarps * kSlots)
      || !tensor_map(&tm_v, v, B, Tn, KV, D, kWarps * kSlots))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes<T, kSlots>(D);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_kernel<T, kSlots>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int chunks = (H / KV + kHeads - 1) / kHeads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B * KV * chunks * P));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(P);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, decode_attn_kernel<T, kSlots>, q, tm_k, tm_v,
                         cache_pos, out, Tn, H, KV, D, pos, window, P);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* cache_pos,
           void* out, int B, int Tn, int H, int KV, int D, int pos,
           int window, int P, void* stream) {
  if (B <= 0 || Tn <= 0 || KV <= 0 || D <= 0 || D > kMaxD || H % KV != 0
      || P < 1 || P > kMaxCluster || (D * sizeof(T)) % 16 != 0
      || (std::is_same<T, __nv_bfloat16>::value && D % 16 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* qt = static_cast<const T*>(q);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* cp = static_cast<const int*>(cache_pos);
  auto* ot = static_cast<T*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  // slots a warp takes of each tile: in bf16 32 (four n-blocks of the score
  // mma, two k-steps of PV) up to D = 80 and 16 above, in float32 8, so
  // that two stages of 8 warps' tiles fit a block's shared memory
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (D <= 80)
      return launch_slots<T, 32>(qt, kt, vt, cp, ot, B, Tn, H, KV, D, pos,
                                 window, P, st);
    return launch_slots<T, 16>(qt, kt, vt, cp, ot, B, Tn, H, KV, D, pos,
                               window, P, st);
  } else {
    return launch_slots<T, 8>(qt, kt, vt, cp, ot, B, Tn, H, KV, D, pos,
                              window, P, st);
  }
}

}  // namespace

// q [B, H, D]; k, v [B, T, KV, D]; cache_pos [T] int32; out [B, H, D] in
// q's dtype.  window <= 0 means full attention; P the blocks of a cluster
// (1..8).  Returns the launch's cudaError_t (0 on success).
extern "C" int decode_attn_f32(const void* q, const void* k, const void* v,
                               const void* cache_pos, void* out, int B, int T,
                               int H, int KV, int D, int pos, int window,
                               int P, void* stream) {
  return launch<float>(q, k, v, cache_pos, out, B, T, H, KV, D, pos, window,
                       P, stream);
}

extern "C" int decode_attn_bf16(const void* q, const void* k, const void* v,
                                const void* cache_pos, void* out, int B,
                                int T, int H, int KV, int D, int pos,
                                int window, int P, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, cache_pos, out, B, T, H, KV, D, pos,
                               window, P, stream);
}
