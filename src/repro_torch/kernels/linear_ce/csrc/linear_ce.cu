// The training loss: LM head product, log-softmax cross-entropy and its
// backward, without the float32 logits in device memory.
//
// Replaces no TPU kernel: it computes the reference's
// `chunked_cross_entropy` (src/repro/models/layers.py:131-173), which the
// reference leaves to XLA as a scan over sequence chunks:
//
//   logits = f32(h @ W), columns >= vocab = -1e30          h [N, d], W [d, V]
//   lse    = m + log sum exp(logits - m)                    m the row max
//   gold   = logits[label], valid = label >= 0
//   loss   = sum (lse - gold) valid / max(sum valid, 1)
//
// and its backward under the loss's cotangent g:
//
//   dl = dtype(g / max(cnt, 1) valid (exp(logits - lse) - onehot)), 0 on
//        the padded columns;  dh = dl @ W^T,  dW = h^T @ dl  (float32 sums)
//
// in four kernels:
//
//   K1 fwd      logits tiles with an online log-sum-exp epilogue: an item is
//               a row tile and one vocab split (contiguous vocab tiles);
//               each row's (max, sum exp, gold if its label is in the split)
//               go to float32 partials [3, n_split, N]
//   combine     one block forms lse [N], the loss sum and the count, in a
//               fixed order (no atomics: repeats are bit-identical); a
//               vocab-sharded head gathers every rank's K1 partials first
//               and combines them all (its own entry point)
//   K2 dlogits  the same logits tiles again; the epilogue writes dl in the
//               model dtype (rows of one backward pass)
//   K3 gemm     out [M, N] = A [M, K] @ B [K, N] with float32 sums, for
//               dh = dl @ W^T (K = V long: split-K, float32 partials, the
//               last split of a tile to arrive sums them in split order) and
//               dW = h^T @ dl (optionally adding a float32 running sum, for
//               more than one pass)
//
// What bounds it: operations.  Its products are 6 N d V FLOP a call (2 for
// the forward, 4 for the backward) plus the recompute of the logits in K2
// (2 more): at qwen3-4b's [train] shape (N = 2,048, d = 2,560, V = 153,600)
// 6.4 TFLOP, against some 2 GB of operand and dl bytes.  So the bf16 route
// is built on the tensor cores: a persistent block an SM, warp-specialised
// (a producer warpgroup at setmaxnreg 56 whose one lane issues TMA loads,
// two consumer warpgroups at 224, each 64 rows of a 128 x 256 float32
// accumulator on wgmma m64n256k16), 64-deep k-tiles through a 4-stage ring
// of 48 KB on full / empty mbarriers (the mainloop of
// moe_ffn/csrc/moe_ffn.cu's moe_wgmma_kernel).  TMA loads every operand as
// stored, in the 128-byte swizzle: a K-major operand (its K contiguous) as
// one box of 64 x rows, an MN-major one as 64 x 64 boxes that wgmma reads
// through its transpose bit.  So the untied head [d, V] (V contiguous) and
// the tied one, table [V, d] read through table.T, both feed the kernels
// without a copy; so do dl [N, V] and h [N, d] as either operand of K3.
// 2,048 rows are only 16 row tiles, so the forward splits the vocabulary
// (the wrapper picks the split that balances the items over the SMs) and
// dh splits its K.
//
// The epilogue.  K2 writes dl [N, V] and K3-dW a bf16 [d, V], 0.63 and
// 0.79 GB at [train]'s shape, a 128 x 256 tile (64 KB) an item.  Stored
// from the accumulators as 4-byte words (a warp's instruction half-fills
// eight 32-byte sectors) they held the tensor cores idle: on an H100 at
// 700 W, removing the stores took 0.32 ms off K2's 2.65 and 0.54 off
// dW's 2.97, removing K2's exp only 0.06.  So the output leaves by TMA:
// each consumer warp rounds its 16 rows to bf16 a 64-column quarter at a
// time into a 16 x 64 box in shared memory, in the 128-byte swizzle (a
// warp's 4-byte writes fill the 32 banks once), and its lane 0 issues the
// box's bulk tensor store and goes on; the stores drain under the next
// item's products.  Each warp has two boxes and reuses one once its last
// store has read it (cp.async.bulk.wait_group.read 1): the warps never
// wait for each other.  Why this schedule and not ping-pong (each
// consumer warpgroup a tile of its own, one's epilogue under the other's
// products): a warpgroup's own 64 x 256 or 128 x 128 tile loads 40 or 32
// KB a k-tile for half the products of the cooperative 128 x 256 tile's
// 48 KB, 1.67 or 1.33 times the shared-memory fill and L2 traffic a
// FLOP, where the 128 x 256 tile already moves 128 bytes a clock through
// the SM's shared memory (TMA fills 48, the two warpgroups' wgmma read
// 80).  The budget: the ring keeps 4 stages (192 KB) and the boxes take
// 8 warps x 2 x 2 KB = 32 KB, 230,480 of the 232,448 bytes a block may
// use; a whole staged tile (64 KB) would cost a stage, and 3 stages leave
// the producer one k-tile ahead.  K1 keeps its register epilogue (no
// store), dh's split partials and a K3 with c_in or a float32 out keep
// the consumers' own stores.  Not used: clusters of two blocks that
// multicast the B tile their row tiles share (K1, K2, dW), bit-equal but
// 34-63% slower on the card, each stage waiting for both blocks'
// releases.
//
// The float32 route is a parity check: one plain CUDA-core
// tile design (64 x 64 tiles, 4 x 4 a thread, strided loads of any layout,
// no TF32).
//
// A head of a vocab-sharded model holds the columns [col0, col0 + V) of the
// vocabulary: a label outside them counts its row but names no column here
// (no gold, no one-hot), and vocab (this shard's live columns) may be 0.
//
// Every launch runs on the caller's stream; the C entry points return the
// first launch error (0 when all launched), or kErrSizes / kErrNoSms /
// kErrMap - CUresult for what they refuse before launching.  K2's scale
// (the loss's cotangent on the loss sum, g / max(cnt, 1)) is read on the
// device: no host sync.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstdint>

namespace {

constexpr float kMaskValue = -1e30f;     // the reference's padded columns
constexpr size_t kMaxSmem = 232448;      // a block's opt-in shared memory

// bf16 route: 128 rows x 256 columns x 64 deep, 4 stages, 384 threads
constexpr int kBM = 128;
constexpr int kBN = 256;
constexpr int kBK = 64;
constexpr int kStages = 4;
constexpr int kWgThreads = 384;
constexpr int kABytes = kBM * kBK * 2;          // A's k-tile
constexpr int kBBytes = kBN * kBK * 2;          // B's k-tile
constexpr int kBoxBytes = 64 * kBK * 2;         // a 64 x 64 box
constexpr int kStageBytes = kABytes + kBBytes;
// the staged epilogue: a consumer warp's 16 rows x 64 columns of bf16
// output a TMA store, two such boxes a warp (double-buffered), 8 warps
constexpr int kOutRows = 16;
constexpr int kOutBox = kOutRows * 64 * 2;
constexpr int kOutBytes = 8 * 2 * kOutBox;
// registers a thread after setmaxnreg: 128 * 56 + 256 * 224 = 64,512 of
// the SM's 65,536 (the launch gives each of the 384 threads 168)
constexpr int kProducerRegs = 56;
constexpr int kConsumerRegs = 224;
// the alignment slack, the ring, the output boxes, a full and an empty
// mbarrier a stage, the split sum's flag (ref.py's smem_bytes mirrors it)
constexpr size_t kWgSmem = 1024 + static_cast<size_t>(kStages) * kStageBytes +
                           kOutBytes + 2 * kStages * 8 + 16;
static_assert(kWgSmem <= kMaxSmem, "the ring exceeds a block's shared memory");

// float32 route: 64 x 64 tiles, 16 deep, 256 threads
constexpr int kSM = 64;
constexpr int kSN = 64;
constexpr int kSK = 16;
constexpr int kSimtThreads = 256;
constexpr int kSumBlock = 16;          // k-tiles summed apart (256 k)

constexpr int kCombineThreads = 1024;

// what an entry point returns besides a cudaError_t
constexpr int kErrSizes = -1;          // sizes or options the kernels refuse
constexpr int kErrNoSms = -2;          // the card's SM count is unknown
constexpr int kErrMap = -1000;         // minus the CUresult of a TMA map

// what a launch computes
constexpr int kFwd = 0;
constexpr int kDlogits = 1;
constexpr int kGemm = 2;

struct Args {
  // the operands: A [M, K], B [K, N], stored K-major or MN-major (the bf16
  // route reads them through TMA maps; the float32 route by these strides
  // in elements: A(m, k) = a[m * sam + k * sak], B(k, n) = b[k * sbk + n *
  // sbn]).  K1 / K2: A = h (M = rows, K = d), B = the head (N = V).
  const void* a;
  const void* b;
  int64_t sam, sak, sbk, sbn;
  int M, N, K;
  // K1 / K2
  const int64_t* labels;   // [M], of the whole vocabulary
  int vocab, n_split;      // live columns of this head, K1's splits
  int col0;                // the vocabulary's column of this head's first
  float* part;             // K1: [3, n_split, M] max, sum exp, gold
  const float* lse;        // K2: [M]
  const float* scale;      // K2: the cotangent on the loss sum
  void* dl;                // K2: [M, N] in the model dtype
  // K3
  const float* c_in;       // [M, N] float32 added to the product, or null
  void* out;               // [M, N]: bf16, or float32 if out_f32
  float* work;             // [split, M, N] float32 partials (split > 1)
  int* sem;                // [row tiles * column tiles] arrivals, zeros
                           // at the launch
  int split, out_f32;
  // bf16 route, K3: a whole bf16 out leaves through shared memory by TMA
  // stores, as K2's dl always does (set by the launch)
  int tma_out;
};

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// row's label as a column of this head: -1 unlabelled, INT_MAX (no column)
// for a label of another shard's columns
__device__ __forceinline__ int column_of(const Args& p, int row) {
  const int64_t l = p.labels[row];
  if (l < 0) return -1;
  const int64_t c = l - p.col0;
  return c >= 0 && c < p.N ? static_cast<int>(c) : INT_MAX;
}

__device__ __forceinline__ int split_lo(int n_tiles, int n_split, int s) {
  return static_cast<int>(static_cast<int64_t>(s) * n_tiles / n_split);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// a pair of adjacent outputs (columns col, col + 1 of a row) in the model
// dtype
template <typename T>
__device__ __forceinline__ void store_pair(T* row, int col, float v0,
                                           float v1);
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* row,
                                                          int col, float v0,
                                                          float v1) {
  *reinterpret_cast<unsigned*>(row + col) = pack_bf16(v0, v1);
}
template <>
__device__ __forceinline__ void store_pair<float>(float* row, int col,
                                                  float v0, float v1) {
  *reinterpret_cast<float2*>(row + col) = make_float2(v0, v1);
}

// ---------------------------------------------------------------------------
// bf16: warp-specialised wgmma tiles fed by TMA
// ---------------------------------------------------------------------------

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
// an arrival that also arms the barrier with the bytes TMA loads bring
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
// TMA: the box of `map` at (c0, c1) (innermost first) global -> shared,
// zero-filled outside the tensor, counted on `bar`
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
// TMA: shared -> the box of `map` at (c0, c1), in the issuing thread's
// bulk async-group; elements outside the tensor are not written
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             unsigned src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of the thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until at most N of the thread's bulk groups are still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// the thread's shared-memory writes, visible to the TMA (async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void sts32(unsigned addr, unsigned v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
// a barrier of the two consumer warpgroups alone
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// wgmma's shared-memory matrix descriptor of a tile in the 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units).
// K-major: the stride offset steps 8 rows (1,024 bytes), the leading one is
// unused.  MN-major: the leading offset steps from one 64-element atom to
// the next (a box), the stride offset 8 k-rows.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo,
                                              unsigned sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFFu)
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
// keeps the compiler from moving a use or a definition of the
// accumulators across a wgmma fence, issue or wait (an operand defined
// after the fence serializes the products)
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256, float32) (+)= A (64 x 16) * B (16 x 256), a 16-deep step;
// TA / TB: the operand is MN-major (wgmma's transpose bit); accumulate = 0
// starts the sum.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t da,
                                          uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

// The work of a launch, as the persistent blocks walk it: item w (block b
// takes w = b, b + grid, ...) is row tile mt (the fastest, so the blocks
// that share a head tile run together and share it in L2) and the output
// column tiles [nt_lo, nt_hi) over the k-tiles [kt_lo, kt_hi): K1 a vocab
// split, K2 one vocab tile, K3 one column tile and one split of K.
struct Walk {
  int n_mt, n_nt, nk, n_items;
};
struct Item {
  int mt, nt_lo, nt_hi, kt_lo, kt_hi, s;
};

template <int MODE>
__device__ __forceinline__ Walk walk_of(const Args& p, int bm, int bn,
                                        int bk) {
  Walk wk;
  wk.n_mt = (p.M + bm - 1) / bm;
  wk.n_nt = (p.N + bn - 1) / bn;
  wk.nk = (p.K + bk - 1) / bk;
  wk.n_items = MODE == kFwd ? wk.n_mt * p.n_split
               : MODE == kDlogits ? wk.n_mt * wk.n_nt
                                  : wk.n_mt * wk.n_nt * p.split;
  return wk;
}

template <int MODE>
__device__ __forceinline__ Item item_of(const Args& p, const Walk& wk,
                                        int w) {
  Item it;
  it.mt = w % wk.n_mt;
  const int r = w / wk.n_mt;
  it.kt_lo = 0;
  it.kt_hi = wk.nk;
  it.s = 0;
  if (MODE == kFwd) {
    it.s = r;
    it.nt_lo = split_lo(wk.n_nt, p.n_split, r);
    it.nt_hi = split_lo(wk.n_nt, p.n_split, r + 1);
  } else if (MODE == kDlogits) {
    it.nt_lo = r;
    it.nt_hi = r + 1;
  } else {
    it.nt_lo = r % wk.n_nt;
    it.nt_hi = it.nt_lo + 1;
    it.s = r / wk.n_nt;
    it.kt_lo = split_lo(wk.nk, p.split, it.s);
    it.kt_hi = split_lo(wk.nk, p.split, it.s + 1);
  }
  return it;
}

// One launch of the bf16 route: a persistent block an SM.  Warpgroup 0 is
// the producer (one warp; its lane 0 issues the TMA loads, the other three
// warps leave after giving up their registers), warpgroups 1 and 2 the
// consumers: 64 rows each of the 128-row tile, float32 accumulators of
// 64 x 256.  A_MN / B_MN: the operand is stored MN-major (wgmma reads it
// through its transpose bit).
//   K1: A = h, B = the head; per vocab tile the running (max, sum exp) of
//       each row and its gold logit; at the item's end its partials.
//   K2: A = h, B = the head; dl = scale (exp(l - lse) - onehot).
//   K3: A, B as given; out (+ c_in), or a float32 partial and the split sum.
// K2, and K3 with p.tma_out (whole, into bf16): each consumer warp rounds
// its 16 rows of the tile to bf16 a quarter (64 columns) at a time into one of
// its two swizzled boxes in shared memory, and its lane 0 stores the box by
// TMA (tm_out) and goes on: the stores drain under the next item's
// products, and a box is written again once its store has read it.
template <int MODE, bool A_MN, bool B_MN, typename T>
__global__ void __launch_bounds__(kWgThreads, 1)
    lce_wgmma_kernel(const __grid_constant__ CUtensorMap tm_a,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_out,
                     const Args p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  unsigned char* outbox = ring + kStages * kStageBytes;   // 1,024-aligned
  auto* full = reinterpret_cast<uint64_t*>(outbox + kOutBytes);
  uint64_t* empty = full + kStages;
  auto* sFlag = reinterpret_cast<int*>(empty + kStages);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);        // the TMA loads' issuer
      mbar_init(&empty[s], 8);       // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const Walk wk = walk_of<MODE>(p, kBM, kBN, kBK);

  if (tid < 128) {
    // ---- producer: one warp of the warpgroup (lane 0 issues the loads)
    setmaxnreg_dec<kProducerRegs>();
    if (tid >= 32) return;
    int st = 0;
    unsigned ph = 0;
    for (int w = blockIdx.x; w < wk.n_items; w += gridDim.x) {
      const Item it = item_of<MODE>(p, wk, w);
      const int m0 = it.mt * kBM;
      for (int nt = it.nt_lo; nt < it.nt_hi; ++nt) {
        const int n0 = nt * kBN;
        for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
          mbar_wait(&empty[st], ph ^ 1);
          if (tid == 0) {
            unsigned char* sa = ring + st * kStageBytes;
            unsigned char* sb = sa + kABytes;
            const int k0 = kt * kBK;
            mbar_arrive_expect(&full[st], kStageBytes);
            if (A_MN) {
              tma_load_2d(sa, &tm_a, m0, k0, &full[st]);
              tma_load_2d(sa + kBoxBytes, &tm_a, m0 + 64, k0, &full[st]);
            } else {
              tma_load_2d(sa, &tm_a, k0, m0, &full[st]);
            }
            if (B_MN) {
#pragma unroll
              for (int j = 0; j < 4; ++j)
                tma_load_2d(sb + j * kBoxBytes, &tm_b, n0 + 64 * j, k0,
                            &full[st]);
            } else {
              tma_load_2d(sb, &tm_b, k0, n0, &full[st]);
            }
          }
          __syncwarp();
          if (++st == kStages) {
            st = 0;
            ph ^= 1;
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of a tile
  setmaxnreg_inc<kConsumerRegs>();
  const int ct = tid - 128;
  const int cw = ct >> 7, lane = ct & 31;
  const int t4 = lane & 3;
  // the thread's rows of the tile: accumulator rows lane / 4 and + 8 of
  // its warp; acc[4 nb + 2 hf + e] is column 8 nb + 2 t4 + e of row
  // rw + 8 hf
  const int rw = cw * 64 + ((ct >> 5) & 3) * 16 + (lane >> 2);
  const unsigned ring_addr = smem_addr(ring);
  // the warp's two output boxes; a thread's word of row r (lane / 4 + 8 hf)
  // and 8-column chunk j sits in the 128-byte swizzle at chunk j ^ (r % 8)
  const unsigned wbox = smem_addr(outbox) + (ct >> 5) * 2 * kOutBox;
  const int rbox = (ct >> 5 & 3) * 16 + cw * 64;
  // K2's scale, read on the device
  const float inv = MODE == kDlogits ? *p.scale : 0.0f;
  float acc[128];
  int st = 0;
  unsigned ph = 0;
  for (int w = blockIdx.x; w < wk.n_items; w += gridDim.x) {
    const Item it = item_of<MODE>(p, wk, w);
    const int m0 = it.mt * kBM;
    // the item's rows: label, running max, sum of exp, gold (K1); lse and
    // scale (K2)
    int lab[2];
    float rmax[2], rsum[2], gold[2], lse[2], scl[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int row = m0 + rw + 8 * hf;
      const bool in = row < p.M;
      lab[hf] = MODE != kGemm && in ? column_of(p, row) : -1;
      rmax[hf] = -CUDART_INF_F;
      rsum[hf] = 0.0f;
      gold[hf] = 0.0f;
      lse[hf] = MODE == kDlogits && in ? p.lse[row] : 0.0f;
      scl[hf] = lab[hf] >= 0 ? inv : 0.0f;
    }
    for (int nt = it.nt_lo; nt < it.nt_hi; ++nt) {
      int pst = 0;
      for (int kt = it.kt_lo; kt < it.kt_hi; ++kt) {
        mbar_wait(&full[st], ph);
        const unsigned sa = ring_addr + st * kStageBytes;
        const unsigned sb = sa + kABytes;
        hold(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da =
              A_MN ? smem_desc(sa + cw * kBoxBytes + kk * 16 * 128, kBoxBytes,
                               1024)
                   : smem_desc(sa + cw * 64 * 128 + kk * 32, 16, 1024);
          const uint64_t db =
              B_MN ? smem_desc(sb + kk * 16 * 128, kBoxBytes, 1024)
                   : smem_desc(sb + kk * 32, 16, 1024);
          wgmma_256<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db,
                                                kt > it.kt_lo || kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();               // k-tile kt - 1's products landed
        hold(acc);
        if (kt > it.kt_lo && lane == 0) mbar_arrive(&empty[pst]);
        pst = st;
        if (++st == kStages) {
          st = 0;
          ph ^= 1;
        }
      }
      wgmma_wait<0>();
      hold(acc);
      if (lane == 0) mbar_arrive(&empty[pst]);

      const int n0 = nt * kBN;
      if (MODE == kFwd) {
        // online log-sum-exp over the tile's 256 columns, a row's 64 of
        // them in each of a quad's 4 threads
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float tmax = -CUDART_INF_F;
#pragma unroll
          for (int nb = 0; nb < 32; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = n0 + nb * 8 + 2 * t4 + e;
              float& v = acc[4 * nb + 2 * hf + e];
              v = col < p.vocab ? v : kMaskValue;
              if (col == lab[hf]) gold[hf] = v;
              tmax = fmaxf(tmax, v);
            }
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
          const float mnew = fmaxf(rmax[hf], tmax);
          float s = 0.0f;
#pragma unroll
          for (int nb = 0; nb < 32; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              s += __expf(acc[4 * nb + 2 * hf + e] - mnew);
          rsum[hf] = rsum[hf] * __expf(rmax[hf] - mnew) + s;
          rmax[hf] = mnew;
        }
      } else if (MODE == kDlogits || p.tma_out) {
        // K2's dl, or a whole K3's bf16 out, through the warp's boxes
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const unsigned box = wbox + (q & 1) * kOutBox;
          if (lane == 0) bulk_wait_read<1>();   // the box's last store read
          __syncwarp();
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int nb = 8 * q + j;
              float v[2];
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                v[e] = acc[4 * nb + 2 * hf + e];
                if (MODE == kDlogits) {
                  const int c = n0 + nb * 8 + 2 * t4 + e;
                  const float q1 = __expf(v[e] - lse[hf]) -
                                   (c == lab[hf] ? 1.0f : 0.0f);
                  v[e] = c < p.vocab ? scl[hf] * q1 : 0.0f;
                }
              }
              sts32(box + ((lane >> 2) + 8 * hf) * 128 +
                        ((j ^ (lane >> 2)) << 4) + t4 * 4,
                    pack_bf16(v[0], v[1]));
            }
          fence_async_smem();
          __syncwarp();
          if (lane == 0) {
            const int c0 = n0 + 64 * q, r0 = m0 + rbox;
            if (c0 < p.N && r0 < p.M) tma_store_2d(&tm_out, box, c0, r0);
            bulk_commit();                      // empty if nothing stored
          }
        }
      } else {
        // K3: out (+ c_in), or this split's float32 partial and, from the
        // last split of the tile to arrive, the sum of all in split order
        const bool whole = p.split == 1;
        float* part = p.work + static_cast<int64_t>(it.s) * p.M * p.N;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = m0 + rw + 8 * hf;
          if (row >= p.M) continue;
          const int64_t base = static_cast<int64_t>(row) * p.N;
#pragma unroll
          for (int nb = 0; nb < 32; ++nb) {
            const int col = n0 + nb * 8 + 2 * t4;
            if (col >= p.N) continue;
            float v0 = acc[4 * nb + 2 * hf], v1 = acc[4 * nb + 2 * hf + 1];
            if (!whole) {
              *reinterpret_cast<float2*>(part + base + col) =
                  make_float2(v0, v1);
              continue;
            }
            if (p.c_in != nullptr) {
              const float2 c =
                  *reinterpret_cast<const float2*>(p.c_in + base + col);
              v0 += c.x;
              v1 += c.y;
            }
            if (p.out_f32)
              store_pair<float>(static_cast<float*>(p.out) + base, col, v0,
                                v1);
            else
              store_pair<__nv_bfloat16>(
                  static_cast<__nv_bfloat16*>(p.out) + base, col, v0, v1);
          }
        }
        if (!whole) {
          __threadfence();
          consumers_sync();
          const int tile = it.mt * wk.n_nt + it.nt_lo;
          if (ct == 0)
            *sFlag = atomicAdd(&p.sem[tile], 1) == p.split - 1;
          consumers_sync();
          if (*sFlag) {
            __threadfence();
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = m0 + rw + 8 * hf;
              if (row >= p.M) continue;
              const int64_t base = static_cast<int64_t>(row) * p.N;
              for (int nb = 0; nb < 32; ++nb) {
                const int col = n0 + nb * 8 + 2 * t4;
                if (col >= p.N) continue;
                float v0 = 0.0f, v1 = 0.0f;
                for (int s = 0; s < p.split; ++s) {
                  const float2 c = __ldcg(reinterpret_cast<const float2*>(
                      p.work + static_cast<int64_t>(s) * p.M * p.N + base +
                      col));
                  v0 += c.x;
                  v1 += c.y;
                }
                if (p.c_in != nullptr) {
                  const float2 c =
                      *reinterpret_cast<const float2*>(p.c_in + base + col);
                  v0 += c.x;
                  v1 += c.y;
                }
                if (p.out_f32)
                  store_pair<float>(static_cast<float*>(p.out) + base, col,
                                    v0, v1);
                else
                  store_pair<__nv_bfloat16>(
                      static_cast<__nv_bfloat16*>(p.out) + base, col, v0,
                      v1);
              }
            }
          }
        }
      }
    }
    if (MODE == kFwd) {
      // the item's partials: the quad's sums in a fixed order (its max is
      // already shared), the one gold logit of a label in the split
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float s = rsum[hf], gd = gold[hf];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        gd += __shfl_xor_sync(0xffffffffu, gd, 1);
        gd += __shfl_xor_sync(0xffffffffu, gd, 2);
        const int row = m0 + rw + 8 * hf;
        if (t4 == 0 && row < p.M) {
          const int64_t at = static_cast<int64_t>(it.s) * p.M + row;
          const int64_t plane = static_cast<int64_t>(p.n_split) * p.M;
          p.part[at] = rmax[hf];
          p.part[plane + at] = s;
          p.part[2 * plane + at] = gd;
        }
      }
    }
  }
  if (lane == 0) bulk_wait<0>();       // the last stores done
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
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2-D bf16 tensor map [rows][inner] (row-major) with a box of 64 x
// box_rows in the 128-byte swizzle (elements outside the tensor read as
// zeros).
CUresult bf16_map(CUtensorMap* map, const void* base, int inner, int rows,
                  int box_rows) {
  const EncodeTiled encode = encode_tiled();
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(inner) *
                                 sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The maps of A [M, K] and B [K, N] as stored: K-major A is [M][K] with
// 128-row boxes, MN-major A [K][M] with 64 x 64 boxes; K-major B is [N][K]
// with 256-row boxes, MN-major B [K][N] with 64 x 64 boxes.
CUresult operand_maps(const Args& p, bool a_mn, bool b_mn, CUtensorMap* a,
                      CUtensorMap* b) {
  const CUresult ra = a_mn ? bf16_map(a, p.a, p.M, p.K, 64)
                           : bf16_map(a, p.a, p.K, p.M, kBM);
  if (ra != CUDA_SUCCESS) return ra;
  return b_mn ? bf16_map(b, p.b, p.N, p.K, 64)
              : bf16_map(b, p.b, p.K, p.N, kBN);
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 0;
  }
  return n;
}

// The backward runs on autograd's device thread, where B11's launch may be
// the thread's first CUDA call: PyTorch selects the device there without
// making its context current, and cuTensorMapEncodeTiled, a driver call,
// then fails with CUDA_ERROR_INVALID_CONTEXT.  cudaSetDevice makes the
// device's primary context current in the calling thread.
cudaError_t bind_context() {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  return err != cudaSuccess ? err : cudaSetDevice(dev);
}

// The map of the output that leaves by TMA stores, and whether it does: K2's
// dl (its launch checks the rows and base), and a whole K3's bf16 out (no
// c_in) with 16-byte rows and base, each [M][N] in 64 x kOutRows boxes.
// Any other output keeps the consumers' own stores.
CUresult out_map(const Args& p, int mode, CUtensorMap* map, int* tma_out) {
  *tma_out = 0;
  const void* out = mode == kDlogits ? p.dl : p.out;
  const bool staged =
      mode == kDlogits ||
      (mode == kGemm && !p.out_f32 && p.c_in == nullptr && p.split == 1 &&
       p.N % 8 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0);
  if (!staged) return CUDA_SUCCESS;
  const CUresult res = bf16_map(map, out, p.N, p.M, kOutRows);
  *tma_out = res == CUDA_SUCCESS;
  return res;
}

template <int MODE, bool A_MN, bool B_MN, typename T>
int launch_wgmma(const Args& p, int items, cudaStream_t stream) {
  CUtensorMap a, b, o = {};
  const int sms = sm_count();
  if (sms <= 0) return kErrNoSms;
  const cudaError_t bound = bind_context();
  if (bound != cudaSuccess) return static_cast<int>(bound);
  Args q = p;
  CUresult res = operand_maps(p, A_MN, B_MN, &a, &b);
  if (res == CUDA_SUCCESS) res = out_map(p, MODE, &o, &q.tma_out);
  if (res != CUDA_SUCCESS) return kErrMap - static_cast<int>(res);
  auto kernel = lce_wgmma_kernel<MODE, A_MN, B_MN, T>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = items < sms ? items : sms;
  kernel<<<grid, kWgThreads, kWgSmem, stream>>>(a, b, o, q);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: CUDA-core tiles
// ---------------------------------------------------------------------------

// acc (4 x 4 a thread: rows ty * 4 + i, columns tx * 4 + j of the 64 x 64
// tile at (m0, n0)) = A [m0.., k] . B [k, n0..] over all of K, k-tiles of
// 16 double-buffered through registers; loads follow the operands'
// contiguous axis.  K is summed in blocks of kSumBlock, each block's sum
// added to the running one: dh's K is the vocabulary (153,600), and one
// running float32 sum over it drifts by ~1e-5 of the result.
__device__ __forceinline__ void simt_tile(const Args& p, int m0, int n0,
                                          float (&acc)[4][4],
                                          float (&sA)[2][kSK][kSM + 4],
                                          float (&sB)[2][kSK][kSN]) {
  const float* A = static_cast<const float*>(p.a);
  const float* B = static_cast<const float*>(p.b);
  const int tid = threadIdx.x;
  const bool a_k = p.sak == 1, b_n = p.sbn == 1;
  float ra[4], rb[4];
  auto a_at = [&](int j, int& m, int& k) {
    const int i = tid + kSimtThreads * j;
    if (a_k) { k = i & (kSK - 1); m = i / kSK; }
    else { m = i & (kSM - 1); k = i / kSM; }
  };
  auto b_at = [&](int j, int& k, int& n) {
    const int i = tid + kSimtThreads * j;
    if (b_n) { n = i & (kSN - 1); k = i / kSN; }
    else { k = i & (kSK - 1); n = i / kSK; }
  };
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int m, k, n;
      a_at(j, m, k);
      ra[j] = m0 + m < p.M && k0 + k < p.K
                  ? A[(m0 + m) * p.sam + (k0 + k) * p.sak]
                  : 0.0f;
      b_at(j, k, n);
      rb[j] = n0 + n < p.N && k0 + k < p.K
                  ? B[(k0 + k) * p.sbk + (n0 + n) * p.sbn]
                  : 0.0f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int m, k, n;
      a_at(j, m, k);
      sA[buf][k][m] = ra[j];
      b_at(j, k, n);
      sB[buf][k][n] = rb[j];
    }
  };
  const int tx = tid & 15, ty = tid >> 4;
  float blk[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = blk[i][j] = 0.0f;
  const int nk = (p.K + kSK - 1) / kSK;
  __syncthreads();                      // the previous tile's reads done
  fetch(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) fetch((kt + 1) * kSK);
#pragma unroll
    for (int k = 0; k < kSK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&sA[buf][k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sB[buf][k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) blk[i][j] = fmaf(av[i], bv[j], blk[i][j]);
    }
    if (kt % kSumBlock == kSumBlock - 1 || kt + 1 == nk) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] += blk[i][j];
          blk[i][j] = 0.0f;
        }
    }
    if (kt + 1 < nk) store(buf ^ 1);
    __syncthreads();
  }
}

// One launch of the float32 route, a block a (row tile, split) for K1, a
// tile for K2 and K3 (grid x: row tiles, y: splits or column tiles).  A
// row's 64 columns lie in the 16 threads tx of one half-warp.
template <int MODE>
__global__ void __launch_bounds__(kSimtThreads) lce_simt_kernel(const Args p) {
  __shared__ __align__(16) float sA[2][kSK][kSM + 4];
  __shared__ __align__(16) float sB[2][kSK][kSN];
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * kSM;
  const int n_nt = (p.N + kSN - 1) / kSN;
  int nt_lo = blockIdx.y, nt_hi = blockIdx.y + 1;
  if (MODE == kFwd) {
    nt_lo = split_lo(n_nt, p.n_split, blockIdx.y);
    nt_hi = split_lo(n_nt, p.n_split, blockIdx.y + 1);
  }
  int lab[4];
  float rmax[4], rsum[4], gold[4], lse[4], scl[4];
  const float inv = MODE == kDlogits ? *p.scale : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    const bool in = row < p.M;
    lab[i] = MODE != kGemm && in ? column_of(p, row) : -1;
    rmax[i] = -CUDART_INF_F;
    rsum[i] = 0.0f;
    gold[i] = 0.0f;
    lse[i] = MODE == kDlogits && in ? p.lse[row] : 0.0f;
    scl[i] = lab[i] >= 0 ? inv : 0.0f;
  }
  float acc[4][4];
  for (int nt = nt_lo; nt < nt_hi; ++nt) {
    const int n0 = nt * kSN;
    simt_tile(p, m0, n0, acc, sA, sB);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      if (MODE == kFwd) {
        float tmax = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx * 4 + j;
          float& v = acc[i][j];
          v = col < p.vocab ? v : kMaskValue;
          if (col == lab[i]) gold[i] = v;
          tmax = fmaxf(tmax, v);
        }
#pragma unroll
        for (int o = 1; o < 16; o <<= 1)
          tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
        const float mnew = fmaxf(rmax[i], tmax);
        float s = 0.0f;
#pragma unroll
        for (int j = 0; j < 4; ++j) s += expf(acc[i][j] - mnew);
        rsum[i] = rsum[i] * expf(rmax[i] - mnew) + s;
        rmax[i] = mnew;
      } else {
        if (row >= p.M) continue;
        const int64_t base = static_cast<int64_t>(row) * p.N;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = n0 + tx * 4 + j;
          if (MODE == kDlogits) {
            const float q = expf(acc[i][j] - lse[i]) -
                            (col == lab[i] ? 1.0f : 0.0f);
            v[j] = col < p.vocab ? scl[i] * q : 0.0f;
          } else {
            v[j] = acc[i][j] +
                   (p.c_in != nullptr && col < p.N ? p.c_in[base + col]
                                                   : 0.0f);
          }
        }
        float* out = static_cast<float*>(MODE == kDlogits ? p.dl : p.out);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n0 + tx * 4 + j < p.N) out[base + n0 + tx * 4 + j] = v[j];
      }
    }
  }
  if (MODE == kFwd) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float s = rsum[i], gd = gold[i];
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        gd += __shfl_xor_sync(0xffffffffu, gd, o);
      }
      const int row = m0 + ty * 4 + i;
      if (tx == 0 && row < p.M) {
        const int64_t at = static_cast<int64_t>(blockIdx.y) * p.M + row;
        const int64_t plane = static_cast<int64_t>(p.n_split) * p.M;
        p.part[at] = rmax[i];
        p.part[plane + at] = s;
        p.part[2 * plane + at] = gd;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the combine: lse, the loss sum and the count, one block, a fixed order
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kCombineThreads)
    lce_combine_kernel(const float* part, const int64_t* labels, float* lse,
                       float* stats, float* loss, int M, int n_split) {
  __shared__ float sTot[kCombineThreads];
  __shared__ float sCnt[kCombineThreads];
  const int tid = threadIdx.x;
  const int64_t plane = static_cast<int64_t>(n_split) * M;
  float tot = 0.0f, cnt = 0.0f;
  for (int row = tid; row < M; row += kCombineThreads) {
    float m = -CUDART_INF_F;
    for (int s = 0; s < n_split; ++s)
      m = fmaxf(m, part[static_cast<int64_t>(s) * M + row]);
    float sum = 0.0f, gold = 0.0f;
    for (int s = 0; s < n_split; ++s) {
      const int64_t at = static_cast<int64_t>(s) * M + row;
      sum += part[plane + at] * expf(part[at] - m);
      gold += part[2 * plane + at];
    }
    const float l = m + logf(sum);
    lse[row] = l;
    if (labels[row] >= 0) {
      tot += l - gold;
      cnt += 1.0f;
    }
  }
  sTot[tid] = tot;
  sCnt[tid] = cnt;
  __syncthreads();
  for (int o = kCombineThreads / 2; o > 0; o >>= 1) {
    if (tid < o) {
      sTot[tid] += sTot[tid + o];
      sCnt[tid] += sCnt[tid + o];
    }
    __syncthreads();
  }
  if (tid == 0) {
    stats[0] = sTot[0];
    stats[1] = sCnt[0];
    *loss = sTot[0] / fmaxf(sCnt[0], 1.0f);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The operands of K1 / K2: A = h [M, d] (K-major), B = the head, [d, V]
// (b_mn) or the table [V, d] read as its transpose.
Args loss_args(const void* h, const void* w, int b_mn, int M, int d, int V) {
  Args p = {};
  p.a = h;
  p.b = w;
  p.M = M;
  p.N = V;
  p.K = d;
  p.sam = d;
  p.sak = 1;
  p.sbk = b_mn ? V : 1;
  p.sbn = b_mn ? 1 : d;
  return p;
}

template <int MODE, typename T>
int launch_loss(const Args& p, bool b_mn, int n_items, cudaStream_t st) {
  return b_mn ? launch_wgmma<MODE, false, true, T>(p, n_items, st)
              : launch_wgmma<MODE, false, false, T>(p, n_items, st);
}

int fwd(const Args& p, bool bf16, bool b_mn, float* lse, float* stats,
        float* loss, cudaStream_t st) {
  const int bm = bf16 ? kBM : kSM, bn = bf16 ? kBN : kSN;
  const int n_mt = (p.M + bm - 1) / bm, n_nt = (p.N + bn - 1) / bn;
  if (p.M <= 0 || p.K <= 0 || p.N <= 0 || p.vocab < 0 || p.vocab > p.N ||
      p.col0 < 0 || p.n_split < 1 || p.n_split > n_nt ||
      static_cast<int64_t>(n_mt) * p.n_split >= INT_MAX ||
      (bf16 && (p.N % 8 != 0 || p.K % 8 != 0)) ||
      (!bf16 && p.n_split > 65535))
    return kErrSizes;
  int err;
  if (bf16) {
    err = launch_loss<kFwd, __nv_bfloat16>(p, b_mn, n_mt * p.n_split, st);
  } else {
    lce_simt_kernel<kFwd><<<dim3(n_mt, p.n_split), kSimtThreads, 0, st>>>(p);
    err = static_cast<int>(cudaGetLastError());
  }
  if (err != 0 || lse == nullptr) return err;
  lce_combine_kernel<<<1, kCombineThreads, 0, st>>>(p.part, p.labels, lse,
                                                    stats, loss, p.M,
                                                    p.n_split);
  return static_cast<int>(cudaGetLastError());
}

int dlogits(const Args& p, bool bf16, bool b_mn, cudaStream_t st) {
  const int bm = bf16 ? kBM : kSM, bn = bf16 ? kBN : kSN;
  const int64_t n_mt = (p.M + bm - 1) / bm, n_nt = (p.N + bn - 1) / bn;
  if (p.M <= 0 || p.K <= 0 || p.N <= 0 || p.vocab < 0 || p.vocab > p.N ||
      p.col0 < 0 || n_mt * n_nt >= INT_MAX ||
      (bf16 && (p.N % 8 != 0 || p.K % 8 != 0 ||
                reinterpret_cast<uintptr_t>(p.dl) % 16 != 0)) ||
      (!bf16 && n_nt > 65535))
    return kErrSizes;
  if (bf16)
    return launch_loss<kDlogits, __nv_bfloat16>(
        p, b_mn, static_cast<int>(n_mt * n_nt), st);
  lce_simt_kernel<kDlogits>
      <<<dim3(static_cast<unsigned>(n_mt), static_cast<unsigned>(n_nt)),
         kSimtThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int gemm(const Args& p, bool bf16, bool a_mn, bool b_mn, cudaStream_t st) {
  const int bm = bf16 ? kBM : kSM, bn = bf16 ? kBN : kSN;
  const int64_t n_mt = (p.M + bm - 1) / bm, n_nt = (p.N + bn - 1) / bn;
  const int nk = (p.K + kBK - 1) / kBK;
  // TMA: the rows of each stored operand 16-byte aligned
  const bool bad_bf16 =
      p.split > nk || (a_mn && !b_mn) || (a_mn ? p.M : p.K) % 8 != 0 ||
      (b_mn ? p.N : p.K) % 8 != 0 ||
      (p.split > 1 && (p.work == nullptr || p.sem == nullptr));
  if (p.M <= 0 || p.K <= 0 || p.N <= 0 || p.split < 1 ||
      n_mt * n_nt * p.split >= INT_MAX || p.N % 2 != 0 ||
      (bf16 && bad_bf16) ||
      (!bf16 && (p.split != 1 || !p.out_f32 || n_nt > 65535)))
    return kErrSizes;
  if (!bf16) {
    lce_simt_kernel<kGemm>
        <<<dim3(static_cast<unsigned>(n_mt), static_cast<unsigned>(n_nt)),
           kSimtThreads, 0, st>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const int items = static_cast<int>(n_mt * n_nt * p.split);
  if (a_mn) return launch_wgmma<kGemm, true, true, __nv_bfloat16>(p, items, st);
  if (b_mn) return launch_wgmma<kGemm, false, true, __nv_bfloat16>(p, items, st);
  return launch_wgmma<kGemm, false, false, __nv_bfloat16>(p, items, st);
}

}  // namespace

// K1 and the combine.  h [N, d]; w the head's columns [col0, col0 + V),
// [d, V] if b_mn else the table [V, d]; labels [N] int64; part [3, n_split,
// N], lse [N], stats [2] (loss sum, count), loss [] float32.  With lse null,
// K1 alone (a vocab-sharded head: its partials are combined after a
// gather, by linear_ce_combine).
#define LCE_FWD(NAME, BF16)                                                   \
  extern "C" int NAME(const void* h, const void* w, const void* labels,       \
                      void* part, void* lse, void* stats, void* loss, int N,  \
                      int d, int V, int vocab, int col0, int b_mn,            \
                      int n_split, void* stream) {                            \
    Args p = loss_args(h, w, b_mn, N, d, V);                                  \
    p.labels = static_cast<const int64_t*>(labels);                           \
    p.vocab = vocab;                                                          \
    p.col0 = col0;                                                            \
    p.n_split = n_split;                                                      \
    p.part = static_cast<float*>(part);                                       \
    return fwd(p, BF16, b_mn != 0, static_cast<float*>(lse),                  \
               static_cast<float*>(stats), static_cast<float*>(loss),         \
               static_cast<cudaStream_t>(stream));                            \
  }
LCE_FWD(linear_ce_fwd_f32, false)
LCE_FWD(linear_ce_fwd_bf16, true)

// The combine alone: part [3, n_split, N] (every shard's K1 partials, in
// shard order), labels [N] int64 -> lse [N], stats [2], loss [] float32.
extern "C" int linear_ce_combine(const void* part, const void* labels,
                                 void* lse, void* stats, void* loss, int N,
                                 int n_split, void* stream) {
  if (N <= 0 || n_split < 1) return kErrSizes;
  lce_combine_kernel<<<1, kCombineThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), static_cast<const int64_t*>(labels),
      static_cast<float*>(lse), static_cast<float*>(stats),
      static_cast<float*>(loss), N, n_split);
  return static_cast<int>(cudaGetLastError());
}

// K2.  h [N, d], w as K1's; labels [N]; lse [N] from the combine; scale []
// the cotangent on the loss sum (float32); dl [N, V] in h's dtype.
#define LCE_DLOGITS(NAME, BF16)                                               \
  extern "C" int NAME(const void* h, const void* w, const void* labels,       \
                      const void* lse, const void* scale, void* dl, int N,    \
                      int d, int V, int vocab, int col0, int b_mn,            \
                      void* stream) {                                         \
    Args p = loss_args(h, w, b_mn, N, d, V);                                  \
    p.labels = static_cast<const int64_t*>(labels);                           \
    p.vocab = vocab;                                                          \
    p.col0 = col0;                                                            \
    p.lse = static_cast<const float*>(lse);                                   \
    p.scale = static_cast<const float*>(scale);                               \
    p.dl = dl;                                                                \
    return dlogits(p, BF16, b_mn != 0, static_cast<cudaStream_t>(stream));    \
  }
LCE_DLOGITS(linear_ce_dlogits_f32, false)
LCE_DLOGITS(linear_ce_dlogits_bf16, true)

// K3.  out [M, N] = A [M, K] @ B [K, N] (+ c_in [M, N] float32 when not
// null); A stored [K][M] if a_mn else [M][K], B [K][N] if b_mn else [N][K];
// out float32 if out_f32 else bf16; split > 1: work [split, M, N] float32
// and sem [row tiles * column tiles] int32 zeros.
#define LCE_GEMM(NAME, BF16)                                                  \
  extern "C" int NAME(const void* a, const void* b, const void* c_in,         \
                      void* out, void* work, void* sem, int M, int N, int K,  \
                      int a_mn, int b_mn, int split, int out_f32,             \
                      void* stream) {                                         \
    Args p = {};                                                              \
    p.a = a;                                                                  \
    p.b = b;                                                                  \
    p.M = M;                                                                  \
    p.N = N;                                                                  \
    p.K = K;                                                                  \
    p.sam = a_mn ? 1 : K;                                                     \
    p.sak = a_mn ? M : 1;                                                     \
    p.sbk = b_mn ? N : 1;                                                     \
    p.sbn = b_mn ? 1 : K;                                                     \
    p.c_in = static_cast<const float*>(c_in);                                 \
    p.out = out;                                                              \
    p.work = static_cast<float*>(work);                                       \
    p.sem = static_cast<int*>(sem);                                           \
    p.split = split;                                                          \
    p.out_f32 = out_f32;                                                      \
    return gemm(p, BF16, a_mn != 0, b_mn != 0,                                \
                static_cast<cudaStream_t>(stream));                           \
  }
LCE_GEMM(linear_ce_gemm_f32, false)
LCE_GEMM(linear_ce_gemm_bf16, true)
