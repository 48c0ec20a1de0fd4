// Fused ingest of the population tick: bandwidth rows -> int16 signatures.
//
// Replaces `quant_signature_jnp` (src/repro/kernels/ee_gate/population.py:136,
// program `_jnp_program` :102-133).  That function is one jitted XLA launch,
// not a Pallas kernel, but it is the population tick's ingest over every
// user each tick, so it gets a kernel of its own.
//
// What it computes, for each user row u of a (Us, N) float64 bandwidth
// matrix `vec` and each packed link slot (k, n) of the (2L-1, N) requantizer
// pack (rows 0..L-2 the source-node row steeps, row L-1 the init vector,
// rows L..2L-2 the column steeps):
//
//   bwm  = vec[u, n] > 0 ? vec[u, n] : NaN
//   sc   = ((bits[k] / bwm + C[k, n]) * gamma) / delta
//   ok   = isfinite(sc) && mask[k, n] && load[k] <= vec[u, n]
//   q_m  = floor(sc + 1e-12) | ceil(sc - 1e-12) | rint(sc)    (mode m)
//   out[u, m, k, n] = ok && q_m <= gamma ? (int16) q_m : -1
//
// for the M <= 2 quantizer modes of the call, written as (Us, M*(2L-1)*N)
// int16 rows: the exact bytes the cohort-state table keys on.  The numpy
// oracle (`quant_signature_np`) and `plan.update_uplinks` do these float64
// operations in this order, so every one is an explicit round-to-nearest
// intrinsic (__ddiv_rn, __dadd_rn, __dmul_rn) and the source is built with
// -fmad=false: the signatures are byte-equal to the oracle's.  rint rounds
// half to even, as np.round does.  A NaN or non-positive bandwidth gives a
// NaN sc (invalid, -1); the source column holds +inf, whose bits / inf
// term is 0.
//
// Bound: bytes.  A row reads N doubles and writes M*(2L-1)*N int16: at the
// population tick's h4 cohort (N = 5, L = 5, M = 2) 40 B in and 180 B out,
// so 1e6 rows move 220 MB, 0.0657 ms at 3.35 TB/s; the arithmetic is two
// divides, an add and a multiply a link slot, shared by both modes.
//
// Design (simple and right first): a block takes kRows consecutive users,
// whose outputs are one contiguous run; a thread takes one (user, k, n)
// slot at a time, computes sc once and stores both modes' values, so
// consecutive threads store consecutive int16s of each mode's run (rows of
// 180 B are not 16-byte aligned, so no wider stores are attempted).  The
// small packs are read through the read-only cache; each bandwidth is read
// by the 2L-1 threads of its link slots, from L1.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;          // users a block

enum Mode { kFloor = 0, kCeil = 1, kRound = 2 };

__device__ __forceinline__ double quantize(double x, int mode) {
  if (mode == kFloor) return floor(__dadd_rn(x, 1e-12));
  if (mode == kCeil) return ceil(__dsub_rn(x, 1e-12));
  return rint(x);
}

__device__ __forceinline__ int16_t encode(double q, bool ok, double gamma) {
  return ok && q <= gamma ? static_cast<int16_t>(q) : int16_t(-1);
}

__global__ void __launch_bounds__(kThreads)
quant_signature_kernel(const double* __restrict__ vec,
                       const double* __restrict__ bits,
                       const double* __restrict__ C,
                       const uint8_t* __restrict__ mask,
                       const double* __restrict__ load,
                       int16_t* __restrict__ out, int Us, int K2, int N,
                       int M, int mode0, int mode1, double gamma,
                       double delta) {
  const int K2N = K2 * N;
  const long long u0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = static_cast<int>(min(static_cast<long long>(kRows),
                                        Us - u0));
  const unsigned slots = static_cast<unsigned>(rows) * K2N;
  const double* v_blk = vec + u0 * N;
  int16_t* o_blk = out + u0 * M * K2N;
  const double nan = __longlong_as_double(0x7ff8000000000000LL);
  for (unsigned i = threadIdx.x; i < slots; i += kThreads) {
    const unsigned r = i / K2N;
    const unsigned j = i - r * K2N;
    const unsigned k = j / N;
    const unsigned n = j - k * N;
    const double v = v_blk[r * N + n];
    const double bwm = v > 0.0 ? v : nan;
    double sc = __ddiv_rn(__ldg(bits + k), bwm);
    sc = __dadd_rn(sc, __ldg(C + j));
    sc = __dmul_rn(sc, gamma);
    sc = __ddiv_rn(sc, delta);
    const bool ok = isfinite(sc) && __ldg(mask + j) != 0
                    && __ldg(load + k) <= v;
    int16_t* o = o_blk + static_cast<size_t>(r) * M * K2N + j;
    o[0] = encode(quantize(sc, mode0), ok, gamma);
    if (M > 1) o[K2N] = encode(quantize(sc, mode1), ok, gamma);
  }
}

}  // namespace

// vec [Us, N] float64; bits, load [K2] float64; C [K2, N] float64; mask
// [K2, N] bool (one byte each); out [Us, M*K2*N] int16, all contiguous on
// one device.  M in {1, 2}; modes 0 floor, 1 ceil, 2 round (mode1 is read
// only when M == 2); 0 <= gamma < 32767.  Returns the launch's cudaError_t
// (0 on success; Us == 0 launches nothing).
extern "C" int quant_signature(const void* vec, const void* bits,
                               const void* C, const void* mask,
                               const void* load, void* out, int Us, int K2,
                               int N, int M, int mode0, int mode1, int gamma,
                               double delta, void* stream) {
  if (Us < 0 || K2 <= 0 || N <= 0 || M < 1 || M > 2 || gamma < 0
      || gamma >= 32767 || mode0 < 0 || mode0 > 2 || mode1 < 0 || mode1 > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(kRows) * K2 * N > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (Us == 0) return 0;
  const unsigned blocks = static_cast<unsigned>((Us + kRows - 1) / kRows);
  quant_signature_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(vec), static_cast<const double*>(bits),
      static_cast<const double*>(C), static_cast<const uint8_t*>(mask),
      static_cast<const double*>(load), static_cast<int16_t*>(out), Us, K2,
      N, M, mode0, mode1, static_cast<double>(gamma), delta);
  return static_cast<int>(cudaGetLastError());
}
