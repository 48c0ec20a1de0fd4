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
// oracle (`quant_signature_np`) does these float64 operations in this order,
// each rounded to nearest, and the kernel's rows are byte-equal to its.
//
// Bound: bytes.  A row reads N doubles and writes M*(2L-1)*N int16: at the
// population tick's h4 cohort (N = 5, L = 5, M = 2) 40 B in and 180 B out,
// so 1e6 rows move 220 MB, 0.0657 ms at 3.35 TB/s.  The arithmetic is two
// f64 divides, an add and a multiply a link slot, shared by both modes.
//
// What held the first kernel (one thread a slot, `__ddiv_rn` twice, runtime
// index divides, 2-byte stores) at 18% of the bound, measured on the card:
// the divides (the compiler's divide is a reciprocal refinement of eight f64
// instructions and a check that sends a zero or tiny dividend, a huge or
// infinite divisor and a zero or tiny quotient to a called slow path: the
// source column's bits / inf took it in every warp), the index divides, and
// the scattered 2-byte stores with each rate re-read by 2L-1 threads.
//
// Design:
// - One thread owns one link (user, n) of a group of R consecutive users
//   (R = 64 at N = 5: 320 threads, 10 warps).  It reads the rate once, with
//   the block's consecutive threads on consecutive doubles, and classifies
//   it once: v <= 0 or NaN makes every slot -1, +inf gives the quotient +0
//   by selection (bits / inf with finite bits >= 0), a rate in the fast
//   domain gets its reciprocal once for its 2L-1 slots.
// - Divides by one reciprocal, correctly rounded (Markstein).  For a divisor
//   b the link keeps yh = RN(1/b) (`__drcp_rn`, correctly rounded) and yl =
//   RN(e * yh) with e = 1 - b*yh exact in one FMA, so yh + yl = 1/b to a
//   relative 2^-105.  A quotient is then q0 = RN(a*yh + RN(a*yl)), within
//   one ulp of a/b (faithful), r = a - b*q0 exact in one FMA, and q =
//   RN(q0 + r*yh), which is RN(a/b) by Markstein's theorem (y within half
//   an ulp of 1/b, q0 within one ulp of a/b, no underflow or overflow:
//   P. Markstein, IBM J. Res. Dev. 34(1), 1990; the theorem behind the
//   IA-64 divide).  Three FMAs and a multiply a divide, no branch.  delta's
//   reciprocal is taken once a thread.  The fast domain: bits, C, delta and
//   the rate are each +0 or in [2^-200, 2^200] (and gamma < 32767), so
//   every quotient, residual and product of both divides stays a normal
//   number (the second dividend lies in [2^-400, 2^416]) and sc is finite
//   and >= 0.  A link outside it (a subnormal, tiny or huge rate, or a pack
//   or delta outside it) runs the general path of the same kernel: the
//   first kernel's arithmetic, `__ddiv_rn` twice a slot.
// - The quantizers without the conversion pipe: for 0 <= t < 65536 the
//   integer floor(t) is the low word of RD(t + 1.5*2^52) (ceil: RU, rint:
//   RN, half to even like np.round); a value >= 65536 is above every gamma
//   and encodes -1.
// - The shape (2L-1, N) is a template parameter for the paper's apps (9, 5)
//   and (5, 5), with a generic instantiation for any other; the two modes
//   are template parameters.  No integer division runs in the slot loop.
// - The packs (bits, C, mask, load) are read into shared memory once a
//   block.  Each group's rows are staged in shared memory, both modes,
//   and leave as one contiguous run in 16-byte stores (64 rows x 180 B =
//   11,520 B at h4); two staging buffers let one barrier a group suffice.
//   Blocks are persistent, four an SM (48 registers a thread), looping
//   over groups: fewer warps an SM leave the divides' f64 chains and the
//   group barrier exposed.
//
// Built with -fmad=false: every multiply and add above is an explicit
// intrinsic, and the FMAs are explicit `__fma_rn`.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 320;
constexpr int kMaxSmem = 227 * 1024;
constexpr int kNone = -1;
enum Mode { kFloor = 0, kCeil = 1, kRound = 2 };

// a fast-path link's bits, C, delta and rate are +0 or in [kLo, kHi]
constexpr double kLo = 0x1p-200;
constexpr double kHi = 0x1p200;
constexpr double kMagic = 6755399441055744.0;   // 1.5 * 2^52

__device__ __forceinline__ bool in_domain(double x) {
  return x >= kLo && x <= kHi;
}

__device__ __forceinline__ bool zero_or_in_domain(double x) {
  return __double_as_longlong(x) == 0 || in_domain(x);
}

// the divisor's part of a correctly rounded divide: b, RN(1/b) and the
// low part of 1/b (b in the domain)
struct Recip {
  double b, yh, yl;
};

__device__ __forceinline__ Recip recip(double b) {
  const double yh = __drcp_rn(b);
  return {b, yh, __dmul_rn(__fma_rn(-b, yh, 1.0), yh)};
}

// RN(a / b) for b in the domain and a = +0 or in [2^-400, 2^416]
// (Markstein); with {0, 0, 0} it gives a * 0 = +0 for a >= +0, the value
// of a / +inf
__device__ __forceinline__ double divide(double a, const Recip& r) {
  const double q0 = __fma_rn(a, r.yh, __dmul_rn(a, r.yl));
  return __fma_rn(__fma_rn(-r.b, q0, a), r.yh, q0);
}

// the mode's level of -1 < sc < 65536 (eps = 1e-12, from the parameter
// bank): the low word of the directed sum with kMagic, whose unit is 1
template <int Q>
__device__ __forceinline__ int level(double sc, double eps) {
  if (Q == kFloor) return __double2loint(__dadd_rd(__dadd_rn(sc, eps),
                                                   kMagic));
  if (Q == kCeil) return __double2loint(__dadd_ru(__dsub_rn(sc, eps),
                                                  kMagic));
  return __double2loint(__dadd_rn(sc, kMagic));
}

// the general path's encoding of any sc (the first kernel's)
template <int Q>
__device__ __forceinline__ int16_t encode_any(double sc, bool ok,
                                              double gamma) {
  const double q = Q == kFloor ? floor(__dadd_rn(sc, 1e-12))
                   : Q == kCeil ? ceil(__dsub_rn(sc, 1e-12)) : rint(sc);
  return ok && q <= gamma ? static_cast<int16_t>(q) : int16_t(-1);
}

struct Params {
  const double* vec;
  const double* bits;
  const double* C;
  const uint8_t* mask;
  const double* load;
  int16_t* out;
  long long Us;
  int K2, N, R, groups;
  int stage;           // int16 a staging buffer (R rows, rounded up to 8)
  int gamma;
  double delta;
  double eps;          // the quantizers' 1e-12, read from the parameter bank
  bool aligned;        // out and every group's run 16-byte aligned
};

// rows a group: as many as the block has threads for, a multiple of 8 when
// it can be (so R rows of int16 are a multiple of 16 bytes)
__host__ __device__ constexpr int group_rows(int N) {
  return N >= kThreads ? 1 : (kThreads / N >= 8 ? kThreads / N / 8 * 8
                                                : kThreads / N);
}

// one link column n's packs, in shared memory
struct ColumnPacks {
  const double *bits, *C, *load;   // C and mask at column n
  const uint8_t* mask;
  int N;
  __device__ __forceinline__ double b(int k) const { return bits[k]; }
  __device__ __forceinline__ double c(int k) const { return C[k * N]; }
  __device__ __forceinline__ double l(int k) const { return load[k]; }
  __device__ __forceinline__ bool m(int k) const { return mask[k * N]; }
};

// the M modes of one link's 2L-1 slots into o[k * N] (mode 0) and
// o[K2N + k * N] (mode 1)
template <int K2c, int Q0, int Q1>
__device__ __forceinline__ void link_slots(
    double v, const ColumnPacks& pk, bool fast_column, const Recip& dr,
    const Params& p, int K2, int N, int16_t* o) {
  constexpr int M = Q1 == kNone ? 1 : 2;
  constexpr int Q1m = Q1 == kNone ? Q0 : Q1;
  const int K2N = K2 * N;
  const double gamma = static_cast<double>(p.gamma);
  const bool valid = v > 0.0;
  const bool vinf = v == __longlong_as_double(0x7ff0000000000000LL);
  const bool vdom = in_domain(v);
  if (fast_column && (vdom || vinf || !valid)) {
    const Recip lr = recip(vdom ? v : 1.0);
    const Recip br = vinf ? Recip{0.0, 0.0, 0.0} : lr;
#pragma unroll
    for (int k = 0; k < (K2c > 0 ? K2c : K2); ++k) {
      const double s = __dadd_rn(divide(pk.b(k), br), pk.c(k));
      const double sc = divide(__dmul_rn(s, gamma), dr);
      // sc >= +0 here: it is below 65536 (above every gamma) when its
      // high word is below 65536's
      const bool ok = valid & pk.m(k) & (pk.l(k) <= v)
                      & (__double2hiint(sc) < 0x40F00000);
      const int q0 = level<Q0>(sc, p.eps);
      o[k * N] = ok & (q0 <= p.gamma) ? static_cast<int16_t>(q0)
                                      : int16_t(-1);
      if (M > 1) {
        const int q1 = level<Q1m>(sc, p.eps);
        o[K2N + k * N] = ok & (q1 <= p.gamma) ? static_cast<int16_t>(q1)
                                              : int16_t(-1);
      }
    }
  } else {
    const double bwm = valid ? v : __longlong_as_double(0x7ff8000000000000LL);
#pragma unroll 1
    for (int k = 0; k < K2; ++k) {
      double sc = __ddiv_rn(pk.b(k), bwm);
      sc = __dadd_rn(sc, pk.c(k));
      sc = __dmul_rn(sc, gamma);
      sc = __ddiv_rn(sc, p.delta);
      const bool ok = isfinite(sc) && pk.m(k) && pk.l(k) <= v;
      o[k * N] = encode_any<Q0>(sc, ok, gamma);
      if (M > 1) o[K2N + k * N] = encode_any<Q1m>(sc, ok, gamma);
    }
  }
}

// a group's rows are one contiguous run of the output
__device__ __forceinline__ void copy_out(const int16_t* buf, int16_t* dst,
                                         int n16, bool aligned) {
  int done = 0;
  if (aligned) {
    const uint4* s4 = reinterpret_cast<const uint4*>(buf);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < n16 / 8; i += kThreads) d4[i] = s4[i];
    done = n16 / 8 * 8;
  }
  for (int i = done + threadIdx.x; i < n16; i += kThreads) dst[i] = buf[i];
}

template <int K2c, int Nc, int Q0, int Q1>
__global__ void __launch_bounds__(kThreads, 4)
quant_signature_kernel(const Params p) {
  constexpr int M = Q1 == kNone ? 1 : 2;
  const int K2 = K2c > 0 ? K2c : p.K2;
  const int N = Nc > 0 ? Nc : p.N;
  const int R = Nc > 0 ? group_rows(Nc > 0 ? Nc : 1) : p.R;
  const int K2N = K2 * N;
  const int W = M * K2N;
  const int t = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* stage = reinterpret_cast<int16_t*>(smem);
  double* sC = reinterpret_cast<double*>(stage + 2 * p.stage);
  double* sBits = sC + K2N;
  double* sLoad = sBits + K2;
  uint8_t* sMask = reinterpret_cast<uint8_t*>(sLoad + K2);
  uint8_t* sFast = sMask + K2N;
  for (int i = t; i < K2N; i += kThreads) {
    sC[i] = p.C[i];
    sMask[i] = p.mask[i];
  }
  for (int i = t; i < K2; i += kThreads) {
    sBits[i] = p.bits[i];
    sLoad[i] = p.load[i];
  }
  __syncthreads();
  // a link column n takes the fast path when delta and its packs are in
  // the domain (gamma always is)
  const bool delta_ok = in_domain(p.delta);
  for (int n = t; n < N; n += kThreads) {
    bool ok = delta_ok;
    for (int k = 0; k < K2; ++k)
      ok = ok && zero_or_in_domain(sBits[k])
           && zero_or_in_domain(sC[k * N + n]);
    sFast[n] = ok;
  }
  __syncthreads();
  const Recip dr = recip(delta_ok ? p.delta : 1.0);

  for (int g = blockIdx.x, parity = 0; g < p.groups;
       g += gridDim.x, parity ^= 1) {
    int16_t* buf = stage + parity * p.stage;
    const long long u0 = static_cast<long long>(g) * R;
    const int rows = static_cast<int>(min(static_cast<long long>(R),
                                          p.Us - u0));
    // a thread's link (r, n) is found once a link, not once a slot (one
    // link a thread at N <= 320, a loop over the row's links above)
    for (int j = t; j < rows * N; j += kThreads) {
      const int r = j / N;
      const int n = j - r * N;
      const ColumnPacks pk{sBits, sC + n, sLoad, sMask + n, N};
      link_slots<K2c, Q0, Q1>(p.vec[u0 * N + j], pk, sFast[n], dr, p, K2, N,
                              buf + r * W + n);
    }
    __syncthreads();
    copy_out(buf, p.out + u0 * W, rows * W, p.aligned);
  }
}

template <int K2c, int Nc, int Q0, int Q1>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  auto kernel = quant_signature_kernel<K2c, Nc, Q0, Q1>;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long persistent = static_cast<long long>(sms) * max(per_sm, 1);
  const int grid = static_cast<int>(min(static_cast<long long>(p.groups),
                                        persistent));
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int K2c, int Nc>
int launch_modes(const Params& p, int M, int mode0, int mode1, size_t smem,
                 cudaStream_t stream) {
#define QS_MODES(a, b)                                                   \
  if (mode0 == a && (b == kNone ? M == 1 : M == 2 && mode1 == b))        \
    return launch<K2c, Nc, a, b>(p, smem, stream);
  QS_MODES(kFloor, kNone) QS_MODES(kCeil, kNone) QS_MODES(kRound, kNone)
  QS_MODES(kFloor, kFloor) QS_MODES(kFloor, kCeil) QS_MODES(kFloor, kRound)
  QS_MODES(kCeil, kFloor) QS_MODES(kCeil, kCeil) QS_MODES(kCeil, kRound)
  QS_MODES(kRound, kFloor) QS_MODES(kRound, kCeil) QS_MODES(kRound, kRound)
#undef QS_MODES
  return static_cast<int>(cudaErrorInvalidValue);
}

// the fast path's divide alone, for the card tests: q[i] = a[i] / b[i]
// through `recip` and `divide`, both operands +0 or in the domain (b not 0)
__global__ void quant_divide_kernel(const double* __restrict__ a,
                                    const double* __restrict__ b,
                                    double* __restrict__ q, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    q[i] = divide(a[i], recip(b[i]));
}

}  // namespace

// vec [Us, N] float64; bits, load [K2] float64; C [K2, N] float64; mask
// [K2, N] bool (one byte each); out [Us, M*K2*N] int16, all contiguous on
// one device.  M in {1, 2}; modes 0 floor, 1 ceil, 2 round (mode1 is read
// only when M == 2); 0 <= gamma < 32767.  Returns the launch's cudaError_t
// (0 on success; Us == 0 launches nothing; a shape whose packs and staging
// do not fit in a block's shared memory is cudaErrorInvalidValue).
extern "C" int quant_signature(const void* vec, const void* bits,
                               const void* C, const void* mask,
                               const void* load, void* out, int Us, int K2,
                               int N, int M, int mode0, int mode1, int gamma,
                               double delta, void* stream) {
  if (Us < 0 || K2 <= 0 || N <= 0 || M < 1 || M > 2 || gamma < 0
      || gamma >= 32767 || mode0 < 0 || mode0 > 2 || mode1 < 0 || mode1 > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long K2N = static_cast<long long>(K2) * N;
  const int R = group_rows(N);
  const long long W = M * K2N;
  const long long stage = (R * W + 7) / 8 * 8;
  const long long smem = 2 * stage * 2 + K2N * 8 + 2LL * K2 * 8 + K2N + N;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (Us == 0) return 0;
  Params p;
  p.vec = static_cast<const double*>(vec);
  p.bits = static_cast<const double*>(bits);
  p.C = static_cast<const double*>(C);
  p.mask = static_cast<const uint8_t*>(mask);
  p.load = static_cast<const double*>(load);
  p.out = static_cast<int16_t*>(out);
  p.Us = Us;
  p.K2 = K2;
  p.N = N;
  p.R = R;
  p.groups = static_cast<int>((Us + R - 1) / R);
  p.stage = static_cast<int>(stage);
  p.gamma = gamma;
  p.delta = delta;
  p.eps = 1e-12;
  p.aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0 && R * W % 8 == 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t bytes = static_cast<size_t>(smem);
  if (K2 == 9 && N == 5) return launch_modes<9, 5>(p, M, mode0, mode1, bytes, s);
  if (K2 == 5 && N == 5) return launch_modes<5, 5>(p, M, mode0, mode1, bytes, s);
  return launch_modes<0, 0>(p, M, mode0, mode1, bytes, s);
}

// a [n], b [n], q [n] float64 on one device; 0 <= n.  Returns the launch's
// cudaError_t.
extern "C" int quant_signature_divide(const void* a, const void* b, void* q,
                                      int n, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int grid = (n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096;
  quant_divide_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(a), static_cast<const double*>(b),
      static_cast<double*>(q), n);
  return static_cast<int>(cudaGetLastError());
}
