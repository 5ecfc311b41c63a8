// Device functions shared by the port's kernels: the fused cascade
// (fused_polymul.cu), the fused end-to-end multiplier
// (fused_e2e_polymul.cu), the stage kernels (ntt_channels.cu,
// intt_channels.cu, decompose.cu, compose.cu) and their multi-block forms
// (*_fs.cu), among them the register passes of the transforms that K1-K4
// run, the multi-block column and row stages, the cluster cascade that
// K1-fs and K2-fs run, the Eq-10 compose tail and K6's compose kernel
// that K2, K6 and K2-fs run, and the cluster steps (DSMEM decompose,
// compose over the peers' y) that K2 runs.
//
// Every function stores, word for word, what the int64 arithmetic of the
// plain PyTorch versions (repro_torch/core/modmath.py,
// repro_torch/kernels/crt.py, repro_torch/kernels/ntt.py) stores, so a
// kernel and its plain version agree bit for bit.  Each computes in the
// narrowest integer type that is exact for the values it sees:
//
// * Butterflies and residue products run on uint32.  Every value a
//   butterfly stores is below window*q < 2^31 (lazy) or below q < 2^31
//   (strict), and every intermediate below 2^32: lazy v = 30 (W = 2) sums
//   stay below 4q < 2^32, lazy v <= 29 (W = 4) below 8q < 2^32.  The
//   Shoup quotient (v*w') >> beta is __umulhi(v, w') at beta = 32 and one
//   32x32->64 product at beta <= 31; v*w - qhat*q lies in [0, 2q) and is
//   exact mod 2^32.  The Barrett product reduction of b <= 30-bit moduli
//   takes one 32x32->64 product for x and one for (x >> s1) * eps (both
//   factors below 2^31); its remainder lies in [0, 4q) < 2^32.  The strict
//   v = 31 regime reduces its 62-bit products with the block Barrett
//   below, whose constant K2 takes from RnsPlan.dec_d and K1, K3 and K4
//   derive from q (channel_reduce).
// * The SAU network's words reach 2^59 and stay 64-bit.  Its shifts and
//   adds are one product by beta (exact mod 2^64), its Barrett quotient
//   one 32x32->64 product (inside the configuration's window x >> s1 and
//   eps are both below 2^32; RnsPlan.dec admits windows up to 32 bits),
//   and below q < 2^30 its remainders 32-bit.
// * The decompose block products and the Horner steps acc * [beta^t']_q
//   (Alg 2's blocks, the most significant first), and the compose products
//   y = r * q~ mod q (K6), all below q^2, use the Barrett of block_barrett
//   (m = floor(2^(b+31) / q)), exact for every x < 2^(2b) with
//   b = bit_length(q) <= 31.
// * The Eq-10 limb sums are 64-bit; each term is a 32x32->64 product
//   (y < q < 2^31, limb < 2^28, so below 2^59).  A sum of kSumChannels = 15
//   of them on a limb below 2^28 stays below 2^63; past 15 channels the
//   sums are carry-normalised (every limb back below 2^w) before the next
//   15, so they are exact for every t.
//
// No register array is indexed by a runtime count: the limb loops unroll
// to a compile-time MAXL with predication, and limb counts past MAXL run
// in chunks of MAXL limbs with the carry passed between chunks.  Channel,
// segment and limb counts are not compile-time limits: what a kernel
// keeps per channel, per segment or per limb lives in dynamic shared
// memory sized at launch, and the host refuses what one block's shared
// memory cannot hold (kernels/ntt.py and kernels/crt.py mirror the sizes).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace parentt {

typedef long long i64;
typedef uint32_t res_t;
typedef uint64_t u64;

constexpr int kTPrime = 3;  // Alg-2 block width t' of every plan
constexpr int kMaxThreads = 512;
// dynamic shared memory one block may opt in to on an H100 (227 KB)
constexpr long long kMaxSmem = 227 * 1024;
// channels whose Eq-10 products a limb sum takes between two carry
// normalisations: 15 * (2^59 - 2^31) + 2^36 < 2^63
constexpr int kSumChannels = 15;

// Items of `per` bytes a staging area of `room` bytes holds, at most
// `cap`: all of cap if they fit, else a multiple of 32 where room allows
// 32 or more, else what fits (0 when not one does).  The kernels' launch
// code and kernels/ntt.py fit_chunk size their staging with it.
__host__ __device__ inline int fit_chunk(int cap, long long room, long long per) {
  const long long k = room > 0 ? room / per : 0;
  if (k >= cap) return cap;
  return k >= 32 ? (int)(k & ~31LL) : (int)k;
}

// Rows of a one-thread-a-row tile (K5, K6) whose `words` int64 words a row
// stage in shared memory beside `fixed` bytes: up to 256 rows within 64 KB,
// or 32 rows past it while one block's shared memory holds them
// (kernels/crt.py tile_rows).
__host__ __device__ inline int tile_rows(int words, long long fixed) {
  const long long per = 8LL * words;
  long long budget = 64 * 1024 > 32 * per ? 64 * 1024 : 32 * per;
  if (budget > kMaxSmem - fixed) budget = kMaxSmem - fixed;
  return fit_chunk(256, budget, per);
}

// Opt a kernel in to dynamic shared memory above the 48 KB default.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Reduction regime of a table set (repro_torch.kernels.ntt.reduction_mode).
enum Mode : int {
  kLazy = 0,     // Harvey lazy butterflies (Shoup twiddles), Barrett products
  kBarrett = 1,  // strict butterflies, Barrett products
  kRem = 2,      // strict butterflies, block-Barrett products (q of 31 bits)
};

// One channel's butterfly and product reduction constants.  A kernel that
// fixes mode and window at compile time sets them from constants, and the
// branches below fold away.
struct Reduce {
  res_t q;
  res_t half;  // (q + 1) / 2
  res_t eps;   // Barrett eps of the residue products (unused under kRem)
  int s1, s2;
  int mode;
  int window;  // lazy window: values stay in [0, window * q)
  int beta;    // Shoup shift: 32 at window 2, <= 31 at window 4
  res_t bm;    // kRem: block_barrett constant of q
  int bs1;     // its shift, bit_length(q) - 1
};

// Channel c's Reduce from the (t,) device arrays of q, (q + 1) / 2 and the
// Barrett eps, the regime shared by every channel, and, under kRem, the
// block-Barrett constant m = floor(2^(b+31) / q), b = bit_length(q)
// (repro_torch.core.rns.block_barrett_constant; below 2^32 because
// q > 2^(b-1)).
__device__ __forceinline__ Reduce channel_reduce(const i64* qs, const i64* half, const i64* eps,
                                                 int c, int mode, int window, int beta, int s1,
                                                 int s2, res_t block_m) {
  Reduce r;
  r.q = (res_t)qs[c];
  r.half = (res_t)half[c];
  r.eps = (res_t)eps[c];
  r.s1 = s1;
  r.s2 = s2;
  r.mode = mode;
  r.window = window;
  r.beta = beta;
  r.bm = mode == kRem ? block_m : 0;
  r.bs1 = mode == kRem ? 31 - __clz((int)r.q) : 0;
  return r;
}

// The same for a kernel that holds no table of m (K1, K3, K4): under kRem
// each thread derives it with one 64-bit division as it sets the channel
// up.  K2 passes RnsPlan.dec_d's m, which its decompose keeps in shared
// memory.
__device__ __forceinline__ Reduce channel_reduce(const i64* qs, const i64* half, const i64* eps,
                                                 int c, int mode, int window, int beta, int s1,
                                                 int s2) {
  res_t m = 0;
  if (mode == kRem) {
    const res_t q = (res_t)qs[c];
    m = (res_t)((1ull << (63 - __clz((int)q))) / q);
  }
  return channel_reduce(qs, half, eps, c, mode, window, beta, s1, s2, m);
}

// The butterfly regime a kernel instance fixes at compile time: lazy with
// window 2 (v = 30), lazy with window 4 (v <= 29), or strict (Barrett
// products, or block-Barrett ones under kRem, decided at run time).
enum Regime : int { kLazy2 = 0, kLazy4 = 1, kStrict = 2 };

// The Regime of a table set's (mode, window) (kernels/ntt.py reduction_mode).
inline int regime_of(int mode, int window) {
  return mode != kLazy ? kStrict : (window == 2 ? kLazy2 : kLazy4);
}

// channel_reduce with the regime REG fixed, so the branches of the
// butterflies on mode and window fold away; `block_m` is m where the
// kernel holds it (K2), else nothing.
template <int REG, typename... BlockM>
__device__ __forceinline__ Reduce regime_reduce(const i64* qs, const i64* half, const i64* eps,
                                                int c, int mode, int window, int beta, int s1,
                                                int s2, BlockM... block_m) {
  if (REG != kStrict) {
    mode = kLazy;
    window = REG == kLazy2 ? 2 : 4;
  }
  if (REG == kLazy2) beta = 32;
  return channel_reduce(qs, half, eps, c, mode, window, beta, s1, s2, block_m...);
}

// x - m where x >= m: min(x, x - m) on unsigned 32-bit words.
__device__ __forceinline__ res_t cond_sub(res_t x, res_t m) { return min(x, x - m); }

__device__ __forceinline__ res_t add_mod(res_t x, res_t y, res_t q) { return cond_sub(x + y, q); }

__device__ __forceinline__ res_t sub_mod(res_t x, res_t y, res_t q) {
  return x >= y ? x - y : x - y + q;
}

// x * 2^-1 mod q (Eq 24).
__device__ __forceinline__ res_t div2_mod(res_t x, res_t half) {
  return (x >> 1) + (x & 1) * half;
}

// One conditional subtraction on 64-bit words.
__device__ __forceinline__ u64 cond_sub64(u64 r, u64 q) { return r >= q ? r - q : r; }

// x mod q for x < 2^(2b), b = bit_length(q) = s1 + 1 <= 31, with
// m = floor(2^(b+31) / q) (repro_torch.core.rns.block_barrett_constant):
// x >> s1 < 2^32 and m < 2^32, the quotient is low by at most 2, so the
// remainder lies in [0, 3q) (32 bits when NARROW).
template <bool NARROW>
__device__ __forceinline__ i64 block_barrett(u64 x, i64 q, i64 m, int s1) {
  const res_t qhat = __umulhi((res_t)(x >> s1), (res_t)m);
  if (NARROW) {
    res_t r = (res_t)x - qhat * (res_t)q;
    r = cond_sub(r, (res_t)q);
    return cond_sub(r, (res_t)q);
  }
  u64 r = x - (u64)qhat * (res_t)q;
  r = cond_sub64(r, q);
  return (i64)cond_sub64(r, q);
}

// x * y mod q for x, y in [0, q): under kRem the block Barrett (x * y <
// q^2 < 2^(2b)), else the Barrett of the residue products.
__device__ __forceinline__ res_t mul_mod(res_t x, res_t y, const Reduce& r) {
  const u64 p = (u64)x * y;
  if (r.mode == kRem) return (res_t)block_barrett<false>(p, r.q, r.bm, r.bs1);
  const res_t qhat = (res_t)(((u64)(res_t)(p >> r.s1) * r.eps) >> r.s2);
  res_t rem = (res_t)p - qhat * r.q;  // in [0, 4q), exact mod 2^32
  rem = cond_sub(rem, r.q);
  rem = cond_sub(rem, r.q);
  return cond_sub(rem, r.q);
}

// v * w mod q up to one extra q: [0, 2q), no conditional subtraction.
__device__ __forceinline__ res_t shoup_mul(res_t v, res_t w, res_t ws, const Reduce& r) {
  const res_t qhat = r.window == 2 ? __umulhi(v, ws) : (res_t)(((u64)v * ws) >> r.beta);
  return v * w - qhat * r.q;
}

__device__ __forceinline__ void ct_butterfly(res_t& u, res_t& v, res_t w, res_t ws,
                                             const Reduce& r) {
  if (r.mode == kLazy) {
    const res_t t = shoup_mul(v, w, ws, r);
    const res_t q2 = 2 * r.q;
    if (r.window == 4) {
      const res_t uu = cond_sub(u, q2);
      u = uu + t;
      v = uu - t + q2;
    } else {
      const res_t x = cond_sub(u + t, q2);
      v = cond_sub(u - t + q2, q2);
      u = x;
    }
  } else {
    const res_t p = mul_mod(v, w, r);
    const res_t x = add_mod(u, p, r.q);
    v = sub_mod(u, p, r.q);
    u = x;
  }
}

__device__ __forceinline__ void gs_butterfly(res_t& u, res_t& v, res_t w, res_t ws,
                                             const Reduce& r) {
  if (r.mode == kLazy) {
    const res_t wq = r.window * r.q;
    const res_t s = cond_sub(u + v, wq);
    const res_t d = shoup_mul(cond_sub(u - v + wq, wq), w, ws, r);
    u = div2_mod(s, r.half);
    v = div2_mod(d, r.half);
  } else {
    const res_t s = add_mod(u, v, r.q);
    const res_t d = mul_mod(sub_mod(u, v, r.q), w, r);
    u = div2_mod(s, r.half);
    v = div2_mod(d, r.half);
  }
}

// [0, window * q) -> [0, q): the one exit reduce of a lazy transform.
__device__ __forceinline__ res_t canonicalize(res_t x, const Reduce& r) {
  if (r.mode != kLazy) return x;
  if (r.window == 4) x = cond_sub(x, 2 * r.q);
  return cond_sub(x, r.q);
}

// A twiddle and its Shoup constant (both below 2^32) from the int64
// tables: the low 32-bit word of each (little-endian), one register each.
__device__ __forceinline__ void load_twiddle(const i64* __restrict__ tab,
                                             const i64* __restrict__ tab_sh, int idx,
                                             const Reduce& r, res_t& w, res_t& ws) {
  w = __ldg(reinterpret_cast<const res_t*>(tab + idx));
  ws = r.mode == kLazy ? __ldg(reinterpret_cast<const res_t*>(tab_sh + idx)) : 0;
}

// --------------------------------------------------------------------------
// Register passes of the transforms (K1-K4)
// --------------------------------------------------------------------------
//
// A thread keeps 2^G coefficients of each polynomial in registers across
// G <= 3 stages, so a transform takes ceil(log2(n) / 3) trips through
// shared memory and a barrier after each, in place of one a stage.  A
// block has pass_threads(n) threads; the passes of a channel's cascade
// (K1, K2) are forward g0, K, ..., K, then the last forward pass, the
// pointwise product and the first inverse pass as one (middle_pass), then
// inverse K, ..., g0, with K = pass_group(n) and g0 = log2(n) - K
// (passes - 1).  The forward transform (K3) runs the forward passes
// alone, the inverse transform (K4) the inverse passes K, ..., K, g0.
// Residues sit in shared memory one pad word per 16 (pad), against the
// bank conflicts of the short strides.

constexpr int kMaxGroup = 3;  // stages a thread runs from registers per pass
static_assert(kMaxGroup == 3, "PARENTT_DISPATCH_G instantiates passes of 1 to 3 stages");

// Threads of a block that runs the passes over one n-point polynomial:
// n / 16 within [32, kMaxThreads], at most n / 2 (kernels/ntt.py
// pass_threads mirrors it).
__host__ __device__ inline int pass_threads(int n) {
  const int t = n / 16 < 32 ? 32 : (n / 16 > kMaxThreads ? kMaxThreads : n / 16);
  return t < n / 2 ? t : n / 2;
}

// K: stages a thread runs per pass, log2(n / threads) capped at kMaxGroup
// (kernels/ntt.py pass_group).  K < log2(n), so there are two passes or more.
__host__ __device__ inline int pass_group(int n) {
  int log_e = 0;
  while ((1 << (log_e + 1)) <= n / pass_threads(n)) ++log_e;
  return log_e < kMaxGroup ? log_e : kMaxGroup;
}

// Words of a padded residue polynomial, and the place of element i in it.
__host__ __device__ inline int padded(int n) { return n + n / 16; }
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// Where a pass reads its NPOLY polynomials and where it leaves them:
// padded residue polynomials in shared memory, or one (channel, row)
// polynomial of (t, rows, n) int64 words in device memory, each read as
// its residue, and each stored canonical (the transforms' one exit reduce).
template <int NPOLY>
struct SharedPolys {
  res_t* poly[NPOLY];
  __device__ __forceinline__ res_t load(int k, int i) const { return poly[k][pad(i)]; }
  __device__ __forceinline__ void store(int k, int i, res_t x, const Reduce&) const {
    poly[k][pad(i)] = x;
  }
};

template <int NPOLY>
struct DevicePolys {
  const i64* poly[NPOLY];
  __device__ __forceinline__ res_t load(int k, int i) const { return (res_t)__ldg(poly[k] + i); }
};

struct DeviceOut {
  i64* poly;
  __device__ __forceinline__ void store(int, int i, res_t x, const Reduce& r) const {
    poly[i] = canonicalize(x, r);
  }
};

// Forward CT stages s0 + J .. s0 + G - 1 in registers over NPOLY (1 or 2)
// polynomials that share the channel's tables (`y` is not touched when
// NPOLY is 1): x[m] (and y[m]) is element hi * (n >> s0) + m * (n >> (s0 +
// G)) + lo.  Stage s0 + j pairs m with m + 2^(G-1-j) and uses twiddle
// fwd[2^(s0+j) + (hi << j) + (m >> (G-j))].  One stage per template
// level, so every loop bound and register index is a compile-time
// constant.
template <int G, int NPOLY, int J = 0>
__device__ __forceinline__ void ct_group(res_t (&x)[1 << G], res_t (&y)[1 << G], int hi, int s0,
                                         const i64* __restrict__ fwd,
                                         const i64* __restrict__ fwd_sh, const Reduce& r) {
  static_assert(NPOLY == 1 || NPOLY == 2, "a pass runs one or two polynomials");
  if constexpr (J < G) {
    constexpr int half = 1 << (G - 1 - J);
    const int base = (1 << (s0 + J)) + (hi << J);
#pragma unroll
    for (int b = 0; b < (1 << J); ++b) {
      res_t w, ws;
      load_twiddle(fwd, fwd_sh, base + b, r, w, ws);
#pragma unroll
      for (int k = 0; k < half; ++k) {
        ct_butterfly(x[b * 2 * half + k], x[b * 2 * half + k + half], w, ws, r);
        if constexpr (NPOLY == 2) {
          ct_butterfly(y[b * 2 * half + k], y[b * 2 * half + k + half], w, ws, r);
        }
      }
    }
    ct_group<G, NPOLY, J + 1>(x, y, hi, s0, fwd, fwd_sh, r);
  }
}

// Inverse GS stages s0 + J .. s0 + G - 1 in registers: x[m] is element
// hi * 2^(s0+G) + m * 2^s0 + lo.  Stage s0 + j pairs m with m + 2^j and
// uses twiddle inv[(n >> (s0+j+1)) + (hi << (G-j-1)) + (m >> (j+1))].
template <int G, int J = 0>
__device__ __forceinline__ void gs_group(res_t (&x)[1 << G], int hi, int s0, int log_n,
                                         const i64* __restrict__ inv,
                                         const i64* __restrict__ inv_sh, const Reduce& r) {
  if constexpr (J < G) {
    constexpr int half = 1 << J;
    const int base = (1 << (log_n - 1 - s0 - J)) + (hi << (G - 1 - J));
#pragma unroll
    for (int b = 0; b < (1 << (G - 1 - J)); ++b) {
      res_t w, ws;
      load_twiddle(inv, inv_sh, base + b, r, w, ws);
#pragma unroll
      for (int k = 0; k < half; ++k) {
        gs_butterfly(x[b * 2 * half + k], x[b * 2 * half + k + half], w, ws, r);
      }
    }
    gs_group<G, J + 1>(x, hi, s0, log_n, inv, inv_sh, r);
  }
}

// The threads that run a pass, and the barrier after it: the whole block
// (every kernel but the tile streams), or a block's first N threads beside
// a producer warp that never joins them (K3-fs, K4-fs: named barrier 1).
struct WholeBlock {
  static constexpr int kMaxG = kMaxGroup;  // stages a pass may take (stage loops)
  __device__ __forceinline__ int id() const { return threadIdx.x; }
  __device__ __forceinline__ int size() const { return blockDim.x; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};
template <int N, int MAXG>
struct FirstThreads {
  static constexpr int kMaxG = MAXG;
  __device__ __forceinline__ int id() const { return threadIdx.x; }
  __device__ __forceinline__ int size() const { return N; }
  __device__ __forceinline__ void sync() const {
    asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
  }
};

// Tables of one channel.
struct ChannelTabs {
  const i64* fwd;
  const i64* inv;
  const i64* fwd_sh;
  const i64* inv_sh;
};

// G forward stages from s0 over NPOLY polynomials for the groups p0 .. p1 - 1
// of a length-2^log_n transform, read from `in` and left in `out`.  Group
// p holds elements base + m 2^log_st (forward_pass); a multi-block kernel
// runs the groups of its span of the polynomial.
template <int G, int NPOLY, typename In, typename Out, typename Crew = WholeBlock>
__device__ __forceinline__ void forward_span(const In& in, const Out& out, int s0, int log_n,
                                             int p0, int p1, const ChannelTabs& tb,
                                             const Reduce& r, const Crew& crew = Crew{}) {
  const int log_st = log_n - s0 - G;
  for (int p = p0 + crew.id(); p < p1; p += crew.size()) {
    const int hi = p >> log_st;
    const int base = (hi << (log_st + G)) + (p & ((1 << log_st) - 1));
    res_t x[1 << G], y[1 << G];
#pragma unroll
    for (int m = 0; m < (1 << G); ++m) {
      x[m] = in.load(0, base + (m << log_st));
      if constexpr (NPOLY == 2) y[m] = in.load(1, base + (m << log_st));
    }
    ct_group<G, NPOLY>(x, y, hi, s0, tb.fwd, tb.fwd_sh, r);
#pragma unroll
    for (int m = 0; m < (1 << G); ++m) {
      out.store(0, base + (m << log_st), x[m], r);
      if constexpr (NPOLY == 2) out.store(1, base + (m << log_st), y[m], r);
    }
  }
}

// A pass of G forward stages from s0 over NPOLY whole polynomials.  In the
// first pass (s0 = 0) thread p holds elements p + m 2^(log_n - G), so
// consecutive threads read consecutive words; in the last
// (s0 = log_n - G) its 2^G elements are contiguous.
template <int G, int NPOLY, typename In, typename Out>
__device__ __forceinline__ void forward_pass(const In& in, const Out& out, int s0, int log_n,
                                             const ChannelTabs& tb, const Reduce& r) {
  forward_span<G, NPOLY>(in, out, s0, log_n, 0, 1 << (log_n - G), tb, r);
}

// The last G forward stages, the canonical pointwise product and the
// first G inverse stages for the groups p0 .. p1 - 1: both touch the same
// 2^G contiguous elements, so they share one trip.  Reads both operands
// from `in`, leaves the product's partial inverse in `out`.
template <int G, typename In, typename Out>
__device__ __forceinline__ void middle_span(const In& in, const Out& out, int log_n, int p0,
                                            int p1, const ChannelTabs& tb, const Reduce& r) {
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
    const int base = p << G;
    res_t x[1 << G], y[1 << G];
#pragma unroll
    for (int m = 0; m < (1 << G); ++m) {
      x[m] = in.load(0, base + m);
      y[m] = in.load(1, base + m);
    }
    ct_group<G, 2>(x, y, p, log_n - G, tb.fwd, tb.fwd_sh, r);
#pragma unroll
    for (int m = 0; m < (1 << G); ++m) x[m] = mul_mod(canonicalize(x[m], r), canonicalize(y[m], r), r);
    gs_group<G>(x, p, 0, log_n, tb.inv, tb.inv_sh, r);
#pragma unroll
    for (int m = 0; m < (1 << G); ++m) out.store(0, base + m, x[m], r);
  }
}

// middle_span over whole polynomials A and B in shared memory, into A.
template <int G>
__device__ __forceinline__ void middle_pass(res_t* A, res_t* B, int log_n, const ChannelTabs& tb,
                                            const Reduce& r) {
  middle_span<G>(SharedPolys<2>{{A, B}}, SharedPolys<1>{{A}}, log_n, 0, 1 << (log_n - G), tb, r);
}

// What the last inverse pass does to each value before it stores it.
struct Keep {
  __device__ __forceinline__ res_t operator()(res_t x, const Reduce&) const { return x; }
};

// G inverse stages from s0 for the groups p0 .. p1 - 1 of a length-2^log_n
// transform, read from `in` and left in `out`, each value through
// `finish` first.  Group p holds elements base + m 2^s0.
template <int G, typename In, typename Out, typename Finish, typename Crew = WholeBlock>
__device__ __forceinline__ void inverse_span(const In& in, const Out& out, int s0, int log_n,
                                             int p0, int p1, const Finish& finish,
                                             const ChannelTabs& tb, const Reduce& r,
                                             const Crew& crew = Crew{}) {
  for (int p = p0 + crew.id(); p < p1; p += crew.size()) {
    const int hi = p >> s0;
    const int base = (hi << (s0 + G)) + (p & ((1 << s0) - 1));
    res_t x[1 << G];
#pragma unroll
    for (int m = 0; m < (1 << G); ++m) x[m] = in.load(0, base + (m << s0));
    gs_group<G>(x, hi, s0, log_n, tb.inv, tb.inv_sh, r);
#pragma unroll
    for (int m = 0; m < (1 << G); ++m) out.store(0, base + (m << s0), finish(x[m], r), r);
  }
}

// A pass of G inverse stages from s0 over a whole polynomial.  In the last
// pass (s0 = log_n - G) thread p holds elements p + m 2^s0, so
// consecutive threads store consecutive words.
template <int G, typename In, typename Out, typename Finish>
__device__ __forceinline__ void inverse_pass(const In& in, const Out& out, int s0, int log_n,
                                             const Finish& finish, const ChannelTabs& tb,
                                             const Reduce& r) {
  inverse_span<G>(in, out, s0, log_n, 0, 1 << (log_n - G), finish, tb, r);
}

// g in 1 .. kMaxGroup
#define PARENTT_DISPATCH_G(g, CALL) \
  switch (g) {                      \
    case 1: CALL(1); break;         \
    case 2: CALL(2); break;         \
    default: CALL(3); break;        \
  }

// g in 1 .. Crew::kMaxG (3, or 4 for a crew whose threads hold 16 values
// of a pass: the tile streams')
#define PARENTT_DISPATCH_CREW_G(g, CALL)  \
  if constexpr (Crew::kMaxG == 4) {       \
    if (g == 4) {                         \
      CALL(4);                            \
    } else {                              \
      PARENTT_DISPATCH_G(g, CALL)         \
    }                                     \
  } else {                                \
    PARENTT_DISPATCH_G(g, CALL)           \
  }

// The cascade NTT(a) (.) NTT(b) -> iNTT of one channel over the shared
// polynomials A and B (each padded(n) words): the first forward pass reads
// both operands from `in`, the last inverse pass stores the product,
// each value through `finish`, to `out`; the spectra stay bit-reversed
// between the transforms.  A barrier follows every pass but the last:
// `out`'s reader synchronises.
template <typename In, typename Out, typename Finish>
__device__ __forceinline__ void channel_cascade(res_t* A, res_t* B, const In& in, const Out& out,
                                                const Finish& finish, int log_n, int K,
                                                const ChannelTabs& tb, const Reduce& r) {
  const int passes = (log_n + K - 1) / K;
  const int g0 = log_n - K * (passes - 1);
  const SharedPolys<2> ab{{A, B}};
  const SharedPolys<1> a{{A}};
#define FIRST(G) forward_pass<G, 2>(in, ab, 0, log_n, tb, r)
  PARENTT_DISPATCH_G(g0, FIRST)
#undef FIRST
  __syncthreads();
  int s0 = g0;
  for (int q = 1; q + 1 < passes; ++q, s0 += K) {
#define FWD(G) forward_pass<G, 2>(ab, ab, s0, log_n, tb, r)
    PARENTT_DISPATCH_G(K, FWD)
#undef FWD
    __syncthreads();
  }
#define MID(G) middle_pass<G>(A, B, log_n, tb, r)
  PARENTT_DISPATCH_G(K, MID)
#undef MID
  __syncthreads();
  s0 = K;
  for (int q = passes - 2; q > 0; --q, s0 += K) {
#define INV(G) inverse_pass<G>(a, a, s0, log_n, Keep{}, tb, r)
    PARENTT_DISPATCH_G(K, INV)
#undef INV
    __syncthreads();
  }
#define LAST(G) inverse_pass<G>(a, out, s0, log_n, finish, tb, r)
  PARENTT_DISPATCH_G(g0, LAST)
#undef LAST
}

// --------------------------------------------------------------------------
// Hopper primitives: mbarriers, TMA and bulk copies, proxy fences, L2
// cache policies, release/acquire counters (sm_90a; K7's rings and the
// multi-block transforms' tile streams)
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Arrive once and expect `bytes` more of TMA traffic in the current phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Whether the phase of parity `parity` has completed, after waiting for
// it a while (the hardware's time limit of try_wait) if it has not.
__device__ __forceinline__ bool mbar_try(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// A spin that outlasts some seconds is a fault of a ring's or a queue's
// bookkeeping: trap, so the launch fails instead of hanging the card.
struct Watchdog {
  uint64_t start = 0;
  uint32_t spins = 0;
  __device__ __forceinline__ void tick() {
    if ((++spins & 0xfff) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > 4000000000ull) __trap();  // 4 s
    }
  }
};

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  Watchdog dog;
  do {
    dog.tick();
  } while (!mbar_try(bar, parity));
}

// One box of a 4-D tensor map (coordinates innermost first) into shared
// memory; the copy counts its bytes on `bar`.  Elements past the tensor's
// edge arrive as zeros.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar))
      : "memory");
}

// One box of a 2-D tensor map into shared memory, its bytes counted on
// `bar`, under the L2 cache policy `policy`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) of device memory
// into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1], %2, [%3], %4;\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// A box of shared memory out to a 2-D tensor map, in this thread's bulk
// group.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0, {%1, %2}], [%3], %4;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_addr(src)), "l"(policy)
      : "memory");
}

// `bytes` of shared memory out to device memory, in this thread's bulk group.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes,
                                           uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Until this thread's bulk stores are written.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Orders this thread's generic accesses of shared memory (or of device
// memory) with the async proxy's (TMA's) on either side.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// L2 policies for a bulk copy: lines streamed once go first, lines read
// again soon are kept as any other.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}
__device__ __forceinline__ uint64_t l2_evict_normal() {
  uint64_t p;
  asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(p));
  return p;
}

// A counter read with acquire and added to with release, across the card.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void red_release_add(int* p, int v) {
  asm volatile("red.release.gpu.global.add.s32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

// cuTensorMapEncodeTiled is a driver-API call: it is looked up through the
// runtime, so the libraries need no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// --------------------------------------------------------------------------
// Multi-block (four-step) transforms (K3-fs, K4-fs; the cluster cascade
// of K1-fs and K2-fs below)
// --------------------------------------------------------------------------
//
// A polynomial too long for one CTA's shared memory is the same radix-2
// flow graph viewed as an (n1, n2) tile, element x = r n2 + c, with
// n2 = 2^ceil(L/2), n1 = n / n2 (L = log2 n; kernels/ntt.py fs_split).
// K3-fs's and K4-fs's tiles hold E = min(n, 4096) elements (kLogFsTile):
//
// * Column stages s = 0 .. L1 - 1 (L1 = log2 n1) pair x with x + n/2^(s+1),
//   rows apart in one column.  A column CTA takes C = E / n1 adjacent
//   columns of every row as a virtual length-E polynomial v = r C + cc.
//   Virtual stage s pairs v with v + E/2^(s+1), the same rows, and its
//   twiddle fwd[2^s + (v >> (log E - s))] = fwd[2^s + (r >> (L1 - s))] is
//   the real one (the fwd[:n1] prefix), so the register passes run on the
//   virtual tile unchanged with log_n = log E.  The inverse column stages
//   u = L2 .. L - 1 (stride 2^u) are virtual stages log C + u - L2, whose
//   twiddle inv[(E >> (u'+1)) + (v >> (u'+1))] is the real
//   inv[(n >> (u+1)) + (x >> (u+1))] too.
// * Row stages s = L1 .. L - 1 pair inside rows.  A row CTA takes
//   R = E / n2 whole rows, the contiguous span [x0, x0 + E), and runs
//   the passes on real indices over the groups of that span; the
//   twiddle fwd[2^s + (x >> (L - s))] is fwd[((n1 + r) << k) + low] with
//   k = s - L1, the reference's four_step_row_indices, read from the
//   stage table itself.
//
// Between the column and the row stages the values stay lazy (below W q,
// or q when strict) as 32-bit words: a butterfly's window does not depend
// on its stage, so the row stages continue from the column stages'
// bounds.  K3-fs and K4-fs keep them in a (t, rows, n) scratch tensor
// between the two phases of their tile stream (below); the cluster cascade
// keeps them in its CTAs' shared memory.  The passes between a tile's
// first and last run through the CTA's tile in shared memory (padded one
// word in 16 against bank conflicts).

constexpr int kLogFsTile = 12;

// A column CTA's virtual element v -> its place x in the polynomial.
struct ColMap {
  int log_c, log_n2, c0;
  __device__ __forceinline__ int operator()(int v) const {
    return ((v >> log_c) << log_n2) + c0 + (v & ((1 << log_c) - 1));
  }
};

struct RowMap {
  __device__ __forceinline__ int operator()(int x) const { return x; }
};

__device__ __forceinline__ res_t read_word(const i64* p) { return (res_t)__ldg(p); }
// 32-bit words are read as plain loads: K2-fs's cascade stores y over the
// residues it read
__device__ __forceinline__ res_t read_word(const res_t* p) { return *p; }

// NPOLY polynomials in device memory (int64 residues, or 32-bit words
// that the same CTA may overwrite later in the launch).
template <typename T, int NPOLY, typename Map>
struct GlobalIn {
  const T* poly[NPOLY];
  Map map;
  __device__ __forceinline__ res_t load(int k, int i) const { return read_word(poly[k] + map(i)); }
};

// One int64 polynomial in device memory, stored canonical.
template <typename Map>
struct CanonOut {
  i64* poly;
  Map map;
  __device__ __forceinline__ void store(int, int i, res_t x, const Reduce& r) const {
    poly[map(i)] = canonicalize(x, r);
  }
};

// A CTA's tile of NPOLY polynomials in shared memory, element i at
// pad(i - off) (off: the first element of a row CTA's span).
template <int NPOLY>
struct TilePolys {
  res_t* poly[NPOLY];
  int off;
  __device__ __forceinline__ res_t load(int k, int i) const { return poly[k][pad(i - off)]; }
  __device__ __forceinline__ void store(int k, int i, res_t x, const Reduce&) const {
    poly[k][pad(i - off)] = x;
  }
};

// Forward stages s_begin .. s_end - 1 of a length-2^log_n transform over the
// groups of the span [x0, x0 + 2^log_span), in passes of K stages after a
// first of g0: the first pass reads `in`, the last writes `out`, the passes
// between go through `tile` with a barrier after each pass that writes it.
// No barrier follows the last pass.  `crew` runs the passes.
template <int NPOLY, typename In, typename Tile, typename Out, typename Crew = WholeBlock>
__device__ __forceinline__ void forward_stages(const In& in, const Tile& tile, const Out& out,
                                               int s_begin, int s_end, int log_n, int x0,
                                               int log_span, int K, const ChannelTabs& tb,
                                               const Reduce& r, const Crew& crew = Crew{}) {
  const int passes = (s_end - s_begin + K - 1) / K;
  const int g0 = s_end - s_begin - K * (passes - 1);
  int s0 = s_begin;
  for (int q = 0; q < passes; ++q) {
    const int G = q == 0 ? g0 : K;
    const int p0 = x0 >> G, p1 = (x0 + (1 << log_span)) >> G;
    if (passes == 1) {
#define ONE(G) forward_span<G, NPOLY>(in, out, s0, log_n, p0, p1, tb, r, crew)
      PARENTT_DISPATCH_CREW_G(G, ONE)
#undef ONE
    } else if (q == 0) {
#define FIRST(G) forward_span<G, NPOLY>(in, tile, s0, log_n, p0, p1, tb, r, crew)
      PARENTT_DISPATCH_CREW_G(G, FIRST)
#undef FIRST
    } else if (q + 1 < passes) {
#define MID(G) forward_span<G, NPOLY>(tile, tile, s0, log_n, p0, p1, tb, r, crew)
      PARENTT_DISPATCH_CREW_G(G, MID)
#undef MID
    } else {
#define LAST(G) forward_span<G, NPOLY>(tile, out, s0, log_n, p0, p1, tb, r, crew)
      PARENTT_DISPATCH_CREW_G(G, LAST)
#undef LAST
    }
    if (q + 1 < passes) crew.sync();
    s0 += G;
  }
}

// Inverse stages u_begin .. u_end - 1 (stride 2^u) likewise, in passes of K
// stages and a last of g0; the last pass stores each value through `finish`.
template <typename In, typename Tile, typename Out, typename Crew = WholeBlock>
__device__ __forceinline__ void inverse_stages(const In& in, const Tile& tile, const Out& out,
                                               int u_begin, int u_end, int log_n, int x0,
                                               int log_span, int K, const ChannelTabs& tb,
                                               const Reduce& r, const Crew& crew = Crew{}) {
  const int passes = (u_end - u_begin + K - 1) / K;
  const int g0 = u_end - u_begin - K * (passes - 1);
  int s0 = u_begin;
  for (int q = 0; q < passes; ++q) {
    const int G = q + 1 < passes ? K : g0;
    const int p0 = x0 >> G, p1 = (x0 + (1 << log_span)) >> G;
    if (passes == 1) {
#define ONE(G) inverse_span<G>(in, out, s0, log_n, p0, p1, Keep{}, tb, r, crew)
      PARENTT_DISPATCH_CREW_G(G, ONE)
#undef ONE
    } else if (q == 0) {
#define FIRST(G) inverse_span<G>(in, tile, s0, log_n, p0, p1, Keep{}, tb, r, crew)
      PARENTT_DISPATCH_CREW_G(G, FIRST)
#undef FIRST
    } else if (q + 1 < passes) {
#define MID(G) inverse_span<G>(tile, tile, s0, log_n, p0, p1, Keep{}, tb, r, crew)
      PARENTT_DISPATCH_CREW_G(G, MID)
#undef MID
    } else {
#define LAST(G) inverse_span<G>(tile, out, s0, log_n, p0, p1, Keep{}, tb, r, crew)
      PARENTT_DISPATCH_CREW_G(G, LAST)
#undef LAST
    }
    if (q + 1 < passes) crew.sync();
    s0 += G;
  }
}

// Arguments of the multi-block launches: the int64 operands the first
// launch reads, the 32-bit scratch between launches, the int64 output of
// the last, and the channel tables (t, n) with their Shoup constants.
struct FsArgs {
  const i64* in[2];
  res_t* scratch[2];
  i64* out;
  const i64* qs;
  const i64* half;
  const i64* eps;
  const i64* fwd;
  const i64* inv;
  const i64* fwd_sh;
  const i64* inv_sh;
  int rows;
  int log_n;
  int mode;
  int window;
  int beta;
  int s1;
  int s2;
};

// Channel c's reduction constants and tables for a multi-block launch.
template <int REG>
__device__ __forceinline__ Reduce fs_reduce(const FsArgs& a, int c) {
  return regime_reduce<REG>(a.qs, a.half, a.eps, c, a.mode, a.window, a.beta, a.s1, a.s2);
}

__device__ __forceinline__ ChannelTabs fs_tabs(const FsArgs& a, int c) {
  const size_t off = (size_t)c << a.log_n;
  return ChannelTabs{a.fwd + off, a.inv + off, a.fwd_sh + off, a.inv_sh + off};
}

// One 32-bit polynomial in device memory, each value stored as y =
// canonical(p) * q~ mod q for the compose (K2-fs's cascade).
template <typename Map>
struct TildeOut {
  res_t* poly;
  Map map;
  res_t tilde;
  __device__ __forceinline__ void store(int, int i, res_t x, const Reduce& r) const {
    poly[map(i)] = mul_mod(canonicalize(x, r), tilde, r);
  }
};

// --------------------------------------------------------------------------
// K3-fs and K4-fs: one persistent launch a call, streaming tiles
// --------------------------------------------------------------------------
//
// The grid is the CTAs the card holds at once (kernels/ntt.py
// fs_stream_grid).  A CTA is kFsStreamThreads consumer threads, which run
// the passes, and one producer warp whose first lane moves every tile in
// and out with TMA.  Every CTA takes tickets of one ordered queue from a
// device counter (atomicAdd): the first phase's tiles (K3-fs: columns;
// K4-fs: rows) and the second phase's of every (channel, row) polynomial,
// each polynomial's tiles in order, the second phase's handed out `lag`
// first-phase tiles behind (fs_ticket; lag = tiles a polynomial + grid).
// A first-phase tile's store, once written, adds one to its polynomial's
// arrival counter (release); a second-phase tile is loaded once that
// counter holds all the polynomial's first-phase tiles (acquire, then a
// proxy fence before the TMA load).  Those were handed out earlier, so the
// CTAs that hold them never wait on the tile that waits: the producer
// polls, and keeps storing its own CTA's finished tiles while it does.
// The 32-bit words between the phases are read back about two tiles'
// time after they are written, from L2 where they still sit; the input
// and output stream past with L2's evict-first policy.  Device memory
// sees each input word read once, each output word written once, and
// the scratch written back from L2 at most once (16 to 20 bytes a
// coefficient, against 24 for two launches).
//
// What bounds it on an H100: the passes' integer work, not the bytes.
// Alone, with no TMA traffic, the passes take longer than the copies
// alone, and the stream comes out a little above the larger of the two
// (chip_smoke.py --transform-variants; PERF.md).  Two CTAs an SM
// (shared memory) of 256 consumer threads: 512 or a third CTA of 128 were
// slower.
//
// The producer keeps the next tile's input in flight in a ring of two
// dense staging slots (E int64 words each) while the consumers run the
// current tile's passes, and drains each finished tile from its slot with
// a TMA store:
//   * a column tile is a 2-D box of C words x n1 rows of the (polys n1,
//     n2) view (fs_col_map) past n = 4096; at n <= 4096 it is the whole
//     polynomial, like a row tile a contiguous span, a 1-D bulk copy;
//   * the first pass reads the slot, the passes between go through the
//     padded tile, the last writes the slot back, dense, in the output's
//     word type (lazy 32-bit words or canonical int64) for the store.
// Where a thread's 2^G elements would sit side by side in int64 words
// (K3-fs's last row pass, K4-fs's first) the tile is copied between the
// slot and the padded tile in its own step instead, so the slot's int64
// words are read and written by consecutive threads.
// Full and done mbarriers per slot hand a tile between the producer and
// the consumers; the consumers' barrier is named barrier 1.  The arrival
// counters and the queue's counter are zeroed on the stream before each
// launch (cudaMemsetAsync).  A launch of one phase (phases 1 or 2) runs
// the same tile loop over that phase's tiles alone.

constexpr int kFsStreamThreads = 256;                 // consumer threads a CTA
constexpr int kFsStreamBlock = kFsStreamThreads + 32;  // and the producer warp
constexpr int kFsStreamMinBlocks = 2;                  // CTAs an SM (shared memory holds two)
// Stages a pass takes (the first of the forward stages, the last of the
// inverse, fewer): K3-fs runs its eight column or row stages at n = 65536
// in two passes of 16 values a thread, K4-fs, whose butterflies halve, in
// three of 8, each the faster (chip_smoke.py --transform-variants, PERF.md).
template <bool FWD>
constexpr int kFsStreamGroup = FWD ? 4 : 3;
template <bool FWD>
using FsCrew = FirstThreads<kFsStreamThreads, kFsStreamGroup<FWD>>;

// PARENTT_FS_STREAM_FORM, for chip_smoke.py --transform-variants alone: 1
// copies each tile through the padded tile with no butterfly (the stream's
// memory time), 2 runs the passes with no TMA traffic (its integer time).
#ifndef PARENTT_FS_STREAM_FORM
#define PARENTT_FS_STREAM_FORM 0
#endif

// A multi-block transform's split: log2 of n, n1, n2, the tile E, the
// columns a column tile takes (C = E / n1) and the tiles a phase takes of
// each polynomial (n / E).
struct FsStreamGeom {
  int log_n, log_n1, log_n2, log_e, log_c, log_t;
};

__host__ __device__ inline FsStreamGeom fs_stream_geom(int log_n) {
  FsStreamGeom g;
  g.log_n = log_n;
  g.log_n2 = (log_n + 1) / 2;
  g.log_n1 = log_n - g.log_n2;
  g.log_e = log_n < kLogFsTile ? log_n : kLogFsTile;
  g.log_c = g.log_e - g.log_n1;
  g.log_t = log_n - g.log_e;
  return g;
}

// The queue's ticket k -> (second: the tile's phase, 0 or 1; its index
// among the phase's `tiles`, polynomial-major).  Both phases (phases = 3):
// the first `lag` first-phase tiles, then first- and second-phase tiles
// in turn, then the rest of the second phase; one phase alone (1 or 2): its
// tiles in order (kernels/ntt.py fs_ticket).
__host__ __device__ inline void fs_ticket(int k, int tiles, int lag, int phases, int& second,
                                          int& tile) {
  if (phases != 3) {
    second = phases == 2;
    tile = k;
    return;
  }
  const int d = lag < tiles ? lag : tiles;
  if (k < d) {
    second = 0;
    tile = k;
  } else if (k < 2 * tiles - d) {
    second = (k - d) & 1;
    tile = second ? (k - d) >> 1 : d + ((k - d) >> 1);
  } else {
    second = 1;
    tile = k - tiles;
  }
}

// First-phase tiles the queue hands out before the first second-phase
// tile: a polynomial's tiles and one a CTA, so a second-phase tile comes
// about two tiles' time after the last of its polynomial's first-phase
// tiles was handed out (kernels/ntt.py fs_lag).
__host__ __device__ inline int fs_stream_lag(int log_n, int grid) {
  return (1 << fs_stream_geom(log_n).log_t) + grid;
}

// Dynamic shared memory of a CTA: 128 bytes of alignment slack, the two
// staging slots, the padded tile, and the full and done mbarriers and
// the tickets of the two slots (kernels/ntt.py fs_stream_smem_bytes).
__host__ __device__ inline int fs_tile_words_bytes(int log_e) {
  return (padded(1 << log_e) * (int)sizeof(res_t) + 7) & ~7;
}
__host__ __device__ inline int fs_stream_smem(int log_n) {
  const int log_e = fs_stream_geom(log_n).log_e;
  return 128 + 2 * (8 << log_e) + fs_tile_words_bytes(log_e) + 4 * 8 + 2 * 4;
}

struct FsStreamArgs {
  const i64* in;   // (t, rows, n) int64 input
  res_t* scratch;  // (t, rows, n) 32-bit words between the phases
  i64* out;        // (t, rows, n) int64 output
  int* counters;   // [0] the queue's next ticket, [1 + p] polynomial p's first-phase tiles stored
  const i64* qs;
  const i64* half;
  const i64* eps;
  const i64* tab;  // the forward (K3-fs) or inverse (K4-fs) tables, (t, n)
  const i64* tab_sh;
  int rows, polys, log_n, mode, window, beta, s1, s2;
  int phases;  // the queue's phases: 3 both (every call), 1 or 2 one
  int lag;
};

// A tile staged dense in a slot: element i at word i - off (a column
// tile's virtual element v at v, a row tile's element x at x - x0), read
// as a residue, or stored lazy (32-bit words) or canonical (int64).
template <typename T>
struct StagedIn {
  const T* buf;
  int off;
  __device__ __forceinline__ res_t load(int, int i) const { return (res_t)buf[i - off]; }
};
template <typename T>
struct StagedOut {
  T* buf;
  int off;
  __device__ __forceinline__ void store(int, int i, res_t x, const Reduce& r) const {
    if constexpr (sizeof(T) == 8) buf[i - off] = (T)canonicalize(x, r);
    else buf[i - off] = (T)x;
  }
};

// Every element of the span [x0, x0 + E) from `in` to `out`.
template <typename In, typename Out, typename Crew>
__device__ __forceinline__ void copy_span(const In& in, const Out& out, int x0, int E,
                                          const Reduce& r, const Crew& crew) {
  for (int j = crew.id(); j < E; j += crew.size()) out.store(0, x0 + j, in.load(0, x0 + j), r);
}

// One tile's stages, read from and written back to its slot.  A phase whose
// stages take one pass runs it into the tile and copies it out after a
// barrier: its slot is both its input and its output.
template <bool FWD, typename Crew>
__device__ __forceinline__ void fs_stream_tile(int second, int blk, unsigned char* slot,
                                               res_t* words, const FsStreamGeom& g,
                                               const ChannelTabs& tb, const Reduce& r,
                                               const Crew& crew) {
  const int E = 1 << g.log_e;
  constexpr int K = kFsStreamGroup<FWD>;
  const bool one_pass = g.log_n1 <= K;  // the column stages (L1 of them) in one pass
#if PARENTT_FS_STREAM_FORM == 1
  {
    const int x0 = (FWD != (second != 0)) ? 0 : blk << g.log_e;
    const TilePolys<1> tile{{words}, x0};
    if (second) copy_span(StagedIn<res_t>{(const res_t*)slot, x0}, tile, x0, E, r, crew);
    else copy_span(StagedIn<i64>{(const i64*)slot, x0}, tile, x0, E, r, crew);
    crew.sync();
    if (second) copy_span(tile, StagedOut<i64>{(i64*)slot, x0}, x0, E, r, crew);
    else copy_span(tile, StagedOut<res_t>{(res_t*)slot, x0}, x0, E, r, crew);
    return;
  }
#endif
  if (FWD && !second) {  // column stages: int64 residues -> lazy 32-bit words
    const TilePolys<1> tile{{words}, 0};
    const StagedIn<i64> in{(const i64*)slot, 0};
    const StagedOut<res_t> out{(res_t*)slot, 0};
    if (!one_pass) {
      forward_stages<1>(in, tile, out, 0, g.log_n1, g.log_e, 0, g.log_e, K, tb, r, crew);
      return;
    }
    forward_stages<1>(in, tile, tile, 0, g.log_n1, g.log_e, 0, g.log_e, K, tb, r, crew);
    crew.sync();
    copy_span(tile, out, 0, E, r, crew);
  } else if (FWD) {  // row stages: 32-bit words -> canonical int64, through the tile
    const int x0 = blk << g.log_e;
    const TilePolys<1> tile{{words}, x0};
    forward_stages<1>(StagedIn<res_t>{(const res_t*)slot, x0}, tile, tile, g.log_n1, g.log_n,
                      g.log_n, x0, g.log_e, K, tb, r, crew);
    crew.sync();
    copy_span(tile, StagedOut<i64>{(i64*)slot, x0}, x0, E, r, crew);
  } else if (!second) {  // inverse row stages: int64 spectra, copied into the tile -> 32-bit words
    const int x0 = blk << g.log_e;
    const TilePolys<1> tile{{words}, x0};
    copy_span(StagedIn<i64>{(const i64*)slot, x0}, tile, x0, E, r, crew);
    crew.sync();
    inverse_stages(tile, tile, StagedOut<res_t>{(res_t*)slot, x0}, 0, g.log_n2, g.log_n, x0,
                   g.log_e, K, tb, r, crew);
  } else {  // inverse column stages: 32-bit words -> canonical int64
    const TilePolys<1> tile{{words}, 0};
    const StagedIn<res_t> in{(const res_t*)slot, 0};
    const StagedOut<i64> out{(i64*)slot, 0};
    if (!one_pass) {
      inverse_stages(in, tile, out, g.log_c, g.log_e, g.log_e, 0, g.log_e, K, tb, r, crew);
      return;
    }
    inverse_stages(in, tile, tile, g.log_c, g.log_e, g.log_e, 0, g.log_e, K, tb, r, crew);
    crew.sync();
    copy_span(tile, out, 0, E, r, crew);
  }
}

// The producer (one thread): hands tiles to the consumers through the
// ring and drains them, until the queue is empty; then marks the next
// slot with ticket -1.  `col_in` / `col_out`: the 2-D maps a column tile
// is loaded from and stored to past n = 4096.
template <bool FWD>
__device__ __forceinline__ void fs_stream_produce(const FsStreamArgs& a, const CUtensorMap& col_in,
                                                  const CUtensorMap& col_out,
                                                  unsigned char* slots, uint64_t* full,
                                                  uint64_t* done, int* info,
                                                  const FsStreamGeom& g) {
  const int E = 1 << g.log_e;
  const int T = 1 << g.log_t;
  const int tiles = a.polys << g.log_t;
  const int total = (a.phases == 3 ? 2 : 1) * tiles;
  const uint64_t streamed = l2_evict_first(), kept = l2_evict_normal();
  int loaded = 0, stored = 0, pending = -1;
  bool exhausted = false;
  // the tile in slot s: where it sits, and its byte offset in its tensors
  auto place = [&](int code, int& second, int& poly, int& blk, size_t& off) {
    int tile;
    fs_ticket(code, tiles, a.lag, a.phases, second, tile);
    poly = tile >> g.log_t;
    blk = tile & (T - 1);
    off = ((size_t)poly << g.log_n) + ((size_t)blk << g.log_e);
  };
  auto try_load = [&]() -> bool {
    if (exhausted || loaded - stored >= 2) return false;
    if (pending < 0) {
      pending = atomicAdd(a.counters, 1);
      if (pending >= total) {
        exhausted = true;
        return false;
      }
    }
    int second, poly, blk;
    size_t off;
    place(pending, second, poly, blk, off);
    if (second && a.phases == 3 && PARENTT_FS_STREAM_FORM != 2) {
      if (ld_acquire(a.counters + 1 + poly) < T) return false;
      fence_async_global();
    }
    const int s = loaded & 1;
    info[s] = pending;
    unsigned char* dst = slots + (size_t)s * (8 << g.log_e);
    const uint32_t bytes = (uint32_t)E * (second ? 4 : 8);
#if PARENTT_FS_STREAM_FORM == 2
    mbar_arrive(&full[s]);
    ++loaded;
    pending = -1;
    return true;
#endif
    mbar_expect_tx(&full[s], bytes);
    if (FWD != (second != 0) && g.log_t > 0)
      tma_load_2d(dst, &col_in, &full[s], blk << g.log_c, poly << g.log_n1, streamed);
    else if (second)
      bulk_load(dst, a.scratch + off, bytes, &full[s], streamed);
    else
      bulk_load(dst, a.in + off, bytes, &full[s], streamed);
    ++loaded;
    pending = -1;
    return true;
  };
  Watchdog dog;
  for (;;) {
    if (stored < loaded && mbar_try(&done[stored & 1], (stored >> 1) & 1)) {
      const int s = stored & 1;
      int second, poly, blk;
      size_t off;
      place(info[s], second, poly, blk, off);
      const unsigned char* src = slots + (size_t)s * (8 << g.log_e);
#if PARENTT_FS_STREAM_FORM == 2
      ++stored;
      try_load();
      continue;
#endif
      if (FWD != (second != 0) && g.log_t > 0)
        tma_store_2d(&col_out, src, blk << g.log_c, poly << g.log_n1, second ? streamed : kept);
      else if (second)
        bulk_store(a.out + off, src, (uint32_t)E * 8, streamed);
      else
        bulk_store(a.scratch + off, src, (uint32_t)E * 4, kept);
      bulk_commit();
      bulk_wait_read();
      ++stored;
      try_load();  // the slot is free: refill it before the store is written
      if (!second) {  // a first-phase tile: once written, its polynomial's count
        bulk_wait();
        fence_async_global();
        red_release_add(a.counters + 1 + poly, 1);
      }
      dog = Watchdog{};
    } else if (try_load()) {
      dog = Watchdog{};
    } else if (exhausted && stored == loaded) {
      info[loaded & 1] = -1;
      mbar_arrive(&full[loaded & 1]);
      bulk_wait();
      return;
    } else {  // a second-phase tile waits, or the queue is empty and tiles are out
      dog.tick();
      if (stored == loaded) __nanosleep(256);
    }
  }
}

// One CTA of K3-fs (FWD) or K4-fs's tile stream in regime REG; `raw`: its
// fs_stream_smem bytes of dynamic shared memory.
template <int REG, bool FWD>
__device__ __forceinline__ void fs_stream(const FsStreamArgs& a, const CUtensorMap& col_in,
                                          const CUtensorMap& col_out, unsigned char* raw) {
  const FsStreamGeom g = fs_stream_geom(a.log_n);
  unsigned char* slots = raw + ((128 - (smem_addr(raw) & 127)) & 127);
  res_t* words = (res_t*)(slots + 2 * (8 << g.log_e));
  uint64_t* full = (uint64_t*)((unsigned char*)words + fs_tile_words_bytes(g.log_e));
  uint64_t* done = full + 2;
  int* info = (int*)(done + 2);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&done[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kFsStreamThreads) {
    if (threadIdx.x == kFsStreamThreads)
      fs_stream_produce<FWD>(a, col_in, col_out, slots, full, done, info, g);
    return;
  }
  const FsCrew<FWD> crew{};
  const int tiles = a.polys << g.log_t;
  for (int i = 0;; ++i) {
    const int s = i & 1;
    mbar_wait(&full[s], (i >> 1) & 1);
    const int code = ((volatile int*)info)[s];
    if (code < 0) return;
    int second, tile;
    fs_ticket(code, tiles, a.lag, a.phases, second, tile);
    const int poly = tile >> g.log_t;
    const int c = poly / a.rows;
    unsigned char* slot = slots + (size_t)s * (8 << g.log_e);
    const size_t toff = (size_t)c << a.log_n;
    fs_stream_tile<FWD>(second, tile & ((1 << g.log_t) - 1), slot, words, g,
                        ChannelTabs{a.tab + toff, a.tab + toff, a.tab_sh + toff, a.tab_sh + toff},
                        regime_reduce<REG>(a.qs, a.half, a.eps, c, a.mode, a.window, a.beta,
                                           a.s1, a.s2),
                        crew);
    fence_async_shared();  // the slot's words, out to the producer's TMA store
    crew.sync();
    if (threadIdx.x == 0) mbar_arrive(&done[s]);
  }
}

// The 2-D map of the column view of a (t, rows, n) tensor of `word` (4 or
// 8) byte words at `base`: polys n1 rows of n2 words, in boxes of C words x
// n1 rows, one a column tile.  False where the driver's encoder is missing
// or refuses (kernels/ntt.py fs_col_box mirrors the geometry and TMA's
// limits on it).
inline bool fs_col_map(CUtensorMap* map, const void* base, int word, int log_n, int polys) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const FsStreamGeom g = fs_stream_geom(log_n);
  const cuuint64_t dims[2] = {(cuuint64_t)1 << g.log_n2, (cuuint64_t)polys << g.log_n1};
  const cuuint64_t strides[1] = {(cuuint64_t)word << g.log_n2};
  const cuuint32_t box[2] = {1u << g.log_c, 1u << g.log_n1};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, word == 8 ? CU_TENSOR_MAP_DATA_TYPE_INT64 : CU_TENSOR_MAP_DATA_TYPE_UINT32, 2,
                const_cast<void*>(base), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches a tile stream of `kernel` (FWD: K3-fs, else K4-fs) on `stream`
// with `grid` CTAs at most: zeroes the counters, encodes the column maps
// past n = 4096.  Returns the CUDA error.
template <typename Kernel>
inline int fs_stream_launch(Kernel kernel, bool fwd, FsStreamArgs a, int grid,
                            cudaStream_t stream) {
  const FsStreamGeom g = fs_stream_geom(a.log_n);
  cudaError_t err = cudaMemsetAsync(a.counters, 0, (1 + (size_t)a.polys) * sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap col_in, col_out;
  memset(&col_in, 0, sizeof col_in);
  memset(&col_out, 0, sizeof col_out);
  if (g.log_t > 0 &&
      (!fs_col_map(&col_in, fwd ? (const void*)a.in : a.scratch, fwd ? 8 : 4, a.log_n, a.polys) ||
       !fs_col_map(&col_out, fwd ? (const void*)a.scratch : a.out, fwd ? 4 : 8, a.log_n,
                   a.polys)))
    return (int)cudaErrorInvalidValue;
  a.lag = fs_stream_lag(a.log_n, grid);
  const int tickets = (a.phases == 3 ? 2 : 1) * (a.polys << g.log_t);
  const int smem = fs_stream_smem(a.log_n);
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid < tickets ? grid : tickets, kFsStreamBlock, smem, stream>>>(col_in, col_out, a);
  return (int)cudaGetLastError();
}

// CTAs of `kernel` an SM holds at once at n = 2^log_n, or minus the CUDA error.
template <typename Kernel>
inline int fs_stream_blocks_per_sm(Kernel kernel, int log_n) {
  const int smem = fs_stream_smem(log_n);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, kFsStreamBlock, smem);
  return err == cudaSuccess ? count : -(int)err;
}

// --------------------------------------------------------------------------
// The multi-block cascade as one cluster launch (K1-fs; K2-fs's cascade)
// --------------------------------------------------------------------------
//
// A thread-block cluster of C = 2^lc CTAs (C <= n1) per (channel, row)
// holds the row's two polynomials whole in shared memory as 32-bit words,
// on the (n1, n2) split above: E = n / C elements of each a CTA.  CTA k
// owns column block k (n1 rows x n2 / C adjacent columns: the virtual
// length-E polynomial v = r (n2 / C) + cc of ColMap, on which the column
// stages run as in K3-fs) and row block k (n1 / C whole rows, the span
// [k E, (k + 1) E), on which the row stages run).  Three padded E-word
// buffers a CTA:
//   buf0: a's column block, then b's row block;
//   buf1: b's column block, then the product's column block;
//   buf2: a's row block, then the product's.
// The transposes between the two views are the last pass of each phase:
// it stores every value straight into the buffer of the peer that owns it
// next (DSMEM), so nothing reaches device memory between the phases:
//   1. both operands' forward column stages but the last, together (the
//      first pass reads device memory), then a's last pass into the
//      peers' buf2;
//   2. cluster.sync (every peer has read its buf0); b's last column pass
//      into the peers' buf0;
//   3. cluster.sync; the forward row stages of both, the canonical
//      pointwise product and the inverse row stages (middle_span, as in
//      K1), the last inverse row pass into the peers' buf1;
//   4. cluster.sync; the inverse column stages, the last pass to `last`.
// A cluster barrier before any DSMEM store (its arrival at the start, its
// wait before the first store) makes four a call.  Device memory sees each operand word read once and each output
// word written once.

// log2 of the largest portable cluster; a launch past it (16 CTAs past
// n = 32768: kernels/ntt.py fs_cluster, which names each launch's size)
// opts in to a non-portable size.
constexpr int kLogCascadeCluster = 3;

// Threads and dynamic shared memory (three padded buffers) of a CTA of a
// cluster of 2^lc CTAs over n = 2^log_n (kernels/ntt.py mirrors both).
__host__ __device__ inline int cascade_fs_threads(int log_n, int lc) {
  return pass_threads(1 << (log_n - lc));
}
__host__ __device__ inline long long cascade_fs_smem(int log_n, int lc) {
  return 3LL * padded(1 << (log_n - lc)) * sizeof(res_t);
}

// CTA `rank`'s column block as a ColMap.
__device__ __forceinline__ ColMap cascade_colmap(int log_n, int lc, int rank) {
  const int log_n2 = (log_n + 1) / 2;
  return ColMap{log_n2 - lc, log_n2, rank << (log_n2 - lc)};
}

// The last column pass's store: virtual element v of this CTA's column
// block -> its element x -> the row block of CTA x / E, in its `buf`.
template <typename Cluster>
struct PeerRows {
  Cluster* cluster;
  res_t* buf;
  ColMap map;
  int log_e;
  __device__ __forceinline__ void store(int, int v, res_t x, const Reduce&) const {
    const int e = map(v);
    cluster->map_shared_rank(buf, e >> log_e)[pad(e & ((1 << log_e) - 1))] = x;
  }
};

// The last inverse row pass's store: element x -> the column block of the
// CTA that owns its column, in its `buf`.
template <typename Cluster>
struct PeerCols {
  Cluster* cluster;
  res_t* buf;
  int log_n2, log_cc;  // log n2, log2 of the columns of a block
  __device__ __forceinline__ void store(int, int x, res_t v, const Reduce&) const {
    const int col = x & ((1 << log_n2) - 1);
    const int at = ((x >> log_n2) << log_cc) + (col & ((1 << log_cc) - 1));
    cluster->map_shared_rank(buf, col >> log_cc)[pad(at)] = v;
  }
};

// The two halves of a cluster barrier (barrier.cluster): the arrival
// without memory ordering, and the wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// The cascade of one (channel, row) pair over a cluster of 2^lc CTAs (see
// above): the operands' (channel, row) polynomials `a` and `b` (int64
// residues or 32-bit words) are read through this CTA's ColMap, `last`
// stores the product's column block.  `smem`: cascade_fs_smem.  PHASES < 3
// stops after the first transpose (1) or the second (2), at a cluster
// barrier, so that a timing can split the launch; the kernels run all 3.
template <int PHASES = 3, typename T, typename Cluster, typename Last>
__device__ __forceinline__ void cluster_cascade(Cluster& cluster, const T* a, const T* b,
                                                const Last& last, res_t* smem, int log_n, int lc,
                                                const ChannelTabs& tb, const Reduce& r) {
  const int log_n2 = (log_n + 1) / 2;
  const int log_n1 = log_n - log_n2;
  const int log_e = log_n - lc;
  const int log_cc = log_n2 - lc;
  const int E = 1 << log_e;
  const int K = pass_group(E);
  const int rank = (int)cluster.block_rank();
  res_t* const buf0 = smem;
  res_t* const buf1 = smem + padded(E);
  res_t* const buf2 = smem + 2 * padded(E);
  const ColMap map = cascade_colmap(log_n, lc, rank);
  const TilePolys<1> col0{{buf0}, 0};
  const TilePolys<1> col1{{buf1}, 0};
  const PeerRows<Cluster> rows_a{&cluster, buf2, map, log_e};
  const PeerRows<Cluster> rows_b{&cluster, buf0, map, log_e};

  // every CTA of the cluster runs before any DSMEM store: the arrival here,
  // the wait before the first store, so the column loads go on meanwhile
  cluster_arrive_relaxed();
  // 1. both operands' column stages but the last, together (their first
  // pass's loads in flight at once); a's last pass into the row blocks
  // (peers' buf2)
  if (log_n1 > K) {
    const TilePolys<2> cols{{buf0, buf1}, 0};
    forward_stages<2>(GlobalIn<T, 2, ColMap>{{a, b}, map}, cols, cols, 0, log_n1 - K, log_e, 0,
                      log_e, K, tb, r);
    __syncthreads();  // the relaxed arrival orders none of these stores
    cluster_wait();
    forward_stages<1>(col0, col0, rows_a, log_n1 - K, log_n1, log_e, 0, log_e, K, tb, r);
  } else {
    cluster_wait();
    forward_stages<1>(GlobalIn<T, 1, ColMap>{{a}, map}, col0, rows_a, 0, log_n1, log_e, 0, log_e,
                      K, tb, r);
  }
  // 2. b's last column pass, once every peer has read its buf0 (a's last
  // pass), into the row blocks' buf0
  cluster.sync();
  if (log_n1 > K) {
    forward_stages<1>(col1, col1, rows_b, log_n1 - K, log_n1, log_e, 0, log_e, K, tb, r);
  } else {
    forward_stages<1>(GlobalIn<T, 1, ColMap>{{b}, map}, col1, rows_b, 0, log_n1, log_e, 0, log_e,
                      K, tb, r);
  }
  cluster.sync();  // both operands' row blocks landed
  if constexpr (PHASES == 1) return;
  // 3. the row stages around the product, the last pass into the column
  // blocks (peers' buf1, which b's last column pass has read)
  const int x0 = rank << log_e;
  const TilePolys<2> ab{{buf2, buf0}, x0};
  const TilePolys<1> prod{{buf2}, x0};
  const PeerCols<Cluster> cols{&cluster, buf1, log_n2, log_cc};
  if (log_n2 <= K) {  // one pass: the row stages around the product, in registers
#define ONE(G) middle_span<G>(ab, cols, log_n, x0 >> G, (x0 + E) >> G, tb, r)
    PARENTT_DISPATCH_G(log_n2, ONE)
#undef ONE
  } else {
    forward_stages<2>(ab, ab, ab, log_n1, log_n - K, log_n, x0, log_e, K, tb, r);
    __syncthreads();
#define MIDDLE(G) middle_span<G>(ab, prod, log_n, x0 >> G, (x0 + E) >> G, tb, r)
    PARENTT_DISPATCH_G(K, MIDDLE)
#undef MIDDLE
    __syncthreads();
    inverse_stages(prod, prod, cols, K, log_n2, log_n, x0, log_e, K, tb, r);
  }
  cluster.sync();  // the product's column blocks landed; no DSMEM access follows
  if constexpr (PHASES == 2) return;
  // 4. the inverse column stages, the last pass to `last`
  inverse_stages(col1, col1, last, log_cc, log_e, log_e, 0, log_e, K, tb, r);
}

// The launch of a cluster cascade over `polys` (channel, row) pairs at
// 2^lc CTAs a cluster; `attr` must outlive the configuration.
inline cudaLaunchConfig_t cascade_config(int polys, int log_n, int lc, cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)polys << lc, 1, 1);
  cfg.blockDim = dim3((unsigned)cascade_fs_threads(log_n, lc), 1, 1);
  cfg.dynamicSmemBytes = (size_t)cascade_fs_smem(log_n, lc);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1u << lc;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Opt a cluster cascade kernel in to its shared memory and, for 16 CTAs,
// to a non-portable cluster size.
inline cudaError_t allow_cascade(const void* kernel, int log_n, int lc) {
  const long long bytes = cascade_fs_smem(log_n, lc);
  cudaError_t err = cudaSuccess;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  if (err == cudaSuccess && lc > kLogCascadeCluster) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return err;
}

// Launches the cluster cascade `kernel` with `params` over `polys` pairs at
// 2^lc CTAs a cluster on `stream`; returns cudaErrorInvalidValue for a
// cluster past n1 or 16 CTAs, else the CUDA error of an attribute call or
// the launch (a cluster the card cannot schedule comes back as the launch
// error).
inline int launch_cluster_cascade(const void* kernel, void** params, int polys, int log_n,
                                  int lc, cudaStream_t stream) {
  if (lc < 0 || lc > log_n - (log_n + 1) / 2 || lc > kLogCascadeCluster + 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = allow_cascade(kernel, log_n, lc);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cascade_config(polys, log_n, lc, stream, &attr);
  err = cudaLaunchKernelExC(&cfg, kernel, params);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Clusters of 2^lc CTAs of `kernel` the card holds at once at n = 2^log_n
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
inline int cascade_clusters(const void* kernel, int log_n, int lc) {
  cudaError_t err = allow_cascade(kernel, log_n, lc);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cascade_config(1, log_n, lc, nullptr, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

// --------------------------------------------------------------------------
// Alg-2 SAU decompose
// --------------------------------------------------------------------------

// Every channel's decompose circuit as the stacked (t,) device arrays of
// RnsPlan.dec_d (repro_torch.core.rns).
struct DecomposeTables {
  const i64* qs;       // (t,)
  const i64* beta;     // (t,) the SAU multiplier beta = sum(sign * 2^e) - 1
  const i64* sau_eps;  // (t,)
  const i64* sau_s2;   // (t,)
  const i64* horner;   // (t,) [beta^t']_q: the Horner step between blocks
  const i64* block_m;  // (t,) block-product Barrett constant
  int t;
  int s1;  // v - 1: the Barrett windows and the block Barrett
};

// One channel's circuit, as a block keeps it in shared memory: every
// constant but 1/q is below 2^32 and kept as a 32-bit word; 32 bytes, so
// a table of t channels is 16-byte aligned.
struct __align__(16) Decompose {
  double inv_q;  // 1 / q, for the compose's quotient estimate
  res_t q;
  res_t beta;
  res_t sau_eps;
  res_t block_m;
  res_t sau_s2;  // v1 + 4
  res_t horner;  // [beta^t']_q
};
static_assert(sizeof(Decompose) == 32, "the host sizes the table at 32 bytes a channel");

// Bytes of the table of t circuits (kernels/ntt.py decompose_table_bytes).
__host__ __device__ inline long long decompose_table_bytes(int t) {
  return (long long)t * sizeof(Decompose);
}

// Every channel's circuit in shared memory (t entries at `ch`), with the
// shift they share.
struct DecomposeShared {
  Decompose* ch;
  int t;
  int s1;
};

// Fill the table at `at` (decompose_table_bytes(a.t) bytes of shared
// memory, 16-byte aligned) from the device tables; the caller
// synchronises the block before reading it.
__device__ __forceinline__ DecomposeShared load_decompose(void* at, const DecomposeTables& a) {
  Decompose* ch = reinterpret_cast<Decompose*>(at);
  for (int c = threadIdx.x; c < a.t; c += blockDim.x) {
    Decompose& d = ch[c];
    d.q = (res_t)a.qs[c];
    d.inv_q = 1.0 / (double)a.qs[c];
    d.beta = (res_t)a.beta[c];
    d.sau_eps = (res_t)a.sau_eps[c];
    d.block_m = (res_t)a.block_m[c];
    d.sau_s2 = (res_t)a.sau_s2[c];
    d.horner = (res_t)a.horner[c];
  }
  return DecomposeShared{ch, a.t, a.s1};
}

// Barrett of a non-negative SAU word x < 2^c (repro_torch.core.modmath
// barrett_reduce): x >> s1 and eps lie below 2^32 there, so the quotient
// is one 32x32->64 product, and the remainder lies in [0, 4q).  NARROW
// (q < 2^30) keeps the remainder in 32 bits, exact since 4q < 2^32.
template <bool NARROW>
__device__ __forceinline__ i64 sau_barrett(i64 x, i64 q, i64 eps, int s1, int s2) {
  const res_t qhat = (res_t)(((u64)(res_t)(x >> s1) * (res_t)eps) >> s2);
  if (NARROW) {
    res_t r = (res_t)x - qhat * (res_t)q;
    r = cond_sub(r, (res_t)q);
    r = cond_sub(r, (res_t)q);
    return cond_sub(r, (res_t)q);
  }
  u64 r = (u64)x - (u64)qhat * (res_t)q;
  r = cond_sub64(r, q);
  r = cond_sub64(r, q);
  return (i64)cond_sub64(r, q);
}

// The SAU network z * beta, beta = sum(sign * 2^e) - 1 (Eq 5): its shifts
// and adds are exact in int64 arithmetic mod 2^64, and so is one product
// by beta (< 2^32), which the GPU issues as two multiply-adds.
__device__ __forceinline__ i64 sau(i64 x, const Decompose& d) {
  return (i64)((u64)x * (res_t)d.beta);
}

// Alg-2 residue of one coefficient's S base-2^v segments `z` (shared
// memory) mod d.q, in blocks of t' = kTPrime segments, each
// blk = Barrett(z0 + SAU(z1) + SAU(Barrett(SAU(z2)))) < q, taken by
// Horner from the most significant block down: acc = acc * [beta^t']_q +
// blk mod q, one v x v product (block Barrett) and one conditional
// subtraction a block, so acc stays canonical for any number of blocks
// and the circuit needs one constant past the SAU's.  The plain version
// sums blk * [beta^{t' rho}]_q mod q and reduces the sum; both give the
// canonical residue.
template <bool NARROW>
__device__ __forceinline__ i64 decompose(const i64* z, int S, const Decompose& d, int s1) {
  static_assert(kTPrime == 3, "the block body below is written for t' = 3");
  i64 acc = 0;
  for (int base = (S - 1) / kTPrime * kTPrime; base >= 0; base -= kTPrime) {
    i64 blk = z[base];
    if (base + 1 < S) blk += sau(z[base + 1], d);
    if (base + 2 < S) {
      const i64 x = sau_barrett<NARROW>(sau(z[base + 2], d), d.q, d.sau_eps, s1, d.sau_s2);
      blk += sau_barrett<NARROW>(sau(x, d), d.q, d.sau_eps, s1, d.sau_s2);
    }
    blk = sau_barrett<NARROW>(blk, d.q, d.sau_eps, s1, d.sau_s2);
    if (base + kTPrime < S) {
      blk += block_barrett<NARROW>((u64)(res_t)acc * d.horner, d.q, d.block_m, s1);
      blk = (i64)cond_sub64((u64)blk, d.q);
    }
    acc = blk;
  }
  return acc;
}

// --------------------------------------------------------------------------
// Eq-10 compose
// --------------------------------------------------------------------------

// Carry-normalise the limb sums of limbs l0 .. l0 + MAXL - 1: every limb
// below the top one (L - 1) back to [0, 2^w), the top one keeping the
// rest; returns the carry out of the chunk's last limb when that limb is
// not the top one (0 otherwise).  The value the sums stand for is kept.
template <int MAXL>
__device__ __forceinline__ i64 carry_normalize(i64 (&acc)[MAXL], int l0, int L, int w) {
  const i64 mask = (1LL << w) - 1;
  i64 carry = 0;
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    if (l0 + l < L - 1) {
      const i64 s = acc[l] + carry;
      acc[l] = s & mask;
      carry = s >> w;
    } else if (l0 + l == L - 1) {
      acc[l] += carry;
      carry = 0;
    }
  }
  return carry;
}

// Eq-10 limb sums of one coefficient over limbs l0 .. l0 + MAXL - 1 (those
// below L): acc[l] = sum_c y_c * q^_c[l0 + l] over the t channels, with
// y_c = finish(c, load(c)) = [p_c * q~_c]_{q_c} < 2^31 supplied by the
// caller in two steps (a word read, then any arithmetic on it), called
// for c = 0, 1, ..., t - 1 in order, and `star` the (t, L) limbs (< 2^28)
// of q^_c.  Channels run kSumChannels at a time (the loop over them
// unrolled; with PRELOAD the group's words are all read before its
// arithmetic, so the reads are in flight together, at the cost of
// kSumChannels registers), and between two groups the sums are
// carry-normalised (every limb below 2^w, the top one too: the partial
// value sum_c y_c q^_c < t q < 2^(wL)), so no sum passes 2^63.  Returns
// the carries the normalisations pushed out of the chunk's last limb (0
// when it holds limb L - 1), which belong to limb l0 + MAXL.  Limbs
// l0 + l >= L stay 0.  SINGLE: the caller guarantees t <= kSumChannels,
// so the group loop runs once as straight-line code.
template <int MAXL, bool PRELOAD, bool SINGLE, typename Load, typename Finish>
__device__ __forceinline__ i64 crt_limb_sums(i64 (&acc)[MAXL], const Load& load,
                                             const Finish& finish, const i64* __restrict__ star,
                                             int t, int L, int l0, int w) {
#pragma unroll
  for (int l = 0; l < MAXL; ++l) acc[l] = 0;
  i64 spill = 0;
  for (int c0 = 0; SINGLE ? c0 == 0 : c0 < t; c0 += kSumChannels) {
    res_t raw[kSumChannels];
    if (PRELOAD) {
#pragma unroll
      for (int k = 0; k < kSumChannels; ++k) raw[k] = c0 + k < t ? (res_t)load(c0 + k) : 0u;
    }
#pragma unroll
    for (int k = 0; k < kSumChannels; ++k) {
      if (c0 + k < t) {
        const int c = c0 + k;
        const res_t yc = (res_t)finish(c, PRELOAD ? raw[k] : (res_t)load(c));
        const res_t* sc = reinterpret_cast<const res_t*>(star + (size_t)c * L + l0);
#pragma unroll
        for (int l = 0; l < MAXL; ++l) {
          if (l0 + l < L) acc[l] += (i64)((u64)yc * __ldg(sc + 2 * l));
        }
      }
    }
    if (!SINGLE && c0 + kSumChannels < t) spill += carry_normalize(acc, l0, L, w);
  }
  return spill;
}

// The carry ripple of limbs l0 .. l0 + MAXL - 1 (those below L) that
// subtracts k q as it goes: each limb's low w bits to out[l0 + l], and
// the floor carry out of the chunk returned (past the top limb: -1 or 0).
template <int MAXL>
__device__ __forceinline__ i64 ripple_limbs(const i64 (&acc)[MAXL], int l0, int k,
                                            const int* __restrict__ ql, int L, int w, i64* out) {
  const i64 mask = (1LL << w) - 1;
  i64 carry = 0;
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    if (l0 + l < L) {
      const i64 s = acc[l] + carry - (i64)k * __ldg(ql + 2 * (l0 + l));
      out[l0 + l] = s & mask;
      carry = s >> w;
    }
  }
  return carry;
}

// The canonical limbs of value - k q, from limbs with `carry` (-1 or 0)
// left past the top one by the ripple that subtracted k q
// (crt_compose): value - k q lies in [-q, 2q), so one addition of q when
// the carry is negative (k one too large), or one subtraction of q when
// the limbs are still >= q (k one too small), leaves value mod q.  The
// limbs are in memory (the caller's stage), each in [0, 2^w).
__device__ __forceinline__ void correct_limbs(i64* limb, i64 carry, const int* __restrict__ ql,
                                              int L, int w) {
  const int mask = (1 << w) - 1;
  if (carry < 0) {
    int c = 0;
    for (int l = 0; l < L; ++l) {
      const int d = (int)limb[l] + __ldg(ql + 2 * l) + c;
      c = d >> w;
      limb[l] = d & mask;
    }
    return;
  }
  // limbs >= q: the highest limb that differs from q's decides (nearly
  // always the top one, so the scan stops there)
  int top = L - 1;
  while (top > 0 && (int)limb[top] == __ldg(ql + 2 * top)) --top;
  if ((int)limb[top] < __ldg(ql + 2 * top)) return;
  int borrow = 0;
  for (int l = 0; l < L; ++l) {
    const int d = (int)limb[l] - __ldg(ql + 2 * l) - borrow;
    borrow = d < 0;
    limb[l] = d < 0 ? d + (1 << w) : d;
  }
}

// The Eq-10 compose of one coefficient (K2, K6, K2-fs) into its L
// canonical base-2^w limbs at `out` (the caller's stage in shared memory):
// y_c = finish(c, load(c)) as crt_limb_sums takes it (each called once for
// each channel a chunk of MAXL limbs), inv_q(c) = 1 / q_c.  k = floor(sum_c y_c / q_c) in double
// precision, formed in the first chunk's channel pass, is floor(value / q)
// to within one: value / q = sum_c y_c / q_c exactly, each of the t fma
// steps rounds a sum below t by at most t 2^-53 and each 1/q_c is within
// 2^-53 of exact, so the estimate is within t (t + 1) 2^-53 of it, far
// below 1 for any t a plan can have.  Each chunk's limb sums then ripple
// into `out` subtracting k q as they go, the ripple's carry and the
// chunk's normalisation carries passed to the next chunk, and
// correct_limbs finishes: the limbs of value mod q, as the plain
// version's carry ripple and t - 1 conditional subtractions
// (kernels/crt.py compose_finalize) give them, with no loop of
// big-integer compare-and-subtract steps.  SINGLE: the caller guarantees
// L <= MAXL and t <= kSumChannels (one chunk, one channel group), so the
// compose runs as straight-line code, as K6's 8-limb instance does.
template <int MAXL, bool PRELOAD, bool SINGLE, typename Load, typename Finish, typename InvQ>
__device__ __forceinline__ void crt_compose(const Load& load, const Finish& finish,
                                            const InvQ& inv_q, const i64* __restrict__ star,
                                            const i64* __restrict__ q_limbs, int t, int L, int w,
                                            i64* out) {
  const int* ql = reinterpret_cast<const int*>(q_limbs);  // limb l: low word ql[2 l]
  double quotient = 0.0;                                   // sum_c y_c / q_c
  const auto finish_first = [&](int c, res_t raw) {
    const res_t v = (res_t)finish(c, raw);
    quotient = fma((double)v, inv_q(c), quotient);
    return v;
  };
  int k = 0;
  i64 carry = 0;  // into limb l0
  for (int l0 = 0; SINGLE ? l0 == 0 : l0 < L; l0 += MAXL) {
    i64 acc[MAXL];
    i64 spill;
    if (l0 == 0) {  // the first chunk's channel pass also forms k
      spill = crt_limb_sums<MAXL, PRELOAD, SINGLE>(acc, load, finish_first, star, t, L, 0, w);
      k = (int)quotient;
    } else {
      spill = crt_limb_sums<MAXL, PRELOAD, SINGLE>(acc, load, finish, star, t, L, l0, w);
    }
    acc[0] += carry;
    carry = spill + ripple_limbs(acc, l0, k, ql, L, w, out);
  }
  correct_limbs(out, carry, ql, L, w);  // carry: -1 or 0 past the top limb
}

// K6's compose kernel (compose.cu), also K2-fs's last launch: one thread a
// coefficient, a CTA of up to kComposeTile coefficients (compose_rows_of),
// the channels' constants in shared memory, crt_compose, the limbs staged
// in shared memory and written out as cnt * L contiguous int64 words.  Y:
// the input is K2-fs's 32-bit y = p q~ mod q (the cascade applied q~), so
// the products by q~ are not taken; else canonical int64 residues r and
// y = r q~ by the block Barrett.  compose.cu notes the design.
constexpr int kComposeTile = 256;  // coefficients of a CTA at most

struct ComposeArgs {
  const i64* res;      // (t, rows) canonical residues (not Y)
  const res_t* y;      // (t, rows) y words (Y)
  i64* out;
  const i64* qs;       // (t,)
  const i64* tilde;    // (t,): q~_c = (q / q_c)^-1 mod q_c (not Y)
  const i64* block_m;  // (t,): floor(2^(b+31) / q_c) (not Y)
  const i64* star;     // (t, L): limbs of q^_c = q / q_c
  const i64* q_limbs;  // (L,)
  i64 rows;
  int t;
  int L;
  int w;
  int s1;  // b - 1, b = bit_length(q_c), the same for every channel
};

// One channel's constants, as a CTA keeps them in shared memory.
struct __align__(8) ComposeChannel {
  double inv_q;
  res_t q;
  res_t m;
  res_t tilde;
};
static_assert(sizeof(ComposeChannel) == 24, "kernels/crt.py sizes the table at 24 bytes a channel");

// Bytes of the channel table, rounded to 16 for the stage after it, and
// the coefficients of a CTA (kernels/crt.py compose_rows mirrors both).
__host__ __device__ inline long long compose_table_bytes(int t) {
  return ((long long)t * sizeof(ComposeChannel) + 15) / 16 * 16;
}
__host__ __device__ inline int compose_rows_of(int t, int L) {
  return tile_rows(L, compose_table_bytes(t));
}

template <bool NARROW, int MAXL, int MIN_BLOCKS, bool Y>
__global__ void __launch_bounds__(kComposeTile, MIN_BLOCKS) compose_kernel(const ComposeArgs args) {
  // the 8-limb instance serves t <= kSumChannels, L <= 8 in one pass
  constexpr bool kSingle = MAXL == 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ComposeChannel* ch = reinterpret_cast<ComposeChannel*>(smem_raw);
  i64* stage = reinterpret_cast<i64*>(smem_raw + compose_table_bytes(args.t));  // (R, L) limbs
  const int t = args.t, L = args.L, R = blockDim.x;
  const i64 row0 = (i64)blockIdx.x * R;
  const int cnt = (int)min((i64)R, args.rows - row0);
  const int j = threadIdx.x;
  const auto word = [&](int c) {
    return Y ? __ldg(args.y + (size_t)c * args.rows + row0 + j)
             : (res_t)__ldg(args.res + (size_t)c * args.rows + row0 + j);
  };
  // kSingle: every channel's word read before the table fills, so the
  // reads overlap it (the channel index is compile-time in one pass)
  res_t first[kSingle ? kSumChannels : 1];
  if (kSingle) {
#pragma unroll
    for (int c = 0; c < kSumChannels; ++c) first[c] = c < t && j < cnt ? word(c) : 0u;
  }
  for (int c = threadIdx.x; c < t; c += R) {
    ch[c].inv_q = 1.0 / (double)args.qs[c];
    ch[c].q = (res_t)args.qs[c];
    if (!Y) {
      ch[c].m = (res_t)args.block_m[c];
      ch[c].tilde = (res_t)args.tilde[c];
    }
  }
  __syncthreads();
  if (j < cnt) {
    crt_compose<MAXL, !kSingle, kSingle>(
        [&](int c) { return kSingle ? first[c] : word(c); },
        [&](int c, res_t rc) {
          if (Y) return rc;
          const ComposeChannel& k = ch[c];
          return (res_t)block_barrett<NARROW>((u64)rc * k.tilde, k.q, k.m, args.s1);
        },
        [&](int c) { return ch[c].inv_q; }, args.star, args.q_limbs, t, L, args.w,
        stage + j * L);
  }
  __syncthreads();
  i64* po = args.out + row0 * L;
  for (int i = threadIdx.x; i < cnt * L; i += R) po[i] = stage[i];
}

// The limb chunk and CTAs an SM of a compose instance: 8 limbs (one
// straight-line pass) for t <= 15 and L <= 8, five CTAs; else 16-limb
// chunks, three CTAs for L <= 16 and two past it (compose.cu).
constexpr int kComposeMinBlocks = 5;
inline int compose_variant(int t, int L) { return L <= 8 && t <= kSumChannels ? 0 : L <= 16 ? 1 : 2; }

// --------------------------------------------------------------------------
// Cluster steps of the fused e2e kernel (K2)
// --------------------------------------------------------------------------
//
// A thread-block cluster of C CTAs shares a run of coefficients j (a
// row), and CTA `rank` takes the slice
// [ceil(rank m / C), ceil((rank + 1) m / C)) of the run's m coefficients.
// Channel c lives on CTA c % C as slot c / C: its two residue
// polynomials at res + slot * 2 * PS (a, then b at + PS), element j at
// pad(j); after the cascade y(c) sits at res + slot * slot_stride + pad(j)
// (where a was).  `Cluster` is
// cooperative_groups' cluster_group.

// y = canonical(p) * q~ mod q: what the cascade's last inverse pass
// stores for the compose.
struct TildeProduct {
  res_t tilde;
  __device__ __forceinline__ res_t operator()(res_t x, const Reduce& r) const {
    return mul_mod(canonicalize(x, r), tilde, r);
  }
};

// Decompose the slice [j0, j1) of both operands into every channel, each
// residue stored in its owner's shared memory over DSMEM.  A chunk of dc
// coefficients an operand at a time (dc <= blockDim / 2, as the staging
// holds them): stage_in(sa, sb, jc, cnt), run by the whole block, leaves
// the S segments of coefficients jc .. jc + cnt - 1 of operand a at sa and
// of b at sb; then dc threads decompose a, dc threads b.  The caller
// synchronises the cluster before (every peer runs) and after (every
// residue landed).
template <bool NARROW, typename Cluster, typename StageIn>
__device__ __forceinline__ void cluster_decompose(Cluster& cluster, res_t* res, int PS, int C,
                                                  int t, int S, int j0, int j1, int dc,
                                                  i64* stage, const DecomposeShared& dsh,
                                                  const StageIn& stage_in) {
  const int op = threadIdx.x / dc;  // 0: a, 1: b, past them idle
  const int jj = threadIdx.x - op * dc;
  for (int jc = j0; jc < j1; jc += dc) {
    const int cnt = min(dc, j1 - jc);
    stage_in(stage, stage + dc * S, jc, cnt);
    __syncthreads();
    if (op < 2 && jj < cnt) {
      const i64* z = stage + (op * dc + jj) * S;
      const int at = (op * PS) + pad(jc + jj);
      int owner = 0, slot = 0;
      for (int c = 0; c < t; ++c) {
        const i64 x = decompose<NARROW>(z, S, dsh.ch[c], dsh.s1);
        cluster.map_shared_rank(res, owner)[slot * 2 * PS + at] = (res_t)x;
        if (++owner == C) owner = 0, ++slot;
      }
    }
    __syncthreads();
  }
}

// The Eq-10 compose (crt_compose) over the peers' y for the slice
// [j0, j1), a chunk of cc coefficients (cc <= blockDim) at a time, each
// chunk's (cc, L) limbs staged in `stage`; store_out(stage, jc, cnt), run
// by the whole block, writes a chunk's limbs out.  The caller
// synchronises the cluster before (every y stored) and after (the peers
// have read this CTA's y before it exits).
template <int MAXL, typename Cluster, typename StoreOut>
__device__ __forceinline__ void cluster_compose(Cluster& cluster, res_t* res, int slot_stride,
                                                int C, int t, int L, int w, int j0, int j1,
                                                int cc, const i64* __restrict__ star,
                                                const i64* __restrict__ q_limbs, i64* stage,
                                                const DecomposeShared& dsh,
                                                const StoreOut& store_out) {
  for (int jc = j0; jc < j1; jc += cc) {
    const int cnt = min(cc, j1 - jc);
    const int j = threadIdx.x;
    if (j < cnt) {
      const int at = pad(jc + j);
      int owner = 0, off = at;  // channel c sits on CTA c % C at slot c / C
      crt_compose<MAXL, false, false>(
          [&](int c) {
            if (c == 0) owner = 0, off = at;
            const res_t y = cluster.map_shared_rank(res, owner)[off];
            if (++owner == C) owner = 0, off += slot_stride;
            return y;
          },
          [](int, res_t y) { return y; }, [&](int c) { return dsh.ch[c].inv_q; }, star, q_limbs,
          t, L, w, stage + j * L);
    }
    __syncthreads();
    store_out(stage, jc, cnt);
    __syncthreads();
  }
}

// --------------------------------------------------------------------------
// launch helpers
// --------------------------------------------------------------------------

// Issue the copy of `words` int64 from device memory to shared memory with
// the whole block, through cp.async: 16-byte copies where source and
// destination share 16-byte alignment, 8-byte copies otherwise.
// Consecutive threads take consecutive words, so every request coalesces.
// The copies are committed as one group of this thread's: wait_staged(k)
// returns once all but the k most recent groups have landed.
__device__ __forceinline__ void stage_words_async(i64* dst, const i64* src, int words) {
  const unsigned sdst = (unsigned)__cvta_generic_to_shared(dst);
  if (((reinterpret_cast<uintptr_t>(src) | sdst) & 15) == 0) {
    for (int i = threadIdx.x; i < words >> 1; i += blockDim.x) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(sdst + 16 * i),
                   "l"(src + 2 * i)
                   : "memory");
    }
    if ((words & 1) && threadIdx.x == 0) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sdst + 8 * (words - 1)),
                   "l"(src + words - 1)
                   : "memory");
    }
  } else {
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(sdst + 8 * i),
                   "l"(src + i)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wait_staged() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// stage_words_async and wait until this thread's copies have landed; the
// caller synchronises the block.
__device__ __forceinline__ void stage_words(i64* dst, const i64* src, int words) {
  stage_words_async(dst, src, words);
  wait_staged<0>();
}

// Arguments of the single-transform stage kernels (ntt_channels.cu, K3,
// and intt_channels.cu, K4, both on the register passes over one padded
// polynomial): (t, rows, n) residues in and out, channel tables (t, n) of
// one direction with their Shoup constants.
struct StageArgs {
  const i64* in;
  i64* out;
  const i64* qs;
  const i64* half;
  const i64* eps;
  const i64* tab;
  const i64* tab_sh;
  int rows;
  int log_n;
  int mode;
  int window;
  int beta;
  int s1;
  int s2;
};

// --------------------------------------------------------------------------
// The one-CTA cascade launch (K1, and K2-fs's cascade where one CTA holds a
// channel's pair)
// --------------------------------------------------------------------------

// Where the one-CTA cascade reads a (channel, row) pair and stores its
// product: int64 residues in and canonical int64 out (K1), or 32-bit words
// in and y = canonical(p) * q~ mod q over the first operand's words
// (K2-fs, FsArgs.scratch).
struct CanonPair {
  __device__ __forceinline__ static DevicePolys<2> in(const FsArgs& a, size_t base) {
    return DevicePolys<2>{{a.in[0] + base, a.in[1] + base}};
  }
  __device__ __forceinline__ static DeviceOut out(const FsArgs& a, size_t base, const i64*, int) {
    return DeviceOut{a.out + base};
  }
};
struct TildePair {
  __device__ __forceinline__ static GlobalIn<res_t, 2, RowMap> in(const FsArgs& a, size_t base) {
    return GlobalIn<res_t, 2, RowMap>{{a.scratch[0] + base, a.scratch[1] + base}, {}};
  }
  __device__ __forceinline__ static TildeOut<RowMap> out(const FsArgs& a, size_t base,
                                                         const i64* tilde, int c) {
    return TildeOut<RowMap>{a.scratch[0] + base, RowMap{}, (res_t)tilde[c]};
  }
};

// CTAs of kMaxThreads an SM that the register budget leaves room for
// (twice as many of the 256 threads at n = 4096): at most 64 registers,
// which no instance spills at; three would cap them at 40, where the lazy
// W = 4 and strict instances spill.
constexpr int kPairMinBlocks = 2;

// One CTA per (channel, row) pair of `Pair`'s words (fused_polymul.cu has
// the design); `tilde`: the channels' q~ (TildePair).
template <int REG, typename Pair>
__global__ void __launch_bounds__(kMaxThreads, kPairMinBlocks)
    pair_cascade_kernel(const FsArgs a, const i64* tilde) {
  extern __shared__ res_t smem[];
  const int n = 1 << a.log_n;
  const int c = blockIdx.x / a.rows;
  const size_t base = (size_t)blockIdx.x * n;
  channel_cascade(smem, smem + padded(n), Pair::in(a, base), Pair::out(a, base, tilde, c),
                  Keep{}, a.log_n, pass_group(n), fs_tabs(a, c), fs_reduce<REG>(a, c));
}

typedef void (*PairKernel)(const FsArgs, const i64*);

template <typename Pair>
inline PairKernel pair_kernel(int mode, int window) {
  static const PairKernel kernels[3] = {pair_cascade_kernel<kLazy2, Pair>,
                                        pair_cascade_kernel<kLazy4, Pair>,
                                        pair_cascade_kernel<kStrict, Pair>};
  return kernels[regime_of(mode, window)];
}

// A one-CTA cascade's shared memory, both operands' padded residues, and
// whether one block holds it (kernels/ntt.py cascade_smem_bytes,
// cascade_fits).
inline size_t pair_smem(int log_n) { return 2 * (size_t)padded(1 << log_n) * sizeof(res_t); }
inline bool pair_fits(int log_n) { return (long long)pair_smem(log_n) <= kMaxSmem; }

// Launches the one-CTA cascade of `Pair` over `polys` pairs on `stream`;
// returns the CUDA error of the attribute call or the launch.
template <typename Pair>
inline int launch_pair_cascade(const FsArgs& a, const i64* tilde, int polys,
                               cudaStream_t stream) {
  const PairKernel kernel = pair_kernel<Pair>(a.mode, a.window);
  const size_t smem = pair_smem(a.log_n);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<polys, pass_threads(1 << a.log_n), smem, stream>>>(a, tilde);
  return (int)cudaGetLastError();
}

// How many CTAs of `Pair`'s one-CTA cascade an SM holds at once at
// n = 2^log_n and this regime (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// or minus the CUDA error.
template <typename Pair>
inline int pair_blocks_per_sm(int log_n, int mode, int window) {
  const PairKernel kernel = pair_kernel<Pair>(mode, window);
  const size_t smem = pair_smem(log_n);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, pass_threads(1 << log_n),
                                                      smem);
  return err == cudaSuccess ? count : -(int)err;
}

}  // namespace parentt
