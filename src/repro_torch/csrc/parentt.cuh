// Device functions shared by the port's kernels: the fused cascade
// (fused_polymul.cu), the fused end-to-end multiplier
// (fused_e2e_polymul.cu) and the stage kernels (ntt_channels.cu,
// intt_channels.cu, decompose.cu, compose.cu), among them the register
// passes of the transforms that K1-K4 run and the Eq-10 compose tail that
// K2 and K6 run.
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
// * The decompose block products [blk * beta^{t' rho}]_q and the compose
//   products y = r * q~ mod q (K6), below q^2, use the Barrett of
//   block_barrett (m = floor(2^(b+31) / q)), exact for every x < 2^(2b)
//   with b = bit_length(q) <= 31.
// * The Eq-10 limb sums are 64-bit; each term is a 32x32->64 product
//   (y < q < 2^31, limb < 2^28) and each sum stays below t * 2^59.
//
// No register array is indexed by a runtime count: the limb loops unroll
// to a compile-time MAXL with predication.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace parentt {

typedef long long i64;
typedef uint32_t res_t;
typedef uint64_t u64;

// Upper limits the Python wrappers check before a launch.
constexpr int kMaxSegments = 16;
constexpr int kMaxLimbs = 16;
constexpr int kMaxChannels = 16;
constexpr int kTPrime = 3;     // Alg-2 block width t' of every plan
constexpr int kMaxBlocks = 6;  // Alg-2 blocks: ceil(kMaxSegments / t')
constexpr int kMaxThreads = 512;

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
template <int G, int NPOLY, typename In, typename Out>
__device__ __forceinline__ void forward_span(const In& in, const Out& out, int s0, int log_n,
                                             int p0, int p1, const ChannelTabs& tb,
                                             const Reduce& r) {
  const int log_st = log_n - s0 - G;
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
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
template <int G, typename In, typename Out, typename Finish>
__device__ __forceinline__ void inverse_span(const In& in, const Out& out, int s0, int log_n,
                                             int p0, int p1, const Finish& finish,
                                             const ChannelTabs& tb, const Reduce& r) {
  for (int p = p0 + threadIdx.x; p < p1; p += blockDim.x) {
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
// Multi-block (four-step) transforms (K1-fs, K3-fs, K4-fs)
// --------------------------------------------------------------------------
//
// A polynomial too long for one CTA's shared memory is the same radix-2
// flow graph viewed as an (n1, n2) tile, element x = r n2 + c, with
// n2 = 2^ceil(L/2), n1 = n / n2 (L = log2 n; kernels/ntt.py fs_split).
// Each launch's CTAs take kFsTile = 4096 elements (E = min(n, 4096)):
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
// Between launches the values stay lazy (below W q, or q when strict) as
// 32-bit words in a (t, rows, n) scratch tensor: a butterfly's window
// does not depend on its stage, so the row stages continue from the
// column stages' bounds.  Each launch's first pass reads device memory,
// its last writes it, and the passes between run through the CTA's tile
// in shared memory (padded one word in 16 against bank conflicts).

constexpr int kLogFsTile = 12;
constexpr int kFsThreads = 256;  // pass_threads(kFsTile)
static_assert(kLogFsTile <= 12, "kFsThreads holds pass_threads of a tile");

// Where a CTA of a multi-block launch sits: its polynomial, channel and
// tile, and the split.
struct FsGeom {
  int log_n, log_n1, log_n2, log_e, log_c;  // log E, log C (columns a column CTA)
  int c;                                    // channel
  size_t poly;                              // offset of the (channel, row) polynomial
  int blk;                                  // tile of the polynomial
};

__device__ __forceinline__ FsGeom fs_geom(int log_n, int rows) {
  FsGeom g;
  g.log_n = log_n;
  g.log_n2 = (log_n + 1) / 2;
  g.log_n1 = log_n - g.log_n2;
  g.log_e = log_n < kLogFsTile ? log_n : kLogFsTile;
  g.log_c = g.log_e - g.log_n1;
  const int tiles_log = log_n - g.log_e;
  const int poly = blockIdx.x >> tiles_log;
  g.blk = blockIdx.x & ((1 << tiles_log) - 1);
  g.c = poly / rows;
  g.poly = (size_t)poly << log_n;
  return g;
}

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
// the scratch is read as plain loads: the cascade's row pass rewrites what it read
__device__ __forceinline__ res_t read_word(const res_t* p) { return *p; }

// NPOLY polynomials in device memory (int64 residues, or 32-bit scratch).
template <typename T, int NPOLY, typename Map>
struct GlobalIn {
  const T* poly[NPOLY];
  Map map;
  __device__ __forceinline__ res_t load(int k, int i) const { return read_word(poly[k] + map(i)); }
};

// NPOLY 32-bit scratch polynomials: lazy values stored as they are.
template <int NPOLY, typename Map>
struct ScratchOut {
  res_t* poly[NPOLY];
  Map map;
  __device__ __forceinline__ void store(int k, int i, res_t x, const Reduce&) const {
    poly[k][map(i)] = x;
  }
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
// No barrier follows the last pass.
template <int NPOLY, typename In, typename Tile, typename Out>
__device__ __forceinline__ void forward_stages(const In& in, const Tile& tile, const Out& out,
                                               int s_begin, int s_end, int log_n, int x0,
                                               int log_span, int K, const ChannelTabs& tb,
                                               const Reduce& r) {
  const int passes = (s_end - s_begin + K - 1) / K;
  const int g0 = s_end - s_begin - K * (passes - 1);
  int s0 = s_begin;
  for (int q = 0; q < passes; ++q) {
    const int G = q == 0 ? g0 : K;
    const int p0 = x0 >> G, p1 = (x0 + (1 << log_span)) >> G;
    if (passes == 1) {
#define ONE(G) forward_span<G, NPOLY>(in, out, s0, log_n, p0, p1, tb, r)
      PARENTT_DISPATCH_G(G, ONE)
#undef ONE
    } else if (q == 0) {
#define FIRST(G) forward_span<G, NPOLY>(in, tile, s0, log_n, p0, p1, tb, r)
      PARENTT_DISPATCH_G(G, FIRST)
#undef FIRST
    } else if (q + 1 < passes) {
#define MID(G) forward_span<G, NPOLY>(tile, tile, s0, log_n, p0, p1, tb, r)
      PARENTT_DISPATCH_G(G, MID)
#undef MID
    } else {
#define LAST(G) forward_span<G, NPOLY>(tile, out, s0, log_n, p0, p1, tb, r)
      PARENTT_DISPATCH_G(G, LAST)
#undef LAST
    }
    if (q + 1 < passes) __syncthreads();
    s0 += G;
  }
}

// Inverse stages u_begin .. u_end - 1 (stride 2^u) likewise, in passes of K
// stages and a last of g0; the last pass stores each value through `finish`.
template <typename In, typename Tile, typename Out>
__device__ __forceinline__ void inverse_stages(const In& in, const Tile& tile, const Out& out,
                                               int u_begin, int u_end, int log_n, int x0,
                                               int log_span, int K, const ChannelTabs& tb,
                                               const Reduce& r) {
  const int passes = (u_end - u_begin + K - 1) / K;
  const int g0 = u_end - u_begin - K * (passes - 1);
  int s0 = u_begin;
  for (int q = 0; q < passes; ++q) {
    const int G = q + 1 < passes ? K : g0;
    const int p0 = x0 >> G, p1 = (x0 + (1 << log_span)) >> G;
    if (passes == 1) {
#define ONE(G) inverse_span<G>(in, out, s0, log_n, p0, p1, Keep{}, tb, r)
      PARENTT_DISPATCH_G(G, ONE)
#undef ONE
    } else if (q == 0) {
#define FIRST(G) inverse_span<G>(in, tile, s0, log_n, p0, p1, Keep{}, tb, r)
      PARENTT_DISPATCH_G(G, FIRST)
#undef FIRST
    } else if (q + 1 < passes) {
#define MID(G) inverse_span<G>(tile, tile, s0, log_n, p0, p1, Keep{}, tb, r)
      PARENTT_DISPATCH_G(G, MID)
#undef MID
    } else {
#define LAST(G) inverse_span<G>(tile, out, s0, log_n, p0, p1, Keep{}, tb, r)
      PARENTT_DISPATCH_G(G, LAST)
#undef LAST
    }
    if (q + 1 < passes) __syncthreads();
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

// Forward column stages: NPOLY int64 operands -> 32-bit scratch.
template <int REG, int NPOLY>
__device__ __forceinline__ void fs_cols_forward(const FsArgs& a, res_t* smem) {
  const FsGeom g = fs_geom(a.log_n, a.rows);
  const Reduce r = fs_reduce<REG>(a, g.c);
  const ColMap map{g.log_c, g.log_n2, g.blk << g.log_c};
  const int E = 1 << g.log_e;
  GlobalIn<i64, NPOLY, ColMap> in{{}, map};
  ScratchOut<NPOLY, ColMap> out{{}, map};
  TilePolys<NPOLY> tile{{}, 0};
  for (int k = 0; k < NPOLY; ++k) {
    in.poly[k] = a.in[k] + g.poly;
    out.poly[k] = a.scratch[k] + g.poly;
    tile.poly[k] = smem + k * padded(E);
  }
  forward_stages<NPOLY>(in, tile, out, 0, g.log_n1, g.log_e, 0, g.log_e, pass_group(E),
                        fs_tabs(a, g.c), r);
}

// Inverse column stages: 32-bit scratch -> canonical int64 output.
template <int REG>
__device__ __forceinline__ void fs_cols_inverse(const FsArgs& a, res_t* smem) {
  const FsGeom g = fs_geom(a.log_n, a.rows);
  const Reduce r = fs_reduce<REG>(a, g.c);
  const ColMap map{g.log_c, g.log_n2, g.blk << g.log_c};
  const int E = 1 << g.log_e;
  const GlobalIn<res_t, 1, ColMap> in{{a.scratch[0] + g.poly}, map};
  const CanonOut<ColMap> out{a.out + g.poly, map};
  const TilePolys<1> tile{{smem}, 0};
  inverse_stages(in, tile, out, g.log_c, g.log_e, g.log_e, 0, g.log_e, pass_group(E),
                 fs_tabs(a, g.c), r);
}

// Kernel launch geometry shared by the host entry points: CTAs of one
// multi-block launch over t x rows polynomials, and its threads.
inline int fs_blocks(int t, int rows, int log_n) {
  const int log_e = log_n < kLogFsTile ? log_n : kLogFsTile;
  return t * rows << (log_n - log_e);
}
inline int fs_threads(int log_n) {
  return pass_threads(1 << (log_n < kLogFsTile ? log_n : kLogFsTile));
}
// Shared memory of a launch that holds NPOLY tiles.
inline size_t fs_smem(int log_n, int npoly) {
  return (size_t)npoly * padded(1 << (log_n < kLogFsTile ? log_n : kLogFsTile)) * sizeof(res_t);
}

// --------------------------------------------------------------------------
// Alg-2 SAU decompose
// --------------------------------------------------------------------------

// Every channel's decompose circuit as the stacked (t,) device arrays of
// RnsPlan.dec_d (repro_torch.core.rns).
struct DecomposeTables {
  const i64* qs;            // (t,)
  const i64* beta;          // (t,) the SAU multiplier beta = sum(sign * 2^e) - 1
  const i64* sau_eps;       // (t,)
  const i64* sau_s2;        // (t,)
  const i64* acc_eps;       // (t,)
  const i64* block_m;       // (t,) block-product Barrett constant
  const i64* block_consts;  // (t, n_blocks)
  int t;
  int n_blocks;
  int s1;      // v - 1
  int acc_s2;  // 4
};

// One channel's circuit, as a block keeps it in shared memory.
// Every constant but 1/q is below 2^32 and kept as a 32-bit word; the
// struct is 16-byte aligned for vector loads.
struct __align__(16) Decompose {
  double inv_q;  // 1 / q, for the compose's quotient estimate
  res_t q;
  res_t beta;
  res_t sau_eps;
  res_t acc_eps;
  res_t block_m;
  res_t sau_s2;                    // v1 + 4
  res_t block_consts[kMaxBlocks];  // [beta^{t' rho}]_q
};

// Every channel's circuit in shared memory, with the shifts they share.
struct DecomposeShared {
  Decompose ch[kMaxChannels];
  int t;
  int s1;      // v - 1: both Barrett windows and the block Barrett
  int acc_s2;  // 4
};

// Fill `sh` from the device tables (the caller synchronises the block).
__device__ __forceinline__ void load_decompose(DecomposeShared& sh, const DecomposeTables& a) {
  for (int c = threadIdx.x; c < a.t; c += blockDim.x) {
    Decompose& d = sh.ch[c];
    d.q = (res_t)a.qs[c];
    d.inv_q = 1.0 / (double)a.qs[c];
    d.beta = (res_t)a.beta[c];
    d.sau_eps = (res_t)a.sau_eps[c];
    d.acc_eps = (res_t)a.acc_eps[c];
    d.block_m = (res_t)a.block_m[c];
    d.sau_s2 = (res_t)a.sau_s2[c];
    for (int k = 0; k < kMaxBlocks; ++k) {
      d.block_consts[k] =
          k < a.n_blocks ? (res_t)a.block_consts[(size_t)c * a.n_blocks + k] : 0;
    }
  }
  if (threadIdx.x == 0) {
    sh.t = a.t;
    sh.s1 = a.s1;
    sh.acc_s2 = a.acc_s2;
  }
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
// memory) mod d.q, in blocks of t' = kTPrime segments: z0 + SAU(z1) +
// SAU(Barrett(SAU(z2))), one v x v product per later block, and a last
// Barrett of the accumulator.
template <bool NARROW>
__device__ __forceinline__ i64 decompose(const i64* z, int S, const Decompose& d,
                                         const DecomposeShared& sh) {
  static_assert(kTPrime == 3, "the block body below is written for t' = 3");
  i64 acc = 0;
#pragma unroll
  for (int rho = 0; rho < kMaxBlocks; ++rho) {
    const int base = rho * kTPrime;
    if (base < S) {
      i64 blk = z[base];
      if (base + 1 < S) blk += sau(z[base + 1], d);
      if (base + 2 < S) {
        const i64 x = sau_barrett<NARROW>(sau(z[base + 2], d), d.q, d.sau_eps, sh.s1, d.sau_s2);
        blk += sau_barrett<NARROW>(sau(x, d), d.q, d.sau_eps, sh.s1, d.sau_s2);
      }
      blk = sau_barrett<NARROW>(blk, d.q, d.sau_eps, sh.s1, d.sau_s2);
      acc += rho == 0 ? blk
                      : block_barrett<NARROW>((u64)(res_t)blk * (res_t)d.block_consts[rho], d.q,
                                              d.block_m, sh.s1);
    }
  }
  return sau_barrett<NARROW>(acc, d.q, d.acc_eps, sh.s1, sh.acc_s2);
}

// --------------------------------------------------------------------------
// Eq-10 compose
// --------------------------------------------------------------------------

// Eq-10 limb sums of one coefficient: acc[l] = sum_c y(c) * q^_c[l] over
// the t channels, with y(c) = [p_c * q~_c]_{q_c} < 2^31 supplied by the
// caller in channel order and `star` the (t, L) limbs (< 2^28) of q^_c.
// Both loops unroll (channels to kMaxChannels, limbs to MAXL, predicated),
// so the t values y(c) can be in flight together.  Limbs l >= L stay 0.
template <int MAXL, typename Y>
__device__ __forceinline__ void crt_limb_sums(i64 (&acc)[MAXL], Y y, const i64* __restrict__ star,
                                              int t, int L) {
#pragma unroll
  for (int l = 0; l < MAXL; ++l) acc[l] = 0;
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    if (c < t) {
      const res_t yc = (res_t)y(c);
      const res_t* sc = reinterpret_cast<const res_t*>(star + (size_t)c * L);
#pragma unroll
      for (int l = 0; l < MAXL; ++l) {
        if (l < L) acc[l] += (i64)((u64)yc * __ldg(sc + 2 * l));
      }
    }
  }
}

// The Eq-10 tail on one coefficient (K2, K6): raw limb sums -> canonical
// base-2^w limbs of the composed value mod q, for a caller that knows
// k = floor(value / q) to within one: here k = floor(sum_c y_c / q_c) in
// double precision (the exact quotient, since value / q = sum_c y_c / q_c,
// up to a rounding error far below 1).  The carry ripple subtracts k q as
// it goes; the result lies in [-q, 2q), and one conditional addition or
// subtraction of q makes it canonical: the limbs of value mod q, as the
// plain version's carry ripple and t - 1 conditional subtractions
// (kernels/crt.py compose_finalize) give them.
template <int MAXL>
__device__ __forceinline__ void compose_finalize_quotient(i64 (&acc)[MAXL], int k,
                                                          const i64* __restrict__ q_limbs, int L,
                                                          int w) {
  const i64 mask = (1LL << w) - 1;
  const int* ql = reinterpret_cast<const int*>(q_limbs);  // limb l: low word ql[2 l]
  int limb[MAXL];
  i64 carry = 0;
#pragma unroll
  for (int l = 0; l < MAXL; ++l) {
    limb[l] = 0;
    if (l < L) {
      const i64 s = acc[l] + carry - (i64)k * __ldg(ql + 2 * l);
      limb[l] = (int)(s & mask);
      carry = s >> w;  // floor: -1 or 0 past the top limb
    }
  }
  if (carry < 0) {  // k was one too large
    int c = 0;
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
      if (l < L) {
        const int d = limb[l] + __ldg(ql + 2 * l) + c;
        c = d >> w;
        limb[l] = d & (int)mask;
      }
    }
  } else {  // k was one too small when the rest is still >= q
    bool ge = true;
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
      if (l < L) {
        const int q = __ldg(ql + 2 * l);
        if (limb[l] != q) ge = limb[l] > q;
      }
    }
    if (ge) {
      int borrow = 0;
#pragma unroll
      for (int l = 0; l < MAXL; ++l) {
        if (l < L) {
          const int d = limb[l] - __ldg(ql + 2 * l) - borrow;
          borrow = d < 0;
          limb[l] = d < 0 ? d + (1 << w) : d;
        }
      }
    }
  }
#pragma unroll
  for (int l = 0; l < MAXL; ++l) acc[l] = limb[l];
}

// --------------------------------------------------------------------------
// launch helpers
// --------------------------------------------------------------------------

// Copy `words` int64 from device memory to shared memory with the whole
// block, through cp.async: 16-byte copies where source and destination
// share 16-byte alignment, 8-byte copies otherwise.  Consecutive threads
// take consecutive words, so every request coalesces.  Returns when this
// thread's copies have landed; the caller synchronises the block.
__device__ __forceinline__ void stage_words(i64* dst, const i64* src, int words) {
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
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

// Opt a kernel in to dynamic shared memory above the 48 KB default.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace parentt
