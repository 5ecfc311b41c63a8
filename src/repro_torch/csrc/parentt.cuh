// Device functions shared by the fused cascade kernel (fused_polymul.cu)
// and the fused end-to-end kernel (fused_e2e_polymul.cu).
//
// Every function repeats, operation for operation, the int64 arithmetic of
// the plain PyTorch versions (repro_torch/core/modmath.py,
// repro_torch/kernels/crt.py, repro_torch/kernels/ntt.py), so kernel and
// plain version agree bit for bit.  All arithmetic is signed 64-bit
// (`long long`), as torch's int64: the SAU network starts from -x and the
// Barrett quotient uses an arithmetic shift.  Worst cases stay inside 63
// bits: Shoup products v*w' < 2^63 (v = 30: v < 2q < 2^31, w' < 2^32),
// Barrett (x >> (b-1)) * eps < 2^62, SAU words < 2^59, the Eq-10 limb sums
// < t * 2^59.
//
// Residues live in shared memory as 32-bit words: every value a
// butterfly stores is below window*q < 2^31 (lazy, b <= 30) or below
// q < 2^31 (strict, b = 31), so uint32 storage is exact and halves the
// working set against int64.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace parentt {

typedef long long i64;
typedef uint32_t res_t;

// Upper limits of the per-coefficient register arrays; the Python
// wrappers refuse configurations above them.
constexpr int kMaxSegments = 16;
constexpr int kMaxLimbs = 16;
constexpr int kMaxThreads = 512;

// Reduction regime of a table set (repro_torch.kernels.ntt.reduction_mode).
enum Mode : int {
  kLazy = 0,     // Harvey lazy butterflies (Shoup twiddles), Barrett products
  kBarrett = 1,  // strict butterflies, Barrett products
  kRem = 2,      // strict butterflies, generic % (q of 31 bits)
};

// One channel's butterfly and product reduction constants.
struct Reduce {
  i64 q;
  i64 half;  // (q + 1) / 2
  i64 eps;   // Barrett eps of the residue products (unused under kRem)
  int s1, s2;
  int mode;
  int window;  // lazy window: values stay in [0, window * q)
  int beta;    // Shoup shift
};

// One channel's Alg-2 SAU decompose circuit (repro_torch.core.rns.dec_arrays).
struct Decompose {
  i64 q;
  i64 sau_eps;
  i64 acc_eps;
  int s1;      // v - 1, shared by both Barrett windows
  int sau_s2;  // v1 + 4
  int acc_s2;  // 4
  int n_terms;
  const i64* beta_e;        // (n_terms,) shift of each signed power of two
  const i64* beta_s;        // (n_terms,) its sign, 0 on padding
  const i64* block_consts;  // (n_blocks,) [beta^{t' rho}]_q
};

__device__ __forceinline__ i64 cond_sub(i64 x, i64 m) { return x >= m ? x - m : x; }

__device__ __forceinline__ i64 add_mod(i64 x, i64 y, i64 q) {
  const i64 s = x + y;
  return s >= q ? s - q : s;
}

__device__ __forceinline__ i64 sub_mod(i64 x, i64 y, i64 q) {
  const i64 d = x - y;
  return d < 0 ? d + q : d;
}

// x * 2^-1 mod q (Eq 24).
__device__ __forceinline__ i64 div2_mod(i64 x, i64 half) { return (x >> 1) + (x & 1) * half; }

__device__ __forceinline__ i64 barrett_reduce(i64 x, i64 q, i64 eps, int s1, int s2) {
  const i64 qhat = ((x >> s1) * eps) >> s2;
  i64 r = x - qhat * q;
  r = cond_sub(r, q);
  r = cond_sub(r, q);
  return cond_sub(r, q);
}

__device__ __forceinline__ i64 mul_mod(i64 x, i64 y, const Reduce& r) {
  const i64 p = x * y;
  if (r.mode == kRem) return p % r.q;
  return barrett_reduce(p, r.q, r.eps, r.s1, r.s2);
}

// v * w mod q up to one extra q: [0, 2q), no conditional subtraction.
__device__ __forceinline__ i64 shoup_mul(i64 v, i64 w, i64 ws, i64 q, int beta) {
  return v * w - ((v * ws) >> beta) * q;
}

__device__ __forceinline__ void ct_butterfly(i64& u, i64& v, i64 w, i64 ws, const Reduce& r) {
  if (r.mode == kLazy) {
    const i64 t = shoup_mul(v, w, ws, r.q, r.beta);
    const i64 q2 = 2 * r.q;
    if (r.window == 4) {
      const i64 uu = cond_sub(u, q2);
      u = uu + t;
      v = uu - t + q2;
    } else {
      const i64 x = cond_sub(u + t, q2);
      v = cond_sub(u - t + q2, q2);
      u = x;
    }
  } else {
    const i64 p = mul_mod(v, w, r);
    const i64 x = add_mod(u, p, r.q);
    v = sub_mod(u, p, r.q);
    u = x;
  }
}

__device__ __forceinline__ void gs_butterfly(i64& u, i64& v, i64 w, i64 ws, const Reduce& r) {
  if (r.mode == kLazy) {
    const i64 wq = r.window * r.q;
    const i64 s = cond_sub(u + v, wq);
    const i64 d = shoup_mul(cond_sub(u - v + wq, wq), w, ws, r.q, r.beta);
    u = div2_mod(s, r.half);
    v = div2_mod(d, r.half);
  } else {
    const i64 s = add_mod(u, v, r.q);
    const i64 d = mul_mod(sub_mod(u, v, r.q), w, r);
    u = div2_mod(s, r.half);
    v = div2_mod(d, r.half);
  }
}

// [0, window * q) -> [0, q): the one exit reduce of a lazy transform.
__device__ __forceinline__ i64 canonicalize(i64 x, const Reduce& r) {
  if (r.mode != kLazy) return x;
  if (r.window == 4) x = cond_sub(x, 2 * r.q);
  return cond_sub(x, r.q);
}

// Forward CT/DIT stages (twiddles psi^brv merged), natural order in,
// bit-reversed out, over two shared-memory polynomials.  Stage s pairs at stride h = n >> (s + 1); butterfly k of the
// stage sits in block i = k / h and uses twiddle fwd[2^s + i].
__device__ __forceinline__ void ct_stages(res_t* a, res_t* b, const i64* __restrict__ fwd,
                                          const i64* __restrict__ fwd_sh, const Reduce& r,
                                          int log_n) {
  const int half_n = 1 << (log_n - 1);
  for (int s = 0; s < log_n; ++s) {
    const int log_h = log_n - 1 - s;
    const int h = 1 << log_h;
    for (int k = threadIdx.x; k < half_n; k += blockDim.x) {
      const int i = k >> log_h;
      const int iu = (i << (log_h + 1)) + (k & (h - 1));
      const int iv = iu + h;
      const i64 w = __ldg(fwd + (1 << s) + i);
      const i64 ws = r.mode == kLazy ? __ldg(fwd_sh + (1 << s) + i) : 0;
      i64 u = a[iu], v = a[iv];
      ct_butterfly(u, v, w, ws, r);
      a[iu] = (res_t)u;
      a[iv] = (res_t)v;
      u = b[iu];
      v = b[iv];
      ct_butterfly(u, v, w, ws, r);
      b[iu] = (res_t)u;
      b[iv] = (res_t)v;
    }
    __syncthreads();
  }
}

// Inverse GS stages in mirror order with the halving in every stage,
// bit-reversed in, natural order out.  Stage s pairs at stride 2^s;
// butterfly k sits in block i = k >> s and uses twiddle inv[H + i] with
// H = n >> (s + 1).
__device__ __forceinline__ void gs_stages(res_t* a, const i64* __restrict__ inv,
                                          const i64* __restrict__ inv_sh, const Reduce& r,
                                          int log_n) {
  const int half_n = 1 << (log_n - 1);
  for (int s = 0; s < log_n; ++s) {
    const int blocks = half_n >> s;
    for (int k = threadIdx.x; k < half_n; k += blockDim.x) {
      const int i = k >> s;
      const int iu = (i << (s + 1)) + (k & ((1 << s) - 1));
      const int iv = iu + (1 << s);
      const i64 w = __ldg(inv + blocks + i);
      const i64 ws = r.mode == kLazy ? __ldg(inv_sh + blocks + i) : 0;
      i64 u = a[iu], v = a[iv];
      gs_butterfly(u, v, w, ws, r);
      a[iu] = (res_t)u;
      a[iv] = (res_t)v;
    }
    __syncthreads();
  }
}

// The no-shuffle cascade NTT(a) (.) NTT(b) -> iNTT on two shared-memory
// polynomials (loaded and synchronised by the caller).  Spectra stay
// bit-reversed between the transforms.  Leaves the product in `a`, still
// in the lazy window: the caller canonicalizes as it reads.
__device__ __forceinline__ void cascade(res_t* a, res_t* b, const i64* __restrict__ fwd,
                                        const i64* __restrict__ inv,
                                        const i64* __restrict__ fwd_sh,
                                        const i64* __restrict__ inv_sh, const Reduce& r,
                                        int log_n) {
  ct_stages(a, b, fwd, fwd_sh, r, log_n);
  for (int j = threadIdx.x; j < (1 << log_n); j += blockDim.x) {
    a[j] = (res_t)mul_mod(canonicalize(a[j], r), canonicalize(b[j], r), r);
  }
  __syncthreads();
  gs_stages(a, inv, inv_sh, r, log_n);
}

// z * beta by shifts and adds: beta = sum(sign * 2^e) - 1 (Eq 5).
__device__ __forceinline__ i64 sau(i64 x, const Decompose& d) {
  i64 acc = -x;
  for (int k = 0; k < d.n_terms; ++k) acc += d.beta_s[k] * (x << d.beta_e[k]);
  return acc;
}

// Alg-2 residue of one coefficient's S base-2^v segments mod d.q: blocks of
// t' segments z0 + SAU(z1) + SAU(Barrett(SAU(z2))), one v x v product per
// later block, and a last Barrett of the accumulator.
__device__ __forceinline__ i64 decompose(const i64* z, int S, int t_prime, const Decompose& d) {
  const int n_blocks = (S + t_prime - 1) / t_prime;
  i64 acc = 0;
  for (int rho = 0; rho < n_blocks; ++rho) {
    const int base = rho * t_prime;
    i64 blk = z[base];
    if (t_prime > 1 && base + 1 < S) blk += sau(z[base + 1], d);
    for (int k = 2; k < t_prime && base + k < S; ++k) {
      i64 x = barrett_reduce(sau(z[base + k], d), d.q, d.sau_eps, d.s1, d.sau_s2);
      for (int rep = 0; rep < k - 1; ++rep) {
        x = barrett_reduce(sau(x, d), d.q, d.sau_eps, d.s1, d.sau_s2);
      }
      blk += x;
    }
    blk = barrett_reduce(blk, d.q, d.sau_eps, d.s1, d.sau_s2);
    acc += rho == 0 ? blk : (blk * d.block_consts[rho]) % d.q;
  }
  return barrett_reduce(acc, d.q, d.acc_eps, d.s1, d.acc_s2);
}

// Eq-10 tail on one coefficient: raw limb sums -> canonical base-2^w limbs
// of the composed value mod q (carry ripple, then t - 1 conditional
// big-integer subtractions of q).
__device__ __forceinline__ void compose_finalize(i64* acc, const i64* __restrict__ q_limbs, int L,
                                                 int w, int t) {
  const i64 mask = (1LL << w) - 1;
  i64 carry = 0;
  for (int l = 0; l < L; ++l) {
    const i64 s = acc[l] + carry;
    acc[l] = s & mask;
    carry = s >> w;
  }
  for (int rep = 0; rep < t - 1; ++rep) {
    bool ge = true;
    for (int l = L - 1; l >= 0; --l) {
      const i64 ql = __ldg(q_limbs + l);
      if (acc[l] != ql) {
        ge = acc[l] > ql;
        break;
      }
    }
    if (!ge) continue;
    i64 borrow = 0;
    for (int l = 0; l < L; ++l) {
      const i64 d = acc[l] - __ldg(q_limbs + l) - borrow;
      borrow = d < 0;
      acc[l] = d < 0 ? d + (1LL << w) : d;
    }
  }
}

// Threads per block: one per butterfly of a stage up to kMaxThreads.
inline int block_threads(int n) {
  const int half_n = n / 2;
  return half_n < 32 ? 32 : (half_n > kMaxThreads ? kMaxThreads : half_n);
}

// Opt a kernel in to dynamic shared memory above the 48 KB default.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace parentt
