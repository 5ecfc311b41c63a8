// Fused end-to-end multiplier (the paper's Fig-10 datapath in one kernel):
// SAU decompose -> per-channel NTT(a) (.) NTT(b) -> iNTT -> Eq-10 compose,
// segments (rows, n, S) x 2 -> product limbs (rows, n, L), residues never
// in device memory.
//
// Replaces the TPU kernel fused_e2e_polymul_pallas
// (src/repro/kernels/ntt.py:802) with its bodies _make_fused_e2e_kernel
// (:479) and _make_fused_e2e_chgrid_kernel (:530).
//
// Design: one block per row.  The TPU version runs the channels as an
// ordered grid axis and accumulates y_i * q^_i into a revisited output
// block; Hopper blocks run in no order, so here the block itself loops
// over the t channels.  It decomposes both operands into all t channels
// at once (each segment is read from device memory exactly once) and
// keeps the 2t residue polynomials in shared memory as 32-bit words
// (8tn bytes: 192 KB at n = 4096, t = 6, under the 227 KB a block may
// opt in to).  Each channel then runs the shared cascade in place and
// overwrites its `a` slot with y_i = p_i * q~_i mod q_i.  After the last
// channel every thread sums the t terms y_i * q^_i per limb for its own
// coefficients, runs the carry ripple and the t - 1 conditional
// subtractions, and writes its limbs once.
//
// What bounds it on an H100: device memory sees 2S int64 segments in and
// L int64 limbs out per coefficient; the 64-bit integer work of 3t
// transforms (emulated with 32-bit instructions, plus software 64-bit %
// for the decompose block products, q~ products at q of 31 bits and the
// v = 31 butterflies) dominates.  The shared-memory working set allows one
// block per SM, so a batch below 132 rows leaves SMs idle.
#include "parentt.cuh"

using namespace parentt;

namespace {

struct E2EArgs {
  const i64* za;
  const i64* zb;
  i64* out;
  // per-channel scalars (t,)
  const i64* qs;
  const i64* half;
  const i64* eps;
  const i64* tilde;
  // per-channel tables (t, n)
  const i64* fwd;
  const i64* inv;
  const i64* fwd_sh;
  const i64* inv_sh;
  // per-channel decompose circuits
  DecomposeTables dec;
  // compose
  const i64* star;     // (t, L): q^_i limbs
  const i64* q_limbs;  // (L,)
  int log_n;
  int t;
  int S;
  int L;
  int t_prime;
  int w;
  int mode;
  int window;
  int beta;
  int s1;
  int s2;
};

__global__ void __launch_bounds__(kMaxThreads) fused_e2e_polymul_kernel(const E2EArgs args) {
  extern __shared__ res_t smem[];
  const int n = 1 << args.log_n;
  res_t* ra = smem;                        // (t, n) residues of a, then y_i
  res_t* rb = smem + (size_t)args.t * n;   // (t, n) residues of b
  const size_t row = blockIdx.x;

  // Step 1: Alg-2 SAU decompose of both operands into every channel.
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    i64 za[kMaxSegments], zb[kMaxSegments];
    const size_t seg = (row * n + j) * args.S;
    for (int k = 0; k < args.S; ++k) {
      za[k] = args.za[seg + k];
      zb[k] = args.zb[seg + k];
    }
    for (int c = 0; c < args.t; ++c) {
      const Decompose d = channel_decompose(args.dec, c);
      ra[(size_t)c * n + j] = (res_t)decompose(za, args.S, args.t_prime, d);
      rb[(size_t)c * n + j] = (res_t)decompose(zb, args.S, args.t_prime, d);
    }
  }
  __syncthreads();

  // Steps 2-3: per channel, the cascade, then y_i = p_i * q~_i mod q_i.
  for (int c = 0; c < args.t; ++c) {
    const Reduce r = channel_reduce(args.qs, args.half, args.eps, c, args.mode, args.window,
                                    args.beta, args.s1, args.s2);
    const size_t off = (size_t)c * n;
    cascade(ra + off, rb + off, args.fwd + off, args.inv + off, args.fwd_sh + off,
            args.inv_sh + off, r, args.log_n);
    const i64 tilde = args.tilde[c];
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      ra[off + j] = (res_t)mul_mod(canonicalize(ra[off + j], r), tilde, r);
    }
  }
  __syncthreads();

  // Step 4: Eq-10 limb sums and the compose tail, one write per limb.
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    i64 acc[kMaxLimbs];
    crt_limb_sums(acc, [&](int c) { return (i64)ra[(size_t)c * n + j]; }, args.star, args.t,
                  args.L);
    compose_finalize(acc, args.q_limbs, args.L, args.w, args.t);
    i64* po = args.out + (row * n + j) * args.L;
    for (int l = 0; l < args.L; ++l) po[l] = acc[l];
  }
}

}  // namespace

extern "C" {

// Launches the e2e multiplier on `stream`; returns cudaGetLastError().
int parentt_fused_e2e_polymul(
    const long long* za, const long long* zb, long long* out, const long long* qs,
    const long long* half, const long long* eps, const long long* tilde, const long long* fwd,
    const long long* inv, const long long* fwd_shoup, const long long* inv_shoup,
    const long long* sau_eps, const long long* sau_s2, const long long* acc_eps,
    const long long* beta_e, const long long* beta_s, const long long* block_consts,
    const long long* star, const long long* q_limbs, int rows, int log_n, int t, int S, int L,
    int n_terms, int n_blocks, int t_prime, int dec_s1, int acc_s2, int w, int mode, int window,
    int beta, int s1, int s2, void* stream) {
  const int n = 1 << log_n;
  const size_t smem = 2 * (size_t)t * n * sizeof(res_t);
  const cudaError_t err = allow_smem(fused_e2e_polymul_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const DecomposeTables dec{qs,     sau_eps,      sau_s2,   acc_eps, beta_e,
                            beta_s, block_consts, n_terms,  n_blocks, dec_s1, acc_s2};
  const E2EArgs args{za,  zb,      out,       qs,    half,    eps,   tilde, fwd,  inv,
                     fwd_shoup, inv_shoup, dec, star, q_limbs, log_n, t,     S,    L,
                     t_prime, w, mode,    window, beta,  s1,    s2};
  fused_e2e_polymul_kernel<<<rows, block_threads(n), smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
