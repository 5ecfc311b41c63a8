// Eq-10 inverse CRT: canonical residues (t, rows) -> canonical base-2^w
// limbs (rows, L) of the composed value mod q.
//
// Replaces the TPU kernel compose_pallas (src/repro/kernels/crt.py:266,
// body :249, compose_finalize :207).
//
// Design: one thread per coefficient, a CTA of kTile = 256 coefficients,
// on the compose tail of the fused e2e kernel (K2).  The CTA keeps its
// channels' constants (q, 1/q, the block-Barrett m, q~) in shared memory.
// Each thread
// * reads its t residues, one word a channel (coalesced across threads),
//   all t loads issued before the arithmetic;
// * forms y_c = r_c q~_c mod q_c as one 32x32->64 product reduced by the
//   block Barrett of parentt.cuh with m = floor(2^(b+31) / q_c)
//   (RnsPlan.dec_d's block_m, the constant K2 and K5 take), exact since
//   r_c q~_c < q_c^2 < 2^(2b);
// * sums y_c q^_c limb by limb (crt_limb_sums) and y_c / q_c in double,
//   whose floor is floor(value / q) to within one, and finishes with
//   compose_finalize_quotient: one carry ripple that subtracts that
//   quotient times q, then one conditional addition or subtraction of q
//   (no loop of big-integer compare-and-subtract steps);
// * leaves its L limbs in the CTA's (kTile, L) shared stage, which the CTA
//   writes out as cnt * L contiguous int64 words (coalesced; the last CTA
//   writes only its cnt rows).
// The limb bound MAXL (8 or 16) and NARROW (every q below 2^30: the
// Barrett remainders in 32 bits) are template parameters, so the limb sums
// are MAXL-word register arrays.  Input domain: canonical residues
// r_c < q_c, the contract of repro_torch.compose.
//
// What bounds it on an H100: t int64 words in and L out per coefficient
// (the byte bound: 104 bytes at t = 6, L = 7); the t block Barretts and
// t x L multiply-adds are integer work of a smaller bound.  A thread's
// loads are independent and the stores coalesced, so what is left is the
// latency of the loads against the CTAs an SM holds.
#include "parentt.cuh"

using namespace parentt;

namespace {

constexpr int kTile = 256;
// CTAs of kTile an SM that the register budget leaves room for with
// MAXL = 8: at most 48 registers.  MAXL = 16 holds twice the limb sums
// and keeps two CTAs (at most 128 registers) rather than spill, which its narrow
// instance did with no bound given.
constexpr int kMinBlocks = 5;

struct ComposeArgs {
  const i64* res;
  i64* out;
  const i64* qs;       // (t,)
  const i64* tilde;    // (t,): q~_c = (q / q_c)^-1 mod q_c
  const i64* block_m;  // (t,): floor(2^(b+31) / q_c)
  const i64* star;     // (t, L): limbs of q^_c = q / q_c
  const i64* q_limbs;  // (L,)
  i64 rows;
  int t;
  int L;
  int w;
  int s1;  // b - 1, b = bit_length(q_c), the same for every channel
};

// One channel's constants, as a CTA keeps them in shared memory.
struct ComposeChannel {
  double inv_q;
  res_t q;
  res_t m;
  res_t tilde;
};

template <bool NARROW, int MAXL>
__global__ void __launch_bounds__(kTile, MAXL == 8 ? kMinBlocks : 2)
    compose_kernel(const ComposeArgs args) {
  extern __shared__ __align__(16) i64 stage[];  // (kTile, L) limbs of this tile
  __shared__ ComposeChannel ch[kMaxChannels];
  const int t = args.t, L = args.L;
  for (int c = threadIdx.x; c < t; c += blockDim.x) {
    ch[c].inv_q = 1.0 / (double)args.qs[c];
    ch[c].q = (res_t)args.qs[c];
    ch[c].m = (res_t)args.block_m[c];
    ch[c].tilde = (res_t)args.tilde[c];
  }
  const i64 row0 = (i64)blockIdx.x * kTile;
  const int cnt = (int)min((i64)kTile, args.rows - row0);
  const int j = threadIdx.x;
  res_t r[kMaxChannels];
#pragma unroll
  for (int c = 0; c < kMaxChannels; ++c) {
    r[c] = c < t && j < cnt ? (res_t)__ldg(args.res + (size_t)c * args.rows + row0 + j) : 0;
  }
  __syncthreads();
  if (j < cnt) {
    i64 acc[MAXL];
    double quotient = 0.0;  // sum_c y_c / q_c
    crt_limb_sums(
        acc,
        [&](int c) {
          const ComposeChannel& k = ch[c];
          const res_t y = (res_t)block_barrett<NARROW>((u64)r[c] * k.tilde, k.q, k.m, args.s1);
          quotient = fma((double)y, k.inv_q, quotient);
          return (i64)y;
        },
        args.star, t, L);
    compose_finalize_quotient(acc, (int)quotient, args.q_limbs, L, args.w);
#pragma unroll
    for (int l = 0; l < MAXL; ++l) {
      if (l < L) stage[j * L + l] = acc[l];
    }
  }
  __syncthreads();
  i64* po = args.out + row0 * L;
  for (int i = threadIdx.x; i < cnt * L; i += kTile) po[i] = stage[i];
}

typedef void (*ComposeKernel)(const ComposeArgs);

ComposeKernel pick_kernel(int narrow, int L) {
  static const ComposeKernel kernels[2][2] = {
      {compose_kernel<false, 8>, compose_kernel<false, 16>},
      {compose_kernel<true, 8>, compose_kernel<true, 16>},
  };
  return kernels[narrow ? 1 : 0][L <= 8 ? 0 : 1];
}

}  // namespace

extern "C" {

// Launches the compose on `stream`; `narrow` (every q below 2^30) picks
// the 32-bit Barrett remainders.  Returns cudaGetLastError().
int parentt_compose(const long long* residues, long long* out, const long long* qs,
                    const long long* qi_tilde, const long long* block_m, const long long* star,
                    const long long* q_limbs, long long rows, int t, int L, int w, int s1,
                    int narrow, void* stream) {
  const ComposeArgs args{residues, out, qs, qi_tilde, block_m, star, q_limbs, rows, t, L, w, s1};
  const long long blocks = (rows + kTile - 1) / kTile;
  const size_t smem = (size_t)kTile * L * sizeof(i64);
  pick_kernel(narrow, L)<<<(unsigned)blocks, kTile, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
