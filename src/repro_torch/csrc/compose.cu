// Eq-10 inverse CRT: canonical residues (t, rows) -> canonical base-2^w
// limbs (rows, L) of the composed value mod q.
//
// Replaces the TPU kernel compose_pallas (src/repro/kernels/crt.py:266,
// body :249, compose_finalize :207).
//
// Design: one thread per coefficient, a CTA of R coefficients, on the
// compose tail of the fused e2e kernel (K2).  The CTA keeps its channels'
// constants (q, 1/q, the block-Barrett m, q~) in shared memory.  Each
// thread
// * reads its t residues, one word a channel (coalesced across threads),
//   the reads in flight together: the 8-limb instances (t <= 15, L <= 8,
//   crt_compose's SINGLE: one pass of straight-line code) issue every
//   read before the CTA's table fills, into registers; the 16-limb
//   instances read each group of 15 channels' words before its
//   arithmetic (crt_compose's PRELOAD).  `python3 chip_smoke.py
//   --compose-variants` times both against the same source with each
//   switched off;
// * forms y_c = r_c q~_c mod q_c as one 32x32->64 product reduced by the
//   block Barrett of parentt.cuh with m = floor(2^(b+31) / q_c)
//   (RnsPlan.dec_d's block_m, the constant K2 and K5 take), exact since
//   r_c q~_c < q_c^2 < 2^(2b);
// * sums y_c q^_c limb by limb and y_c / q_c in double (crt_compose:
//   carry-normalised every 15 channels, so exact for any t), whose floor
//   is floor(value / q) to within one, and finishes with one carry ripple
//   that subtracts that quotient times q, then one conditional addition or
//   subtraction of q (no loop of big-integer compare-and-subtract steps);
// * leaves its L limbs in the CTA's (R, L) shared stage, which the CTA
//   writes out as cnt * L contiguous int64 words (coalesced; the last CTA
//   writes only its cnt rows).
// R = 256 while the stage takes at most 64 KB, fewer past it (tile_rows).
// The limb chunk MAXL (8 for L <= 8 and t <= 15, else 16: the limbs
// ripple into the stage chunk by chunk and are corrected there), the CTAs
// an SM the registers are held to, and NARROW (every q below 2^30: the
// Barrett remainders in 32 bits) are template parameters, so the limb
// sums are MAXL-word register arrays.  Input domain: canonical residues
// r_c < q_c, the contract of repro_torch.compose.
//
// What bounds it on an H100: t int64 words in and L out per coefficient
// (the byte bound: 104 bytes at t = 6, L = 7); the t block Barretts and
// t x L multiply-adds are integer work of a smaller bound at small t (at
// t = 30, L = 32 the 960 multiply-adds a coefficient weigh more).  A
// thread's loads are independent and the stores coalesced, so what is
// left is the latency of the loads against the CTAs an SM holds.
#include "parentt.cuh"

using namespace parentt;

namespace {

// CTAs of kComposeTile an SM that the register budget leaves room for
// with MAXL = 8: at most 48 registers (kComposeMinBlocks).  MAXL = 16
// holds twice the limb sums: three CTAs (at most 80 registers, a short
// spill) for L <= 16, where it runs one chunk, and two (at most 128) past
// it, where the chunk loop's carries and the second pass over the
// channels spill at 80.  The kernel body is parentt.cuh's compose_kernel.
typedef void (*ComposeKernel)(const ComposeArgs);

ComposeKernel pick_kernel(int narrow, int t, int L) {
  static const ComposeKernel kernels[2][3] = {
      {compose_kernel<false, 8, kComposeMinBlocks, false>, compose_kernel<false, 16, 3, false>,
       compose_kernel<false, 16, 2, false>},
      {compose_kernel<true, 8, kComposeMinBlocks, false>, compose_kernel<true, 16, 3, false>,
       compose_kernel<true, 16, 2, false>},
  };
  return kernels[narrow ? 1 : 0][compose_variant(t, L)];
}

}  // namespace

extern "C" {

// Launches the compose on `stream`; `narrow` (every q below 2^30) picks
// the 32-bit Barrett remainders.  Returns the CUDA error of the attribute
// call or the launch (cudaErrorInvalidValue when one CTA's shared memory
// cannot hold a row's limbs beside the channels' table).
int parentt_compose(const long long* residues, long long* out, const long long* qs,
                    const long long* qi_tilde, const long long* block_m, const long long* star,
                    const long long* q_limbs, long long rows, int t, int L, int w, int s1,
                    int narrow, void* stream) {
  const ComposeArgs args{residues, nullptr, out, qs, qi_tilde, block_m, star, q_limbs,
                         rows,     t,       L,   w,  s1};
  const int R = compose_rows_of(t, L);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + R - 1) / R;
  const size_t smem = (size_t)(compose_table_bytes(t) + (long long)R * L * sizeof(i64));
  const ComposeKernel kernel = pick_kernel(narrow, t, L);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, R, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
