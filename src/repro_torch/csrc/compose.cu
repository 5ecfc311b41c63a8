// Eq-10 inverse CRT: canonical residues (t, rows) -> canonical base-2^w
// limbs (rows, L) of the composed value mod q.
//
// Replaces the TPU kernel compose_pallas (src/repro/kernels/crt.py:266,
// body :249, compose_finalize :207).
//
// Design: one thread per coefficient.  It reads its t residues (one word
// per channel, coalesced across threads), forms y_c = r_c * q~_c mod q_c
// with the reference's `%` (its floor % and C's truncating % agree on the
// canonical residues this kernel takes), sums y_c * q^_c limb by limb with
// the device function the fused e2e kernel shares (each sum < t * 2^59),
// and runs the Eq-10 tail `compose_finalize`: carry ripple, then t - 1
// conditional big-integer subtractions of q.  It writes its L limbs once.
//
// What bounds it on an H100: t int64 words in and L out per coefficient;
// the t software 64-bit `%` and the t x L limb products are integer work
// of the same order.  The limb stores stride by L words across threads.
#include "parentt.cuh"

using namespace parentt;

namespace {

struct ComposeArgs {
  const i64* res;
  i64* out;
  const i64* qs;       // (t,)
  const i64* tilde;    // (t,): q~_c = (q / q_c)^-1 mod q_c
  const i64* star;     // (t, L): limbs of q^_c = q / q_c
  const i64* q_limbs;  // (L,)
  i64 rows;
  int t;
  int L;
  int w;
};

__global__ void __launch_bounds__(256) compose_kernel(const ComposeArgs args) {
  const i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= args.rows) return;
  const i64* rc = args.res + row;
  i64 acc[kMaxLimbs];
  crt_limb_sums(
      acc,
      [&](int c) {
        return (rc[(size_t)c * args.rows] * __ldg(args.tilde + c)) % __ldg(args.qs + c);
      },
      args.star, args.t, args.L);
  compose_finalize(acc, args.q_limbs, args.L, args.w, args.t);
  i64* po = args.out + (size_t)row * args.L;
#pragma unroll
  for (int l = 0; l < kMaxLimbs; ++l) {
    if (l < args.L) po[l] = acc[l];
  }
}

}  // namespace

extern "C" {

// Launches the compose on `stream`; returns cudaGetLastError().
int parentt_compose(const long long* residues, long long* out, const long long* qs,
                    const long long* qi_tilde, const long long* star, const long long* q_limbs,
                    long long rows, int t, int L, int w, void* stream) {
  const ComposeArgs args{residues, out, qs, qi_tilde, star, q_limbs, rows, t, L, w};
  const int threads = 256;
  const long long blocks = (rows + threads - 1) / threads;
  compose_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
