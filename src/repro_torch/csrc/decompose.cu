// Alg-2 SAU decompose: base-2^v segments (rows, S) -> canonical residues
// (t, rows) in every RNS channel.
//
// Replaces the TPU kernel decompose_pallas (src/repro/kernels/crt.py:180,
// body :167, decompose_stage :41).  The TPU version makes one pallas_call
// per channel, each with that channel's SAU circuit baked in and each
// reading all S segments; here one launch serves all t channels.
//
// Design: one thread per coefficient.  It reads its S segments once into
// registers and runs the shared `decompose` device function of
// parentt.cuh (the one the fused e2e kernel runs) for each channel with
// that channel's constants, writing out[c, row]: consecutive threads
// write consecutive words, so the stores coalesce.
//
// What bounds it on an H100: S int64 words in and t out per coefficient;
// the SAU shift/add networks, the Barrett reductions and the 64-bit `%`
// of the block products are emulated 64-bit integer work of the same
// order, so bytes and operations are close.  The segment loads stride by
// S words across threads and lean on L1 to gather them.
#include "parentt.cuh"

using namespace parentt;

namespace {

struct DecomposeArgs {
  const i64* z;
  i64* out;
  DecomposeTables dec;
  i64 rows;
  int t;
  int S;
  int t_prime;
};

__global__ void __launch_bounds__(256) decompose_kernel(const DecomposeArgs args) {
  const i64 row = (i64)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= args.rows) return;
  i64 z[kMaxSegments];
  const i64* zr = args.z + (size_t)row * args.S;
  for (int k = 0; k < args.S; ++k) z[k] = zr[k];
  for (int c = 0; c < args.t; ++c) {
    const Decompose d = channel_decompose(args.dec, c);
    args.out[(size_t)c * args.rows + row] = decompose(z, args.S, args.t_prime, d);
  }
}

}  // namespace

extern "C" {

// Launches the decompose on `stream`; returns cudaGetLastError().
int parentt_decompose(const long long* z, long long* out, const long long* qs,
                      const long long* sau_eps, const long long* sau_s2,
                      const long long* acc_eps, const long long* beta_e,
                      const long long* beta_s, const long long* block_consts, long long rows,
                      int t, int S, int t_prime, int n_terms, int n_blocks, int dec_s1,
                      int acc_s2, void* stream) {
  const DecomposeTables dec{qs,     sau_eps,      sau_s2,  acc_eps,  beta_e,
                            beta_s, block_consts, n_terms, n_blocks, dec_s1, acc_s2};
  const DecomposeArgs args{z, out, dec, rows, t, S, t_prime};
  const int threads = 256;
  const long long blocks = (rows + threads - 1) / threads;
  decompose_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
