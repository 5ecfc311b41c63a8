// Forward negacyclic NTT per RNS channel: canonical residues (t, rows, n)
// in natural order -> canonical spectra (t, rows, n) in bit-reversed order.
//
// Replaces the TPU kernel ntt_channels_pallas (src/repro/kernels/ntt.py:680,
// body _make_ntt_kernel :397), the forward stage of the reference's
// per-stage backend "pallas".
//
// Design: one block per (channel, row) polynomial.  The residues are
// loaded into shared memory as 32-bit words (4n bytes: 16 KB at n = 4096,
// so several blocks share an SM), the log2(n) CT stages of parentt.cuh
// run in place with the channel's forward tables in the plan's regime
// (lazy W = 2 at v = 30, lazy W = 4 at v = 29, strict % at v = 31), and
// each value is canonicalized as it is written back as int64.  Input
// domain: canonical residues below q < 2^31, as the reference's lazy
// butterflies assume; uint32 storage is exact there.
//
// What bounds it on an H100: one int64 word in and one out per
// coefficient (16 bytes); the n/2 log2(n) butterflies of 64-bit integer
// work (emulated with 32-bit instructions) and one barrier per stage
// weigh more.  The design keeps the whole transform on chip; it does not
// yet optimise the integer arithmetic or the bank conflicts of the
// short-stride stages.
#include "parentt.cuh"

using namespace parentt;

namespace {

__global__ void __launch_bounds__(kMaxThreads) ntt_channels_kernel(const StageArgs args) {
  extern __shared__ res_t smem[];
  const int n = 1 << args.log_n;
  const int c = blockIdx.x / args.rows;
  const size_t base = (size_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) smem[j] = (res_t)args.in[base + j];
  __syncthreads();
  const Reduce r = channel_reduce(args.qs, args.half, args.eps, c, args.mode, args.window,
                                  args.beta, args.s1, args.s2);
  const size_t tab = (size_t)c * n;
  ct_stages<1>(smem, nullptr, args.tab + tab, args.tab_sh + tab, r, args.log_n);
  for (int j = threadIdx.x; j < n; j += blockDim.x) args.out[base + j] = canonicalize(smem[j], r);
}

}  // namespace

extern "C" {

// Launches the forward transform on `stream`; returns cudaGetLastError().
int parentt_ntt_channels(const long long* a, long long* out, const long long* qs,
                         const long long* half, const long long* eps, const long long* fwd,
                         const long long* fwd_shoup, int t, int rows, int log_n, int mode,
                         int window, int beta, int s1, int s2, void* stream) {
  const int n = 1 << log_n;
  const size_t smem = (size_t)n * sizeof(res_t);
  const cudaError_t err = allow_smem(ntt_channels_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const StageArgs args{a, out, qs, half, eps, fwd, fwd_shoup, rows, log_n, mode, window, beta,
                       s1, s2};
  ntt_channels_kernel<<<t * rows, block_threads(n), smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
