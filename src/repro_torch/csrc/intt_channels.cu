// Inverse negacyclic NTT per RNS channel with the Eq-24 halving in every
// stage: canonical spectra (t, rows, n) in bit-reversed order -> canonical
// residues (t, rows, n) in natural order (n^-1 folded in).
//
// Replaces the TPU kernel intt_channels_pallas (src/repro/kernels/ntt.py:721,
// body _make_intt_kernel :419), the inverse stage of the reference's
// per-stage backend "pallas".
//
// Design: as ntt_channels.cu, one block per (channel, row) with the
// polynomial in shared memory as 32-bit words (4n bytes), running the GS
// stages of parentt.cuh with the channel's inverse tables and
// canonicalizing on the way out.  Input domain: canonical values below
// q < 2^31.
//
// What bounds it on an H100: 16 bytes of device memory per coefficient
// against n/2 log2(n) butterflies of emulated 64-bit integer work, each
// with two halvings, and one barrier per stage: the arithmetic weighs
// more.
#include "parentt.cuh"

using namespace parentt;

namespace {

__global__ void __launch_bounds__(kMaxThreads) intt_channels_kernel(const StageArgs args) {
  extern __shared__ res_t smem[];
  const int n = 1 << args.log_n;
  const int c = blockIdx.x / args.rows;
  const size_t base = (size_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) smem[j] = (res_t)args.in[base + j];
  __syncthreads();
  const Reduce r = channel_reduce(args.qs, args.half, args.eps, c, args.mode, args.window,
                                  args.beta, args.s1, args.s2);
  const size_t tab = (size_t)c * n;
  gs_stages(smem, args.tab + tab, args.tab_sh + tab, r, args.log_n);
  for (int j = threadIdx.x; j < n; j += blockDim.x) args.out[base + j] = canonicalize(smem[j], r);
}

}  // namespace

extern "C" {

// Launches the inverse transform on `stream`; returns cudaGetLastError().
int parentt_intt_channels(const long long* a, long long* out, const long long* qs,
                          const long long* half, const long long* eps, const long long* inv,
                          const long long* inv_shoup, int t, int rows, int log_n, int mode,
                          int window, int beta, int s1, int s2, void* stream) {
  const int n = 1 << log_n;
  const size_t smem = (size_t)n * sizeof(res_t);
  const cudaError_t err = allow_smem(intt_channels_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const StageArgs args{a, out, qs, half, eps, inv, inv_shoup, rows, log_n, mode, window, beta,
                       s1, s2};
  intt_channels_kernel<<<t * rows, block_threads(n), smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
