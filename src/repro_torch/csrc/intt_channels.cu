// Inverse negacyclic NTT per RNS channel with the Eq-24 halving in every
// stage: canonical spectra (t, rows, n) in bit-reversed order -> canonical
// residues (t, rows, n) in natural order (n^-1 folded in).
//
// Replaces the TPU kernel intt_channels_pallas (src/repro/kernels/ntt.py:721,
// body _make_intt_kernel :419), the inverse stage of the reference's
// per-stage backend "pallas".
//
// Design: the mirror of ntt_channels.cu (K3).  One CTA per (channel, row)
// polynomial, pass_threads(n) threads (256 at n = 4096), on the inverse
// register passes of parentt.cuh that K1 and K2 run after their middle
// pass: a thread keeps 2^G <= 8 coefficients in registers across G GS
// stages between trips through shared memory, where the polynomial sits
// as 32-bit residues padded one word in 16 (4.25n bytes: 17 KB at
// n = 4096).  Passes of K = pass_group(n) stages run from s0 = 0; the
// first reads the spectra straight from device memory into registers,
// and the last, of g0 stages, canonicalizes and stores int64 straight to
// device memory (thread p holds elements p + m 2^s0: consecutive threads
// store consecutive words).  In the first pass a thread reads 2^G
// contiguous words, so one load instruction of a warp spans 32 strides
// of 8 * 2^G bytes, but the thread's next loads take the rest of the
// same sectors from L1: on the H100 this beat a coalesced copy-in through
// shared memory and one more barrier (PERF.md, PR 17).  At n = 4096 that
// is 3 barriers, against 13 when every stage was one.  The regime (lazy
// W = 2 at v = 30, lazy W = 4 at v = 29, strict at v = 31 with
// block-Barrett products) is a template parameter.  Input domain:
// canonical spectra below q < 2^31, as the reference's lazy butterflies
// assume; uint32 storage is exact there.
//
// What bounds it on an H100: one int64 word in and one out per
// coefficient (16 bytes); the n/2 log2(n) butterflies, each with two
// halvings, are 32-bit integer work of a smaller bound.  With one
// polynomial a CTA the registers leave room for many CTAs an SM
// (kMinBlocks), which hides the latency of the shared-memory trips and
// the barriers.
#include "parentt.cuh"

using namespace parentt;

namespace {

// CTAs of kMaxThreads an SM that the register budget leaves room for
// (twice as many of the 256 threads at n = 4096): at most 40 registers in
// the lazy regimes, as K3.  The strict regime (v = 31) spills there and
// keeps two CTAs of kMaxThreads (64 registers) instead.
constexpr int kMinBlocks = 3;

template <int REG>
__global__ void __launch_bounds__(kMaxThreads, REG == kStrict ? 2 : kMinBlocks)
    intt_channels_kernel(const StageArgs args) {
  extern __shared__ res_t smem[];
  const int log_n = args.log_n;
  const int n = 1 << log_n;
  const int c = blockIdx.x / args.rows;
  const size_t base = (size_t)blockIdx.x * n;
  const Reduce r = regime_reduce<REG>(args.qs, args.half, args.eps, c, args.mode, args.window,
                                      args.beta, args.s1, args.s2);
  const size_t tab = (size_t)c * n;
  const ChannelTabs tb{nullptr, args.tab + tab, nullptr, args.tab_sh + tab};
  const int K = pass_group(n);
  const int passes = (log_n + K - 1) / K;
  const int g0 = log_n - K * (passes - 1);
  const SharedPolys<1> a{{smem}};
#define FIRST(G) inverse_pass<G>(DevicePolys<1>{{args.in + base}}, a, 0, log_n, Keep{}, tb, r)
  PARENTT_DISPATCH_G(K, FIRST)
#undef FIRST
  __syncthreads();
  int s0 = K;
  for (int q = 2; q < passes; ++q, s0 += K) {
#define INV(G) inverse_pass<G>(a, a, s0, log_n, Keep{}, tb, r)
    PARENTT_DISPATCH_G(K, INV)
#undef INV
    __syncthreads();
  }
#define LAST(G) inverse_pass<G>(a, DeviceOut{args.out + base}, s0, log_n, Keep{}, tb, r)
  PARENTT_DISPATCH_G(g0, LAST)
#undef LAST
}

typedef void (*InttKernel)(const StageArgs);

InttKernel pick_kernel(int mode, int window) {
  static const InttKernel kernels[3] = {intt_channels_kernel<kLazy2>,
                                        intt_channels_kernel<kLazy4>,
                                        intt_channels_kernel<kStrict>};
  return kernels[regime_of(mode, window)];
}

// One padded polynomial.
size_t intt_smem(int n) { return (size_t)padded(n) * sizeof(res_t); }

}  // namespace

extern "C" {

// Launches the inverse transform on `stream`; returns the CUDA error of
// the attribute call or the launch.
int parentt_intt_channels(const long long* a, long long* out, const long long* qs,
                          const long long* half, const long long* eps, const long long* inv,
                          const long long* inv_shoup, int t, int rows, int log_n, int mode,
                          int window, int beta, int s1, int s2, void* stream) {
  const int n = 1 << log_n;
  const InttKernel kernel = pick_kernel(mode, window);
  const cudaError_t err = allow_smem(kernel, intt_smem(n));
  if (err != cudaSuccess) return (int)err;
  const StageArgs args{a, out, qs, half, eps, inv, inv_shoup, rows, log_n, mode, window, beta,
                       s1, s2};
  kernel<<<t * rows, pass_threads(n), intt_smem(n), (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// How many CTAs of the transform an SM holds at once at this n and
// regime (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the
// CUDA error.
int parentt_intt_channels_blocks_per_sm(int log_n, int mode, int window) {
  const int n = 1 << log_n;
  const InttKernel kernel = pick_kernel(mode, window);
  cudaError_t err = allow_smem(kernel, intt_smem(n));
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, pass_threads(n),
                                                      intt_smem(n));
  return err == cudaSuccess ? count : -(int)err;
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
