// Forward negacyclic NTT per RNS channel: canonical residues (t, rows, n)
// in natural order -> canonical spectra (t, rows, n) in bit-reversed order.
//
// Replaces the TPU kernel ntt_channels_pallas (src/repro/kernels/ntt.py:680,
// body _make_ntt_kernel :397), the forward stage of the reference's
// per-stage backend "pallas".
//
// Design: one CTA per (channel, row) polynomial, pass_threads(n) threads
// (256 at n = 4096), on the forward register passes of parentt.cuh that
// K1 and K2 run: a thread keeps 2^G <= 8 coefficients in registers across
// G stages between trips through shared memory, where the polynomial sits
// as 32-bit residues padded one word in 16 (4.25n bytes: 17 KB at
// n = 4096).  The first pass reads the residues straight from device
// memory (thread p holds elements p + m 2^(log2 n - G): coalesced, no
// fill loop or barrier first).  The last pass writes back to the padded
// shared memory, and a copy-out in which consecutive threads store
// consecutive int64 words leaves canonical (coalesced; faster on the
// H100 than 16-byte vector stores straight from registers, which span
// 64-byte strides across a warp, PERF.md).  At n = 4096 that is 4
// barriers, against 13 when every stage was one.  The regime (lazy W = 2
// at v = 30, lazy W = 4 at v = 29, strict at v = 31 with block-Barrett
// products) is a template parameter.  Input domain: canonical residues below q < 2^31, as the
// reference's lazy butterflies assume; uint32 storage is exact there.
//
// What bounds it on an H100: one int64 word in and one out per
// coefficient (16 bytes); the n/2 log2(n) butterflies are 32-bit integer
// work of a smaller bound.  With one polynomial a CTA the registers leave
// room for many CTAs an SM (kMinBlocks), which hides the latency of the
// shared-memory trips and the barriers.
#include "parentt.cuh"

using namespace parentt;

namespace {

// CTAs of kMaxThreads an SM that the register budget leaves room for
// (twice as many of the 256 threads at n = 4096): at most 40 registers,
// which no instance spills at; four would cap them at 32, where every
// instance spills.
constexpr int kMinBlocks = 3;

template <int REG>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    ntt_channels_kernel(const StageArgs args) {
  extern __shared__ res_t smem[];
  const int log_n = args.log_n;
  const int n = 1 << log_n;
  const int c = blockIdx.x / args.rows;
  const size_t base = (size_t)blockIdx.x * n;
  const Reduce r = regime_reduce<REG>(args.qs, args.half, args.eps, c, args.mode, args.window,
                                      args.beta, args.s1, args.s2);
  const size_t tab = (size_t)c * n;
  const ChannelTabs tb{args.tab + tab, nullptr, args.tab_sh + tab, nullptr};
  const int K = pass_group(n);
  const int passes = (log_n + K - 1) / K;
  const int g0 = log_n - K * (passes - 1);
  const SharedPolys<1> a{{smem}};
#define FIRST(G) forward_pass<G, 1>(DevicePolys<1>{{args.in + base}}, a, 0, log_n, tb, r)
  PARENTT_DISPATCH_G(g0, FIRST)
#undef FIRST
  __syncthreads();
  int s0 = g0;
  for (int q = 1; q + 1 < passes; ++q, s0 += K) {
#define FWD(G) forward_pass<G, 1>(a, a, s0, log_n, tb, r)
    PARENTT_DISPATCH_G(K, FWD)
#undef FWD
    __syncthreads();
  }
#define LAST(G) forward_pass<G, 1>(a, a, s0, log_n, tb, r)
  PARENTT_DISPATCH_G(K, LAST)
#undef LAST
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    args.out[base + j] = canonicalize(smem[pad(j)], r);
  }
}

typedef void (*NttKernel)(const StageArgs);

NttKernel pick_kernel(int mode, int window) {
  static const NttKernel kernels[3] = {ntt_channels_kernel<kLazy2>, ntt_channels_kernel<kLazy4>,
                                       ntt_channels_kernel<kStrict>};
  return kernels[regime_of(mode, window)];
}

// One padded polynomial.
size_t ntt_smem(int n) { return (size_t)padded(n) * sizeof(res_t); }

}  // namespace

extern "C" {

// Launches the forward transform on `stream`; returns the CUDA error of
// the attribute call or the launch.
int parentt_ntt_channels(const long long* a, long long* out, const long long* qs,
                         const long long* half, const long long* eps, const long long* fwd,
                         const long long* fwd_shoup, int t, int rows, int log_n, int mode,
                         int window, int beta, int s1, int s2, void* stream) {
  const int n = 1 << log_n;
  const NttKernel kernel = pick_kernel(mode, window);
  const cudaError_t err = allow_smem(kernel, ntt_smem(n));
  if (err != cudaSuccess) return (int)err;
  const StageArgs args{a, out, qs, half, eps, fwd, fwd_shoup, rows, log_n, mode, window, beta,
                       s1, s2};
  kernel<<<t * rows, pass_threads(n), ntt_smem(n), (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// How many CTAs of the transform an SM holds at once at this n and
// regime (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the
// CUDA error.
int parentt_ntt_channels_blocks_per_sm(int log_n, int mode, int window) {
  const int n = 1 << log_n;
  const NttKernel kernel = pick_kernel(mode, window);
  cudaError_t err = allow_smem(kernel, ntt_smem(n));
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, pass_threads(n),
                                                      ntt_smem(n));
  return err == cudaSuccess ? count : -(int)err;
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
