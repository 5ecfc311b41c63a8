// Fused no-shuffle cascade: per-channel negacyclic products
// NTT(a) (.) NTT(b) -> iNTT, (t, rows, n) x (t, rows, n) -> (t, rows, n).
//
// Replaces the TPU kernel fused_polymul_pallas / _make_fused_kernel
// (src/repro/kernels/ntt.py:757, :442, body _cascade :359).
//
// Design: one CTA per (channel, row) polynomial pair, pass_threads(n)
// threads (256 at n = 4096), on the register passes of parentt.cuh that
// K2 runs (channel_cascade): a thread keeps 2^G <= 8 coefficients of both
// operands in registers across G stages between trips through shared
// memory, where both operands sit as 32-bit residues padded one word in
// 16 (8.5n bytes: 34 KB at n = 4096).  The first forward pass reads a and
// b straight from device memory into registers (thread p holds elements
// p + m 2^(log2 n - G), so the loads coalesce and no fill loop or barrier
// comes first); the last forward pass, the canonical pointwise product
// and the first inverse pass are one; the last inverse pass
// canonicalizes and stores int64 straight to device memory (elements
// p + m 2^s0, coalesced).  At n = 4096 that is 6 barriers, against 26
// when every stage was one.  The regime (lazy W = 2, lazy W = 4, strict)
// is a template parameter, so the butterflies' branches on it fold away;
// strict v = 31 products take the block Barrett.
//
// What bounds it on an H100: device memory traffic is 2 int64 operands in
// and 1 out (24 bytes per coefficient); the 3 n/2 log2(n) butterflies
// are 32-bit integer work of a smaller bound.  The design keeps every
// intermediate on chip, issues a thread's loads together, and has few
// barriers; what is left is the latency of the shared-memory trips and
// the integer work, with 4 CTAs an SM at n = 4096 (registers:
// kMinBlocks below).
#include "parentt.cuh"

using namespace parentt;

namespace {

// CTAs of kMaxThreads an SM that the register budget leaves room for
// (twice as many of the 256 threads at n = 4096): at most 64 registers,
// which no instance spills at; three would cap them at 40, where the
// lazy W = 4 and strict instances spill.
constexpr int kMinBlocks = 2;

struct CascadeArgs {
  const i64* a;
  const i64* b;
  i64* out;
  const i64* qs;
  const i64* half;
  const i64* eps;
  const i64* fwd;
  const i64* inv;
  const i64* fwd_sh;
  const i64* inv_sh;
  int rows;
  int log_n;
  int group;  // K: stages per register pass
  int mode;
  int window;
  int beta;
  int s1;
  int s2;
};

template <int REG>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    fused_polymul_kernel(const CascadeArgs args) {
  extern __shared__ res_t smem[];
  const int n = 1 << args.log_n;
  const int c = blockIdx.x / args.rows;
  const size_t base = (size_t)blockIdx.x * n;
  const Reduce r = regime_reduce<REG>(args.qs, args.half, args.eps, c, args.mode, args.window,
                                      args.beta, args.s1, args.s2);
  const size_t tab = (size_t)c * n;
  const ChannelTabs tb{args.fwd + tab, args.inv + tab, args.fwd_sh + tab, args.inv_sh + tab};
  channel_cascade(smem, smem + padded(n), DevicePolys<2>{{args.a + base, args.b + base}},
                  DeviceOut{args.out + base}, Keep{}, args.log_n, args.group, tb, r);
}

typedef void (*CascadeKernel)(const CascadeArgs);

CascadeKernel pick_kernel(int mode, int window) {
  static const CascadeKernel kernels[3] = {
      fused_polymul_kernel<kLazy2>, fused_polymul_kernel<kLazy4>, fused_polymul_kernel<kStrict>};
  return kernels[regime_of(mode, window)];
}

// Both operands' padded residues.
size_t cascade_smem(int n) { return 2 * (size_t)padded(n) * sizeof(res_t); }

}  // namespace

extern "C" {

// Launches the cascade on `stream`; returns the CUDA error of the
// attribute call or the launch (0 = launched).
int parentt_fused_polymul(const long long* a, const long long* b, long long* out,
                          const long long* qs, const long long* half, const long long* eps,
                          const long long* fwd, const long long* inv, const long long* fwd_shoup,
                          const long long* inv_shoup, int t, int rows, int log_n, int mode,
                          int window, int beta, int s1, int s2, void* stream) {
  const int n = 1 << log_n;
  const CascadeKernel kernel = pick_kernel(mode, window);
  const cudaError_t err = allow_smem(kernel, cascade_smem(n));
  if (err != cudaSuccess) return (int)err;
  const CascadeArgs args{a, b, out, qs, half, eps, fwd, inv, fwd_shoup, inv_shoup,
                         rows, log_n, pass_group(n), mode, window, beta, s1, s2};
  kernel<<<t * rows, pass_threads(n), cascade_smem(n), (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// How many CTAs of the cascade an SM holds at once at this n and regime
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
int parentt_fused_polymul_blocks_per_sm(int log_n, int mode, int window) {
  const int n = 1 << log_n;
  const CascadeKernel kernel = pick_kernel(mode, window);
  cudaError_t err = allow_smem(kernel, cascade_smem(n));
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, pass_threads(n),
                                                      cascade_smem(n));
  return err == cudaSuccess ? count : -(int)err;
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
