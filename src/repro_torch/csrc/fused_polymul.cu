// Fused no-shuffle cascade: per-channel negacyclic products
// NTT(a) (.) NTT(b) -> iNTT, (t, rows, n) x (t, rows, n) -> (t, rows, n).
//
// Replaces the TPU kernel fused_polymul_pallas / _make_fused_kernel
// (src/repro/kernels/ntt.py:757, :442, body _cascade :359).
//
// Design: one block per (channel, row) polynomial pair.  Both operands
// sit in shared memory as 32-bit residues (8n bytes: 32 KB at n = 4096),
// the 2 log2(n) forward stages run on them together, then the
// canonicalized pointwise product and log2(n) inverse stages; the spectra
// never leave shared memory, and no permutation runs between the
// transforms.  One __syncthreads() per stage.
//
// What bounds it on an H100: device memory traffic is 2 int64 operands in
// and 1 out (24 bytes per coefficient), which at 3.35 TB/s is far below
// the arithmetic: 3 n/2 log2(n) butterflies of 64-bit integer work that
// the GPU emulates with several 32-bit instructions each (and a software
// 64-bit % in the q = 31-bit regime), plus one barrier per stage.  The
// design keeps every intermediate on chip and feeds two transforms per
// stage loop to hide latency; it does not yet optimise the integer
// arithmetic or the bank conflicts of the short-stride stages.
#include "parentt.cuh"

using namespace parentt;

namespace {

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
  int mode;
  int window;
  int beta;
  int s1;
  int s2;
};

__global__ void __launch_bounds__(kMaxThreads) fused_polymul_kernel(const CascadeArgs args) {
  extern __shared__ res_t smem[];
  const int n = 1 << args.log_n;
  res_t* sa = smem;
  res_t* sb = smem + n;
  const int c = blockIdx.x / args.rows;
  const size_t base = (size_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    sa[j] = (res_t)args.a[base + j];
    sb[j] = (res_t)args.b[base + j];
  }
  __syncthreads();
  Reduce r;
  r.q = args.qs[c];
  r.half = args.half[c];
  r.eps = args.eps[c];
  r.s1 = args.s1;
  r.s2 = args.s2;
  r.mode = args.mode;
  r.window = args.window;
  r.beta = args.beta;
  const size_t tab = (size_t)c * n;
  cascade(sa, sb, args.fwd + tab, args.inv + tab, args.fwd_sh + tab, args.inv_sh + tab, r,
          args.log_n);
  for (int j = threadIdx.x; j < n; j += blockDim.x) args.out[base + j] = canonicalize(sa[j], r);
}

}  // namespace

extern "C" {

// Launches the cascade on `stream`; returns cudaGetLastError() (0 = launched).
int parentt_fused_polymul(const long long* a, const long long* b, long long* out,
                          const long long* qs, const long long* half, const long long* eps,
                          const long long* fwd, const long long* inv, const long long* fwd_shoup,
                          const long long* inv_shoup, int t, int rows, int log_n, int mode,
                          int window, int beta, int s1, int s2, void* stream) {
  const int n = 1 << log_n;
  const size_t smem = 2 * (size_t)n * sizeof(res_t);
  const cudaError_t err = allow_smem(fused_polymul_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const CascadeArgs args{a, b, out, qs, half, eps, fwd, inv, fwd_shoup, inv_shoup,
                         rows, log_n, mode, window, beta, s1, s2};
  fused_polymul_kernel<<<t * rows, block_threads(n), smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
