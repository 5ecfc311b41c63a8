// Fused no-shuffle cascade as a multi-block transform (K1-fs): per-channel
// negacyclic products NTT(a) (.) NTT(b) -> iNTT, (t, rows, n) x (t, rows, n)
// -> (t, rows, n), for n whose two operands do not fit one CTA's shared
// memory (n = 32768 and 65536 on the card), and any n >= 4.
//
// Replaces the four-step body of the TPU kernel fused_polymul_pallas
// (src/repro/kernels/ntt.py:757; _cascade :359 with _fwd_stages /
// _inv_stages :312 / :338), on the card's own two-level split
// (parentt.cuh, "Multi-block transforms").  As in the reference, the
// tiles stay transposed across the product: the NTT-domain product never
// reaches device memory.
//
// Design: three launches over E = min(n, 4096)-element tiles,
// pass_threads(E) threads a CTA (256):
//   1. the forward column stages of a and b: a CTA takes n1 rows x E/n1
//      adjacent columns of both operands (coalesced int64 row segments)
//      and stores their lazy values as 32-bit words to two scratch
//      tensors;
//   2. one row pass (parentt.cuh fs_rows_cascade, which K2-fs's row launch
//      runs too): a CTA takes E/n2 whole rows of both, runs the forward
//      row stages, the canonical pointwise product and the inverse row
//      stages (the last forward and first inverse stages share one trip,
//      middle_span, as in K1) in its shared memory, and stores the
//      product's lazy values over a's scratch;
//   3. the inverse column stages, whose last pass canonicalizes and stores
//      int64.
// The regime is a template parameter.
//
// What bounds it on an H100: device memory.  The least traffic is two
// int64 operands in and one out a coefficient (24 bytes); the split adds
// 32-bit scratch: two words written and read by the row pass, one written
// back and read by the last pass (16 bytes more, 40 in all).  The
// 3 n/2 log2(n) butterflies are 32-bit integer work of a smaller bound.
#include "parentt.cuh"

using namespace parentt;

namespace {

template <int REG>
__global__ void __launch_bounds__(kFsThreads, 4) fused_fs_cols_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  fs_cols_forward<REG, 2>(a, smem);
}

template <int REG>
__global__ void __launch_bounds__(kFsThreads, 4) fused_fs_rows_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  fs_rows_cascade<REG>(a, smem);
}

template <int REG>
__global__ void __launch_bounds__(kFsThreads, REG == kStrict ? 4 : 6)
    fused_fs_inv_cols_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  fs_cols_inverse<REG>(a, smem);
}

typedef void (*FsKernel)(const FsArgs);

// Pass 0: forward columns (two tiles), 1: rows (two tiles), 2: inverse
// columns (one tile).
FsKernel pick_kernel(int pass, int mode, int window) {
  static const FsKernel kernels[3][3] = {
      {fused_fs_cols_kernel<kLazy2>, fused_fs_cols_kernel<kLazy4>,
       fused_fs_cols_kernel<kStrict>},
      {fused_fs_rows_kernel<kLazy2>, fused_fs_rows_kernel<kLazy4>,
       fused_fs_rows_kernel<kStrict>},
      {fused_fs_inv_cols_kernel<kLazy2>, fused_fs_inv_cols_kernel<kLazy4>,
       fused_fs_inv_cols_kernel<kStrict>}};
  return kernels[pass][regime_of(mode, window)];
}

size_t pass_smem(int pass, int log_n) { return fs_smem(log_n, pass < 2 ? 2 : 1); }

}  // namespace

extern "C" {

// Launches the three passes on `stream` (scratch_a, scratch_b: (t, rows, n)
// 32-bit words each); returns the CUDA error of an attribute call or a
// launch.
int parentt_fused_polymul_fs(const long long* a, const long long* b, int* scratch_a,
                             int* scratch_b, long long* out, const long long* qs,
                             const long long* half, const long long* eps, const long long* fwd,
                             const long long* inv, const long long* fwd_shoup,
                             const long long* inv_shoup, int t, int rows, int log_n, int mode,
                             int window, int beta, int s1, int s2, void* stream) {
  const FsArgs args{{a, b},    {(res_t*)scratch_a, (res_t*)scratch_b},
                    out,       qs,
                    half,      eps,
                    fwd,       inv,
                    fwd_shoup, inv_shoup,
                    rows,      log_n,
                    mode,      window,
                    beta,      s1,
                    s2};
  for (int pass = 0; pass < 3; ++pass) {
    const FsKernel kernel = pick_kernel(pass, mode, window);
    const cudaError_t err = allow_smem(kernel, pass_smem(pass, log_n));
    if (err != cudaSuccess) return (int)err;
    kernel<<<fs_blocks(t, rows, log_n), fs_threads(log_n), pass_smem(pass, log_n),
             (cudaStream_t)stream>>>(args);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
  }
  return 0;
}

// How many CTAs of pass `pass` an SM holds at once at this n and regime,
// or minus the CUDA error.
int parentt_fused_polymul_fs_blocks_per_sm(int pass, int log_n, int mode, int window) {
  const FsKernel kernel = pick_kernel(pass, mode, window);
  cudaError_t err = allow_smem(kernel, pass_smem(pass, log_n));
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, fs_threads(log_n),
                                                      pass_smem(pass, log_n));
  return err == cudaSuccess ? count : -(int)err;
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
