// Forward negacyclic NTT per RNS channel as a multi-block transform (K3-fs):
// canonical residues (t, rows, n) in natural order -> canonical spectra
// (t, rows, n) in bit-reversed order, for n whose polynomial does not fit
// one CTA's shared memory (n = 65536 on the card), and any n >= 4.
//
// Replaces the four-step body of the TPU kernel ntt_channels_pallas
// (src/repro/kernels/ntt.py:680; _make_ntt_kernel :397 -> _fs_cols_fwd /
// _fs_cols_fwd_hier and _fs_rows_fwd, :158-174 and :266).  It computes what
// that body computes, on the card's own two-level split (parentt.cuh,
// "Multi-block transforms"), not the TPU's 128-lane / 8-sublane chain.
//
// Design: two launches over E = min(n, 4096)-element tiles,
// pass_threads(E) threads a CTA (256):
//   1. the column stages: a CTA takes n1 rows x E/n1 adjacent columns of
//      the (n1, n2) view (every row segment a coalesced load of int64
//      residues), runs the log2(n1) column stages on the register passes
//      as a virtual length-E transform, and stores its lazy values as
//      32-bit words to a scratch tensor;
//   2. the row stages: a CTA takes E/n2 whole rows (contiguous), runs the
//      log2(n2) row stages with the twist-merged twiddles read from the
//      stage table itself, canonicalizes, and copies out int64 through
//      shared memory with consecutive threads on consecutive words.
// The regime (lazy W = 2, lazy W = 4, strict with block-Barrett products)
// is a template parameter.
//
// What bounds it on an H100: device memory.  The least traffic is one
// int64 word in and one out a coefficient (16 bytes); the split adds a
// 32-bit scratch write and read (8 bytes more, 24 in all).  The n/2
// log2(n) butterflies are 32-bit integer work of a smaller bound.  The
// tiles are small (17 KB), so an SM holds many CTAs.
#include "parentt.cuh"

using namespace parentt;

namespace {

template <int REG>
__global__ void __launch_bounds__(kFsThreads, REG == kStrict ? 4 : 6)
    ntt_fs_cols_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  fs_cols_forward<REG, 1>(a, smem);
}

template <int REG>
__global__ void __launch_bounds__(kFsThreads, REG == kStrict ? 4 : 6)
    ntt_fs_rows_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  const FsGeom g = fs_geom(a.log_n, a.rows);
  const Reduce r = fs_reduce<REG>(a, g.c);
  const int E = 1 << g.log_e;
  const int x0 = g.blk << g.log_e;
  const GlobalIn<res_t, 1, RowMap> in{{a.scratch[0] + g.poly}, RowMap{}};
  const TilePolys<1> tile{{smem}, x0};
  forward_stages<1>(in, tile, tile, g.log_n1, g.log_n, g.log_n, x0, g.log_e, pass_group(E),
                    fs_tabs(a, g.c), r);
  __syncthreads();
  i64* out = a.out + g.poly + x0;
  for (int j = threadIdx.x; j < E; j += blockDim.x) out[j] = canonicalize(smem[pad(j)], r);
}

typedef void (*FsKernel)(const FsArgs);

FsKernel pick_kernel(int pass, int mode, int window) {
  static const FsKernel kernels[2][3] = {
      {ntt_fs_cols_kernel<kLazy2>, ntt_fs_cols_kernel<kLazy4>, ntt_fs_cols_kernel<kStrict>},
      {ntt_fs_rows_kernel<kLazy2>, ntt_fs_rows_kernel<kLazy4>, ntt_fs_rows_kernel<kStrict>}};
  return kernels[pass][regime_of(mode, window)];
}

}  // namespace

extern "C" {

// Launches the two passes on `stream` (scratch: (t, rows, n) 32-bit
// words); returns the CUDA error of an attribute call or a launch.
int parentt_ntt_channels_fs(const long long* a, int* scratch, long long* out,
                            const long long* qs, const long long* half, const long long* eps,
                            const long long* fwd, const long long* fwd_shoup, int t, int rows,
                            int log_n, int mode, int window, int beta, int s1, int s2,
                            void* stream) {
  const FsArgs args{{a, a},    {(res_t*)scratch, (res_t*)scratch},
                    out,       qs,
                    half,      eps,
                    fwd,       fwd,
                    fwd_shoup, fwd_shoup,
                    rows,      log_n,
                    mode,      window,
                    beta,      s1,
                    s2};
  for (int pass = 0; pass < 2; ++pass) {
    const FsKernel kernel = pick_kernel(pass, mode, window);
    const cudaError_t err = allow_smem(kernel, fs_smem(log_n, 1));
    if (err != cudaSuccess) return (int)err;
    kernel<<<fs_blocks(t, rows, log_n), fs_threads(log_n), fs_smem(log_n, 1),
             (cudaStream_t)stream>>>(args);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return (int)launched;
  }
  return 0;
}

// How many CTAs of pass `pass` (0: columns, 1: rows) an SM holds at once
// at this n and regime, or minus the CUDA error.
int parentt_ntt_channels_fs_blocks_per_sm(int pass, int log_n, int mode, int window) {
  const FsKernel kernel = pick_kernel(pass, mode, window);
  cudaError_t err = allow_smem(kernel, fs_smem(log_n, 1));
  if (err != cudaSuccess) return -(int)err;
  int count = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&count, kernel, fs_threads(log_n),
                                                      fs_smem(log_n, 1));
  return err == cudaSuccess ? count : -(int)err;
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
