// Inverse negacyclic NTT per RNS channel as a multi-block transform
// (K4-fs), with the Eq-24 halving in every stage: canonical spectra
// (t, rows, n) in bit-reversed order -> canonical residues (t, rows, n)
// in natural order, for n whose polynomial does not fit one CTA's shared
// memory (n = 65536 on the card), and any n >= 4.
//
// Replaces the four-step body of the TPU kernel intt_channels_pallas
// (src/repro/kernels/ntt.py:721; _make_intt_kernel :419 -> _fs_rows_inv and
// _fs_cols_inv / _fs_cols_inv_hier, :190-204 and :282), on the card's own
// two-level split (parentt.cuh, "Multi-block transforms").
//
// Design: the mirror of ntt_channels_fs.cu (K3-fs), two launches over
// E = min(n, 4096)-element tiles, pass_threads(E) threads a CTA (256):
//   1. the row stages first (GS, stride 1 .. n2/2): a CTA takes E/n2 whole
//      rows, reads the int64 spectra straight into registers, runs the
//      log2(n2) inverse row stages on the register passes with the
//      stage table's twiddles, and stores its lazy values as 32-bit words
//      to a scratch tensor;
//   2. the column stages (stride n2 .. n/2): a CTA takes n1 rows x E/n1
//      adjacent columns as a virtual length-E transform, runs the
//      log2(n1) inverse column stages, and its last pass canonicalizes and
//      stores int64 (consecutive threads on consecutive columns).
// The regime is a template parameter.
//
// What bounds it on an H100: device memory, as K3-fs: 16 bytes a
// coefficient at the least, 24 with the 32-bit scratch; the butterflies
// with their two halvings are 32-bit integer work of a smaller bound.
#include "parentt.cuh"

using namespace parentt;

namespace {

template <int REG>
__global__ void __launch_bounds__(kFsThreads, REG == kStrict ? 4 : 6)
    intt_fs_rows_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  const FsGeom g = fs_geom(a.log_n, a.rows);
  const Reduce r = fs_reduce<REG>(a, g.c);
  const int x0 = g.blk << g.log_e;
  const GlobalIn<i64, 1, RowMap> in{{a.in[0] + g.poly}, RowMap{}};
  const ScratchOut<1, RowMap> out{{a.scratch[0] + g.poly}, RowMap{}};
  const TilePolys<1> tile{{smem}, x0};
  inverse_stages(in, tile, out, 0, g.log_n2, g.log_n, x0, g.log_e, pass_group(1 << g.log_e),
                 fs_tabs(a, g.c), r);
}

template <int REG>
__global__ void __launch_bounds__(kFsThreads, REG == kStrict ? 4 : 6)
    intt_fs_cols_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  fs_cols_inverse<REG>(a, smem);
}

typedef void (*FsKernel)(const FsArgs);

FsKernel pick_kernel(int pass, int mode, int window) {
  static const FsKernel kernels[2][3] = {
      {intt_fs_rows_kernel<kLazy2>, intt_fs_rows_kernel<kLazy4>, intt_fs_rows_kernel<kStrict>},
      {intt_fs_cols_kernel<kLazy2>, intt_fs_cols_kernel<kLazy4>, intt_fs_cols_kernel<kStrict>}};
  return kernels[pass][regime_of(mode, window)];
}

}  // namespace

extern "C" {

// Launches the two passes on `stream` (scratch: (t, rows, n) 32-bit
// words); returns the CUDA error of an attribute call or a launch.
int parentt_intt_channels_fs(const long long* a, int* scratch, long long* out,
                             const long long* qs, const long long* half, const long long* eps,
                             const long long* inv, const long long* inv_shoup, int t, int rows,
                             int log_n, int mode, int window, int beta, int s1, int s2,
                             void* stream) {
  const FsArgs args{{a, a},    {(res_t*)scratch, (res_t*)scratch},
                    out,       qs,
                    half,      eps,
                    inv,       inv,
                    inv_shoup, inv_shoup,
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

// How many CTAs of pass `pass` (0: rows, 1: columns) an SM holds at once
// at this n and regime, or minus the CUDA error.
int parentt_intt_channels_fs_blocks_per_sm(int pass, int log_n, int mode, int window) {
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
