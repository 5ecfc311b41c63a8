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
// Design: the mirror of ntt_channels_fs.cu (K3-fs), one persistent launch
// a call, a tile stream (parentt.cuh fs_stream) over E = min(n,
// 4096)-element tiles, the row tiles of every polynomial first, its column
// tiles a lag later, each loaded once its polynomial's row tiles are in
// the scratch:
//   1. a row tile (E/n2 whole rows of int64 spectra, contiguous) is copied
//      into the padded tile, runs the log2(n2) inverse row stages (GS,
//      stride 1 .. n2/2) with the stage table's twiddles, and leaves its
//      lazy values as 32-bit words in the scratch;
//   2. a column tile (n1 rows x E/n1 adjacent columns, a TMA box of
//      32-bit words) runs the log2(n1) inverse column stages (stride n2 ..
//      n/2) as a virtual length-E transform, and its last pass
//      canonicalizes and leaves int64 for the TMA store.
// The regime is a template parameter.
//
// What bounds it on an H100: the integer passes, as K3-fs's, the more so
// for the two halvings in every butterfly; three stages a pass (K3-fs
// takes four), the faster here (chip_smoke.py --transform-variants).  16
// bytes a coefficient of device memory at the least, the 32-bit words
// between the phases read back from L2.
#include "parentt.cuh"

using namespace parentt;

namespace {

template <int REG>
__global__ void __launch_bounds__(kFsStreamBlock, kFsStreamMinBlocks)
    intt_fs_kernel(const __grid_constant__ CUtensorMap col_in,
                   const __grid_constant__ CUtensorMap col_out, const FsStreamArgs a) {
  extern __shared__ unsigned char smem[];
  fs_stream<REG, false>(a, col_in, col_out, smem);
}

decltype(&intt_fs_kernel<kLazy2>) pick_kernel(int mode, int window) {
  static const decltype(&intt_fs_kernel<kLazy2>) kernels[3] = {
      intt_fs_kernel<kLazy2>, intt_fs_kernel<kLazy4>, intt_fs_kernel<kStrict>};
  return kernels[regime_of(mode, window)];
}

int launch(const long long* a, int* scratch, long long* out, const long long* qs,
           const long long* half, const long long* eps, const long long* inv,
           const long long* inv_shoup, int t, int rows, int log_n, int mode, int window, int beta,
           int s1, int s2, int phases, int grid, void* stream) {
  const FsStreamArgs args{a,   (res_t*)scratch, out,   scratch + ((size_t)t * rows << log_n),
                          qs,  half,            eps,   inv,
                          inv_shoup, rows,      t * rows, log_n,
                          mode, window,         beta,  s1,
                          s2,  phases,          0};
  return fs_stream_launch(pick_kernel(mode, window), false, args, grid, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// One call on `stream`: `scratch` holds the (t, rows, n) 32-bit words
// between the phases and, after them, 1 + t * rows int32 counters; `grid`
// is the CTAs the card holds at once.  Returns the CUDA error of the
// memset, the map encoding, the attribute call or the launch.
int parentt_intt_channels_fs(const long long* a, int* scratch, long long* out,
                             const long long* qs, const long long* half, const long long* eps,
                             const long long* inv, const long long* inv_shoup, int t, int rows,
                             int log_n, int mode, int window, int beta, int s1, int s2, int grid,
                             void* stream) {
  return launch(a, scratch, out, qs, half, eps, inv, inv_shoup, t, rows, log_n, mode, window,
                beta, s1, s2, 3, grid, stream);
}

#ifdef PARENTT_FS_PHASES
// The same tile loop over one phase's tiles (`phases` 1: the rows, 2: the
// columns) or both (3), for chip_smoke.py --transform-variants alone.
int parentt_intt_channels_fs_phases(const long long* a, int* scratch, long long* out,
                                    const long long* qs, const long long* half,
                                    const long long* eps, const long long* inv,
                                    const long long* inv_shoup, int t, int rows, int log_n,
                                    int mode, int window, int beta, int s1, int s2, int phases,
                                    int grid, void* stream) {
  return launch(a, scratch, out, qs, half, eps, inv, inv_shoup, t, rows, log_n, mode, window,
                beta, s1, s2, phases, grid, stream);
}
#endif

// How many CTAs an SM holds at once at this n and regime, or minus the
// CUDA error.
int parentt_intt_channels_fs_blocks_per_sm(int log_n, int mode, int window) {
  return fs_stream_blocks_per_sm(pick_kernel(mode, window), log_n);
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
