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
// Design: one persistent launch a call, a tile stream (parentt.cuh
// fs_stream): every CTA takes E = min(n, 4096)-element tiles from one
// queue, the column tiles of every polynomial first, its row tiles a lag
// later, each row tile loaded once its polynomial's column tiles are in
// the scratch:
//   1. a column tile (n1 rows x E/n1 adjacent columns of the (n1, n2)
//      view, a TMA box of int64 residues) runs the log2(n1) column stages
//      on the register passes as a virtual length-E transform and leaves
//      its lazy values as 32-bit words in the scratch;
//   2. a row tile (E/n2 whole rows, contiguous 32-bit words) runs the
//      log2(n2) row stages with the twist-merged twiddles read from the
//      stage table itself, canonicalizes, and leaves int64 in the output.
// A producer warp keeps the next tile's load in flight while the consumer
// threads run the current tile's passes, and drains each finished tile
// with a TMA store.  The regime (lazy W = 2, lazy W = 4, strict with
// block-Barrett products) is a template parameter.
//
// What bounds it on an H100: the integer passes.  The least traffic is
// one int64 word in and one out a coefficient (16 bytes), and the 32-bit
// words between the phases are read back from L2; but the n/2 log2(n)
// butterflies in ceil(log2(n1)/4) + ceil(log2(n2)/4) trips through shared
// memory (four stages a pass) take longer alone than the tile copies
// alone, and the stream, which overlaps one tile's loads and stores with
// another's passes, comes out a little above them (chip_smoke.py
// --transform-variants, PERF.md).
#include "parentt.cuh"

using namespace parentt;

namespace {

template <int REG>
__global__ void __launch_bounds__(kFsStreamBlock, kFsStreamMinBlocks)
    ntt_fs_kernel(const __grid_constant__ CUtensorMap col_in,
                  const __grid_constant__ CUtensorMap col_out, const FsStreamArgs a) {
  extern __shared__ unsigned char smem[];
  fs_stream<REG, true>(a, col_in, col_out, smem);
}

decltype(&ntt_fs_kernel<kLazy2>) pick_kernel(int mode, int window) {
  static const decltype(&ntt_fs_kernel<kLazy2>) kernels[3] = {
      ntt_fs_kernel<kLazy2>, ntt_fs_kernel<kLazy4>, ntt_fs_kernel<kStrict>};
  return kernels[regime_of(mode, window)];
}

int launch(const long long* a, int* scratch, long long* out, const long long* qs,
           const long long* half, const long long* eps, const long long* fwd,
           const long long* fwd_shoup, int t, int rows, int log_n, int mode, int window, int beta,
           int s1, int s2, int phases, int grid, void* stream) {
  const FsStreamArgs args{a,   (res_t*)scratch, out,   scratch + ((size_t)t * rows << log_n),
                          qs,  half,            eps,   fwd,
                          fwd_shoup, rows,      t * rows, log_n,
                          mode, window,         beta,  s1,
                          s2,  phases,          0};
  return fs_stream_launch(pick_kernel(mode, window), true, args, grid, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// One call on `stream`: `scratch` holds the (t, rows, n) 32-bit words
// between the phases and, after them, 1 + t * rows int32 counters; `grid`
// is the CTAs the card holds at once.  Returns the CUDA error of the
// memset, the map encoding, the attribute call or the launch.
int parentt_ntt_channels_fs(const long long* a, int* scratch, long long* out,
                            const long long* qs, const long long* half, const long long* eps,
                            const long long* fwd, const long long* fwd_shoup, int t, int rows,
                            int log_n, int mode, int window, int beta, int s1, int s2, int grid,
                            void* stream) {
  return launch(a, scratch, out, qs, half, eps, fwd, fwd_shoup, t, rows, log_n, mode, window,
                beta, s1, s2, 3, grid, stream);
}

#ifdef PARENTT_FS_PHASES
// The same tile loop over one phase's tiles (`phases` 1: the columns, 2:
// the rows) or both (3), for chip_smoke.py --transform-variants alone.
int parentt_ntt_channels_fs_phases(const long long* a, int* scratch, long long* out,
                                   const long long* qs, const long long* half,
                                   const long long* eps, const long long* fwd,
                                   const long long* fwd_shoup, int t, int rows, int log_n,
                                   int mode, int window, int beta, int s1, int s2, int phases,
                                   int grid, void* stream) {
  return launch(a, scratch, out, qs, half, eps, fwd, fwd_shoup, t, rows, log_n, mode, window,
                beta, s1, s2, phases, grid, stream);
}
#endif

// How many CTAs an SM holds at once at this n and regime, or minus the
// CUDA error.
int parentt_ntt_channels_fs_blocks_per_sm(int log_n, int mode, int window) {
  return fs_stream_blocks_per_sm(pick_kernel(mode, window), log_n);
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
