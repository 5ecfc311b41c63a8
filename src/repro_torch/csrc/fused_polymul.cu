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
// kPairMinBlocks).  The kernel and its launch live in parentt.cuh
// (pair_cascade_kernel, launch_pair_cascade), which K2-fs's cascade also
// runs on 32-bit words where one CTA holds a pair.
#include "parentt.cuh"

using namespace parentt;

extern "C" {

// Launches the cascade on `stream`; returns the CUDA error of the
// attribute call or the launch (0 = launched).
int parentt_fused_polymul(const long long* a, const long long* b, long long* out,
                          const long long* qs, const long long* half, const long long* eps,
                          const long long* fwd, const long long* inv, const long long* fwd_shoup,
                          const long long* inv_shoup, int t, int rows, int log_n, int mode,
                          int window, int beta, int s1, int s2, void* stream) {
  const FsArgs args{{a, b},    {nullptr, nullptr},
                    out,       qs,
                    half,      eps,
                    fwd,       inv,
                    fwd_shoup, inv_shoup,
                    rows,      log_n,
                    mode,      window,
                    beta,      s1,
                    s2};
  return launch_pair_cascade<CanonPair>(args, nullptr, t * rows, (cudaStream_t)stream);
}

// How many CTAs of the cascade an SM holds at once at this n and regime
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
int parentt_fused_polymul_blocks_per_sm(int log_n, int mode, int window) {
  return pair_blocks_per_sm<CanonPair>(log_n, mode, window);
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
