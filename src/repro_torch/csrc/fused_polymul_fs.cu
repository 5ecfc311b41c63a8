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
// Design: one launch, one thread-block cluster of C = 2^lc CTAs per
// (channel, row), C named by the caller (kernels/ntt.py fs_cluster:
// min(8, n1), 16 past n = 32768), launched with cudaLaunchKernelEx, on
// parentt.cuh's cluster_cascade: the cluster holds the row's two
// polynomials whole as 32-bit words, n / C elements of each a CTA in
// three padded buffers (52,224 bytes at n = 65536, C = 16).  CTA k reads column
// block k of a and b (n1 rows x n2 / C adjacent columns: runs of 128
// bytes of int64 at n = 65536, C = 16) and runs their forward column
// stages; the last column pass of each stores every value into the row
// block of the CTA that owns its row (DSMEM, the first transpose); the row
// stages, the canonical pointwise product and the inverse row stages run
// on whole rows, the last pass storing into the column block of the CTA
// that owns the column (DSMEM, the second transpose); the inverse column
// stages' last pass canonicalizes and stores int64 in the same runs.  The
// regime is a template parameter.
//
// What bounds it on an H100: device memory, two int64 operands in and one
// out a coefficient (24 bytes), the least any form moves: no scratch goes
// through device memory.  The two transposes move 12 bytes a coefficient
// between SMs of a cluster, and the 3 n/2 log2(n) butterflies are 32-bit
// integer work of a smaller bound.
#include <cooperative_groups.h>

#include "parentt.cuh"

namespace cg = cooperative_groups;
using namespace parentt;

namespace {

// PHASES < 3: the launch cut after its first or second transpose
// (parentt_fused_polymul_fs_phases).
template <int REG, int PHASES>
__global__ void __launch_bounds__(kMaxThreads, 2) fused_fs_kernel(const FsArgs a, const int lc) {
  extern __shared__ res_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int pair = blockIdx.x >> lc;  // the (channel, row) pair of this cluster
  const int c = pair / a.rows;
  const size_t poly = (size_t)pair << a.log_n;
  const ColMap map = cascade_colmap(a.log_n, lc, (int)cluster.block_rank());
  cluster_cascade<PHASES>(cluster, a.in[0] + poly, a.in[1] + poly,
                          CanonOut<ColMap>{a.out + poly, map}, smem, a.log_n, lc, fs_tabs(a, c),
                          fs_reduce<REG>(a, c));
}

template <int PHASES>
const void* pick_kernel(int mode, int window) {
  static const void* kernels[3] = {(const void*)fused_fs_kernel<kLazy2, PHASES>,
                                   (const void*)fused_fs_kernel<kLazy4, PHASES>,
                                   (const void*)fused_fs_kernel<kStrict, PHASES>};
  return kernels[regime_of(mode, window)];
}

int launch(const void* kernel, const long long* a, const long long* b, long long* out,
           const long long* qs, const long long* half, const long long* eps,
           const long long* fwd, const long long* inv, const long long* fwd_shoup,
           const long long* inv_shoup, int t, int rows, int log_n, int mode, int window,
           int beta, int s1, int s2, int lc, void* stream) {
  const FsArgs args{{a, b},    {nullptr, nullptr},
                    out,       qs,
                    half,      eps,
                    fwd,       inv,
                    fwd_shoup, inv_shoup,
                    rows,      log_n,
                    mode,      window,
                    beta,      s1,
                    s2};
  void* params[] = {(void*)&args, (void*)&lc};
  return launch_cluster_cascade(kernel, params, t * rows, log_n, lc, (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Launches the cascade on `stream` as clusters of 2^lc CTAs; returns the
// CUDA error of an attribute call or the launch (a cluster the card cannot
// schedule comes back as the launch error).
int parentt_fused_polymul_fs(const long long* a, const long long* b, long long* out,
                             const long long* qs, const long long* half, const long long* eps,
                             const long long* fwd, const long long* inv,
                             const long long* fwd_shoup, const long long* inv_shoup, int t,
                             int rows, int log_n, int mode, int window, int beta, int s1, int s2,
                             int lc, void* stream) {
  return launch(pick_kernel<3>(mode, window), a, b, out, qs, half, eps, fwd, inv, fwd_shoup,
                inv_shoup, t, rows, log_n, mode, window, beta, s1, s2, lc, stream);
}

#ifdef PARENTT_CASCADE_PHASES
// The same launch cut after its first (phases = 1) or second (2)
// transpose, or whole (3), in a build with PARENTT_CASCADE_PHASES defined
// (chip_smoke.py --cascade-variants, which times the phases apart; the
// kernels' own build has no cut instances).  `out` is written only when
// phases = 3.
int parentt_fused_polymul_fs_phases(const long long* a, const long long* b, long long* out,
                                    const long long* qs, const long long* half,
                                    const long long* eps, const long long* fwd,
                                    const long long* inv, const long long* fwd_shoup,
                                    const long long* inv_shoup, int t, int rows, int log_n,
                                    int mode, int window, int beta, int s1, int s2, int lc,
                                    int phases, void* stream) {
  const void* kernel = phases == 1   ? pick_kernel<1>(mode, window)
                       : phases == 2 ? pick_kernel<2>(mode, window)
                                     : pick_kernel<3>(mode, window);
  return launch(kernel, a, b, out, qs, half, eps, fwd, inv, fwd_shoup, inv_shoup, t, rows, log_n,
                mode, window, beta, s1, s2, lc, stream);
}
#endif

// How many clusters of 2^lc CTAs the card holds at once at this n and
// regime (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int parentt_fused_polymul_fs_max_clusters(int log_n, int mode, int window, int lc) {
  return cascade_clusters(pick_kernel<3>(mode, window), log_n, lc);
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
