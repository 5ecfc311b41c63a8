// Fused end-to-end multiplier (the paper's Fig-10 datapath in one kernel):
// SAU decompose -> per-channel NTT(a) (.) NTT(b) -> iNTT -> Eq-10 compose,
// segments (rows, n, S) x 2 -> product limbs (rows, n, L), residues never
// in device memory.
//
// Replaces the TPU kernel fused_e2e_polymul_pallas
// (src/repro/kernels/ntt.py:802) with its bodies _make_fused_e2e_kernel
// (:479) and _make_fused_e2e_chgrid_kernel (:530).
//
// Design: one thread-block cluster of C = min(t, 8) CTAs per row.  The TPU
// version runs the channels as an ordered grid axis and accumulates
// y_i * q^_i into a revisited output block; here the channels are spread
// over the cluster and meet through distributed shared memory (DSMEM).
// CTA r of a cluster
//
// * owns the channels r, r + C, ... (one at t <= 8, ceil(t / 8) slots past
//   it), each as two 32-bit residue polynomials in its shared memory (8n
//   bytes a channel, padded by one word in 16 against bank conflicts), and
//   the coefficient slice
//   [ceil(r n / C), ceil((r + 1) n / C)), which is uneven when C does not
//   divide n;
// * decompose (parentt.cuh cluster_decompose, shared with K2-fs): copies
//   its slice's segments of both operands, a chunk at a time (dc
//   coefficients an operand, fewer than half the threads where the
//   staging beside the residues cannot hold more), into shared
//   memory (cp.async, coalesced), runs every channel's SAU circuit on them
//   (half the threads per operand) and stores each residue straight into
//   the owning CTA's shared memory over DSMEM; cluster.sync();
// * cascade: per owned channel, NTT(a) and NTT(b), the pointwise product,
//   the iNTT and y_i = p_i * q~_i mod q_i, on the register passes of
//   parentt.cuh (channel_cascade, shared with K1 and K3).  A thread keeps
//   2^G coefficients of both operands in registers across G <= 3 stages,
//   so a transform takes ceil(log2(n) / 3) trips through shared memory,
//   and the last forward trip, the product and the first inverse trip are
//   one (at n = 4096: 6 barriers a channel, against 37 when every stage is
//   one); cluster.sync();
// * compose (parentt.cuh cluster_compose, shared with K2-fs): reads y_i
//   of its slice from every peer over DSMEM, runs the
//   Eq-10 limb sums and the tail (the quotient floor(value / q) =
//   floor(sum y_i / q_i) estimated in double and corrected by one
//   conditional add or subtract of q, in place of t - 1 conditional
//   subtractions), stages the (chunk, L)
//   limbs in shared memory and writes them coalesced; a last
//   cluster.sync() keeps its shared memory alive until every peer has read
//   it.
//
// Butterflies and products are 32-bit, the decompose's SAU network one
// product by beta (parentt.cuh); the regime (lazy W = 2, lazy W = 4,
// strict) and the limb chunk MAXL (8 for L <= 8, else 16-limb chunks) are
// template parameters, so the limb sums live in registers.  The
// channels' circuits live in dynamic shared memory after the residues
// (32 bytes a channel), the staging after them (e2e_geom: what is left of
// 227 KB bounds the decompose and compose chunks).  One launch through
// cudaLaunchKernelEx with the cluster dimension; the wrapper refuses a
// shape whose CTA does not fit, and a cluster that cannot be scheduled
// comes back as the launch error.
//
// What bounds it on an H100: device memory sees 2S int64 segments in and
// L int64 limbs out per coefficient; the 3t transforms, the SAU networks
// and the limb sums are integer work of a larger order (the operation
// bound).  At n = 4096, t = 6 a row takes 6 CTAs of 256 threads and
// about 50 KB each, so up to four CTAs share an SM and a one-row call
// spreads over 6 SMs.
#include <cooperative_groups.h>

#include "parentt.cuh"

namespace cg = cooperative_groups;
using namespace parentt;

namespace {

constexpr int kMaxCluster = 8;
// Two 512-thread CTAs (four of 256) an SM: at most 64 registers a thread
// in the lazy regimes.  The strict regime (v = 31) needs more and keeps
// one CTA of 512 (two of 256) rather than spill.
constexpr int kMinBlocks = 2;

struct E2EArgs {
  const i64* za;
  const i64* zb;
  i64* out;
  // per-channel scalars (t,)
  const i64* qs;
  const i64* half;
  const i64* eps;
  const i64* tilde;
  // per-channel tables (t, n)
  const i64* fwd;
  const i64* inv;
  const i64* fwd_sh;
  const i64* inv_sh;
  // per-channel decompose circuits
  DecomposeTables dec;
  // compose
  const i64* star;     // (t, L): q^_i limbs
  const i64* q_limbs;  // (L,)
  int log_n;
  int t;
  int S;
  int L;
  int w;
  int mode;
  int window;
  int beta;
  int s1;
  int s2;
  int cluster;  // C: CTAs per row
  int slots;    // channels a CTA owns at most: ceil(t / C)
  int group;    // K: stages per register pass
  int dc;       // coefficients an operand a decompose chunk
  int cc;       // coefficients a compose chunk
};

// C = min(t, 8) CTAs a row, each owning at most ceil(t / C) channels
// (kernels/ntt.py e2e_cluster mirrors it for plan admission).
int cluster_of(int t) { return t < kMaxCluster ? t : kMaxCluster; }
int slots_of(int t) { return (t + cluster_of(t) - 1) / cluster_of(t); }

// Shared memory of a CTA (kernels/ntt.py e2e_smem_bytes mirrors it): the
// residue polynomials (rounded to 16), the channels' circuits, and the
// staging of a decompose chunk's segments (dc coefficients an operand) or
// a compose chunk's limbs (cc coefficients), dc and cc as large as what is
// left of kMaxSmem holds, up to half the threads and all of them.
struct E2EGeom {
  long long res, table, smem;
  int dc, cc;
};

E2EGeom e2e_geom(int n, int t, int S, int L) {
  E2EGeom g;
  const int T = pass_threads(n);
  g.res = ((long long)slots_of(t) * 2 * padded(n) * sizeof(res_t) + 15) / 16 * 16;
  g.table = decompose_table_bytes(t);
  const long long room = kMaxSmem - g.res - g.table;
  g.dc = fit_chunk(T / 2, room, 2LL * S * sizeof(i64));
  g.cc = fit_chunk(T, room, (long long)L * sizeof(i64));
  const long long in = 2LL * g.dc * S, out = (long long)g.cc * L;
  g.smem = g.res + g.table + (in > out ? in : out) * (long long)sizeof(i64);
  return g;
}

template <int REG, int MAXL>
__global__ void __launch_bounds__(kMaxThreads, REG == kStrict ? 1 : kMinBlocks)
    fused_e2e_polymul_kernel(const E2EArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = args.cluster;
  const int rank = (int)cluster.block_rank();
  const size_t row = blockIdx.x / C;
  const int n = 1 << args.log_n;
  const int PS = padded(n);  // polynomial stride in shared memory
  const int T = blockDim.x;
  const int S = args.S, L = args.L, t = args.t;
  const size_t res_bytes = ((size_t)args.slots * 2 * PS * sizeof(res_t) + 15) / 16 * 16;
  res_t* res = reinterpret_cast<res_t*>(smem_raw);  // (slots, 2, PS)
  const DecomposeShared dsh = load_decompose(smem_raw + res_bytes, args.dec);
  i64* stage = reinterpret_cast<i64*>(smem_raw + res_bytes + decompose_table_bytes(t));
  const int j0 = (rank * n + C - 1) / C;
  const int j1 = ((rank + 1) * n + C - 1) / C;

  cluster.sync();  // every CTA of the cluster runs before any DSMEM store

  // Step 1: decompose this CTA's slice of both operands into every
  // channel, each residue stored in its owner's shared memory.
  cluster_decompose<REG != kStrict>(
      cluster, res, PS, C, t, S, j0, j1, args.dc, stage, dsh,
      [&](i64* sa, i64* sb, int jc, int cnt) {
        const size_t seg = (row * n + jc) * S;
        stage_words(sa, args.za + seg, cnt * S);
        stage_words(sb, args.zb + seg, cnt * S);
      });
  cluster.sync();

  // Steps 2-3: the cascade and y_i = p_i * q~_i mod q_i per owned channel.
  for (int slot = 0; slot < args.slots; ++slot) {
    const int c = rank + slot * C;
    if (c >= t) break;
    const Reduce r = regime_reduce<REG>(args.qs, args.half, args.eps, c, args.mode, args.window,
                                        args.beta, args.s1, args.s2, dsh.ch[c].block_m);
    const size_t tab = (size_t)c * n;
    const ChannelTabs tb{args.fwd + tab, args.inv + tab, args.fwd_sh + tab, args.inv_sh + tab};
    res_t* A = res + (size_t)slot * 2 * PS;
    channel_cascade(A, A + PS, SharedPolys<2>{{A, A + PS}}, SharedPolys<1>{{A}},
                    TildeProduct{(res_t)args.tilde[c]}, args.log_n, args.group, tb, r);
  }
  cluster.sync();

  // Step 4: Eq-10 limb sums over the peers' y, the compose tail, and the
  // (chunk, L) limbs staged and written coalesced.
  cluster_compose<MAXL>(cluster, res, 2 * PS, C, t, L, args.w, j0, j1, args.cc,
                                 args.star, args.q_limbs, stage, dsh,
                                 [&](const i64* st, int jc, int cnt) {
                                   i64* po = args.out + (row * n + jc) * L;
                                   for (int i = threadIdx.x; i < cnt * L; i += T) po[i] = st[i];
                                 });
  cluster.sync();  // peers have read this CTA's y before it exits
}

typedef void (*E2EKernel)(const E2EArgs);

E2EKernel pick_kernel(int mode, int window, int L) {
  const int reg = regime_of(mode, window);
  static const E2EKernel kernels[3][2] = {
      {fused_e2e_polymul_kernel<kLazy2, 8>, fused_e2e_polymul_kernel<kLazy2, 16>},
      {fused_e2e_polymul_kernel<kLazy4, 8>, fused_e2e_polymul_kernel<kLazy4, 16>},
      {fused_e2e_polymul_kernel<kStrict, 8>, fused_e2e_polymul_kernel<kStrict, 16>},
  };
  return kernels[reg][L <= 8 ? 0 : 1];
}

// The launch configuration of one call; `attr` must outlive `cfg`.
cudaLaunchConfig_t e2e_config(int rows, int n, int t, const E2EGeom& geo, cudaStream_t stream,
                              cudaLaunchAttribute* attr) {
  const int cluster = cluster_of(t);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)rows * cluster, 1, 1);
  cfg.blockDim = dim3(pass_threads(n), 1, 1);
  cfg.dynamicSmemBytes = (size_t)geo.smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The geometry of (n, t, S, L), or cudaErrorInvalidValue where one CTA's
// shared memory cannot hold it, with the kernel opted in to its shared
// memory.
cudaError_t prepare(E2EKernel kernel, int n, int t, int S, int L, E2EGeom* geo) {
  *geo = e2e_geom(n, t, S, L);
  if (geo->dc < 1 || geo->cc < 1 || geo->smem > kMaxSmem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)geo->smem);
}

}  // namespace

extern "C" {

// Launches the e2e multiplier on `stream` as clusters of min(t, 8) CTAs
// per row; returns the CUDA error of the attribute call or the launch
// (0 = launched).
int parentt_fused_e2e_polymul(
    const long long* za, const long long* zb, long long* out, const long long* qs,
    const long long* half, const long long* eps, const long long* tilde, const long long* fwd,
    const long long* inv, const long long* fwd_shoup, const long long* inv_shoup,
    const long long* sau_beta, const long long* sau_eps, const long long* sau_s2,
    const long long* horner, const long long* block_m, const long long* star,
    const long long* q_limbs, int rows, int log_n, int t, int S, int L, int dec_s1, int w,
    int mode, int window, int beta, int s1, int s2, void* stream) {
  const int n = 1 << log_n;
  const E2EKernel kernel = pick_kernel(mode, window, L);
  E2EGeom geo;
  cudaError_t err = prepare(kernel, n, t, S, L, &geo);
  if (err != cudaSuccess) return (int)err;
  const DecomposeTables dec{qs, sau_beta, sau_eps, sau_s2, horner, block_m, t, dec_s1};
  const E2EArgs args{za,        zb,     out,  qs,      half,  eps, tilde, fwd,
                     inv,       fwd_shoup, inv_shoup, dec, star, q_limbs, log_n, t,
                     S,         L,      w,    mode,    window, beta, s1, s2,
                     cluster_of(t), slots_of(t), pass_group(n), geo.dc, geo.cc};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = e2e_config(rows, n, t, geo, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many clusters of the kernel the card holds at once for this shape
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int parentt_fused_e2e_max_clusters(int log_n, int t, int S, int L, int mode, int window) {
  const int n = 1 << log_n;
  const E2EKernel kernel = pick_kernel(mode, window, L);
  E2EGeom geo;
  cudaError_t err = prepare(kernel, n, t, S, L, &geo);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = e2e_config(1, n, t, geo, nullptr, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, (void*)kernel, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
