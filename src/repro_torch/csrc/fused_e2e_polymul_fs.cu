// Fused end-to-end multiplier as a multi-block kernel (K2-fs): SAU
// decompose -> per-channel NTT(a) (.) NTT(b) -> iNTT -> Eq-10 compose,
// segments (rows, n, S) x 2 -> product limbs (rows, n, L), for n whose two
// operands do not fit one CTA's shared memory (n = 32768 and 65536 on the
// card), and any n >= 16, at any t whose CTAs fit (e2e_fs_geom).
//
// Replaces the four-step body of the TPU kernel fused_e2e_polymul_pallas
// (src/repro/kernels/ntt.py:802, bodies :479 and :530 under
// schedule="four_step"), on the card's own two-level split (parentt.cuh,
// "Multi-block transforms").  No int64 residue reaches device memory: the
// residues and the products' y go between the launches as 32-bit words.
//
// Design: three streaming launches, none of whose CTAs' shared memory
// grows with t, and none waiting behind another stage's cluster barrier:
//   1. decompose both operands (K5's Horner body, parentt.cuh decompose):
//      a CTA walks kDecTiles tiles of TR coefficients of one operand
//      (blockIdx.y), double-buffered:
//      tile i + 1's segments are in flight (cp.async, stage_words_async)
//      while tile i is decomposed.  Its TR x G threads all work: thread
//      (j, g) takes coefficient j in the channels g, g + G, ... (G channel
//      groups, dec_groups), and stores each canonical residue as a 32-bit
//      word to (t, rows, n): consecutive threads, consecutive words.  The
//      segments are read once for all t channels.
//   2. the cascade of each (channel, row) pair on the 32-bit residues:
//      past one CTA (n > 16384) K1-fs's cluster (parentt.cuh
//      cluster_cascade, of the size the caller names: kernels/ntt.py
//      fs_cluster), below it K1's own kernel and launch (parentt.cuh
//      pair_cascade_kernel on TildePair), each reading 32-bit words and
//      storing y = canonical(p) * q~ mod q as 32-bit words over the first
//      operand's residues (TildeOut).
//   3. the compose: K6's kernel (parentt.cuh compose_kernel) on the y
//      words, its quotient tail and limb sums, the limbs written in runs.
// The regime (lazy W = 2, lazy W = 4, strict) and the limb chunk are
// template parameters.  The wrapper refuses a shape whose CTAs do not
// fit, and a cluster that cannot be scheduled comes back as the launch
// error.
//
// What bounds it on an H100: device memory sees 2S int64 segments in and
// L int64 limbs out a coefficient, and 24t bytes of 32-bit words between
// the launches (two residues written and read, one y written and read a
// channel): 16S + 24t + 8L bytes, 296 at S = t = 6, L = 7.  The 3t
// transforms, the SAU networks and the limb sums are integer work of the
// same order (the operation bound).
#include <cooperative_groups.h>

#include "parentt.cuh"

namespace cg = cooperative_groups;
using namespace parentt;

namespace {

constexpr int kDecThreads = 256;  // threads of a decompose CTA at most
constexpr int kDecTiles = 4;      // tiles a decompose CTA walks

// G, the channel groups of a decompose CTA: min(8, ceil(t / 3)), so a
// thread decomposes about three channels of its coefficient (2 groups at
// t = 6, 5 at t = 15, 8 at t = 30; kernels/ntt.py dec_groups).
int dec_groups(int t) { return (t + 2) / 3 < 8 ? (t + 2) / 3 : 8; }

// A decompose CTA's geometry: TR coefficients a tile (0 where not one
// fits), G channel groups, and its shared memory (the circuits and two
// tiles of segments); kernels/ntt.py e2e_fs_geom mirrors it.
struct DecGeom {
  int tile, groups;
  long long smem;
};

DecGeom dec_geom(int t, int S) {
  DecGeom g;
  g.groups = dec_groups(t);
  const long long table = decompose_table_bytes(t);
  g.tile = fit_chunk(kDecThreads / g.groups, (kMaxSmem - table) / 2, (long long)S * sizeof(i64));
  g.smem = table + 2LL * g.tile * S * sizeof(i64);
  return g;
}

struct DecArgs {
  const i64* z[2];  // (rows * n, S) segments of a and b
  res_t* out[2];    // (t, rows * n) 32-bit residues of a and b
  DecomposeTables dec;
  i64 coeffs;  // rows * n
  int S;
  int tile;    // TR
  int groups;  // G
};

template <bool NARROW>
__global__ void __launch_bounds__(kDecThreads) e2e_fs_decompose_kernel(const DecArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DecomposeShared dsh = load_decompose(smem_raw, a.dec);
  i64* stage = reinterpret_cast<i64*>(smem_raw + decompose_table_bytes(a.dec.t));
  const int TR = a.tile, S = a.S;
  // blockIdx.y: the operand (a picked by a select: a parameter array
  // indexed at run time would be copied to local memory)
  const i64* const z = blockIdx.y ? a.z[1] : a.z[0];
  res_t* const out = blockIdx.y ? a.out[1] : a.out[0];
  const i64 first = (i64)blockIdx.x * kDecTiles * TR;  // the first coefficient of tile 0
  const int tiles = (int)min((i64)kDecTiles, (a.coeffs - first + TR - 1) / TR);
  const int j = threadIdx.x % TR;
  const int g = threadIdx.x / TR;
  const auto issue = [&](int i) {  // tile i into buffer i & 1
    const i64 c0 = first + (i64)i * TR;
    stage_words_async(stage + (i & 1) * TR * S, z + c0 * S, (int)(min((i64)TR, a.coeffs - c0) * S));
  };
  issue(0);
  for (int i = 0; i < tiles; ++i) {
    if (i + 1 < tiles) {
      issue(i + 1);
      wait_staged<1>();
    } else {
      wait_staged<0>();
    }
    __syncthreads();  // tile i (and, the first time, the circuits) landed
    const i64 c = first + (i64)i * TR + j;
    if (c < a.coeffs) {
      const i64* zc = stage + (i & 1) * TR * S + j * S;
      for (int ch = g; ch < dsh.t; ch += a.groups) {
        out[(size_t)ch * a.coeffs + c] = (res_t)decompose<NARROW>(zc, S, dsh.ch[ch], dsh.s1);
      }
    }
    __syncthreads();  // tile i read before its buffer is refilled
  }
}

// K2-fs's cascade past one CTA: K1-fs's cluster on 32-bit residues, y
// over the first operand's.
template <int REG>
__global__ void __launch_bounds__(kMaxThreads, 2)
    e2e_fs_cascade_kernel(const FsArgs a, const i64* tilde, const int lc) {
  extern __shared__ res_t smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int pair = blockIdx.x >> lc;
  const int c = pair / a.rows;
  const size_t poly = (size_t)pair << a.log_n;
  const ColMap map = cascade_colmap(a.log_n, lc, (int)cluster.block_rank());
  cluster_cascade(cluster, (const res_t*)a.scratch[0] + poly, (const res_t*)a.scratch[1] + poly,
                  TildeOut<ColMap>{a.scratch[0] + poly, map, (res_t)tilde[c]}, smem, a.log_n, lc,
                  fs_tabs(a, c), fs_reduce<REG>(a, c));
}

const void* cluster_kernel(int mode, int window) {
  static const void* kernels[3] = {(const void*)e2e_fs_cascade_kernel<kLazy2>,
                                   (const void*)e2e_fs_cascade_kernel<kLazy4>,
                                   (const void*)e2e_fs_cascade_kernel<kStrict>};
  return kernels[regime_of(mode, window)];
}

typedef void (*ComposeKernel)(const ComposeArgs);

}  // namespace

extern "C" {

// Launch 1 on `stream`: za, zb (rows * n, S) -> ra, rb (t, rows * n)
// 32-bit residues; `narrow`: every q below 2^30.  Returns the CUDA error
// (cudaErrorInvalidValue where a CTA cannot hold one coefficient's
// segments beside the circuits).
int parentt_e2e_fs_decompose(const long long* za, const long long* zb, int* ra, int* rb,
                             const long long* qs, const long long* sau_beta,
                             const long long* sau_eps, const long long* sau_s2,
                             const long long* horner, const long long* block_m, long long coeffs,
                             int t, int S, int dec_s1, int narrow, void* stream) {
  const DecGeom geo = dec_geom(t, S);
  if (geo.tile < 1 || geo.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  const DecArgs args{{za, zb},
                     {(res_t*)ra, (res_t*)rb},
                     {qs, sau_beta, sau_eps, sau_s2, horner, block_m, t, dec_s1},
                     coeffs,
                     S,
                     geo.tile,
                     geo.groups};
  const long long per_block = (long long)kDecTiles * geo.tile;  // coefficients a CTA
  void (*kernel)(const DecArgs) =
      narrow ? e2e_fs_decompose_kernel<true> : e2e_fs_decompose_kernel<false>;
  const cudaError_t err = allow_smem(kernel, (size_t)geo.smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3((unsigned)((coeffs + per_block - 1) / per_block), 2), geo.tile * geo.groups,
           (size_t)geo.smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// Launch 2 on `stream`: the cascade of ra, rb (t, rows, n) 32-bit residues,
// y = p q~ mod q over ra: K1's one-CTA body where one CTA holds a pair
// (lc = 0), else K1-fs's clusters of 2^lc CTAs.  Returns the CUDA error
// (cudaErrorInvalidValue for lc = 0 where one CTA does not hold a pair).
int parentt_e2e_fs_cascade(int* ra, int* rb, const long long* qs, const long long* half,
                           const long long* eps, const long long* tilde, const long long* fwd,
                           const long long* inv, const long long* fwd_shoup,
                           const long long* inv_shoup, int t, int rows, int log_n, int mode,
                           int window, int beta, int s1, int s2, int lc, void* stream) {
  const FsArgs args{{nullptr, nullptr}, {(res_t*)ra, (res_t*)rb},
                    nullptr,            qs,
                    half,               eps,
                    fwd,                inv,
                    fwd_shoup,          inv_shoup,
                    rows,               log_n,
                    mode,               window,
                    beta,               s1,
                    s2};
  if (lc == 0) {
    if (!pair_fits(log_n)) return (int)cudaErrorInvalidValue;
    return launch_pair_cascade<TildePair>(args, tilde, t * rows, (cudaStream_t)stream);
  }
  void* params[] = {(void*)&args, (void*)&tilde, (void*)&lc};
  return launch_cluster_cascade(cluster_kernel(mode, window), params, t * rows, log_n, lc,
                                (cudaStream_t)stream);
}

// Launch 3 on `stream`: y (t, coeffs) 32-bit words -> limbs (coeffs, L).
// Returns the CUDA error (cudaErrorInvalidValue where a CTA cannot hold
// one coefficient's limbs beside the channels' table).
int parentt_e2e_fs_compose(const int* y, long long* out, const long long* qs,
                           const long long* star, const long long* q_limbs, long long coeffs,
                           int t, int L, int w, void* stream) {
  static const ComposeKernel kernels[3] = {compose_kernel<true, 8, kComposeMinBlocks, true>,
                                           compose_kernel<true, 16, 3, true>,
                                           compose_kernel<true, 16, 2, true>};
  const ComposeArgs args{nullptr, (const res_t*)y, out, qs, nullptr, nullptr, star, q_limbs,
                         coeffs,  t,               L,   w,  0};
  const int R = compose_rows_of(t, L);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(compose_table_bytes(t) + (long long)R * L * sizeof(i64));
  const ComposeKernel kernel = kernels[compose_variant(t, L)];
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((coeffs + R - 1) / R), R, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

// The three launches on `stream` (ra, rb: (t, rows, n) 32-bit words each;
// y goes over ra); returns the CUDA error of the first that fails.
int parentt_fused_e2e_polymul_fs(
    const long long* za, const long long* zb, int* ra, int* rb, long long* out,
    const long long* qs, const long long* half, const long long* eps, const long long* tilde,
    const long long* fwd, const long long* inv, const long long* fwd_shoup,
    const long long* inv_shoup, const long long* sau_beta, const long long* sau_eps,
    const long long* sau_s2, const long long* horner, const long long* block_m,
    const long long* star, const long long* q_limbs, int rows, int log_n, int t, int S, int L,
    int dec_s1, int w, int mode, int window, int beta, int s1, int s2, int narrow, int lc,
    void* stream) {
  const long long coeffs = (long long)rows << log_n;
  int err = parentt_e2e_fs_decompose(za, zb, ra, rb, qs, sau_beta, sau_eps, sau_s2, horner,
                                     block_m, coeffs, t, S, dec_s1, narrow, stream);
  if (err != 0) return err;
  err = parentt_e2e_fs_cascade(ra, rb, qs, half, eps, tilde, fwd, inv, fwd_shoup, inv_shoup, t,
                               rows, log_n, mode, window, beta, s1, s2, lc, stream);
  if (err != 0) return err;
  return parentt_e2e_fs_compose(ra, out, qs, star, q_limbs, coeffs, t, L, w, stream);
}

// How many clusters of 2^lc CTAs of the cascade launch the card holds at
// once at this n and regime (cudaOccupancyMaxActiveClusters; lc = 0, K1's
// one-CTA body: its CTAs an SM holds, times the SMs), or minus the CUDA
// error.
int parentt_fused_e2e_polymul_fs_max_clusters(int log_n, int mode, int window, int lc) {
  if (lc > 0) return cascade_clusters(cluster_kernel(mode, window), log_n, lc);
  const int count = pair_blocks_per_sm<TildePair>(log_n, mode, window);
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  return count < 0 ? count : count * sms;
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
