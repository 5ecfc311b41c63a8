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
// residues of a column tile live in a cluster's shared memory from the
// decompose to the column stages, and the products' y from the inverse
// column stages to the compose.
//
// Design: three launches over E = min(n, 4096)-element tiles,
// pass_threads(E) threads a CTA (256):
//   1. forward columns with decompose: one thread-block cluster of
//      C = min(t, 8) CTAs per (row, column tile), launched through
//      cudaLaunchKernelEx as K2 is; CTA r owns K2's slots, the channels
//      r, r + C, ... (one at t <= 8), each as two padded tiles.  CTA r
//      reads the segments of its slice of the tile's E coefficients (n1
//      rows x E/n1 adjacent columns, ColMap) once, runs every channel's
//      SAU circuit on them and stores each residue into the owning CTA's
//      shared memory over DSMEM (K2's cluster_decompose); after
//      cluster.sync() it runs the forward column stages of each of its
//      channels on both operands and stores their lazy values as 32-bit
//      words to two (t, rows, n) scratch tensors.  A cluster reads the
//      segments once, where t independent CTAs would read them t times.
//   2. rows: K1-fs's row launch (parentt.cuh fs_rows_cascade): the
//      forward row stages, the canonical pointwise product and the inverse
//      row stages, the product's lazy values over a's scratch.
//   3. inverse columns with compose, the geometry of launch 1: CTA r runs
//      the inverse column stages of each of its channels, whose last pass
//      forms y = canonical(p) * q~ mod q in a shared tile a slot; after
//      cluster.sync() it composes its slice from every peer's y with K2's
//      quotient tail (cluster_compose), stages the limbs and writes them in
//      row segments of E/n1 coefficients x L words; a last cluster.sync()
//      keeps its shared memory alive until every peer has read it.
// The regime (lazy W = 2, lazy W = 4, strict) and the limb chunk MAXL (8
// for L <= 8, else 16-limb chunks) are template parameters, as in K2;
// the channels' circuits and the staging live in dynamic shared memory
// after the tiles, the chunks as large as what is left of 227 KB holds.
// The wrapper refuses a shape whose CTAs do not fit, and a cluster that
// cannot be scheduled comes back as the launch error.
//
// What bounds it on an H100: device memory sees 2S int64 segments in and
// L int64 limbs out per coefficient (152 bytes at S = 6, L = 7), and the
// split adds the 32-bit scratch: two words written by launch 1 and read by
// launch 2, one written back and read by launch 3 (144 bytes at t = 6,
// 296 in all).  The 3t transforms, the SAU networks and the limb sums are
// integer work of the same order (the operation bound).
#include <cooperative_groups.h>

#include "parentt.cuh"

namespace cg = cooperative_groups;
using namespace parentt;

namespace {

constexpr int kMaxCluster = 8;

struct E2EFsArgs {
  FsArgs fs;  // the transforms' tables, regime, scratch; fs.in and fs.out unused
  const i64* za;
  const i64* zb;
  i64* out;
  const i64* tilde;  // (t,) q~_i
  DecomposeTables dec;
  const i64* star;     // (t, L): q^_i limbs
  const i64* q_limbs;  // (L,)
  int t;
  int S;
  int L;
  int w;
  int cluster;  // C = min(t, 8): CTAs per (row, column tile)
  int slots;    // channels a CTA owns at most: ceil(t / C)
  int dc;       // coefficients an operand a decompose chunk (pass 0)
  int cc;       // coefficients a compose chunk (pass 2)
};

int cluster_of(int t) { return t < kMaxCluster ? t : kMaxCluster; }
int slots_of(int t) { return (t + cluster_of(t) - 1) / cluster_of(t); }

// Bytes of `npoly` padded tiles, rounded to 16 for the table after them.
__host__ __device__ inline long long tiles_bytes(int E, int npoly) {
  return ((long long)npoly * padded(E) * sizeof(res_t) + 15) / 16 * 16;
}

// Dynamic shared memory of each pass (kernels/ntt.py e2e_fs_smem_bytes
// mirrors it): pass 0 (forward columns) holds both operands' tiles of
// each slot, the channels' circuits and dc coefficients' segments an
// operand; pass 1 (rows) K1-fs's two tiles; pass 2 (inverse columns) the
// y tile of each slot, the circuits (1/q) and cc coefficients' limbs.
struct E2EFsGeom {
  long long smem[3];
  int dc, cc;
};

E2EFsGeom e2e_fs_geom(int log_n, int t, int S, int L) {
  E2EFsGeom g;
  const int E = 1 << (log_n < kLogFsTile ? log_n : kLogFsTile);
  const int T = pass_threads(E);
  const int slots = slots_of(t);
  const long long table = decompose_table_bytes(t);
  const long long cols = tiles_bytes(E, 2 * slots) + table;
  g.dc = fit_chunk(T / 2, kMaxSmem - cols, 2LL * S * sizeof(i64));
  g.smem[0] = cols + 2LL * g.dc * S * sizeof(i64);
  g.smem[1] = (long long)fs_smem(log_n, 2);
  const long long inv = tiles_bytes(E, slots) + table;
  g.cc = fit_chunk(T, kMaxSmem - inv, (long long)L * sizeof(i64));
  g.smem[2] = inv + (long long)g.cc * L * sizeof(i64);
  return g;
}

bool fits(const E2EFsGeom& g) {
  return g.dc >= 1 && g.cc >= 1 && g.smem[0] <= kMaxSmem && g.smem[1] <= kMaxSmem &&
         g.smem[2] <= kMaxSmem;
}

// Where a CTA of a cluster launch sits: its row, column tile and rank
// (its channels rank, rank + C, ...), and the tile's ColMap.
struct ClusterGeom {
  FsGeom g;  // split and tile; g.c and g.poly unused
  size_t row;
  int rank;
  ColMap map;
  // offset of channel c's polynomial of this row in a (t, rows, n) tensor
  __device__ __forceinline__ size_t poly(int c, int rows) const {
    return ((size_t)c * rows + row) << g.log_n;
  }
};

__device__ __forceinline__ ClusterGeom cluster_geom(cg::cluster_group& cluster,
                                                    const E2EFsArgs& a) {
  ClusterGeom geo;
  FsGeom& g = geo.g;
  const int C = a.cluster;
  g.log_n = a.fs.log_n;
  g.log_n2 = (g.log_n + 1) / 2;
  g.log_n1 = g.log_n - g.log_n2;
  g.log_e = g.log_n < kLogFsTile ? g.log_n : kLogFsTile;
  g.log_c = g.log_e - g.log_n1;
  const int tiles_log = g.log_n - g.log_e;
  const int tile = blockIdx.x / C;  // the cluster's (row, column tile)
  g.blk = tile & ((1 << tiles_log) - 1);
  geo.row = (size_t)(tile >> tiles_log);
  geo.rank = (int)cluster.block_rank();
  geo.map = ColMap{g.log_c, g.log_n2, g.blk << g.log_c};
  return geo;
}

// y = canonical(p) * q~ mod q into a shared tile: the inverse column
// stages' last store.
struct TildeTile {
  res_t* poly;
  TildeProduct y;
  __device__ __forceinline__ void store(int, int i, res_t x, const Reduce& r) const {
    poly[pad(i)] = y(x, r);
  }
};

template <int REG>
__global__ void __launch_bounds__(kFsThreads, REG == kStrict ? 2 : 4)
    e2e_fs_cols_kernel(const E2EFsArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterGeom geo = cluster_geom(cluster, a);
  const FsGeom& g = geo.g;
  const int C = a.cluster;
  const int E = 1 << g.log_e;
  const int PS = padded(E);
  const int S = a.S;
  const long long tiles = tiles_bytes(E, 2 * a.slots);
  res_t* res = reinterpret_cast<res_t*>(smem_raw);  // (slots, 2, PS): a, b of each channel
  const DecomposeShared dsh = load_decompose(smem_raw + tiles, a.dec);
  i64* stage = reinterpret_cast<i64*>(smem_raw + tiles + decompose_table_bytes(a.t));
  const int j0 = (geo.rank * E + C - 1) / C;
  const int j1 = ((geo.rank + 1) * E + C - 1) / C;
  const size_t row0 = geo.row << g.log_n;  // the row's first coefficient

  cluster.sync();  // every CTA of the cluster runs before any DSMEM store

  // the tile's virtual elements jc .. jc + cnt - 1, gathered through ColMap:
  // runs of E/n1 coefficients x S contiguous words
  cluster_decompose<REG != kStrict>(
      cluster, res, PS, C, a.t, S, j0, j1, a.dc, stage, dsh,
      [&](i64* sa, i64* sb, int jc, int cnt) {
        for (int i = threadIdx.x; i < cnt * S; i += blockDim.x) {
          const int j = i / S;
          const size_t at = (row0 + geo.map(jc + j)) * S + (i - j * S);
          sa[i] = __ldg(a.za + at);
          sb[i] = __ldg(a.zb + at);
        }
      });
  cluster.sync();

  // the forward column stages of each owned channel on both operands, from
  // the shared tiles to the 32-bit scratch
  for (int slot = 0; slot < a.slots; ++slot) {
    const int c = geo.rank + slot * C;
    if (c >= a.t) break;
    const Reduce r = fs_reduce<REG>(a.fs, c);
    res_t* A = res + (size_t)slot * 2 * PS;
    const TilePolys<2> tile{{A, A + PS}, 0};
    const size_t poly = geo.poly(c, a.fs.rows);
    const ScratchOut<2, ColMap> out{{a.fs.scratch[0] + poly, a.fs.scratch[1] + poly}, geo.map};
    forward_stages<2>(tile, tile, out, 0, g.log_n1, g.log_e, 0, g.log_e, pass_group(E),
                      fs_tabs(a.fs, c), r);
  }
}

template <int REG>
__global__ void __launch_bounds__(kFsThreads, 4) e2e_fs_rows_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  fs_rows_cascade<REG>(a, smem);
}

template <int REG, int MAXL>
__global__ void __launch_bounds__(kFsThreads, REG == kStrict ? 2 : 4)
    e2e_fs_inv_cols_kernel(const E2EFsArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterGeom geo = cluster_geom(cluster, a);
  const FsGeom& g = geo.g;
  const int C = a.cluster;
  const int E = 1 << g.log_e;
  const int PS = padded(E);
  const int L = a.L;
  const long long tiles = tiles_bytes(E, a.slots);
  res_t* res = reinterpret_cast<res_t*>(smem_raw);  // (slots, PS): y of each owned channel
  // 1 / q of every channel for the quotient
  const DecomposeShared dsh = load_decompose(smem_raw + tiles, a.dec);
  i64* stage = reinterpret_cast<i64*>(smem_raw + tiles + decompose_table_bytes(a.t));
  const int j0 = (geo.rank * E + C - 1) / C;
  const int j1 = ((geo.rank + 1) * E + C - 1) / C;
  const size_t row0 = geo.row << g.log_n;

  // the inverse column stages of each owned channel, from the scratch to y
  // in its shared tile
  for (int slot = 0; slot < a.slots; ++slot) {
    const int c = geo.rank + slot * C;
    if (c >= a.t) break;
    const Reduce r = fs_reduce<REG>(a.fs, c);
    res_t* Y = res + (size_t)slot * PS;
    const GlobalIn<res_t, 1, ColMap> in{{a.fs.scratch[0] + geo.poly(c, a.fs.rows)}, geo.map};
    const TilePolys<1> tile{{Y}, 0};
    const TildeTile y{Y, TildeProduct{(res_t)a.tilde[c]}};
    inverse_stages(in, tile, y, g.log_c, g.log_e, g.log_e, 0, g.log_e, pass_group(E),
                   fs_tabs(a.fs, c), r);
  }
  cluster.sync();  // every peer's y stored

  // the compose of this CTA's slice, its limbs written through ColMap:
  // runs of E/n1 coefficients x L contiguous words
  cluster_compose<MAXL>(cluster, res, PS, C, a.t, L, a.w, j0, j1, a.cc, a.star,
                                 a.q_limbs, stage, dsh, [&](const i64* st, int jc, int cnt) {
                                   for (int i = threadIdx.x; i < cnt * L; i += blockDim.x) {
                                     const int j = i / L;
                                     a.out[(row0 + geo.map(jc + j)) * L + (i - j * L)] = st[i];
                                   }
                                 });
  cluster.sync();  // peers have read this CTA's y before it exits
}

// pass 0: forward columns with decompose, 2: inverse columns with compose
// (clusters, templated on the regime and, pass 2, the limb chunk);
// pass 1: rows (K1-fs's row launch, on a.fs).
const void* pick_kernel(int pass, int mode, int window, int L) {
  const int reg = regime_of(mode, window);
  static const void* cols[3] = {(const void*)e2e_fs_cols_kernel<kLazy2>,
                                (const void*)e2e_fs_cols_kernel<kLazy4>,
                                (const void*)e2e_fs_cols_kernel<kStrict>};
  static const void* rows[3] = {(const void*)e2e_fs_rows_kernel<kLazy2>,
                                (const void*)e2e_fs_rows_kernel<kLazy4>,
                                (const void*)e2e_fs_rows_kernel<kStrict>};
  static const void* inv[3][2] = {
      {(const void*)e2e_fs_inv_cols_kernel<kLazy2, 8>,
       (const void*)e2e_fs_inv_cols_kernel<kLazy2, 16>},
      {(const void*)e2e_fs_inv_cols_kernel<kLazy4, 8>,
       (const void*)e2e_fs_inv_cols_kernel<kLazy4, 16>},
      {(const void*)e2e_fs_inv_cols_kernel<kStrict, 8>,
       (const void*)e2e_fs_inv_cols_kernel<kStrict, 16>}};
  if (pass == 0) return cols[reg];
  if (pass == 1) return rows[reg];
  return inv[reg][L <= 8 ? 0 : 1];
}

// The launch configuration of pass `pass`; `attr` must outlive `cfg`.
cudaLaunchConfig_t pass_config(int pass, int rows, int log_n, int t, const E2EFsGeom& geo,
                               cudaStream_t stream, cudaLaunchAttribute* attr) {
  const int cluster = pass == 1 ? 1 : cluster_of(t);
  cudaLaunchConfig_t cfg = {};
  // a cluster launch: C CTAs per (row, tile); the row launch: one CTA per
  // (channel, row, tile)
  cfg.gridDim = dim3((unsigned)fs_blocks(pass == 1 ? t : cluster, rows, log_n), 1, 1);
  cfg.blockDim = dim3(fs_threads(log_n), 1, 1);
  cfg.dynamicSmemBytes = (size_t)geo.smem[pass];
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pass == 1 ? 0 : 1;
  return cfg;
}

cudaError_t allow_pass_smem(const void* kernel, long long bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// Launches the three passes on `stream` (scratch_a, scratch_b: (t, rows, n)
// 32-bit words each); returns the CUDA error of an attribute call or a
// launch (0 = launched; cudaErrorInvalidValue where a CTA's shared memory
// cannot hold the shape, which the wrapper refuses first).
int parentt_fused_e2e_polymul_fs(
    const long long* za, const long long* zb, int* scratch_a, int* scratch_b, long long* out,
    const long long* qs, const long long* half, const long long* eps, const long long* tilde,
    const long long* fwd, const long long* inv, const long long* fwd_shoup,
    const long long* inv_shoup, const long long* sau_beta, const long long* sau_eps,
    const long long* sau_s2, const long long* horner, const long long* block_m,
    const long long* star, const long long* q_limbs, int rows, int log_n, int t, int S, int L,
    int dec_s1, int w, int mode, int window, int beta, int s1, int s2, void* stream) {
  const E2EFsGeom geo = e2e_fs_geom(log_n, t, S, L);
  if (!fits(geo)) return (int)cudaErrorInvalidValue;
  const FsArgs fs{{nullptr, nullptr}, {(res_t*)scratch_a, (res_t*)scratch_b},
                  nullptr,            qs,
                  half,               eps,
                  fwd,                inv,
                  fwd_shoup,          inv_shoup,
                  rows,               log_n,
                  mode,               window,
                  beta,               s1,
                  s2};
  const DecomposeTables dec{qs, sau_beta, sau_eps, sau_s2, horner, block_m, t, dec_s1};
  const E2EFsArgs args{fs, za, zb,           out,         tilde,  dec,   star, q_limbs,
                       t,  S,  L,            w,           cluster_of(t), slots_of(t),
                       geo.dc, geo.cc};
  for (int pass = 0; pass < 3; ++pass) {
    const void* kernel = pick_kernel(pass, mode, window, L);
    cudaError_t err = allow_pass_smem(kernel, geo.smem[pass]);
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = pass_config(pass, rows, log_n, t, geo, (cudaStream_t)stream,
                                               &attr);
    void* params[] = {pass == 1 ? (void*)&fs : (void*)&args};  // the row launch takes FsArgs
    err = cudaLaunchKernelExC(&cfg, kernel, params);
    if (err != cudaSuccess) return (int)err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// How many clusters of pass 0 or 2 the card holds at once for this shape
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
int parentt_fused_e2e_polymul_fs_max_clusters(int pass, int log_n, int t, int S, int L, int mode,
                                              int window) {
  const E2EFsGeom geo = e2e_fs_geom(log_n, t, S, L);
  if (!fits(geo)) return -(int)cudaErrorInvalidValue;
  const void* kernel = pick_kernel(pass, mode, window, L);
  cudaError_t err = allow_pass_smem(kernel, geo.smem[pass]);
  if (err != cudaSuccess) return -(int)err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = pass_config(pass, 1, log_n, t, geo, nullptr, &attr);
  int count = 0;
  err = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
  return err == cudaSuccess ? count : -(int)err;
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
