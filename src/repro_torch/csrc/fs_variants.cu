// Measurement-only kernels of `python3 chip_smoke.py --transform-variants`
// (no wrapper and no path of the port calls them; the command builds this
// file beside the kernels' own build).  They hold the multi-block
// transforms' earlier design, which K3-fs's and K4-fs's tile streams
// replaced: a column launch and a row launch, one CTA of 256 threads a
// 4096-element tile, the first pass reading device memory a word a thread
// (__ldg), the last writing it, lazy 32-bit words in a (t, rows, n)
// scratch between the two launches.
// Each of the four launches (K3-fs columns then rows, K4-fs rows then
// columns) comes in three forms:
//   * whole: the launch as that design ran it;
//   * copy: the same tile maps and word types with no butterfly: each
//     element read from device memory into the padded tile, a barrier, and
//     stored from the tile as the launch stores it (its memory time);
//   * passes: the launch's passes on a tile already in shared memory (each
//     element set from its index), no device traffic but one word a CTA
//     stored, so nothing is optimised away (its integer time).
// Only the lazy W = 2 regime (v = 30, the measured shapes) is built.
#include "parentt.cuh"

using namespace parentt;

namespace {

enum Variant : int { kWhole = 0, kCopy = 1, kPasses = 2 };

constexpr int kOldThreads = 256;  // pass_threads(4096)

// Where a CTA of a launch sits: its polynomial, channel and tile, and the
// split (the earlier FsGeom).
struct OldGeom {
  int log_n, log_n1, log_n2, log_e, log_c;
  int c;
  size_t poly;
  int blk;
};

__device__ __forceinline__ OldGeom old_geom(int log_n, int rows) {
  OldGeom g;
  g.log_n = log_n;
  g.log_n2 = (log_n + 1) / 2;
  g.log_n1 = log_n - g.log_n2;
  g.log_e = log_n < kLogFsTile ? log_n : kLogFsTile;
  g.log_c = g.log_e - g.log_n1;
  const int tiles_log = log_n - g.log_e;
  const int poly = blockIdx.x >> tiles_log;
  g.blk = blockIdx.x & ((1 << tiles_log) - 1);
  g.c = poly / rows;
  g.poly = (size_t)poly << log_n;
  return g;
}

// 32-bit scratch words stored as they are (the earlier ScratchOut).
template <typename Map>
struct OldScratchOut {
  res_t* poly;
  Map map;
  __device__ __forceinline__ void store(int, int i, res_t x, const Reduce&) const {
    poly[map(i)] = x;
  }
};

// The copy form: every element of the tile's span [x0, x0 + E) read through
// `in` into the tile, and stored from it through `out`.
template <typename In, typename Out>
__device__ __forceinline__ void copy_tile(const In& in, const Out& out, res_t* smem, int x0, int E,
                                          const Reduce& r) {
  for (int j = threadIdx.x; j < E; j += blockDim.x) smem[pad(j)] = in.load(0, x0 + j);
  __syncthreads();
  for (int j = threadIdx.x; j < E; j += blockDim.x) out.store(0, x0 + j, smem[pad(j)], r);
}

// The passes form's tile: element j set to j mod q, a value every regime's
// butterflies take.
__device__ __forceinline__ void fill_tile(res_t* smem, int E, const Reduce& r) {
  for (int j = threadIdx.x; j < E; j += blockDim.x) smem[pad(j)] = (res_t)j % r.q;
  __syncthreads();
}

// One word a CTA, so the passes form's work is kept.
__device__ __forceinline__ void keep_tile(res_t* smem, int E, i64* out) {
  __syncthreads();
  if (threadIdx.x == 0) out[blockIdx.x] = (i64)smem[0] + smem[pad(E - 1)];
}

// K3-fs's column launch: int64 residues through ColMap -> 32-bit scratch.
template <int V>
__global__ void __launch_bounds__(kOldThreads, 6) ntt_cols_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  const OldGeom g = old_geom(a.log_n, a.rows);
  const Reduce r = fs_reduce<kLazy2>(a, g.c);
  const ColMap map{g.log_c, g.log_n2, g.blk << g.log_c};
  const int E = 1 << g.log_e;
  const GlobalIn<i64, 1, ColMap> in{{a.in[0] + g.poly}, map};
  const OldScratchOut<ColMap> out{a.scratch[0] + g.poly, map};
  const TilePolys<1> tile{{smem}, 0};
  if (V == kCopy) return copy_tile(in, out, smem, 0, E, r);
  if (V == kPasses) fill_tile(smem, E, r);
  if (V == kWhole)
    forward_stages<1>(in, tile, out, 0, g.log_n1, g.log_e, 0, g.log_e, pass_group(E),
                      fs_tabs(a, g.c), r);
  else
    forward_stages<1>(tile, tile, tile, 0, g.log_n1, g.log_e, 0, g.log_e, pass_group(E),
                      fs_tabs(a, g.c), r);
  if (V == kPasses) keep_tile(smem, E, a.out);
}

// K3-fs's row launch: 32-bit scratch rows -> canonical int64 through the
// tile and a coalesced copy-out.
template <int V>
__global__ void __launch_bounds__(kOldThreads, 6) ntt_rows_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  const OldGeom g = old_geom(a.log_n, a.rows);
  const Reduce r = fs_reduce<kLazy2>(a, g.c);
  const int E = 1 << g.log_e;
  const int x0 = g.blk << g.log_e;
  const GlobalIn<res_t, 1, RowMap> in{{a.scratch[0] + g.poly}, RowMap{}};
  const CanonOut<RowMap> out{a.out + g.poly, RowMap{}};
  const TilePolys<1> tile{{smem}, x0};
  if (V == kCopy) return copy_tile(in, out, smem, x0, E, r);
  if (V == kPasses) fill_tile(smem, E, r);
  if (V == kWhole)
    forward_stages<1>(in, tile, tile, g.log_n1, g.log_n, g.log_n, x0, g.log_e, pass_group(E),
                      fs_tabs(a, g.c), r);
  else
    forward_stages<1>(tile, tile, tile, g.log_n1, g.log_n, g.log_n, x0, g.log_e, pass_group(E),
                      fs_tabs(a, g.c), r);
  if (V == kPasses) return keep_tile(smem, E, a.out);
  __syncthreads();
  i64* o = a.out + g.poly + x0;
  for (int j = threadIdx.x; j < E; j += blockDim.x) o[j] = canonicalize(smem[pad(j)], r);
}

// K4-fs's row launch: int64 spectra rows -> 32-bit scratch.
template <int V>
__global__ void __launch_bounds__(kOldThreads, 6) intt_rows_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  const OldGeom g = old_geom(a.log_n, a.rows);
  const Reduce r = fs_reduce<kLazy2>(a, g.c);
  const int E = 1 << g.log_e;
  const int x0 = g.blk << g.log_e;
  const GlobalIn<i64, 1, RowMap> in{{a.in[0] + g.poly}, RowMap{}};
  const OldScratchOut<RowMap> out{a.scratch[0] + g.poly, RowMap{}};
  const TilePolys<1> tile{{smem}, x0};
  if (V == kCopy) return copy_tile(in, out, smem, x0, E, r);
  if (V == kPasses) fill_tile(smem, E, r);
  if (V == kWhole)
    inverse_stages(in, tile, out, 0, g.log_n2, g.log_n, x0, g.log_e, pass_group(E),
                   fs_tabs(a, g.c), r);
  else
    inverse_stages(tile, tile, tile, 0, g.log_n2, g.log_n, x0, g.log_e, pass_group(E),
                   fs_tabs(a, g.c), r);
  if (V == kPasses) keep_tile(smem, E, a.out);
}

// K4-fs's column launch: 32-bit scratch through ColMap -> canonical int64.
template <int V>
__global__ void __launch_bounds__(kOldThreads, 6) intt_cols_kernel(const FsArgs a) {
  extern __shared__ res_t smem[];
  const OldGeom g = old_geom(a.log_n, a.rows);
  const Reduce r = fs_reduce<kLazy2>(a, g.c);
  const ColMap map{g.log_c, g.log_n2, g.blk << g.log_c};
  const int E = 1 << g.log_e;
  const GlobalIn<res_t, 1, ColMap> in{{a.scratch[0] + g.poly}, map};
  const CanonOut<ColMap> out{a.out + g.poly, map};
  const TilePolys<1> tile{{smem}, 0};
  if (V == kCopy) return copy_tile(in, out, smem, 0, E, r);
  if (V == kPasses) fill_tile(smem, E, r);
  if (V == kWhole)
    inverse_stages(in, tile, out, g.log_c, g.log_e, g.log_e, 0, g.log_e, pass_group(E),
                   fs_tabs(a, g.c), r);
  else
    inverse_stages(tile, tile, tile, g.log_c, g.log_e, g.log_e, 0, g.log_e, pass_group(E),
                   fs_tabs(a, g.c), r);
  if (V == kPasses) keep_tile(smem, E, a.out);
}

typedef void (*OldKernel)(const FsArgs);

// [transform: 0 K3-fs, 1 K4-fs][launch: 0 first, 1 second][variant]
OldKernel pick(int transform, int launch, int variant) {
  static const OldKernel kernels[2][2][3] = {
      {{ntt_cols_kernel<kWhole>, ntt_cols_kernel<kCopy>, ntt_cols_kernel<kPasses>},
       {ntt_rows_kernel<kWhole>, ntt_rows_kernel<kCopy>, ntt_rows_kernel<kPasses>}},
      {{intt_rows_kernel<kWhole>, intt_rows_kernel<kCopy>, intt_rows_kernel<kPasses>},
       {intt_cols_kernel<kWhole>, intt_cols_kernel<kCopy>, intt_cols_kernel<kPasses>}}};
  return kernels[transform][launch][variant];
}

}  // namespace

extern "C" {

// Launches one launch of the earlier design (`transform` 0: K3-fs, 1: K4-fs; `launch` 0 or
// 1, in the transform's order) in form `variant` (0 whole, 1 copy, 2
// passes) on `stream`, over t x rows polynomials of n = 2^log_n: `a` the
// int64 input, `scratch` the (t, rows, n) 32-bit words, `out` the int64
// output (the passes form stores one word a CTA there), `tab` and
// `tab_sh` the forward (K3-fs) or inverse (K4-fs) tables.  Only the lazy
// W = 2 regime; returns the CUDA error, cudaErrorInvalidValue for another.
int parentt_fs_variant(int transform, int launch, int variant, const long long* a, int* scratch,
                       long long* out, const long long* qs, const long long* half,
                       const long long* eps, const long long* tab, const long long* tab_sh,
                       int t, int rows, int log_n, int mode, int window, int beta, int s1, int s2,
                       void* stream) {
  if (regime_of(mode, window) != kLazy2 || transform < 0 || transform > 1 || launch < 0 ||
      launch > 1 || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  const FsArgs args{{a, a}, {(res_t*)scratch, (res_t*)scratch}, out, qs, half, eps, tab, tab,
                    tab_sh, tab_sh, rows, log_n, mode, window, beta, s1, s2};
  const int log_e = log_n < kLogFsTile ? log_n : kLogFsTile;
  const size_t smem = padded(1 << log_e) * sizeof(res_t);
  const OldKernel kernel = pick(transform, launch, variant);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<t * rows << (log_n - log_e), pass_threads(1 << log_e), smem, (cudaStream_t)stream>>>(
      args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
