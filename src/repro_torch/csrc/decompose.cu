// Alg-2 SAU decompose: base-2^v segments (rows, S) -> canonical residues
// (t, rows) in every RNS channel.
//
// Replaces the TPU kernel decompose_pallas (src/repro/kernels/crt.py:180,
// body :167, decompose_stage :41).  The TPU version makes one pallas_call
// per channel, each with that channel's SAU circuit baked in and each
// reading all S segments; here one launch serves all t channels.
//
// Design: one block per tile of kTile consecutive rows.  The block copies
// its contiguous (kTile, S) int64 slab into shared memory with cp.async
// (16-byte copies, consecutive threads on consecutive words) and every
// channel's circuit (SAU shifts and signs, Barrett and block constants)
// once.  Each thread then runs the shared `decompose` device function of
// parentt.cuh (the one the fused e2e kernel runs) for its row in all t
// channels, reading its segments from shared memory, and writes
// out[c, row]: consecutive threads write consecutive words.  Nothing is
// kept in a register array indexed by S, and the block products reduce
// with a Barrett instead of a 64-bit %.
//
// What bounds it on an H100: S int64 words in and t out per coefficient
// (the byte bound), against the SAU shift/add networks and Barrett
// reductions in 64-bit integers, which the GPU issues as pairs of 32-bit
// instructions: the two are of the same order.
#include "parentt.cuh"

using namespace parentt;

namespace {

constexpr int kTile = 256;

struct DecomposeArgs {
  const i64* z;
  i64* out;
  DecomposeTables dec;
  i64 rows;
  int S;
};

template <bool NARROW>
__global__ void __launch_bounds__(kTile) decompose_kernel(const DecomposeArgs args) {
  extern __shared__ __align__(16) i64 slab[];  // (kTile, S) segments of this tile
  __shared__ DecomposeShared dsh;
  const i64 row0 = (i64)blockIdx.x * kTile;
  const int rows_here = (int)min((i64)kTile, args.rows - row0);
  load_decompose(dsh, args.dec);
  stage_words(slab, args.z + row0 * args.S, rows_here * args.S);
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= rows_here) return;
  const i64* z = slab + j * args.S;
  for (int c = 0; c < dsh.t; ++c) {
    args.out[(size_t)c * args.rows + row0 + j] = decompose<NARROW>(z, args.S, dsh.ch[c], dsh);
  }
}

}  // namespace

extern "C" {

// Launches the decompose on `stream`; `narrow` (every q below 2^30) picks
// the 32-bit remainders.  Returns cudaGetLastError().
int parentt_decompose(const long long* z, long long* out, const long long* qs,
                      const long long* beta, const long long* sau_eps, const long long* sau_s2,
                      const long long* acc_eps, const long long* block_m,
                      const long long* block_consts, long long rows, int t, int S, int n_blocks, int dec_s1, int acc_s2, int narrow, void* stream) {
  const DecomposeTables dec{qs, beta, sau_eps, sau_s2, acc_eps, block_m, block_consts,
                            t,  n_blocks, dec_s1, acc_s2};
  const DecomposeArgs args{z, out, dec, rows, S};
  const long long blocks = (rows + kTile - 1) / kTile;
  const size_t smem = (size_t)kTile * S * sizeof(i64);
  if (narrow) {
    decompose_kernel<true><<<(unsigned)blocks, kTile, smem, (cudaStream_t)stream>>>(args);
  } else {
    decompose_kernel<false><<<(unsigned)blocks, kTile, smem, (cudaStream_t)stream>>>(args);
  }
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
