// Alg-2 SAU decompose: base-2^v segments (rows, S) -> canonical residues
// (t, rows) in every RNS channel.
//
// Replaces the TPU kernel decompose_pallas (src/repro/kernels/crt.py:180,
// body :167, decompose_stage :41).  The TPU version makes one pallas_call
// per channel, each with that channel's SAU circuit baked in and each
// reading all S segments; here one launch serves all t channels.
//
// Design: one block per tile of R consecutive rows (R = 256 while the
// tile's segments take at most 64 KB, fewer as S grows: tile_rows).  The
// block copies its contiguous (R, S) int64 slab into shared memory with
// cp.async (16-byte copies, consecutive threads on consecutive words) and
// every channel's circuit (SAU multiplier, Barrett and Horner constants)
// once, beside it in dynamic shared memory sized by t.  Each thread then
// runs the shared `decompose` device function of parentt.cuh (the one the
// fused e2e kernel runs: Alg-2 blocks by Horner, the most significant
// first, so any number of blocks takes one constant) for its row in all t
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

constexpr int kTile = 256;  // rows of a block at most

struct DecomposeArgs {
  const i64* z;
  i64* out;
  DecomposeTables dec;
  i64 rows;
  int S;
};

// Rows of a block (kernels/crt.py decompose_rows mirrors it).
int rows_of(int t, int S) { return tile_rows(S, decompose_table_bytes(t)); }

template <bool NARROW>
__global__ void __launch_bounds__(kTile) decompose_kernel(const DecomposeArgs args) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const DecomposeShared dsh = load_decompose(smem_raw, args.dec);
  i64* slab = reinterpret_cast<i64*>(smem_raw + decompose_table_bytes(args.dec.t));  // (R, S)
  const int R = blockDim.x;
  const i64 row0 = (i64)blockIdx.x * R;
  const int rows_here = (int)min((i64)R, args.rows - row0);
  stage_words(slab, args.z + row0 * args.S, rows_here * args.S);
  __syncthreads();
  const int j = threadIdx.x;
  if (j >= rows_here) return;
  const i64* z = slab + j * args.S;
  for (int c = 0; c < dsh.t; ++c) {
    args.out[(size_t)c * args.rows + row0 + j] = decompose<NARROW>(z, args.S, dsh.ch[c], dsh.s1);
  }
}

}  // namespace

extern "C" {

// Launches the decompose on `stream`; `narrow` (every q below 2^30) picks
// the 32-bit remainders.  Returns the CUDA error of the attribute call or
// the launch (cudaErrorInvalidValue when one block's shared memory cannot
// hold a row's segments beside the circuits' table).
int parentt_decompose(const long long* z, long long* out, const long long* qs,
                      const long long* beta, const long long* sau_eps, const long long* sau_s2,
                      const long long* horner, const long long* block_m, long long rows, int t,
                      int S, int dec_s1, int narrow, void* stream) {
  const DecomposeTables dec{qs, beta, sau_eps, sau_s2, horner, block_m, t, dec_s1};
  const DecomposeArgs args{z, out, dec, rows, S};
  const int R = rows_of(t, S);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + R - 1) / R;
  const size_t smem = (size_t)(decompose_table_bytes(t) + (long long)R * S * sizeof(i64));
  void (*kernel)(const DecomposeArgs) = narrow ? decompose_kernel<true> : decompose_kernel<false>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, R, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
