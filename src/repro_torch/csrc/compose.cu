// Eq-10 inverse CRT: canonical residues (t, rows) -> canonical base-2^w
// limbs (rows, L) of the composed value mod q.
//
// Replaces the TPU kernel compose_pallas (src/repro/kernels/crt.py:266,
// body :249, compose_finalize :207).
//
// Design: one thread per coefficient, a CTA of R coefficients, on the
// compose tail of the fused e2e kernel (K2).  The CTA keeps its channels'
// constants (q, 1/q, the block-Barrett m, q~) in shared memory.  Each
// thread
// * reads its t residues, one word a channel (coalesced across threads),
//   the reads in flight together: the 8-limb instances (t <= 15, L <= 8,
//   crt_compose's SINGLE: one pass of straight-line code) issue every
//   read before the CTA's table fills, into registers; the 16-limb
//   instances read each group of 15 channels' words before its
//   arithmetic (crt_compose's PRELOAD).  `python3 chip_smoke.py
//   --compose-variants` times both against the same source with each
//   switched off;
// * forms y_c = r_c q~_c mod q_c as one 32x32->64 product reduced by the
//   block Barrett of parentt.cuh with m = floor(2^(b+31) / q_c)
//   (RnsPlan.dec_d's block_m, the constant K2 and K5 take), exact since
//   r_c q~_c < q_c^2 < 2^(2b);
// * sums y_c q^_c limb by limb and y_c / q_c in double (crt_compose:
//   carry-normalised every 15 channels, so exact for any t), whose floor
//   is floor(value / q) to within one, and finishes with one carry ripple
//   that subtracts that quotient times q, then one conditional addition or
//   subtraction of q (no loop of big-integer compare-and-subtract steps);
// * leaves its L limbs in the CTA's (R, L) shared stage, which the CTA
//   writes out as cnt * L contiguous int64 words (coalesced; the last CTA
//   writes only its cnt rows).
// R = 256 while the stage takes at most 64 KB, fewer past it (tile_rows).
// The limb chunk MAXL (8 for L <= 8 and t <= 15, else 16: the limbs
// ripple into the stage chunk by chunk and are corrected there), the CTAs
// an SM the registers are held to, and NARROW (every q below 2^30: the
// Barrett remainders in 32 bits) are template parameters, so the limb
// sums are MAXL-word register arrays.  Input domain: canonical residues
// r_c < q_c, the contract of repro_torch.compose.
//
// What bounds it on an H100: t int64 words in and L out per coefficient
// (the byte bound: 104 bytes at t = 6, L = 7); the t block Barretts and
// t x L multiply-adds are integer work of a smaller bound at small t (at
// t = 30, L = 32 the 960 multiply-adds a coefficient weigh more).  A
// thread's loads are independent and the stores coalesced, so what is
// left is the latency of the loads against the CTAs an SM holds.
#include "parentt.cuh"

using namespace parentt;

namespace {

constexpr int kTile = 256;  // rows of a CTA at most
// CTAs of kTile an SM that the register budget leaves room for with
// MAXL = 8: at most 48 registers.  MAXL = 16 holds twice the limb sums:
// three CTAs (at most 80 registers, a short spill) for L <= 16, where it
// runs one chunk, and two (at most 128) past it, where the chunk loop's
// carries and the second pass over the channels spill at 80.
constexpr int kMinBlocks = 5;

struct ComposeArgs {
  const i64* res;
  i64* out;
  const i64* qs;       // (t,)
  const i64* tilde;    // (t,): q~_c = (q / q_c)^-1 mod q_c
  const i64* block_m;  // (t,): floor(2^(b+31) / q_c)
  const i64* star;     // (t, L): limbs of q^_c = q / q_c
  const i64* q_limbs;  // (L,)
  i64 rows;
  int t;
  int L;
  int w;
  int s1;  // b - 1, b = bit_length(q_c), the same for every channel
};

// One channel's constants, as a CTA keeps them in shared memory.
struct __align__(8) ComposeChannel {
  double inv_q;
  res_t q;
  res_t m;
  res_t tilde;
};
static_assert(sizeof(ComposeChannel) == 24, "kernels/crt.py sizes the table at 24 bytes a channel");

// Bytes of the channel table, rounded to 16 for the stage after it, and
// the rows of a CTA (kernels/crt.py compose_rows mirrors both).
__host__ __device__ inline long long table_bytes(int t) { return ((long long)t * sizeof(ComposeChannel) + 15) / 16 * 16; }
int rows_of(int t, int L) { return tile_rows(L, table_bytes(t)); }

template <bool NARROW, int MAXL, int MIN_BLOCKS>
__global__ void __launch_bounds__(kTile, MIN_BLOCKS) compose_kernel(const ComposeArgs args) {
  // the 8-limb instance serves t <= kSumChannels, L <= 8 in one pass
  constexpr bool kSingle = MAXL == 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ComposeChannel* ch = reinterpret_cast<ComposeChannel*>(smem_raw);
  i64* stage = reinterpret_cast<i64*>(smem_raw + table_bytes(args.t));  // (R, L) limbs
  const int t = args.t, L = args.L, R = blockDim.x;
  const i64 row0 = (i64)blockIdx.x * R;
  const int cnt = (int)min((i64)R, args.rows - row0);
  const int j = threadIdx.x;
  const i64* r = args.res + row0 + j;
  // kSingle: every channel's word read before the table fills, so the
  // reads overlap it (the channel index is compile-time in one pass)
  res_t first[kSingle ? kSumChannels : 1];
  if (kSingle) {
#pragma unroll
    for (int c = 0; c < kSumChannels; ++c) {
      first[c] = c < t && j < cnt ? (res_t)__ldg(r + (size_t)c * args.rows) : 0u;
    }
  }
  for (int c = threadIdx.x; c < t; c += R) {
    ch[c].inv_q = 1.0 / (double)args.qs[c];
    ch[c].q = (res_t)args.qs[c];
    ch[c].m = (res_t)args.block_m[c];
    ch[c].tilde = (res_t)args.tilde[c];
  }
  __syncthreads();
  if (j < cnt) {
    crt_compose<MAXL, !kSingle, kSingle>(
        [&](int c) { return kSingle ? first[c] : (res_t)__ldg(r + (size_t)c * args.rows); },
        [&](int c, res_t rc) {
          const ComposeChannel& k = ch[c];
          return (res_t)block_barrett<NARROW>((u64)rc * k.tilde, k.q, k.m, args.s1);
        },
        [&](int c) { return ch[c].inv_q; }, args.star, args.q_limbs, t, L, args.w,
        stage + j * L);
  }
  __syncthreads();
  i64* po = args.out + row0 * L;
  for (int i = threadIdx.x; i < cnt * L; i += R) po[i] = stage[i];
}

typedef void (*ComposeKernel)(const ComposeArgs);

ComposeKernel pick_kernel(int narrow, int t, int L) {
  static const ComposeKernel kernels[2][3] = {
      {compose_kernel<false, 8, kMinBlocks>, compose_kernel<false, 16, 3>,
       compose_kernel<false, 16, 2>},
      {compose_kernel<true, 8, kMinBlocks>, compose_kernel<true, 16, 3>,
       compose_kernel<true, 16, 2>},
  };
  return kernels[narrow ? 1 : 0][L <= 8 && t <= kSumChannels ? 0 : L <= 16 ? 1 : 2];
}

}  // namespace

extern "C" {

// Launches the compose on `stream`; `narrow` (every q below 2^30) picks
// the 32-bit Barrett remainders.  Returns the CUDA error of the attribute
// call or the launch (cudaErrorInvalidValue when one CTA's shared memory
// cannot hold a row's limbs beside the channels' table).
int parentt_compose(const long long* residues, long long* out, const long long* qs,
                    const long long* qi_tilde, const long long* block_m, const long long* star,
                    const long long* q_limbs, long long rows, int t, int L, int w, int s1,
                    int narrow, void* stream) {
  const ComposeArgs args{residues, out, qs, qi_tilde, block_m, star, q_limbs, rows, t, L, w, s1};
  const int R = rows_of(t, L);
  if (R < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = (rows + R - 1) / R;
  const size_t smem = (size_t)(table_bytes(t) + (long long)R * L * sizeof(i64));
  const ComposeKernel kernel = pick_kernel(narrow, t, L);
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, R, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
