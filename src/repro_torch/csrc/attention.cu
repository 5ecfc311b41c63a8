// Forward flash attention with an online softmax: q (B, Sq, H, D),
// k/v (B, Skv, Hk, D) -> o (B, Sq, H, D), float32 or bfloat16 in and out,
// float32 inside.  GQA (query head h reads kv head h / (H / Hk)), causal
// mask, sliding window, logit softcap tanh(s / cap) * cap, query offset.
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/attention.py:82,
// body _kernel :33, pallas_call :133).  Three variants; the wrapper
// (repro_torch/kernels/attention.py, attention_variant) picks one from
// (dtype, D, Sq, H / Hk) alone:
//
// * wgmma (bf16 prefill, every D): one block per (128 query rows, head,
//   batch), heaviest causal tiles launched first.  A producer thread
//   loads the block's Q once and streams
//   64-key K and V tiles through two rings of shared-memory stages with
//   TMA (cp.async.bulk.tensor on 4-D tensor maps of the strided
//   (B, S, heads, D) layout, 64-column panels with the 128-byte swizzle,
//   64-byte at D = 32; full and empty mbarriers per stage).  Key tiles no
//   row of the block sees are never loaded.  Warpgroups 0 and 1 each own
//   64 query rows.  S = Q K^T runs on wgmma in bf16 with float32
//   accumulation from the unscaled bf16 Q and K; the scale 1/sqrt(D), the
//   softcap and a branch-free mask (each row's visible columns of the
//   tile) apply to the float32 scores in registers, and the online
//   softmax reduces each row over the quad of lanes that hold it.  P keeps
//   the reference's float32 precision in P @ V: it is split into
//   hi = bf16(p) and lo = bf16(p - hi), and two register-A wgmmas
//   (P_hi V, P_lo V, V an MN-major B operand) add into one float32 O
//   accumulator; l sums the float32 p.  The two consumer warpgroups take
//   turns to issue their products (named barriers), and at D <= 128 tile
//   t's P @ V goes out with tile t + 1's Q K^T, so one warpgroup's softmax
//   runs while the tensor cores work for the other.  Registers shape the
//   block: with 9 or more warps ptxas gives a thread at most 168 (and
//   setmaxnreg did not lift that for this kernel with nvcc 12.9), which
//   holds D <= 128, so there a
//   producer warp sits beside the two warpgroups (288 threads).  At
//   D = 256 O alone is 128 registers a thread: 256 threads, a producer
//   thread inside warpgroup 1, and P @ V right after its own softmax.
// * decode (bf16, Sq * H / Hk <= 8 rows): split-KV.  One block of 128
//   threads per (batch, kv head, key split), holding every query row of
//   the GQA group, so each K/V byte is read once; 32-key tiles stream
//   through a three-stage TMA ring; scores, softmax and P @ V on the CUDA
//   cores in float32.  Each split writes its partial (m, l, acc) to a
//   scratch buffer; the last block of a (batch, kv head), found with a
//   counter the wrapper allocates once and the kernel resets, combines
//   them in the same launch.
// * simt (float32 I/O): the port's first design: one block of 256
//   threads per (64 query rows, head, batch), both products as float32
//   FMAs on the CUDA cores, P through shared memory.
//
// Head dim 80 (zamba2-2.7b) is padded inside the kernels, never in device
// memory: the tensor maps keep the global row at 80 columns and TMA fills
// the columns of a box past it with zeros.  wgmma: two 64-column panels,
// the second 16 real columns and 48 zeros; Q K^T runs over the 5 real
// 16-column steps, P @ V over both panels (128 columns, 1.6x the products
// D needs), the zero columns of O never stored.  decode: tiles of 128
// columns (each lane 4 of them in Q K^T, the product of Q's zeros and
// K's zeros past 80), partials and the output 80 wide.  simt: one column
// a load in P @ V (5 a thread).  The bytes read from device memory are
// those of D = 80.
//
// Scores use the reference's finite sentinel -1e30 semantics.  A row that
// has seen no key yet keeps m = -1e30, l = 0, acc = 0; the reference adds
// exp(0) = 1 terms for such a row, which its first visible key erases
// (alpha = exp(-1e30 - m) = 0), so skipping them gives the same result; a
// key split that sees no key carries the same (m, l, acc) into the
// combine.  A row that sees no key at all gets the reference's answer,
// sum(V[:Skv]) / Skv_padded, from a separate pass over V on the CUDA
// cores that runs only for such rows; Skv_padded = ceil(Skv / blk_k) *
// blk_k comes from the wrapper.
//
// What bounds each on an H100: prefill, the two products, 4 * D FLOPs per
// visible (query, key) pair and head at the bf16 tensor-core rate (989
// TFLOP/s); the split P makes the tensor cores do 6 * D, 1.5x that, and
// the softmax (expf, tanhf) runs on the CUDA cores between the products.
// Decode: the K and V bytes at 3.35 TB/s, which the design reads once
// (whole GQA group per block) with enough splits to fill the 132 SMs.
// Float32: the two products on the CUDA cores (67 TFLOP/s).
#include <cuda_bf16.h>

#include "parentt.cuh"

namespace {

// the Hopper primitives of csrc/parentt.cuh that the rings use
using parentt::encoder;
using parentt::EncodeTiled;
using parentt::mbar_arrive;
using parentt::mbar_expect_tx;
using parentt::mbar_init;
using parentt::mbar_wait;
using parentt::smem_addr;
using parentt::tma_load;

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------------------
// simt variant (float32 I/O; the template also takes bf16, which the
// entry points no longer route here)
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;    // query rows per block
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kGroups = 16;
constexpr int kRows = 4;       // query rows per thread
constexpr int kKeys = kBlockK / kGroups;  // keys per thread and tile
constexpr int kPad = 4;        // elements of padding per Q/K/P row: spreads banks
constexpr int kPStride = kBlockQ + kPad;
constexpr float kNegInf = -1e30f;
static_assert(kBlockQ == kBlockK && kBlockQ == kGroups * kRows, "64-row tiles, 4 rows a thread");

struct AttnArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Skv, H, Hk;
  int causal;
  long long window;      // 0: no window
  long long q_offset;    // absolute position of query row 0
  long long skv_padded;  // what a row that sees no key divides by
  float scale;
  float softcap;         // 0: none
  float inv_softcap;     // 1 / softcap (0: none), from the host: a division
                         // in a kernel is a call, which serialises its wgmmas
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) { return __float2bfloat16(x); }

// N consecutive elements of T (N * sizeof(T) bytes, aligned to that) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  static_assert(N == 1 || N == 2 || N == 4, "one, two or four elements");
  if constexpr (N == 1) {
    out[0] = to_f32(*p);
  } else if constexpr (sizeof(T) == 4 && N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  } else if constexpr (sizeof(T) == 4) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = x.x; out[1] = x.y; out[2] = y.x; out[3] = y.y;
  } else {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = x.x; out[1] = x.y;
  }
}

// Rows r0..r0+63 of one head of a (B, S, heads, D) tensor into shared
// memory with row stride `stride` (rows at or past `rows` are zero).
// kScale: Q, converted to float32 and multiplied by `scale`; otherwise
// kept in T.  Global reads are 16 bytes a thread.
template <typename T, int D, bool kScale, typename S>
__device__ __forceinline__ void load_tile(S* dst, int stride, const T* src, int b, int r0,
                                          int rows, int heads, int head, float scale) {
  constexpr int kChunk = 16 / sizeof(T);  // elements per 16-byte read
  constexpr int kPerRow = D / kChunk;
  for (int idx = threadIdx.x; idx < kBlockK * kPerRow; idx += kThreads) {
    const int r = idx / kPerRow;
    const int d = (idx % kPerRow) * kChunk;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < rows) {
      const size_t off = (((size_t)b * rows + r0 + r) * heads + head) * D + d;
      raw = *reinterpret_cast<const uint4*>(src + off);
    }
    const T* x = reinterpret_cast<const T*>(&raw);
    S* row = dst + r * stride + d;
    if constexpr (kScale) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) row[e] = to_f32(x[e]) * scale;
    } else {
      // 8-byte stores: a bf16 K row (D + kPad elements) is only 8-byte aligned
      const uint2* w = reinterpret_cast<const uint2*>(&raw);
      reinterpret_cast<uint2*>(row)[0] = w[0];
      reinterpret_cast<uint2*>(row)[1] = w[1];
    }
  }
}

// acc[i][*] += sum_j P[row i][j] * V[j][cols], over one staged tile.
template <typename T, int D, int VEC, int NCH>
__device__ __forceinline__ void accumulate_pv(float (&acc)[kRows][NCH * VEC], const float* Pt,
                                              const T* Vs, int rg, int cg) {
#pragma unroll 4
  for (int j = 0; j < kBlockK; ++j) {
    const float4 p = *reinterpret_cast<const float4*>(Pt + j * kPStride + rg * kRows);
    const float pr[kRows] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float vv[VEC];
      load_vec<T, VEC>(Vs + j * D + c * kGroups * VEC + cg * VEC, vv);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][c * VEC + e] = fmaf(pr[i], vv[e], acc[i][c * VEC + e]);
    }
  }
}

// Max and sum over the 16 lanes of a row group (lanes 0-15 or 16-31).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int s = 1; s < kGroups; s <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int s = 1; s < kGroups; s <<= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return (size_t)kBlockQ * (D + kPad) * sizeof(float)      // Q, scaled
         + (size_t)kBlockK * kPStride * sizeof(float)      // P, transposed
         + (size_t)kBlockK * (D + kPad) * sizeof(T)        // K
         + (size_t)kBlockK * D * sizeof(T);                // V
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) attention_kernel(const AttnArgs a) {
  constexpr int KS = D + kPad;                     // Q and K row stride
  // head-dim columns per load in P @ V (D = 80: one), and such loads per thread and key
  constexpr int VEC = D % 64 == 0 ? 4 : D % 32 == 0 ? 2 : 1;
  constexpr int NCH = D / (kGroups * VEC);
  static_assert(NCH * kGroups * VEC == D && D % 4 == 0, "head dim");
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Pt = Qs + kBlockQ * KS;
  T* Ks = reinterpret_cast<T*>(Pt + kBlockK * kPStride);
  T* Vs = Ks + kBlockK * KS;

  const int rg = threadIdx.x / kGroups;
  const int cg = threadIdx.x % kGroups;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.H / a.Hk);
  const T* kp = static_cast<const T*>(a.k);
  const T* vp = static_cast<const T*>(a.v);

  load_tile<T, D, true>(Qs, KS, static_cast<const T*>(a.q), b, q0, a.Sq, a.H, h, a.scale);

  long long qpos[kRows];
  float m[kRows], l[kRows], acc[kRows][NCH * VEC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    qpos[i] = a.q_offset + q0 + rg * kRows + i;
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < NCH * VEC; ++e) acc[i][e] = 0.f;
  }

  // the keys some row of this tile can see: [kbeg, kend)
  const long long qlo = a.q_offset + q0;
  const long long qhi = a.q_offset + min(q0 + kBlockQ, a.Sq) - 1;
  const long long kbeg = a.window ? max(0LL, qlo - a.window + 1) : 0LL;
  const long long kend = a.causal ? min((long long)a.Skv, qhi + 1) : (long long)a.Skv;

  for (long long k0 = kbeg / kBlockK * kBlockK; k0 < kend; k0 += kBlockK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D, false>(Ks, KS, kp, b, (int)k0, a.Skv, a.Hk, hk, 0.f);
    load_tile<T, D, false>(Vs, D, vp, b, (int)k0, a.Skv, a.Hk, hk, 0.f);
    __syncthreads();

    // S = (Q * scale) K^T on this thread's 4 x 4 rows and keys
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float qv[kRows][4], kv[kKeys][4];
#pragma unroll
      for (int i = 0; i < kRows; ++i) load_vec<float, 4>(Qs + (rg * kRows + i) * KS + d, qv[i]);
#pragma unroll
      for (int j = 0; j < kKeys; ++j) load_vec<T, 4>(Ks + (cg + kGroups * j) * KS + d, kv[j]);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[i][e], kv[j][e], s[i][j]);
    }

    // softcap, mask, online softmax; P goes to shared memory transposed
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const long long kpos = k0 + cg + kGroups * j;
        float x = s[i][j];
        if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
        const bool seen = kpos < a.Skv && (!a.causal || kpos <= qpos[i]) &&
                          (a.window == 0 || kpos > qpos[i] - a.window);
        s[i][j] = seen ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        // a row that has seen no key yet adds nothing (see the header)
        s[i][j] = m_new == kNegInf ? 0.f : expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int e = 0; e < NCH * VEC; ++e) acc[i][e] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeys; ++j)
      *reinterpret_cast<float4*>(Pt + (cg + kGroups * j) * kPStride + rg * kRows) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();
    accumulate_pv<T, D, VEC, NCH>(acc, Pt, Vs, rg, cg);
  }

  // rows that see no key at all: sum(V[:Skv]) / Skv_padded, as the reference
  bool none[kRows];
  int any = 0;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const long long lo = a.window ? max(0LL, qpos[i] - a.window + 1) : 0LL;
    const long long hi = a.causal ? min((long long)a.Skv, qpos[i] + 1) : (long long)a.Skv;
    none[i] = q0 + rg * kRows + i < a.Sq && lo >= hi;
    any |= none[i];
  }
  if (__syncthreads_or(any)) {
    for (int k0 = 0; k0 < a.Skv; k0 += kBlockK) {
      __syncthreads();
      load_tile<T, D, false>(Vs, D, vp, b, k0, a.Skv, a.Hk, hk, 0.f);
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float in = k0 + cg + kGroups * j < a.Skv ? 1.f : 0.f;
        *reinterpret_cast<float4*>(Pt + (cg + kGroups * j) * kPStride + rg * kRows) =
            make_float4(none[0] ? in : 0.f, none[1] ? in : 0.f, none[2] ? in : 0.f,
                        none[3] ? in : 0.f);
      }
      __syncthreads();
      accumulate_pv<T, D, VEC, NCH>(acc, Pt, Vs, rg, cg);
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i)
      if (none[i]) l[i] = (float)a.skv_padded;
  }

  T* op = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = q0 + rg * kRows + i;
    if (r >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* row = op + (((size_t)b * a.Sq + r) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        row[c * kGroups * VEC + cg * VEC + e] = from_f32<T>(acc[i][c * VEC + e] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const AttnArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, D>();
  const cudaError_t err = parentt::allow_smem(attention_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBlockQ - 1) / kBlockQ, a.H, a.B);
  attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const AttnArgs& a, int D, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 80: return launch<T, 80>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// wgmma (sm_90a; the mbarrier and TMA primitives are csrc/parentt.cuh's)
// ---------------------------------------------------------------------------

// wgmma descriptor of a tile of rows of kRowBytes (64 or 128) bytes,
// swizzled by the same span, 8-row groups 8 * kRowBytes apart.  K-major
// (Q, K) and MN-major (V, one 64-column atom wide) tiles both step by 8
// rows in their strided dimension, so both offsets carry that stride.
template <int kRowBytes>
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  constexpr uint64_t kGroup = (8 * kRowBytes) >> 4;         // 16-byte units
  constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;   // 128B or 64B swizzle
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (kGroup << 16) | (kGroup << 32) |
         (kLayout << 62);
}

// Named barriers 1 and 2 order the two consumer warpgroups' products.
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma accumulators
// across the asynchronous product.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D(64 x 64, f32) (+)= A(64 x 16, bf16) B(16 x 64, bf16)^T, A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 64, f32) += A(64 x 16, bf16, registers) B(16 x 64, bf16), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 32, f32) += A(64 x 16, bf16, registers) B(16 x 32, bf16), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// hi = bf16(x), lo = bf16(x - hi), two values a register each
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// ---------------------------------------------------------------------------
// wgmma variant (bf16 prefill)
// ---------------------------------------------------------------------------

constexpr int kPfRows = 128;     // query rows per block: two consumer warpgroups of 64
constexpr int kPfKeys = 64;      // keys per ring stage
constexpr int kPfConsumers = 256;

template <int D>
struct Pf {
  static constexpr int PW = D < 64 ? D : 64;  // panel width: columns of one swizzle span
  static constexpr int RowBytes = PW * 2;
  // D = 80: two panels, the second 16 columns of the row and 48 zeros
  static constexpr int Panels = (D + PW - 1) / PW;
  static constexpr int QPanel = kPfRows * RowBytes;  // bytes
  static constexpr int KPanel = kPfKeys * RowBytes;
  static constexpr int QBytes = Panels * QPanel;
  static constexpr int KBytes = Panels * KPanel;     // one K (or V) tile
  static constexpr int Stages = D == 256 ? 2 : 4;
  static constexpr int Frag = PW / 2;                // O floats a thread holds per panel
  // D <= 128: a producer warp beside the two warpgroups (288 threads), and
  // tile t's P @ V issued with tile t + 1's Q K^T.  D = 256: O alone is
  // 128 registers a thread, which 9 or more warps (at most 168 registers
  // each) cannot hold, so 256 threads, a producer thread inside warpgroup
  // 1, and P @ V right after its own softmax.
  static constexpr bool Defer = D <= 128;
  static constexpr int Threads = Defer ? 288 : 256;
  static constexpr size_t Smem = 1024 + QBytes + (size_t)Stages * 2 * KBytes + (1 + 4 * Stages) * 8;
  static_assert(Smem <= 227 * 1024, "shared memory");
  static_assert(D % 16 == 0, "Q K^T steps of 16 columns");
};

template <int PW>
__device__ __forceinline__ void wgmma_pv(float (&d)[PW / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (PW == 64) wgmma_rs_n64(d, a, b);
  else wgmma_rs_n32(d, a, b);
}

// O (+)= P_hi V + P_lo V over one V tile, a 64-column panel at a time.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[Pf<D>::Panels][Pf<D>::Frag],
                                         const uint32_t (&hi)[4][4], const uint32_t (&lo)[4][4],
                                         const unsigned char* vs) {
  using P = Pf<D>;
#pragma unroll
  for (int p = 0; p < P::Panels; ++p)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t vd = smem_desc<P::RowBytes>(vs + p * P::KPanel + kk * 16 * P::RowBytes);
      wgmma_pv<P::PW>(o[p], hi[kk], vd);
      wgmma_pv<P::PW>(o[p], lo[kk], vd);
    }
}

// Tile t (keys k0..k0+63) of K and V into ring stage t % Stages, once
// both warpgroups have released the stage's previous tile.
template <int D>
__device__ __forceinline__ void load_kv(unsigned char* kring, unsigned char* vring,
                                        const CUtensorMap* kmap, const CUtensorMap* vmap,
                                        uint64_t* k_full, uint64_t* v_full, uint64_t* k_empty,
                                        uint64_t* v_empty, int t, int k0, int hk, int b) {
  using P = Pf<D>;
  const int s = t % P::Stages;
  const uint32_t parity = ((t / P::Stages) & 1) ^ 1;
  mbar_wait(&k_empty[s], parity);
  mbar_expect_tx(&k_full[s], P::KBytes);
  for (int p = 0; p < P::Panels; ++p)
    tma_load(kring + (size_t)s * P::KBytes + p * P::KPanel, kmap, &k_full[s], p * P::PW, hk, k0,
             b);
  mbar_wait(&v_empty[s], parity);
  mbar_expect_tx(&v_full[s], P::KBytes);
  for (int p = 0; p < P::Panels; ++p)
    tma_load(vring + (size_t)s * P::KBytes + p * P::KPanel, vmap, &v_full[s], p * P::PW, hk, k0,
             b);
}

template <int D, bool kSoftcap>
__global__ void __launch_bounds__(Pf<D>::Threads, 1)
    prefill_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const AttnArgs a) {
  using P = Pf<D>;
  constexpr int RB = P::RowBytes;
  constexpr int S = P::Stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* kring = base + P::QBytes;  // stage s of K at kring + s KBytes
  unsigned char* vring = kring + (size_t)S * P::KBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(vring + (size_t)S * P::KBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + S;
  uint64_t* k_empty = v_full + S;
  uint64_t* v_empty = k_empty + S;

  // block -> (query tile, head, batch), the heaviest (last) query tiles first
  const int n_qt = (a.Sq + kPfRows - 1) / kPfRows;
  const int blk = blockIdx.x;
  const int q0 = (n_qt - 1 - blk / (a.H * a.B)) * kPfRows;
  const int h = blk % a.H;
  const int b = (blk / a.H) % a.B;
  const int hk = h / (a.H / a.Hk);

  // the key tiles some row of the block can see
  const long long qlo = a.q_offset + q0;
  const long long qhi = a.q_offset + min(q0 + kPfRows, a.Sq) - 1;
  const long long kbeg = a.window ? max(0LL, qlo - a.window + 1) : 0LL;
  const long long kend = a.causal ? min((long long)a.Skv, qhi + 1) : (long long)a.Skv;
  const int kt0 = (int)(kbeg / kPfKeys);
  const int n_kt = kend > kbeg ? (int)((kend + kPfKeys - 1) / kPfKeys) - kt0 : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kPfConsumers / 32);  // one arrival per consumer warp
      mbar_init(&v_empty[s], kPfConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform: a
  // branch it cannot prove uniform around the products serialises them
  const int w = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  // The producer loads Q and then each K/V tile once both warpgroups have
  // released the ring stage it reuses: the producer warp's first thread
  // (Defer), or thread 0 of warpgroup 1, the one that issues second, which
  // loads the first stages here and the later tiles inside its loop.
  // (The producer's branch sits inside the uniform one on w: a divergent
  // branch ahead of the consumers' code serialises their products.)
  constexpr bool kDefer = P::Defer;
  const bool producer = threadIdx.x == (kDefer ? kPfConsumers : 128);
  if (kDefer ? w == 2 : w == 1) {
    if (producer) {
      mbar_expect_tx(q_full, P::QBytes);
      for (int p = 0; p < P::Panels; ++p)
        tma_load(base + p * P::QPanel, &qmap, q_full, p * P::PW, h, q0, b);
      for (int t = 0; t < (kDefer ? n_kt : min(n_kt, S)); ++t)
        load_kv<D>(kring, vring, &kmap, &vmap, k_full, v_full, k_empty, v_empty, t,
                   (kt0 + t) * kPfKeys, hk, b);
    }
    if (kDefer) return;  // the producer warp
  }

  // consumers: warpgroup w owns block rows 64w..64w+63; this thread rows
  // row0 and row0 + 8 of them, columns 8j + 2 (lane % 4) + {0, 1}
  const int ct = threadIdx.x;
  const int warp = (ct % 128) / 32;
  const int lane = ct % 32;
  const int row0 = 64 * w + 16 * warp + lane / 4;
  long long qpos[2];
  float m[2], l[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qpos[i] = a.q_offset + q0 + row0 + 8 * i;
    m[i] = kNegInf;
    l[i] = 0.f;
  }
  float o[P::Panels][P::Frag];
#pragma unroll
  for (int p = 0; p < P::Panels; ++p)
#pragma unroll
    for (int e = 0; e < P::Frag; ++e) o[p][e] = 0.f;

  const unsigned char* qs = base + 64 * w * RB;  // this warpgroup's rows of Q panel 0
  mbar_wait(q_full, 0);

  // The two warpgroups take turns to issue (named barriers 1 + w), so one
  // runs its softmax while the tensor cores work for the other.  With
  // Defer, tile t's P @ V goes out with tile t + 1's Q K^T and its V stage
  // is released one tile late; the turns keep the warpgroups within a tile
  // of each other.  A tile no row of a warpgroup sees (one per block at
  // the causal diagonal) is computed and masked whole: every branch around
  // a wgmma depends on t and w alone, so ptxas keeps the products
  // asynchronous.
  uint32_t hi[4][4], lo[4][4];  // P of tile t - 1 (kDefer) or t
  if (w == 1 && n_kt > 0) named_arrive(1);
  for (int t = 0; t < n_kt; ++t) {
    const int s = t % S;
    const int s_prev = (t + S - 1) % S;
    const long long k0 = (long long)(kt0 + t) * kPfKeys;
    float sc[32];
    mbar_wait(&k_full[s], (t / S) & 1);
    if (kDefer && t > 0) mbar_wait(&v_full[s_prev], ((t - 1) / S) & 1);
    named_sync(1 + w);
    wgmma_fence();
    // S = Q K^T over D in steps of 16 columns
    const unsigned char* ks = kring + (size_t)s * P::KBytes;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int off = (kk * 16) / P::PW * P::QPanel + (kk * 16) % P::PW * 2;
      const int koff = (kk * 16) / P::PW * P::KPanel + (kk * 16) % P::PW * 2;
      wgmma_ss_n64(sc, smem_desc<RB>(qs + off), smem_desc<RB>(ks + koff), kk > 0);
    }
    if (kDefer && t > 0) issue_pv<D>(o, hi, lo, vring + (size_t)s_prev * P::KBytes);
    wgmma_commit();
    if (w == 0 || t + 1 < n_kt) named_arrive(2 - w);
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(hi);
    fence_regs(lo);
#pragma unroll
    for (int p = 0; p < P::Panels; ++p) fence_regs(o[p]);
    __syncwarp();
    if (lane == 0) {
      mbar_arrive(&k_empty[s]);
      if (kDefer && t > 0) mbar_arrive(&v_empty[s_prev]);
    }

    // scale, softcap and mask, branch-free: row i sees the tile's columns
    // [vis_lo[i], vis_hi[i]); this thread's columns are 2 (lane % 4) + 8j + c
    int vis_lo[2], vis_hi[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      long long hi_k = a.Skv - k0;
      if (a.causal) hi_k = min(hi_k, qpos[i] + 1 - k0);
      const long long lo_k = a.window ? qpos[i] - a.window + 1 - k0 : 0;
      vis_lo[i] = (int)max(0LL, min((long long)kPfKeys, lo_k)) - 2 * (lane % 4);
      vis_hi[i] = (int)max(0LL, min((long long)kPfKeys, hi_k)) - 2 * (lane % 4);
    }
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sc[j * 4 + i * 2 + c] * a.scale;
          if constexpr (kSoftcap) x = tanhf(x * a.inv_softcap) * a.softcap;
          const int col = 8 * j + c;
          x = col >= vis_lo[i] && col < vis_hi[i] ? x : kNegInf;
          sc[j * 4 + i * 2 + c] = x;
          mx[i] = fmaxf(mx[i], x);
        }
    // online softmax over the quad of lanes that holds a row
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      alpha[i] = expf(m[i] - m_new);
      // a row that has seen no key yet adds nothing (see the header):
      // exp(x - inf) = 0
      const float m_use = m_new == kNegInf ? __int_as_float(0x7f800000) : m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sc[j * 4 + i * 2 + c];
          x = expf(x - m_use);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
#pragma unroll
    for (int p = 0; p < P::Panels; ++p)
#pragma unroll
      for (int e = 0; e < P::Frag; ++e) o[p][e] *= alpha[(e / 2) % 2];

    // P as bf16 hi + lo A fragments: keys 16kk..16kk+15
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], hi[kk][r], lo[kk][r]);
    if constexpr (!kDefer) {
      mbar_wait(&v_full[s], (t / S) & 1);
      wgmma_fence();
      issue_pv<D>(o, hi, lo, vring + (size_t)s * P::KBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(hi);
      fence_regs(lo);
#pragma unroll
      for (int p = 0; p < P::Panels; ++p) fence_regs(o[p]);
      __syncwarp();
      if (lane == 0) mbar_arrive(&v_empty[s]);
      if (producer && t + S < n_kt)  // the stage of tile t
        load_kv<D>(kring, vring, &kmap, &vmap, k_full, v_full, k_empty, v_empty, t + S,
                   (kt0 + t + S) * kPfKeys, hk, b);
    }
  }
  if (kDefer && n_kt > 0) {
    const int s_last = (n_kt - 1) % S;
    mbar_wait(&v_full[s_last], ((n_kt - 1) / S) & 1);
    wgmma_fence();
    issue_pv<D>(o, hi, lo, vring + (size_t)s_last * P::KBytes);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(hi);
    fence_regs(lo);
#pragma unroll
    for (int p = 0; p < P::Panels; ++p) fence_regs(o[p]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&v_empty[s_last]);
  }

  // rows that see no key at all: sum(V[:Skv]) / Skv_padded, as the reference
  const bf16* vp = static_cast<const bf16*>(a.v);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long lo_k = a.window ? max(0LL, qpos[i] - a.window + 1) : 0LL;
    const long long hi_k = a.causal ? min((long long)a.Skv, qpos[i] + 1) : (long long)a.Skv;
    if (q0 + row0 + 8 * i >= a.Sq || lo_k < hi_k) continue;
    for (int k = 0; k < a.Skv; ++k) {
      const bf16* row = vp + (((size_t)b * a.Skv + k) * a.Hk + hk) * D + 2 * (lane % 4);
#pragma unroll
      for (int p = 0; p < P::Panels; ++p)
#pragma unroll
        for (int j = 0; j < P::PW / 8; ++j) {
          if (p * P::PW + 8 * j >= D) continue;  // a padding column group
          const float2 x =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(row + p * P::PW + 8 * j));
          o[p][j * 4 + i * 2] += x.x;
          o[p][j * 4 + i * 2 + 1] += x.y;
        }
    }
    l[i] = (float)a.skv_padded;
  }

  // __fdividef (within 2 ulp) rather than '/': see AttnArgs::inv_softcap
  bf16* op = static_cast<bf16*>(a.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + row0 + 8 * i;
    if (r >= a.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* row = op + (((size_t)b * a.Sq + r) * a.H + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int p = 0; p < P::Panels; ++p)
#pragma unroll
      for (int j = 0; j < P::PW / 8; ++j)
        if (p * P::PW + 8 * j < D)  // the padding columns of O are not stored
          *reinterpret_cast<__nv_bfloat162*>(row + p * P::PW + 8 * j) =
            __floats2bfloat162_rn(__fdividef(o[p][j * 4 + i * 2], denom),
                                  __fdividef(o[p][j * 4 + i * 2 + 1], denom));
  }
}

// ---------------------------------------------------------------------------
// decode variant (bf16, at most kDcMaxRows query rows per kv head): split-KV
// ---------------------------------------------------------------------------

constexpr int kDcKeys = 32;  // keys per ring stage: one per lane in the softmax
constexpr int kDcThreads = 128;
constexpr int kDcStages = 3;
constexpr int kDcMaxRows = 8;

template <int D, int R>
struct Dc {
  // the tiles' width: D, or at D = 80 the 128 columns TMA fills past 80 with zeros
  static constexpr int DP = D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 256;
  static constexpr int CH = DP / 32;       // head-dim columns a lane holds in Q K^T
  static constexpr int KG = 256 / DP;      // key groups in P @ V (each thread two columns)
  static constexpr int Tile = kDcKeys * DP * 2;  // bytes of one K (or V) tile
  static constexpr size_t Smem = 128 + (size_t)kDcStages * 2 * Tile + (size_t)KG * R * DP * 4 +
                                 2 * R * kDcKeys * 4 + 3 * R * 4 + 64;
  static_assert(D % 16 == 0 && D <= DP, "head dim");
};

// N consecutive bf16 (2N bytes, aligned to that) of shared memory as floats.
template <int N>
__device__ __forceinline__ void load_bf16(const bf16* p, float (&out)[N]) {
  if constexpr (N == 8) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else if constexpr (N == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
  } else if constexpr (N == 2) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = __bfloat162float(*p);
  }
}

// Tile t of the ring (keys k0..k0+31 of kv head hk, batch b) into stage t % kDcStages.
template <int kTile>
__device__ __forceinline__ void decode_issue(unsigned char* ring, const CUtensorMap* kmap,
                                             const CUtensorMap* vmap, uint64_t* full, int t, int k0,
                                             int hk, int b) {
  const int s = t % kDcStages;
  unsigned char* ks = ring + (size_t)s * 2 * kTile;
  mbar_expect_tx(&full[s], 2 * kTile);
  tma_load(ks, kmap, &full[s], 0, hk, k0, b);
  tma_load(ks + kTile, vmap, &full[s], 0, hk, k0, b);
}

// Partial (m, l, acc) of each (batch, kv head, split) and row live in
// `part`: acc (rows, D) floats per split, then (m, l) per split and row.
template <int D, int R>
__global__ void __launch_bounds__(kDcThreads)
    decode_kernel(const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
                  const AttnArgs a, float* part, int* counters, int n_split, int split_tiles) {
  using C = Dc<D, R>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127);
  unsigned char* ring = base;  // stage s: K at ring + 2s Tile, V after it
  float* red = reinterpret_cast<float*>(ring + (size_t)kDcStages * 2 * C::Tile);  // (KG, R, DP)
  float* Ssc = red + C::KG * R * C::DP;  // (R, kDcKeys) scores, then probabilities
  float* Pr = Ssc + R * kDcKeys;
  float* alpha_s = Pr + R * kDcKeys;
  float* m_s = alpha_s + R;
  float* l_s = m_s + R;
  uint64_t* full = reinterpret_cast<uint64_t*>(l_s + R + 1) ;
  full = reinterpret_cast<uint64_t*>((reinterpret_cast<uintptr_t>(full) + 7) & ~uintptr_t(7));
  __shared__ int last;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x % n_split;
  const int bh = blockIdx.x / n_split;
  const int hk = bh % a.Hk;
  const int b = bh / a.Hk;
  const int g = a.H / a.Hk;
  const int rows = a.Sq * g;  // row r: query r / g, head hk * g + r % g

  // this split's tiles that some row can see
  const long long kbeg = a.window ? max(0LL, a.q_offset - a.window + 1) : 0LL;
  const long long kend =
      a.causal ? min((long long)a.Skv, a.q_offset + a.Sq) : (long long)a.Skv;
  const int t_lo = max(split * split_tiles, (int)(kbeg / kDcKeys));
  const int t_hi = kend > kbeg ? min((split + 1) * split_tiles, (int)((kend + kDcKeys - 1) / kDcKeys))
                               : t_lo;
  const int n_t = max(0, t_hi - t_lo);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kDcStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < R) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(n_t, kDcStages); ++t)
      decode_issue<C::Tile>(ring, &kmap, &vmap, full, t, (t_lo + t) * kDcKeys, hk, b);

  // this lane's columns lane*CH.. of each row's query, float32
  const bf16* qp = static_cast<const bf16*>(a.q);
  float qf[R][C::CH];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int e = 0; e < C::CH; ++e) {
      qf[r][e] = 0.f;
      if (r < rows && lane * C::CH + e < D)
        qf[r][e] = __bfloat162float(
            qp[(((size_t)b * a.Sq + r / g) * a.H + hk * g + r % g) * D + lane * C::CH + e]);
    }

  const int cp = tid % (C::DP / 2);  // P @ V: columns 2cp, 2cp + 1, keys kg + KG i
  const int kg = tid / (C::DP / 2);
  float acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;

  for (int t = 0; t < n_t; ++t) {
    const int s = t % kDcStages;
    const bf16* ks = reinterpret_cast<const bf16*>(ring + (size_t)s * 2 * C::Tile);
    const bf16* vs = ks + kDcKeys * C::DP;
    const long long k0 = (long long)(t_lo + t) * kDcKeys;
    mbar_wait(&full[s], (t / kDcStages) & 1);

    // scores: warp w keys 8w..8w+7, each lane CH columns, summed over the warp
#pragma unroll 2
    for (int kk = 0; kk < kDcKeys / 4; ++kk) {
      const int key = warp * (kDcKeys / 4) + kk;
      float kf[C::CH];
      load_bf16<C::CH>(ks + key * C::DP + lane * C::CH, kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) break;
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < C::CH; ++e) d = fmaf(qf[r][e], kf[e], d);
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) d += __shfl_xor_sync(0xffffffffu, d, sh);
        if (lane == 0) Ssc[r * kDcKeys + key] = d;
      }
    }
    __syncthreads();

    // online softmax: warp w rows w, w + 4, ..., lane = key
    for (int r = warp; r < rows; r += 4) {
      const long long qpos = a.q_offset + r / g;
      const long long kpos = k0 + lane;
      float x = Ssc[r * kDcKeys + lane] * a.scale;
      if (a.softcap != 0.f) x = tanhf(x / a.softcap) * a.softcap;
      const bool seen = kpos < a.Skv && (!a.causal || kpos <= qpos) &&
                        (a.window == 0 || kpos > qpos - a.window);
      x = seen ? x : kNegInf;
      float mx = x;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = m_new == kNegInf ? 0.f : expf(x - m_new);
      float sum = p;
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      Pr[r * kDcKeys + lane] = p;
      __syncwarp();
      if (lane == 0) {
        const float al = expf(m_old - m_new);
        alpha_s[r] = al;
        l_s[r] = l_s[r] * al + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V on this thread's two columns
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r >= rows) break;
      const float al = alpha_s[r];
      acc[r][0] *= al;
      acc[r][1] *= al;
    }
    for (int key = kg; key < kDcKeys; key += C::KG) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(vs + key * C::DP + 2 * cp));
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) break;
        const float p = Pr[r * kDcKeys + key];
        acc[r][0] = fmaf(p, v.x, acc[r][0]);
        acc[r][1] = fmaf(p, v.y, acc[r][1]);
      }
    }
    __syncthreads();  // stage s and the score buffers are free again
    if (tid == 0 && t + kDcStages < n_t)
      decode_issue<C::Tile>(ring, &kmap, &vmap, full, t + kDcStages,
                            (t_lo + t + kDcStages) * kDcKeys, hk, b);
  }

  // this split's partial: acc summed over the key groups, then (m, l)
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r >= rows) break;
    red[(kg * R + r) * C::DP + 2 * cp] = acc[r][0];
    red[(kg * R + r) * C::DP + 2 * cp + 1] = acc[r][1];
  }
  __syncthreads();
  const size_t slot = (size_t)bh * n_split;
  float* acc_g = part + (slot + split) * rows * D;
  float* ml_g = part + (size_t)a.B * a.Hk * n_split * rows * D;
  for (int idx = tid; idx < rows * D; idx += kDcThreads) {
    const int r = idx / D, d = idx % D;
    float x = 0.f;
    for (int k = 0; k < C::KG; ++k) x += red[(k * R + r) * C::DP + d];
    acc_g[idx] = x;
  }
  if (tid < rows) {
    ml_g[((slot + split) * rows + tid) * 2] = m_s[tid];
    ml_g[((slot + split) * rows + tid) * 2 + 1] = l_s[tid];
  }

  // the last split of this (batch, kv head) to finish combines all of them
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(&counters[bh], 1) == n_split - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const bf16* vp = static_cast<const bf16*>(a.v);
  bf16* op = static_cast<bf16*>(a.o);
  for (int idx = tid; idx < rows * D; idx += kDcThreads) {
    const int r = idx / D, d = idx % D;
    float M = kNegInf;
    for (int sp = 0; sp < n_split; ++sp) M = fmaxf(M, __ldcg(ml_g + ((slot + sp) * rows + r) * 2));
    float o;
    if (M == kNegInf) {
      // a row that sees no key at all: sum(V[:Skv]) / Skv_padded, as the reference
      float x = 0.f;
      for (int k = 0; k < a.Skv; ++k)
        x += __bfloat162float(vp[(((size_t)b * a.Skv + k) * a.Hk + hk) * D + d]);
      o = x / fmaxf((float)a.skv_padded, 1e-30f);
    } else {
      float L = 0.f, O = 0.f;
      for (int sp = 0; sp < n_split; ++sp) {
        const float ms = __ldcg(ml_g + ((slot + sp) * rows + r) * 2);
        const float e = expf(ms - M);
        L += __ldcg(ml_g + ((slot + sp) * rows + r) * 2 + 1) * e;
        O += __ldcg(part + ((slot + sp) * rows + r) * D + d) * e;
      }
      o = O / fmaxf(L, 1e-30f);
    }
    op[(((size_t)b * a.Sq + r / g) * a.H + hk * g + r % g) * D + d] = __float2bfloat16(o);
  }
  if (tid == 0) counters[bh] = 0;
}

// ---------------------------------------------------------------------------
// tensor maps and launches
// ---------------------------------------------------------------------------

// A 4-D map of one bf16 (B, S, heads, D) tensor, innermost first, read in
// boxes of `box_rows` rows of one head and `box_cols` columns.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, int D, int box_cols,
                int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t rows = S > 0 ? S : 1;  // a map needs a row; no box reads it when S = 0
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 rows * heads * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)box_cols, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
         CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_prefill(const AttnArgs& a, cudaStream_t stream) {
  using P = Pf<D>;
  const CUtensorMapSwizzle sw = P::RowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                                   : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap qmap, kmap, vmap;
  if (!tensor_map(&qmap, a.q, a.B, a.Sq, a.H, D, P::PW, kPfRows, sw) ||
      !tensor_map(&kmap, a.k, a.B, a.Skv, a.Hk, D, P::PW, kPfKeys, sw) ||
      !tensor_map(&vmap, a.v, a.B, a.Skv, a.Hk, D, P::PW, kPfKeys, sw))
    return cudaErrorInvalidValue;
  const auto kernel = a.softcap != 0.f ? prefill_kernel<D, true> : prefill_kernel<D, false>;
  const cudaError_t err = parentt::allow_smem(kernel, P::Smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((a.Sq + kPfRows - 1) / kPfRows) * a.H * a.B;
  kernel<<<blocks, P::Threads, P::Smem, stream>>>(qmap, kmap, vmap, a);
  return cudaGetLastError();
}

template <int D, int R>
cudaError_t launch_decode(const AttnArgs& a, float* part, int* counters, int n_split,
                          int split_tiles, cudaStream_t stream) {
  using C = Dc<D, R>;
  CUtensorMap kmap, vmap;
  if (!tensor_map(&kmap, a.k, a.B, a.Skv, a.Hk, D, C::DP, kDcKeys, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&vmap, a.v, a.B, a.Skv, a.Hk, D, C::DP, kDcKeys, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  const cudaError_t err = parentt::allow_smem(decode_kernel<D, R>, C::Smem);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)a.B * a.Hk * n_split;
  decode_kernel<D, R><<<blocks, kDcThreads, C::Smem, stream>>>(kmap, vmap, a, part, counters,
                                                                n_split, split_tiles);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_decode_rows(const AttnArgs& a, float* part, int* counters, int n_split,
                               int split_tiles, cudaStream_t stream) {
  const int rows = a.Sq * (a.H / a.Hk);
  if (rows <= 2) return launch_decode<D, 2>(a, part, counters, n_split, split_tiles, stream);
  if (rows <= 4) return launch_decode<D, 4>(a, part, counters, n_split, split_tiles, stream);
  if (rows <= kDcMaxRows)
    return launch_decode<D, kDcMaxRows>(a, part, counters, n_split, split_tiles, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Each entry launches one variant on `stream` and returns cudaGetLastError()
// (cudaErrorInvalidValue for a shape it does not take).

// float32 I/O: the CUDA-core kernel
int parentt_attention_simt(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                           int Skv, int H, int Hk, int D, int causal, long long window,
                           long long q_offset, long long skv_padded, float scale, float softcap,
                           void* stream) {
  const AttnArgs a{q, k, v, o, B, Sq, Skv, H, Hk, causal, window, q_offset, skv_padded, scale,
                   softcap, softcap != 0.f ? 1.f / softcap : 0.f};
  return (int)launch_d<float>(a, D, (cudaStream_t)stream);
}

// bf16 prefill: the wgmma kernel
int parentt_attention_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                            int Skv, int H, int Hk, int D, int causal, long long window,
                            long long q_offset, long long skv_padded, float scale, float softcap,
                            void* stream) {
  const AttnArgs a{q, k, v, o, B, Sq, Skv, H, Hk, causal, window, q_offset, skv_padded, scale,
                   softcap, softcap != 0.f ? 1.f / softcap : 0.f};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return (int)launch_prefill<32>(a, s);
    case 64: return (int)launch_prefill<64>(a, s);
    case 80: return (int)launch_prefill<80>(a, s);
    case 128: return (int)launch_prefill<128>(a, s);
    case 256: return (int)launch_prefill<256>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 decode: the split-KV kernel.  `part` holds B * Hk * n_split *
// Sq * (H / Hk) * (D + 2) floats; `counters` B * Hk zeros, which the
// kernel leaves at zero.
int parentt_attention_decode(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                             int Skv, int H, int Hk, int D, int causal, long long window,
                             long long q_offset, long long skv_padded, float scale, float softcap,
                             void* part, void* counters, int n_split, int split_tiles,
                             void* stream) {
  const AttnArgs a{q, k, v, o, B, Sq, Skv, H, Hk, causal, window, q_offset, skv_padded, scale,
                   softcap, softcap != 0.f ? 1.f / softcap : 0.f};
  float* p = static_cast<float*>(part);
  int* c = static_cast<int*>(counters);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return (int)launch_decode_rows<32>(a, p, c, n_split, split_tiles, s);
    case 64: return (int)launch_decode_rows<64>(a, p, c, n_split, split_tiles, s);
    case 80: return (int)launch_decode_rows<80>(a, p, c, n_split, split_tiles, s);
    case 128: return (int)launch_decode_rows<128>(a, p, c, n_split, split_tiles, s);
    case 256: return (int)launch_decode_rows<256>(a, p, c, n_split, split_tiles, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a block of each variant at head dim D (0:
// wgmma, 1: decode at its most rows, 2: simt float32), for the logs.
int parentt_attention_smem(int variant, int D) {
  switch (variant * 1000 + D) {
    case 32: return (int)Pf<32>::Smem;
    case 64: return (int)Pf<64>::Smem;
    case 80: return (int)Pf<80>::Smem;
    case 128: return (int)Pf<128>::Smem;
    case 256: return (int)Pf<256>::Smem;
    case 1032: return (int)Dc<32, kDcMaxRows>::Smem;
    case 1064: return (int)Dc<64, kDcMaxRows>::Smem;
    case 1080: return (int)Dc<80, kDcMaxRows>::Smem;
    case 1128: return (int)Dc<128, kDcMaxRows>::Smem;
    case 1256: return (int)Dc<256, kDcMaxRows>::Smem;
    case 2032: return (int)smem_bytes<float, 32>();
    case 2064: return (int)smem_bytes<float, 64>();
    case 2080: return (int)smem_bytes<float, 80>();
    case 2128: return (int)smem_bytes<float, 128>();
    case 2256: return (int)smem_bytes<float, 256>();
    default: return -1;
  }
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
