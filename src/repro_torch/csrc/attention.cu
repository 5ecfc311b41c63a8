// Forward flash attention with an online softmax: q (B, Sq, H, D),
// k/v (B, Skv, Hk, D) -> o (B, Sq, H, D), float32 or bfloat16 in and out,
// float32 inside.  GQA (query head h reads kv head h / (H / Hk)), causal
// mask, sliding window, logit softcap tanh(s / cap) * cap, query offset.
//
// Replaces the TPU kernel flash_attention (src/repro/kernels/attention.py:82,
// body _kernel :33, pallas_call :133).
//
// Design: one block of 256 threads per (query tile of 64 rows, head,
// batch).  The block scales its Q tile once into shared memory as float32
// and loops over 64-key tiles of K and V, which it stages in shared memory
// in the input type.  Thread (rg, cg) = (tid / 16, tid % 16) owns query
// rows 4rg..4rg+3: for each key tile it forms their scores against keys
// cg + 16j (j < 4) with float32 FMAs, applies the softcap and the mask,
// and updates the rows' running max, normaliser and accumulator, all in
// registers (the 16 threads of a row group reduce the row max and sum
// with warp shuffles).  The probabilities go through shared memory
// (transposed, so a thread reads its four rows in one load) into the
// P @ V product, where the thread owns head-dim columns cg*VEC + 16*VEC*c.
// The kernel reads the tiles straight from the (B, S, heads, D) layout
// and masks the ragged Sq and Skv edges itself: no padded copy exists.
// Key tiles that no row of the query tile can see (before the window,
// after the causal edge) are skipped.
//
// Scores use the reference's finite sentinel -1e30 semantics.  A row that
// has seen no key yet keeps m = -1e30, l = 0, acc = 0; the reference adds
// exp(0) = 1 terms for such a row, which its first visible key erases
// (alpha = exp(-1e30 - m) = 0), so skipping them gives the same result.
// A row that sees no key at all gets the reference's answer,
// sum(V[:Skv]) / Skv_padded, from an extra pass over V that runs only in
// blocks holding such a row; Skv_padded = ceil(Skv / blk_k) * blk_k comes
// from the wrapper.
//
// What bounds it on an H100: the two products, 4 * D FLOPs per visible
// (query, key) pair and head, here on the CUDA cores in float32 (67
// TFLOP/s) where the bound counts the bf16 tensor-core rate (989
// TFLOP/s); at decode (Sq = 1) the K and V bytes, which each query head
// re-reads (H / Hk times).  Tensor cores (wgmma), TMA and a ring of tiles
// are left to a later design.
#include <cuda_bf16.h>

#include "parentt.cuh"

namespace {

typedef __nv_bfloat16 bf16;

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
  static_assert(N == 2 || N == 4, "two or four elements");
  if constexpr (sizeof(T) == 4 && N == 4) {
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
  constexpr int VEC = D >= 64 ? 4 : 2;             // head-dim columns per load in P @ V
  constexpr int NCH = D / (kGroups * VEC);         // such loads per thread and key
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
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the attention on `stream`; returns cudaGetLastError().
int parentt_attention(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                      int Skv, int H, int Hk, int D, int is_bf16, int causal, long long window,
                      long long q_offset, long long skv_padded, float scale, float softcap,
                      void* stream) {
  const AttnArgs a{q, k, v, o, B, Sq, Skv, H, Hk, causal, window, q_offset, skv_padded, scale,
                   softcap};
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_d<bf16>(a, D, s) : launch_d<float>(a, D, s));
}

const char* parentt_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
