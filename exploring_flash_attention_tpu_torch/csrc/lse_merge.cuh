// The LSE-weighted merge of split-KV partials, written once for both of
// its forms: H2 (splitkv_combine.cu, the split path of flash_attention_v1)
// and the last block of each (sequence, KV head) in H6-decode
// (paged_decode.cu), which merges the runs of its own launch.
//
// The arithmetic is B10's (exploring_flash_attention_tpu/ops/
// attention_v2_splitkv.py:330-341): over a row's nkb partials (O_k, lse_k),
//   m = max_k lse_k            (0 when every lse_k is -inf)
//   w_k = exp(lse_k - m) / sum_j exp(lse_j - m)   (a zero sum taken as 1)
//   O = sum_k w_k O_k          in f32, rounded once by the caller.
//
// Layout.  A row of d columns (a multiple of 4, or any d read a float at
// a time: ANY) is owned by a group of L
// lanes of one warp (L a power of two up to 32: 32 / L rows a warp), lane j
// holding NV chunks of 4 columns, chunk v at columns 4 (j + L v) .. + 3,
// each read as one 16-byte load per partial; a chunk at or past d is idle
// (no load, no store; it adds nothing).  At d = 4L (d = 32, 64, 128) that
// is one chunk a lane, none idle; at d = 80 one chunk on 32 lanes, 20 of
// them busy; at d = 256 two chunks on 32 lanes, at d = 512 four (one warp
// a row up to d 512, so the max and the sum stay shuffles).  The row's LSEs are
// read once, lse_k by lane k % L of the group; the max and the sum reduce
// by shuffles within the group, and each weight, computed once by the lane
// that read its LSE, reaches the other lanes by __shfl_sync.  No LSE is
// read inside the O loop, which is unrolled by 4 partials so that four
// 16-byte loads are in flight before the first FMA; the first four are
// issued beside the LSE load, ahead of the reductions.
//
// More than L partials are taken L at a time (a round); the running max
// rescales the sum and O of the earlier rounds as in an online softmax,
// and the last round folds 1 / sum into its weights.  With nkb <= L (one
// round) this is exactly w_k = exp(lse_k - m) * inv as above.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace eft {

// kL2: the partials were written by other blocks of the same launch (the
// decode merge), so they are read through L2 (ld.global.cg); L1 is not
// coherent across SMs.  Otherwise they are a finished input, read once by
// the read-only path without allocating in L1.
template <bool kL2>
__device__ __forceinline__ float merge_load(const float* p) {
  if constexpr (kL2) {
    return __ldcg(p);
  } else {
    return __ldg(p);
  }
}

template <bool kL2>
__device__ __forceinline__ float4 merge_load4(const float* p) {
  if constexpr (kL2) {
    return __ldcg(reinterpret_cast<const float4*>(p));
  } else {
    float4 v;                           // not volatile: free to schedule
    asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
        : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
        : "l"(p));
    return v;
  }
}

template <int L>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, L));
  return x;
}

template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, L);
  return x;
}

// Whether this lane's chunk v of a row of d columns holds columns.
template <int L>
__device__ __forceinline__ bool merge_chunk(int v, int d) {
  return 4 * (int(threadIdx.x % L) + L * v) < d;
}

// Four f32 of a row from p, a float at a time: those of columns below n
// (rows of a d that is not a multiple of 4 are not 16-byte aligned)
template <bool kL2>
__device__ __forceinline__ float4 merge_load4_any(const float* p, int n) {
  float x[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = i < n ? merge_load<kL2>(p + i) : 0.f;
  return make_float4(x[0], x[1], x[2], x[3]);
}

// Partials u < cnt (cnt <= U) of this lane's chunks, from row `r` on in
// steps of `stride` rows of d floats; zeros past cnt, in idle chunks and
// (ANY: a float at a time) past d.
template <int L, int NV, int U, bool kL2, bool ANY = false>
__device__ __forceinline__ void merge_load_group(float4 (&v)[U][NV],
                                                 const float* col, size_t r,
                                                 size_t stride, int cnt,
                                                 int d) {
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const float* p = col + (r + u * stride) * d + 4 * L * c;
      if (!(u < cnt && merge_chunk<L>(c, d)))
        v[u][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      else if constexpr (ANY)
        v[u][c] = merge_load4_any<kL2>(
            p, d - 4 * (int(threadIdx.x % L) + L * c));
      else
        v[u][c] = merge_load4<kL2>(p);
    }
}

// The merged f32 O of one row, this lane's NV chunks (zero where idle).
// Partial k of the row is row `first + k * stride` of o_part [.., d] and
// of lse.  Every lane of the warp calls it with the same nkb (the shuffles
// take the whole warp); a lane whose row does not exist passes a row that
// does and drops the result.  ANY: d need not be a multiple of 4.
template <int L, int NV, int U, bool kL2, bool ANY = false>
__device__ __forceinline__ void lse_merge_row(float4 (&acc)[NV],
                                              const float* __restrict__ o_part,
                                              const float* __restrict__ lse,
                                              size_t first, size_t stride,
                                              int nkb, int d) {
  const int j = threadIdx.x % L;        // this lane's place in its group
  const float* col = o_part + 4 * j;
#pragma unroll
  for (int c = 0; c < NV; ++c) acc[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = -CUDART_INF_F, den = 0.f;
  for (int c0 = 0; c0 < nkb; c0 += L) {
    const int n = min(L, nkb - c0);     // partials in this round
    const size_t r0 = first + size_t(c0) * stride;
    const float x = j < n ? merge_load<kL2>(lse + r0 + size_t(j) * stride)
                          : -CUDART_INF_F;
    float4 v[U][NV];
    merge_load_group<L, NV, U, kL2, ANY>(v, col, r0, stride, min(n, U), d);
    const float m_new = fmaxf(m, group_max<L>(x));
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
    float w = expf(x - m_use);          // 0 where lse_k is -inf
    float alpha = expf(m - m_use);      // 0 before the first finite lse
    den = den * alpha + group_sum<L>(w);
    m = m_new;
    if (c0 + L >= nkb) {                // the last round: fold in 1 / sum
      const float inv = 1.f / (den == 0.f ? 1.f : den);
      w *= inv;
      alpha *= inv;
    }
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      acc[c].x *= alpha;
      acc[c].y *= alpha;
      acc[c].z *= alpha;
      acc[c].w *= alpha;
    }
    for (int i = 0;;) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float wu = __shfl_sync(0xffffffffu, w, min(i + u, n - 1), L);
        const float wk = i + u < n ? wu : 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c) {
          acc[c].x = fmaf(wk, v[u][c].x, acc[c].x);
          acc[c].y = fmaf(wk, v[u][c].y, acc[c].y);
          acc[c].z = fmaf(wk, v[u][c].z, acc[c].z);
          acc[c].w = fmaf(wk, v[u][c].w, acc[c].w);
        }
      }
      i += U;
      if (i >= n) break;
      merge_load_group<L, NV, U, kL2, ANY>(v, col, r0 + size_t(i) * stride,
                                           stride, min(n - i, U), d);
    }
  }
}

// The lanes per row and 16-byte chunks per lane of a row of D columns: the
// smallest power of two of lanes (at most 32) that hold D / 4 chunks.
template <int D>
struct MergeRow {
  static constexpr int CHUNKS = D / 4;
  static constexpr int L = CHUNKS > 16 ? 32 : CHUNKS > 8 ? 16
                         : CHUNKS > 4 ? 8 : 4;
  static constexpr int NV = (CHUNKS + L - 1) / L;
  static_assert(D % 16 == 0 && D <= 512, "d is a multiple of 16 up to 512");
};

// Four f32 values as this lane writes them to a row of O at dst: those
// of columns below n, one at a time (a row of any d)
template <class T>
__device__ __forceinline__ void store4_any(T* dst, float4 v, int n) {
  const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < n) {
      if constexpr (std::is_same_v<T, float>) dst[i] = x[i];
      else dst[i] = __float2bfloat16(x[i]);
    }
}

// Four f32 values rounded to bf16 and written as one 8-byte store.
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 packed;
  packed.x = *reinterpret_cast<const uint32_t*>(&lo);
  packed.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(dst) = packed;
}

}  // namespace eft
