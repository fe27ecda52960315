// Tile loads shared by the quantized and d-tiled forwards H4-kvq
// (kvquant_attention.cu) and H5 (dtiled_attention.cu): int8 or e4m3 codes
// converted to bf16 or fp16 on their way into shared memory (exact: every
// int8 and every e4m3 value fits the 8-bit mantissa of bf16 and the range
// and 11-bit mantissa of fp16), and a bf16 tile cut from a wider row.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace eft {

// element type of K and V (the kv_kind argument of the C entry points)
enum KvKind : int { KV_BF16 = 0, KV_INT8 = 1, KV_FP8 = 2 };

template <int KIND>
__device__ __forceinline__ float code_to_float(uint8_t x) {
  if constexpr (KIND == KV_INT8) {
    return float(static_cast<int8_t>(x));
  } else {
    __nv_fp8_e4m3 f;
    f.__x = x;
    return float(f);
  }
}

__device__ __forceinline__ void store_float(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

__device__ __forceinline__ void store_float(__half* dst, float x) {
  *dst = __float2half_rn(x);
}

// 16 codes at src (16-byte aligned) -> 16 T (bf16 or fp16) at dst
// (16-byte aligned)
template <int KIND, typename T>
__device__ __forceinline__ void codes16_to(T* dst, const uint8_t* src) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const uint8_t* x = reinterpret_cast<const uint8_t*>(&raw);
  __align__(16) T out[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) store_float(&out[e], code_to_float<KIND>(x[e]));
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(out)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(out)[1];
}

// Rows [row0, row0 + 64), columns [col0, col0 + W) of a [n_rows, ld]
// matrix of codes (KIND int8 or e4m3, converted to T) or of bf16
// (KV_BF16, T bf16) into a shared tile of row stride LDT; rows past
// n_rows are zero.
template <int KIND, typename T, int W, int LDT>
__device__ __forceinline__ void load_tile_as(T* dst, const void* src,
                                             int row0, int n_rows, int ld,
                                             int col0) {
  static_assert(KIND != KV_BF16 || sizeof(T) == 2, "bf16 is copied as is");
  constexpr int VEC = KIND == KV_BF16 ? 8 : 16;   // elements per 16 bytes
  constexpr int PER_ROW = W / VEC;
  for (int i = threadIdx.x; i < 64 * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * VEC;
    T* d = dst + r * LDT + c;
    const size_t at = size_t(row0 + r) * ld + col0 + c;
    if (row0 + r >= n_rows) {
      reinterpret_cast<uint4*>(d)[0] = make_uint4(0u, 0u, 0u, 0u);
      if (VEC == 16) reinterpret_cast<uint4*>(d)[1] = make_uint4(0u, 0u, 0u, 0u);
    } else if constexpr (KIND == KV_BF16) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(
          static_cast<const __nv_bfloat16*>(src) + at);
    } else {
      codes16_to<KIND>(d, static_cast<const uint8_t*>(src) + at);
    }
  }
}

}  // namespace eft
