// What H1's four translation units share: prefill_attention.cu (the bf16
// kernel of d up to 256 and the C entry), prefill_attention_f32.cu (the f32
// kernel of d up to 256), prefill_attention_wide.cu (bf16 d 257 to 512) and
// prefill_attention_wide_f32.cu (f32 d 257 to 512), which compile at once.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace eft {
namespace prefill {

// a KV span is whole tiles of SPAN_TILE keys, which the bound statistic's
// prefix maxima (ops/attention.py bound_kmax) also take
constexpr int SPAN_TILE = 128;
// the row statistic's group: a row's bound reads the K/V tile that the last
// row of its 128-row group sees, whatever the Q tile
constexpr int BOUND_ROWS = 128;
constexpr float BOUND_SHIFT = 64.f;

// the mask argument of eft_prefill_attention
enum Mask : int { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

__device__ __forceinline__ long long clamp64(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// H1 at f32 q/k/v (prefill_attention_f32.cu): eft_prefill_attention's
// launch with in_f32, on the f32 core's instance D = 64, 128 or 256 of d
// and the statistic kmax names (null: exact)
int launch_f32(const void* q, const void* k, const void* v, void* o,
               int out_f32, void* lse, int batch, int hq, int hkv, int lq,
               int lkv, int d, int mask, int diag_off, int window,
               const int* offs, int kv_span, float scale, const float* kmax,
               cudaStream_t stream);

// H1 at bf16 d 257 to 512 (prefill_attention_wide.cu): eft_prefill_attention's
// launch on wide_attention.cuh's block (H5's, with the masks, spans, LSE
// and the bound statistic), at 64-row Q tiles whatever q_rows
int launch_wide(const void* q, const void* k, const void* v, void* o,
                int out_f32, void* lse, int batch, int hq, int hkv, int lq,
                int lkv, int d, int mask, int diag_off, int window,
                const int* offs, int kv_span, float scale, const float* kmax,
                cudaStream_t stream);

// H1 at f32 d 257 to 512 (prefill_attention_wide_f32.cu):
// eft_prefill_attention's launch with in_f32 on H5's f32 block in clusters
// of two (dtiled_attention.cuh, with the masks, spans, LSE and the bound
// statistic), at 64-row Q tiles whatever q_rows
int launch_wide_f32(const void* q, const void* k, const void* v, void* o,
                    int out_f32, void* lse, int batch, int hq, int hkv,
                    int lq, int lkv, int d, int mask, int diag_off,
                    int window, const int* offs, int kv_span, float scale,
                    const float* kmax, cudaStream_t stream);

}  // namespace prefill
}  // namespace eft
