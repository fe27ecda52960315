// H2: the merge of split-KV partials on Hopper (sm_90a).  f32 in, one
// rounding to bf16 or f32 out.
//
// Replaces the TPU kernel
//   B10 _combine_kernel   exploring_flash_attention_tpu/ops/attention_v2_splitkv.py:330
// Each of nkb partials holds an O normalized over its KV span and the
// span's natural-log LSE; a row's attention over the whole KV is
//   O = sum_k w_k O_k,  w_k = exp(lse_k - max lse) / sum_j exp(lse_j - max lse)
// as B10 computes it.  A row whose partials are all (0, -inf) gives O = 0.
//
// Design.  One warp per output row (batch*head, q row); each lane owns
// D / 32 columns, so every partial's row is read once, coalesced, and the
// weights (one exp per partial, the same in every lane) never leave
// registers.  The work is a pass over the partials' bytes: nkb * D * 4
// read and D * 2 or 4 written per row, bound by HBM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 8;                 // warps, one row each, per block

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
__global__ void __launch_bounds__(ROWS * 32)
splitkv_combine_kernel(const float* __restrict__ o_part,  // [BH, nkb, Lq, D]
                       const float* __restrict__ lse,     // [BH, nkb, Lq]
                       void* __restrict__ o,              // [BH, Lq, D]
                       int out_f32, int n_rows, int nkb, int lq) {
  const int row = blockIdx.x * ROWS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int bh = row / lq;
  const int qi = row % lq;
  // partial k of this row sits at (bh * nkb + k) * lq + qi
  const size_t first = size_t(bh) * nkb * lq + qi;

  float m = -CUDART_INF_F;
  for (int kb = lane; kb < nkb; kb += 32)
    m = fmaxf(m, lse[first + size_t(kb) * lq]);
  m = warp_max(m);
  const float m_use = m == -CUDART_INF_F ? 0.f : m;
  float den = 0.f;
  for (int kb = lane; kb < nkb; kb += 32)
    den += expf(lse[first + size_t(kb) * lq] - m_use);
  den = warp_sum(den);
  const float inv = 1.f / (den == 0.f ? 1.f : den);

  float acc[D / 32];
#pragma unroll
  for (int j = 0; j < D / 32; ++j) acc[j] = 0.f;
  for (int kb = 0; kb < nkb; ++kb) {
    const size_t r = first + size_t(kb) * lq;
    const float w = expf(lse[r] - m_use) * inv;
    const float* src = o_part + r * D;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) acc[j] += w * src[lane + 32 * j];
  }
  const size_t out = size_t(row) * D;
  if (out_f32) {
    float* dst = static_cast<float*>(o) + out;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) dst[lane + 32 * j] = acc[j];
  } else {
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(o) + out;
#pragma unroll
    for (int j = 0; j < D / 32; ++j)
      dst[lane + 32 * j] = __float2bfloat16(acc[j]);
  }
}

template <int D>
int launch(const void* o_part, const void* lse, void* o, int out_f32,
           int n_rows, int nkb, int lq, cudaStream_t stream) {
  const dim3 grid((n_rows + ROWS - 1) / ROWS);
  splitkv_combine_kernel<D><<<grid, ROWS * 32, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(lse), o,
      out_f32, n_rows, nkb, lq);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_v2_splitkv.py has already checked shapes, dtypes and
// contiguity.  n_bh = batch * heads; d in {32, 64, 128}.
extern "C" int eft_splitkv_combine(const void* o_part, const void* lse,
                                   void* o, int n_bh, int nkb, int lq, int d,
                                   int out_f32, int device, void* stream) {
  if (n_bh <= 0 || nkb <= 0 || lq <= 0 ||
      int64_t(n_bh) * lq > int64_t(INT32_MAX))
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_rows = n_bh * lq;
  switch (d) {
    case 32:
      return launch<32>(o_part, lse, o, out_f32, n_rows, nkb, lq, s);
    case 64:
      return launch<64>(o_part, lse, o, out_f32, n_rows, nkb, lq, s);
    case 128:
      return launch<128>(o_part, lse, o, out_f32, n_rows, nkb, lq, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
