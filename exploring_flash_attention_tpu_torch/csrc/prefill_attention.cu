// H1: the attention forward on Hopper (sm_90a). bf16 in, f32 accumulate,
// one kernel for three masks (none, causal, sliding window) and head dims
// 32, 64 and 128.
//
// Replaces the TPU kernels of the JAX package's dense forward, which
// compute one function and differ from each other only by a VMEM rule
// (one-pass vs streaming, heads folded per program), by the MXU's slow
// depth-32 products (B6/B7 compute S^T and O^T), or by the mask:
//   B1 _v1_onepass_fold_kernel       exploring_flash_attention_tpu/ops/attention_v1.py:1139
//   B2 _v1_onepass_kernel            exploring_flash_attention_tpu/ops/attention_v1.py:387
//   B3 _v1_kernel                    exploring_flash_attention_tpu/ops/attention_v1.py:213
//   B4 _v1_onepass_causal_kernel     exploring_flash_attention_tpu/ops/attention_v1.py:489
//   B5 _v1_onepass_window_kernel     exploring_flash_attention_tpu/ops/attention_v1.py:901
//   B6 _v1_onepass_kernel_pvt        exploring_flash_attention_tpu/ops/attention_v1.py:1261
//   B7 _v1_onepass_pvt_pipe_kernel   exploring_flash_attention_tpu/ops/attention_v1.py:1357
//   B8 _onepass_partial_kernel       exploring_flash_attention_tpu/ops/attention_v2_splitkv.py:51
//   B9 _splitkv_fwd_kernel           exploring_flash_attention_tpu/ops/attention_v2_splitkv.py:213
// It returns a normalized O (bf16 or f32, rounded once from the f32
// accumulator) and, when asked, the natural-log row LSE (scale included).
// With a KV span (a multiple of 64 keys) the grid gains a third axis, one
// block per (batch*q-head, Q tile, span), and each block writes the
// partial (O normalized over its span, the span's LSE) of B8's multi-span
// form and B9 into o [B, Hq, nkb, Lq, D] and lse [B, Hq, nkb, Lq];
// H2 (splitkv_combine.cu) merges them.  B9's traced offsets are not
// ported here.
// Causal and window masks use the decode convention: row i sits at
// position i + diag_off of the key axis (diag_off = q_pos0 - kv_pos0,
// Lkv - Lq by default) and sees key j iff j <= i + diag_off; a window
// further needs j >= i + diag_off - window + 1 (inclusive of the row's
// own position, as oracle/reference.py:51).  A row that sees no key gives
// (O = 0, LSE = -inf).
//
// Design.  One block per (batch*q-head, 64-row Q tile); the block walks
// the K/V tiles of its GQA KV head (h / group) with an online softmax in
// f32: S = Q K^T on bf16 WMMA tiles, p = exp2(S * scale * log2e - m) (the
// scale folded into one multiply), P rounded to bf16 before P V (as B4
// does), l summed from the rounded P.  Causal stops at the tile holding
// the Q tile's last visible key; a window also starts at the tile holding
// its first row's first visible key, so tiles wholly outside the band are
// never loaded (B5's sliding slice, B3's clamped index map at
// attention_v1.py:1760-1775).  The bounds are per Q tile and the mask per
// row: each row's edges are masked inside the tiles.  They are computed
// in 64 bits, so no diagonal offset overflows.  O is kept in f32 shared
// memory between tiles because WMMA accumulator fragments have no
// documented element layout to rescale in registers.  At D = 32 the
// depth-32 products are plain WMMA k-steps; the transposed forms of B6/B7
// answer a TPU matrix-unit shape and have no counterpart here.
//
// Cost at the canonical shape (B=32, H=8, L=1024, d=128, non-causal):
// 4*32*8*1024*1024*128 = 137.4 GFLOP, 0.139 ms at the H100's 989 TFLOP/s
// dense bf16, while Q, K, V and O (268 MB in bf16) take 0.080 ms at
// 3.35 TB/s: the bound is the tensor cores.  This kernel reaches a few
// per cent of it: four warps per block and every product through shared
// memory.  A fast version (later work) keeps S, P and O in registers on
// wgmma, feeds K/V through a multi-stage TMA ring with producer/consumer
// warps (FlashAttention-3's shape on Hopper).  A long KV over few Q tiles
// leaves SMs idle (B=1, H=8, Lq=1024: 128 blocks for 132 SMs): the span
// mode spreads such a call over more blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using namespace eft;

// the mask argument of eft_prefill_attention
enum Mask : int { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

__device__ __forceinline__ long long clamp64(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hq, Lq, D]
                         const __nv_bfloat16* __restrict__ k,   // [B, Hkv, Lkv, D]
                         const __nv_bfloat16* __restrict__ v,   // [B, Hkv, Lkv, D]
                         void* __restrict__ o,                  // [B, Hq, Lq, D]
                         int out_f32,                           // o f32, else bf16
                         float* __restrict__ lse,               // [B, Hq, Lq] or null
                         int hq, int group, int lq, int lkv, int mask,
                         int diag_off, int window, int kv_span,
                         float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  float* so = reinterpret_cast<float*>(smem + L::o);
  float* sm = reinterpret_cast<float*>(smem + L::m);
  float* sl = reinterpret_cast<float*>(smem + L::l);
  float* salpha = reinterpret_cast<float*>(smem + L::alpha);

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const int bhk = b * (hq / group) + h / group;      // GQA KV head
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  const __nv_bfloat16* qb = q + size_t(bh) * lq * D;
  const __nv_bfloat16* kb = k + size_t(bhk) * lkv * D;
  const __nv_bfloat16* vb = v + size_t(bhk) * lkv * D;

  // the K/V tiles [kv_begin, kv_end) of this block's span that some row
  // of this Q tile sees: the last row's causal limit ends them, the first
  // row's window edge starts them (rounded down to a tile); a block whose
  // span holds none of them writes (0, -inf)
  const int span = blockIdx.z;
  const int span0 = span * kv_span;
  int kv_begin = span0, kv_end = min(lkv, span0 + kv_span);
  if (mask != MASK_NONE) {
    const long long q_last = min(q0 + BQ, lq) - 1;
    kv_end = min(kv_end, int(clamp64(q_last + diag_off + 1, 0, lkv)));
  }
  if (mask == MASK_WINDOW) {
    const long long first = (long long)q0 + diag_off - window + 1;
    kv_begin = max(kv_begin, int(clamp64(first, 0, lkv)) / BKV * BKV);
  }

  load_tile<D>(sq, qb, q0, lq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) so[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    sm[r] = -CUDART_INF_F;
    sl[r] = 0.f;
  }
  __syncthreads();

  for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
    load_tile<D>(sk, kb, kv0, lkv);
    load_tile<D>(sv, vb, kv0, lkv);
    __syncthreads();

    warp_qk<D>(sq, sk, ss, r0);            // S = Q K^T, this warp's rows
    __syncwarp();

    // online softmax over the warp's rows, in the exp2 basis
    for (int r = r0; r < r0 + 16; ++r) {
      const int qi = q0 + r;
      // the row sees keys [lo, hi]; rows past Lq see none
      int lo = 0, hi = lkv - 1;
      if (mask != MASK_NONE) {
        const long long last = (long long)qi + diag_off;
        hi = int(clamp64(last, -1, lkv - 1));
        if (mask == MASK_WINDOW)
          lo = int(clamp64(last - window + 1, 0, lkv));
      }
      if (qi >= lq) hi = -1;
      float s[BKV / 32];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int col = lane + 32 * c;
        const int kj = kv0 + col;
        const bool vis = kj >= lo && kj <= hi;
        s[c] = vis ? ss[r * L::LDS + col] * scale_log2 : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[c]);
      }
      tmax = warp_max(tmax);
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, tmax);
      // a row that has seen no key yet keeps m = -inf, p = 0, l = 0
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const __nv_bfloat16 p = __float2bfloat16(exp2f(s[c] - m_use));
        sp[r * L::LDP + lane + 32 * c] = p;
        psum += __bfloat162float(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        sm[r] = m_new;
        sl[r] = sl[r] * alpha + psum;
        salpha[r] = alpha;
      }
    }
    __syncwarp();

    warp_rescale_pv<D>(sp, sv, so, salpha, r0, lane);   // O = alpha O + P V
    __syncthreads();            // sK / sV are rewritten by the next tile
  }

  // normalize and store once from f32; the natural-log LSE is
  // m * ln2 + ln(l)
  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= lq) break;
    const float l_raw = sl[r];
    const float denom = l_raw == 0.f ? 1.f : l_raw;
    const size_t row = (size_t(bh) * gridDim.z + span) * lq + qi;
    if (out_f32) {
      float* orow = static_cast<float*>(o) + row * D;
      for (int c = lane; c < D; c += 32) orow[c] = so[r * L::LDO + c] / denom;
    } else {
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(o) + row * D;
      for (int c = lane; c < D; c += 32)
        orow[c] = __float2bfloat16(so[r * L::LDO + c] / denom);
    }
    if (lse != nullptr && lane == 0)
      lse[row] = l_raw == 0.f ? -CUDART_INF_F
                              : sm[r] * 0.6931471805599453f + logf(denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           int out_f32, void* lse, int batch, int hq, int hkv, int lq,
           int lkv, int mask, int diag_off, int window, int kv_span,
           float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  // no span: one span of whole tiles covering the KV
  const int span = kv_span ? kv_span : (lkv + BKV - 1) / BKV * BKV;
  const dim3 grid(batch * hq, (lq + BQ - 1) / BQ, (lkv + span - 1) / span);
  prefill_attention_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), o, out_f32,
      static_cast<float*>(lse), hq, hq / hkv, lq, lkv, mask, diag_off,
      window, span, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention.py has already checked shapes, dtypes, contiguity and
// alignment; the checks here only refuse what would index out of bounds.
// mask: 0 none, 1 causal, 2 window (window >= 1); lse may be null.
// kv_span: 0 for one span over the whole KV, else a multiple of 64 keys,
// and o / lse hold cdiv(lkv, kv_span) partials per row.
extern "C" int eft_prefill_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int batch, int hq, int hkv, int lq,
                                     int lkv, int d, int mask, int diag_off,
                                     int window, int kv_span, int out_f32,
                                     float scale, int device, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || lq <= 0 || lkv <= 0 ||
      mask < MASK_NONE || mask > MASK_WINDOW ||
      (mask == MASK_WINDOW && window < 1) || kv_span < 0 ||
      kv_span % BKV != 0)
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv,
                        mask, diag_off, window, kv_span, scale, s);
    case 64:
      return launch<64>(q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv,
                        mask, diag_off, window, kv_span, scale, s);
    case 128:
      return launch<128>(q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv,
                         mask, diag_off, window, kv_span, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* eft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
