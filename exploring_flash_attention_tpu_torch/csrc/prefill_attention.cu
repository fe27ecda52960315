// H1: causal prefill attention on Hopper (sm_90a). bf16 in, f32 accumulate.
//
// Replaces two TPU kernels of the JAX package that compute the same
// function and differ only by which of them fits the TPU core's VMEM:
//   B4 _v1_onepass_causal_kernel   exploring_flash_attention_tpu/ops/attention_v1.py:489
//   B8 _onepass_partial_kernel     exploring_flash_attention_tpu/ops/attention_v2_splitkv.py:51
// Both return a normalized O and the natural-log row LSE (scale included)
// of causal attention under the decode convention: the q rows are the last
// Lq positions, so row i sees key j iff j <= i + diag_off, where
// diag_off = q_pos0 - kv_pos0 (Lkv - Lq by default).  A row that sees no
// key gives (O = 0, LSE = -inf).
//
// Design.  One block per (batch*q-head, 64-row Q tile); the block walks
// the K/V tiles of its GQA KV head (h / group) only up to its causal
// limit, with an online softmax in f32: S = Q K^T on bf16 WMMA tiles,
// p = exp2(S * scale * log2e - m) (the scale folded into one multiply), P
// rounded to bf16 before P V (as B4 does), l summed from the rounded P.
// The ragged edges (Lq and Lkv not multiples of 64) and the diagonal are
// masked inside the kernel.  O is kept in f32 shared memory between tiles
// because WMMA accumulator fragments have no documented element layout to
// rescale in registers.
//
// Cost at the generation slice (B=8, Hq=8, Hkv=4, L=256, d=128): about
// 4*8*8*128*256*128.5 = 1.1 GFLOP per layer over 8*8*4 = 256 blocks, i.e.
// a few microseconds of tensor-core work: the kernel is launch- and
// latency-bound there, not FLOP-bound.  A fast version would replace the
// WMMA + shared-memory round trips with wgmma on register-resident S/P/O,
// feed K/V through a multi-stage TMA ring with producer/consumer warps
// (FlashAttention-2/3 on Hopper), and at long L split KV across blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using namespace eft;

template <int D>
__global__ void __launch_bounds__(THREADS)
prefill_attention_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hq, Lq, D]
                         const __nv_bfloat16* __restrict__ k,   // [B, Hkv, Lkv, D]
                         const __nv_bfloat16* __restrict__ v,   // [B, Hkv, Lkv, D]
                         __nv_bfloat16* __restrict__ o,         // [B, Hq, Lq, D]
                         float* __restrict__ lse,               // [B, Hq, Lq]
                         int hq, int group, int lq, int lkv, int diag_off,
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

  // the tile's last row sees keys [0, kv_end); later tiles are skipped
  const int q_last = min(q0 + BQ, lq) - 1;
  const int kv_end = min(lkv, q_last + diag_off + 1);

  load_tile<D>(sq, qb, q0, lq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) so[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    sm[r] = -CUDART_INF_F;
    sl[r] = 0.f;
  }
  __syncthreads();

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    load_tile<D>(sk, kb, kv0, lkv);
    load_tile<D>(sv, vb, kv0, lkv);
    __syncthreads();

    warp_qk<D>(sq, sk, ss, r0);            // S = Q K^T, this warp's rows
    __syncwarp();

    // online softmax over the warp's rows, in the exp2 basis
    for (int r = r0; r < r0 + 16; ++r) {
      const int qi = q0 + r;
      const int lim = qi + diag_off;             // last visible key
      float s[BKV / 32];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int col = lane + 32 * c;
        const int kj = kv0 + col;
        const bool vis = qi < lq && kj < lkv && kj <= lim;
        s[c] = vis ? ss[r * L::LDS + col] * scale_log2 : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[c]);
      }
      tmax = warp_max(tmax);
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, tmax);
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

  // normalize and store; the natural-log LSE is m * ln2 + ln(l)
  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= lq) break;
    const float l_raw = sl[r];
    const float denom = l_raw == 0.f ? 1.f : l_raw;
    __nv_bfloat16* orow = o + (size_t(bh) * lq + qi) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = __float2bfloat16(so[r * L::LDO + c] / denom);
    if (lane == 0)
      lse[size_t(bh) * lq + qi] =
          l_raw == 0.f ? -CUDART_INF_F
                       : sm[r] * 0.6931471805599453f + logf(denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int batch, int hq, int hkv, int lq, int lkv, int diag_off,
           float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      prefill_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(batch * hq, (lq + BQ - 1) / BQ);
  prefill_attention_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), hq,
      hq / hkv, lq, lkv, diag_off, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention.py has already checked shapes, dtypes, contiguity and
// alignment; the checks here only refuse what would index out of bounds.
extern "C" int eft_prefill_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int batch, int hq, int hkv, int lq,
                                     int lkv, int d, int diag_off,
                                     float scale, int device, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || lq <= 0 || lkv <= 0)
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, k, v, o, lse, batch, hq, hkv, lq, lkv, diag_off,
                        scale, s);
    case 128:
      return launch<128>(q, k, v, o, lse, batch, hq, hkv, lq, lkv, diag_off,
                         scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* eft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
