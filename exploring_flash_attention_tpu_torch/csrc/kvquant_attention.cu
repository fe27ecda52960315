// H4-kvq: the attention forward over a quantized K/V on Hopper (sm_90a).
// bf16 Q, int8 or e4m3 K and V with one f32 scale per `block` keys,
// non-causal, f32 accumulate, bf16 or f32 O.
//
// Replaces two TPU kernels of the JAX package that compute one function
// and differ only by a VMEM rule (one pass when the quantized KV fits,
// attention_v1.py:93, else streaming):
//   B16 _kvquant_kernel           exploring_flash_attention_tpu/ops/attention_kvquant.py:47
//   B17 _kvquant_onepass_kernel   exploring_flash_attention_tpu/ops/attention_kvquant.py:114
//
// Design.  attention_tile.cuh's WMMA loop without a mask: one block per
// (batch*head, 64-row Q tile) walks 64-key tiles with an online softmax in
// f32 in the exp2 basis.  Each K/V tile's codes convert on their way into
// shared memory (exact), because WMMA takes no fp8 operand: K to bf16,
// for S = Q K_codes^T on bf16 WMMA tiles (attention_tile.cuh); V to
// fp16, for P V on fp16 WMMA tiles.  The scales are read per key,
// scale[key / block], so any block works, a ragged last one included:
//   - the K scale folds into the S-column multiply,
//     s * (k_scale * scale * log2e), as B17 folds it (attention_kvquant.py:147);
//   - the V scale: each tile's P V is multiplied by the largest V scale
//     among its keys, vmax, after the product, as B16 multiplies its tile's
//     P V by v_s (:104); P's columns carry the rest, p * (v_scale / vmax),
//     which is p itself wherever the tile lies in one scale block (every
//     block a multiple of 64).  l sums the unscaled f32 p, as B16 does
//     (:92).
// The limit that follows: P is rounded to fp16, 2^-11 relative per weight
// (B16 and B17 round it to bf16, 2^-8; the ratio keeps P in [0, 1], so
// fp16's range holds for any scale).  A uniform vmax needs no fragment
// element layout: the tile's product is a fresh accumulator fragment added
// into O's, both of one fragment type.
// Keys past Lkv are masked before the exp and their V scale is zero.

// Cost at the canonical shape (B=32, H=8, L=1024, d=128): 137.4 GFLOP,
// 0.139 ms at 989 TFLOP/s bf16, against ~201 MB of bf16 Q and O and int8
// K and V, 0.060 ms at 3.35 TB/s: the bound is the tensor cores.  This
// simple form reaches a few per cent of it (four warps, every product
// through shared memory); the fast form is H1's and H4-int8's on
// wgmma_tile.cuh (a TMA ring, S, P and O in registers), with e4m3 wgmma at
// twice the bf16 rate or the codes converted into the V buffer.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "quant_tile.cuh"

namespace {

using namespace eft;

// O[r0 .. r0+16, D] = alpha[row] * O + vmax * (P V) for the calling
// warp's rows, P and V in fp16
template <int D>
__device__ __forceinline__ void warp_rescale_pv_scaled(
    const __half* sp, const __half* sv, float* so, const float* salpha,
    float vmax, int r0, int lane) {
  using namespace nvcuda;
  using L = Layout<D>;
  for (int r = r0; r < r0 + 16; ++r) {
    const float alpha = salpha[r];
    for (int c = lane; c < D; c += 32) so[r * L::LDO + c] *= alpha;
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc, pv;
    wmma::load_matrix_sync(acc, so + r0 * L::LDO + n * 16, L::LDO,
                           wmma::mem_row_major);
    wmma::fill_fragment(pv, 0.f);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __half, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __half, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, sp + r0 * L::LDP + kk * 16, L::LDP);
      wmma::load_matrix_sync(fb, sv + kk * 16 * L::LDH + n * 16, L::LDH);
      wmma::mma_sync(pv, fa, fb, pv);
    }
    // one scalar for the whole fragment: no element layout needed
#pragma unroll
    for (int e = 0; e < acc.num_elements; ++e) acc.x[e] += vmax * pv.x[e];
    wmma::store_matrix_sync(so + r0 * L::LDO + n * 16, acc, L::LDO,
                            wmma::mem_row_major);
  }
}

template <int D, int KIND>
__global__ void __launch_bounds__(THREADS)
kvquant_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [BH, Lq, D]
                         const uint8_t* __restrict__ k,        // [BH, Lkv, D] codes
                         const uint8_t* __restrict__ v,        // [BH, Lkv, D] codes
                         const float* __restrict__ ks,         // [BH, n_blocks]
                         const float* __restrict__ vs,         // [BH, n_blocks]
                         void* __restrict__ o,                 // [BH, Lq, D]
                         int out_f32, int lq, int lkv, int block,
                         int n_blocks, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __half* sv = reinterpret_cast<__half*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  __half* sp = reinterpret_cast<__half*>(smem + L::p);
  float* so = reinterpret_cast<float*>(smem + L::o);
  float* sm = reinterpret_cast<float*>(smem + L::m);
  float* sl = reinterpret_cast<float*>(smem + L::l);
  float* salpha = reinterpret_cast<float*>(smem + L::alpha);
  float* sks = reinterpret_cast<float*>(smem + L::bytes);   // k_scale * scale * log2e
  float* svs = sks + BKV;                                   // v_scale, 0 past Lkv

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const uint8_t* kb = k + size_t(bh) * lkv * D;
  const uint8_t* vb = v + size_t(bh) * lkv * D;
  const float* ksb = ks + size_t(bh) * n_blocks;
  const float* vsb = vs + size_t(bh) * n_blocks;

  load_tile<D>(sq, q + size_t(bh) * lq * D, q0, lq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) so[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    sm[r] = -CUDART_INF_F;
    sl[r] = 0.f;
  }

  for (int kv0 = 0; kv0 < lkv; kv0 += BKV) {
    __syncthreads();             // Q staged / the previous tile consumed
    load_tile_as<KIND, __nv_bfloat16, D, L::LDH>(sk, kb, kv0, lkv, D, 0);
    load_tile_as<KIND, __half, D, L::LDH>(sv, vb, kv0, lkv, D, 0);
    for (int t = threadIdx.x; t < BKV; t += THREADS) {
      const int key = kv0 + t;
      sks[t] = key < lkv ? ksb[key / block] * scale_log2 : 0.f;
      svs[t] = key < lkv ? vsb[key / block] : 0.f;
    }
    __syncthreads();

    warp_qk<D>(sq, sk, ss, r0);            // S = Q K_codes^T, this warp's rows
    // the tile's largest V scale and each column's share of it, 1
    // wherever the tile lies in one scale block
    const float vmax = warp_max(fmaxf(fabsf(svs[lane]), fabsf(svs[lane + 32])));
    float ratio[BKV / 32];
#pragma unroll
    for (int c = 0; c < BKV / 32; ++c)
      ratio[c] = vmax > 0.f ? svs[lane + 32 * c] / vmax : 0.f;
    __syncwarp();

    for (int r = r0; r < r0 + 16; ++r) {
      float s[BKV / 32];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int col = lane + 32 * c;
        s[c] = kv0 + col < lkv ? ss[r * L::LDS + col] * sks[col] : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[c]);
      }
      tmax = warp_max(tmax);
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, tmax);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const float p = exp2f(s[c] - m_use);
        psum += p;                                  // l sums the unscaled p
        sp[r * L::LDP + lane + 32 * c] = __float2half_rn(p * ratio[c]);
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

    // O = alpha O + vmax (P V)
    warp_rescale_pv_scaled<D>(sp, sv, so, salpha, vmax, r0, lane);
  }
  __syncthreads();               // O and l complete

  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= lq) break;
    const float denom = sl[r] == 0.f ? 1.f : sl[r];
    const size_t row = size_t(bh) * lq + qi;
    if (out_f32) {
      float* orow = static_cast<float*>(o) + row * D;
      for (int c = lane; c < D; c += 32) orow[c] = so[r * L::LDO + c] / denom;
    } else {
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(o) + row * D;
      for (int c = lane; c < D; c += 32)
        orow[c] = __float2bfloat16(so[r * L::LDO + c] / denom);
    }
  }
}

template <int D, int KIND>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* o, int out_f32, int bh, int lq, int lkv,
           int block, int n_blocks, float scale_log2, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes + 2 * BKV * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      kvquant_attention_kernel<D, KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(bh, (lq + BQ - 1) / BQ);
  kvquant_attention_kernel<D, KIND><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), o, out_f32, lq, lkv, block, n_blocks,
      scale_log2);
  return int(cudaGetLastError());
}

template <int D>
int launch_kind(int kv_kind, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, void* o, int out_f32, int bh,
                int lq, int lkv, int block, int n_blocks, float scale_log2,
                cudaStream_t stream) {
  if (kv_kind == KV_INT8)
    return launch<D, KV_INT8>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, block,
                              n_blocks, scale_log2, stream);
  return launch<D, KV_FP8>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, block,
                           n_blocks, scale_log2, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_kvquant.py has already checked shapes, dtypes, contiguity
// and alignment; the checks here only refuse what would index out of
// bounds.  kv_kind: 1 int8, 2 e4m3; scale_log2 = softmax scale * log2(e).
extern "C" int eft_kvquant_attention(const void* q, const void* k,
                                     const void* v, const void* ks,
                                     const void* vs, void* o, int batch,
                                     int heads, int lq, int lkv, int d,
                                     int block, int n_blocks, int kv_kind,
                                     int out_f32, float scale_log2,
                                     int device, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lkv <= 0 || block <= 0 ||
      n_blocks != (lkv + block - 1) / block ||
      (kv_kind != KV_INT8 && kv_kind != KV_FP8))
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_kind<64>(kv_kind, q, k, v, ks, vs, o, out_f32,
                             batch * heads, lq, lkv, block, n_blocks,
                             scale_log2, s);
    case 128:
      return launch_kind<128>(kv_kind, q, k, v, ks, vs, o, out_f32,
                              batch * heads, lq, lkv, block, n_blocks,
                              scale_log2, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
