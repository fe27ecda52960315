// H5: the d-tiled attention forward on Hopper (sm_90a), for head dims 128
// to 512 (multiples of 128).  bf16 Q; K and V bf16, or int8 or e4m3 codes
// with one f32 scale per `block` keys; non-causal, f32 accumulate, bf16
// or f32 O.
//
// Replaces the TPU kernel
//   B19 _dtiled_kernel   exploring_flash_attention_tpu/ops/attention_v1_dtiled.py:75
// and computes what it computes; its grid of phases per KV tile (n_cq
// S-chunk phases, one softmax phase, n_cv P V-chunk phases) answers the
// TPU's sequential grid and is not copied.
//
// Design.  One block per (batch*head, 64-row Q tile) walks 64-key tiles
// with an online softmax in f32 in the exp2 basis.  Per tile:
//   1. S = sum over 128-wide d-chunks of Q_c K_c^T: each chunk of Q and K
//      is staged in shared memory (K's codes converted to bf16, exactly)
//      and its bf16 WMMA products accumulate into S fragments held in
//      registers across the chunks;
//   2. the softmax on the f32 S: the K scale folds into the exp2 constant,
//      s * (scale * log2e * k_scale[key / block]); l sums the f32 p; P is
//      rounded to bf16 after the V scale rides it, p * v_scale[key / block]
//      (:150-161); O's rows are rescaled by alpha once, full width;
//   3. O[:, c] += P V_c for each 128-wide d-chunk of V, staged like K.
// O is kept full width in f32 shared memory (WMMA accumulator fragments
// have no documented element layout to rescale in registers; the
// reference's tiled_d flash_attention_v1.h keeps it in registers): at
// d=512 that is 132 KB of the block's 195 KB, so one block runs per SM and
// d above 512 would not fit; the wrapper raises there.  Keys past Lkv are
// masked before the exp and their V scale is zero; rows past Lq are not
// written, so neither length needs to divide a tile.
//
// Cost at B=4, H=8, L=1024, d=512: 68.7 GFLOP, 0.069 ms at 989 TFLOP/s
// bf16, against 134 MB of bf16 Q, K, V and O (0.040 ms at 3.35 TB/s):
// bound by the tensor cores.  With four warps per SM and Q re-staged per
// KV tile this simple form reaches a few per cent of it; a fast form keeps
// a smaller O slice per warpgroup in wgmma registers and streams the
// chunks through a TMA ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "attention_tile.cuh"
#include "quant_tile.cuh"

namespace {

using namespace eft;
using namespace nvcuda;

constexpr int DC = 128;                 // d-chunk width
constexpr int LDC = DC + PAD_H;         // bf16 chunk rows
constexpr int MAX_D = 512;

struct DtiledLayout {
  static constexpr size_t q = 0;                                  // [64][LDC] bf16
  static constexpr size_t kv = q + size_t(BQ) * LDC * 2;          // [64][LDC] bf16
  static constexpr size_t s = kv + size_t(BKV) * LDC * 2;         // [64][LDS] f32
  static constexpr size_t p = s + size_t(BQ) * (BKV + PAD_F) * 4; // [64][LDP] bf16
  static constexpr size_t stats = p + size_t(BQ) * (BKV + PAD_H) * 2;
  static constexpr size_t o = stats + size_t(5) * 64 * 4;         // [64][d + 4] f32
  static size_t bytes(int d) { return o + size_t(BQ) * (d + PAD_F) * 4; }
};

template <int KIND>
__global__ void __launch_bounds__(THREADS)
dtiled_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [BH, Lq, d]
                        const void* __restrict__ k,           // [BH, Lkv, d]
                        const void* __restrict__ v,           // [BH, Lkv, d]
                        const float* __restrict__ ks,         // [BH, n_blocks] or null
                        const float* __restrict__ vs,         // [BH, n_blocks] or null
                        void* __restrict__ o,                 // [BH, Lq, d]
                        int out_f32, int lq, int lkv, int d, int block,
                        int n_blocks, float scale_log2) {
  using D = DtiledLayout;
  constexpr int LDS = BKV + PAD_F;
  constexpr int LDP = BKV + PAD_H;
  constexpr size_t ELEM = KIND == KV_BF16 ? 2 : 1;     // bytes of a K/V element
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + D::q);
  __nv_bfloat16* skv = reinterpret_cast<__nv_bfloat16*>(smem + D::kv);
  float* ss = reinterpret_cast<float*>(smem + D::s);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + D::p);
  float* sm = reinterpret_cast<float*>(smem + D::stats);
  float* sl = sm + 64;
  float* salpha = sl + 64;
  float* sks = salpha + 64;              // scale * log2e * k_scale per key
  float* svs = sks + 64;                 // v_scale per key, 0 past Lkv
  float* so = reinterpret_cast<float*>(smem + D::o);
  const int ldo = d + PAD_F;

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const __nv_bfloat16* qb = q + size_t(bh) * lq * d;
  const unsigned char* kb =
      static_cast<const unsigned char*>(k) + size_t(bh) * lkv * d * ELEM;
  const unsigned char* vb =
      static_cast<const unsigned char*>(v) + size_t(bh) * lkv * d * ELEM;

  for (int i = threadIdx.x; i < BQ * ldo; i += THREADS) so[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    sm[r] = -CUDART_INF_F;
    sl[r] = 0.f;
  }

  for (int kv0 = 0; kv0 < lkv; kv0 += BKV) {
    // 1. S = Q K^T over the d-chunks, in registers
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc[BKV / 16];
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(sacc[n], 0.f);
    for (int c0 = 0; c0 < d; c0 += DC) {
      __syncthreads();           // the previous chunk or tile is consumed
      load_tile_as<KV_BF16, __nv_bfloat16, DC, LDC>(sq, qb, q0, lq, d, c0);
      load_tile_as<KIND, __nv_bfloat16, DC, LDC>(skv, kb, kv0, lkv, d, c0);
      if (c0 == 0) {
        for (int t = threadIdx.x; t < BKV; t += THREADS) {
          const int key = kv0 + t;
          const bool valid = key < lkv;
          if constexpr (KIND == KV_BF16) {
            sks[t] = scale_log2;
            svs[t] = valid ? 1.f : 0.f;
          } else {
            sks[t] = valid ? scale_log2 * ks[size_t(bh) * n_blocks + key / block] : 0.f;
            svs[t] = valid ? vs[size_t(bh) * n_blocks + key / block] : 0.f;
          }
        }
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) {
#pragma unroll
        for (int kk = 0; kk < DC / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> fb;
          wmma::load_matrix_sync(fa, sq + r0 * LDC + kk * 16, LDC);
          wmma::load_matrix_sync(fb, skv + n * 16 * LDC + kk * 16, LDC);
          wmma::mma_sync(sacc[n], fa, fb, sacc[n]);
        }
      }
    }
#pragma unroll
    for (int n = 0; n < BKV / 16; ++n)
      wmma::store_matrix_sync(ss + r0 * LDS + n * 16, sacc[n], LDS,
                              wmma::mem_row_major);
    __syncwarp();

    // 2. online softmax over the warp's rows, in the exp2 basis
    for (int r = r0; r < r0 + 16; ++r) {
      float s[BKV / 32];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int col = lane + 32 * c;
        s[c] = kv0 + col < lkv ? ss[r * LDS + col] * sks[col] : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[c]);
      }
      tmax = warp_max(tmax);
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, tmax);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int col = lane + 32 * c;
        const float p = exp2f(s[c] - m_use);
        psum += p;                                  // l sums the unscaled p
        sp[r * LDP + col] = __float2bfloat16(p * svs[col]);
      }
      psum = warp_sum(psum);
      const float alpha = exp2f(m_old - m_use);
      if (lane == 0) {
        sm[r] = m_new;
        sl[r] = sl[r] * alpha + psum;
      }
      for (int c = lane; c < d; c += 32) so[r * ldo + c] *= alpha;
    }
    __syncwarp();

    // 3. O[:, c0 .. c0+128] += P V_c over the d-chunks
    for (int c0 = 0; c0 < d; c0 += DC) {
      __syncthreads();           // every warp is done with the K or V chunk
      load_tile_as<KIND, __nv_bfloat16, DC, LDC>(skv, vb, kv0, lkv, d, c0);
      __syncthreads();
#pragma unroll
      for (int n = 0; n < DC / 16; ++n) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        float* optr = so + r0 * ldo + c0 + n * 16;
        wmma::load_matrix_sync(acc, optr, ldo, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BKV / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> fb;
          wmma::load_matrix_sync(fa, sp + r0 * LDP + kk * 16, LDP);
          wmma::load_matrix_sync(fb, skv + kk * 16 * LDC + n * 16, LDC);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(optr, acc, ldo, wmma::mem_row_major);
      }
    }
  }
  __syncthreads();

  for (int r = r0; r < r0 + 16; ++r) {
    const int qi = q0 + r;
    if (qi >= lq) break;
    const float denom = sl[r] == 0.f ? 1.f : sl[r];
    const size_t row = size_t(bh) * lq + qi;
    if (out_f32) {
      float* orow = static_cast<float*>(o) + row * d;
      for (int c = lane; c < d; c += 32) orow[c] = so[r * ldo + c] / denom;
    } else {
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(o) + row * d;
      for (int c = lane; c < d; c += 32)
        orow[c] = __float2bfloat16(so[r * ldo + c] / denom);
    }
  }
}

template <int KIND>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* o, int out_f32, int bh, int lq, int lkv,
           int d, int block, int n_blocks, float scale_log2,
           cudaStream_t stream) {
  const size_t bytes = DtiledLayout::bytes(d);
  const cudaError_t err = cudaFuncSetAttribute(
      dtiled_attention_kernel<KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(DtiledLayout::bytes(MAX_D)));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(bh, (lq + BQ - 1) / BQ);
  dtiled_attention_kernel<KIND><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v,
      static_cast<const float*>(ks), static_cast<const float*>(vs), o,
      out_f32, lq, lkv, d, block, n_blocks, scale_log2);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_v1_dtiled.py has already checked shapes, dtypes,
// contiguity and alignment; the checks here only refuse what would index
// out of bounds.  kv_kind: 0 bf16 (ks, vs unused), 1 int8, 2 e4m3;
// d a multiple of 128 up to 512; scale_log2 = softmax scale * log2(e).
extern "C" int eft_dtiled_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, void* o, int batch,
                                    int heads, int lq, int lkv, int d,
                                    int block, int n_blocks, int kv_kind,
                                    int out_f32, float scale_log2,
                                    int device, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lkv <= 0 || d <= 0 ||
      d % DC != 0 || d > MAX_D ||
      (kv_kind != KV_BF16 &&
       (block <= 0 || n_blocks != (lkv + block - 1) / block)))
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (kv_kind) {
    case KV_BF16:
      return launch<KV_BF16>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, d,
                             block, n_blocks, scale_log2, s);
    case KV_INT8:
      return launch<KV_INT8>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, d,
                             block, n_blocks, scale_log2, s);
    case KV_FP8:
      return launch<KV_FP8>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, d,
                            block, n_blocks, scale_log2, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
