// H4-int8: the fully-int8 attention forward on Hopper (sm_90a).  int8 Q,
// K and V with per-block f32 scales, non-causal, bf16 or f32 O.
//
// Replaces the TPU kernel
//   B18 _int8_kernel   exploring_flash_attention_tpu/ops/attention_int8.py:50
// and computes its function, a one-pass softmax: m is the row max over
// every key, l sums the f32 p, and P V runs in one of two modes:
//   pv_mode bf16: P rounded to bf16, V's codes converted to bf16 (exact),
//                 bf16 WMMA, the f32 product times v_scale (:111-119);
//   pv_mode int8: p_i8 = round(p * 127), half to even (__float2int_rn, as
//                 jnp.round), int8 x int8 -> int32 WMMA, exact, times
//                 v_scale / 127 (:96-100, :119).
// The int8 codes of P depend on the final row max, so an online softmax
// (a running max) would compute another function.  So each block makes two
// passes over its keys in one launch: the first runs only the int8 Q K^T
// products and takes each row's max; the second recomputes S, forms P
// against the fixed max and accumulates P V, with no rescaling.
//
// S = Q_i8 K_i8^T on int8 WMMA (16x16x16, int32 accumulate) is exact;
// q_scale[row / q_block] * k_scale[key / kv_block] * scale * log2e folds
// into the exp2 argument (:85-89), in B18's order.  The V scale is applied
// per run of 16-key WMMA steps that share one scale block, so any kv block
// that is a multiple of 16 works, a ragged last one included: each run's
// product goes through a per-warp 16x16 scratch into O, which lives in f32
// shared memory (WMMA fragments have no documented element layout, so an
// int32 fragment cannot be added into a float one in registers).  Int8
// fragments start on 32-byte boundaries only in the chunked layout of
// quant_tile.cuh's load_i8_chunked, which Q, K, V (int8 mode) and P (int8
// mode) use.
//
// Cost at the canonical shape (B=32, H=8, L=1024, d=128): 68.7 G int8
// operations for Q K^T and 68.7 G for P V, bf16 in pv_mode bf16: 0.104 ms
// at 1,979 TOP/s int8 and 989 TFLOP/s bf16 (0.069 ms all int8), against
// ~134 MB of int8 Q, K, V and bf16 O, 0.040 ms at 3.35 TB/s: bound by the
// tensor cores.  The first pass repeats the Q K^T half.  A fast form runs
// both products on Hopper's int8 wgmma with register-resident S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tile.cuh"
#include "quant_tile.cuh"

namespace {

using namespace eft;
using namespace nvcuda;

// Shared memory of one block: D int8 columns chunked [D/16][64][16] for Q
// and K; V as bf16 [64][LDH] (bf16 mode) or chunked int8 (int8 mode); S
// int32 [64][LDS]; P bf16 [64][LDP] or chunked int8 [4][64][16]; O f32
// [64][LDO]; one 16x16 f32/int32 scratch per warp; per-row and per-key
// scalars.
template <int D>
struct Int8Layout {
  using L = Layout<D>;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + size_t(BQ) * D;
  static constexpr size_t v = k + size_t(BKV) * D;
  static constexpr size_t s = v + size_t(BKV) * L::LDH * 2;
  static constexpr size_t p = s + size_t(BQ) * L::LDS * 4;
  static constexpr size_t o = p + size_t(BQ) * L::LDP * 2;
  static constexpr size_t acc = o + size_t(BQ) * L::LDO * 4;
  static constexpr size_t row_qs = acc + size_t(WARPS) * 256 * 4;
  static constexpr size_t row_m = row_qs + BQ * 4;
  static constexpr size_t row_l = row_m + BQ * 4;
  static constexpr size_t key_ks = row_l + BQ * 4;
  static constexpr size_t key_vs = key_ks + BKV * 4;
  static constexpr size_t key_blk = key_vs + BKV * 4;
  static constexpr size_t bytes = key_blk + BKV * 4;
};

// S[r0 .. r0+16, 64] = Q K^T (int32) for the calling warp's rows
template <int D>
__device__ __forceinline__ void warp_qk_i8(const int8_t* sq, const int8_t* sk,
                                           int* ss, int r0) {
  using L = Layout<D>;
#pragma unroll
  for (int n = 0; n < BKV / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, int> acc;
    wmma::fill_fragment(acc, 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::col_major> fb;
      wmma::load_matrix_sync(fa, sq + (kk * BQ + r0) * 16, 16);
      wmma::load_matrix_sync(fb, sk + (kk * BKV + n * 16) * 16, 16);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(ss + r0 * L::LDS + n * 16, acc, L::LDS,
                            wmma::mem_row_major);
  }
}

template <int D, bool PV_INT8>
__global__ void __launch_bounds__(THREADS)
int8_attention_kernel(const int8_t* __restrict__ q,    // [BH, Lq, D]
                      const int8_t* __restrict__ k,    // [BH, Lkv, D]
                      const int8_t* __restrict__ v,    // [BH, Lkv, D]
                      const float* __restrict__ qs,    // [BH, n_qb]
                      const float* __restrict__ ks,    // [BH, n_kvb]
                      const float* __restrict__ vs,    // [BH, n_kvb]
                      void* __restrict__ o,            // [BH, Lq, D]
                      int out_f32, int lq, int lkv, int q_block, int n_qb,
                      int kv_block, int n_kvb, float scale_log2) {
  using L = Layout<D>;
  using S = Int8Layout<D>;
  using PT = typename std::conditional<PV_INT8, signed char, __nv_bfloat16>::type;
  using AT = typename std::conditional<PV_INT8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* sq = reinterpret_cast<int8_t*>(smem + S::q);
  int8_t* sk = reinterpret_cast<int8_t*>(smem + S::k);
  int* ss = reinterpret_cast<int*>(smem + S::s);
  float* so = reinterpret_cast<float*>(smem + S::o);
  float* sqs = reinterpret_cast<float*>(smem + S::row_qs);
  float* sm = reinterpret_cast<float*>(smem + S::row_m);
  float* sl = reinterpret_cast<float*>(smem + S::row_l);
  float* sks = reinterpret_cast<float*>(smem + S::key_ks);
  float* svs = reinterpret_cast<float*>(smem + S::key_vs);
  int* sblk = reinterpret_cast<int*>(smem + S::key_blk);

  const int bh = blockIdx.x;
  const int q0 = blockIdx.y * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int8_t* kb = k + size_t(bh) * lkv * D;
  const int8_t* vb = v + size_t(bh) * lkv * D;
  const float* ksb = ks + size_t(bh) * n_kvb;
  const float* vsb = vs + size_t(bh) * n_kvb;
  AT* sacc = reinterpret_cast<AT*>(smem + S::acc) + warp * 256;

  load_i8_chunked<D>(sq, q + size_t(bh) * lq * D, q0, lq);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) so[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const int qi = q0 + r;
    sqs[r] = qi < lq ? qs[size_t(bh) * n_qb + qi / q_block] : 0.f;
    sm[r] = -CUDART_INF_F;
    sl[r] = 0.f;
  }

  // pass 1: each row's max of s_i32 * (q_scale * k_scale) * scale * log2e
  for (int kv0 = 0; kv0 < lkv; kv0 += BKV) {
    __syncthreads();             // Q staged / the previous tile consumed
    load_i8_chunked<D>(sk, kb, kv0, lkv);
    for (int t = threadIdx.x; t < BKV; t += THREADS)
      sks[t] = kv0 + t < lkv ? ksb[(kv0 + t) / kv_block] : 0.f;
    __syncthreads();
    warp_qk_i8<D>(sq, sk, ss, r0);
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int col = lane + 32 * c;
        if (kv0 + col < lkv)
          tmax = fmaxf(tmax, __fmul_rn(float(ss[r * L::LDS + col]),
                                       sqs[r] * sks[col] * scale_log2));
      }
      tmax = warp_max(tmax);
      if (lane == 0) sm[r] = fmaxf(sm[r], tmax);
    }
  }

  // pass 2: P against the fixed max, O += (P V) * v_scale
  PT* sp = reinterpret_cast<PT*>(smem + S::p);
  for (int kv0 = 0; kv0 < lkv; kv0 += BKV) {
    __syncthreads();
    load_i8_chunked<D>(sk, kb, kv0, lkv);
    if constexpr (PV_INT8)
      load_i8_chunked<D>(reinterpret_cast<int8_t*>(smem + S::v), vb, kv0, lkv);
    else
      load_tile_as<KV_INT8, __nv_bfloat16, D, L::LDH>(
          reinterpret_cast<__nv_bfloat16*>(smem + S::v), vb, kv0, lkv, D, 0);
    for (int t = threadIdx.x; t < BKV; t += THREADS) {
      const int key = kv0 + t;
      const bool valid = key < lkv;
      sks[t] = valid ? ksb[key / kv_block] : 0.f;
      svs[t] = valid ? vsb[key / kv_block] * (PV_INT8 ? 1.f / 127.f : 1.f) : 0.f;
      sblk[t] = key / kv_block;
    }
    __syncthreads();
    warp_qk_i8<D>(sq, sk, ss, r0);
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const float m = sm[r];
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < BKV / 32; ++c) {
        const int col = lane + 32 * c;
        float p = 0.f;
        // s = s_i32 * cc and s - m each rounded, as B18 computes them
        // (no fused multiply-add)
        if (kv0 + col < lkv && m != -CUDART_INF_F)
          p = exp2f(__fsub_rn(__fmul_rn(float(ss[r * L::LDS + col]),
                                        sqs[r] * sks[col] * scale_log2), m));
        psum += p;
        if constexpr (PV_INT8)
          sp[((col / 16) * BQ + r) * 16 + col % 16] =
              static_cast<signed char>(__float2int_rn(p * 127.f));
        else
          sp[r * L::LDP + col] = __float2bfloat16(p);
      }
      psum = warp_sum(psum);
      if (lane == 0) sl[r] += psum;
    }
    __syncwarp();

    // O[r0 .. r0+16, n*16 ..] += v_scale * P[:, run] V[run, n*16 ..] per
    // run of 16-key steps inside one scale block
    for (int n = 0; n < D / 16; ++n) {
      for (int kk = 0; kk < BKV / 16;) {
        int kend = kk + 1;
        while (kend < BKV / 16 && sblk[kend * 16] == sblk[kk * 16]) ++kend;
        wmma::fragment<wmma::accumulator, 16, 16, 16, AT> acc;
        wmma::fill_fragment(acc, AT(0));
        for (int j = kk; j < kend; ++j) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, PT, wmma::row_major> fa;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, PT, wmma::row_major> fb;
          if constexpr (PV_INT8) {
            wmma::load_matrix_sync(fa, sp + (j * BQ + r0) * 16, 16);
            wmma::load_matrix_sync(
                fb, reinterpret_cast<const signed char*>(smem + S::v) +
                        (n * BKV + j * 16) * 16, 16);
          } else {
            wmma::load_matrix_sync(fa, sp + r0 * L::LDP + j * 16, L::LDP);
            wmma::load_matrix_sync(
                fb, reinterpret_cast<const __nv_bfloat16*>(smem + S::v) +
                        j * 16 * L::LDH + n * 16, L::LDH);
          }
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(sacc, acc, 16, wmma::mem_row_major);
        __syncwarp();
        const float f = svs[kk * 16];
        for (int e = lane; e < 256; e += 32)
          so[(r0 + e / 16) * L::LDO + n * 16 + e % 16] += float(sacc[e]) * f;
        __syncwarp();
        kk = kend;
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
      float* orow = static_cast<float*>(o) + row * D;
      for (int c = lane; c < D; c += 32) orow[c] = so[r * L::LDO + c] / denom;
    } else {
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(o) + row * D;
      for (int c = lane; c < D; c += 32)
        orow[c] = __float2bfloat16(so[r * L::LDO + c] / denom);
    }
  }
}

template <int D, bool PV_INT8>
int launch(const void* q, const void* k, const void* v, const void* qs,
           const void* ks, const void* vs, void* o, int out_f32, int bh,
           int lq, int lkv, int q_block, int n_qb, int kv_block, int n_kvb,
           float scale_log2, cudaStream_t stream) {
  const size_t bytes = Int8Layout<D>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      int8_attention_kernel<D, PV_INT8>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(bh, (lq + BQ - 1) / BQ);
  int8_attention_kernel<D, PV_INT8><<<grid, THREADS, bytes, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const int8_t*>(v), static_cast<const float*>(qs),
      static_cast<const float*>(ks), static_cast<const float*>(vs), o,
      out_f32, lq, lkv, q_block, n_qb, kv_block, n_kvb, scale_log2);
  return int(cudaGetLastError());
}

template <int D>
int launch_mode(int pv_int8, const void* q, const void* k, const void* v,
                const void* qs, const void* ks, const void* vs, void* o,
                int out_f32, int bh, int lq, int lkv, int q_block, int n_qb,
                int kv_block, int n_kvb, float scale_log2,
                cudaStream_t stream) {
  if (pv_int8)
    return launch<D, true>(q, k, v, qs, ks, vs, o, out_f32, bh, lq, lkv,
                           q_block, n_qb, kv_block, n_kvb, scale_log2, stream);
  return launch<D, false>(q, k, v, qs, ks, vs, o, out_f32, bh, lq, lkv,
                          q_block, n_qb, kv_block, n_kvb, scale_log2, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_int8.py has already checked shapes, dtypes, contiguity and
// alignment; the checks here only refuse what would index out of bounds.
// kv_block must be a multiple of 16; scale_log2 = softmax scale * log2(e).
extern "C" int eft_int8_attention(const void* q, const void* k, const void* v,
                                  const void* qs, const void* ks,
                                  const void* vs, void* o, int batch,
                                  int heads, int lq, int lkv, int d,
                                  int q_block, int n_qb, int kv_block,
                                  int n_kvb, int pv_int8, int out_f32,
                                  float scale_log2, int device, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lkv <= 0 || q_block <= 0 ||
      n_qb != (lq + q_block - 1) / q_block || kv_block <= 0 ||
      kv_block % 16 != 0 || n_kvb != (lkv + kv_block - 1) / kv_block)
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_mode<64>(pv_int8, q, k, v, qs, ks, vs, o, out_f32,
                             batch * heads, lq, lkv, q_block, n_qb, kv_block,
                             n_kvb, scale_log2, s);
    case 128:
      return launch_mode<128>(pv_int8, q, k, v, qs, ks, vs, o, out_f32,
                              batch * heads, lq, lkv, q_block, n_qb, kv_block,
                              n_kvb, scale_log2, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
