// Pieces of the WMMA attention kernel H6-extend (paged_extend.cu), its only
// user: the shared-memory layout of one 64-row Q tile against 64-column
// K/V tiles, the warp reductions, and each warp's two tensor-core products
// on its 16 rows.
//
// H6-extend keeps S, P and O in shared memory between the products,
// because WMMA accumulator fragments have no documented element layout to
// rescale in registers.  Four warps each own 16 rows.  H1, H3, H4-int8,
// H4-kvq and H5 run on wgmma instead (wgmma_tile.cuh).

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

namespace eft {

constexpr int BQ = 64;        // Q rows per block
constexpr int BKV = 64;       // K/V rows per tile
constexpr int WARPS = 4;      // each warp owns 16 Q rows
constexpr int THREADS = WARPS * 32;
// Row padding.  A WMMA fragment's base must be 32-byte aligned; fragments
// start on multiples of 16 rows and 16 columns, and 16 padded rows are a
// multiple of 32 bytes at every D (at D = 32 a bf16 row is 80 bytes, so
// single rows are only 16-byte aligned, which the 16-byte tile loads need).
constexpr int PAD_H = 8;      // bf16 row padding
constexpr int PAD_F = 4;      // f32 row padding

template <int D>
struct Layout {
  static constexpr int LDH = D + PAD_H;      // Q, K, V rows (bf16)
  static constexpr int LDS = BKV + PAD_F;    // S rows (f32)
  static constexpr int LDP = BKV + PAD_H;    // P rows (bf16)
  static constexpr int LDO = D + PAD_F;      // O rows (f32)
  static constexpr size_t q = 0;
  static constexpr size_t k = q + size_t(BQ) * LDH * 2;
  static constexpr size_t v = k + size_t(BKV) * LDH * 2;
  static constexpr size_t s = v + size_t(BKV) * LDH * 2;
  static constexpr size_t p = s + size_t(BQ) * LDS * 4;
  static constexpr size_t o = p + size_t(BQ) * LDP * 2;
  static constexpr size_t m = o + size_t(BQ) * LDO * 4;
  static constexpr size_t l = m + size_t(BQ) * 4;
  static constexpr size_t alpha = l + size_t(BQ) * 4;
  static constexpr size_t bytes = alpha + size_t(BQ) * 4;
};

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

// S[r0 .. r0+16, 64] = Q K^T for the calling warp's rows
template <int D>
__device__ __forceinline__ void warp_qk(const __nv_bfloat16* sq,
                                        const __nv_bfloat16* sk, float* ss,
                                        int r0) {
  using namespace nvcuda;
  using L = Layout<D>;
#pragma unroll
  for (int n = 0; n < BKV / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> fb;
      wmma::load_matrix_sync(fa, sq + r0 * L::LDH + kk * 16, L::LDH);
      wmma::load_matrix_sync(fb, sk + n * 16 * L::LDH + kk * 16, L::LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(ss + r0 * L::LDS + n * 16, acc, L::LDS,
                            wmma::mem_row_major);
  }
}

// O[r0 .. r0+16, D] = alpha[row] * O + P V for the calling warp's rows
template <int D>
__device__ __forceinline__ void warp_rescale_pv(const __nv_bfloat16* sp,
                                                const __nv_bfloat16* sv,
                                                float* so, const float* salpha,
                                                int r0, int lane) {
  using namespace nvcuda;
  using L = Layout<D>;
  for (int r = r0; r < r0 + 16; ++r) {
    const float alpha = salpha[r];
    for (int c = lane; c < D; c += 32) so[r * L::LDO + c] *= alpha;
  }
  __syncwarp();
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, so + r0 * L::LDO + n * 16, L::LDO,
                           wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb;
      wmma::load_matrix_sync(fa, sp + r0 * L::LDP + kk * 16, L::LDP);
      wmma::load_matrix_sync(fb, sv + kk * 16 * L::LDH + n * 16, L::LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(so + r0 * L::LDO + n * 16, acc, L::LDO,
                            wmma::mem_row_major);
  }
}

}  // namespace eft
