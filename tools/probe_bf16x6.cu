// A one-tile probe of f32 products on bf16 wgmma by three-piece splits
// (tools/probe_bf16x6.py builds and drives it): each f32 value x is split
// exactly into bf16 pieces hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
// hi - mid), and a product is the sum of piece products, all accumulated
// in one wgmma f32 accumulator, as Mosaic's HIGHEST (bf16x6) computes an
// f32 dot on the TPU's MXU.  The probe asks what Hopper's tensor cores make
// of those sums (their adders may keep fewer bits than an IEEE f32 add),
// with H1's own operand layouts and wgmma wrappers (wgmma_tile.cuh):
//   probe_qk: S [64 x 64] = Q [64 x 128] K^T, both K-major in shared memory
//     (m64n64k16, 8 k-steps per piece product);
//   probe_pv: O [64 x 128] = P [64 x keys] V [keys x 128], P as the bf16 A
//     fragment in registers (H1's P V), V MN-major in shared memory, keys
//     in chunks of 64 into the same accumulator (m64n128k16).
// terms: 1 (hi hi: bf16 inputs, the control), 3 (bf16x3: hi hi, hi mid,
// mid hi) or 6 (bf16x6: those, hi lo, lo hi, mid mid), the smallest first.
// One block of one warpgroup; not a kernel of the port.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../exploring_flash_attention_tpu_torch/csrc/wgmma_tile.cuh"

namespace {

using namespace eft::hopper;

constexpr int D = 128;
constexpr int ROWS = 64;                       // Q rows, keys per chunk
constexpr int PIECE = ROWS * D * 2;            // bytes of one bf16 piece
// the piece products, smallest first: (A piece, B piece) of product t
__host__ __device__ constexpr int piece_a(int t) {
  return t == 0 ? 2 : t == 2 ? 1 : t == 3 ? 1 : 0;
}
__host__ __device__ constexpr int piece_b(int t) {
  return t == 1 ? 2 : t == 2 ? 1 : t == 4 ? 1 : 0;
}

__device__ __forceinline__ void split3(float x, float (&p)[3]) {
  p[0] = __bfloat162float(__float2bfloat16(x));
  p[1] = __bfloat162float(__float2bfloat16(x - p[0]));
  p[2] = __bfloat162float(__float2bfloat16(x - p[0] - p[1]));
}

// rows x 128 f32 (row-major, ld floats) into three bf16 pieces, each as
// two boxes of 64 columns, 128-byte rows, swizzled as a TMA load writes
// them: K-major for Q and K, MN-major for V (keys as rows)
__device__ void stage(unsigned char* dst, const float* src, int ld) {
  for (int x = threadIdx.x; x < ROWS * (D / 8); x += blockDim.x) {
    const int r = x / (D / 8), ch = x % (D / 8);
    float p[8][3];
#pragma unroll
    for (int e = 0; e < 8; ++e) split3(src[size_t(r) * ld + 8 * ch + e], p[e]);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      uint4 w;
      uint32_t* u = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) u[e] = pack_bf16x2(p[2 * e][k], p[2 * e + 1][k]);
      *reinterpret_cast<uint4*>(dst + k * PIECE + (ch / 8) * ROWS * 128 +
                                swz128(r, (ch % 8) * 16)) = w;
    }
  }
}

// TERMS: the last TERMS of the six piece products
template <int TERMS>
__global__ void __launch_bounds__(128) probe_qk_kernel(const float* q,
                                                       const float* k,
                                                       float* s) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sq = align_1024(smem_raw);
  unsigned char* sk = sq + 3 * PIECE;
  stage(sq, q, D);
  stage(sk, k, D);
  fence_proxy_async();
  __syncthreads();
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int t = 6 - TERMS; t < 6; ++t)
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = gmma_desc(sq + piece_a(t) * PIECE +
                                        box * ROWS * 128 + off, 16, 1024, 128);
      const uint64_t db = gmma_desc(sk + piece_b(t) * PIECE +
                                        box * ROWS * 128 + off, 16, 1024, 128);
      wgmma_ss_bf16_n64(acc, da, db, 1);
    }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp % 4) * 16 + lane / 4, col0 = 2 * (lane % 4);
#pragma unroll
  for (int e = 0; e < 32; ++e)
    s[(row0 + acc_row8(e)) * ROWS + col0 + acc_col(e)] = acc[e];
}

template <int TERMS>
__global__ void __launch_bounds__(128) probe_pv_kernel(const float* p,
                                                       const float* v,
                                                       float* o, int keys) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sv = align_1024(smem_raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = (warp % 4) * 16 + lane / 4, col0 = 2 * (lane % 4);
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < keys; k0 += ROWS) {
    __syncthreads();                   // the previous chunk is read
    stage(sv, v + size_t(k0) * D, D);
    fence_proxy_async();
    __syncthreads();
    // P's A fragments of this chunk in three pieces: register j of k-step
    // kk holds (row0 + acc_row8(2j), kk * 16 + acc_col(2j) + col0 + {0, 1}),
    // as H1 packs its S accumulator into P V's A operand
    uint32_t pa[3][ROWS / 4];
#pragma unroll
    for (int j = 0; j < ROWS / 4; ++j) {
      const int e = 2 * (j % 4), kk = j / 4;
      const float* at = p + size_t(row0 + acc_row8(e)) * keys + k0 + kk * 16 +
                        acc_col(e) + col0;
      float x0[3], x1[3];
      split3(at[0], x0);
      split3(at[1], x1);
#pragma unroll
      for (int k = 0; k < 3; ++k) pa[k][j] = pack_bf16x2(x0[k], x1[k]);
    }
    wgmma_fence();
#pragma unroll
    for (int t = 6 - TERMS; t < 6; ++t)
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        const uint32_t* a = &pa[piece_a(t)][4 * kk];
        const uint64_t db = gmma_desc(sv + piece_b(t) * PIECE + kk * 16 * 128,
                                      ROWS * 128, 1024, 128);
        wgmma_rs_bf16_n128(acc, a[0], a[1], a[2], a[3], db, 1);
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        o[(row0 + 8 * r) * D + 8 * j + col0 + c] = acc[4 * j + 2 * r + c];
}

template <int TERMS>
int qk(const void* q, const void* k, void* s) {
  const int bytes = 6 * PIECE + 1024;
  cudaFuncSetAttribute(probe_qk_kernel<TERMS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  probe_qk_kernel<TERMS><<<1, 128, bytes>>>(static_cast<const float*>(q),
                                            static_cast<const float*>(k),
                                            static_cast<float*>(s));
  const cudaError_t launch = cudaGetLastError();
  return int(launch != cudaSuccess ? launch : cudaDeviceSynchronize());
}

template <int TERMS>
int pv(const void* p, const void* v, void* o, int keys) {
  const int bytes = 3 * PIECE + 1024;
  cudaFuncSetAttribute(probe_pv_kernel<TERMS>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  probe_pv_kernel<TERMS><<<1, 128, bytes>>>(static_cast<const float*>(p),
                                            static_cast<const float*>(v),
                                            static_cast<float*>(o), keys);
  const cudaError_t launch = cudaGetLastError();
  return int(launch != cudaSuccess ? launch : cudaDeviceSynchronize());
}

}  // namespace

// q, k: [64, 128] f32; s: [64, 64] f32; terms 1, 3 or 6.  Returns the
// cudaError_t.
extern "C" int probe_qk(const void* q, const void* k, void* s, int terms) {
  if (terms == 1) return qk<1>(q, k, s);
  if (terms == 3) return qk<3>(q, k, s);
  if (terms == 6) return qk<6>(q, k, s);
  return int(cudaErrorInvalidValue);
}

// p: [64, keys] f32 (keys a multiple of 64); v: [keys, 128]; o: [64, 128].
extern "C" int probe_pv(const void* p, const void* v, void* o, int keys,
                        int terms) {
  if (terms == 1) return pv<1>(p, v, o, keys);
  if (terms == 3) return pv<3>(p, v, o, keys);
  if (terms == 6) return pv<6>(p, v, o, keys);
  return int(cudaErrorInvalidValue);
}
