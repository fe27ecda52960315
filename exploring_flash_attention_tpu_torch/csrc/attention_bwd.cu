// H3-dkv and H3-dq: the causal flash-attention backward on Hopper (sm_90a).
// bf16 in, f32 accumulate, bf16 out.
//
// Replace five TPU kernels of the JAX package that compute one gradient
// and differ only by which of them fits the TPU core's VMEM
// (exploring_flash_attention_tpu/ops/attention_bwd.py):
//   B11 _fused_bwd_kernel     :458  dQ, dK and dV per (b, h), all resident
//   B12 _dkv_onepass_kernel   :281  dK/dV per KV tile, Q and dO resident
//   B13 _dq_onepass_kernel    :377  dQ per Q tile, K and V resident
//   B14 _dkv_kernel           :112  tiled dK/dV, grid (bh, n_kv, n_q)
//   B15 _dq_kernel            :205  tiled dQ, grid (bh, n_q, n_kv)
// H3-dkv takes the dK/dV halves and H3-dq the dQ halves.  B11's fused form
// would need a sum of dQ across blocks (atomics), so it is split as B12 and
// B13 are.  Not ported: B14/B15's traced offsets and window masks.
//
//   P  = exp2(S * scale * log2e - lse * log2e),  S = Q K^T,
//        0 where row i does not see key j (j > i + diag_off) and on rows
//        with lse = -inf (rows that see no key)
//   dV = P^T dO      dP = dO V^T      dS = P o (dP - delta) * scale
//   dQ = dS K        dK = dS^T Q
//
// delta = rowsum(dO o O) in f32 comes from the wrapper
// (ops/attention_bwd.py), as in the JAX package.  P and dS are rounded to
// bf16 before their products, as the TPU kernels do (attention_bwd.py:174,
// :192); S, dP and every sum stay f32.
//
// Design: FlashAttention-2's split into two kernels with opposite loop
// orders and no atomics, so a result is bitwise reproducible.
// - H3-dkv: one block per (64-row KV tile, batch * KV head).  The TPU's
//   sequential grid axis becomes a loop inside the block: over the G q
//   heads of the GQA group and, per head, over the Q tiles from the first
//   one whose last row sees this KV tile (kv0 - diag_off, the clamp of
//   attention_bwd.py:826-842) to the end.  Each warp owns 16 KV rows and
//   computes the transposed tiles S^T = K Q^T and dP^T = V dO^T for them, so
//   the rows of P^T and dS^T that dV += P^T dO and dK += dS^T Q need are
//   the warp's own: no block barrier sits between the two phases, only the
//   two that guard the shared Q and dO tiles.  dK and dV accumulate in f32
//   WMMA fragments (registers) over the whole loop, so the GQA sum of
//   attention_bwd.py:670-676 happens in f32 inside the block and no
//   [B * Hq, Lkv, d] f32 partials reach device memory.
// - H3-dq: one block per (batch * q head, 64-row Q tile), the longest rows
//   first, walking the K/V tiles up to its causal limit as H1 does.  Each
//   warp owns 16 Q rows and accumulates dQ += dS K in f32 fragments.
// Results leave the fragments through an f32 staging tile that overlays
// the Q and dO tiles, and are stored in bf16 once.
//
// Shared memory at d = 128 (rows padded as in attention_tile.cuh): four
// bf16 64 x 136 tiles (Q, dO, K, V) 69,632 B; S and dP in f32 64 x 68,
// 34,816 B; dS and (H3-dkv only) P in bf16 64 x 72, 9,216 B each; lse and
// delta 512 B.  H3-dkv 123,392 B, H3-dq 114,176 B: one block per SM.
//
// What bounds it: per (Q tile, KV tile) pair H3-dkv runs four 64 x 64 x d
// tile products and H3-dq three, 7.3 MFLOP at d = 128; the flagship's
// training shape (B=8, Hq=8, Hkv=4, L=1024) has 64 * 136 causal pairs per
// layer, 64 GFLOP issued for ~43 GFLOP of causal work.  With four warps
// per SM and every tile going through shared memory between WMMA products,
// the kernels are bound by tensor-core latency and shared-memory traffic,
// not by the 989 TFLOP/s peak or by HBM.  A fast version would keep S, P
// and dS in registers under wgmma, feed Q/dO and K/V through a multi-stage
// TMA ring with producer and consumer warps (FlashAttention-3), and fuse
// dQ into H3-dkv with atomics or a cross-block reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using namespace eft;
using namespace nvcuda;
using bf16 = __nv_bfloat16;
using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr float LOG2E = 1.4426950408889634f;

template <int D, bool WITH_P>
struct BwdLayout {
  using L = Layout<D>;
  static constexpr size_t tile = size_t(64) * L::LDH * 2;     // bf16 rows
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + tile;
  static constexpr size_t k = dout + tile;
  static constexpr size_t v = k + tile;
  static constexpr size_t s = v + tile;
  static constexpr size_t dp = s + size_t(64) * L::LDS * 4;
  static constexpr size_t ds = dp + size_t(64) * L::LDS * 4;
  static constexpr size_t p = ds + size_t(64) * L::LDP * 2;
  static constexpr size_t lse = p + (WITH_P ? size_t(64) * L::LDP * 2 : 0);
  static constexpr size_t delta = lse + 64 * 4;
  static constexpr size_t bytes = delta + 64 * 4;
  // f32 staging of the result rows, over the Q and dO tiles
  static constexpr int LDR = D + PAD_F;
  static_assert(size_t(64) * LDR * 4 <= 2 * tile, "staging overflows Q, dO");
};

// lse (in the log2 basis) and delta of Q rows [q0, q0 + 64); pad rows get
// lse = -inf, which zeroes their P and dS
__device__ __forceinline__ void load_stats(float* sl, float* sd,
                                           const float* lse,
                                           const float* delta, int q0,
                                           int lq) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool in = q0 + r < lq;
    sl[r] = in ? lse[q0 + r] * LOG2E : -CUDART_INF_F;
    sd[r] = in ? delta[q0 + r] : 0.f;
  }
}

// P and dS of one score in f32: 0 where the key is hidden or the row sees
// no key (lse = -inf would make the exp2 argument +inf)
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse_l2,
                                         float delta, bool visible,
                                         float scale_log2, float scale,
                                         float& p, float& ds) {
  visible = visible && lse_l2 != -CUDART_INF_F;
  p = visible ? exp2f(s * scale_log2 - lse_l2) : 0.f;
  ds = visible ? p * (dp - delta) * scale : 0.f;
}

// acc[n] += A[r0 .. r0+16, 0 .. 64] B[0 .. 64, 16n .. 16n+16] for the
// calling warp: A a bf16 tile of 64 columns (P^T, dS^T or dS), B a bf16
// tile of D columns (dO, Q or K), both row-major
template <int D>
__device__ __forceinline__ void warp_acc(AccFrag (&acc)[D / 16],
                                         const bf16* sa, const bf16* sb,
                                         int r0) {
  using L = Layout<D>;
#pragma unroll
  for (int kk = 0; kk < 64 / 16; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
    wmma::load_matrix_sync(fa, sa + r0 * L::LDP + kk * 16, L::LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fb, sb + kk * 16 * L::LDH + n * 16, L::LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero(AccFrag (&acc)[D / 16]) {
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
}

// Store the warp's 16 result rows as bf16 rows [row0 + r0, + 16) of a
// [n_rows, D] matrix, through the f32 staging tile
template <int D>
__device__ __forceinline__ void warp_store(AccFrag (&acc)[D / 16],
                                           float* stage, bf16* dst,
                                           int row0, int n_rows, int r0,
                                           int lane) {
  constexpr int LDR = BwdLayout<D, false>::LDR;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + r0 * LDR + n * 16, acc[n], LDR,
                            wmma::mem_row_major);
  __syncwarp();
  for (int r = r0; r < r0 + 16 && row0 + r < n_rows; ++r)
    for (int c = lane; c < D; c += 32)
      dst[size_t(row0 + r) * D + c] = __float2bfloat16(stage[r * LDR + c]);
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dkv_kernel(const bf16* __restrict__ q,      // [B, Hq, Lq, D]
                         const bf16* __restrict__ k,      // [B, Hkv, Lkv, D]
                         const bf16* __restrict__ v,      // [B, Hkv, Lkv, D]
                         const bf16* __restrict__ dout,   // [B, Hq, Lq, D]
                         const float* __restrict__ lse,   // [B, Hq, Lq]
                         const float* __restrict__ delta, // [B, Hq, Lq]
                         bf16* __restrict__ dk,           // [B, Hkv, Lkv, D]
                         bf16* __restrict__ dv,           // [B, Hkv, Lkv, D]
                         int hq, int hkv, int lq, int lkv, int diag_off,
                         float scale) {
  using L = Layout<D>;
  using S = BwdLayout<D, true>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + S::q);
  bf16* sdo = reinterpret_cast<bf16*>(smem + S::dout);
  bf16* sk = reinterpret_cast<bf16*>(smem + S::k);
  bf16* sv = reinterpret_cast<bf16*>(smem + S::v);
  float* ss = reinterpret_cast<float*>(smem + S::s);
  float* sdp = reinterpret_cast<float*>(smem + S::dp);
  bf16* sds = reinterpret_cast<bf16*>(smem + S::ds);
  bf16* sp = reinterpret_cast<bf16*>(smem + S::p);
  float* sl = reinterpret_cast<float*>(smem + S::lse);
  float* sd = reinterpret_cast<float*>(smem + S::delta);

  const int kv0 = blockIdx.x * BKV;
  const int bhk = blockIdx.y;                   // b * hkv + KV head
  const int b = bhk / hkv;
  const int group = hq / hkv;
  const int h0 = (bhk % hkv) * group;           // first q head of the group
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;                     // this warp's KV rows
  const float scale_log2 = scale * LOG2E;

  load_tile<D>(sk, k + size_t(bhk) * lkv * D, kv0, lkv);
  load_tile<D>(sv, v + size_t(bhk) * lkv * D, kv0, lkv);

  AccFrag dk_acc[D / 16], dv_acc[D / 16];
  zero<D>(dk_acc);
  zero<D>(dv_acc);

  // Q row i sees key kv0 iff i >= kv0 - diag_off: earlier Q tiles are
  // skipped (a tile past Lq leaves the loop empty)
  const int q_begin = (max(0, kv0 - diag_off) / BQ) * BQ;
  for (int g = 0; g < group; ++g) {
    const size_t bh = size_t(b) * hq + h0 + g;
    for (int q0 = q_begin; q0 < lq; q0 += BQ) {
      __syncthreads();          // every warp is done with the last Q / dO
      load_tile<D>(sq, q + bh * lq * D, q0, lq);
      load_tile<D>(sdo, dout + bh * lq * D, q0, lq);
      load_stats(sl, sd, lse + bh * lq, delta + bh * lq, q0, lq);
      __syncthreads();

      warp_qk<D>(sk, sq, ss, r0);             // S^T = K Q^T, own KV rows
      warp_qk<D>(sv, sdo, sdp, r0);           // dP^T = V dO^T
      __syncwarp();
      for (int r = r0; r < r0 + 16; ++r) {
        const int j = kv0 + r;
#pragma unroll
        for (int cc = 0; cc < BQ / 32; ++cc) {
          const int c = lane + 32 * cc;
          const int i = q0 + c;
          float p, ds;
          p_and_ds(ss[r * L::LDS + c], sdp[r * L::LDS + c], sl[c], sd[c],
                   i < lq && j < lkv && j <= i + diag_off, scale_log2,
                   scale, p, ds);
          sp[r * L::LDP + c] = __float2bfloat16(p);
          sds[r * L::LDP + c] = __float2bfloat16(ds);
        }
      }
      __syncwarp();
      warp_acc<D>(dv_acc, sp, sdo, r0);       // dV += P^T dO
      warp_acc<D>(dk_acc, sds, sq, r0);       // dK += dS^T Q
    }
  }

  __syncthreads();              // the staging tile overlays Q and dO
  float* stage = reinterpret_cast<float*>(smem + S::q);
  warp_store<D>(dk_acc, stage, dk + size_t(bhk) * lkv * D, kv0, lkv, r0,
                lane);
  warp_store<D>(dv_acc, stage, dv + size_t(bhk) * lkv * D, kv0, lkv, r0,
                lane);
}

template <int D>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_kernel(const bf16* __restrict__ q,       // [B, Hq, Lq, D]
                        const bf16* __restrict__ k,       // [B, Hkv, Lkv, D]
                        const bf16* __restrict__ v,       // [B, Hkv, Lkv, D]
                        const bf16* __restrict__ dout,    // [B, Hq, Lq, D]
                        const float* __restrict__ lse,    // [B, Hq, Lq]
                        const float* __restrict__ delta,  // [B, Hq, Lq]
                        bf16* __restrict__ dq,            // [B, Hq, Lq, D]
                        int hq, int group, int lq, int lkv, int diag_off,
                        float scale) {
  using L = Layout<D>;
  using S = BwdLayout<D, false>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem + S::q);
  bf16* sdo = reinterpret_cast<bf16*>(smem + S::dout);
  bf16* sk = reinterpret_cast<bf16*>(smem + S::k);
  bf16* sv = reinterpret_cast<bf16*>(smem + S::v);
  float* ss = reinterpret_cast<float*>(smem + S::s);
  float* sdp = reinterpret_cast<float*>(smem + S::dp);
  bf16* sds = reinterpret_cast<bf16*>(smem + S::ds);
  float* sl = reinterpret_cast<float*>(smem + S::lse);
  float* sd = reinterpret_cast<float*>(smem + S::delta);

  const size_t bh = blockIdx.x;
  const int b = bh / hq;
  const int h = bh % hq;
  const size_t bhk = size_t(b) * (hq / group) + h / group;   // GQA KV head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest rows first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;                     // this warp's Q rows
  const float scale_log2 = scale * LOG2E;

  // the tile's last row sees keys [0, kv_end); later tiles are skipped
  const int q_last = min(q0 + BQ, lq) - 1;
  const int kv_end = min(lkv, q_last + diag_off + 1);

  load_tile<D>(sq, q + bh * lq * D, q0, lq);
  load_tile<D>(sdo, dout + bh * lq * D, q0, lq);
  load_stats(sl, sd, lse + bh * lq, delta + bh * lq, q0, lq);

  AccFrag dq_acc[D / 16];
  zero<D>(dq_acc);

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();            // every warp is done with the last K / V
    load_tile<D>(sk, k + bhk * lkv * D, kv0, lkv);
    load_tile<D>(sv, v + bhk * lkv * D, kv0, lkv);
    __syncthreads();

    warp_qk<D>(sq, sk, ss, r0);               // S = Q K^T, own Q rows
    warp_qk<D>(sdo, sv, sdp, r0);             // dP = dO V^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const int i = q0 + r;
#pragma unroll
      for (int cc = 0; cc < BKV / 32; ++cc) {
        const int c = lane + 32 * cc;
        const int j = kv0 + c;
        float p, ds;
        p_and_ds(ss[r * L::LDS + c], sdp[r * L::LDS + c], sl[r], sd[r],
                 i < lq && j < lkv && j <= i + diag_off, scale_log2, scale,
                 p, ds);
        sds[r * L::LDP + c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();
    warp_acc<D>(dq_acc, sds, sk, r0);         // dQ += dS K
  }

  __syncthreads();              // the staging tile overlays Q and dO
  warp_store<D>(dq_acc, reinterpret_cast<float*>(smem + S::q),
                dq + bh * lq * D, q0, lq, r0, lane);
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int batch, int hq, int hkv, int lq, int lkv, int diag_off,
               float scale, cudaStream_t stream) {
  const size_t bytes = BwdLayout<D, true>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((lkv + BKV - 1) / BKV, batch * hkv);
  attention_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), hq, hkv, lq, lkv,
      diag_off, scale);
  return int(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int batch,
              int hq, int hkv, int lq, int lkv, int diag_off, float scale,
              cudaStream_t stream) {
  const size_t bytes = BwdLayout<D, false>::bytes;
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(batch * hq, (lq + BQ - 1) / BQ);
  attention_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), hq, hq / hkv, lq, lkv, diag_off, scale);
  return int(cudaGetLastError());
}

bool bad_shape(int batch, int hq, int hkv, int lq, int lkv) {
  return batch <= 0 || hkv <= 0 || hq % hkv != 0 || lq <= 0 || lkv <= 0 ||
         batch * hkv > 65535 || (lq + BQ - 1) / BQ > 65535;
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).  The wrappers
// in ops/attention_bwd.py have already checked shapes, dtypes, contiguity
// and alignment; the checks here only refuse what would index out of
// bounds or exceed a grid dimension.
extern "C" int eft_attention_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int batch, int hq,
                                     int hkv, int lq, int lkv, int d,
                                     int diag_off, float scale, int device,
                                     void* stream) {
  if (bad_shape(batch, hq, hkv, lq, lkv)) return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, hq,
                            hkv, lq, lkv, diag_off, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, hq,
                             hkv, lq, lkv, diag_off, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" int eft_attention_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int batch, int hq, int hkv,
                                    int lq, int lkv, int d, int diag_off,
                                    float scale, int device, void* stream) {
  if (bad_shape(batch, hq, hkv, lq, lkv)) return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, lq,
                           lkv, diag_off, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, hq, hkv,
                            lq, lkv, diag_off, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
