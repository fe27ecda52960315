// H2: the merge of split-KV partials on Hopper (sm_90a).  f32 in, one
// rounding to bf16 or f32 out.
//
// Replaces the TPU kernel
//   B10 _combine_kernel   exploring_flash_attention_tpu/ops/attention_v2_splitkv.py:330
// Each of nkb partials holds an O normalized over its KV span and the
// span's natural-log LSE; a row's attention over the whole KV is
//   O = sum_k w_k O_k,  w_k = exp(lse_k - max lse) / sum_j exp(lse_j - max lse)
// as B10 computes it (lse_merge.cuh, shared with H6-decode's own merge).
// A row whose partials are all (0, -inf) gives O = 0.
//
// Cost: the bytes.  A row reads nkb * (D + 1) * 4 bytes and writes D * 2
// or 4; the work is one FMA per partial element.  At the v1 split case
// (2 partials of 8192 rows, d=128) that is 10 MB, 0.0031 ms at 3.35 TB/s,
// so the kernel is a matter of latency: how soon each row's bytes are in
// flight.  Design:
//   - a row of D columns is D / 4 lanes (32 at d=128, 16 at d=64, 8 at
//     d=32: 1, 2 or 4 rows a warp), each lane owning 4 consecutive
//     columns, read with one 16-byte load per partial through the
//     read-only path without allocating in L1 (each byte is read once);
//     at a d that is no power of two the row takes the next power of two
//     of lanes, those past d idle (d=80: 32 lanes, 20 busy), and past d
//     = 128 each lane two 16-byte chunks, past 256 three or four, a row
//     still one warp's (eft::MergeRow).  One instance per d (every
//     multiple of 16 up to 512), so nothing is padded in memory and d 32 /
//     64 / 128 compile as before;
//   - the row's LSEs are read once, one per lane, beside its first four
//     16-byte loads, and reduced by shuffles within the row's lanes; each
//     weight reaches the lanes by __shfl_sync (lse_merge.cuh);
//   - O is written as one 8-byte store of 4 bf16, or one float4, per lane;
//   - a d that is not a multiple of 16 runs on the instance of its row's
//     lanes (D 16, 32, 64, 128, 256 or 512: the lanes and chunks of a row
//     depend only on which of these d reaches) with d read at run time,
//     the loads and stores past d masked: 16-byte loads where the rows
//     are (d % 4 == 0), else a float at a time (ANY).  The multiples of
//     16 keep their instances of constant d;
//   - a block is 4 warps (40 registers a thread, 12 blocks an SM): at the
//     v1 split case 2048 blocks of 4 rows fill the 132 SMs, 1584 at once.
//     Held to 32 registers (16 blocks an SM, one wave) it spilled and read
//     slower on an H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lse_merge.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MERGE_UNROLL = 4;         // 16-byte loads in flight a lane

// RUNTIME: d (at most D) is d_arg, not D; ANY: d % 4 != 0
template <int D, bool RUNTIME, bool ANY>
__global__ void __launch_bounds__(THREADS)
splitkv_combine_kernel(const float* __restrict__ o_part,  // [BH, nkb, Lq, d]
                       const float* __restrict__ lse,     // [BH, nkb, Lq]
                       void* __restrict__ o,              // [BH, Lq, d]
                       int out_f32, int n_rows, int nkb, int lq, int d_arg) {
  const int d = RUNTIME ? d_arg : D;
  constexpr int L = eft::MergeRow<D>::L;    // lanes per row
  constexpr int NV = eft::MergeRow<D>::NV;  // 16-byte chunks per lane
  constexpr int RPW = 32 / L;          // rows per warp
  constexpr int ROWS = WARPS * RPW;    // rows per block
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int warp_row = blockIdx.x * ROWS + warp * RPW;
  if (warp_row >= n_rows) return;      // the whole warp: its shuffles agree
  const int row = warp_row + lane / L;
  const int r = min(row, n_rows - 1);  // a row past the end merges the last
  const int bh = r / lq, qi = r % lq;
  // partial k of this row sits at (bh * nkb + k) * lq + qi
  float4 acc[NV];
  eft::lse_merge_row<L, NV, MERGE_UNROLL, false, ANY>(
      acc, o_part, lse, size_t(bh) * nkb * lq + qi, size_t(lq), nkb, d);
  if (row >= n_rows) return;
#pragma unroll
  for (int c = 0; c < NV; ++c) {
    if (!eft::merge_chunk<L>(c, d)) continue;
    const int col = 4 * (lane % L + L * c);
    const size_t out = size_t(row) * d + col;
    if constexpr (ANY) {
      if (out_f32)
        eft::store4_any(static_cast<float*>(o) + out, acc[c], d - col);
      else
        eft::store4_any(static_cast<__nv_bfloat16*>(o) + out, acc[c],
                        d - col);
    } else if (out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(o) + out) = acc[c];
    } else {
      eft::store_bf16x4(static_cast<__nv_bfloat16*>(o) + out, acc[c]);
    }
  }
}

template <int D, bool RUNTIME, bool ANY>
int launch(const void* o_part, const void* lse, void* o, int out_f32,
           int n_rows, int nkb, int lq, int d, cudaStream_t stream) {
  constexpr int ROWS = WARPS * (32 / eft::MergeRow<D>::L);
  const dim3 grid((n_rows + ROWS - 1) / ROWS);
  splitkv_combine_kernel<D, RUNTIME, ANY><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(lse), o,
      out_f32, n_rows, nkb, lq, d);
  return int(cudaGetLastError());
}

// the instance of head dim d: the multiples of 16 from D up to 512 have
// their own; any other d runs on the instance of its lanes (16, 32, 64,
// 128, 256 or 512) with d read at run time
template <int D>
int launch_d(int d, const void* o_part, const void* lse, void* o,
             int out_f32, int n_rows, int nkb, int lq, cudaStream_t stream) {
  if (d == D)
    return launch<D, false, false>(o_part, lse, o, out_f32, n_rows, nkb, lq,
                                   d, stream);
  if constexpr ((D & (D - 1)) == 0) {
    if (d < D && d % 16 != 0) {
      if (d % 4 == 0)
        return launch<D, true, false>(o_part, lse, o, out_f32, n_rows, nkb,
                                      lq, d, stream);
      return launch<D, true, true>(o_part, lse, o, out_f32, n_rows, nkb, lq,
                                   d, stream);
    }
  }
  if constexpr (D < 512)
    return launch_d<D + 16>(d, o_part, lse, o, out_f32, n_rows, nkb, lq,
                            stream);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_v2_splitkv.py has already checked shapes, dtypes,
// contiguity and 16-byte alignment.  n_bh = batch * heads; d from 1 to
// 512.
extern "C" int eft_splitkv_combine(const void* o_part, const void* lse,
                                   void* o, int n_bh, int nkb, int lq, int d,
                                   int out_f32, int device, void* stream) {
  if (n_bh <= 0 || nkb <= 0 || lq <= 0 ||
      int64_t(n_bh) * lq > int64_t(INT32_MAX) ||
      (reinterpret_cast<uintptr_t>(o_part) | reinterpret_cast<uintptr_t>(o)) %
          16 != 0)
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return launch_d<16>(d, o_part, lse, o, out_f32, n_bh * lq, nkb, lq, s);
}
