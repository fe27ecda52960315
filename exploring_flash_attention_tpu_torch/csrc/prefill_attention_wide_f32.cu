// H1 at f32 past d 256: eft_prefill_attention's f32 launch at head dims d
// from 257 to 512 (prefill_attention_f32.cu takes f32 d up to 256 on the
// f32 core and prefill_attention.cu calls launch_wide_f32 above it).  It
// computes H1's function (the TPU kernels B1-B5, B8 and B9 that
// prefill_attention.cu names) at f32 with every option H1 has: none,
// causal and window masks at a static diagonal or at traced positions
// (the int32 pair each block reads), the natural-log LSE, KV spans (a
// third grid axis of whole 128-key spans writing [B, Hq, nkb, Lq, d]
// partials), the bound statistic, bf16 or f32 O, any GQA group.
//
// Why H5's f32 block.  At d = 512 the f32 core's block cannot hold O (256
// f32 registers a thread) beside the fresh P V accumulator that keeps O
// f32-accurate over many key tiles, and one block of four 128-column
// chunks cannot either (dtiled_attention.cuh's f32 comment).  H5's f32
// kernel splits d across a cluster of two blocks, each holding two of O's
// chunks in two consumer warpgroups: S is each block's partial over its
// columns, summed over the ranks through distributed shared memory
// (exchange_s), so both ranks hold the same S, m, l and P; Q is streamed
// 64 columns at a time beside K's (its three pieces do not stay resident),
// 32-key tiles, bf16x6 products, each tile's P V in a fresh accumulator
// added to O in f32.  This file runs that block (produce_f32, key_loop_f32
// and share_l_f32 in dtiled_attention.cuh) with what H1 adds:
//   - each owned row's band of keys [lo, hi] (masks at diag_off or at the
//     traced pair, the span's keys, Lkv), masked on S, and the tiles
//     outside every row's band never loaded (the loop bounds in 64 bits);
//   - the K/V head of each q head (GQA) and the span's key range, the
//     producer's loads starting at its first tile;
//   - the bound statistic: each row's fixed shift from |q|^2 (the whole
//     row, read by both ranks the same way) and the prefix maximum of
//     |k|^2, alpha = 1;
//   - the LSE, written by rank 0's warpgroup 0; bf16 or f32 O.
// H1's f32 rounding is H5's f32 rounding with V's scale 1: l sums the f32
// p, P is kept f32 and split into three bf16 pieces.  Both ranks walk the
// same tiles: every bound and skip comes from the cluster's (batch*head,
// Q tile, span), nothing from the rank, or the exchange's barriers (which
// wait on both ranks) would deadlock.  Rows of d % 4 != 0 (no tensor map
// takes them) run the STAGED instances, whose producer copies them with
// cp.async at their alignment.  q_rows selects nothing here: every call
// runs 64-row tiles, which leaves the result unchanged.
//
// Cost at B=4, H=8, L=1024, d=512, no mask: 68.7 GFLOP of f32, six bf16
// products each, 0.417 ms at 989 TFLOP/s bf16; Q is re-read from L2 once
// per 32-key tile (H5's f32 cost).

#include "dtiled_attention.cuh"
#include "prefill_attention.cuh"

namespace {

using eft::prefill::BOUND_ROWS;
using eft::prefill::BOUND_SHIFT;
using eft::prefill::MASK_NONE;
using eft::prefill::MASK_WINDOW;
using eft::prefill::SPAN_TILE;
using eft::prefill::clamp64;

// The key tiles (of `tile` keys) that some row of the Q tile [q0, q0 +
// bq) sees in the span [span0, span0 + kv_span): the last row's causal
// limit ends them, the first row's window edge starts them (rounded down
// to a tile), in 64 bits where positions add.  Returns how many (0: the
// span holds none, and the block writes (0, -inf)) and sets kv_begin, the
// first one's first key
__device__ __forceinline__ int key_tiles(int tile, int bq, int q0, int lq,
                                         int lkv, int span0, int kv_span,
                                         int mask, int diag_off, int window,
                                         int& kv_begin) {
  kv_begin = span0;
  int kv_end = min(lkv, span0 + kv_span);
  if (mask != MASK_NONE) {
    const long long q_last = min(q0 + bq, lq) - 1;
    kv_end = min(kv_end, int(clamp64(q_last + diag_off + 1, 0, lkv)));
  }
  if (mask == MASK_WINDOW) {
    const long long first = (long long)q0 + diag_off - window + 1;
    kv_begin = max(kv_begin, int(clamp64(first, 0, lkv)) / tile * tile);
  }
  return kv_end > kv_begin ? (kv_end - kv_begin + tile - 1) / tile : 0;
}

// The keys [lo, hi] that the Q row at `row` sees: every key without a
// mask, those up to its diagonal (row + diag_off) when causal, the last
// `window` of those with a window; hi < lo where it sees none
__device__ __forceinline__ void row_band(int row, int lkv, int mask,
                                         int diag_off, int window, int& lo,
                                         int& hi) {
  lo = 0;
  hi = lkv - 1;
  if (mask != MASK_NONE) {
    const long long last = (long long)row + diag_off;
    hi = int(clamp64(last, -1, lkv - 1));
    if (mask == MASK_WINDOW) lo = int(clamp64(last - window + 1, 0, lkv));
  }
}

// The bound form's |k|^2 statistic of a block whose Q tile starts at row
// q0 and reads K/V head bhk: the prefix maximum (kmax: [B * Hkv,
// cdiv(lkv, 128)]) at the last 128-key tile that the last row of the
// block's 128-row group sees (the last tile without a mask), so every Q
// tile and span of a row reads the same entry
__device__ __forceinline__ float bound_kmax2(const float* kmax, int bhk,
                                             int q0, int lq, int lkv,
                                             int mask, int diag_off) {
  const int n_kv = (lkv + SPAN_TILE - 1) / SPAN_TILE;
  int idx = n_kv - 1;
  if (mask != MASK_NONE) {
    const long long g_last =
        min(q0 / BOUND_ROWS * BOUND_ROWS + BOUND_ROWS, lq) - 1;
    const long long x = g_last + diag_off;
    idx = x < 0 ? 0 : int(clamp64(x / SPAN_TILE, 0, n_kv - 1));
  }
  return kmax[size_t(bhk) * n_kv + idx];
}

// |q|^2 of an f32 row of d floats at `row` (null: a row past the tensor,
// 0), summed over the four lanes of the calling thread's quad, each lane
// every fourth float4 (d % 4 == 0) or float; the whole warp calls it
__device__ __forceinline__ float row_sq(const float* row, int d) {
  float sum = 0.f;
  if (row != nullptr) {
    if (d % 4 == 0) {
      for (int c = threadIdx.x % 4; 4 * c < d; c += 4) {
        const float4 x = reinterpret_cast<const float4*>(row)[c];
        sum = fmaf(x.x, x.x, sum);
        sum = fmaf(x.y, x.y, sum);
        sum = fmaf(x.z, x.z, sum);
        sum = fmaf(x.w, x.w, sum);
      }
    } else {
      for (int c = threadIdx.x % 4; c < d; c += 4)
        sum = fmaf(row[c], row[c], sum);
    }
  }
  return quad_sum(sum);
}

constexpr int WIDE_NC = 2;      // chunks a block; a cluster of two blocks
constexpr int WIDE_RANKS = 2;
// registers a thread after setmaxnreg: the producer's (TMA, STAGED),
// warpgroup 0's and warpgroup 1's (O 64 and the fresh P V 64); the block
// keeps the launch's 3 x 168
constexpr int PRODUCER_REGS[2] = {64, 64};
constexpr int WG0_REGS = 232;
constexpr int OTHER_REGS = 208;
static_assert(PRODUCER_REGS[1] + WG0_REGS + OTHER_REGS <=
                  3 * FCfg<WIDE_NC, KV_BF16>::LAUNCH_REGS,
              "the block's registers");

template <bool BOUND, bool STAGED>
__global__ void __launch_bounds__(FCfg<WIDE_NC, KV_BF16>::THREADS, 1)
prefill_attention_wide_f32_kernel(
    const __grid_constant__ CUtensorMap tq,  // [B*Hq, Lq, d] f32
    const __grid_constant__ CUtensorMap tk,  // [B*Hkv, Lkv, d] f32
    const __grid_constant__ CUtensorMap tv,  // [B*Hkv, Lkv, d] f32
    void* __restrict__ o,                    // [B, Hq, nkb, Lq, d]
    int out_f32, float* __restrict__ lse,    // [B, Hq, nkb, Lq] or null
    int hq, int group, int lq, int lkv, int mask, int diag_off, int window,
    const int* __restrict__ offs,            // (q_pos0, kv_pos0) or null
    int kv_span, float scale_log2,
    const float* __restrict__ kmax,          // the bound form's, or null
    int d, const float* __restrict__ qg, const float* __restrict__ kg,
    const float* __restrict__ vg) {
  constexpr int NC = WIDE_NC;
  using C = FCfg<NC, KV_BF16>;
  // traced offsets: the diagonal comes from device memory, not the host
  if (offs != nullptr) diag_off = offs[0] - offs[1];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto* bars = reinterpret_cast<FBars<NC>*>(smem + C::bars);

  // the cluster's (batch*head, Q tile, span): the Q tiles of a head next
  // to each other, the last first (under a causal mask it holds the most
  // work); rank r holds d's columns [256 r, 256 r + 256)
  const uint32_t ranks = cluster_size();
  const int c0 = int(cluster_rank()) * C::D;
  const int n_qt = (lq + BQ - 1) / BQ;
  const int tile = blockIdx.x / ranks;
  const int bh = tile / n_qt;
  const int bhk = (bh / hq) * (hq / group) + (bh % hq) / group;   // GQA
  const int q0 = (n_qt - 1 - tile % n_qt) * BQ;
  const int wg = threadIdx.x / 128;

  // the 32-key tiles of this span that some row of the Q tile sees, the
  // same on both ranks
  const int span0 = blockIdx.z * kv_span;
  int kv_begin;
  const int n_tiles = key_tiles(FKV, BQ, q0, lq, lkv, span0, kv_span,
                                mask, diag_off, window, kv_begin);

  init_f32_bars(bars, ranks);
  cluster_sync();             // every rank's barriers ready

  const int lane = threadIdx.x % 32;
  const int rl = threadIdx.x / 32 % 4 * 16 + lane / 4;
  const size_t base = (size_t(bh) * gridDim.z + blockIdx.z) * lq;
  // each warpgroup's path runs to its end apart (its own cluster_sync and
  // return): where they met after the branches, ptxas kept 8 bytes of
  // stack in the bound STAGED instance at every register split tried
  if (wg == NC) {
    set_regs<PRODUCER_REGS[STAGED], C::LAUNCH_REGS>();
    produce_f32<NC, KV_BF16, STAGED>(&tq, &tk, &tv, nullptr, nullptr, smem,
                                     bars, bh, q0, lkv, 1, 0, n_tiles,
                                     scale_log2, c0, qg, kg, vg, lq, d, bhk,
                                     kv_begin);
    cluster_sync();
    return;
  }
  float acc_o[DC / 2], l[2] = {0.f, 0.f};
  if (wg == 0) {
    set_regs<WG0_REGS, C::LAUNCH_REGS>();
    // each owned row sees keys [lo, hi]
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      row_band(q0 + rl + 8 * r, lkv, mask, diag_off, window, lo[r], hi[r]);
    }
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if constexpr (BOUND) {
      // |k|^2's statistic as prefill_attention.cu reads it, and |q|^2 of
      // each owned row over all of d (both ranks read the same)
      const float kmax2 =
          bound_kmax2(kmax, bhk, q0, lq, lkv, mask, diag_off);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + rl + 8 * r;
        const float sq = row_sq(
            row < lq ? qg + (size_t(bh) * lq + row) * d : nullptr, d);
        m[r] = sqrtf(sq * kmax2) * scale_log2 - BOUND_SHIFT;
      }
    }
    key_loop_f32<NC, KV_BF16, true, BOUND>(
        smem, bars, kv_begin, n_tiles,
        [lo, hi](int r, int key) { return key >= lo[r] && key <= hi[r]; },
        acc_o, m, l, ranks);
    share_l_f32<NC, KV_BF16, true>(smem, l);
    float* row_lse = cluster_rank() == 0 ? lse : nullptr;
    if (d % 8 != 0)
      store_o_rows<DC, true>(acc_o, l, m, q0 + rl, lq, base, o, out_f32,
                             row_lse, d, c0, d - c0);
    else
      store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, base, o, out_f32, row_lse,
                       d, c0, d - c0);
    cluster_sync();
    return;
  } else {
    set_regs<OTHER_REGS, C::LAUNCH_REGS>();
    float m[2] = {0.f, 0.f};
    key_loop_f32<NC, KV_BF16, false>(
        smem, bars, kv_begin, n_tiles, [](int, int) { return true; }, acc_o,
        m, l, ranks);
    share_l_f32<NC, KV_BF16, false>(smem, l);
    const int col = c0 + DC;
    if (d % 8 != 0)
      store_o_rows<DC, true>(acc_o, l, m, q0 + rl, lq, base, o, out_f32,
                             nullptr, d, col, d - col);
    else
      store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, base, o, out_f32, nullptr,
                       d, col, d - col);
  }
  cluster_sync();             // no rank still reads this block's buffer
}

template <bool BOUND, bool STAGED>
int launch_h1_wide_f32(const void* q, const void* k, const void* v, void* o,
                       int out_f32, void* lse, int batch, int hq, int hkv,
                       int lq, int lkv, int d, int mask, int diag_off,
                       int window, const int* offs, int kv_span, float scale,
                       const float* kmax, cudaStream_t stream) {
  using C = FCfg<WIDE_NC, KV_BF16>;
  CUtensorMap tq = {}, tk = {}, tv = {};
  if constexpr (!STAGED) {
    int err = make_tmap(&tq, q, 4, d, lq, batch * hq, FH, BQ, 0);
    if (!err) err = make_tmap(&tk, k, 4, d, lkv, batch * hkv, FH, FKV, 0);
    if (!err) err = make_tmap(&tv, v, 4, d, lkv, batch * hkv, FH, FKV, 0);
    if (err) return err;
  }
  auto kernel = prefill_attention_wide_f32_kernel<BOUND, STAGED>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (attr != cudaSuccess) return int(attr);
  // no span: one span of whole 128-key tiles covering the KV
  const int span =
      kv_span ? kv_span : (lkv + SPAN_TILE - 1) / SPAN_TILE * SPAN_TILE;
  const ClusterLaunch l(
      dim3(batch * hq * ((lq + BQ - 1) / BQ) * WIDE_RANKS, 1,
           (lkv + span - 1) / span),
      WIDE_RANKS, C::THREADS, C::bytes, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, kernel, tq, tk, tv, o, out_f32, static_cast<float*>(lse), hq,
      hq / hkv, lq, lkv, mask, diag_off, window, offs, span,
      scale * 1.4426950408889634f, kmax, d, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v));
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

namespace eft {
namespace prefill {

int launch_wide_f32(const void* q, const void* k, const void* v, void* o,
                    int out_f32, void* lse, int batch, int hq, int hkv,
                    int lq, int lkv, int d, int mask, int diag_off,
                    int window, const int* offs, int kv_span, float scale,
                    const float* kmax, cudaStream_t stream) {
  if (int64_t(batch) * hq * ((lq + BQ - 1) / BQ) * WIDE_RANKS > INT32_MAX)
    return int(cudaErrorInvalidValue);
  auto go = [&](auto bound, auto staged) {
    return launch_h1_wide_f32<decltype(bound)::value,
                              decltype(staged)::value>(
        q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv, d, mask, diag_off,
        window, offs, kv_span, scale, kmax, stream);
  };
  using T = std::true_type;
  using F = std::false_type;
  // rows of d % 4 != 0 (4d bytes): no tensor map takes them
  if (d % 4 != 0) return kmax ? go(T{}, T{}) : go(F{}, T{});
  return kmax ? go(T{}, F{}) : go(F{}, F{});
}

}  // namespace prefill
}  // namespace eft
