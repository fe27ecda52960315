// H1: the attention forward on Hopper (sm_90a). bf16 in, f32 accumulate,
// one kernel for three masks (none, causal, sliding window) and every head
// dim d from 1 to 256 (257 to 512: prefill_attention_wide.cu and at f32
// prefill_attention_wide_f32.cu, on H5's blocks), on instances D = 32,
// 64, 128 and 256: a d below its instance's D (1-31 on 32, 33-63 on 64,
// 65-127 on 128, 129-255 on 256) is described to TMA with its true d, so
// the tiles' columns past d land as
// zeros (wgmma_tile.cuh), and the epilogue stores the first d columns of
// O; a d that is not a multiple of 8, whose rows no tensor map takes, is
// loaded by the staged producer below into the same tiles.  The padded
// columns cost (D - d) / D of the tensor-core work: 37.5% at d=80, none at
// d = D.  f32 q/k/v take a second kernel, prefill_attention_f32_kernel
// (prefill_attention_f32.cu, compiled beside this file), on the f32 core
// of f32_attention.cuh (bf16x6 on wgmma, f32-accurate as the JAX
// package's HIGHEST), with the same masks, spans, offsets and bound form;
// f32 d 257 to 512 run on H5's f32 block in clusters of two
// (prefill_attention_wide_f32.cu).
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
// With a KV span (a multiple of 128 keys) the grid gains a third axis, one
// block per (batch*q-head, Q tile, span), and each block writes the
// partial (O normalized over its span, the span's LSE) of B8's multi-span
// form and B9 into o [B, Hq, nkb, Lq, D] and lse [B, Hq, nkb, Lq];
// H2 (splitkv_combine.cu) merges them.  B9's traced offsets come as a
// device pointer to the int32 pair (q_pos0, kv_pos0): each block reads it
// before it derives anything from diag_off, so the host never reads the
// offsets and a launch captured in a CUDA graph takes new ones on replay.
// Causal and window masks use the decode convention: row i sits at
// position i + diag_off of the key axis (diag_off = q_pos0 - kv_pos0,
// Lkv - Lq by default) and sees key j iff j <= i + diag_off; a window
// further needs j >= i + diag_off - window + 1 (inclusive of the row's
// own position, as oracle/reference.py:51).  A row that sees no key gives
// (O = 0, LSE = -inf).
//
// Two launch forms, both template parameters, neither the default:
//  - a 64-row Q tile (q_rows = 64, TileConfig.block_q <= 64): one consumer
//    warpgroup and the producer, 256 threads, setmaxnreg 24 / 232 (128 x
//    24 + 128 x 232 = 256 x 128, what the launch allocates under
//    __launch_bounds__(256, 2)).  Twice the blocks of the 128-row tile for
//    a short Lq; each row meets the same K/V tiles in the same order, and a
//    tile wholly masked for a row adds p = 0 at alpha = 1, so O and the LSE
//    are bitwise those of the 128-row tile.
//  - the bound statistic (softmax="bound", B1-B3's opt-in form,
//    exploring_flash_attention_tpu/ops/attention_v1.py:1110-1137,1735-1753):
//    each row's shift is fixed before the K/V loop at
//    m_i = sqrt(|q_i|^2 kmax2) * scale * log2(e) - BOUND_SHIFT, with
//    |q_i|^2 the f32 sum of squares of the bf16 row read from the Q tile in
//    shared memory and kmax2 an entry of the caller's prefix maxima
//    (cummax over 128-key tiles) of each tile's largest |k_j|^2 per KV
//    head: the entry of the last K/V tile that the last row of the row's
//    128-row group sees (the last tile without a mask).  So one form serves
//    static and traced offsets, spans and both Q tiles, a causal output is
//    bitwise unchanged when K/V grow by whole 128-key tiles, and zero-filled
//    tail keys (norm 0) cannot raise the bound.  There is no running max and
//    no rescale of O: p = bf16(exp2(s - m_i)) lies in (0, 2^64], which bf16,
//    the f32 l and the f32 O hold.
//
// Cost at the canonical shape (B=32, H=8, L=1024, d=128, non-causal):
// 4*32*8*1024*1024*128 = 137.4 GFLOP, 0.139 ms at the H100's 989 TFLOP/s
// dense bf16, while Q, K, V and O (268 MB in bf16) take 0.080 ms at
// 3.35 TB/s: the bound is the tensor cores, which only wgmma reaches.
//
// Design (FlashAttention-3's layout for d <= 128, wgmma_tile.cuh).  One
// block per (batch*q-head, 128-row Q tile, KV span), the Q tiles of a head
// next to each other in the grid so that the blocks in flight read each
// head's K and V from HBM about once and share them in L2: 384 threads, two
// consumer warpgroups of 64 Q rows each and one producer warpgroup, which
// hands its registers to the consumers (setmaxnreg: 24 and 240 per
// thread).  The producer's first lane loads the Q tile once and then
// streams 128-key K and V tiles of the GQA KV head (h / group) through a
// three-stage TMA ring (full and empty mbarriers).  Each consumer
// warpgroup, per K/V tile (consume() overlaps steps 1 and 4 of
// neighbouring tiles with step 3):
//   1. S = Q K^T on bf16 wgmma (m64n128k16, d/16 steps), both operands in
//      swizzled shared memory; S stays in 64 f32 registers per thread;
//   2. masks S in registers from each element's (row, column): columns at
//      or past Lkv (TMA zero-fills them, and a zero key scores 0, not
//      -inf), and the causal / window band, whose per-row edges are
//      computed once in 64 bits; a tile wholly inside every row's band
//      takes a loop without the compares, which otherwise cost about as
//      much as the rest of the softmax;
//   3. the online softmax in the exp2 basis, P rounded to bf16 before P V
//      as B4 rounds it: s * scale_log2, p = bf16(exp2(s - m_use)) (exp2 on
//      MUFU.EX2, flushing below 2^-126), l summed from the rounded
//      P (per thread, the quad's sums added at the end), alpha = exp2(m_old
//      - m_use), m_use = 0 while a row has seen nothing (p = 0, l = 0);
//   4. O = alpha O + P V: P, packed to bf16 pairs, is the A fragment in
//      registers; V is the B operand straight from its TMA tile, MN-major
//      (wgmma's transposed B).  O lives in f32 registers from the first
//      tile to the last and never goes through shared memory;
//   5. releases the stage once P V has read it.
// Tiles are skipped per Q tile: causal stops at the tile holding the last
// row's last visible key, a window starts at the tile holding the first
// row's first visible key (B5's sliding slice).  The epilogue writes O / l
// from registers (bf16 or f32) and the LSE, m ln 2 + ln l.
//
// Budget.  Shared memory at d=128: Q 32 KB, three stages of K and V 192
// KB, 224 KB + barriers of the 227 KB a block may have (112 KB at d=64, 56
// KB at d=32).  Registers: S 64 + O d/2 + P 32 per consumer thread, within
// the 240 that setmaxnreg gives (a block of 288 threads, the producer a
// single warp, is capped at 168: the launch allocates registers as for
// 384).  So one block per SM: ops/attention_v1.py's RESIDENT_BLOCKS =
// 132.  The two warpgroups take no turns: ping-pong scheduling between
// them gained nothing at the canonical shape.
//
// D=256 (FlashAttention-3 runs d=256 on narrower K/V tiles too): O is 128
// f32 registers a consumer thread, so S and P shrink to a 64-key tile (S
// 32 + P 16 + O 128 within the 240), and Q (64 KB at 128 rows) leaves room
// for two 64 KB stages of K and V: 192 KB.  Each row tile is four
// 64-column boxes (the 128-byte swizzle's width) and P V two m64n128k16
// products, one per half of V.  A KV span stays whole 128-key tiles, two
// 64-key steps each, and the bound statistic stays per 128-key tile.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "prefill_attention.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace eft::hopper;
using namespace eft::prefill;

// NC consumer warpgroups of 64 Q rows (1 or 2) and the producer warpgroup.
// Registers per thread after setmaxnreg: 128 * 40 + 256 * 232 = 384 * 168
// and 128 * 40 + 128 * 216 = 256 * 128, what the launch allocates (more,
// and the consumers' setmaxnreg.inc waits forever).  The producer's staged
// loads (below) spilled at 24 and 32 registers, and fit 40; the consumers
// hold their state in 216 without a spill
template <int NC>
struct Block {
  static constexpr int BQ = 64 * NC;                 // Q rows per block
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr int MIN_BLOCKS = NC == 1 ? 2 : 1;  // caps at 128 / 168
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int CONSUMER_REGS = NC == 1 ? 216 : 232;
};

// Shared memory of one block.  Every tile is TMA boxes of BOX columns
// (rows of BOX * 2 bytes, the swizzle width) by its rows, box after box.
// K/V tiles of BKV keys (128; 64 at D=256) in a ring of STAGES (3; 2).
template <int D, int NC>
struct Tiles {
  static constexpr int BQ = Block<NC>::BQ;
  static constexpr int BKV = D == 256 ? 64 : 128;
  static constexpr int STAGES = D == 256 ? 2 : 3;
  static constexpr int BOX = D >= 64 ? 64 : 32;
  static constexpr int ROW = BOX * 2;                 // bytes; = swizzle
  static constexpr int NBOX = D / BOX;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t KV_BYTES = BKV * D * 2;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + Q_BYTES;
  static constexpr size_t v = k + size_t(STAGES) * KV_BYTES;
  static constexpr size_t bars = v + size_t(STAGES) * KV_BYTES;
  static constexpr size_t bytes = bars + 8 * (2 * STAGES + 1) + 1024;
  static_assert(SPAN_TILE % BKV == 0, "a span is whole K/V tiles");
  static_assert(bytes <= 232448, "the block's shared memory");
};

// ---------------------------------------------- rows TMA cannot describe
// At a bf16 d that is not a multiple of 8 a row of q, k or v is 2d bytes,
// not a multiple of 16, and no tensor map takes that stride.  Then the
// whole producer warpgroup loads each tile into the layout its TMA boxes
// would give (the staged form, a run-time choice: the consumers read the
// same tiles on the same barriers either way), a row a thread, with
// wgmma_tile.cuh's staged rows (zero_tail, stage_row, hand_over; the
// producer runs on 40 registers a thread).

// The staged producer (thread t of 128): Q, then the K and V tiles of the
// ring, as the TMA producer brings them; every address in shared memory a
// shared-window one (32 bits) and each row's source computed afresh, the
// producer's registers being few.  A thread copies one row of every tile:
// row t of K and of V (128-key tiles), or row t of K (t < 64) or t - 64 of
// V (64-key tiles).  With three stages a thread hands tile i - 1 over once
// tile i is in flight; with two (D=256) each tile as it lands, since
// waiting for a free stage with a tile unhanded would wait on itself.
template <int D, int NC>
__device__ __forceinline__ void produce_staged(
    uint32_t smem, const __nv_bfloat16* q, const __nv_bfloat16* k,
    const __nv_bfloat16* v, int bh, int bhk, int q0, int lq, int lkv, int d,
    int kv_begin, int n_tiles) {
  using T = Tiles<D, NC>;
  constexpr int BKV = T::BKV, STAGES = T::STAGES, BOX = T::BOX;
  constexpr bool SPLIT = BKV < 128;       // K and V rows on apart threads
  constexpr bool LAG = STAGES > 2;
  const uint32_t full = smem + T::bars, empty = full + 8 * STAGES;
  const int t = threadIdx.x % 128;
  if (t < T::BQ) zero_tail<D, BOX>(smem + T::q, T::BQ, t, d);
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if constexpr (SPLIT) {
      zero_tail<D, BOX>(smem + (t < BKV ? T::k : T::v) + s * T::KV_BYTES,
                        BKV, t % BKV, d);
    } else {
      zero_tail<D, BOX>(smem + T::k + s * T::KV_BYTES, BKV, t, d);
      zero_tail<D, BOX>(smem + T::v + s * T::KV_BYTES, BKV, t, d);
    }
  }
  named_bar_sync(1, 128);             // the zeros before any copy lands
  if (t < T::BQ)
    stage_row<BOX>(smem + T::q, T::BQ, t, q + (size_t(bh) * lq + q0 + t) * d,
                   q0 + t < lq, d);
  cp_async_commit();
  if constexpr (!LAG) hand_over(empty + 8 * STAGES, true);     // q_full
#pragma unroll 1
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(empty + 8 * s, ((i / STAGES) & 1) ^ 1);
    const int r = t % BKV, kv = kv_begin + i * BKV + r;
    const size_t at = (size_t(bhk) * lkv + kv) * d;
    if constexpr (SPLIT) {
      stage_row<BOX>(smem + (t < BKV ? T::k : T::v) + s * T::KV_BYTES, BKV,
                     r, (t < BKV ? k : v) + at, kv < lkv, d);
    } else {
      stage_row<BOX>(smem + T::k + s * T::KV_BYTES, BKV, r, k + at,
                     kv < lkv, d);
      stage_row<BOX>(smem + T::v + s * T::KV_BYTES, BKV, r, v + at,
                     kv < lkv, d);
    }
    cp_async_commit();
    if constexpr (LAG)
      hand_over(i == 0 ? empty + 8 * STAGES : full + 8 * ((i - 1) % STAGES),
                false);
    else
      hand_over(full + 8 * s, true);
  }
  if constexpr (LAG) hand_over(full + 8 * ((n_tiles - 1) % STAGES), true);
}

// O += P V of 16 keys; v_k is their rows of the V tile (MN-major boxes of
// BKV rows)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         const unsigned char* v_k) {
  using T = Tiles<D, 1>;                 // V's layout: the same for any NC
  const uint64_t db = gmma_desc(v_k, T::BKV * T::ROW, 8 * T::ROW, T::ROW);
  if constexpr (D == 256)
    wgmma_rs_bf16_n256(o, a, db,
                       gmma_desc(v_k + 2 * T::BKV * T::ROW, T::BKV * T::ROW,
                                 8 * T::ROW, T::ROW));
  else if constexpr (D == 128)
    wgmma_rs_bf16_n128(o, a[0], a[1], a[2], a[3], db, 1);
  else if constexpr (D == 64)
    wgmma_rs_bf16_n64(o, a[0], a[1], a[2], a[3], db, 1);
  else
    wgmma_rs_bf16_n32(o, a[0], a[1], a[2], a[3], db, 1);
}

// S = Q K^T of one K tile (issued, not waited for)
template <int D, int NC>
__device__ __forceinline__ void issue_qk(
    float (&acc_s)[Tiles<D, NC>::BKV / 2], const unsigned char* q_wg,
    const unsigned char* k_s) {
  using T = Tiles<D, NC>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / T::BOX, off = (kk * 16 % T::BOX) * 2;
    const uint64_t da = gmma_desc(q_wg + box * T::BQ * T::ROW + off, 16,
                                  8 * T::ROW, T::ROW);
    const uint64_t db = gmma_desc(k_s + box * T::BKV * T::ROW + off, 16,
                                  8 * T::ROW, T::ROW);
    if constexpr (T::BKV == 128) {
      if (kk == 0) wgmma_ss_bf16_n128_first(acc_s, da, db);
      else wgmma_ss_bf16_n128(acc_s, da, db, 1);
    } else {
      if (kk == 0) wgmma_ss_bf16_n64_first(acc_s, da, db);
      else wgmma_ss_bf16_n64(acc_s, da, db, 1);
    }
  }
}

// O += P V of one V tile, 16 keys a step (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_pv(
    float (&acc_o)[D / 2], const uint32_t (&pa)[Tiles<D, 1>::BKV / 4],
    const unsigned char* v_s) {
  using T = Tiles<D, 1>;
#pragma unroll
  for (int kk = 0; kk < T::BKV / 16; ++kk)
    wgmma_pv<D>(acc_o, &pa[4 * kk], v_s + kk * 16 * T::ROW);
}

// The online softmax of one S tile, in registers: the mask (unless the
// tile is whole) and the scale, the new row max (quad shuffles), p =
// exp2(s - m_use) in f32; alpha = exp2(m_old - m_use) for O and l.  The
// bound form takes the row's fixed shift m: p = exp2(s - m), alpha = 1.
template <bool BOUND, int N>
__device__ __forceinline__ void softmax_exp(
    float (&acc_s)[N],
    float (&m)[2], float (&alpha)[2], bool whole, int col_base,
    const int (&lo)[2], const int (&hi)[2], float scale_log2) {
  if constexpr (BOUND) {
    // p = exp2(s * scale_log2 - m) as one FMA; masked keys give 2^-inf
    const float neg_m[2] = {-m[0], -m[1]};
    if (whole) {
#pragma unroll
      for (int e = 0; e < N; ++e)
        acc_s[e] = exp2_approx(
            fmaf(acc_s[e], scale_log2, neg_m[acc_row8(e) / 8]));
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const int r = acc_row8(e) / 8;
        const int col = col_base + acc_col(e);
        acc_s[e] = col >= lo[r] && col <= hi[r]
                       ? exp2_approx(fmaf(acc_s[e], scale_log2, neg_m[r]))
                       : 0.f;
      }
    }
    alpha[0] = alpha[1] = 1.f;
    return;
  }
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  if (whole) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      acc_s[e] = acc_s[e] * scale_log2;
      mx[acc_row8(e) / 8] = fmaxf(mx[acc_row8(e) / 8], acc_s[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int r = acc_row8(e) / 8;
      const int col = col_base + acc_col(e);
      acc_s[e] = col >= lo[r] && col <= hi[r] ? acc_s[e] * scale_log2
                                              : -CUDART_INF_F;
      mx[r] = fmaxf(mx[r], acc_s[e]);
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
    alpha[r] = exp2f(m[r] - m_use[r]);
    m[r] = m_new;
  }
#pragma unroll
  for (int e = 0; e < N; ++e)
    acc_s[e] = exp2_approx(acc_s[e] - m_use[acc_row8(e) / 8]);
}

// P packed as the bf16 A fragment of P V; l = l * alpha + the rounded P
template <int N>
__device__ __forceinline__ void pack_p(const float (&p)[N],
                                       uint32_t (&pa)[N / 2], float (&l)[2],
                                       const float (&alpha)[2]) {
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 2; ++j)
    pa[j] = pack_bf16x2(p[2 * j], p[2 * j + 1], psum[j & 1]);
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
}

// One consumer warpgroup's whole share of a block: rows q0 + 64 wg ..
// + 63 (this thread owns two), the K/V tiles [kv_begin, kv_begin + 128 n),
// then the epilogue.  FlashAttention-3's intra-warpgroup overlap: per tile
// i, S of tile i is issued; O is rescaled by tile i - 1's alpha while it
// runs; P V of tile i - 1 is issued behind it; the softmax of tile i (its
// exp2 in place on S) runs while P V is in flight; after P V has landed,
// P of tile i is packed into the A fragment P V of tile i - 1 read.  No
// register an in-flight wgmma reads or writes is written meanwhile (ptxas
// would serialize every wgmma, C7513), and the arithmetic and its order
// are those of the plain loop: O_i = alpha_i O_{i-1} + P_i V_i.
template <int D, int NC, bool BOUND>
__device__ __forceinline__ void consume(
    const unsigned char* sq, const unsigned char* sk, const unsigned char* sv,
    uint64_t* full, uint64_t* empty, uint64_t* q_full, void* o, int out_f32,
    float* lse, int lq, int lkv, int mask, int diag_off, int window,
    float scale_log2, int q0, int bh, int span, int kv_begin, int n_tiles,
    float kmax2, int d) {
  using T = Tiles<D, NC>;
  constexpr int BKV = T::BKV, STAGES = T::STAGES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  // each owned row sees keys [lo, hi]
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lo[r] = 0;
    hi[r] = lkv - 1;
    if (mask != MASK_NONE) {
      const long long last = (long long)row0 + 8 * r + diag_off;
      hi[r] = int(clamp64(last, -1, lkv - 1));
      if (mask == MASK_WINDOW)
        lo[r] = int(clamp64(last - window + 1, 0, lkv));
    }
  }
  // a tile is whole (no key of it is masked for any row of this
  // warpgroup) when it ends inside the KV and, under a mask, inside the
  // first row's band and past the last row's window edge
  const long long wg_first = (long long)q0 + wg * 64 + diag_off;
  const long long wg_last = wg_first + 63;
  auto is_whole = [&](int kv0) {
    bool whole = kv0 + BKV <= lkv;
    if (mask != MASK_NONE) whole = whole && kv0 + BKV - 1 <= wg_first;
    if (mask == MASK_WINDOW) whole = whole && kv0 >= wg_last - window + 1;
    return whole;
  };

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  const unsigned char* q_wg = sq + wg * 64 * T::ROW;

  if (n_tiles > 0) {
    mbar_wait(q_full, 0);
    if constexpr (BOUND) {
      // |q_i|^2 of the two owned rows from the Q tile: a row's bytes stay
      // in its own ROW bytes under the swizzle, so each lane of the quad
      // sums every fourth 16-byte chunk of each box and the quad adds
      const int lrow = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float sq_sum = 0.f;
#pragma unroll
        for (int x = 0; x < T::NBOX; ++x)
#pragma unroll
          for (int c = lane % 4; c < T::ROW / 16; c += 4) {
            const uint4 w = *reinterpret_cast<const uint4*>(
                sq + x * T::BQ * T::ROW + (lrow + 8 * r) * T::ROW + c * 16);
            const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float lo_f = __uint_as_float(ws[j] << 16);
              const float hi_f = __uint_as_float(ws[j] & 0xffff0000u);
              sq_sum += lo_f * lo_f + hi_f * hi_f;
            }
          }
        m[r] = sqrtf(quad_sum(sq_sum) * kmax2) * scale_log2 - BOUND_SHIFT;
      }
    }
    float alpha[2];
    uint32_t pa[BKV / 4];
    {
      // tile 0 (O is still zero: no rescale)
      float acc_s[BKV / 2];
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_qk<D, NC>(acc_s, q_wg, sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);
      softmax_exp<BOUND>(acc_s, m, alpha, is_whole(kv_begin), kv_begin + col0,
                         lo, hi, scale_log2);
      pack_p(acc_s, pa, l, alpha);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES, prev = (i - 1) % STAGES;
      const int kv0 = kv_begin + i * BKV;
      float acc_s[BKV / 2];
      mbar_wait(&full[s], (i / STAGES) & 1);
      wgmma_fence();
      issue_qk<D, NC>(acc_s, q_wg, sk + s * T::KV_BYTES);
      wgmma_commit();
      fence_regs(acc_s);
      // O of the tiles before i - 1, rescaled by tile i - 1's alpha (the
      // exact form), while S of tile i runs; then P V of tile i - 1
      if constexpr (!BOUND) {
#pragma unroll
        for (int e = 0; e < D / 2; ++e) acc_o[e] *= alpha[acc_row8(e) / 8];
      }
      fence_regs(acc_o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<D>(acc_o, pa, sv + prev * T::KV_BYTES);
      wgmma_commit();
      fence_regs(acc_o);
      fence_regs(pa);
      wgmma_wait<1>();                 // S of tile i
      softmax_exp<BOUND>(acc_s, m, alpha, is_whole(kv0), kv0 + col0, lo, hi,
                         scale_log2);
      wgmma_wait<0>();                 // P V of tile i - 1
      fence_regs(acc_o);
      fence_regs(pa);
      mbar_arrive(&empty[prev]);
      pack_p(acc_s, pa, l, alpha);
    }
    const int last = (n_tiles - 1) % STAGES;
    if constexpr (!BOUND) {
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc_o[e] *= alpha[acc_row8(e) / 8];
    }
    fence_regs(acc_o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv<D>(acc_o, pa, sv + last * T::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(pa);
    mbar_arrive(&empty[last]);
  }

  // normalize and store once from f32, with the LSE when asked: the first
  // d columns, at rows of d.  At d = D the store is inlined apart, with
  // constant strides: the runtime ones cost 5% at the canonical shape
  const size_t base = (size_t(bh) * gridDim.z + span) * lq;
  if (d == D)
    store_o_rows<D>(acc_o, l, m, row0, lq, base, o, out_f32, lse);
  else if (d % 8 == 0)
    store_o_rows<D>(acc_o, l, m, row0, lq, base, o, out_f32, lse, d, 0, d);
  else
    store_o_rows<D, true>(acc_o, l, m, row0, lq, base, o, out_f32, lse, d,
                          0, d);
}

template <int D, int NC, bool BOUND>
__global__ void __launch_bounds__(Block<NC>::THREADS, Block<NC>::MIN_BLOCKS)
prefill_attention_kernel(const __grid_constant__ CUtensorMap tq,  // [B*Hq, Lq, D]
                         const __grid_constant__ CUtensorMap tk,  // [B*Hkv, Lkv, D]
                         const __grid_constant__ CUtensorMap tv,  // [B*Hkv, Lkv, D]
                         void* __restrict__ o,                  // [B, Hq, Lq, D]
                         int out_f32,                           // o f32, else bf16
                         float* __restrict__ lse,               // [B, Hq, Lq] or null
                         int hq, int group, int lq, int lkv, int mask,
                         int diag_off, int window,
                         const int* __restrict__ offs,  // (q_pos0, kv_pos0) or null
                         int kv_span, float scale_log2,
                         // [B*Hkv, cdiv(Lkv, 128)] prefix maxima of |k|^2
                         // (the bound form) or null
                         const float* __restrict__ kmax,
                         int d,                        // the true head dim
                         // the staged form (d % 8 != 0): q, k, v themselves
                         const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v) {
  using T = Tiles<D, NC>;
  constexpr int BQ = T::BQ, BKV = T::BKV, STAGES = T::STAGES;
  constexpr int CONSUMERS = NC;
  // traced offsets: the diagonal comes from device memory, not the host
  if (offs != nullptr) diag_off = offs[0] - offs[1];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sq = smem + T::q;
  unsigned char* sk = smem + T::k;
  unsigned char* sv = smem + T::v;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  // blockIdx.x runs over the Q tiles of one head first: the blocks in
  // flight share their heads' K and V through L2
  const int n_qt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int bhk = (bh / hq) * (hq / group) + (bh % hq) / group;   // GQA
  // the last Q tile first: under a causal mask it holds the most work
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

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
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV
                                        : 0;

  // full barriers: one TMA arrival, or the 128 producer threads' staged
  const bool staged = q != nullptr;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], staged ? 128 : 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_init(q_full, staged ? 128 : 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer warpgroup gives its registers to the consumers; its
    // first lane loads Q once, then K and V tile by tile through the ring
    // (the staged form: every producer thread)
    setmaxnreg_dec<Block<NC>::PRODUCER_REGS>();
    if (staged) {
      if (n_tiles > 0)
        produce_staged<D, NC>(smem_u32(smem), q, k, v, bh, bhk, q0, lq, lkv,
                              d, kv_begin, n_tiles);
    } else if (warp == CONSUMERS * 4 && lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, T::Q_BYTES);
      for (int x = 0; x < T::NBOX; ++x)
        tma_load_3d(sq + x * BQ * T::ROW, &tq, q_full, x * T::BOX, q0, bh);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::KV_BYTES);
        const int kv0 = kv_begin + i * BKV;
        for (int x = 0; x < T::NBOX; ++x) {
          tma_load_3d(sk + s * T::KV_BYTES + x * BKV * T::ROW, &tk, &full[s],
                      x * T::BOX, kv0, bhk);
          tma_load_3d(sv + s * T::KV_BYTES + x * BKV * T::ROW, &tv, &full[s],
                      x * T::BOX, kv0, bhk);
        }
      }
    }
  } else {
    setmaxnreg_inc<Block<NC>::CONSUMER_REGS>();
    // the bound form's |k|^2 statistic: the prefix maximum at the last K/V
    // tile that the last row of this block's 128-row group sees (every
    // tile without a mask), from diag_off as this block has it
    float kmax2 = 0.f;
    if constexpr (BOUND) {
      const int n_kv = (lkv + SPAN_TILE - 1) / SPAN_TILE;
      int idx = n_kv - 1;
      if (mask != MASK_NONE) {
        const long long g_last =
            min(q0 / BOUND_ROWS * BOUND_ROWS + BOUND_ROWS, lq) - 1;
        const long long x = g_last + diag_off;
        idx = x < 0 ? 0 : int(clamp64(x / SPAN_TILE, 0, n_kv - 1));
      }
      kmax2 = kmax[size_t(bhk) * n_kv + idx];
    }
    consume<D, NC, BOUND>(sq, sk, sv, full, empty, q_full, o, out_f32, lse,
                          lq, lkv, mask, diag_off, window, scale_log2, q0, bh,
                          span, kv_begin, n_tiles, kmax2, d);
  }
}

template <int D, int NC, bool BOUND>
int launch(const void* q, const void* k, const void* v, void* o,
           int out_f32, void* lse, int batch, int hq, int hkv, int lq,
           int lkv, int d, int mask, int diag_off, int window,
           const int* offs, int kv_span, float scale, const float* kmax,
           cudaStream_t stream) {
  using T = Tiles<D, NC>;
  constexpr int BQ = T::BQ, BKV = T::BKV;
  // the true d: TMA zero-fills the boxes' columns past it.  Rows of a d
  // that is not a multiple of 8 (2d bytes) take the staged form instead
  const bool staged = d % 8 != 0;
  CUtensorMap tq = {}, tk = {}, tv = {};
  if (!staged) {
    int err = make_tmap(&tq, q, 2, d, lq, batch * hq, T::BOX, BQ, T::ROW);
    if (!err)
      err = make_tmap(&tk, k, 2, d, lkv, batch * hkv, T::BOX, BKV, T::ROW);
    if (!err)
      err = make_tmap(&tv, v, 2, d, lkv, batch * hkv, T::BOX, BKV, T::ROW);
    if (err) return err;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      prefill_attention_kernel<D, NC, BOUND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  // no span: one span of whole tiles covering the KV
  const int span =
      kv_span ? kv_span : (lkv + SPAN_TILE - 1) / SPAN_TILE * SPAN_TILE;
  const dim3 grid(batch * hq * ((lq + BQ - 1) / BQ), 1,
                  (lkv + span - 1) / span);
  prefill_attention_kernel<D, NC, BOUND>
      <<<grid, Block<NC>::THREADS, T::bytes, stream>>>(
          tq, tk, tv, o, out_f32, static_cast<float*>(lse), hq, hq / hkv, lq,
          lkv, mask, diag_off, window, offs, span,
          scale * 1.4426950408889634f, kmax, d,
          staged ? static_cast<const __nv_bfloat16*>(q) : nullptr,
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v));
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention.py has already checked shapes, dtypes, contiguity and
// alignment; the checks here only refuse what would index out of bounds.
// mask: 0 none, 1 causal, 2 window (window >= 1); lse may be null.
// offs: null (diag_off holds the diagonal) or a device pointer to the
// int32 pair (q_pos0, kv_pos0), whose difference replaces diag_off.
// kv_span: 0 for one span over the whole KV, else a multiple of 128 keys,
// and o / lse hold cdiv(lkv, kv_span) partials per row.  q_rows: the Q
// tile, 64 or 128.  kmax: null (the exact statistic) or the bound form's
// f32 [batch * hkv, cdiv(lkv, 128)] prefix maxima of |k|^2.  d: 1 to 512
// at both dtypes; up to 256 on the smallest instance D >= d (bf16 d % 8 !=
// 0 in the staged form), 257 to 512 on the wide blocks (bf16 launch_wide,
// f32 launch_wide_f32).  in_f32: 0 for bf16 q/k/v, 1 for f32 (bf16x6: up
// to d 256 the f32 core's instances D = 64, 128, 256, rows of d % 4 != 0
// read a float at a time; past it H5's f32 block in clusters of two, rows
// of d % 4 != 0 staged).
extern "C" int eft_prefill_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int batch, int hq, int hkv, int lq,
                                     int lkv, int d, int mask, int diag_off,
                                     int window, const void* offs,
                                     int kv_span, int out_f32, float scale,
                                     int q_rows, const void* kmax,
                                     int in_f32, int device, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || lq <= 0 || lkv <= 0 ||
      mask < MASK_NONE || mask > MASK_WINDOW ||
      (mask == MASK_WINDOW && window < 1) || kv_span < 0 ||
      kv_span % SPAN_TILE != 0 || (q_rows != 64 && q_rows != 128) ||
      d < 1 || d > 512 || (in_f32 != 0 && in_f32 != 1))
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o_offs = static_cast<const int*>(offs);
  const float* km = static_cast<const float*>(kmax);
  // one instance per (D, Q tile, statistic); at f32 per (D, statistic)
  auto go = [&](auto dc, auto nc, auto bound) {
    return launch<decltype(dc)::value, decltype(nc)::value,
                  decltype(bound)::value>(
        q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv, d, mask,
        diag_off, window, o_offs, kv_span, scale, km, s);
  };
  if (in_f32 && d > 256)
    return eft::prefill::launch_wide_f32(q, k, v, o, out_f32, lse, batch, hq,
                                         hkv, lq, lkv, d, mask, diag_off,
                                         window, o_offs, kv_span, scale, km,
                                         s);
  if (in_f32)
    return eft::prefill::launch_f32(q, k, v, o, out_f32, lse, batch, hq, hkv,
                                    lq, lkv, d, mask, diag_off, window,
                                    o_offs, kv_span, scale, km, s);
  if (d > 256)
    return eft::prefill::launch_wide(q, k, v, o, out_f32, lse, batch, hq,
                                     hkv, lq, lkv, d, mask, diag_off, window,
                                     o_offs, kv_span, scale, km, s);
  using T = std::true_type;
  using F = std::false_type;
  auto by_tile = [&](auto dc) {
    using N1 = std::integral_constant<int, 1>;
    using N2 = std::integral_constant<int, 2>;
    if (q_rows == 64) return km ? go(dc, N1{}, T{}) : go(dc, N1{}, F{});
    return km ? go(dc, N2{}, T{}) : go(dc, N2{}, F{});
  };
  if (d <= 32) return by_tile(std::integral_constant<int, 32>{});
  if (d <= 64) return by_tile(std::integral_constant<int, 64>{});
  if (d <= 128) return by_tile(std::integral_constant<int, 128>{});
  return by_tile(std::integral_constant<int, 256>{});
}

extern "C" const char* eft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
