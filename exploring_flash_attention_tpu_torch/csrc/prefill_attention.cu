// H1: the attention forward on Hopper (sm_90a). bf16 in, f32 accumulate,
// one kernel for three masks (none, causal, sliding window) and head dims
// 32, 64 and 128.
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

using namespace eft::hopper;

constexpr int BQ = 128;          // Q rows per block
constexpr int BKV = 128;         // keys per K/V tile; a KV span is whole tiles
constexpr int STAGES = 3;        // K/V ring depth
constexpr int CONSUMERS = 2;     // warpgroups of 64 Q rows
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
// registers per thread after setmaxnreg: 128 * 24 + 256 * 240 = 384 * 168,
// what the launch allocates (more, and the consumers' setmaxnreg.inc waits
// forever)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// the mask argument of eft_prefill_attention
enum Mask : int { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

// Shared memory of one block.  Every tile is TMA boxes of BOX columns
// (rows of BOX * 2 bytes, the swizzle width) by 128 rows, box after box.
template <int D>
struct Tiles {
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
};

__device__ __forceinline__ long long clamp64(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_bf16_n128(o, a[0], a[1], a[2], a[3], db, 1);
  else if constexpr (D == 64)
    wgmma_rs_bf16_n64(o, a[0], a[1], a[2], a[3], db, 1);
  else
    wgmma_rs_bf16_n32(o, a[0], a[1], a[2], a[3], db, 1);
}

// S = Q K^T of one K tile (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_qk(float (&acc_s)[BKV / 2],
                                         const unsigned char* q_wg,
                                         const unsigned char* k_s) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / T::BOX, off = (kk * 16 % T::BOX) * 2;
    const uint64_t da = gmma_desc(q_wg + box * BQ * T::ROW + off, 16,
                                  8 * T::ROW, T::ROW);
    const uint64_t db = gmma_desc(k_s + box * BKV * T::ROW + off, 16,
                                  8 * T::ROW, T::ROW);
    if (kk == 0) wgmma_ss_bf16_n128_first(acc_s, da, db);
    else wgmma_ss_bf16_n128(acc_s, da, db, 1);
  }
}

// O += P V of one V tile, 16 keys a step (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc_o)[D / 2],
                                         const uint32_t (&pa)[BKV / 4],
                                         const unsigned char* v_s) {
  using T = Tiles<D>;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_pv<D>(acc_o, &pa[4 * kk],
                gmma_desc(v_s + kk * 16 * T::ROW, BKV * T::ROW, 8 * T::ROW,
                          T::ROW));
}

// The online softmax of one S tile, in registers: the mask (unless the
// tile is whole) and the scale, the new row max (quad shuffles), p =
// exp2(s - m_use) in f32; alpha = exp2(m_old - m_use) for O and l
__device__ __forceinline__ void softmax_exp(
    float (&acc_s)[BKV / 2],
    float (&m)[2], float (&alpha)[2], bool whole, int col_base,
    const int (&lo)[2], const int (&hi)[2], float scale_log2) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  if (whole) {
#pragma unroll
    for (int e = 0; e < BKV / 2; ++e) {
      acc_s[e] = acc_s[e] * scale_log2;
      mx[acc_row8(e) / 8] = fmaxf(mx[acc_row8(e) / 8], acc_s[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < BKV / 2; ++e) {
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
  for (int e = 0; e < BKV / 2; ++e)
    acc_s[e] = exp2_approx(acc_s[e] - m_use[acc_row8(e) / 8]);
}

// P packed as the bf16 A fragment of P V; l = l * alpha + the rounded P
__device__ __forceinline__ void pack_p(const float (&p)[BKV / 2],
                                       uint32_t (&pa)[BKV / 4], float (&l)[2],
                                       const float (&alpha)[2]) {
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BKV / 4; ++j)
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
template <int D>
__device__ __forceinline__ void consume(
    const unsigned char* sq, const unsigned char* sk, const unsigned char* sv,
    uint64_t* full, uint64_t* empty, uint64_t* q_full, void* o, int out_f32,
    float* lse, int lq, int lkv, int mask, int diag_off, int window,
    float scale_log2, int q0, int bh, int span, int kv_begin, int n_tiles) {
  using T = Tiles<D>;
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
    float alpha[2];
    uint32_t pa[BKV / 4];
    {
      // tile 0 (O is still zero: no rescale)
      float acc_s[BKV / 2];
      mbar_wait(&full[0], 0);
      wgmma_fence();
      issue_qk<D>(acc_s, q_wg, sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);
      softmax_exp(acc_s, m, alpha, is_whole(kv_begin), kv_begin + col0, lo, hi, scale_log2);
      pack_p(acc_s, pa, l, alpha);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES, prev = (i - 1) % STAGES;
      const int kv0 = kv_begin + i * BKV;
      float acc_s[BKV / 2];
      mbar_wait(&full[s], (i / STAGES) & 1);
      wgmma_fence();
      issue_qk<D>(acc_s, q_wg, sk + s * T::KV_BYTES);
      wgmma_commit();
      fence_regs(acc_s);
      // O of the tiles before i - 1, rescaled by tile i - 1's alpha, while
      // S of tile i runs; then P V of tile i - 1
#pragma unroll
      for (int e = 0; e < D / 2; ++e) acc_o[e] *= alpha[acc_row8(e) / 8];
      fence_regs(acc_o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<D>(acc_o, pa, sv + prev * T::KV_BYTES);
      wgmma_commit();
      fence_regs(acc_o);
      fence_regs(pa);
      wgmma_wait<1>();                 // S of tile i
      softmax_exp(acc_s, m, alpha, is_whole(kv0), kv0 + col0, lo, hi, scale_log2);
      wgmma_wait<0>();                 // P V of tile i - 1
      fence_regs(acc_o);
      fence_regs(pa);
      mbar_arrive(&empty[prev]);
      pack_p(acc_s, pa, l, alpha);
    }
    const int last = (n_tiles - 1) % STAGES;
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc_o[e] *= alpha[acc_row8(e) / 8];
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

  // normalize and store once from f32, with the LSE when asked
  store_o_rows<D>(acc_o, l, m, row0, lq, (size_t(bh) * gridDim.z + span) * lq,
                  o, out_f32, lse);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
prefill_attention_kernel(const __grid_constant__ CUtensorMap tq,  // [B*Hq, Lq, D]
                         const __grid_constant__ CUtensorMap tk,  // [B*Hkv, Lkv, D]
                         const __grid_constant__ CUtensorMap tv,  // [B*Hkv, Lkv, D]
                         void* __restrict__ o,                  // [B, Hq, Lq, D]
                         int out_f32,                           // o f32, else bf16
                         float* __restrict__ lse,               // [B, Hq, Lq] or null
                         int hq, int group, int lq, int lkv, int mask,
                         int diag_off, int window,
                         const int* __restrict__ offs,  // (q_pos0, kv_pos0) or null
                         int kv_span, float scale_log2) {
  using T = Tiles<D>;
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

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer warpgroup gives its registers to the consumers; its
    // first lane loads Q once, then K and V tile by tile through the ring
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0 && n_tiles > 0) {
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
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<D>(sq, sk, sv, full, empty, q_full, o, out_f32, lse, lq, lkv,
               mask, diag_off, window, scale_log2, q0, bh, span, kv_begin,
               n_tiles);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           int out_f32, void* lse, int batch, int hq, int hkv, int lq,
           int lkv, int mask, int diag_off, int window, const int* offs,
           int kv_span, float scale, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap tq, tk, tv;
  int err = make_tmap(&tq, q, 2, D, lq, batch * hq, T::BOX, BQ, T::ROW);
  if (!err) err = make_tmap(&tk, k, 2, D, lkv, batch * hkv, T::BOX, BKV, T::ROW);
  if (!err) err = make_tmap(&tv, v, 2, D, lkv, batch * hkv, T::BOX, BKV, T::ROW);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      prefill_attention_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  // no span: one span of whole tiles covering the KV
  const int span = kv_span ? kv_span : (lkv + BKV - 1) / BKV * BKV;
  const dim3 grid(batch * hq * ((lq + BQ - 1) / BQ), 1,
                  (lkv + span - 1) / span);
  prefill_attention_kernel<D><<<grid, THREADS, T::bytes, stream>>>(
      tq, tk, tv, o, out_f32, static_cast<float*>(lse), hq, hq / hkv, lq,
      lkv, mask, diag_off, window, offs, span, scale * 1.4426950408889634f);
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
// and o / lse hold cdiv(lkv, kv_span) partials per row.
extern "C" int eft_prefill_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int batch, int hq, int hkv, int lq,
                                     int lkv, int d, int mask, int diag_off,
                                     int window, const void* offs,
                                     int kv_span, int out_f32,
                                     float scale, int device, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || lq <= 0 || lkv <= 0 ||
      mask < MASK_NONE || mask > MASK_WINDOW ||
      (mask == MASK_WINDOW && window < 1) || kv_span < 0 ||
      kv_span % BKV != 0)
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* o_offs = static_cast<const int*>(offs);
  switch (d) {
    case 32:
      return launch<32>(q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv,
                        mask, diag_off, window, o_offs, kv_span, scale, s);
    case 64:
      return launch<64>(q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv,
                        mask, diag_off, window, o_offs, kv_span, scale, s);
    case 128:
      return launch<128>(q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv,
                         mask, diag_off, window, o_offs, kv_span, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" const char* eft_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
