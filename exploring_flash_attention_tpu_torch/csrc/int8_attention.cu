// H4-int8: the fully-int8 attention forward on Hopper (sm_90a).  int8 Q,
// K and V with per-block f32 scales, non-causal, bf16 or f32 O.
//
// Replaces the TPU kernel
//   B18 _int8_kernel   exploring_flash_attention_tpu/ops/attention_int8.py:50
// and computes its function, a one-pass softmax against the final row max:
// m is the row max over every key, l sums the f32 p, and P V runs in one
// of two modes:
//   pv_mode bf16: P rounded to bf16, V's codes converted to bf16 (exact,
//                 :112), bf16 products, f32 sums times v_scale (:111-119);
//   pv_mode int8: p_i8 = round(p * 127), half to even (__float2int_rn, as
//                 jnp.round), int8 x int8 -> int32 products, exact, times
//                 v_scale / 127 (:96-100, :119).
// The int8 or bf16 code of P depends on the final row max, so an online
// softmax (a running max) would compute another function.  So each block
// makes two passes over its keys in one launch: the first streams K alone
// and takes each row's max; the second streams K and V, recomputes S,
// forms P against the fixed max and accumulates P V, with no rescaling.
//
// Cost at the canonical shape (B=32, H=8, L=1024, d=128): 68.7 G int8
// operations for Q K^T and 68.7 G for P V, bf16 in pv_mode bf16: 0.104 ms
// at 1,979 TOP/s int8 and 989 TFLOP/s bf16 (0.069 ms all int8), against
// ~134 MB of int8 Q, K, V and bf16 O, 0.040 ms at 3.35 TB/s: bound by the
// tensor cores.  The first pass repeats the Q K^T half.
//
// Design (H1's block, wgmma_tile.cuh).  One block per (batch*head,
// 128-row Q tile), the Q tiles of a head next to each other in the grid:
// two consumer warpgroups of 64 rows and one producer warpgroup, which
// hands registers to the consumers (setmaxnreg: 40 and 232 per thread).
// The producer's first warp loads the int8 Q tile once, then streams
// 128-key tiles through a three-stage TMA ring: K alone for pass 1, K and
// V for pass 2; its 32 lanes also write each key's k_scale into the stage
// (a key past Lkv scores 0).  Its other three warps convert each pass-2 V
// tile into the stage's own buffer: bf16 codes in the MN-major layout H1
// reads V from (pv_mode bf16), or the transposed codes V^T, keys
// contiguous, for the K-major B operand that s8 wgmma requires (pv_mode
// int8).  K, V and the converted V complete on their own mbarriers, so
// that every waiter sees each phase it waits for.  Per tile a consumer
// warpgroup:
//   - runs S_i32 = Q_i8 K_i8^T on s8 wgmma (m64n128k32, both operands
//     K-major in 128- or 64-byte swizzled shared memory), exact; s =
//     f32(S) * cc with cc = (q_scale * k_scale) * scale * log2e in B18's
//     order (:85-89), the product and the - m rounded apart, no fused
//     multiply-add;
//   - pass 1: the row max in registers (quad shuffles);
//   - pass 2: p = exp2(s - m) (MUFU.EX2, within 2 ulp), with B18's -inf
//     guard (:93), l += p in f32; a tile wholly inside the KV takes a loop
//     without the key bound;
//   - the kv blocks the tile holds, each a run of 16-key (bf16) or 32-key
//     (int8) steps: the run's P V goes into a run accumulator in registers
//     (P from registers as the bf16 A fragment; or its int8 codes through a
//     per-warpgroup swizzled shared tile, the A operand of s8 wgmma, since
//     the s32 accumulator layout is not the s8 A fragment's), then O +=
//     acc * v_scale (v_scale / 127 in int8 mode).  Every step of the tile
//     is issued for each run, with the P codes outside the run set to zero
//     (so a run shorter than an int8 step, a block of 16 or 48 keys, works;
//     a branch around a wgmma would serialize them all).  Any kv block
//     that is a multiple of 16 works; a block of 128 keys or more makes
//     one run per tile.
// O stays in f32 registers to the end; each row's Q scale is
// scales[row / q_block] for any Q block.
//
// Budget at d=128: shared memory Q 16 KB, three stages of K and V 96 KB,
// three converted V buffers of 32 KB (bf16) or 16 KB (int8) plus P 16 KB,
// key scales 1.5 KB: 210 KB or 178 KB.  Registers: O 64 + the run
// accumulator 64 + P 32 (bf16 fragment) or 16 (packed int8 codes) per
// consumer thread, within 232 (a 288-thread block, with a single producer
// warp, is capped at 168 and spilled).
//
// Head dims.  d is any d from 1 to 256, on instances D = 64, 128 and 256
// (the smallest D >= d): at d a multiple of 16, Q, K and V are described
// to TMA with their true d (int8 rows of d bytes) and loaded as boxes of D
// columns, so the columns past d arrive as zero codes, add nothing to S
// and give O columns that the epilogue does not store.  At any other d no
// tensor map takes a row stride of d bytes: the PACKED instances copy the
// rows themselves into the same swizzled boxes (Q and K) and plain tiles
// (V), zeros past d and past L, with cp.async pieces of the rows'
// alignment (a code at a time below 4 bytes; wgmma_tile.cuh stage16): the
// whole producer warpgroup Q's rows once, the loading warp each K and V
// tile, a tile's copies one group, handed over (its lanes arrive on the
// stage's barriers) once the next tile's are issued.  The padded share
// of the products is (D - d) / D (37.5% at d=80).  The softmax scale is the
// caller's, 1/sqrt(d) of the true d.  At D=256 (d 144 to 256):
//   - Q and K rows are 256 bytes, two 128-byte boxes each (the swizzle is
//     at most 128 bytes wide), S's k-steps walking the boxes in turn;
//   - O alone is 128 registers a consumer thread, so the K/V tile is 64
//     keys (S 32 registers; three stages of K, V and the converted V in
//     226 KB at pv_mode bf16) and each run's P V is four products of 64 of
//     O's columns, each in a fresh 32-register accumulator that is scaled
//     by the run's v_scale and added into O before the next is issued: O
//     128 + the part 32 + P 16 + the run's masked copy 16 within 232 (the
//     part starts from its first wgmma's scale-d 0, descriptors are made
//     where they are issued, and the epilogue finds its rows again: with
//     any of these kept in registers over the loops, ptxas spilled; the
//     smaller instances keep the tuned code, Tiles::TIGHT).  The
//     function is B18's as at D=128: m over every key (pass 1), l the f32
//     p, each kv block's P V scaled by its v_scale after the product.
//   - In pv_mode int8, V^T and each warpgroup's P tile have rows of 64
//     keys, 64 bytes, and take the 64-byte swizzle.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "wgmma_tile.cuh"

namespace {

using namespace eft::hopper;

constexpr int BQ = 128;          // Q rows per block
constexpr int STAGES = 3;        // K/V ring depth
constexpr int CONSUMERS = 2;     // warpgroups of 64 Q rows
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int CONVERTERS = 96;   // the producer warpgroup's last 3 warps
// registers per thread after setmaxnreg: 128 * 40 + 256 * 232 = 384 * 168,
// what the launch allocates (more, and the consumers' setmaxnreg.inc waits
// forever)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int P_BAR = 1;         // + wg: each warpgroup's P tile

// Shared memory of one block.  Q and K are boxes of QK_BOX int8 columns
// (the swizzle width; D up to 128, two boxes of 128 at D=256) by their
// rows, box after box; the V stage is plain [BKV][D] codes; the converted
// V is bf16 [D / 64][BKV][64] (128-byte swizzle, MN-major) or int8 V^T
// [D][BKV] (BKV-byte swizzle, K-major); P is int8 [64][BKV] per warpgroup
// (BKV-byte swizzle).  K/V tiles of BKV keys (128; 64 at D=256); P V in
// parts of PV_N of O's columns (D; 64 at D=256), each in a fresh
// accumulator.
template <int D, bool PV_INT8>
struct Tiles {
  static constexpr int BKV = D == 256 ? 64 : 128;
  static constexpr int QK_BOX = D < 128 ? D : 128;
  static constexpr int NQK = D / QK_BOX;
  static constexpr int PV_N = D == 256 ? 64 : D;
  // registers tight (O 128 a consumer thread): the part starts from its
  // first wgmma's scale-d 0, descriptors are made where they are issued
  // (opaque), the epilogue finds its rows again; the smaller instances
  // keep the tuned code
  static constexpr bool TIGHT = D == 256;
  static constexpr uint32_t Q_BYTES = BQ * D;
  static constexpr uint32_t KV_BYTES = BKV * D;
  static constexpr uint32_t CONV_BYTES = PV_INT8 ? BKV * D : BKV * D * 2;
  static constexpr uint32_t P_BYTES = PV_INT8 ? 64 * BKV : 0;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + Q_BYTES;
  static constexpr size_t v = k + size_t(STAGES) * KV_BYTES;
  static constexpr size_t conv = v + size_t(STAGES) * KV_BYTES;
  static constexpr size_t p = conv + size_t(STAGES) * CONV_BYTES;
  static constexpr size_t kscale = p + size_t(CONSUMERS) * P_BYTES;
  static constexpr size_t bars = kscale + size_t(STAGES) * BKV * 4;
  static constexpr size_t bytes = bars + 8 * (4 * STAGES + 1) + 1024;
  static_assert(bytes <= 232448, "the block's shared memory");
};

// S = Q K^T of one K tile on s8 wgmma, waited for; q_wg is the
// warpgroup's first row in Q's first box
template <int D>
__device__ __forceinline__ void wgmma_qk(int (&s)[Tiles<D, false>::BKV / 2],
                                         const unsigned char* q_wg,
                                         const unsigned char* k_s) {
  using T = Tiles<D, false>;
  constexpr int W = T::QK_BOX;
  if constexpr (T::TIGHT) q_wg = opaque(q_wg);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk) {
    const int box = kk / (W / 32), off = (kk % (W / 32)) * 32;
    const uint64_t da = gmma_desc(q_wg + box * BQ * W + off, 16, 8 * W, W);
    const uint64_t db = gmma_desc(k_s + box * T::BKV * W + off, 16, 8 * W, W);
    if constexpr (T::BKV == 128) {
      if (kk == 0) wgmma_ss_s8_n128_first(s, da, db);
      else wgmma_ss_s8_n128(s, da, db, 1);
    } else {
      if (kk == 0) wgmma_ss_s8_n64_first(s, da, db);
      else wgmma_ss_s8_n64(s, da, db, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
}

// PACKED: d % 16 != 0, Q, K and V copied by the producer's threads from
// qg, kg and vg (tq, tk and tv unused; the instances of the multiples of 16
// compile without it)
template <int D, bool PV_INT8, bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
int8_attention_kernel(const __grid_constant__ CUtensorMap tq,  // [BH, Lq, d]
                      const __grid_constant__ CUtensorMap tk,  // [BH, Lkv, d]
                      const __grid_constant__ CUtensorMap tv,  // [BH, Lkv, d]
                      const float* __restrict__ qs,    // [BH, n_qb]
                      const float* __restrict__ ks,    // [BH, n_kvb]
                      const float* __restrict__ vs,    // [BH, n_kvb]
                      void* __restrict__ o,            // [BH, Lq, d]
                      int out_f32, int lq, int lkv, int d, int q_block,
                      int n_qb, int kv_block, int n_kvb, float scale_log2,
                      const int8_t* __restrict__ qg,   // [BH, Lq, d]
                      const int8_t* __restrict__ kg,   // [BH, Lkv, d]
                      const int8_t* __restrict__ vg) { // [BH, Lkv, d]
  using T = Tiles<D, PV_INT8>;
  constexpr int BKV = T::BKV, W = T::QK_BOX, PV_N = T::PV_N;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sq = smem + T::q;
  unsigned char* sk = smem + T::k;
  unsigned char* sv = smem + T::v;
  float* skey = reinterpret_cast<float*>(smem + T::kscale);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);  // K
  uint64_t* empty = full + STAGES;
  uint64_t* v_full = empty + STAGES;         // V's codes (pass 2)
  uint64_t* conv_full = v_full + STAGES;     // V converted (pass 2)
  uint64_t* q_full = conv_full + STAGES;

  // blockIdx.x runs over the Q tiles of one head first (K and V shared in
  // L2 by the blocks in flight)
  const int n_qt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int n_tiles = (lkv + BKV - 1) / BKV;
  const float* vsb = vs + size_t(bh) * n_kvb;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);           // the loading warp's lanes
      mbar_init(&empty[s], CONSUMERS * 128);
      mbar_init(&v_full[s], PACKED ? 32 : 1);
      mbar_init(&conv_full[s], CONVERTERS);
    }
    mbar_init(q_full, PACKED ? 128 : 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer warpgroup hands registers to the consumers
    setmaxnreg_dec<PRODUCER_REGS>();
    const int al = row_align(d);
    if constexpr (PACKED) {
      // Q's rows, a row a thread, handed over at once
      const int r = threadIdx.x - CONSUMERS * 128;
      const int8_t* src = qg + (size_t(bh) * lq + q0 + r) * d;
#pragma unroll 1
      for (int c = 0; c < D; c += 16)
        stage16(smem_u32(sq + (c / W) * BQ * W) + swz<W>(r, c % W), src + c,
                al, q0 + r < lq ? d - c : 0);
      cp_async_commit();
      hand_over(smem_u32(q_full), true);
    }
    // PACKED: this lane's pieces of rows [kv0, kv0 + BKV) of K (into the
    // stage's swizzled boxes) or V (its plain tile): the 16 bytes at
    // column col of every (32 / (D / 16))-th row from its first (a lane's
    // column is the same in every row, so the loop holds few registers:
    // with the piece's row and column recomputed, the loading warp spilled
    // at D=256 on its 40)
    constexpr int PER_ROW = D / 16;
    const int col = (lane % PER_ROW) * 16;
    auto stage_tile = [&](const int8_t* g, unsigned char* dst, bool boxes,
                          int kv0) {
      const int8_t* src = g + (size_t(bh) * lkv + kv0) * d + col;
      const uint32_t base = smem_u32(dst) + (boxes ? (col / W) * BKV * W
                                                   : col);
#pragma unroll 1
      for (int r = lane / PER_ROW; r < BKV; r += 32 / PER_ROW)
        stage16(base + (boxes ? swz<W>(r, col % W) : r * D),
                src + size_t(r) * d, al, kv0 + r < lkv ? d - col : 0);
    };
    if (warp == CONSUMERS * 4) {
      // the loading warp: Q once; then K tiles (pass 1), K and V tiles
      // (pass 2), each with its keys' k_scale
      const float* ksb = ks + size_t(bh) * n_kvb;
      if (!PACKED && lane == 0) {
        mbar_arrive_expect_tx(q_full, T::Q_BYTES);
        for (int x = 0; x < T::NQK; ++x)
          tma_load_3d(sq + x * BQ * W, &tq, q_full, x * W, q0, bh);
      }
      for (int i = 0; i < 2 * n_tiles; ++i) {
        const int s = i % STAGES;
        const bool pass2 = i >= n_tiles;
        const int kv0 = (pass2 ? i - n_tiles : i) * BKV;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        for (int c = lane; c < BKV; c += 32)
          skey[s * BKV + c] = kv0 + c < lkv ? ksb[(kv0 + c) / kv_block] : 0.f;
        if constexpr (PACKED) {
          // this tile's copies, one group; then tile i - 1's handed over
          stage_tile(kg, sk + s * T::KV_BYTES, true, kv0);
          if (pass2) stage_tile(vg, sv + s * T::KV_BYTES, false, kv0);
          cp_async_commit();
          if (i > 0) {
            const int p = (i - 1) % STAGES;
            hand_over(smem_u32(&full[p]), false);
            if (i - 1 >= n_tiles) mbar_arrive(&v_full[p]);
          }
          if (i == 2 * n_tiles - 1) {
            hand_over(smem_u32(&full[s]), true);
            mbar_arrive(&v_full[s]);
          }
        } else if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], T::KV_BYTES);
          for (int x = 0; x < T::NQK; ++x)
            tma_load_3d(sk + s * T::KV_BYTES + x * BKV * W, &tk, &full[s],
                        x * W, kv0, bh);
          if (pass2) {
            mbar_arrive_expect_tx(&v_full[s], T::KV_BYTES);
            tma_load_3d(sv + s * T::KV_BYTES, &tv, &v_full[s], 0, kv0, bh);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    } else {
      // the converting warps: each pass-2 V tile into the stage's buffer,
      // bf16 in the MN-major layout H1 reads V from (pv_mode bf16), or the
      // transposed codes V^T, keys contiguous, for the K-major B operand
      // that s8 wgmma requires (pv_mode int8)
      const int ct = threadIdx.x - (CONSUMERS * 4 + 1) * 32;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = (n_tiles + t) % STAGES;
        mbar_wait(&v_full[s], (t / STAGES) & 1);
        const unsigned char* v_s = sv + s * T::KV_BYTES;
        unsigned char* conv = smem + T::conv + s * T::CONV_BYTES;
        if constexpr (PV_INT8) {
          // V^T [D][BKV keys]: 16 keys of one column per 16-byte chunk
          for (int x = ct; x < D * (BKV / 16); x += CONVERTERS) {
            const int col = x % D, c = x / D;
            uint32_t w[4];
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const unsigned char* src = v_s + (c * 16 + 4 * b) * D + col;
              w[b] = uint32_t(src[0]) | (uint32_t(src[D]) << 8)
                     | (uint32_t(src[2 * D]) << 16)
                     | (uint32_t(src[3 * D]) << 24);
            }
            *reinterpret_cast<uint4*>(conv + swz<BKV>(col, c * 16)) =
                make_uint4(w[0], w[1], w[2], w[3]);
          }
        } else {
          // bf16 [D / 64][BKV keys][64]
          convert_codes_tile<KV_INT8, false, D>(v_s, conv, BKV, ct,
                                                CONVERTERS);
        }
        fence_proxy_async();
        mbar_arrive(&conv_full[s]);
      }
    }
    return;
  }

  // a consumer warpgroup: rows q0 + 64 wg .. + 63; this thread owns two
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const unsigned char* q_wg = sq + wg * 64 * W;
  float q_scale[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    q_scale[r] = qi < lq ? qs[size_t(bh) * n_qb + qi / q_block] : 0.f;
  }
  mbar_wait(q_full, 0);

  // pass 1: each row's max of s_i32 * (q_scale * k_scale) * scale * log2e
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const int kv0 = i * BKV;
    mbar_wait(&full[s], (i / STAGES) & 1);
    int acc_s[BKV / 2];
    wgmma_qk<D>(acc_s, q_wg, sk + s * T::KV_BYTES);
    const float* ks_s = skey + s * BKV;
    if (kv0 + BKV <= lkv) {
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        const int r = acc_row8(e) / 8;
        m[r] = fmaxf(m[r], __fmul_rn(float(acc_s[e]),
                                     q_scale[r] * ks_s[col0 + acc_col(e)]
                                         * scale_log2));
      }
    } else {
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        const int r = acc_row8(e) / 8;
        const int col = col0 + acc_col(e);
        const float x = __fmul_rn(float(acc_s[e]),
                                  q_scale[r] * ks_s[col] * scale_log2);
        m[r] = fmaxf(m[r], kv0 + col < lkv ? x : -CUDART_INF_F);
      }
    }
    mbar_arrive(&empty[s]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) m[r] = quad_max(m[r]);

  // pass 2: P against the fixed max, O += (P V) * v_scale per kv block
  float acc_o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_o[e] = 0.f;
  float l[2] = {0.f, 0.f};
  for (int t = 0; t < n_tiles; ++t) {
    const int i = n_tiles + t;
    const int s = i % STAGES;
    const int kv0 = t * BKV;
    mbar_wait(&full[s], (i / STAGES) & 1);
    int acc_s[BKV / 2];
    wgmma_qk<D>(acc_s, q_wg, sk + s * T::KV_BYTES);

    // P: the bf16 A fragment, or the int8 codes packed two by two.  A
    // whole tile takes a loop without the key bound (selects, not
    // branches: an accumulator read in a divergent path serializes wgmma)
    uint32_t pa[PV_INT8 ? BKV / 8 : BKV / 4];
    const float* ks_s = skey + s * BKV;
    const bool whole = kv0 + BKV <= lkv;
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const int r = j & 1;
      float p[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int col = col0 + acc_col(2 * j + x);
        // s = s_i32 * cc and s - m each rounded, as B18 computes them
        // (no fused multiply-add); B18's guard: a row whose max is -inf
        // gets exp2(-inf) = 0
        const float arg = __fsub_rn(
            __fmul_rn(float(acc_s[2 * j + x]),
                      q_scale[r] * ks_s[col] * scale_log2), m[r]);
        p[x] = exp2_approx(m[r] == -CUDART_INF_F ? -CUDART_INF_F : arg);
        if (!whole) p[x] = kv0 + col < lkv ? p[x] : 0.f;
        l[r] += p[x];
      }
      if constexpr (PV_INT8) {
        const uint32_t c = (uint32_t(__float2int_rn(p[0] * 127.f)) & 0xff)
                           | ((uint32_t(__float2int_rn(p[1] * 127.f)) & 0xff)
                              << 8);
        if (j % 2 == 0) pa[j / 2] = c;
        else pa[j / 2] |= c << 16;
      } else {
        pa[j] = pack_bf16x2(p[0], p[1]);
      }
    }

    // the stage's V, converted by the producer warpgroup
    mbar_wait(&conv_full[s], (t / STAGES) & 1);
    const unsigned char* conv = smem + T::conv + s * T::CONV_BYTES;

    // one run per kv block in the tile: [r0, r1) of its BKV keys
    const int tile_end = min(kv0 + BKV, lkv);
    for (int b = kv0 / kv_block; b * kv_block < tile_end; ++b) {
      const int r0 = max(kv0, b * kv_block) - kv0;
      const int r1 = min(tile_end, (b + 1) * kv_block) - kv0;
      const float v_scale = PV_INT8 ? vsb[b] * (1.f / 127.f) : vsb[b];
      const unsigned char* cv = T::TIGHT ? opaque(conv) : conv;
      if constexpr (PV_INT8) {
        // this warpgroup's P codes of the run, zero outside it
        unsigned char* sp = smem + T::p + wg * T::P_BYTES;
        if constexpr (T::TIGHT) sp = opaque(sp);
        named_bar_sync(P_BAR + wg, 128);         // the last run's reads done
#pragma unroll
        for (int j = 0; j < BKV / 4; ++j) {
          const int r = j & 1;
          const int col = col0 + acc_col(2 * j);
          const uint32_t c = (pa[j / 2] >> (16 * (j % 2))) & 0xffff;
          const uint32_t keep = (col >= r0 && col < r1 ? 0xff : 0)
                                | (col + 1 >= r0 && col + 1 < r1 ? 0xff00 : 0);
          *reinterpret_cast<uint16_t*>(
              sp + swz<BKV>((warp % 4) * 16 + lane / 4 + 8 * r, col)) =
              uint16_t(c & keep);
        }
        fence_proxy_async();
        named_bar_sync(P_BAR + wg, 128);
        // P V in parts of PV_N of O's columns (rows of V^T), each from a
        // fresh accumulator, times v_scale / 127 into O
#pragma unroll
        for (int h = 0; h < D / PV_N; ++h) {
          // the part from its first step's scale-d 0 (a zeroed
          // accumulator made ptxas fence the products, C7519)
          int acc_i[PV_N / 2];
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BKV / 32; ++kk) {
            const uint64_t dp = gmma_desc(sp + kk * 32, 16, 8 * BKV, BKV);
            const uint64_t dv = gmma_desc(cv + h * PV_N * BKV + kk * 32,
                                          16, 8 * BKV, BKV);
            if constexpr (PV_N == 128) {
              if (kk == 0) wgmma_ss_s8_n128_first(acc_i, dp, dv);
              else wgmma_ss_s8_n128(acc_i, dp, dv, 1);
            } else {
              if (kk == 0) wgmma_ss_s8_n64_first(acc_i, dp, dv);
              else wgmma_ss_s8_n64(acc_i, dp, dv, 1);
            }
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc_i);
#pragma unroll
          for (int e = 0; e < PV_N / 2; ++e)
            acc_o[h * (PV_N / 2) + e] += float(acc_i[e]) * v_scale;
        }
      } else {
        // every step is issued (a branch around a wgmma serializes them
        // all); the steps outside the run multiply zeros.  The run's
        // fragment is masked before the fence: a register written between
        // two wgmmas makes ptxas fence before each (C7519)
        uint32_t pr[BKV / 4];
#pragma unroll
        for (int j = 0; j < BKV / 4; ++j)
          pr[j] = (j / 4) * 16 >= r0 && (j / 4) * 16 < r1 ? pa[j] : 0u;
        // P V in parts of PV_N of O's columns (V's 64-column boxes), each
        // from a fresh accumulator, times v_scale into O
#pragma unroll
        for (int h = 0; h < D / PV_N; ++h) {
          float acc[PV_N / 2];
          if constexpr (!T::TIGHT) {
#pragma unroll
            for (int e = 0; e < PV_N / 2; ++e) acc[e] = 0.f;
          }
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BKV / 16; ++kk) {
            const uint64_t dv = gmma_desc(
                cv + h * (PV_N / 64) * BKV * 128 + kk * 16 * 128,
                BKV * 128, 1024, 128);
            if constexpr (PV_N == 128)
              wgmma_rs_bf16_n128(acc, pr[4 * kk], pr[4 * kk + 1],
                                 pr[4 * kk + 2], pr[4 * kk + 3], dv, 1);
            else
              wgmma_rs_bf16_n64(acc, pr[4 * kk], pr[4 * kk + 1],
                                pr[4 * kk + 2], pr[4 * kk + 3], dv,
                                !T::TIGHT || kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(acc);
#pragma unroll
          for (int e = 0; e < PV_N / 2; ++e)
            acc_o[h * (PV_N / 2) + e] += acc[e] * v_scale;
        }
      }
    }
    mbar_arrive(&empty[s]);            // K, the key scales, V and its copy
  }

  // the first d columns of the two owned rows; at d = D inlined apart,
  // with constant strides.  At D=256 the rows are found from the block's
  // and thread's indices again (kept live over the loops, they spilled)
  int row = row0, head = bh;
  if constexpr (T::TIGHT) {
    const int cta = ctaid_x_again(), tid = tid_x_again();
    row = (cta % n_qt) * BQ + tid / 128 * 64 + tid / 32 % 4 * 16
          + tid % 32 / 4;
    head = cta / n_qt;
  }
  if constexpr (PACKED) {
    // a value at a time (d % 8 != 0 takes it; one epilogue, which at D=256
    // keeps the consumers within their registers)
    store_o_rows<D, true>(acc_o, l, m, row, lq, size_t(head) * lq, o,
                          out_f32, nullptr, d, 0, d);
  } else if (d == D) {
    store_o_rows<D>(acc_o, l, m, row, lq, size_t(head) * lq, o, out_f32,
                    nullptr);
  } else {
    store_o_rows<D>(acc_o, l, m, row, lq, size_t(head) * lq, o, out_f32,
                    nullptr, d, 0, d);
  }
}

template <int D, bool PV_INT8, bool PACKED>
int launch(const void* q, const void* k, const void* v, const void* qs,
           const void* ks, const void* vs, void* o, int out_f32, int bh,
           int lq, int lkv, int d, int q_block, int n_qb, int kv_block,
           int n_kvb, float scale_log2, cudaStream_t stream) {
  using T = Tiles<D, PV_INT8>;
  // boxes of D columns (Q and K: NQK boxes of QK_BOX) over rows of the
  // true d: the columns past d arrive as zero codes.  PACKED: no tensor
  // map takes the rows; the kernel copies them
  CUtensorMap tq = {}, tk = {}, tv = {};
  if constexpr (!PACKED) {
    int err = make_tmap(&tq, q, 1, d, lq, bh, T::QK_BOX, BQ, T::QK_BOX);
    if (!err) err = make_tmap(&tk, k, 1, d, lkv, bh, T::QK_BOX, T::BKV,
                              T::QK_BOX);
    if (!err) err = make_tmap(&tv, v, 1, d, lkv, bh, D, T::BKV, 0);
    if (err) return err;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      int8_attention_kernel<D, PV_INT8, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(bh * ((lq + BQ - 1) / BQ));
  int8_attention_kernel<D, PV_INT8, PACKED>
      <<<grid, THREADS, T::bytes, stream>>>(
          tq, tk, tv, static_cast<const float*>(qs),
          static_cast<const float*>(ks), static_cast<const float*>(vs), o,
          out_f32, lq, lkv, d, q_block, n_qb, kv_block, n_kvb, scale_log2,
          static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
          static_cast<const int8_t*>(v));
  return int(cudaGetLastError());
}

template <int D>
int launch_mode(int pv_int8, const void* q, const void* k, const void* v,
                const void* qs, const void* ks, const void* vs, void* o,
                int out_f32, int bh, int lq, int lkv, int d, int q_block,
                int n_qb, int kv_block, int n_kvb, float scale_log2,
                cudaStream_t stream) {
  auto go = [&](auto mode, auto packed) {
    return launch<D, decltype(mode)::value, decltype(packed)::value>(
        q, k, v, qs, ks, vs, o, out_f32, bh, lq, lkv, d, q_block, n_qb,
        kv_block, n_kvb, scale_log2, stream);
  };
  if (d % 16 != 0)
    return pv_int8 ? go(std::true_type{}, std::true_type{})
                   : go(std::false_type{}, std::true_type{});
  return pv_int8 ? go(std::true_type{}, std::false_type{})
                 : go(std::false_type{}, std::false_type{});
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_int8.py has already checked shapes, dtypes, contiguity and
// alignment; the checks here only refuse what would index out of bounds.
// d: from 1 to 256, on the instance D = 64, 128 or 256 (the smallest D >=
// d; the PACKED one at d % 16 != 0); kv_block must be a multiple of 16; scale_log2 =
// softmax scale * log2(e) (the scale of the true d).
extern "C" int eft_int8_attention(const void* q, const void* k, const void* v,
                                  const void* qs, const void* ks,
                                  const void* vs, void* o, int batch,
                                  int heads, int lq, int lkv, int d,
                                  int q_block, int n_qb, int kv_block,
                                  int n_kvb, int pv_int8, int out_f32,
                                  float scale_log2, int device, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lkv <= 0 || q_block <= 0 ||
      n_qb != (lq + q_block - 1) / q_block || kv_block <= 0 ||
      kv_block % 16 != 0 || n_kvb != (lkv + kv_block - 1) / kv_block ||
      d < 1 || d > 256)
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto dc) {
    return launch_mode<decltype(dc)::value>(
        pv_int8, q, k, v, qs, ks, vs, o, out_f32, batch * heads, lq, lkv, d,
        q_block, n_qb, kv_block, n_kvb, scale_log2, s);
  };
  if (d <= 64) return go(std::integral_constant<int, 64>{});
  if (d <= 128) return go(std::integral_constant<int, 128>{});
  return go(std::integral_constant<int, 256>{});
}
