// H3-dkv and H3-dq: the flash-attention backward on Hopper (sm_90a), one
// pair of kernels for three masks (none, causal, sliding window).  bf16 in,
// f32 accumulate, bf16 out; every head dim d that is a multiple of 16 from
// 16 to 256 (ops.attention.HEAD_DIM_RULE), on instances D = 32, 64, 128
// and 256.  f32 in and out take a second pair of kernels on the f32 core's
// arithmetic (bf16x6 on wgmma, "f32 inputs" below), d 16 to 256 on
// instances D = 64, 128 and 256 (a cluster of two blocks).  A d
// below its instance's D (16 on 32, 48 on 64, 80-112 on 128,
// 144-240 on 256) is described to TMA with its true d, so the columns of
// Q, K, V and dO past d land as zeros, which leave S and dP exact, and the
// epilogues store the first d columns of dQ, dK and dV.  The padded
// columns cost (D - d) / D of the products: 50% at d=16, 37.5% at d=80.
// At d = D = 64 and 128, the tuned instances, d is a template constant
// (EXACT): the code is the one they had before the d rule.
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
// would need a sum of dQ across blocks (atomics, whose order changes from
// run to run), so it is split as B12 and B13 are.  The traced offsets of
// B11-B15 (their offs_ref SMEM operand) come as a device pointer to the
// int32 pair (q_pos0, kv_pos0), read by each block before it derives its
// loop bounds: no host read, and a CUDA graph replays with new offsets.
//
//   P  = exp2(S * scale * log2e - lse * log2e),  S = Q K^T,
//        0 where row i does not see key j and on rows with lse = -inf
//   dV = P^T dO      dP = dO V^T      dS = P o (dP - delta) * scale
//   dQ = dS K        dK = dS^T Q
//
// Masks are H1's (prefill_attention.cu): row i sits at position i +
// diag_off of the key axis; none shows it every key, causal the keys j <=
// i + diag_off, a window further needs j >= i + diag_off - window + 1.
// delta = rowsum(dO o O) in f32 comes from the wrapper
// (ops/attention_bwd.py), as in the JAX package.  At bf16, P and dS are
// rounded to bf16 before their products, as the TPU kernels do in q's
// dtype (attention_bwd.py:174, :192); S, dP and every sum stay f32.  At
// f32 nothing is rounded to bf16: P and dS stay f32 (the TPU kernels keep
// them in q's dtype, f32) and are split into bf16 pieces, as every f32
// operand is.
//
// What bounds it: per visible (row, key) pair H3-dkv runs four products of
// depth d (S, dP, dV, dK) and H3-dq three (S, dP, dQ), 14 d flops, against
// reading Q, K, V, dO once and writing dQ, dK, dV once.  At the flagship's
// training shape (B=8, Hq=8, Hkv=4, L=1024, d=128, causal) that is 60
// GFLOP against 84 MB: the tensor cores bound it, which only wgmma
// reaches.  At f32 each product is six bf16 piece products (bf16x6), so
// the bound is six times the bf16 one at 989 TFLOP/s, against 168 MB.
//
// Design (wgmma_tile.cuh, the block of H1): FlashAttention-2's split into
// two kernels with opposite loop orders and no atomics, so a result is
// bitwise reproducible.  A block is 384 threads: two consumer warpgroups
// and one producer warpgroup that hands its registers over (setmaxnreg 24
// / 240) and feeds a TMA + mbarrier ring.
// - H3-dkv: one block per (batch * KV head, 128 KV rows), the first KV
//   tiles (the longest under a causal mask) first.  K and V are resident;
//   the producer streams stages of (Q tile, dO tile) of 64 rows over the
//   group's q heads and, per head, the Q tiles some row of which sees the
//   block's keys; its second warp writes each stage's -lse * log2e and
//   delta (-inf and 0 past Lq).  Each consumer warpgroup owns 64 KV rows:
//   S^T = K Q^T and dP^T = V dO^T (wgmma, both operands in swizzled shared
//   memory, the Q / dO tile read K-major), then P^T and dS^T in registers
//   (lse and delta by column: the columns are q rows), packed into bf16 A
//   fragments for dV += P^T dO and dK += dS^T Q with the same tile read
//   MN-major.  dK and dV stay in f32 registers over the whole group, so
//   the GQA sum of attention_bwd.py:670-676 happens in f32 inside the
//   block.
// - H3-dq: one block per (batch * q head, 128 Q rows), the last Q tiles
//   (the longest under a causal mask) first.  Q and dO are resident; each
//   consumer warpgroup keeps its 64 rows' lse and delta in registers.  K/V
//   stream in 64-key tiles, four stages: S = Q K^T and dP = dO V^T (K-major
//   B), dS in registers, dQ += dS K (K read MN-major).  At d=128 Q and dO
//   take 64 KB, so 128-key stages would leave room for only two.
// Loop bounds come from the mask (all tiles; from or to the causal
// diagonal; both band edges, in 64 bits).  Interior tiles skip the mask's
// compares; edge tiles apply it by selects on the accumulator registers
// (a wgmma under a branch would serialize every wgmma of the function).
// TMA zero-fills rows past L in the 3-D descriptors, and the masks hide
// them.  Results leave the f32 registers as bf16 pairs.
//
// Budget at D=128.  H3-dkv: K and V 64 KB, four stages of Q and dO 128 KB,
// stats 2 KB; registers dK 64 + dV 64 + S^T 32 + dP^T 32 per consumer
// thread.  H3-dq: Q and dO 64 KB, four stages of K and V 128 KB; registers
// dQ 64 + S 32 + dP 32.  One block per SM.  D=64 and D=32 keep the layout
// in less memory; D=32's tiles are 32-column boxes (64-byte rows and
// swizzle) and its products m64n32k16, as H1's D=32 instance.
//
// D=256 splits columns, not rows (FlashAttention-3 runs d=256 on narrower
// tiles too).  The D=128 layout would need dK 128 + dV 128 registers a
// thread, past the 240 of setmaxnreg, and 128 KB of K and V beside four
// 64 KB stages, past the 227 KB of shared memory.  So a block holds 64
// rows (KV rows for H3-dkv, Q rows for H3-dq), and both consumer
// warpgroups work on all 64: warpgroup w owns columns [128 w, 128 w + 128)
// of dK and dV (of dQ), 64 + 64 (64) registers, as at D=128.  Each
// warpgroup computes S and dP of its 64 rows over the whole depth itself,
// so the pair of them is computed twice: 6 products of depth d a visible
// pair in H3-dkv instead of 4, 5 in H3-dq instead of 3, in exchange for no
// shared-memory handover of P and dS and no barrier between the
// warpgroups.  Shared memory, two stages: H3-dkv K and V 64 KB + Q and dO
// 2 x 64 KB; H3-dq Q and dO 64 KB + K and V 2 x 64 KB (192 KB each).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "f32_attention.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace eft::hopper;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int DKV_QT = 64;       // Q rows per H3-dkv stage
constexpr int DQ_KT = 64;        // keys per H3-dq stage
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
// 128 * 24 + 256 * 240 = 384 * 168, what the launch allocates
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// the mask argument of the C entries (as eft_prefill_attention's)
enum Mask : int { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

// The layout of instance D.  A tile of R rows is NBOX TMA boxes of [R][BOX]
// bf16 (rows of ROW bytes, swizzled at that width), box after box.  ROWS:
// the KV rows of an H3-dkv block and the Q rows of an H3-dq block.  SPLIT
// (D=256): both consumer warpgroups take the block's 64 rows and each owns
// N of the accumulators' D columns; else each owns 64 rows and all D.
template <int D>
struct Geo {
  static constexpr bool SPLIT = D == 256;
  static constexpr int ROWS = SPLIT ? 64 : 128;
  static constexpr int STAGES = SPLIT ? 2 : 4;     // ring depth
  static constexpr int N = SPLIT ? D / CONSUMERS : D;
  static constexpr int BOX = D >= 64 ? 64 : 32;    // bf16 columns of a box
  static constexpr int ROW = BOX * 2;              // bytes; = the swizzle
  static constexpr int NBOX = D / BOX;
  static_assert(N % BOX == 0, "a warpgroup's columns are whole boxes");
};

// Shared memory of an H3-dkv block
template <int D>
struct DkvTiles {
  using G = Geo<D>;
  static constexpr uint32_t KV_BYTES = G::ROWS * D * 2;
  static constexpr uint32_t QT_BYTES = DKV_QT * D * 2;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + KV_BYTES;
  static constexpr size_t q = v + KV_BYTES;                    // per stage
  static constexpr size_t dout = q + size_t(G::STAGES) * QT_BYTES;
  static constexpr size_t nlse = dout + size_t(G::STAGES) * QT_BYTES;
  static constexpr size_t delta = nlse + size_t(G::STAGES) * DKV_QT * 4;
  static constexpr size_t bars = delta + size_t(G::STAGES) * DKV_QT * 4;
  static constexpr size_t bytes = bars + 8 * (2 * G::STAGES + 1) + 1024;
  static_assert(bytes <= 232448, "the block's shared memory");
};

// Shared memory of an H3-dq block
template <int D>
struct DqTiles {
  using G = Geo<D>;
  static constexpr uint32_t Q_BYTES = G::ROWS * D * 2;
  static constexpr uint32_t KV_BYTES = DQ_KT * D * 2;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + Q_BYTES;
  static constexpr size_t k = dout + Q_BYTES;                  // per stage
  static constexpr size_t v = k + size_t(G::STAGES) * KV_BYTES;
  static constexpr size_t bars = v + size_t(G::STAGES) * KV_BYTES;
  static constexpr size_t bytes = bars + 8 * (2 * G::STAGES + 1) + 1024;
  static_assert(bytes <= 232448, "the block's shared memory");
};

__device__ __forceinline__ long long clamp64(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// -lse * log2e, the exp2 argument's offset; -inf for a row that sees no
// key (lse = -inf), so that its P is 0 instead of 2^inf
__device__ __forceinline__ float neg_lse2(float lse) {
  return lse == -CUDART_INF_F ? -CUDART_INF_F : -lse * LOG2E;
}

// the descriptor of k-step kk of a K-major operand: rows [row0, row0 + 64)
// of an R-row tile of instance D
template <int D, int R>
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile,
                                                int row0, int kk) {
  using G = Geo<D>;
  const int box = kk * 16 / G::BOX, off = (kk * 16 % G::BOX) * 2;
  return gmma_desc(tile + box * R * G::ROW + row0 * G::ROW + off, 16,
                   8 * G::ROW, G::ROW);
}

// the descriptor of k-step kk (rows 16 kk .. 16 kk + 15) of an R-row tile
// read MN-major: its columns are the product's N, box after box
template <int D, int R>
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile,
                                                 int kk) {
  using G = Geo<D>;
  return gmma_desc(tile + kk * 16 * G::ROW, R * G::ROW, 8 * G::ROW, G::ROW);
}

// acc[64 x 64] = A B^T over k = D: A rows [a_row0, a_row0 + 64) of an
// RA-row tile, B the first 64 rows of an RB-row tile, both K-major (issued,
// not waited for)
template <int D, int RA, int RB>
__device__ __forceinline__ void issue_abt(float (&acc)[32],
                                          const unsigned char* a, int a_row0,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = kmajor_desc<D, RA>(a, a_row0, kk);
    const uint64_t db = kmajor_desc<D, RB>(b, 0, kk);
    if (kk == 0) wgmma_ss_bf16_n64_first(acc, da, db);
    else wgmma_ss_bf16_n64(acc, da, db, 1);
  }
}

// acc[64 x N] += A[64 x 64] B[64 x N]: A the bf16 fragment of a packed
// 64 x 64 accumulator (16 registers), B the N columns at b of a 64-row tile
// read MN-major (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[Geo<D>::N / 2],
                                          const uint32_t (&a)[16],
                                          const unsigned char* b) {
  constexpr int N = Geo<D>::N;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mnmajor_desc<D, 64>(b, kk);
    if constexpr (N == 128)
      wgmma_rs_bf16_n128(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                         a[4 * kk + 3], db, 1);
    else if constexpr (N == 64)
      wgmma_rs_bf16_n64(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                        a[4 * kk + 3], db, 1);
    else
      wgmma_rs_bf16_n32(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                        a[4 * kk + 3], db, 1);
  }
}

// a 64 x 64 f32 accumulator packed into its bf16 A fragment
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = pack_bf16x2(x[2 * j], x[2 * j + 1]);
}

// The two rows this thread owns of an m64nN f32 accumulator (row0 and
// row0 + 8) as bf16 at dst + row * ld + col, those below n_rows; only the
// first ncols columns (a multiple of 8)
template <int N>
__device__ __forceinline__ void store_rows(const float (&acc)[N / 2],
                                           int row0, int n_rows, bf16* dst,
                                           int ld, int col, int ncols) {
  const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    bf16* out = dst + size_t(row) * ld + col;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (8 * j < ncols)
        *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col0) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// A warpgroup's share of a [rows, d] result: its N columns from col (0, or
// N times the warpgroup under SPLIT), the first d of each row.  At d = D
// the store is inlined apart with constant strides, as H1's epilogue
template <int D>
__device__ __forceinline__ void store_result(const float (&acc)[Geo<D>::N / 2],
                                             int row0, int n_rows, bf16* dst,
                                             int d, int col) {
  constexpr int N = Geo<D>::N;
  if (d == D)
    store_rows<N>(acc, row0, n_rows, dst, D, col, N);
  else
    store_rows<N>(acc, row0, n_rows, dst, d, col, min(N, d - col));
}

// ---------------------------------------------------------------- H3-dkv

// P^T and dS^T of one stage in place of S^T and dP^T: element e of this
// thread is key row r = acc_row8(e) / 8 of its two and q row q0 + its
// column.  nlse / delta are the stage's per-q-row values; [lo[r], hi[r]]
// are the q rows key row r is seen by (empty past Lkv).
__device__ __forceinline__ void dkv_p_ds(float (&s)[32], float (&dp)[32],
                                         const float* nlse,
                                         const float* delta, bool whole,
                                         int q0, const int (&lo)[2],
                                         const int (&hi)[2],
                                         float scale_log2, float scale) {
  const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + col0;
    const float2 nl = *reinterpret_cast<const float2*>(nlse + c);
    const float2 dl = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
    for (int e = 4 * j; e < 4 * j + 4; ++e) {
      const int r = acc_row8(e) / 8;
      const float n = (e & 1) ? nl.y : nl.x;
      const float dd = (e & 1) ? dl.y : dl.x;
      float p = exp2_approx(fmaf(s[e], scale_log2, n));
      if (!whole) {
        const int i = q0 + c + (e & 1);
        p = i >= lo[r] && i <= hi[r] ? p : 0.f;
      }
      s[e] = p;
      dp[e] = p * (dp[e] - dd) * scale;
    }
  }
}

template <int D>
__device__ __forceinline__ void consume_dkv(
    const unsigned char* sk, const unsigned char* sv, const unsigned char* sq,
    const unsigned char* sdo, const float* snl, const float* sdl,
    uint64_t* full, uint64_t* empty, uint64_t* kv_full, bf16* dk, bf16* dv,
    int lq, int lkv, int d, int mask, int diag_off, int window, float scale,
    int kv0, int q_begin, int n_qt, int n_stages) {
  using G = Geo<D>;
  using T = DkvTiles<D>;
  constexpr int STAGES = G::STAGES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  // this warpgroup's 64 KV rows in the block, and its first column
  const int wg_row = G::SPLIT ? 0 : wg * 64;
  const int col = G::SPLIT ? wg * G::N : 0;
  const int kv_wg0 = kv0 + wg_row;
  const int row0 = kv_wg0 + (warp % 4) * 16 + lane / 4;
  const float scale_log2 = scale * LOG2E;
  // the q rows [lo, hi] that see each owned key row
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long j = row0 + 8 * r;
    lo[r] = 0;
    hi[r] = lq - 1;
    if (j >= lkv) {
      lo[r] = 1;
      hi[r] = 0;
    } else if (mask != MASK_NONE) {
      lo[r] = int(clamp64(j - diag_off, 0, lq));
      if (mask == MASK_WINDOW)
        hi[r] = int(clamp64(j - diag_off + window - 1, -1, lq - 1));
    }
  }
  // a stage is whole (every q row of it sees every key row of this
  // warpgroup) when it ends inside Lq, the keys inside Lkv, and under a
  // mask the last key is at or left of the first row's diagonal and the
  // first key inside the last row's window
  const long long first_key = kv_wg0, last_key = kv_wg0 + 63;
  auto is_whole = [&](int q0) {
    bool whole = q0 + DKV_QT <= lq && kv_wg0 + 64 <= lkv;
    if (mask != MASK_NONE)
      whole = whole && last_key <= (long long)q0 + diag_off;
    if (mask == MASK_WINDOW)
      whole = whole && first_key >= (long long)q0 + DKV_QT - 1 + diag_off
                                        - window + 1;
    return whole;
  };

  // the warpgroup's columns of a Q / dO stage (whole boxes of 64 rows)
  const int col_bytes = col / G::BOX * DKV_QT * G::ROW;
  float acc_dk[G::N / 2], acc_dv[G::N / 2];
#pragma unroll
  for (int i = 0; i < G::N / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  if (n_stages > 0) {
    mbar_wait(kv_full, 0);
    for (int i = 0; i < n_stages; ++i) {
      const int s = i % STAGES;
      const int q0 = q_begin + (i % n_qt) * DKV_QT;
      const unsigned char* q_s = sq + s * T::QT_BYTES;
      const unsigned char* do_s = sdo + s * T::QT_BYTES;
      float acc_s[32], acc_dp[32];
      uint32_t pa[16], dsa[16];
      mbar_wait(&full[s], (i / STAGES) & 1);
      wgmma_fence();
      issue_abt<D, G::ROWS, DKV_QT>(acc_s, sk, wg_row, q_s);     // S^T
      issue_abt<D, G::ROWS, DKV_QT>(acc_dp, sv, wg_row, do_s);   // dP^T
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);
      fence_regs(acc_dp);
      dkv_p_ds(acc_s, acc_dp, snl + s * DKV_QT, sdl + s * DKV_QT,
               is_whole(q0), q0, lo, hi, scale_log2, scale);
      pack_a(acc_s, pa);
      pack_a(acc_dp, dsa);
      fence_regs(pa);
      fence_regs(dsa);
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      wgmma_fence();
      issue_acc<D>(acc_dv, pa, do_s + col_bytes);                // P^T dO
      issue_acc<D>(acc_dk, dsa, q_s + col_bytes);                // dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(&empty[s]);
    }
  }
  store_result<D>(acc_dk, row0, lkv, dk, d, col);
  store_result<D>(acc_dv, row0, lkv, dv, d, col);
}

template <int D, bool EXACT>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,   // [B*Hq, Lq, d]
                         const __grid_constant__ CUtensorMap tdo,  // [B*Hq, Lq, d]
                         const __grid_constant__ CUtensorMap tk,   // [B*Hkv, Lkv, d]
                         const __grid_constant__ CUtensorMap tv,   // [B*Hkv, Lkv, d]
                         const float* __restrict__ lse,    // [B, Hq, Lq]
                         const float* __restrict__ delta,  // [B, Hq, Lq]
                         bf16* __restrict__ dk,            // [B, Hkv, Lkv, d]
                         bf16* __restrict__ dv,            // [B, Hkv, Lkv, d]
                         int hq, int hkv, int lq, int lkv, int d, int mask,
                         int diag_off, int window,
                         const int* __restrict__ offs,  // (q_pos0, kv_pos0) or null
                         float scale) {
  using G = Geo<D>;
  using T = DkvTiles<D>;
  constexpr int STAGES = G::STAGES, ROWS = G::ROWS;
  if constexpr (EXACT) d = D;           // a constant, as before the d rule
  if (offs != nullptr) diag_off = offs[0] - offs[1];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sk = smem + T::k;
  unsigned char* sv = smem + T::v;
  unsigned char* sq = smem + T::q;
  unsigned char* sdo = smem + T::dout;
  float* snl = reinterpret_cast<float*>(smem + T::nlse);
  float* sdl = reinterpret_cast<float*>(smem + T::delta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* kv_full = empty + STAGES;

  const int bhk = blockIdx.x;                   // b * hkv + KV head
  const int kv0 = blockIdx.y * ROWS;            // the first tiles first
  const int b = bhk / hkv;
  const int group = hq / hkv;
  const int h0 = (bhk % hkv) * group;           // first q head of the group
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the Q tiles [q_begin, q_end) some row of which sees a key of this
  // block: from the first key's causal row, to the last key's window edge
  long long q_first = 0, q_end = lq;
  if (mask != MASK_NONE) q_first = clamp64((long long)kv0 - diag_off, 0, lq);
  if (mask == MASK_WINDOW) {
    const long long kv_last = min(kv0 + ROWS, lkv) - 1;
    q_end = clamp64(kv_last - diag_off + window, 0, lq);
  }
  const int q_begin = int(q_first) / DKV_QT * DKV_QT;
  const int n_qt = q_end > q_begin
                       ? (int(q_end) - q_begin + DKV_QT - 1) / DKV_QT : 0;
  const int n_stages = n_qt * group;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);      // the TMA thread, the stats warp
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_init(kv_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0 && n_stages > 0) {
      // K and V once, then (Q, dO) stage by stage: head g of the group,
      // Q tile q0
      mbar_arrive_expect_tx(kv_full, 2 * T::KV_BYTES);
      for (int x = 0; x < G::NBOX; ++x) {
        tma_load_3d(sk + x * ROWS * G::ROW, &tk, kv_full, x * G::BOX, kv0,
                    bhk);
        tma_load_3d(sv + x * ROWS * G::ROW, &tv, kv_full, x * G::BOX, kv0,
                    bhk);
      }
      for (int i = 0; i < n_stages; ++i) {
        const int s = i % STAGES;
        const int bh = b * hq + h0 + i / n_qt;
        const int q0 = q_begin + (i % n_qt) * DKV_QT;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::QT_BYTES);
        for (int x = 0; x < G::NBOX; ++x) {
          tma_load_3d(sq + s * T::QT_BYTES + x * DKV_QT * G::ROW, &tq,
                      &full[s], x * G::BOX, q0, bh);
          tma_load_3d(sdo + s * T::QT_BYTES + x * DKV_QT * G::ROW, &tdo,
                      &full[s], x * G::BOX, q0, bh);
        }
      }
    } else if (warp == CONSUMERS * 4 + 1 && n_stages > 0) {
      // the stats warp: -lse * log2e and delta of each stage's q rows
      for (int i = 0; i < n_stages; ++i) {
        const int s = i % STAGES;
        const size_t bh = size_t(b) * hq + h0 + i / n_qt;
        const int q0 = q_begin + (i % n_qt) * DKV_QT;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        for (int c = lane; c < DKV_QT; c += 32) {
          const bool in = q0 + c < lq;
          const size_t at = bh * lq + q0 + c;
          snl[s * DKV_QT + c] = in ? neg_lse2(lse[at]) : -CUDART_INF_F;
          sdl[s * DKV_QT + c] = in ? delta[at] : 0.f;
        }
        mbar_arrive(&full[s]);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const size_t out = size_t(bhk) * lkv * d;
    consume_dkv<D>(sk, sv, sq, sdo, snl, sdl, full, empty, kv_full,
                   dk + out, dv + out, lq, lkv, d, mask, diag_off, window,
                   scale, kv0, q_begin, n_qt, n_stages);
  }
}

// ----------------------------------------------------------------- H3-dq

// dS of one K/V tile in place of dP (S becomes P): element e of this
// thread is row r = acc_row8(e) / 8 of its two and key kv0 + its column;
// [lo[r], hi[r]] are the keys row r sees
__device__ __forceinline__ void dq_p_ds(float (&s)[32], float (&dp)[32],
                                        const float (&nl)[2],
                                        const float (&dl)[2], bool whole,
                                        int kv0, const int (&lo)[2],
                                        const int (&hi)[2], float scale_log2,
                                        float scale) {
  const int col0 = kv0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int r = acc_row8(e) / 8;
    float p = exp2_approx(fmaf(s[e], scale_log2, nl[r]));
    if (!whole) {
      const int j = col0 + acc_col(e);
      p = j >= lo[r] && j <= hi[r] ? p : 0.f;
    }
    s[e] = p;
    dp[e] = p * (dp[e] - dl[r]) * scale;
  }
}

template <int D>
__device__ __forceinline__ void consume_dq(
    const unsigned char* sq, const unsigned char* sdo, const unsigned char* sk,
    const unsigned char* sv, uint64_t* full, uint64_t* empty,
    uint64_t* q_full, const float* lse, const float* delta, bf16* dq,
    int lq, int lkv, int d, int mask, int diag_off, int window, float scale,
    int q0, int kv_begin, int n_tiles) {
  using G = Geo<D>;
  using T = DqTiles<D>;
  constexpr int STAGES = G::STAGES;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  // this warpgroup's 64 Q rows in the block, and its first column
  const int wg_row = G::SPLIT ? 0 : wg * 64;
  const int col = G::SPLIT ? wg * G::N : 0;
  const int q_wg0 = q0 + wg_row;
  const int row0 = q_wg0 + (warp % 4) * 16 + lane / 4;
  const float scale_log2 = scale * LOG2E;
  // each owned row's -lse * log2e and delta (-inf and 0 past Lq) and the
  // keys [lo, hi] it sees
  float nl[2], dl[2];
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    nl[r] = i < lq ? neg_lse2(lse[i]) : -CUDART_INF_F;
    dl[r] = i < lq ? delta[i] : 0.f;
    lo[r] = 0;
    hi[r] = lkv - 1;
    if (mask != MASK_NONE) {
      const long long last = (long long)i + diag_off;
      hi[r] = int(clamp64(last, -1, lkv - 1));
      if (mask == MASK_WINDOW)
        lo[r] = int(clamp64(last - window + 1, 0, lkv));
    }
  }
  // a tile is whole (no key of it is hidden from a row of this warpgroup)
  // when it ends inside Lkv and, under a mask, inside the first row's
  // band and past the last row's window edge
  const long long wg_first = (long long)q_wg0 + diag_off;
  const long long wg_last = wg_first + 63;
  auto is_whole = [&](int kv0) {
    bool whole = kv0 + DQ_KT <= lkv;
    if (mask != MASK_NONE) whole = whole && kv0 + DQ_KT - 1 <= wg_first;
    if (mask == MASK_WINDOW) whole = whole && kv0 >= wg_last - window + 1;
    return whole;
  };

  // the warpgroup's columns of a K stage (whole boxes of 64 keys)
  const int col_bytes = col / G::BOX * DQ_KT * G::ROW;
  float acc_dq[G::N / 2];
#pragma unroll
  for (int i = 0; i < G::N / 2; ++i) acc_dq[i] = 0.f;

  if (n_tiles > 0) {
    mbar_wait(q_full, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % STAGES;
      const int kv0 = kv_begin + i * DQ_KT;
      const unsigned char* k_s = sk + s * T::KV_BYTES;
      const unsigned char* v_s = sv + s * T::KV_BYTES;
      float acc_s[32], acc_dp[32];
      uint32_t dsa[16];
      mbar_wait(&full[s], (i / STAGES) & 1);
      wgmma_fence();
      issue_abt<D, G::ROWS, DQ_KT>(acc_s, sq, wg_row, k_s);      // S
      issue_abt<D, G::ROWS, DQ_KT>(acc_dp, sdo, wg_row, v_s);    // dP
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);
      fence_regs(acc_dp);
      dq_p_ds(acc_s, acc_dp, nl, dl, is_whole(kv0), kv0, lo, hi, scale_log2,
              scale);
      pack_a(acc_dp, dsa);
      fence_regs(dsa);
      fence_regs(acc_dq);
      wgmma_fence();
      issue_acc<D>(acc_dq, dsa, k_s + col_bytes);                // dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dq);
      fence_regs(dsa);
      mbar_arrive(&empty[s]);
    }
  }
  store_result<D>(acc_dq, row0, lq, dq, d, col);
}

template <int D, bool EXACT>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,    // [B*Hq, Lq, d]
                        const __grid_constant__ CUtensorMap tdo,   // [B*Hq, Lq, d]
                        const __grid_constant__ CUtensorMap tk,    // [B*Hkv, Lkv, d]
                        const __grid_constant__ CUtensorMap tv,    // [B*Hkv, Lkv, d]
                        const float* __restrict__ lse,     // [B, Hq, Lq]
                        const float* __restrict__ delta,   // [B, Hq, Lq]
                        bf16* __restrict__ dq,             // [B, Hq, Lq, d]
                        int hq, int group, int lq, int lkv, int d, int mask,
                        int diag_off, int window,
                        const int* __restrict__ offs,  // (q_pos0, kv_pos0) or null
                        float scale) {
  using G = Geo<D>;
  using T = DqTiles<D>;
  constexpr int STAGES = G::STAGES, ROWS = G::ROWS;
  if constexpr (EXACT) d = D;           // a constant, as before the d rule
  if (offs != nullptr) diag_off = offs[0] - offs[1];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sq = smem + T::q;
  unsigned char* sdo = smem + T::dout;
  unsigned char* sk = smem + T::k;
  unsigned char* sv = smem + T::v;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* empty = full + STAGES;
  uint64_t* q_full = empty + STAGES;

  const int bh = blockIdx.x;
  const int b = bh / hq;
  const int bhk = b * (hq / group) + (bh % hq) / group;   // GQA KV head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;     // longest first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the K/V tiles [kv_begin, kv_end) some row of this block sees: the
  // last row's causal limit ends them, the first row's window edge starts
  // them (rounded down to a tile)
  int kv_begin = 0, kv_end = lkv;
  if (mask != MASK_NONE) {
    const long long q_last = min(q0 + ROWS, lq) - 1;
    kv_end = int(clamp64(q_last + diag_off + 1, 0, lkv));
  }
  if (mask == MASK_WINDOW)
    kv_begin = int(clamp64((long long)q0 + diag_off - window + 1, 0, lkv))
               / DQ_KT * DQ_KT;
  const int n_tiles = kv_end > kv_begin
                          ? (kv_end - kv_begin + DQ_KT - 1) / DQ_KT : 0;

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
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS * 4 && lane == 0 && n_tiles > 0) {
      mbar_arrive_expect_tx(q_full, 2 * T::Q_BYTES);
      for (int x = 0; x < G::NBOX; ++x) {
        tma_load_3d(sq + x * ROWS * G::ROW, &tq, q_full, x * G::BOX, q0, bh);
        tma_load_3d(sdo + x * ROWS * G::ROW, &tdo, q_full, x * G::BOX, q0,
                    bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int kv0 = kv_begin + i * DQ_KT;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::KV_BYTES);
        for (int x = 0; x < G::NBOX; ++x) {
          tma_load_3d(sk + s * T::KV_BYTES + x * DQ_KT * G::ROW, &tk,
                      &full[s], x * G::BOX, kv0, bhk);
          tma_load_3d(sv + s * T::KV_BYTES + x * DQ_KT * G::ROW, &tv,
                      &full[s], x * G::BOX, kv0, bhk);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const size_t rows = size_t(bh) * lq;
    consume_dq<D>(sq, sdo, sk, sv, full, empty, q_full, lse + rows,
                  delta + rows, dq + rows * d, lq, lkv, d, mask, diag_off,
                  window, scale, q0, kv_begin, n_tiles);
  }
}

// the four TMA descriptors of a launch: Q and dO boxes of q_rows rows, K
// and V boxes of kv_rows rows, of instance D's box width and swizzle, over
// the true d (TMA zero-fills the columns past it)
template <int D>
int make_maps(CUtensorMap (&m)[4], const void* q, const void* dout,
              const void* k, const void* v, int batch, int hq, int hkv,
              int lq, int lkv, int d, int q_rows, int kv_rows) {
  using G = Geo<D>;
  int err = make_tmap(&m[0], q, 2, d, lq, batch * hq, G::BOX, q_rows, G::ROW);
  if (!err)
    err = make_tmap(&m[1], dout, 2, d, lq, batch * hq, G::BOX, q_rows, G::ROW);
  if (!err)
    err = make_tmap(&m[2], k, 2, d, lkv, batch * hkv, G::BOX, kv_rows, G::ROW);
  if (!err)
    err = make_tmap(&m[3], v, 2, d, lkv, batch * hkv, G::BOX, kv_rows, G::ROW);
  return err;
}

template <int D, bool EXACT>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int batch, int hq, int hkv, int lq, int lkv, int d, int mask,
               int diag_off, int window, const int* offs, float scale,
               cudaStream_t stream) {
  using T = DkvTiles<D>;
  constexpr int ROWS = Geo<D>::ROWS;
  if ((lkv + ROWS - 1) / ROWS > 65535) return int(cudaErrorInvalidValue);
  CUtensorMap m[4];
  const int err = make_maps<D>(m, q, dout, k, v, batch, hq, hkv, lq, lkv, d,
                               DKV_QT, ROWS);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_dkv_kernel<D, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(batch * hkv, (lkv + ROWS - 1) / ROWS);
  attention_bwd_dkv_kernel<D, EXACT><<<grid, THREADS, T::bytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), hq, hkv, lq, lkv, d, mask, diag_off, window,
      offs, scale);
  return int(cudaGetLastError());
}

template <int D, bool EXACT>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int batch,
              int hq, int hkv, int lq, int lkv, int d, int mask,
              int diag_off, int window, const int* offs, float scale,
              cudaStream_t stream) {
  using T = DqTiles<D>;
  constexpr int ROWS = Geo<D>::ROWS;
  if ((lq + ROWS - 1) / ROWS > 65535) return int(cudaErrorInvalidValue);
  CUtensorMap m[4];
  const int err = make_maps<D>(m, q, dout, k, v, batch, hq, hkv, lq, lkv, d,
                               ROWS, DQ_KT);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<D, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(batch * hq, (lq + ROWS - 1) / ROWS);
  attention_bwd_dq_kernel<D, EXACT><<<grid, THREADS, T::bytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), hq, hq / hkv,
      lq, lkv, d, mask, diag_off, window, offs, scale);
  return int(cudaGetLastError());
}

// ------------------------------------------------------------ f32 inputs
// H3-dkv and H3-dq at f32 q, k, v and dO: the same gradients, masks, GQA
// sums and traced offsets as the kernels above, f32 dK, dV and dQ, on the
// arithmetic of the f32 core (f32_attention.cuh): Mosaic's HIGHEST, which
// the TPU kernels ask for on every f32 product (ops/attention_v1.py:202-210
// dot_precision, used at ops/attention_bwd.py:70, 178, 184, 196, 264,
// 273).  Every f32 operand is split exactly into three bf16 pieces (hi,
// mid, lo) and each product is the sum of the six piece products, smallest
// first, in one f32 wgmma accumulator (bf16x6): S^T = K Q^T, dP^T = V dO^T,
// dV += P^T dO and dK += dS^T Q in H3-dkv; S, dP and dQ += dS K in H3-dq.
// P and dS stay f32 (the TPU kernels keep them in q's dtype): each is split
// into three A fragments in registers (RS wgmma), as the f32 core splits
// P for P V.  P = exp2f(s * scale * log2e - lse * log2e), not the
// special-function unit's approximation.
//
// Budget: three pieces triple every tile, so the bf16 layout (128 resident
// rows beside four 64-row stages, 192 KB of K and V pieces alone at
// D=128) does not fit.  A block is one consumer warpgroup over 64 resident
// rows (K and V in H3-dkv, Q and dO in H3-dq: their pieces, 96 KB at
// D=128) and one producer warpgroup, 256 threads, two stages of 32
// streamed rows (Q and dO; K and V: 48 KB a stage at D=128): 192 KB, the
// f32 core's.  The consumer splits its resident rows itself before its
// loop; the producer reads each stage's f32 rows into registers, waits for
// the stage to be free and stores their pieces in the swizzled layout a
// TMA load of a bf16 tile would give (put_split8), with H3-dkv's per-row
// -lse * log2e and delta.  Each stage's share of dK, dV (dQ) is summed in a
// fresh wgmma accumulator and added to the running sums in f32
// (issue_part_f32).  Registers of a consumer thread at D=128: dK 64 + dV 64
// + a stage's share 64, S^T 16 + dP^T 16, the pieces of P^T, then of dS^T,
// 24 (no setmaxnreg: 256 threads may hold 255 each).  Instances D = 64
// (d 16-64) and 128 (d 80-128).
//
// D = 256 (d 144-256) is a cluster of two such blocks that split the
// columns (wgmma_tile.cuh's cluster helpers).  One block would not fit:
// the pieces of its 64 resident rows take 192 KB, the smallest stage (16
// rows of Q and dO pieces) 48 KB more, past the 227 KB of shared memory,
// and dK and dV over 256 columns 128 + 128 registers a thread.  Block c of
// a cluster holds columns [128 c, 128 c + 128) of every tile, resident and
// streamed, and runs the D=128 block's layout and loop on them: both walk
// the same stages.  S^T and dP^T (S and dP) are sums over the depth, so
// each block computes its 128 columns' partial (bf16x6, a fresh
// accumulator) and the two are added in f32 through distributed shared
// memory: each thread stores its 16 + 16 values into the peer's exchange
// buffer, arrives on the peer's barrier, waits for the peer's arrivals on
// its own and adds.  f32 addition of two terms is commutative, so both
// blocks hold bitwise the same S and dP, and so the same P and dS; then
// each runs the loop body on its own columns of dV, dK (dQ) and stores
// them.  No product is computed twice.  Shared memory per block: resident
// pieces 96 KB, two stages 96 KB, two exchange buffers of 16 KB (the peer
// writes stage i's partials into buffer i % 2, so a thread's wait of stage
// i + 1 already follows the peer's reads of stage i - 1's buffer, and one
// arrival a stage hands a buffer over both ways): 225.5 KB with the
// statistics and barriers.  The grid is (2 B Hkv, KV tiles) for H3-dkv
// and (2 B Hq, Q tiles) for H3-dq, a cluster two neighbouring blocks of x.

namespace F = eft::f32;

constexpr int F32_ROWS = 64;      // resident rows: one consumer warpgroup
constexpr int F32_STREAM = 32;    // rows of a streamed tile (Q/dO or K/V)
constexpr int F32_STAGES = 2;
constexpr int F32_THREADS = 256;  // a consumer and a producer warpgroup
constexpr int F32_BAR = 1;        // the consumer warpgroup's named barrier

// Shared memory of an f32 block of instance D: the three pieces of each of
// the two resident 64-row tiles, then F32_STAGES stages of the three pieces
// of each of the two streamed 32-row tiles, the stages' per-row statistics
// (H3-dkv's -lse * log2e and delta), at D=256 the two exchange buffers of
// the peer's S^T and dP^T partials (S and dP), the barriers.  A block
// holds W of the D columns; a piece is W / 64 boxes of [rows][64] bf16,
// 128-byte rows and swizzle (Geo<W>'s layout).
template <int D>
struct F32Tiles {
  static_assert(D == 64 || D == 128 || D == 256, "an f32 instance of H3");
  static constexpr int CLUSTER = D == 256 ? 2 : 1;    // blocks of a cluster
  static constexpr int W = D / CLUSTER;               // columns of a block
  static constexpr int XBUFS = CLUSTER > 1 ? 2 : 0;   // exchange buffers
  static constexpr uint32_t RES_PIECE = F32_ROWS * W * 2;
  static constexpr uint32_t STR_PIECE = F32_STREAM * W * 2;
  static constexpr uint32_t STAGE = 6 * STR_PIECE;
  static constexpr uint32_t XBUF = 2 * F32_ROWS * F32_STREAM * 4;
  static constexpr size_t res = 0;
  static constexpr size_t str = res + 6 * size_t(RES_PIECE);
  static constexpr size_t stats = str + F32_STAGES * size_t(STAGE);
  static constexpr size_t xchg = stats + F32_STAGES * 2 * F32_STREAM * 4;
  static constexpr size_t bars = xchg + XBUFS * size_t(XBUF);
  static constexpr size_t bytes = bars + 8 * (2 * F32_STAGES + XBUFS) + 1024;
  static_assert(bytes <= 232448, "the block's shared memory");
};

// Rows [row0, row0 + R) of an f32 [*, d] matrix, its columns [c0, c0 + D)
// (zero past n_rows and d), as three pieces at tile, stored by the 128
// threads of a warpgroup (t: a thread's index in it)
template <int D, int R>
__device__ __forceinline__ void put_f32_rows(unsigned char* tile,
                                             const float* src, int row0,
                                             int n_rows, int d, int c0,
                                             int t) {
  for (int x = t; x < R * (D / 8); x += 128) {
    const int r = x / (D / 8), ch = x % (D / 8);
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (row0 + r < n_rows && c0 + 8 * ch < d) {
      const float* at = src + size_t(row0 + r) * d + c0 + 8 * ch;
      x0 = *reinterpret_cast<const float4*>(at);
      x1 = *reinterpret_cast<const float4*>(at + 4);
    }
    F::put_split8(tile, R * D * 2, R, r, ch, x0, x1);
  }
}

// A producer thread's share of one stage: 8-float chunks of two streamed
// 32-row tiles
template <int D>
struct F32Stream {
  static constexpr int CH = F32_STREAM * (D / 8) / 128;
  float4 a[CH][2], b[CH][2];
};

// rows [row0, row0 + 32), columns [c0, c0 + D) of a and b ([*, d] each,
// zero past n_rows and d) into producer thread t's registers
template <int D>
__device__ __forceinline__ void fetch_stream(F32Stream<D>& x, const float* a,
                                             const float* b, int row0,
                                             int n_rows, int d, int c0,
                                             int t) {
#pragma unroll
  for (int c = 0; c < F32Stream<D>::CH; ++c) {
    const int e = t + 128 * c, r = e / (D / 8), ch = e % (D / 8);
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    x.a[c][0] = x.a[c][1] = x.b[c][0] = x.b[c][1] = z;
    if (row0 + r < n_rows && c0 + 8 * ch < d) {
      const size_t at = size_t(row0 + r) * d + c0 + 8 * ch;
      x.a[c][0] = *reinterpret_cast<const float4*>(a + at);
      x.a[c][1] = *reinterpret_cast<const float4*>(a + at + 4);
      x.b[c][0] = *reinterpret_cast<const float4*>(b + at);
      x.b[c][1] = *reinterpret_cast<const float4*>(b + at + 4);
    }
  }
}

// ... and their pieces into a stage's tiles sa and sb
template <int D>
__device__ __forceinline__ void put_stream(const F32Stream<D>& x,
                                           unsigned char* sa,
                                           unsigned char* sb, int t) {
  constexpr uint32_t PIECE = F32Tiles<D>::STR_PIECE;
#pragma unroll
  for (int c = 0; c < F32Stream<D>::CH; ++c) {
    const int e = t + 128 * c, r = e / (D / 8), ch = e % (D / 8);
    F::put_split8(sa, PIECE, F32_STREAM, r, ch, x.a[c][0], x.a[c][1]);
    F::put_split8(sb, PIECE, F32_STREAM, r, ch, x.b[c][0], x.b[c][1]);
  }
}

// acc[64 x 32] += A B^T over k = D: the six piece products of A (a
// resident tile's pieces) and B (a stage tile's), both K-major, smallest
// first (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_abt_f32(float (&acc)[16],
                                              const unsigned char* a,
                                              const unsigned char* b) {
  using T = F32Tiles<D>;
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const unsigned char* ap = a + F::piece_a<6>(t) * T::RES_PIECE;
    const unsigned char* bp = b + F::piece_b<6>(t) * T::STR_PIECE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      F::wgmma_ss_bf16_n32(acc, kmajor_desc<D, F32_ROWS>(ap, 0, kk),
                           kmajor_desc<D, F32_STREAM>(bp, 0, kk));
  }
}

// part[64 x D] = A[64 x 32] B[32 x D]: A the three pieces (8 registers
// each) of a 64 x 32 accumulator's bf16 A fragments, B a stage tile's
// pieces read MN-major; the six piece products, smallest first, into a
// fresh accumulator (the first with scale-d 0; issued, not waited for).
// The caller adds part to its running sum with f32 adds: the tensor core
// drops the bits of each added product below the accumulator's last, so a
// sum over hundreds of stages inside one wgmma accumulator drifts (an H100
// read 8.9e-5 of max|dV| over the 16,000 rows of a group of 16 that way)
template <int D>
__device__ __forceinline__ void issue_part_f32(float (&part)[D / 2],
                                               const uint32_t (&a)[24],
                                               const unsigned char* b) {
#pragma unroll
  for (int t = 0; t < 6; ++t) {
    const uint32_t* ap = a + 8 * F::piece_a<6>(t);
    const unsigned char* bp = b + F::piece_b<6>(t) * F32Tiles<D>::STR_PIECE;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const uint64_t db = mnmajor_desc<D, F32_STREAM>(bp, kk);
      const int acc = t > 0 || kk > 0;
      if constexpr (D == 128)
        wgmma_rs_bf16_n128(part, ap[4 * kk], ap[4 * kk + 1], ap[4 * kk + 2],
                           ap[4 * kk + 3], db, acc);
      else
        wgmma_rs_bf16_n64(part, ap[4 * kk], ap[4 * kk + 1], ap[4 * kk + 2],
                          ap[4 * kk + 3], db, acc);
    }
  }
}

// sum += part (this stage's share, f32 adds) once part's products are in
template <int N>
__device__ __forceinline__ void add_part(float (&sum)[N],
                                         float (&part)[N]) {
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] += part[i];
}

// a 64 x 32 f32 accumulator as the three bf16 pieces of its A fragments
// (piece p at a[8 p])
__device__ __forceinline__ void split_a(const float (&x)[16],
                                        uint32_t (&a)[24]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint32_t w[3];
    F::split3x2(x[2 * j], x[2 * j + 1], w);
#pragma unroll
    for (int p = 0; p < 3; ++p) a[8 * p + j] = w[p];
  }
}

// The two rows this thread owns of an m64nN f32 accumulator (row0 and
// row0 + 8) as columns [c0, c0 + N) of dst's rows of d, those below n_rows,
// the columns below d
template <int N>
__device__ __forceinline__ void store_rows_f32(const float (&acc)[N / 2],
                                               int row0, int n_rows,
                                               float* dst, int d, int c0) {
  const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    float* out = dst + size_t(row) * d + c0;
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      if (c0 + 8 * j < d)
        *reinterpret_cast<float2*>(out + 8 * j + col0) =
            make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
}

// S and dP of stage i in a cluster of two (F32Tiles<256>): this block's
// partials over its columns plus its peer's, the same f32 sums in both.
// Each thread stores its 16 + 16 values into the peer's exchange buffer i
// % 2 (16-byte chunk c of thread t at (128 c + t) * 16 bytes: consecutive
// threads, consecutive chunks), arrives on the peer's barrier of that
// buffer, waits for the peer's 128 arrivals on its own and adds what the
// peer stored.  A thread writes a buffer again two stages later, after its
// wait of the stage between, which the peer's same thread reached after
// reading it.
__device__ __forceinline__ void exchange_f32(float (&s)[16], float (&dp)[16],
                                             unsigned char* xchg,
                                             uint64_t* xbar, int i) {
  using T = F32Tiles<256>;
  const int t = threadIdx.x % 128;
  const uint32_t peer = cluster_rank() ^ 1;
  float4* mine = reinterpret_cast<float4*>(xchg + (i % 2) * T::XBUF);
  const uint32_t theirs = peer_smem(mine, peer);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    st_peer_v4(theirs + (128 * c + t) * 16,
               make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2],
                           s[4 * c + 3]));
    st_peer_v4(theirs + (128 * (4 + c) + t) * 16,
               make_float4(dp[4 * c], dp[4 * c + 1], dp[4 * c + 2],
                           dp[4 * c + 3]));
  }
  mbar_arrive_peer(peer_smem(&xbar[i % 2], peer));
  mbar_wait_cluster(&xbar[i % 2], (i / 2) & 1);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 a = mine[128 * c + t], b = mine[128 * (4 + c) + t];
    s[4 * c] += a.x;
    s[4 * c + 1] += a.y;
    s[4 * c + 2] += a.z;
    s[4 * c + 3] += a.w;
    dp[4 * c] += b.x;
    dp[4 * c + 1] += b.y;
    dp[4 * c + 2] += b.z;
    dp[4 * c + 3] += b.w;
  }
}

// P^T and dS^T of one f32 stage in place of S^T and dP^T, as dkv_p_ds on a
// 32-row stage
__device__ __forceinline__ void dkv_p_ds_f32(float (&s)[16], float (&dp)[16],
                                             const float* nlse,
                                             const float* delta, bool whole,
                                             int q0, const int (&lo)[2],
                                             const int (&hi)[2],
                                             float scale_log2, float scale) {
  const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = 8 * j + col0;
    const float2 nl = *reinterpret_cast<const float2*>(nlse + c);
    const float2 dl = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
    for (int e = 4 * j; e < 4 * j + 4; ++e) {
      const int r = acc_row8(e) / 8;
      const float n = (e & 1) ? nl.y : nl.x;
      const float dd = (e & 1) ? dl.y : dl.x;
      float p = exp2f(fmaf(s[e], scale_log2, n));
      if (!whole) {
        const int i = q0 + c + (e & 1);
        p = i >= lo[r] && i <= hi[r] ? p : 0.f;
      }
      s[e] = p;
      dp[e] = p * (dp[e] - dd) * scale;
    }
  }
}

// dS of one f32 K/V tile in place of dP (S becomes P), as dq_p_ds on a
// 32-key tile
__device__ __forceinline__ void dq_p_ds_f32(float (&s)[16], float (&dp)[16],
                                            const float (&nl)[2],
                                            const float (&dl)[2], bool whole,
                                            int kv0, const int (&lo)[2],
                                            const int (&hi)[2],
                                            float scale_log2, float scale) {
  const int col0 = kv0 + 2 * (threadIdx.x % 4);
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    const int r = acc_row8(e) / 8;
    float p = exp2f(fmaf(s[e], scale_log2, nl[r]));
    if (!whole) {
      const int j = col0 + acc_col(e);
      p = j >= lo[r] && j <= hi[r] ? p : 0.f;
    }
    s[e] = p;
    dp[e] = p * (dp[e] - dl[r]) * scale;
  }
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
attention_bwd_dkv_f32_kernel(const float* __restrict__ q,     // [B*Hq, Lq, d]
                             const float* __restrict__ dout,  // [B*Hq, Lq, d]
                             const float* __restrict__ k,    // [B*Hkv, Lkv, d]
                             const float* __restrict__ v,    // [B*Hkv, Lkv, d]
                             const float* __restrict__ lse,   // [B, Hq, Lq]
                             const float* __restrict__ delta, // [B, Hq, Lq]
                             float* __restrict__ dk,   // [B, Hkv, Lkv, d]
                             float* __restrict__ dv,   // [B, Hkv, Lkv, d]
                             int hq, int hkv, int lq, int lkv, int d,
                             int mask, int diag_off, int window,
                             const int* __restrict__ offs, float scale) {
  using T = F32Tiles<D>;
  constexpr int W = T::W;
  constexpr int QT = F32_STREAM;
  if (offs != nullptr) diag_off = offs[0] - offs[1];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sk = smem + T::res;
  unsigned char* sv = sk + 3 * T::RES_PIECE;
  float* stats = reinterpret_cast<float*>(smem + T::stats);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* empty = full + F32_STAGES;
  uint64_t* xbar = empty + F32_STAGES;          // D=256: the exchange's

  const int bhk = blockIdx.x / T::CLUSTER;      // b * hkv + KV head
  const int kv0 = blockIdx.y * F32_ROWS;        // the first tiles first
  const int b = bhk / hkv;
  const int group = hq / hkv;
  const int h0 = (bhk % hkv) * group;           // first q head of the group
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 128;
  const int c0 = T::CLUSTER > 1 ? W * int(cluster_rank()) : 0;  // columns

  // the Q tiles [q_begin, q_end) some row of which sees a key of this
  // block, as attention_bwd_dkv_kernel finds them
  long long q_first = 0, q_end = lq;
  if (mask != MASK_NONE) q_first = clamp64((long long)kv0 - diag_off, 0, lq);
  if (mask == MASK_WINDOW) {
    const long long kv_last = min(kv0 + F32_ROWS, lkv) - 1;
    q_end = clamp64(kv_last - diag_off + window, 0, lq);
  }
  const int q_begin = int(q_first) / QT * QT;
  const int n_qt = q_end > q_begin ? (int(q_end) - q_begin + QT - 1) / QT
                                   : 0;
  const int n_stages = n_qt * group;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128);
    }
    for (int x = 0; x < T::XBUFS; ++x) mbar_init(&xbar[x], 128);
    mbar_init_fence();
  }
  if constexpr (T::CLUSTER > 1) cluster_sync();
  else __syncthreads();

  if (warp >= 4) {
    // the producer: stage i holds Q and dO rows [q0, q0 + 32) of q head
    // h0 + i / n_qt, with their -lse * log2e and delta (-inf, 0 past Lq)
    for (int i = 0; i < n_stages; ++i) {
      const int s = i % F32_STAGES;
      const size_t bh = size_t(b) * hq + h0 + i / n_qt;
      const int q0 = q_begin + (i % n_qt) * QT;
      F32Stream<W> x;
      fetch_stream<W>(x, q + bh * lq * d, dout + bh * lq * d, q0, lq, d, c0,
                      t);
      const bool in = t < QT && q0 + t < lq;
      const float nl = in ? neg_lse2(lse[bh * lq + q0 + t]) : -CUDART_INF_F;
      const float dl = in ? delta[bh * lq + q0 + t] : 0.f;
      mbar_wait(&empty[s], ((i / F32_STAGES) & 1) ^ 1);
      unsigned char* st = smem + T::str + s * T::STAGE;
      put_stream<W>(x, st, st + 3 * T::STR_PIECE, t);
      if (t < QT) {
        stats[s * 2 * QT + t] = nl;
        stats[s * 2 * QT + QT + t] = dl;
      }
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
    if constexpr (T::CLUSTER > 1) cluster_sync();
    return;
  }

  // the consumer warpgroup: KV rows kv0 .. kv0 + 63, this thread two
  const int lane = threadIdx.x % 32;
  const int row0 = kv0 + warp * 16 + lane / 4;
  const float scale_log2 = scale * LOG2E;
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long j = row0 + 8 * r;
    lo[r] = 0;
    hi[r] = lq - 1;
    if (j >= lkv) {
      lo[r] = 1;
      hi[r] = 0;
    } else if (mask != MASK_NONE) {
      lo[r] = int(clamp64(j - diag_off, 0, lq));
      if (mask == MASK_WINDOW)
        hi[r] = int(clamp64(j - diag_off + window - 1, -1, lq - 1));
    }
  }
  const long long first_key = kv0, last_key = kv0 + F32_ROWS - 1;
  auto is_whole = [&](int q0) {
    bool whole = q0 + QT <= lq && kv0 + F32_ROWS <= lkv;
    if (mask != MASK_NONE)
      whole = whole && last_key <= (long long)q0 + diag_off;
    if (mask == MASK_WINDOW)
      whole = whole && first_key >= (long long)q0 + QT - 1 + diag_off
                                        - window + 1;
    return whole;
  };

  const size_t kv_at = size_t(bhk) * lkv * d;
  put_f32_rows<W, F32_ROWS>(sk, k + kv_at, kv0, lkv, d, c0, t);
  put_f32_rows<W, F32_ROWS>(sv, v + kv_at, kv0, lkv, d, c0, t);
  fence_proxy_async();
  named_bar_sync(F32_BAR, 128);

  // dK and dV summed in f32 adds over the stages, each stage's share a
  // fresh wgmma accumulator (issue_part_f32)
  float acc_dk[W / 2], acc_dv[W / 2], part[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc_dk[i] = acc_dv[i] = part[i] = 0.f;
  for (int i = 0; i < n_stages; ++i) {
    const int s = i % F32_STAGES;
    const int q0 = q_begin + (i % n_qt) * QT;
    const unsigned char* q_s = smem + T::str + s * T::STAGE;
    const unsigned char* do_s = q_s + 3 * T::STR_PIECE;
    const float* st = stats + s * 2 * QT;
    float acc_s[16], acc_dp[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc_s[e] = acc_dp[e] = 0.f;
    uint32_t pieces[24];
    mbar_wait(&full[s], (i / F32_STAGES) & 1);
    wgmma_fence();
    issue_abt_f32<W>(acc_s, sk, q_s);                  // S^T
    issue_abt_f32<W>(acc_dp, sv, do_s);                // dP^T
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    fence_regs(acc_dp);
    if constexpr (T::CLUSTER > 1)
      exchange_f32(acc_s, acc_dp, smem + T::xchg, xbar, i);
    dkv_p_ds_f32(acc_s, acc_dp, st, st + QT, is_whole(q0), q0, lo, hi,
                 scale_log2, scale);
    split_a(acc_s, pieces);
    fence_regs(pieces);
    fence_regs(part);
    wgmma_fence();
    issue_part_f32<W>(part, pieces, do_s);             // P^T dO
    add_part(acc_dv, part);
    fence_regs(pieces);
    split_a(acc_dp, pieces);
    fence_regs(pieces);
    wgmma_fence();
    issue_part_f32<W>(part, pieces, q_s);              // dS^T Q
    add_part(acc_dk, part);
    fence_regs(pieces);
    mbar_arrive(&empty[s]);
  }
  store_rows_f32<W>(acc_dk, row0, lkv, dk + kv_at, d, c0);
  store_rows_f32<W>(acc_dv, row0, lkv, dv + kv_at, d, c0);
  if constexpr (T::CLUSTER > 1) cluster_sync();
}

template <int D>
__global__ void __launch_bounds__(F32_THREADS, 1)
attention_bwd_dq_f32_kernel(const float* __restrict__ q,      // [B*Hq, Lq, d]
                            const float* __restrict__ dout,   // [B*Hq, Lq, d]
                            const float* __restrict__ k,     // [B*Hkv, Lkv, d]
                            const float* __restrict__ v,     // [B*Hkv, Lkv, d]
                            const float* __restrict__ lse,    // [B, Hq, Lq]
                            const float* __restrict__ delta,  // [B, Hq, Lq]
                            float* __restrict__ dq,           // [B, Hq, Lq, d]
                            int hq, int group, int lq, int lkv, int d,
                            int mask, int diag_off, int window,
                            const int* __restrict__ offs, float scale) {
  using T = F32Tiles<D>;
  constexpr int W = T::W;
  constexpr int KT = F32_STREAM;
  if (offs != nullptr) diag_off = offs[0] - offs[1];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sq = smem + T::res;
  unsigned char* sdo = sq + 3 * T::RES_PIECE;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* empty = full + F32_STAGES;
  uint64_t* xbar = empty + F32_STAGES;          // D=256: the exchange's

  const int bh = blockIdx.x / T::CLUSTER;
  const int b = bh / hq;
  const int bhk = b * (hq / group) + (bh % hq) / group;   // GQA KV head
  const int q0 = (gridDim.y - 1 - blockIdx.y) * F32_ROWS; // longest first
  const int warp = threadIdx.x / 32;
  const int t = threadIdx.x % 128;
  const int c0 = T::CLUSTER > 1 ? W * int(cluster_rank()) : 0;  // columns

  // the K/V tiles [kv_begin, kv_end) some row of this block sees, as
  // attention_bwd_dq_kernel finds them
  int kv_begin = 0, kv_end = lkv;
  if (mask != MASK_NONE) {
    const long long q_last = min(q0 + F32_ROWS, lq) - 1;
    kv_end = int(clamp64(q_last + diag_off + 1, 0, lkv));
  }
  if (mask == MASK_WINDOW)
    kv_begin = int(clamp64((long long)q0 + diag_off - window + 1, 0, lkv))
               / KT * KT;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + KT - 1) / KT
                                        : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < F32_STAGES; ++s) {
      mbar_init(&full[s], 128);
      mbar_init(&empty[s], 128);
    }
    for (int x = 0; x < T::XBUFS; ++x) mbar_init(&xbar[x], 128);
    mbar_init_fence();
  }
  if constexpr (T::CLUSTER > 1) cluster_sync();
  else __syncthreads();

  if (warp >= 4) {
    // the producer: tile i holds K and V rows [kv0, kv0 + 32)
    const size_t kv_at = size_t(bhk) * lkv * d;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % F32_STAGES;
      F32Stream<W> x;
      fetch_stream<W>(x, k + kv_at, v + kv_at, kv_begin + i * KT, lkv, d,
                      c0, t);
      mbar_wait(&empty[s], ((i / F32_STAGES) & 1) ^ 1);
      unsigned char* st = smem + T::str + s * T::STAGE;
      put_stream<W>(x, st, st + 3 * T::STR_PIECE, t);
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
    if constexpr (T::CLUSTER > 1) cluster_sync();
    return;
  }

  // the consumer warpgroup: Q rows q0 .. q0 + 63, this thread two, with
  // their -lse * log2e and delta (-inf and 0 past Lq) and the keys [lo,
  // hi] each sees
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + warp * 16 + lane / 4;
  const float scale_log2 = scale * LOG2E;
  const size_t rows = size_t(bh) * lq;
  float nl[2], dl[2];
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = row0 + 8 * r;
    nl[r] = i < lq ? neg_lse2(lse[rows + i]) : -CUDART_INF_F;
    dl[r] = i < lq ? delta[rows + i] : 0.f;
    lo[r] = 0;
    hi[r] = lkv - 1;
    if (mask != MASK_NONE) {
      const long long last = (long long)i + diag_off;
      hi[r] = int(clamp64(last, -1, lkv - 1));
      if (mask == MASK_WINDOW)
        lo[r] = int(clamp64(last - window + 1, 0, lkv));
    }
  }
  const long long wg_first = (long long)q0 + diag_off;
  const long long wg_last = wg_first + F32_ROWS - 1;
  auto is_whole = [&](int kv0) {
    bool whole = kv0 + KT <= lkv;
    if (mask != MASK_NONE) whole = whole && kv0 + KT - 1 <= wg_first;
    if (mask == MASK_WINDOW) whole = whole && kv0 >= wg_last - window + 1;
    return whole;
  };

  put_f32_rows<W, F32_ROWS>(sq, q + rows * d, q0, lq, d, c0, t);
  put_f32_rows<W, F32_ROWS>(sdo, dout + rows * d, q0, lq, d, c0, t);
  fence_proxy_async();
  named_bar_sync(F32_BAR, 128);

  // dQ summed in f32 adds over the tiles, each tile's share a fresh wgmma
  // accumulator (issue_part_f32)
  float acc_dq[W / 2], part[W / 2];
#pragma unroll
  for (int i = 0; i < W / 2; ++i) acc_dq[i] = part[i] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % F32_STAGES;
    const int kv0 = kv_begin + i * KT;
    const unsigned char* k_s = smem + T::str + s * T::STAGE;
    const unsigned char* v_s = k_s + 3 * T::STR_PIECE;
    float acc_s[16], acc_dp[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) acc_s[e] = acc_dp[e] = 0.f;
    uint32_t dsa[24];
    mbar_wait(&full[s], (i / F32_STAGES) & 1);
    wgmma_fence();
    issue_abt_f32<W>(acc_s, sq, k_s);                  // S
    issue_abt_f32<W>(acc_dp, sdo, v_s);                // dP
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    fence_regs(acc_dp);
    if constexpr (T::CLUSTER > 1)
      exchange_f32(acc_s, acc_dp, smem + T::xchg, xbar, i);
    dq_p_ds_f32(acc_s, acc_dp, nl, dl, is_whole(kv0), kv0, lo, hi,
                scale_log2, scale);
    split_a(acc_dp, dsa);
    fence_regs(dsa);
    fence_regs(part);
    wgmma_fence();
    issue_part_f32<W>(part, dsa, k_s);                 // dS K
    add_part(acc_dq, part);
    fence_regs(dsa);
    mbar_arrive(&empty[s]);
  }
  store_rows_f32<W>(acc_dq, row0, lq, dq + rows * d, d, c0);
  if constexpr (T::CLUSTER > 1) cluster_sync();
}

// The launch of an f32 kernel of instance D over (x heads, y tiles)
template <int D, class Kernel, class... Args>
int launch_f32(Kernel kernel, int x, int y, cudaStream_t stream,
               Args... args) {
  using T = F32Tiles<D>;
  if (y > 65535) return int(cudaErrorInvalidValue);
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  if constexpr (T::CLUSTER > 1) {
    // x * CLUSTER blocks along x, CLUSTER neighbouring ones a cluster
    const ClusterLaunch l(dim3(x * T::CLUSTER, y), T::CLUSTER, F32_THREADS,
                          T::bytes, stream);
    const cudaError_t err = cudaLaunchKernelEx(&l.cfg, kernel, args...);
    if (err != cudaSuccess) return int(err);
  } else {
    kernel<<<dim3(x, y), F32_THREADS, T::bytes, stream>>>(args...);
  }
  return int(cudaGetLastError());
}

template <int D>
int launch_dkv_f32(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, int batch, int hq, int hkv, int lq,
                   int lkv, int d, int mask, int diag_off, int window,
                   const int* offs, float scale, cudaStream_t stream) {
  return launch_f32<D>(
      attention_bwd_dkv_f32_kernel<D>, batch * hkv,
      (lkv + F32_ROWS - 1) / F32_ROWS, stream,
      static_cast<const float*>(q), static_cast<const float*>(dout),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), hq, hkv, lq, lkv, d,
      mask, diag_off, window, offs, scale);
}

template <int D>
int launch_dq_f32(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, int batch, int hq, int hkv, int lq, int lkv,
                  int d, int mask, int diag_off, int window, const int* offs,
                  float scale, cudaStream_t stream) {
  return launch_f32<D>(
      attention_bwd_dq_f32_kernel<D>, batch * hq,
      (lq + F32_ROWS - 1) / F32_ROWS, stream,
      static_cast<const float*>(q), static_cast<const float*>(dout),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), hq, hq / hkv, lq, lkv, d, mask, diag_off,
      window, offs, scale);
}

// go(integral_constant<int, D>) on the f32 instance for d (16 to 256)
template <typename Go>
int by_f32_instance(int d, Go&& go) {
  if (d <= 64) return go(std::integral_constant<int, 64>{});
  if (d <= 128) return go(std::integral_constant<int, 128>{});
  return go(std::integral_constant<int, 256>{});
}

bool bad_args(int batch, int hq, int hkv, int lq, int lkv, int d, int mask,
              int window, int in_f32) {
  return batch <= 0 || hkv <= 0 || hq % hkv != 0 || lq <= 0 || lkv <= 0 ||
         d < 16 || d > 256 || d % 16 != 0 || mask < MASK_NONE ||
         mask > MASK_WINDOW || (mask == MASK_WINDOW && window < 1) ||
         (in_f32 != 0 && in_f32 != 1);
}

// go(integral_constant<int, D>, integral_constant<bool, EXACT>) on the
// smallest instance D >= d.  The tuned instances, D = d = 64 and 128, run
// with d a compile-time constant (EXACT), the code they had before the d
// rule: with d at run time H3-dq read 1-5% slower there on an H100 (PERF.md)
template <typename F>
int by_instance(int d, F&& go) {
  using Exact = std::true_type;
  using Any = std::false_type;
  if (d <= 32) return go(std::integral_constant<int, 32>{}, Any{});
  if (d == 64) return go(std::integral_constant<int, 64>{}, Exact{});
  if (d <= 64) return go(std::integral_constant<int, 64>{}, Any{});
  if (d == 128) return go(std::integral_constant<int, 128>{}, Exact{});
  if (d <= 128) return go(std::integral_constant<int, 128>{}, Any{});
  return go(std::integral_constant<int, 256>{}, Any{});
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).  The wrappers
// in ops/attention_bwd.py have already checked shapes, dtypes, contiguity
// and alignment; the checks here only refuse what would index out of
// bounds or exceed a grid dimension.  d: a multiple of 16 from 16 to 256,
// run on the smallest instance D >= d.  mask: 0 none, 1 causal, 2 window
// (window >= 1) and offs (null, or the device int32 pair (q_pos0, kv_pos0)
// that replaces diag_off), as eft_prefill_attention takes them.  in_f32: 0
// for bf16 q, k, v, dO and gradients, 1 for f32 (bf16x6 on the f32
// instances D = 64, 128 and 256, the last a cluster of two blocks).
extern "C" int eft_attention_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int batch, int hq,
                                     int hkv, int lq, int lkv, int d,
                                     int mask, int diag_off, int window,
                                     const void* offs, float scale,
                                     int in_f32, int device, void* stream) {
  if (bad_args(batch, hq, hkv, lq, lkv, d, mask, window, in_f32))
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* po = static_cast<const int*>(offs);
  if (in_f32)
    return by_f32_instance(d, [&](auto dc) {
      return launch_dkv_f32<decltype(dc)::value>(
          q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, lq, lkv, d,
          mask, diag_off, window, po, scale, s);
    });
  return by_instance(d, [&](auto dc, auto exact) {
    return launch_dkv<decltype(dc)::value, decltype(exact)::value>(
        q, k, v, dout, lse, delta, dk, dv, batch, hq, hkv, lq, lkv, d, mask,
        diag_off, window, po, scale, s);
  });
}

extern "C" int eft_attention_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int batch, int hq, int hkv,
                                    int lq, int lkv, int d, int mask,
                                    int diag_off, int window,
                                    const void* offs, float scale,
                                    int in_f32, int device, void* stream) {
  if (bad_args(batch, hq, hkv, lq, lkv, d, mask, window, in_f32))
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* po = static_cast<const int*>(offs);
  if (in_f32)
    return by_f32_instance(d, [&](auto dc) {
      return launch_dq_f32<decltype(dc)::value>(
          q, k, v, dout, lse, delta, dq, batch, hq, hkv, lq, lkv, d, mask,
          diag_off, window, po, scale, s);
    });
  return by_instance(d, [&](auto dc, auto exact) {
    return launch_dq<decltype(dc)::value, decltype(exact)::value>(
        q, k, v, dout, lse, delta, dq, batch, hq, hkv, lq, lkv, d, mask,
        diag_off, window, po, scale, s);
  });
}

// The most clusters of H3's f32 D=256 instance (kernel 0 H3-dkv, 1 H3-dq)
// that can be active on `device` at once (cudaOccupancyMaxActiveClusters),
// or minus a cudaError_t
extern "C" int eft_attention_bwd_f32_clusters(int kernel, int device) {
  using T = F32Tiles<256>;
  if (kernel != 0 && kernel != 1) return -int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return -int(dev_err);
  const void* fn = kernel == 0
      ? reinterpret_cast<const void*>(attention_bwd_dkv_f32_kernel<256>)
      : reinterpret_cast<const void*>(attention_bwd_dq_f32_kernel<256>);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (err != cudaSuccess) return -int(err);
  const ClusterLaunch l(dim3(T::CLUSTER), T::CLUSTER, F32_THREADS, T::bytes,
                        nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, fn, &l.cfg);
  return err == cudaSuccess ? n : -int(err);
}
