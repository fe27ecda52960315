// H3-dkv and H3-dq: the flash-attention backward on Hopper (sm_90a), one
// pair of kernels for three masks (none, causal, sliding window).  bf16 in,
// f32 accumulate, bf16 out; head dims 64 and 128.
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
// (ops/attention_bwd.py), as in the JAX package.  P and dS are rounded to
// bf16 before their products, as the TPU kernels do (attention_bwd.py:174,
// :192); S, dP and every sum stay f32.
//
// What bounds it: per visible (row, key) pair H3-dkv runs four products of
// depth d (S, dP, dV, dK) and H3-dq three (S, dP, dQ), 14 d flops, against
// reading Q, K, V, dO once and writing dQ, dK, dV once.  At the flagship's
// training shape (B=8, Hq=8, Hkv=4, L=1024, d=128, causal) that is 60
// GFLOP against 84 MB: the tensor cores bound it, which only wgmma
// reaches.
//
// Design (wgmma_tile.cuh, the block of H1): FlashAttention-2's split into
// two kernels with opposite loop orders and no atomics, so a result is
// bitwise reproducible.  A block is 384 threads: two consumer warpgroups
// and one producer warpgroup that hands its registers over (setmaxnreg 24
// / 240) and feeds a four-stage TMA + mbarrier ring.
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
// Budget at d=128.  H3-dkv: K and V 64 KB, four stages of Q and dO 128 KB,
// stats 2 KB; registers dK 64 + dV 64 + S^T 32 + dP^T 32 per consumer
// thread.  H3-dq: Q and dO 64 KB, four stages of K and V 128 KB; registers
// dQ 64 + S 32 + dP 32.  One block per SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

using namespace eft::hopper;
using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int DKV_ROWS = 128;    // KV rows per H3-dkv block
constexpr int DKV_QT = 64;       // Q rows per H3-dkv stage
constexpr int DQ_ROWS = 128;     // Q rows per H3-dq block
constexpr int DQ_KT = 64;        // keys per H3-dq stage
constexpr int STAGES = 4;        // ring depth of both kernels
constexpr int CONSUMERS = 2;     // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * 128;
// 128 * 24 + 256 * 240 = 384 * 168, what the launch allocates
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int ROW = 128;         // bytes of a TMA box row = the swizzle
constexpr int BOX = 64;          // bf16 columns of a box

// the mask argument of the C entries (as eft_prefill_attention's)
enum Mask : int { MASK_NONE = 0, MASK_CAUSAL = 1, MASK_WINDOW = 2 };

// Shared memory of an H3-dkv block.  A tile of R rows is D / 64 TMA boxes
// of [R][64] bf16 (128-byte swizzled rows), box after box.
template <int D>
struct DkvTiles {
  static constexpr uint32_t KV_BYTES = DKV_ROWS * D * 2;
  static constexpr uint32_t QT_BYTES = DKV_QT * D * 2;
  static constexpr size_t k = 0;
  static constexpr size_t v = k + KV_BYTES;
  static constexpr size_t q = v + KV_BYTES;                    // per stage
  static constexpr size_t dout = q + size_t(STAGES) * QT_BYTES;
  static constexpr size_t nlse = dout + size_t(STAGES) * QT_BYTES;
  static constexpr size_t delta = nlse + size_t(STAGES) * DKV_QT * 4;
  static constexpr size_t bars = delta + size_t(STAGES) * DKV_QT * 4;
  static constexpr size_t bytes = bars + 8 * (2 * STAGES + 1) + 1024;
};

template <int D>
struct DqTiles {
  static constexpr uint32_t Q_BYTES = DQ_ROWS * D * 2;
  static constexpr uint32_t KV_BYTES = DQ_KT * D * 2;
  static constexpr size_t q = 0;
  static constexpr size_t dout = q + Q_BYTES;
  static constexpr size_t k = dout + Q_BYTES;                  // per stage
  static constexpr size_t v = k + size_t(STAGES) * KV_BYTES;
  static constexpr size_t bars = v + size_t(STAGES) * KV_BYTES;
  static constexpr size_t bytes = bars + 8 * (2 * STAGES + 1) + 1024;
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
// of an R-row tile
template <int R>
__device__ __forceinline__ uint64_t kmajor_desc(const unsigned char* tile,
                                                int row0, int kk) {
  const int box = kk * 16 / BOX, off = (kk * 16 % BOX) * 2;
  return gmma_desc(tile + box * R * ROW + row0 * ROW + off, 16, 8 * ROW,
                   ROW);
}

// the descriptor of k-step kk (rows 16 kk .. 16 kk + 15) of an R-row tile
// read MN-major: its D columns are the product's N, box after box
template <int R>
__device__ __forceinline__ uint64_t mnmajor_desc(const unsigned char* tile,
                                                 int kk) {
  return gmma_desc(tile + kk * 16 * ROW, R * ROW, 8 * ROW, ROW);
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
    const uint64_t da = kmajor_desc<RA>(a, a_row0, kk);
    const uint64_t db = kmajor_desc<RB>(b, 0, kk);
    if (kk == 0) wgmma_ss_bf16_n64_first(acc, da, db);
    else wgmma_ss_bf16_n64(acc, da, db, 1);
  }
}

// acc[64 x D] += A[64 x 64] B[64 x D]: A the bf16 fragment of a packed
// 64 x 64 accumulator (16 registers), B a 64-row tile read MN-major
// (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2],
                                          const uint32_t (&a)[16],
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = mnmajor_desc<64>(b, kk);
    if constexpr (D == 128)
      wgmma_rs_bf16_n128(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                         a[4 * kk + 3], db, 1);
    else
      wgmma_rs_bf16_n64(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                        a[4 * kk + 3], db, 1);
  }
}

// a 64 x 64 f32 accumulator packed into its bf16 A fragment
__device__ __forceinline__ void pack_a(const float (&x)[32],
                                       uint32_t (&a)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = pack_bf16x2(x[2 * j], x[2 * j + 1]);
}

// The two rows this thread owns of an m64nD f32 accumulator (row0 and
// row0 + 8) as bf16 rows of dst [n_rows, D], those below n_rows
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           int row0, int n_rows, bf16* dst) {
  const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    bf16* out = dst + size_t(row) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j + col0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
  }
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
    int lq, int lkv, int mask, int diag_off, int window, float scale,
    int kv0, int q_begin, int n_qt, int n_stages) {
  using T = DkvTiles<D>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int kv_wg0 = kv0 + wg * 64;
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

  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

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
      issue_abt<D, DKV_ROWS, DKV_QT>(acc_s, sk, wg * 64, q_s);   // S^T
      issue_abt<D, DKV_ROWS, DKV_QT>(acc_dp, sv, wg * 64, do_s); // dP^T
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
      issue_acc<D>(acc_dv, pa, do_s);                            // P^T dO
      issue_acc<D>(acc_dk, dsa, q_s);                            // dS^T Q
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(pa);
      fence_regs(dsa);
      mbar_arrive(&empty[s]);
    }
  }
  store_rows<D>(acc_dk, row0, lkv, dk);
  store_rows<D>(acc_dv, row0, lkv, dv);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,   // [B*Hq, Lq, D]
                         const __grid_constant__ CUtensorMap tdo,  // [B*Hq, Lq, D]
                         const __grid_constant__ CUtensorMap tk,   // [B*Hkv, Lkv, D]
                         const __grid_constant__ CUtensorMap tv,   // [B*Hkv, Lkv, D]
                         const float* __restrict__ lse,    // [B, Hq, Lq]
                         const float* __restrict__ delta,  // [B, Hq, Lq]
                         bf16* __restrict__ dk,            // [B, Hkv, Lkv, D]
                         bf16* __restrict__ dv,            // [B, Hkv, Lkv, D]
                         int hq, int hkv, int lq, int lkv, int mask,
                         int diag_off, int window,
                         const int* __restrict__ offs,  // (q_pos0, kv_pos0) or null
                         float scale) {
  using T = DkvTiles<D>;
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
  const int kv0 = blockIdx.y * DKV_ROWS;        // the first tiles first
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
    const long long kv_last = min(kv0 + DKV_ROWS, lkv) - 1;
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
      for (int x = 0; x < D / BOX; ++x) {
        tma_load_3d(sk + x * DKV_ROWS * ROW, &tk, kv_full, x * BOX, kv0, bhk);
        tma_load_3d(sv + x * DKV_ROWS * ROW, &tv, kv_full, x * BOX, kv0, bhk);
      }
      for (int i = 0; i < n_stages; ++i) {
        const int s = i % STAGES;
        const int bh = b * hq + h0 + i / n_qt;
        const int q0 = q_begin + (i % n_qt) * DKV_QT;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::QT_BYTES);
        for (int x = 0; x < D / BOX; ++x) {
          tma_load_3d(sq + s * T::QT_BYTES + x * DKV_QT * ROW, &tq, &full[s],
                      x * BOX, q0, bh);
          tma_load_3d(sdo + s * T::QT_BYTES + x * DKV_QT * ROW, &tdo,
                      &full[s], x * BOX, q0, bh);
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
    const size_t out = size_t(bhk) * lkv * D;
    consume_dkv<D>(sk, sv, sq, sdo, snl, sdl, full, empty, kv_full,
                   dk + out, dv + out, lq, lkv, mask, diag_off, window,
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
    int lq, int lkv, int mask, int diag_off, int window, float scale,
    int q0, int kv_begin, int n_tiles) {
  using T = DqTiles<D>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int q_wg0 = q0 + wg * 64;
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

  float acc_dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dq[i] = 0.f;

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
      issue_abt<D, DQ_ROWS, DQ_KT>(acc_s, sq, wg * 64, k_s);     // S
      issue_abt<D, DQ_ROWS, DQ_KT>(acc_dp, sdo, wg * 64, v_s);   // dP
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
      issue_acc<D>(acc_dq, dsa, k_s);                            // dS K
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dq);
      fence_regs(dsa);
      mbar_arrive(&empty[s]);
    }
  }
  store_rows<D>(acc_dq, row0, lq, dq);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
attention_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,    // [B*Hq, Lq, D]
                        const __grid_constant__ CUtensorMap tdo,   // [B*Hq, Lq, D]
                        const __grid_constant__ CUtensorMap tk,    // [B*Hkv, Lkv, D]
                        const __grid_constant__ CUtensorMap tv,    // [B*Hkv, Lkv, D]
                        const float* __restrict__ lse,     // [B, Hq, Lq]
                        const float* __restrict__ delta,   // [B, Hq, Lq]
                        bf16* __restrict__ dq,             // [B, Hq, Lq, D]
                        int hq, int group, int lq, int lkv, int mask,
                        int diag_off, int window,
                        const int* __restrict__ offs,  // (q_pos0, kv_pos0) or null
                        float scale) {
  using T = DqTiles<D>;
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
  const int q0 = (gridDim.y - 1 - blockIdx.y) * DQ_ROWS;  // longest first
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the K/V tiles [kv_begin, kv_end) some row of this block sees: the
  // last row's causal limit ends them, the first row's window edge starts
  // them (rounded down to a tile)
  int kv_begin = 0, kv_end = lkv;
  if (mask != MASK_NONE) {
    const long long q_last = min(q0 + DQ_ROWS, lq) - 1;
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
      for (int x = 0; x < D / BOX; ++x) {
        tma_load_3d(sq + x * DQ_ROWS * ROW, &tq, q_full, x * BOX, q0, bh);
        tma_load_3d(sdo + x * DQ_ROWS * ROW, &tdo, q_full, x * BOX, q0, bh);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int kv0 = kv_begin + i * DQ_KT;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::KV_BYTES);
        for (int x = 0; x < D / BOX; ++x) {
          tma_load_3d(sk + s * T::KV_BYTES + x * DQ_KT * ROW, &tk, &full[s],
                      x * BOX, kv0, bhk);
          tma_load_3d(sv + s * T::KV_BYTES + x * DQ_KT * ROW, &tv, &full[s],
                      x * BOX, kv0, bhk);
        }
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const size_t rows = size_t(bh) * lq;
    consume_dq<D>(sq, sdo, sk, sv, full, empty, q_full, lse + rows,
                  delta + rows, dq + rows * D, lq, lkv, mask, diag_off,
                  window, scale, q0, kv_begin, n_tiles);
  }
}

// the four TMA descriptors of a launch: Q and dO boxes of q_rows rows, K
// and V boxes of kv_rows rows, all 64 columns wide with the 128-byte swizzle
template <int D>
int make_maps(CUtensorMap (&m)[4], const void* q, const void* dout,
              const void* k, const void* v, int batch, int hq, int hkv,
              int lq, int lkv, int q_rows, int kv_rows) {
  int err = make_tmap(&m[0], q, 2, D, lq, batch * hq, BOX, q_rows, ROW);
  if (!err) err = make_tmap(&m[1], dout, 2, D, lq, batch * hq, BOX, q_rows, ROW);
  if (!err) err = make_tmap(&m[2], k, 2, D, lkv, batch * hkv, BOX, kv_rows, ROW);
  if (!err) err = make_tmap(&m[3], v, 2, D, lkv, batch * hkv, BOX, kv_rows, ROW);
  return err;
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int batch, int hq, int hkv, int lq, int lkv, int mask,
               int diag_off, int window, const int* offs, float scale,
               cudaStream_t stream) {
  using T = DkvTiles<D>;
  CUtensorMap m[4];
  const int err = make_maps<D>(m, q, dout, k, v, batch, hq, hkv, lq, lkv,
                               DKV_QT, DKV_ROWS);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_dkv_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(batch * hkv, (lkv + DKV_ROWS - 1) / DKV_ROWS);
  attention_bwd_dkv_kernel<D><<<grid, THREADS, T::bytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), hq, hkv, lq, lkv, mask, diag_off, window, offs,
      scale);
  return int(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int batch,
              int hq, int hkv, int lq, int lkv, int mask, int diag_off,
              int window, const int* offs, float scale, cudaStream_t stream) {
  using T = DqTiles<D>;
  CUtensorMap m[4];
  const int err = make_maps<D>(m, q, dout, k, v, batch, hq, hkv, lq, lkv,
                               DQ_ROWS, DQ_KT);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(batch * hq, (lq + DQ_ROWS - 1) / DQ_ROWS);
  attention_bwd_dq_kernel<D><<<grid, THREADS, T::bytes, stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq), hq, hq / hkv,
      lq, lkv, mask, diag_off, window, offs, scale);
  return int(cudaGetLastError());
}

bool bad_args(int batch, int hq, int hkv, int lq, int lkv, int mask,
              int window) {
  return batch <= 0 || hkv <= 0 || hq % hkv != 0 || lq <= 0 || lkv <= 0 ||
         mask < MASK_NONE || mask > MASK_WINDOW ||
         (mask == MASK_WINDOW && window < 1) ||
         (lkv + DKV_ROWS - 1) / DKV_ROWS > 65535 ||
         (lq + DQ_ROWS - 1) / DQ_ROWS > 65535;
}

}  // namespace

// Both return the cudaError_t of the launch (0 on success).  The wrappers
// in ops/attention_bwd.py have already checked shapes, dtypes, contiguity
// and alignment; the checks here only refuse what would index out of
// bounds or exceed a grid dimension.  mask: 0 none, 1 causal, 2 window
// (window >= 1) and offs (null, or the device int32 pair (q_pos0, kv_pos0)
// that replaces diag_off), as eft_prefill_attention takes them.
extern "C" int eft_attention_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int batch, int hq,
                                     int hkv, int lq, int lkv, int d,
                                     int mask, int diag_off, int window,
                                     const void* offs, float scale,
                                     int device, void* stream) {
  if (bad_args(batch, hq, hkv, lq, lkv, mask, window))
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* po = static_cast<const int*>(offs);
  switch (d) {
    case 64:
      return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, hq,
                            hkv, lq, lkv, mask, diag_off, window, po, scale, s);
    case 128:
      return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, hq,
                             hkv, lq, lkv, mask, diag_off, window, po, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

extern "C" int eft_attention_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int batch, int hq, int hkv,
                                    int lq, int lkv, int d, int mask,
                                    int diag_off, int window,
                                    const void* offs, float scale,
                                    int device, void* stream) {
  if (bad_args(batch, hq, hkv, lq, lkv, mask, window))
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* po = static_cast<const int*>(offs);
  switch (d) {
    case 64:
      return launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, hq, hkv, lq,
                           lkv, mask, diag_off, window, po, scale, s);
    case 128:
      return launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, hq, hkv,
                            lq, lkv, mask, diag_off, window, po, scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
