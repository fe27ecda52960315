// The f32 attention core of H1 (prefill_attention.cu), H6-extend
// (paged_extend.cu) and H4-kvq (kvquant_attention.cu): f32 inputs at f32
// accuracy, on bf16 wgmma.
//
// What f32 means in the JAX package: its kernels ask Mosaic for HIGHEST
// whenever an operand is f32 (ops/attention_v1.py:202-210, dot_precision),
// and its paged kernels compute in q's dtype (serving/decode.py:177-181),
// so an f32 call gives an f32-accurate result, not a bf16 one.  HIGHEST on
// the MXU is bf16x6, and so is this core: every f32 operand x is split
// exactly into three bf16 pieces, hi = bf16(x), mid = bf16(x - hi), lo =
// bf16(x - hi - mid) (hi + mid + lo = x to f32's 24 bits), and a product
// is the sum of the six piece products hi.hi, hi.mid, mid.hi, hi.lo,
// lo.hi and mid.mid, smallest first, in one f32 wgmma accumulator that
// starts from zero.  Each piece product is exact in f32; what Hopper's
// tensor cores do with the sums was measured by tools/probe_bf16x6.py
// against the JAX f32 tiers before this core was written (both bf16x6 and
// bf16x3 within them).  An operand that bf16 holds exactly needs one
// piece: H6-extend's and H4-kvq's int8 or e4m3 K/V codes, so there S = Q
// K^T and P V are three products each (bf16x3 on q and P * v_scale, the
// codes whole), exact f32 products.
//
// O across key tiles: the tensor core drops the bits of an added product
// below its accumulator's last, so O kept in one wgmma accumulator over
// every key tile drifts with the number of tiles (H3 read 8.9e-5 of
// max|dV| that way, PERF.md section 6).  Each tile's P V is therefore its
// own product, in a fresh accumulator (the first wgmma with scale-d 0),
// and O = alpha O + part is an f32 FMA in registers: the rescale by alpha
// that O needs every tile anyway, so the fresh accumulator costs no f32
// operation in the exact statistic and one add a value a tile in the bound
// one (alpha = 1).  Hence per tile and not per few tiles: a part summed
// over several tiles would need the same rescale itself.
//
// Block (Tiles below): NC consumer warpgroups of 64 Q rows (2; 1 at
// D=256) and one producer warpgroup, 128 (NC + 1) threads, one block per
// SM.  D = 64, 128 or 256 (a d below D runs on zero columns).
//   - each consumer warpgroup reads its 64 f32 Q rows from global memory
//     (the caller's row function) and stores their three pieces in the
//     128-byte-swizzled layout a TMA load of a bf16 tile would give;
//   - the producer warpgroup reads each K/V tile of BKV keys from global
//     memory into registers (the caller's fetch), waits for its stage to
//     be free, and stores the pieces (the caller's put: three of an f32
//     tile, one of codes) in two stages, with per-key factors kc (s's
//     scale into the exp2 basis) and vs (P's factor before P V);
//   - each consumer warpgroup, per tile: S on wgmma (SS, both K-major, the
//     pieces' products over d / 16 k-steps each), the mask from each
//     row's [lo, hi], s * kc, the online softmax in f32 (exp2f, l summing
//     the f32 p), P * vs split into three A fragments in registers, P V
//     on wgmma (RS, V MN-major) into a fresh accumulator, then O = alpha O
//     + P V in f32.
// Registers: a consumer thread holds O (D / 2), the fresh P V accumulator
// and P's A fragments at once.  At D=128 that passes the 168 a thread of
// 384 gets, so the producer hands registers over with setmaxnreg (104 /
// 200 with three pieces, whose producer holds a tile's 64 f32 values; 56 /
// 224 with one, as the bf16 H4-kvq and H6-extend).  At D=256 (256
// threads, 255 at most) O alone is 128: P V is two products of 128
// columns, each in a fresh 64-register accumulator added before the next
// is issued (fewer changes than two consumer warpgroups over 128 columns
// each, which would need Q's pieces and the softmax in both).
// Shared memory: Q 3 x BQ x D x 2 bytes, each stage 2 x KP x BKV x D x 2
// (KP pieces of K, then of V): 192 KB for H1 at D=128 (BKV 32) and D=256
// (BKV 16, one consumer), 128 KB and 160 KB for H6-extend (BKV 32).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace eft {
namespace f32 {

using namespace eft::hopper;

// KP: pieces of K and V (3 for f32, 1 for codes exact in bf16)
template <int D, int KP>
struct Tiles {
  static_assert(D == 64 || D == 128 || D == 256, "an instance of the core");
  static constexpr int NC = D == 256 ? 1 : 2;         // consumer warpgroups
  static constexpr int BQ = 64 * NC;                  // Q rows per block
  static constexpr int THREADS = 128 * (NC + 1);
  static constexpr int BKV = KP == 3 && D == 256 ? 16 : 32;
  static constexpr int STAGES = 2;
  static constexpr int TERMS = KP == 3 ? 6 : 3;       // piece products
  static constexpr uint32_t Q_PIECE = BQ * D * 2;
  static constexpr uint32_t KV_PIECE = BKV * D * 2;
  static constexpr uint32_t STAGE = 2 * KP * KV_PIECE;
  static constexpr size_t q = 0;
  static constexpr size_t kv = q + 3 * size_t(Q_PIECE);
  static constexpr size_t fac = kv + STAGES * size_t(STAGE);
  static constexpr size_t bars = fac + STAGES * 2 * BKV * 4;
  static constexpr size_t bytes = bars + 8 * 2 * STAGES + 1024;
  static_assert(bytes <= 232448, "the block's shared memory");
  // registers a thread after setmaxnreg (0: none); 128 * P + 256 * C stays
  // within 384 * 168, what the launch allocates
  static constexpr int PRODUCER_REGS = D == 128 ? (KP == 3 ? 104 : 56) : 0;
  static constexpr int CONSUMER_REGS = D == 128 ? (KP == 3 ? 200 : 224) : 0;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 384 * 168,
                "the block's registers");
  // P V as NPV products of D / NPV columns, each in a fresh accumulator
  static constexpr int NPV = D == 256 ? 2 : 1;
  static constexpr int PV_N = D / NPV;
};

constexpr int Q_BAR = 1;         // named barriers 1, 2: a warpgroup's Q rows

// the pieces of product t (0..5, the smallest first): (A piece, B piece),
// 0 hi, 1 mid, 2 lo.  Six: lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi;
// three (B whole): lo, mid, hi of A against B
template <int TERMS>
__device__ __forceinline__ constexpr int piece_a(int t) {
  return TERMS == 3 ? 2 - t : (t == 0 ? 2 : t == 2 ? 1 : t == 3 ? 1 : 0);
}
template <int TERMS>
__device__ __forceinline__ constexpr int piece_b(int t) {
  return TERMS == 3 ? 0 : (t == 1 ? 2 : t == 2 ? 1 : t == 4 ? 1 : 0);
}

// a and b split into bf16 pieces, packed as bf16x2 (a low): w[0] hi, w[1]
// mid, w[2] lo.  Each difference is exact in f32.
__device__ __forceinline__ void split3x2(float a, float b, uint32_t (&w)[3]) {
  w[0] = pack_bf16x2(a, b);
  a -= __uint_as_float(w[0] << 16);
  b -= __uint_as_float(w[0] & 0xffff0000u);
  w[1] = pack_bf16x2(a, b);
  a -= __uint_as_float(w[1] << 16);
  b -= __uint_as_float(w[1] & 0xffff0000u);
  w[2] = pack_bf16x2(a, b);
}

// 8 f32 of tile row r, columns 8 ch .. 8 ch + 7, as three pieces: piece p
// at tile + p * piece_bytes, in boxes of 64 columns of `rows` rows
// (128-byte rows, 128-byte swizzle)
__device__ __forceinline__ void put_split8(unsigned char* tile,
                                           uint32_t piece_bytes, int rows,
                                           int r, int ch, const float4& x0,
                                           const float4& x1) {
  const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  uint32_t w[4][3];
#pragma unroll
  for (int e = 0; e < 4; ++e) split3x2(x[2 * e], x[2 * e + 1], w[e]);
  unsigned char* at = tile + (ch / 8) * rows * 128 + swz128(r, (ch % 8) * 16);
#pragma unroll
  for (int p = 0; p < 3; ++p)
    *reinterpret_cast<uint4*>(at + p * piece_bytes) =
        make_uint4(w[0][p], w[1][p], w[2][p], w[3][p]);
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16], bf16 -> f32, A and B in shared
// memory (descriptors), both K-major.
__device__ __forceinline__ void wgmma_ss_bf16_n16(float (&d)[8], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], as above
__device__ __forceinline__ void wgmma_ss_bf16_n32(float (&d)[16], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// S (+)= the piece products of Q (this warpgroup's rows, q_wg) and the K
// pieces of one stage (issued, not waited for)
template <int D, int KP>
__device__ __forceinline__ void issue_s(
    float (&acc)[Tiles<D, KP>::BKV / 2], const unsigned char* q_wg,
    const unsigned char* k_s) {
  using T = Tiles<D, KP>;
#pragma unroll
  for (int t = 0; t < T::TERMS; ++t) {
    const unsigned char* a = q_wg + piece_a<T::TERMS>(t) * T::Q_PIECE;
    const unsigned char* b = k_s + piece_b<T::TERMS>(t) * T::KV_PIECE;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int box = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = gmma_desc(a + box * T::BQ * 128 + off, 16, 1024, 128);
      const uint64_t db = gmma_desc(b + box * T::BKV * 128 + off, 16, 1024,
                                    128);
      if constexpr (T::BKV == 16) wgmma_ss_bf16_n16(acc, da, db);
      else wgmma_ss_bf16_n32(acc, da, db);
    }
  }
}

// part = the piece products of P (pa: piece p's A fragments at p * BKV /
// 4) and PV_N columns of the V pieces of one stage from v_s (the first
// column box of this product), in a fresh accumulator: the first wgmma
// with scale-d 0, as issue_part_f32 in attention_bwd.cu (issued, not
// waited for)
template <int D, int KP>
__device__ __forceinline__ void issue_pv(
    float (&part)[Tiles<D, KP>::PV_N / 2],
    const uint32_t (&pa)[3 * Tiles<D, KP>::BKV / 4],
    const unsigned char* v_s) {
  using T = Tiles<D, KP>;
  constexpr int NA = T::BKV / 4;
#pragma unroll
  for (int t = 0; t < T::TERMS; ++t) {
    const uint32_t* a = pa + piece_a<T::TERMS>(t) * NA;
    const unsigned char* b = v_s + piece_b<T::TERMS>(t) * T::KV_PIECE;
#pragma unroll
    for (int kk = 0; kk < T::BKV / 16; ++kk) {
      const uint64_t db = gmma_desc(b + kk * 16 * 128, T::BKV * 128, 1024,
                                    128);
      const int acc = t > 0 || kk > 0;
      if constexpr (T::PV_N == 128)
        wgmma_rs_bf16_n128(part, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                           a[4 * kk + 3], db, acc);
      else
        wgmma_rs_bf16_n64(part, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
                          a[4 * kk + 3], db, acc);
    }
  }
}

// A consumer warpgroup's 64 Q rows (row(r) gives the address of its row
// r's d floats, or null: a zero row), zero past d, as three pieces; then
// the warpgroup's barrier.  Rows of a d that is a multiple of 4 are read
// 16 bytes at a time, others a float at a time.
template <int D, int KP, class RowPtr>
__device__ __forceinline__ void stage_q(unsigned char* sq, int wg, RowPtr row,
                                        int d) {
  using T = Tiles<D, KP>;
  const int ct = threadIdx.x % 128;
  for (int x = ct; x < 64 * (D / 8); x += 128) {
    const int r = x / (D / 8), ch = x % (D / 8);
    const float* src = row(r);
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (src != nullptr && 8 * ch < d)
      load8_f32(src + 8 * ch, d - 8 * ch, d % 4 == 0, x0, x1);
    put_split8(sq, T::Q_PIECE, T::BQ, wg * 64 + r, ch, x0, x1);
  }
  fence_proxy_async();
  named_bar_sync(Q_BAR + wg, 128);
}

// One consumer warpgroup's K/V loop over n_tiles tiles from kv_begin: lo /
// hi are the key positions [lo, hi] each owned row sees (rows row0 and
// row0 + 8 of the accumulator layout).  On return acc_o holds O
// unnormalized, m each row's shift (exp2 basis) and l this thread's share
// of its sum of p (the quad adds).  VSCALE: P is multiplied by vs before P
// V; else vs is not read.  BOUND: m holds each row's fixed shift on entry.
// The consumers' setmaxnreg comes first.
template <int D, int KP, bool BOUND, bool VSCALE>
__device__ __forceinline__ void attend(const unsigned char* smem, int wg,
                                       uint64_t* full, uint64_t* empty,
                                       int kv_begin, int n_tiles,
                                       const int (&lo)[2], const int (&hi)[2],
                                       float (&acc_o)[D / 2], float (&m)[2],
                                       float (&l)[2]) {
  using T = Tiles<D, KP>;
  constexpr int BKV = T::BKV;
  const unsigned char* q_wg = smem + T::q + wg * 64 * 128;
  const float* fac = reinterpret_cast<const float*>(smem + T::fac);
  const int col0 = 2 * (threadIdx.x % 4);
  if constexpr (T::CONSUMER_REGS > 0) setmaxnreg_inc<T::CONSUMER_REGS>();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = 0.f;
    if constexpr (!BOUND) m[r] = -CUDART_INF_F;
  }
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_o[e] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % T::STAGES;
    const int kv0 = kv_begin + i * BKV;
    const unsigned char* k_s = smem + T::kv + s * T::STAGE;
    const float* kc = fac + s * 2 * BKV;
    const float* vs = kc + BKV;
    float acc_s[BKV / 2];
#pragma unroll
    for (int e = 0; e < BKV / 2; ++e) acc_s[e] = 0.f;
    mbar_wait(&full[s], (i / T::STAGES) & 1);
    wgmma_fence();
    issue_s<D, KP>(acc_s, q_wg, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);

    // the mask, s * kc, the online softmax in the exp2 basis
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int e = 0; e < BKV / 2; ++e) {
      const int r = acc_row8(e) / 8;
      const int col = kv0 + col0 + acc_col(e);
      acc_s[e] = col >= lo[r] && col <= hi[r]
                     ? acc_s[e] * kc[col0 + acc_col(e)] : -CUDART_INF_F;
      mx[r] = fmaxf(mx[r], acc_s[e]);
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (BOUND) {
        m_use[r] = m[r];
        alpha[r] = 1.f;
      } else {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
        alpha[r] = exp2f(m[r] - m_use[r]);
        m[r] = m_new;
      }
    }
    // p, l, and P (times vs) as three bf16 A fragments
    uint32_t pa[3 * BKV / 4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const int r = acc_row8(2 * j) / 8;
      const float p0 = exp2f(acc_s[2 * j] - m_use[r]);      // 0 where masked
      const float p1 = exp2f(acc_s[2 * j + 1] - m_use[r]);
      psum[r] += p0 + p1;
      const int c = col0 + acc_col(2 * j);
      uint32_t w[3];
      if constexpr (VSCALE) split3x2(p0 * vs[c], p1 * vs[c + 1], w);
      else split3x2(p0, p1, w);
#pragma unroll
      for (int p = 0; p < 3; ++p) pa[p * (BKV / 4) + j] = w[p];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
    // P V in a fresh accumulator per PV_N columns, O = alpha O + part in
    // f32 (O += part with the bound statistic)
    const unsigned char* v_s = k_s + KP * T::KV_PIECE;
#pragma unroll
    for (int h = 0; h < T::NPV; ++h) {
      float part[T::PV_N / 2];
      fence_regs(pa);
      wgmma_fence();
      issue_pv<D, KP>(part, pa, v_s + h * (T::PV_N / 64) * BKV * 128);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int e = 0; e < T::PV_N / 2; ++e) {
        float& o = acc_o[h * (T::PV_N / 2) + e];
        if constexpr (BOUND) o += part[e];
        else o = fmaf(o, alpha[acc_row8(e) / 8], part[e]);
      }
    }
    fence_regs(pa);
    mbar_arrive(&empty[s]);
  }
}

// The producer warpgroup's loop: per tile i, fetch(i, regs) reads its data
// from global memory into registers, then, once the stage is free,
// put(regs, k_pieces, v_pieces, kc, vs) stores it (every producer thread
// its share), and the stage is handed over.  Its setmaxnreg comes first.
template <int D, int KP, class Regs, class Fetch, class Put>
__device__ __forceinline__ void produce(unsigned char* smem, uint64_t* full,
                                        uint64_t* empty, int n_tiles,
                                        Fetch fetch, Put put) {
  using T = Tiles<D, KP>;
  if constexpr (T::PRODUCER_REGS > 0) setmaxnreg_dec<T::PRODUCER_REGS>();
  float* fac = reinterpret_cast<float*>(smem + T::fac);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % T::STAGES;
    Regs regs;
    fetch(i, regs);
    mbar_wait(&empty[s], ((i / T::STAGES) & 1) ^ 1);
    unsigned char* k_s = smem + T::kv + s * T::STAGE;
    put(regs, k_s, k_s + KP * T::KV_PIECE, fac + s * 2 * T::BKV,
        fac + s * 2 * T::BKV + T::BKV);
    fence_proxy_async();
    mbar_arrive(&full[s]);
  }
}

// barriers: full[s] (the producer's 128 threads), empty[s] (the consumers'
// threads), in the block's shared memory; before any other use
template <int D, int KP>
__device__ __forceinline__ void init_bars(uint64_t* bars) {
  using T = Tiles<D, KP>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::STAGES; ++s) {
      mbar_init(&bars[s], 128);
      mbar_init(&bars[T::STAGES + s], T::NC * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

}  // namespace f32
}  // namespace eft
