// H5: the d-tiled attention forward on Hopper (sm_90a), for head dims 128
// to 512 (multiples of 128).  bf16 Q; K and V bf16, or int8 or e4m3 codes
// with one f32 scale per `block` keys; non-causal, f32 accumulate, bf16
// or f32 O.
//
// Replaces the TPU kernel
//   B19 _dtiled_kernel   exploring_flash_attention_tpu/ops/attention_v1_dtiled.py:75
// and computes what it computes, with its rounding: the K scale folds into
// the exp2 constant, s * (scale * log2e * k_scale[key / block]); l sums
// the f32 p; P is rounded to bf16 after the V scale rides it, p *
// v_scale[key / block] (:145-161; bf16 K/V: scales of 1).  Its grid of
// phases per KV tile (n_cq S-chunk phases, one softmax phase, n_cv P
// V-chunk phases) answers the TPU's sequential grid and is not copied.
//
// Cost at B=4, H=8, L=1024, d=512: 68.7 GFLOP, 0.069 ms at 989 TFLOP/s
// bf16, against 134 MB of bf16 Q, K, V and O (0.040 ms at 3.35 TB/s):
// bound by the tensor cores, which only wgmma reaches.
//
// Design (wgmma_tile.cuh).  At d=512 a 64-row O accumulator is 256 f32
// registers per thread of a warpgroup (over the 255 limit) and a 128-row
// bf16 Q tile 128 KB, so O is split by its 128-wide d-chunks across
// warpgroups.  One block per (batch*head, 64-row Q tile), the Q tiles of a
// head next to each other in the grid, has d / 128 consumer warpgroups and
// one producer warpgroup:
//   - the producer warpgroup writes each 64-key tile's scale factors
//     (k_scale * scale * log2e, v_scale; 0 past Lkv) into one of two
//     buffers, and its first thread loads the Q tile once and then streams
//     the tile's K chunks and V chunks (64 keys x 128 columns each) by TMA:
//     bf16 straight into a ring of eight 16 KB chunk slots; codes into a
//     ring of four 8 KB code slots, from which all its 128 threads convert
//     them into six chunk slots (bf16, exact; wgmma_tile.cuh);
//   - consumer warpgroup 0 computes all of S = Q K^T over the d-chunks on
//     bf16 wgmma (m64n64k16, K-major operands), in one fixed order, so the
//     sum is the same bit for bit from run to run; then the online softmax
//     in registers (columns at or past Lkv masked, MUFU.EX2), P = bf16(p *
//     v_scale) as its A fragment in registers, and with d > 128 it also
//     writes P into one of two swizzled shared tiles and each row's alpha
//     beside it;
//   - consumer warpgroup c owns O[:, 128 c : 128 c + 128] in 64 f32
//     registers per thread: O_c = alpha O_c + P V_c on m64n128k16 wgmma,
//     V's chunk MN-major from its slot, P from registers (c = 0) or from
//     the shared tile (c > 0).  No product is repeated;
//   - the epilogue divides by l, which warpgroup 0 hands over in shared
//     memory, and each warpgroup stores its 128 columns.
// Warpgroup 0 carries the S products (half the operations) and the
// softmax: the others' P V of tile i overlaps its S of tile i + 1.
//
// Budget at d=512: shared memory Q 64 KB, eight 16 KB chunk slots (bf16;
// quantized: six, plus four 8 KB code slots), two P tiles 16 KB: ~210 KB.
// Registers (setmaxnreg): at d=512 640 threads share 96 each at launch;
// the producer gives up 56, which warpgroup 0 takes (152: S 32 + O 64 +
// P 16), the other three keep 96 (O 64); at d=384 warpgroup 0 takes 216.
// At d=256 the producer's 128 registers go to both consumer warpgroups
// (232 each); at d=128 a block of 256 threads needs no transfer.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

using namespace eft::hopper;

constexpr int BQ = 64;           // Q rows per block
constexpr int BKV = 64;          // keys per K/V tile
constexpr int DC = 128;          // d-chunk: the columns of one warpgroup's O
constexpr int MAX_NC = 4;        // d up to 512
constexpr int CONVERTERS = 128;  // quantized: the whole producer warpgroup
constexpr int L_BAR = 1;         // named barrier: l handed over
constexpr int SLOT_BAR = 2;      // named barrier: a code slot read

template <int NC, int KIND>
struct Cfg {
  static constexpr int D = NC * DC;
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr bool QUANT = KIND != KV_BF16;
  static constexpr int SLOTS = QUANT ? 6 : 8;          // chunk slots
  static constexpr int CODE_SLOTS = QUANT ? 4 : 0;
  // registers after setmaxnreg (0: no change); the block's total stays
  // what the launch allocates: 640 x 96 at NC = 4 (40 + 152 + 3 x 96),
  // 512 x 128 at NC = 3 (40 + 216 + 2 x 128), 384 x 168 at NC = 2
  static constexpr int PRODUCER_REGS = NC > 1 ? 40 : 0;
  static constexpr int WG0_REGS =
      NC == 4 ? 152 : NC == 3 ? 216 : NC == 2 ? 232 : 0;
  static constexpr int OTHER_REGS = NC == 2 ? 232 : 0;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t CHUNK_BYTES = BKV * DC * 2;   // 2 boxes [64][64]
  static constexpr uint32_t CODE_BYTES = BKV * DC;
  static constexpr uint32_t P_BYTES = BQ * BKV * 2;       // 1 box [64][64]
  static constexpr size_t q = 0;
  static constexpr size_t chunks = q + Q_BYTES;
  static constexpr size_t codes = chunks + size_t(SLOTS) * CHUNK_BYTES;
  static constexpr size_t p = codes + size_t(CODE_SLOTS) * CODE_BYTES;
  static constexpr size_t alpha = p + 2 * size_t(P_BYTES);  // [2][64]
  static constexpr size_t lsum = alpha + 2 * BQ * 4;         // [64]
  static constexpr size_t scales = lsum + BQ * 4;            // [2][2][64]
  static constexpr size_t bars = scales + 4 * BKV * 4;
  static constexpr int N_BARS = 2 * SLOTS + CODE_SLOTS + 1 + 9;
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
};

// The barriers of one block, in shared memory
template <int NC, int KIND>
struct Bars {
  uint64_t chunk_full[Cfg<NC, KIND>::SLOTS];
  uint64_t chunk_empty[Cfg<NC, KIND>::SLOTS];
  uint64_t code_full[Cfg<NC, KIND>::CODE_SLOTS + 1];
  uint64_t sc_full[2], sc_empty[2];     // a tile's scale factors
  uint64_t p_full[2], p_empty[2];       // P and alpha for warpgroups > 0
  uint64_t q_full;
};

// rescale the two rows this thread owns
__device__ __forceinline__ void rescale(float (&acc)[DC / 2],
                                        const float (&a)[2]) {
#pragma unroll
  for (int e = 0; e < DC / 2; ++e) acc[e] *= a[acc_row8(e) / 8];
}

// the MN-major descriptor of k-step kk (16 keys) of a V chunk slot
__device__ __forceinline__ uint64_t v_desc(const unsigned char* slot,
                                           int kk) {
  return gmma_desc(slot + kk * 16 * 128, BKV * 128, 1024, 128);
}

// the item index of K chunk c (u = c) or V chunk c (u = NC + c) of tile i
template <int NC>
__device__ __forceinline__ int item(int i, int u) {
  return i * 2 * NC + u;
}

// The producer warpgroup.  bf16: its first warp writes each tile's scale
// factors and its first lane loads Q and the K and V chunks into the chunk
// slots.  Quantized: its first thread loads Q and the code chunks, each
// once its code slot's last chunk is converted, and all 128 threads write
// the scale factors and convert each code chunk into its chunk slot,
// agreeing (a named barrier) that a code slot is read before its next load
template <int NC, int KIND>
__device__ __forceinline__ void produce(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    unsigned char* smem, Bars<NC, KIND>* bars, const float* ks,
    const float* vs, int bh, int q0, int lkv, int block, int n_blocks,
    int n_tiles, float scale_log2) {
  using C = Cfg<NC, KIND>;
  const int pt = threadIdx.x - NC * 128;
  unsigned char* chunks = smem + C::chunks;
  float* sscale = reinterpret_cast<float*>(smem + C::scales);
  const float* ksb = ks + size_t(bh) * n_blocks;
  const float* vsb = vs + size_t(bh) * n_blocks;
  // tile i's factors: k_scale * scale * log2e and v_scale per key, 0 past
  // Lkv (bf16: scale * log2e and 1), written by threads t, t + n, ...
  auto write_scales = [&](int i, int t, int n) {
    float* sc = sscale + (i % 2) * 2 * BKV;
    for (int c = t; c < BKV; c += n) {
      const int key = i * BKV + c;
      const bool valid = key < lkv;
      if constexpr (C::QUANT) {
        sc[c] = valid ? ksb[key / block] * scale_log2 : 0.f;
        sc[BKV + c] = valid ? vsb[key / block] : 0.f;
      } else {
        sc[c] = scale_log2;
        sc[BKV + c] = valid ? 1.f : 0.f;
      }
    }
  };
  if (pt == 0) {
    mbar_arrive_expect_tx(&bars->q_full, C::Q_BYTES);
    for (int x = 0; x < 2 * NC; ++x)
      tma_load_3d(smem + C::q + x * BQ * 128, tq, &bars->q_full, x * 64, q0,
                  bh);
  }
  if constexpr (C::QUANT) {
    unsigned char* codes = smem + C::codes;
    const int total = n_tiles * 2 * NC;
    auto load_codes = [&](int j) {
      const int cs = j % C::CODE_SLOTS, u = j % (2 * NC);
      mbar_arrive_expect_tx(&bars->code_full[cs], C::CODE_BYTES);
      tma_load_3d(codes + cs * C::CODE_BYTES, u < NC ? tk : tv,
                  &bars->code_full[cs], (u % NC) * DC, j / (2 * NC) * BKV, bh);
    };
    if (pt == 0)
      for (int j = 0; j < C::CODE_SLOTS && j < total; ++j) load_codes(j);
    for (int j = 0; j < total; ++j) {
      const int i = j / (2 * NC);
      if (j % (2 * NC) == 0) {
        mbar_wait(&bars->sc_empty[i % 2], ((i / 2) & 1) ^ 1);
        write_scales(i, pt, CONVERTERS);
        mbar_arrive(&bars->sc_full[i % 2]);
      }
      const int cs = j % C::CODE_SLOTS, s = j % C::SLOTS;
      mbar_wait(&bars->chunk_empty[s], ((j / C::SLOTS) & 1) ^ 1);
      mbar_wait(&bars->code_full[cs], (j / C::CODE_SLOTS) & 1);
      convert_codes_tile<KIND, false, DC>(codes + cs * C::CODE_BYTES,
                                          chunks + s * C::CHUNK_BYTES, BKV,
                                          pt, CONVERTERS);
      fence_proxy_async();
      mbar_arrive(&bars->chunk_full[s]);
      named_bar_sync(SLOT_BAR, CONVERTERS);
      if (pt == 0 && j + C::CODE_SLOTS < total) load_codes(j + C::CODE_SLOTS);
    }
  } else if (pt < 32) {
    for (int i = 0; i < n_tiles; ++i) {
      mbar_wait(&bars->sc_empty[i % 2], ((i / 2) & 1) ^ 1);
      write_scales(i, pt, 32);
      mbar_arrive(&bars->sc_full[i % 2]);
      if (pt == 0) {
        for (int u = 0; u < 2 * NC; ++u) {
          const int j = item<NC>(i, u);
          const int s = j % C::SLOTS, col = (u % NC) * DC;
          const CUtensorMap* map = u < NC ? tk : tv;
          mbar_wait(&bars->chunk_empty[s], ((j / C::SLOTS) & 1) ^ 1);
          mbar_arrive_expect_tx(&bars->chunk_full[s], C::CHUNK_BYTES);
          unsigned char* dst = chunks + s * C::CHUNK_BYTES;
          tma_load_3d(dst, map, &bars->chunk_full[s], col, i * BKV, bh);
          tma_load_3d(dst + BKV * 128, map, &bars->chunk_full[s], col + 64,
                      i * BKV, bh);
        }
      }
      __syncwarp();
    }
  }
}

// Consumer warpgroup 0: S over every d-chunk, the softmax, P (registers,
// and for the other warpgroups a shared tile), its own O chunk
template <int NC, int KIND>
__device__ __forceinline__ void consume_first(
    unsigned char* smem, Bars<NC, KIND>* bars, void* o, int out_f32, int lq,
    int lkv, int q0, int bh, int n_tiles) {
  using C = Cfg<NC, KIND>;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rl = warp * 16 + lane / 4;       // first owned row of the tile
  const int col0 = 2 * (lane % 4);
  const unsigned char* sq = smem + C::q;
  const unsigned char* chunks = smem + C::chunks;
  const float* sscale = reinterpret_cast<const float*>(smem + C::scales);
  float* salpha = reinterpret_cast<float*>(smem + C::alpha);

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc_o[DC / 2];
#pragma unroll
  for (int e = 0; e < DC / 2; ++e) acc_o[e] = 0.f;
  mbar_wait(&bars->q_full, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int kv0 = i * BKV;
    // S = Q K^T over the d-chunks, in one fixed order
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int j = item<NC>(i, c);
      mbar_wait(&bars->chunk_full[j % C::SLOTS], (j / C::SLOTS) & 1);
    }
    float acc_s[BKV / 2];
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const unsigned char* k_s =
          chunks + (item<NC>(i, c) % C::SLOTS) * C::CHUNK_BYTES;
#pragma unroll
      for (int kk = 0; kk < DC / 16; ++kk) {
        const int box = kk / 4, off = (kk % 4) * 32;
        const uint64_t da = gmma_desc(
            sq + (2 * c + box) * BQ * 128 + off, 16, 1024, 128);
        const uint64_t db = gmma_desc(k_s + box * BKV * 128 + off, 16, 1024,
                                      128);
        if (c == 0 && kk == 0) wgmma_ss_bf16_n64_first(acc_s, da, db);
        else wgmma_ss_bf16_n64(acc_s, da, db, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      mbar_arrive(&bars->chunk_empty[item<NC>(i, c) % C::SLOTS]);

    // the online softmax: s * (k_scale * scale * log2e) per column, the
    // columns past Lkv masked unless the tile is whole
    const int t = i % 2;
    mbar_wait(&bars->sc_full[t], (i / 2) & 1);
    const float* kc = sscale + t * 2 * BKV + col0;
    const float* vsc = kc + BKV;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
    if (kv0 + BKV <= lkv) {
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        acc_s[e] = acc_s[e] * kc[acc_col(e)];
        mx[acc_row8(e) / 8] = fmaxf(mx[acc_row8(e) / 8], acc_s[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        const int r = acc_row8(e) / 8;
        acc_s[e] = kv0 + col0 + acc_col(e) < lkv ? acc_s[e] * kc[acc_col(e)]
                                                 : -CUDART_INF_F;
        mx[r] = fmaxf(mx[r], acc_s[e]);
      }
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
    // l sums the f32 p; P = bf16(p * v_scale), the A fragment of P V
    float psum[2] = {0.f, 0.f};
    uint32_t pa[BKV / 4];
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      const int col = acc_col(2 * j);
      const float p0 = exp2_approx(acc_s[2 * j] - m_use[j & 1]);
      const float p1 = exp2_approx(acc_s[2 * j + 1] - m_use[j & 1]);
      psum[j & 1] += p0 + p1;
      pa[j] = pack_bf16x2(p0 * vsc[col], p1 * vsc[col + 1]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
    mbar_arrive(&bars->sc_empty[t]);

    if constexpr (NC > 1) {
      // P and alpha for the other warpgroups
      const int b = i % 2;
      unsigned char* sp = smem + C::p + b * C::P_BYTES;
      mbar_wait(&bars->p_empty[b], ((i / 2) & 1) ^ 1);
#pragma unroll
      for (int j = 0; j < BKV / 4; ++j)
        *reinterpret_cast<uint32_t*>(
            sp + swz128(rl + 8 * (j & 1), 2 * (col0 + acc_col(2 * j)))) =
            pa[j];
      if (col0 == 0) {
        salpha[b * BQ + rl] = alpha[0];
        salpha[b * BQ + rl + 8] = alpha[1];
      }
      fence_proxy_async();
      mbar_arrive(&bars->p_full[b]);
    }

    // O_0 = alpha O_0 + P V_0
    rescale(acc_o, alpha);
    const int jv = item<NC>(i, NC);
    const int sv = jv % C::SLOTS;
    mbar_wait(&bars->chunk_full[sv], (jv / C::SLOTS) & 1);
    const unsigned char* v_s = chunks + sv * C::CHUNK_BYTES;
    fence_regs(acc_o);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs_bf16_n128(acc_o, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                         pa[4 * kk + 3], v_desc(v_s, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    fence_regs(pa);
    mbar_arrive(&bars->chunk_empty[sv]);
  }

  if constexpr (NC > 1) {
    // hand l over to the other warpgroups
    float* sl = reinterpret_cast<float*>(smem + C::lsum);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float l_row = quad_sum(l[r]);
      if (col0 == 0) sl[rl + 8 * r] = l_row;
    }
    named_bar_sync(L_BAR, NC * 128);
  }
  store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o, out_f32,
                   nullptr, C::D, 0);
}

// Consumer warpgroup c > 0: O_c = alpha O_c + P V_c, P from the shared
// tile warpgroup 0 wrote
template <int NC, int KIND>
__device__ __forceinline__ void consume_chunk(
    unsigned char* smem, Bars<NC, KIND>* bars, void* o, int out_f32, int lq,
    int q0, int bh, int n_tiles) {
  using C = Cfg<NC, KIND>;
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int rl = warp * 16 + lane / 4;
  const unsigned char* chunks = smem + C::chunks;
  const float* salpha = reinterpret_cast<const float*>(smem + C::alpha);

  float acc_o[DC / 2];
#pragma unroll
  for (int e = 0; e < DC / 2; ++e) acc_o[e] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int b = i % 2;
    mbar_wait(&bars->p_full[b], (i / 2) & 1);
    const float a[2] = {salpha[b * BQ + rl], salpha[b * BQ + rl + 8]};
    rescale(acc_o, a);
    const int jv = item<NC>(i, NC + wg);
    const int sv = jv % C::SLOTS;
    mbar_wait(&bars->chunk_full[sv], (jv / C::SLOTS) & 1);
    const unsigned char* sp = smem + C::p + b * C::P_BYTES;
    const unsigned char* v_s = chunks + sv * C::CHUNK_BYTES;
    fence_regs(acc_o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_ss_bf16_n128_tb(acc_o, gmma_desc(sp + kk * 32, 16, 1024, 128),
                            v_desc(v_s, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_o);
    mbar_arrive(&bars->chunk_empty[sv]);
    mbar_arrive(&bars->p_empty[b]);
  }

  named_bar_sync(L_BAR, NC * 128);
  const float* sl = reinterpret_cast<const float*>(smem + C::lsum);
  // the row sums, placed so that store_o_rows' quad sum returns them
  const float l[2] = {lane % 4 == 0 ? sl[rl] : 0.f,
                      lane % 4 == 0 ? sl[rl + 8] : 0.f};
  const float m[2] = {0.f, 0.f};
  store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o, out_f32,
                   nullptr, C::D, wg * DC);
}

template <int NC, int KIND>
__global__ void __launch_bounds__(Cfg<NC, KIND>::THREADS, 1)
dtiled_attention_kernel(const __grid_constant__ CUtensorMap tq,  // [BH, Lq, d]
                        const __grid_constant__ CUtensorMap tk,  // [BH, Lkv, d]
                        const __grid_constant__ CUtensorMap tv,  // [BH, Lkv, d]
                        const float* __restrict__ ks,   // [BH, n_blocks] or null
                        const float* __restrict__ vs,   // [BH, n_blocks] or null
                        void* __restrict__ o,           // [BH, Lq, d]
                        int out_f32, int lq, int lkv, int block,
                        int n_blocks, float scale_log2) {
  using C = Cfg<NC, KIND>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto* bars = reinterpret_cast<Bars<NC, KIND>*>(smem + C::bars);

  const int n_qt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const int n_tiles = (lkv + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
      mbar_init(&bars->chunk_full[s], C::QUANT ? CONVERTERS : 1);
      mbar_init(&bars->chunk_empty[s], 128);
    }
    for (int s = 0; s < C::CODE_SLOTS; ++s) mbar_init(&bars->code_full[s], 1);
    for (int t = 0; t < 2; ++t) {
      mbar_init(&bars->sc_full[t], C::QUANT ? CONVERTERS : 32);
      mbar_init(&bars->sc_empty[t], 128);
      mbar_init(&bars->p_full[t], 128);
      mbar_init(&bars->p_empty[t], NC > 1 ? (NC - 1) * 128 : 1);
    }
    mbar_init(&bars->q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == NC) {
    if constexpr (C::PRODUCER_REGS > 0) setmaxnreg_dec<C::PRODUCER_REGS>();
    produce<NC, KIND>(&tq, &tk, &tv, smem, bars, ks, vs, bh, q0, lkv, block,
                      n_blocks, n_tiles, scale_log2);
  } else if (wg == 0) {
    if constexpr (C::WG0_REGS > 0) setmaxnreg_inc<C::WG0_REGS>();
    consume_first<NC, KIND>(smem, bars, o, out_f32, lq, lkv, q0, bh,
                            n_tiles);
  } else if constexpr (NC > 1) {
    if constexpr (C::OTHER_REGS > 0) setmaxnreg_inc<C::OTHER_REGS>();
    consume_chunk<NC, KIND>(smem, bars, o, out_f32, lq, q0, bh, n_tiles);
  }
}

template <int NC, int KIND>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* o, int out_f32, int bh, int lq, int lkv,
           int block, int n_blocks, float scale_log2, cudaStream_t stream) {
  using C = Cfg<NC, KIND>;
  CUtensorMap tq, tk, tv;
  int err = make_tmap(&tq, q, 2, C::D, lq, bh, 64, BQ, 128);
  if (C::QUANT) {
    if (!err) err = make_tmap(&tk, k, 1, C::D, lkv, bh, DC, BKV, 0);
    if (!err) err = make_tmap(&tv, v, 1, C::D, lkv, bh, DC, BKV, 0);
  } else {
    if (!err) err = make_tmap(&tk, k, 2, C::D, lkv, bh, 64, BKV, 128);
    if (!err) err = make_tmap(&tv, v, 2, C::D, lkv, bh, 64, BKV, 128);
  }
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      dtiled_attention_kernel<NC, KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(bh * ((lq + BQ - 1) / BQ));
  dtiled_attention_kernel<NC, KIND><<<grid, C::THREADS, C::bytes, stream>>>(
      tq, tk, tv, static_cast<const float*>(ks),
      static_cast<const float*>(vs), o, out_f32, lq, lkv, block, n_blocks,
      scale_log2);
  return int(cudaGetLastError());
}

template <int KIND>
int launch_d(int d, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, void* o, int out_f32, int bh,
             int lq, int lkv, int block, int n_blocks, float scale_log2,
             cudaStream_t stream) {
  switch (d / DC) {
    case 1:
      return launch<1, KIND>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, block,
                             n_blocks, scale_log2, stream);
    case 2:
      return launch<2, KIND>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, block,
                             n_blocks, scale_log2, stream);
    case 3:
      return launch<3, KIND>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, block,
                             n_blocks, scale_log2, stream);
    case 4:
      return launch<4, KIND>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, block,
                             n_blocks, scale_log2, stream);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_v1_dtiled.py has already checked shapes, dtypes,
// contiguity and alignment; the checks here only refuse what would index
// out of bounds.  kv_kind: 0 bf16 (ks, vs unused), 1 int8, 2 e4m3; d a
// multiple of 128 up to 512; scale_log2 = softmax scale * log2(e).
extern "C" int eft_dtiled_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, void* o, int batch,
                                    int heads, int lq, int lkv, int d,
                                    int block, int n_blocks, int kv_kind,
                                    int out_f32, float scale_log2,
                                    int device, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lkv <= 0 ||
      d % DC != 0 || d > MAX_NC * DC ||
      (kv_kind != KV_BF16 &&
       (block <= 0 || n_blocks != (lkv + block - 1) / block)))
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  switch (kv_kind) {
    case KV_BF16:
      return launch_d<KV_BF16>(d, q, k, v, ks, vs, o, out_f32, bh, lq, lkv,
                               block, n_blocks, scale_log2, s);
    case KV_INT8:
      return launch_d<KV_INT8>(d, q, k, v, ks, vs, o, out_f32, bh, lq, lkv,
                               block, n_blocks, scale_log2, s);
    case KV_FP8:
      return launch_d<KV_FP8>(d, q, k, v, ks, vs, o, out_f32, bh, lq, lkv,
                              block, n_blocks, scale_log2, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
