// H4-kvq: the attention forward over a quantized K/V on Hopper (sm_90a).
// bf16 or f32 Q, int8 or e4m3 K and V with one f32 scale per `block` keys,
// non-causal, f32 accumulate, bf16 or f32 O.  f32 q takes
// kvquant_attention_f32_kernel below (the f32 core of f32_attention.cuh).
//
// Replaces two TPU kernels of the JAX package that compute one function
// and differ only by a VMEM rule (one pass when the quantized KV fits,
// attention_v1.py:93, else streaming):
//   B16 _kvquant_kernel           exploring_flash_attention_tpu/ops/attention_kvquant.py:47
//   B17 _kvquant_onepass_kernel   exploring_flash_attention_tpu/ops/attention_kvquant.py:114
//
// Cost at the canonical shape (B=32, H=8, L=1024, d=128): 137.4 GFLOP,
// 0.139 ms at 989 TFLOP/s bf16, against ~201 MB of bf16 Q and O and int8
// K and V, 0.060 ms at 3.35 TB/s: the bound is the tensor cores, which only
// wgmma reaches.
//
// Design (H1's block, wgmma_tile.cuh).  One block per (batch*head, 128-row
// Q tile), the Q tiles of a head next to each other in the grid: two
// consumer warpgroups of 64 rows and one producer warpgroup, which hands
// registers to the consumers (setmaxnreg: 56 and 224 per thread).  wgmma
// has no bf16 x int8 or bf16 x e4m3 form, and quantizing Q would compute
// another function (B18's), so the codes are converted to 16 bits in
// shared memory (exact for both kinds):
//   - the producer's first thread loads the bf16 Q tile once, then the
//     code tiles K_0, V_0, K_1, V_1, ... (128 keys each) through a ring of
//     three code slots by TMA, each load once the slot's last tile is
//     converted;
//   - all its 128 threads convert each code tile into one of two
//     converted stages, with packed conversions (wgmma_tile.cuh): K to
//     bf16 in the K-major, 128-byte-swizzled layout H1's S = Q K^T reads, V
//     to fp16 in the MN-major layout H1's P V reads; beside each stage
//     they write each key's k_scale * scale * log2e, each key's
//     v_scale / vmax and the tile's vmax, the largest V scale among its
//     keys (scales are at least 1e-8 / qmax, ops/quant.py:56, so vmax > 0);
//   - each consumer warpgroup runs H1's loop: S on bf16 wgmma (m64n128k16)
//     into registers, the columns at or past Lkv masked (a zero-filled key
//     scores 0, not -inf), s * (k_scale * scale * log2e) per column (as
//     B17 folds it, attention_kvquant.py:147), the online softmax in the
//     exp2 basis (MUFU.EX2), l summing the f32 p (B16, :92), P V on fp16
//     wgmma with P from registers, S of tile i overlapping P V of tile
//     i - 1; a stage is released once P V has read it.
// The rounding contract kept from the WMMA form: P is rounded to fp16 as
// p * (v_scale / vmax), which is p itself wherever a tile lies in one scale
// block (2^-11 relative per weight; B16 and B17 round P to bf16, 2^-8; the
// ratio keeps P in [0, 1], so fp16's range holds for any scale), and each
// tile's product is multiplied by its vmax, per K/V tile.  vmax
// folds into the row rescale: O is held divided by the last tile's vmax,
// so before P V of tile i it is multiplied by alpha_i * vmax_{i-1} /
// vmax_i, and the epilogue multiplies by the last vmax.  Any block works,
// a ragged last one and blocks shorter than a tile included, since scales
// are read per key.
//
// Budget at d=128: shared memory Q 32 KB, two converted stages of K and V
// 128 KB, three code slots 48 KB, scales 2 KB: 210 KB (a third converted
// stage and a code ring of the same depth do not fit in 227 KB).
// Registers: S 64 + O 64 + P 32 per consumer thread, within 224; the
// producer keeps 56 for the conversion (on an H100, 40 / 232 ran about
// 3% slower).
//
// Head dims.  d is any d from 1 to 256, on instances D = 64, 128 and 256
// (the smallest D >= d), as H6-extend's (paged_extend.cu): at d a multiple
// of 16, Q and the code tiles are loaded by TMA as boxes of D columns from
// tensors described with their true d, so the columns past d arrive as
// zeros (zero K and V codes), add nothing to S and give O columns that the
// epilogue does not store.  At any other d a code row of d bytes is no
// stride a tensor map takes, and a tile of BKV rows starts at byte (bh Lkv
// + kv0) d, 16-byte aligned only where Lkv d is: the PACKED instances load
// the tiles themselves, all 128 producer threads with cp.async pieces of
// the rows' alignment (a code at a time where it is below 4 bytes) into
// the same [BKV][D] code slots, zeros past d and past Lkv, each tile's
// copies a group issued SLOTS tiles ahead (wgmma_tile.cuh stage16); and
// copy Q's bf16 rows the same way, a row a thread, and store O a value at
// a time where d % 8 != 0.  The padded share of the products is (D - d) /
// D (37.5% at d=80).  The softmax scale is the caller's, 1/sqrt(d) of the
// true d.  The f32 kernel reads code rows at their alignment too.
// At D=256 O takes 128 registers a consumer thread, so the K/V tile is 64
// keys (S 32 + P 16 + O 128 within the 224, vmax per 64-key tile), and Q
// 64 KB + two converted stages 128 KB leave room for two code slots (32
// KB): 226 KB.  The f32 kernel below takes the same d on the f32 core's
// instances (f32_attention.cuh).

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

constexpr int BQ = 128;          // Q rows per block
constexpr int STAGES = 2;        // converted K/V stages
constexpr int CONSUMERS = 2;     // warpgroups of 64 Q rows
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int CONVERTERS = 128;  // the whole producer warpgroup
constexpr int SLOT_BAR = 1;      // named barrier: a code slot read
// registers per thread after setmaxnreg: 128 * 56 + 256 * 224 = 384 * 168,
// what the launch allocates (more, and the consumers' setmaxnreg.inc waits
// forever)
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;

// Shared memory of one block.  Q and the converted K and V are boxes of 64
// 16-bit columns (128-byte rows, the swizzle width) by their rows, box
// after box; a code slot is a plain [BKV][D] tile of one-byte codes.  Each
// stage's scales: k_scale * scale * log2e per key, v_scale / vmax per key,
// vmax.  K/V tiles of BKV keys (128; 64 at D=256), SLOTS code slots (3; 2
// at D=256).
template <int D>
struct Tiles {
  static constexpr int BKV = D == 256 ? 64 : 128;
  static constexpr int SLOTS = D == 256 ? 2 : 3;
  static constexpr int NBOX = D / 64;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t CONV_BYTES = BKV * D * 2;
  static constexpr uint32_t CODE_BYTES = BKV * D;
  static constexpr int SCALES = 2 * BKV + 4;        // floats per stage
  static constexpr size_t q = 0;
  static constexpr size_t k = q + Q_BYTES;
  static constexpr size_t v = k + size_t(STAGES) * CONV_BYTES;
  static constexpr size_t codes = v + size_t(STAGES) * CONV_BYTES;
  static constexpr size_t scales = codes + size_t(SLOTS) * CODE_BYTES;
  static constexpr size_t bars = scales + size_t(STAGES) * SCALES * 4;
  static constexpr size_t bytes =
      bars + 8 * (SLOTS + 3 * STAGES + 1) + 1024;
  static_assert(bytes <= 232448, "the block's shared memory");
};

// O += P V of 16 keys; v_k is their rows of the converted V tile
// (MN-major boxes of BKV rows)
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         const unsigned char* v_k) {
  constexpr int BKV = Tiles<D>::BKV;
  const uint64_t db = gmma_desc(v_k, BKV * 128, 1024, 128);
  if constexpr (D == 256)
    wgmma_rs_f16_n256(o, a, db,
                      gmma_desc(v_k + 2 * BKV * 128, BKV * 128, 1024, 128));
  else if constexpr (D == 128)
    wgmma_rs_f16_n128(o, a[0], a[1], a[2], a[3], db, 1);
  else
    wgmma_rs_f16_n64(o, a[0], a[1], a[2], a[3], db, 1);
}

// S = Q K^T of one converted K tile (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_qk(float (&acc_s)[Tiles<D>::BKV / 2],
                                         const unsigned char* q_wg,
                                         const unsigned char* k_s) {
  constexpr int BKV = Tiles<D>::BKV;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = gmma_desc(q_wg + box * BQ * 128 + off, 16, 1024, 128);
    const uint64_t db = gmma_desc(k_s + box * BKV * 128 + off, 16, 1024, 128);
    if constexpr (BKV == 128) {
      if (kk == 0) wgmma_ss_bf16_n128_first(acc_s, da, db);
      else wgmma_ss_bf16_n128(acc_s, da, db, 1);
    } else {
      if (kk == 0) wgmma_ss_bf16_n64_first(acc_s, da, db);
      else wgmma_ss_bf16_n64(acc_s, da, db, 1);
    }
  }
}

// O += P V of one converted V tile, 16 keys a step (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc_o)[D / 2],
                                         const uint32_t (&pa)[Tiles<D>::BKV / 4],
                                         const unsigned char* v_s) {
#pragma unroll
  for (int kk = 0; kk < Tiles<D>::BKV / 16; ++kk)
    wgmma_pv<D>(acc_o, &pa[4 * kk], v_s + kk * 16 * 128);
}

// The online softmax of one S tile, in registers: s * kc[col] (kc =
// k_scale * scale * log2e of this thread's columns), the columns at or
// past lkv masked unless the tile is whole, the new row max (quad
// shuffles), p = exp2(s - m_use) in f32; alpha = exp2(m_old - m_use)
template <int N>
__device__ __forceinline__ void softmax_exp(float (&acc_s)[N],
                                            float (&m)[2], float (&alpha)[2],
                                            bool whole, int col_base, int lkv,
                                            const float* kc) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  if (whole) {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      acc_s[e] = acc_s[e] * kc[acc_col(e)];
      mx[acc_row8(e) / 8] = fmaxf(mx[acc_row8(e) / 8], acc_s[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < N; ++e) {
      const int r = acc_row8(e) / 8;
      acc_s[e] = col_base + acc_col(e) < lkv ? acc_s[e] * kc[acc_col(e)]
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

// l = l * alpha + the f32 p; P * (v_scale / vmax) packed as the fp16 A
// fragment of P V (vr: this thread's columns' ratios); then alpha takes
// O's vmax correction, vmax_prev / vmax (1 on the first tile)
template <int N>
__device__ __forceinline__ void pack_p(const float (&p)[N],
                                       uint32_t (&pa)[N / 2], float (&l)[2],
                                       float (&alpha)[2], const float* vr,
                                       float& vmax_prev, float vmax) {
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int col = acc_col(2 * j);
    psum[j & 1] += p[2 * j] + p[2 * j + 1];
    pa[j] = pack_f16x2(p[2 * j] * vr[col], p[2 * j + 1] * vr[col + 1]);
  }
  const float corr = vmax_prev == 0.f ? 1.f : vmax_prev / vmax;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = l[r] * alpha[r] + psum[r];
    alpha[r] *= corr;
  }
  vmax_prev = vmax;
}

// One consumer warpgroup's rows q0 + 64 wg .. + 63 (this thread owns two)
// over every K/V tile, then the epilogue.  H1's overlap: per tile i, S of
// tile i is issued; O is rescaled by tile i - 1's alpha while it runs; P V
// of tile i - 1 is issued behind it; the softmax of tile i runs while P V
// is in flight; after P V has landed, P of tile i is packed.  PACKED: d %
// 16 != 0, O stored a value at a time where d % 8 != 0
template <int D, bool PACKED>
__device__ __forceinline__ void consume(
    const unsigned char* sq, const unsigned char* sk, const unsigned char* sv,
    const float* sscale, uint64_t* k_full, uint64_t* v_full,
    uint64_t* empty, uint64_t* q_full, void* o,
    int out_f32, int lq, int lkv, int d, int q0, int bh, int n_tiles) {
  using T = Tiles<D>;
  constexpr int BKV = T::BKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  const unsigned char* q_wg = sq + wg * 64 * 128;
  float vmax_prev = 0.f;
  float alpha[2];
  uint32_t pa[BKV / 4];

  mbar_wait(q_full, 0);
  {
    // tile 0 (O is still zero: no rescale)
    float acc_s[BKV / 2];
    mbar_wait(&k_full[0], 0);
    wgmma_fence();
    issue_qk<D>(acc_s, q_wg, sk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_s);
    softmax_exp(acc_s, m, alpha, BKV <= lkv, col0, lkv, sscale + col0);
    mbar_wait(&v_full[0], 0);
    pack_p(acc_s, pa, l, alpha, sscale + BKV + col0, vmax_prev,
           sscale[2 * BKV]);
  }
  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % STAGES, prev = (i - 1) % STAGES;
    const int kv0 = i * BKV;
    const float* sc = sscale + s * T::SCALES;
    float acc_s[BKV / 2];
    mbar_wait(&k_full[s], (i / STAGES) & 1);
    wgmma_fence();
    issue_qk<D>(acc_s, q_wg, sk + s * T::CONV_BYTES);
    wgmma_commit();
    fence_regs(acc_s);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc_o[e] *= alpha[acc_row8(e) / 8];
    fence_regs(acc_o);
    fence_regs(pa);
    wgmma_fence();
    issue_pv<D>(acc_o, pa, sv + prev * T::CONV_BYTES);
    wgmma_commit();
    fence_regs(acc_o);
    fence_regs(pa);
    wgmma_wait<1>();                   // S of tile i
    softmax_exp(acc_s, m, alpha, kv0 + BKV <= lkv, kv0 + col0, lkv,
                sc + col0);
    wgmma_wait<0>();                   // P V of tile i - 1
    fence_regs(acc_o);
    fence_regs(pa);
    mbar_arrive(&empty[prev]);
    mbar_wait(&v_full[s], (i / STAGES) & 1);
    pack_p(acc_s, pa, l, alpha, sc + BKV + col0, vmax_prev, sc[2 * BKV]);
  }
  const int last = (n_tiles - 1) % STAGES;
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_o[e] *= alpha[acc_row8(e) / 8];
  fence_regs(acc_o);
  fence_regs(pa);
  wgmma_fence();
  issue_pv<D>(acc_o, pa, sv + last * T::CONV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc_o);
  fence_regs(pa);
  mbar_arrive(&empty[last]);

#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc_o[e] *= vmax_prev;
  // the first d columns of the two owned rows (d <= D); at d = D inlined
  // apart, with constant strides
  if constexpr (PACKED) {
    if (d % 8 != 0)
      store_o_rows<D, true>(acc_o, l, m, row0, lq, size_t(bh) * lq, o,
                            out_f32, nullptr, d, 0, d);
    else
      store_o_rows<D>(acc_o, l, m, row0, lq, size_t(bh) * lq, o, out_f32,
                      nullptr, d, 0, d);
  } else if (d == D) {
    store_o_rows<D>(acc_o, l, m, row0, lq, size_t(bh) * lq, o, out_f32,
                    nullptr);
  } else {
    store_o_rows<D>(acc_o, l, m, row0, lq, size_t(bh) * lq, o, out_f32,
                    nullptr, d, 0, d);
  }
}

// PACKED: d % 16 != 0, Q and the code tiles copied by the producer's
// threads from qg, kg and vg (tq, tk and tv unused; the instances of the
// multiples of 16 compile without it)
template <int D, int KIND, bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
kvquant_attention_kernel(const __grid_constant__ CUtensorMap tq,  // [BH, Lq, d] bf16
                         const __grid_constant__ CUtensorMap tk,  // [BH, Lkv, d] codes
                         const __grid_constant__ CUtensorMap tv,  // [BH, Lkv, d] codes
                         const float* __restrict__ ks,    // [BH, n_blocks]
                         const float* __restrict__ vs,    // [BH, n_blocks]
                         void* __restrict__ o,            // [BH, Lq, d]
                         int out_f32, int lq, int lkv, int d, int block,
                         int n_blocks, float scale_log2,
                         const __nv_bfloat16* __restrict__ qg,  // [BH, Lq, d]
                         const uint8_t* __restrict__ kg,        // [BH, Lkv, d]
                         const uint8_t* __restrict__ vg) {      // [BH, Lkv, d]
  using T = Tiles<D>;
  constexpr int BKV = T::BKV, SLOTS = T::SLOTS;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* sq = smem + T::q;
  unsigned char* sk = smem + T::k;
  unsigned char* sv = smem + T::v;
  unsigned char* scodes = smem + T::codes;
  float* sscale = reinterpret_cast<float*>(smem + T::scales);
  uint64_t* code_full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* k_full = code_full + SLOTS;     // K converted, its scales written
  uint64_t* v_full = k_full + STAGES;       // V converted, its scales written
  uint64_t* empty = v_full + STAGES;        // the stage consumed
  uint64_t* q_full = empty + STAGES;

  // blockIdx.x runs over the Q tiles of one head first (K and V shared in
  // L2 by the blocks in flight)
  const int n_qt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * BQ;
  const int warp = threadIdx.x / 32;
  const int n_tiles = (lkv + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) mbar_init(&code_full[s], 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], CONVERTERS);
      mbar_init(&v_full[s], CONVERTERS);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_init(q_full, PACKED ? CONVERTERS : 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer warpgroup: its first thread issues the TMA loads (Q,
    // then the code tiles K_0, V_0, K_1, ... through the slots; PACKED:
    // all 128 threads copy them); all 128 threads convert each code tile, K to bf16 with its keys' K factors,
    // V to fp16 with its V ratios and vmax, and agree (a named barrier)
    // that the slot is read before its next load is issued
    setmaxnreg_dec<PRODUCER_REGS>();
    const int ct = threadIdx.x - CONSUMERS * 128;
    const float* ksb = ks + size_t(bh) * n_blocks;
    const float* vsb = vs + size_t(bh) * n_blocks;
    auto load_codes = [&](int j) {
      const int slot = j % SLOTS;
      mbar_arrive_expect_tx(&code_full[slot], T::CODE_BYTES);
      tma_load_3d(scodes + slot * T::CODE_BYTES, (j & 1) ? &tv : &tk,
                  &code_full[slot], 0, (j / 2) * BKV, bh);
    };
    // PACKED: this thread's pieces of code tile j (K_i or V_i), one
    // cp.async group, zeros past d and past Lkv
    auto stage_codes = [&](int j) {
      const int kv0 = (j / 2) * BKV;
      const uint8_t* src = ((j & 1) ? vg : kg) + (size_t(bh) * lkv + kv0) * d;
      const uint32_t dst = smem_u32(scodes + (j % SLOTS) * T::CODE_BYTES);
      const int al = row_align(d);
      for (int e = ct; e < BKV * (D / 16); e += CONVERTERS) {
        const int r = e / (D / 16), c = (e % (D / 16)) * 16;
        stage16(dst + r * D + c, src + size_t(r) * d + c, al,
                kv0 + r < lkv ? d - c : 0);
      }
      cp_async_commit();
    };
    if constexpr (PACKED) {
      // Q's rows, a row a thread (BQ = CONVERTERS), 8 columns a piece
      // into its 64-column boxes, handed over at once; then the first
      // SLOTS code tiles, a group each (empty past the last)
      const __nv_bfloat16* q_row = qg + (size_t(bh) * lq + q0 + ct) * d;
      const int q_al = row_align(2 * d);
#pragma unroll 1
      for (int c = 0; c < D; c += 8)
        stage16(smem_u32(sq) + (c / 64) * BQ * 128 + swz128(ct, (c % 64) * 2),
                q_row + c, q_al, q0 + ct < lq ? 2 * (d - c) : 0);
      cp_async_commit();
      hand_over(smem_u32(q_full), true);
      for (int j = 0; j < SLOTS; ++j) {
        if (j < 2 * n_tiles) stage_codes(j);
        else cp_async_commit();
      }
    } else if (ct == 0) {
      mbar_arrive_expect_tx(q_full, T::Q_BYTES);
      for (int x = 0; x < T::NBOX; ++x)
        tma_load_3d(sq + x * BQ * 128, &tq, q_full, x * 64, q0, bh);
      for (int j = 0; j < SLOTS && j < 2 * n_tiles; ++j) load_codes(j);
    }
    for (int j = 0; j < 2 * n_tiles; ++j) {
      const int i = j / 2, s = i % STAGES, slot = j % SLOTS;
      const int kv0 = i * BKV;
      float* sc = sscale + s * T::SCALES;
      const unsigned char* src = scodes + slot * T::CODE_BYTES;
      if ((j & 1) == 0) mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      if constexpr (PACKED) {
        cp_async_wait<SLOTS - 1>();            // this thread's copies of tile j
        named_bar_sync(SLOT_BAR, CONVERTERS);  // and every thread's
      } else {
        mbar_wait(&code_full[slot], (j / SLOTS) & 1);
      }
      if ((j & 1) == 0) {
        convert_codes_tile<KIND, false, D>(src, sk + s * T::CONV_BYTES, BKV,
                                           ct, CONVERTERS);
        for (int t = ct; t < BKV; t += CONVERTERS) {
          const int key = kv0 + t;
          sc[t] = key < lkv ? ksb[key / block] * scale_log2 : 0.f;
        }
      } else {
        convert_codes_tile<KIND, true, D>(src, sv + s * T::CONV_BYTES, BKV,
                                          ct, CONVERTERS);
        const int end = min(kv0 + BKV, lkv);
        float vmax = 0.f;
        for (int b = kv0 / block; b * block < end; ++b)
          vmax = fmaxf(vmax, vsb[b]);
        for (int t = ct; t < BKV; t += CONVERTERS) {
          const int key = kv0 + t;
          sc[BKV + t] = key < lkv ? vsb[key / block] / vmax : 0.f;
        }
        if (ct == 0) sc[2 * BKV] = vmax;
      }
      fence_proxy_async();
      mbar_arrive((j & 1) ? &v_full[s] : &k_full[s]);
      named_bar_sync(SLOT_BAR, CONVERTERS);
      if constexpr (PACKED) {
        if (j + SLOTS < 2 * n_tiles) stage_codes(j + SLOTS);
        else cp_async_commit();
      } else if (ct == 0 && j + SLOTS < 2 * n_tiles) {
        load_codes(j + SLOTS);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  consume<D, PACKED>(sq, sk, sv, sscale, k_full, v_full, empty, q_full, o,
                     out_f32, lq, lkv, d, q0, bh, n_tiles);
}

template <int D, int KIND, bool PACKED>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* o, int out_f32, int bh, int lq, int lkv,
           int d, int block, int n_blocks, float scale_log2,
           cudaStream_t stream) {
  using T = Tiles<D>;
  // boxes of D columns (Q: D / 64 boxes of 64) over rows of the true d:
  // the columns past d arrive as zeros.  PACKED: no tensor map takes the
  // rows; the kernel copies them
  CUtensorMap tq = {}, tk = {}, tv = {};
  if constexpr (!PACKED) {
    int err = make_tmap(&tq, q, 2, d, lq, bh, 64, BQ, 128);
    if (!err) err = make_tmap(&tk, k, 1, d, lkv, bh, D, T::BKV, 0);
    if (!err) err = make_tmap(&tv, v, 1, d, lkv, bh, D, T::BKV, 0);
    if (err) return err;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      kvquant_attention_kernel<D, KIND, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(bh * ((lq + BQ - 1) / BQ));
  kvquant_attention_kernel<D, KIND, PACKED>
      <<<grid, THREADS, T::bytes, stream>>>(
          tq, tk, tv, static_cast<const float*>(ks),
          static_cast<const float*>(vs), o, out_f32, lq, lkv, d, block,
          n_blocks, scale_log2, static_cast<const __nv_bfloat16*>(q),
          static_cast<const uint8_t*>(k), static_cast<const uint8_t*>(v));
  return int(cudaGetLastError());
}

// ------------------------------------------------------------ f32 q
// H4-kvq at f32 q, as B16 and B17 compute for it (compute_dtype f32,
// ops/attention_kvquant.py:196): the codes cast exactly to f32, S = q k in
// f32 scaled by scale * k_scale, p in f32, P V in f32 times v_scale.  On
// the f32 core (f32_attention.cuh) with one piece of K and V: the codes are
// exact in bf16, so S = Q K^T and P V are three bf16 products each (the
// pieces of q, and of P * v_scale, against the codes; bf16x3), exact f32
// products.  One block per (batch*head, BQ-row Q tile), the Q tiles of a
// head next to each other in the grid; 32-key tiles.  The producer reads
// each tile's codes from global memory, converts them exactly to bf16 and
// writes per key kc = k_scale[key / block] * scale * log2(e) and vs =
// v_scale[key / block], both zero at or past Lkv, where the keys are
// zero-filled and masked to -inf.  P * v_scale stays f32 until it is split
// (B16 multiplies the f32 P V by v_scale per block, :99-106; per key the
// same product up to f32 rounding), and l sums the unscaled p.  Shared
// memory at D=128: Q pieces 96 KB, two stages of 32 keys 16 KB, 128 KB; at
// D=256 one consumer warpgroup of 64 rows (f32_attention.cuh), Q pieces 96
// KB, 160 KB.  A d below D is read as zeros past its columns.
template <int D, int KIND>
__global__ void __launch_bounds__(eft::f32::Tiles<D, 1>::THREADS, 1)
kvquant_attention_f32_kernel(const float* __restrict__ q,     // [BH, Lq, d]
                             const uint8_t* __restrict__ k,   // [BH, Lkv, d]
                             const uint8_t* __restrict__ v,   // [BH, Lkv, d]
                             const float* __restrict__ ks,    // [BH, nb]
                             const float* __restrict__ vs,    // [BH, nb]
                             void* __restrict__ o,            // [BH, Lq, d]
                             int out_f32, int lq, int lkv, int d, int block,
                             int n_blocks, float scale_log2) {
  namespace F = eft::f32;
  using T = F::Tiles<D, 1>;
  constexpr int BKV = T::BKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* empty = full + T::STAGES;
  const int n_qt = (lq + T::BQ - 1) / T::BQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * T::BQ;
  const int n_tiles = (lkv + BKV - 1) / BKV;
  F::init_bars<D, 1>(full);
  const int warp = threadIdx.x / 32;

  if (warp >= T::NC * 4) {
    // the producer: each thread CH 16-code pieces of K and of V a tile
    constexpr int CH = BKV * (D / 16) / 128;
    struct Regs { uint4 k[CH], v[CH]; int kv0; };
    const int ct = threadIdx.x - T::NC * 128;
    const size_t head = size_t(bh) * lkv;
    const float* ksb = ks + size_t(bh) * n_blocks;
    const float* vsb = vs + size_t(bh) * n_blocks;
    const int al = row_align(d);
    auto fetch = [&](int i, Regs& x) {
      x.kv0 = i * BKV;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int e = ct + 128 * j, r = e / (D / 16), ch = e % (D / 16);
        x.k[j] = x.v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (x.kv0 + r < lkv && 16 * ch < d) {
          // rows of d bytes: 16-byte loads at d % 16 == 0 (al = 16)
          const size_t at = (head + x.kv0 + r) * d + 16 * ch;
          x.k[j] = load16_al(k + at, al, d - 16 * ch);
          x.v[j] = load16_al(v + at, al, d - 16 * ch);
        }
      }
    };
    auto put = [&](const Regs& x, unsigned char* sk, unsigned char* sv,
                   float* kc, float* vsc) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int e = ct + 128 * j, r = e / (D / 16), ch = e % (D / 16);
        unsigned char* dst[2] = {sk, sv};
        const uint4 in[2] = {x.k[j], x.v[j]};
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          uint32_t w[8];
          codes16_convert<KIND, false>(in[kv], w);
          unsigned char* box = dst[kv] + (ch / 4) * BKV * 128;
          const int byte = (ch % 4) * 32;
          *reinterpret_cast<uint4*>(box + swz128(r, byte)) =
              make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(box + swz128(r, byte + 16)) =
              make_uint4(w[4], w[5], w[6], w[7]);
        }
      }
      if (ct < BKV) {
        const int key = x.kv0 + ct;
        const bool in = key < lkv;
        kc[ct] = in ? ksb[key / block] * scale_log2 : 0.f;
        vsc[ct] = in ? vsb[key / block] : 0.f;
      }
    };
    F::produce<D, 1, Regs>(smem, full, empty, n_tiles, fetch, put);
    return;
  }

  // a consumer warpgroup: rows q0 + 64 wg .. + 63, this thread two of
  // them, each seeing keys [0, Lkv)
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int lo[2] = {0, 0};
  const int hi[2] = {row0 < lq ? lkv - 1 : -1, row0 + 8 < lq ? lkv - 1 : -1};
  F::stage_q<D, 1>(smem + T::q, wg, [&](int r) {
    const int row = q0 + wg * 64 + r;
    return row < lq ? q + (size_t(bh) * lq + row) * d : nullptr;
  }, d);
  float acc_o[D / 2], m[2], l[2];
  F::attend<D, 1, false, true>(smem, wg, full, empty, 0, n_tiles, lo, hi,
                               acc_o, m, l);
  // a value at a time where d % 8 != 0
  if (d % 8 != 0)
    store_o_rows<D, true>(acc_o, l, m, row0, lq, size_t(bh) * lq, o,
                          out_f32, nullptr, d, 0, d);
  else
    store_o_rows<D>(acc_o, l, m, row0, lq, size_t(bh) * lq, o, out_f32,
                    nullptr, d, 0, d);
}

template <int D, int KIND>
int launch_f32(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, void* o, int out_f32, int bh, int lq, int lkv,
               int d, int block, int n_blocks, float scale_log2,
               cudaStream_t stream) {
  using T = eft::f32::Tiles<D, 1>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kvquant_attention_f32_kernel<D, KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(bh * ((lq + T::BQ - 1) / T::BQ));
  kvquant_attention_f32_kernel<D, KIND><<<grid, T::THREADS, T::bytes,
                                          stream>>>(
      static_cast<const float*>(q), static_cast<const uint8_t*>(k),
      static_cast<const uint8_t*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), o, out_f32, lq, lkv, d, block,
      n_blocks, scale_log2);
  return int(cudaGetLastError());
}

template <int D>
int launch_kind(int kv_kind, int q_f32, const void* q, const void* k,
                const void* v, const void* ks, const void* vs, void* o,
                int out_f32, int bh, int lq, int lkv, int d, int block,
                int n_blocks, float scale_log2, cudaStream_t stream) {
  if (q_f32 && kv_kind == KV_INT8)
    return launch_f32<D, KV_INT8>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv,
                                  d, block, n_blocks, scale_log2, stream);
  if (q_f32)
    return launch_f32<D, KV_FP8>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv,
                                 d, block, n_blocks, scale_log2, stream);
  auto go = [&](auto kind, auto packed) {
    return launch<D, decltype(kind)::value, decltype(packed)::value>(
        q, k, v, ks, vs, o, out_f32, bh, lq, lkv, d, block, n_blocks,
        scale_log2, stream);
  };
  using Int8 = std::integral_constant<int, KV_INT8>;
  using Fp8 = std::integral_constant<int, KV_FP8>;
  if (d % 16 != 0)
    return kv_kind == KV_INT8 ? go(Int8{}, std::true_type{})
                              : go(Fp8{}, std::true_type{});
  return kv_kind == KV_INT8 ? go(Int8{}, std::false_type{})
                            : go(Fp8{}, std::false_type{});
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_kvquant.py has already checked shapes, dtypes, contiguity
// and alignment; the checks here only refuse what would index out of
// bounds.  d: from 1 to 256, on the instance D = 64, 128 or 256 (the
// smallest D >= d; the PACKED one at d % 16 != 0); kv_kind: 1 int8, 2 e4m3; scale_log2 =
// softmax scale * log2(e) (the scale of the true d); q_f32: 0 for bf16 q, 1
// for f32 (the f32 core, bf16x3).
extern "C" int eft_kvquant_attention(const void* q, const void* k,
                                     const void* v, const void* ks,
                                     const void* vs, void* o, int batch,
                                     int heads, int lq, int lkv, int d,
                                     int block, int n_blocks, int kv_kind,
                                     int out_f32, float scale_log2,
                                     int q_f32, int device, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lkv <= 0 || block <= 0 ||
      n_blocks != (lkv + block - 1) / block ||
      (kv_kind != KV_INT8 && kv_kind != KV_FP8) ||
      (q_f32 != 0 && q_f32 != 1) || d < 1 || d > 256)
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto go = [&](auto dc) {
    return launch_kind<decltype(dc)::value>(
        kv_kind, q_f32, q, k, v, ks, vs, o, out_f32, batch * heads, lq, lkv,
        d, block, n_blocks, scale_log2, s);
  };
  if (d <= 64) return go(std::integral_constant<int, 64>{});
  if (d <= 128) return go(std::integral_constant<int, 128>{});
  return go(std::integral_constant<int, 256>{});
}
