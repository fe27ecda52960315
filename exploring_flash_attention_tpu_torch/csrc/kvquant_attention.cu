// H4-kvq: the attention forward over a quantized K/V on Hopper (sm_90a).
// bf16 Q, int8 or e4m3 K and V with one f32 scale per `block` keys,
// non-causal, f32 accumulate, bf16 or f32 O.
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
// tile's product is multiplied by its vmax, now per 128-key tile.  vmax
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma_tile.cuh"

namespace {

using namespace eft::hopper;

constexpr int BQ = 128;          // Q rows per block
constexpr int BKV = 128;         // keys per K/V tile
constexpr int STAGES = 2;        // converted K/V stages
constexpr int SLOTS = 3;         // code slots, K and V tiles in turn
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
// 16-bit columns (128-byte rows, the swizzle width) by 128 rows, box after
// box; a code slot is a plain [128][D] tile of one-byte codes.  Each stage's
// scales: k_scale * scale * log2e per key, v_scale / vmax per key, vmax.
template <int D>
struct Tiles {
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
};

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], const uint32_t* a,
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_f16_n128(o, a[0], a[1], a[2], a[3], db, 1);
  else
    wgmma_rs_f16_n64(o, a[0], a[1], a[2], a[3], db, 1);
}

// S = Q K^T of one converted K tile (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_qk(float (&acc_s)[BKV / 2],
                                         const unsigned char* q_wg,
                                         const unsigned char* k_s) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk / 4, off = (kk % 4) * 32;
    const uint64_t da = gmma_desc(q_wg + box * BQ * 128 + off, 16, 1024, 128);
    const uint64_t db = gmma_desc(k_s + box * BKV * 128 + off, 16, 1024, 128);
    if (kk == 0) wgmma_ss_bf16_n128_first(acc_s, da, db);
    else wgmma_ss_bf16_n128(acc_s, da, db, 1);
  }
}

// O += P V of one converted V tile, 16 keys a step (issued, not waited for)
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc_o)[D / 2],
                                         const uint32_t (&pa)[BKV / 4],
                                         const unsigned char* v_s) {
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk)
    wgmma_pv<D>(acc_o, &pa[4 * kk],
                gmma_desc(v_s + kk * 16 * 128, BKV * 128, 1024, 128));
}

// The online softmax of one S tile, in registers: s * kc[col] (kc =
// k_scale * scale * log2e of this thread's columns), the columns at or
// past lkv masked unless the tile is whole, the new row max (quad
// shuffles), p = exp2(s - m_use) in f32; alpha = exp2(m_old - m_use)
__device__ __forceinline__ void softmax_exp(float (&acc_s)[BKV / 2],
                                            float (&m)[2], float (&alpha)[2],
                                            bool whole, int col_base, int lkv,
                                            const float* kc) {
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
  if (whole) {
#pragma unroll
    for (int e = 0; e < BKV / 2; ++e) {
      acc_s[e] = acc_s[e] * kc[acc_col(e)];
      mx[acc_row8(e) / 8] = fmaxf(mx[acc_row8(e) / 8], acc_s[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < BKV / 2; ++e) {
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
  for (int e = 0; e < BKV / 2; ++e)
    acc_s[e] = exp2_approx(acc_s[e] - m_use[acc_row8(e) / 8]);
}

// l = l * alpha + the f32 p; P * (v_scale / vmax) packed as the fp16 A
// fragment of P V (vr: this thread's columns' ratios); then alpha takes
// O's vmax correction, vmax_prev / vmax (1 on the first tile)
__device__ __forceinline__ void pack_p(const float (&p)[BKV / 2],
                                       uint32_t (&pa)[BKV / 4], float (&l)[2],
                                       float (&alpha)[2], const float* vr,
                                       float& vmax_prev, float vmax) {
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BKV / 4; ++j) {
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
// is in flight; after P V has landed, P of tile i is packed.
template <int D>
__device__ __forceinline__ void consume(
    const unsigned char* sq, const unsigned char* sk, const unsigned char* sv,
    const float* sscale, uint64_t* k_full, uint64_t* v_full,
    uint64_t* empty, uint64_t* q_full, void* o,
    int out_f32, int lq, int lkv, int q0, int bh, int n_tiles) {
  using T = Tiles<D>;
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
  store_o_rows<D>(acc_o, l, m, row0, lq, size_t(bh) * lq, o, out_f32,
                  nullptr);
}

template <int D, int KIND>
__global__ void __launch_bounds__(THREADS, 1)
kvquant_attention_kernel(const __grid_constant__ CUtensorMap tq,  // [BH, Lq, D] bf16
                         const __grid_constant__ CUtensorMap tk,  // [BH, Lkv, D] codes
                         const __grid_constant__ CUtensorMap tv,  // [BH, Lkv, D] codes
                         const float* __restrict__ ks,    // [BH, n_blocks]
                         const float* __restrict__ vs,    // [BH, n_blocks]
                         void* __restrict__ o,            // [BH, Lq, D]
                         int out_f32, int lq, int lkv, int block,
                         int n_blocks, float scale_log2) {
  using T = Tiles<D>;
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
    mbar_init(q_full, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer warpgroup: its first thread issues the TMA loads (Q,
    // then the code tiles K_0, V_0, K_1, ... through the slots); all 128
    // threads convert each code tile, K to bf16 with its keys' K factors,
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
    if (ct == 0) {
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
      mbar_wait(&code_full[slot], (j / SLOTS) & 1);
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
      if (ct == 0 && j + SLOTS < 2 * n_tiles) load_codes(j + SLOTS);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  consume<D>(sq, sk, sv, sscale, k_full, v_full, empty, q_full, o, out_f32,
             lq, lkv, q0, bh, n_tiles);
}

template <int D, int KIND>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* o, int out_f32, int bh, int lq, int lkv,
           int block, int n_blocks, float scale_log2, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap tq, tk, tv;
  int err = make_tmap(&tq, q, 2, D, lq, bh, 64, BQ, 128);
  if (!err) err = make_tmap(&tk, k, 1, D, lkv, bh, D, BKV, 0);
  if (!err) err = make_tmap(&tv, v, 1, D, lkv, bh, D, BKV, 0);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      kvquant_attention_kernel<D, KIND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const dim3 grid(bh * ((lq + BQ - 1) / BQ));
  kvquant_attention_kernel<D, KIND><<<grid, THREADS, T::bytes, stream>>>(
      tq, tk, tv, static_cast<const float*>(ks),
      static_cast<const float*>(vs), o, out_f32, lq, lkv, block, n_blocks,
      scale_log2);
  return int(cudaGetLastError());
}

template <int D>
int launch_kind(int kv_kind, const void* q, const void* k, const void* v,
                const void* ks, const void* vs, void* o, int out_f32, int bh,
                int lq, int lkv, int block, int n_blocks, float scale_log2,
                cudaStream_t stream) {
  if (kv_kind == KV_INT8)
    return launch<D, KV_INT8>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, block,
                              n_blocks, scale_log2, stream);
  return launch<D, KV_FP8>(q, k, v, ks, vs, o, out_f32, bh, lq, lkv, block,
                           n_blocks, scale_log2, stream);
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_kvquant.py has already checked shapes, dtypes, contiguity
// and alignment; the checks here only refuse what would index out of
// bounds.  kv_kind: 1 int8, 2 e4m3; scale_log2 = softmax scale * log2(e).
extern "C" int eft_kvquant_attention(const void* q, const void* k,
                                     const void* v, const void* ks,
                                     const void* vs, void* o, int batch,
                                     int heads, int lq, int lkv, int d,
                                     int block, int n_blocks, int kv_kind,
                                     int out_f32, float scale_log2,
                                     int device, void* stream) {
  if (batch <= 0 || heads <= 0 || lq <= 0 || lkv <= 0 || block <= 0 ||
      n_blocks != (lkv + block - 1) / block ||
      (kv_kind != KV_INT8 && kv_kind != KV_FP8))
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch_kind<64>(kv_kind, q, k, v, ks, vs, o, out_f32,
                             batch * heads, lq, lkv, block, n_blocks,
                             scale_log2, s);
    case 128:
      return launch_kind<128>(kv_kind, q, k, v, ks, vs, o, out_f32,
                              batch * heads, lq, lkv, block, n_blocks,
                              scale_log2, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
