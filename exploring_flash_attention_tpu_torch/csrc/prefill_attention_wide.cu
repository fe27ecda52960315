// H1 past d 256: eft_prefill_attention's bf16 launch at head dims d from
// 257 to 512 (prefill_attention.cu takes d up to 256 on its own block and
// calls launch_wide above it).  It computes H1's function (the TPU kernels
// B1-B5, B8 and B9 that prefill_attention.cu names) with every option H1
// has: none, causal and window masks at a static diagonal or at traced
// positions (the int32 pair each block reads), the natural-log LSE, KV
// spans (a third grid axis of whole 128-key spans writing [B, Hq, nkb, Lq,
// d] partials), the bound statistic, bf16 or f32 O, any GQA group.
//
// The block is wide_attention.cuh's (H5's, with the masks and the LSE): 64
// Q rows, NC = 3 or 4 consumer warpgroups of 128 O columns, 64-key K/V
// tiles in 64 x 128 chunks through a ring of eight 16 KB slots.  H1's
// q_rows (64 or 128) selects nothing here: every call runs 64-row tiles,
// which leaves the result unchanged (each row meets the same key tiles in
// the same order).  P = bf16(p) and l sums the rounded P, as H1 rounds it.
// The producer warpgroup's first thread loads the Q tile and the chunks by
// TMA (q, k, v described with their true d, so the columns past d arrive
// as zeros); rows no tensor map takes (d % 8 != 0: a row of 2d bytes) are
// copied by all 128 producer threads in the STAGED instances, as H5's
// STAGED producer copies them (wgmma_tile.cuh stage16: cp.async pieces of
// the rows' alignment, zeros past d and past the keys).  Tiles outside
// every row's band are never loaded: a causal block stops at the tile of
// its last row's last key, a window starts at the tile of its first row's
// first key, as H1's blocks do.
//
// Cost at B=4, H=8, L=1024, d=512, no mask: 68.7 GFLOP, 0.069 ms at 989
// TFLOP/s bf16 against 134 MB of Q, K, V and O (0.040 ms at 3.35 TB/s):
// the tensor cores, as H5 at that shape, plus the LSE's 128 KB.

#include "prefill_attention.cuh"
#include "wide_attention.cuh"

namespace {

using eft::prefill::BOUND_ROWS;
using eft::prefill::MASK_NONE;
using eft::prefill::MASK_WINDOW;
using eft::prefill::SPAN_TILE;
using eft::prefill::clamp64;

// The producer warpgroup of H1's wide block (thread pt of 128): the Q
// tile of q head bh once, then the K and V chunks of KV head bhk, tiles
// [kv_begin, kv_begin + 64 n_tiles), into the ring.  TMA: the first thread
// issues every load.  STAGED: every thread copies its pieces of each chunk
// from qg, kg, vg and hands it over once the next one's copies are issued
template <int NC, bool STAGED>
__device__ __forceinline__ void produce_wide(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    unsigned char* smem, Bars<NC, KV_BF16>* bars, int bh, int bhk, int q0,
    int lq, int lkv, int d, int kv_begin, int n_tiles,
    const __nv_bfloat16* qg, const __nv_bfloat16* kg,
    const __nv_bfloat16* vg) {
  using C = Cfg<NC, KV_BF16>;
  const int pt = threadIdx.x - NC * 128;
  if constexpr (STAGED) {
    const int al = row_align(2 * d);
    const __nv_bfloat16* q_rows = qg + (size_t(bh) * lq + q0) * d;
    for (int e = pt; e < BQ * (C::D / 8); e += 128) {
      const int r = e / (C::D / 8), c = (e % (C::D / 8)) * 8;
      stage16(smem_u32(smem + C::q) + (c / 64) * BQ * 128 +
                  swz128(r, (c % 64) * 2),
              q_rows + size_t(r) * d + c, al,
              q0 + r < lq ? 2 * (d - c) : 0);
    }
    cp_async_commit();
    hand_over(smem_u32(&bars->q_full), true);
    for (int i = 0; i < n_tiles; ++i) {
      const int kv0 = kv_begin + i * BKV;
      for (int u = 0; u < 2 * NC; ++u) {
        const int j = item<NC>(i, u), col = (u % NC) * DC;
        const __nv_bfloat16* src =
            (u < NC ? kg : vg) + (size_t(bhk) * lkv + kv0) * d + col;
        mbar_wait(&bars->chunk_empty[j % C::SLOTS],
                  ((j / C::SLOTS) & 1) ^ 1);
        const uint32_t dst =
            smem_u32(smem + C::chunks + (j % C::SLOTS) * C::CHUNK_BYTES);
        for (int e = pt; e < BKV * (DC / 8); e += 128) {
          const int r = e / (DC / 8), c = (e % (DC / 8)) * 8;
          stage16(dst + (c / 64) * BKV * 128 + swz128(r, (c % 64) * 2),
                  src + size_t(r) * d + c, al,
                  kv0 + r < lkv ? 2 * (d - col - c) : 0);
        }
        cp_async_commit();
        if (j > 0)
          hand_over(smem_u32(&bars->chunk_full[(j - 1) % C::SLOTS]), false);
      }
    }
    hand_over(smem_u32(&bars->chunk_full[(n_tiles * 2 * NC - 1) % C::SLOTS]),
              true);
  } else if (pt == 0) {
    mbar_arrive_expect_tx(&bars->q_full, C::Q_BYTES);
    for (int x = 0; x < 2 * NC; ++x)
      tma_load_3d(smem + C::q + x * BQ * 128, tq, &bars->q_full, x * 64, q0,
                  bh);
    for (int i = 0; i < n_tiles; ++i) {
      const int kv0 = kv_begin + i * BKV;
      for (int u = 0; u < 2 * NC; ++u) {
        const int j = item<NC>(i, u), s = j % C::SLOTS;
        const int col = (u % NC) * DC;
        const CUtensorMap* map = u < NC ? tk : tv;
        mbar_wait(&bars->chunk_empty[s], ((j / C::SLOTS) & 1) ^ 1);
        mbar_arrive_expect_tx(&bars->chunk_full[s], C::CHUNK_BYTES);
        unsigned char* dst = smem + C::chunks + s * C::CHUNK_BYTES;
        tma_load_3d(dst, map, &bars->chunk_full[s], col, kv0, bhk);
        tma_load_3d(dst + BKV * 128, map, &bars->chunk_full[s], col + 64,
                    kv0, bhk);
      }
    }
  }
}

template <int NC, bool BOUND, bool STAGED>
__global__ void __launch_bounds__(Cfg<NC, KV_BF16>::THREADS, 1)
prefill_attention_wide_kernel(
    const __grid_constant__ CUtensorMap tq,  // [B*Hq, Lq, d]
    const __grid_constant__ CUtensorMap tk,  // [B*Hkv, Lkv, d]
    const __grid_constant__ CUtensorMap tv,  // [B*Hkv, Lkv, d]
    void* __restrict__ o,                    // [B, Hq, nkb, Lq, d]
    int out_f32, float* __restrict__ lse,    // [B, Hq, nkb, Lq] or null
    int hq, int group, int lq, int lkv, int mask, int diag_off, int window,
    const int* __restrict__ offs,            // (q_pos0, kv_pos0) or null
    int kv_span, float scale_log2,
    const float* __restrict__ kmax,          // the bound form's, or null
    int d, const __nv_bfloat16* __restrict__ qg,  // STAGED: q, k, v
    const __nv_bfloat16* __restrict__ kg,
    const __nv_bfloat16* __restrict__ vg) {
  using C = Cfg<NC, KV_BF16>;
  // traced offsets: the diagonal comes from device memory, not the host
  if (offs != nullptr) diag_off = offs[0] - offs[1];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto* bars = reinterpret_cast<Bars<NC, KV_BF16>*>(smem + C::bars);

  // the Q tiles of a head next to each other, the last first (under a
  // causal mask it holds the most work)
  const int n_qt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int bhk = (bh / hq) * (hq / group) + (bh % hq) / group;   // GQA
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * BQ;
  const int wg = threadIdx.x / 128;

  // the key tiles [kv_begin, kv_end) of this block's span that some row of
  // the Q tile sees (prefill_attention.cu's bounds, 64-key tiles)
  const int span0 = blockIdx.z * kv_span;
  int kv_begin = span0, kv_end = min(lkv, span0 + kv_span);
  if (mask != MASK_NONE) {
    const long long q_last = min(q0 + BQ, lq) - 1;
    kv_end = min(kv_end, int(clamp64(q_last + diag_off + 1, 0, lkv)));
  }
  if (mask == MASK_WINDOW) {
    const long long first = (long long)q0 + diag_off - window + 1;
    kv_begin = max(kv_begin, int(clamp64(first, 0, lkv)) / BKV * BKV);
  }
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;

  wide_init<NC, KV_BF16>(bars, STAGED ? 128 : 1, STAGED ? 128 : 1);

  if (wg == NC) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (n_tiles > 0)
      produce_wide<NC, STAGED>(&tq, &tk, &tv, smem, bars, bh, bhk, q0, lq,
                               lkv, d, kv_begin, n_tiles, qg, kg, vg);
    return;
  }
  const int lane = threadIdx.x % 32;
  const int rl = threadIdx.x / 32 % 4 * 16 + lane / 4;
  const size_t base = (size_t(bh) * gridDim.z + blockIdx.z) * lq;
  float acc_o[DC / 2], l[2];
  if (wg == 0) {
    setmaxnreg_inc<C::WG0_REGS>();
    // each owned row sees keys [lo, hi]; every row of the block at least
    // [lo_last, hi_first] (the last row's window edge, the first row's
    // diagonal), computed in 64 bits
    Band band;
    band.lo_last = 0;
    band.hi_first = lkv - 1;
    if (mask != MASK_NONE) {
      const long long first = (long long)q0 + diag_off;
      band.hi_first = int(clamp64(first, -1, lkv - 1));
      if (mask == MASK_WINDOW)
        band.lo_last = int(clamp64(first + BQ - 1 - window + 1, 0, lkv));
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      band.lo[r] = 0;
      band.hi[r] = lkv - 1;
      if (mask != MASK_NONE) {
        const long long last = (long long)q0 + rl + 8 * r + diag_off;
        band.hi[r] = int(clamp64(last, -1, lkv - 1));
        if (mask == MASK_WINDOW)
          band.lo[r] = int(clamp64(last - window + 1, 0, lkv));
      }
    }
    // the bound form's |k|^2 statistic, read as prefill_attention.cu reads
    // it: the prefix maximum at the last 128-key tile that the last row of
    // this block's 128-row group sees
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
    float m[2];
    wide_first<NC, KV_BF16, BOUND>(smem, bars, kv_begin, n_tiles, band,
                                   scale_log2, kmax2, acc_o, m, l);
    if (d % 8 != 0)
      store_o_rows<DC, true>(acc_o, l, m, q0 + rl, lq, base, o, out_f32, lse,
                             d, 0, d);
    else
      store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, base, o, out_f32, lse, d, 0,
                       d);
    return;
  }
  if constexpr (C::OTHER_REGS > 0) setmaxnreg_inc<C::OTHER_REGS>();
  wide_chunk<NC, KV_BF16>(smem, bars, n_tiles, acc_o, l);
  const float m[2] = {0.f, 0.f};
  const int col = wg * DC;
  if (d % 8 != 0)
    store_o_rows<DC, true>(acc_o, l, m, q0 + rl, lq, base, o, out_f32,
                           nullptr, d, col, d - col);
  else
    store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, base, o, out_f32, nullptr, d,
                     col, d - col);
}

template <int NC, bool BOUND, bool STAGED>
int launch_h1_wide(const void* q, const void* k, const void* v, void* o,
                   int out_f32, void* lse, int batch, int hq, int hkv,
                   int lq, int lkv, int d, int mask, int diag_off,
                   int window, const int* offs, int kv_span, float scale,
                   const float* kmax, cudaStream_t stream) {
  using C = Cfg<NC, KV_BF16>;
  CUtensorMap tq = {}, tk = {}, tv = {};
  if constexpr (!STAGED) {
    int err = make_tmap(&tq, q, 2, d, lq, batch * hq, 64, BQ, 128);
    if (!err) err = make_tmap(&tk, k, 2, d, lkv, batch * hkv, 64, BKV, 128);
    if (!err) err = make_tmap(&tv, v, 2, d, lkv, batch * hkv, 64, BKV, 128);
    if (err) return err;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      prefill_attention_wide_kernel<NC, BOUND, STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (attr != cudaSuccess) return int(attr);
  // no span: one span of whole 128-key tiles covering the KV
  const int span =
      kv_span ? kv_span : (lkv + SPAN_TILE - 1) / SPAN_TILE * SPAN_TILE;
  const dim3 grid(batch * hq * ((lq + BQ - 1) / BQ), 1,
                  (lkv + span - 1) / span);
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  prefill_attention_wide_kernel<NC, BOUND, STAGED>
      <<<grid, C::THREADS, C::bytes, stream>>>(
          tq, tk, tv, o, out_f32, static_cast<float*>(lse), hq, hq / hkv, lq,
          lkv, mask, diag_off, window, offs, span,
          scale * 1.4426950408889634f, kmax, d, qb,
          static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v));
  return int(cudaGetLastError());
}

}  // namespace

namespace eft {
namespace prefill {

int launch_wide(const void* q, const void* k, const void* v, void* o,
                int out_f32, void* lse, int batch, int hq, int hkv, int lq,
                int lkv, int d, int mask, int diag_off, int window,
                const int* offs, int kv_span, float scale, const float* kmax,
                cudaStream_t stream) {
  if (int64_t(batch) * hq * ((lq + BQ - 1) / BQ) > INT32_MAX)
    return int(cudaErrorInvalidValue);
  auto go = [&](auto nc, auto bound, auto staged) {
    return launch_h1_wide<decltype(nc)::value, decltype(bound)::value,
                          decltype(staged)::value>(
        q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv, d, mask, diag_off,
        window, offs, kv_span, scale, kmax, stream);
  };
  auto by_form = [&](auto nc) {
    using T = std::true_type;
    using F = std::false_type;
    if (d % 8 != 0) return kmax ? go(nc, T{}, T{}) : go(nc, F{}, T{});
    return kmax ? go(nc, T{}, F{}) : go(nc, F{}, F{});
  };
  if (wide_nc(d) == 3) return by_form(std::integral_constant<int, 3>{});
  return by_form(std::integral_constant<int, 4>{});
}

}  // namespace prefill
}  // namespace eft
