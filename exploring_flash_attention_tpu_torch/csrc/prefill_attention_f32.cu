// H1 at f32 q/k/v: prefill_attention_f32_kernel on the f32 core of
// f32_attention.cuh (bf16x6 on wgmma), in a translation unit of its own so
// that it compiles beside the bf16 kernel (prefill_attention.cu, whose
// header comment describes H1 and whose C entry launches this).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "f32_attention.cuh"
#include "prefill_attention.cuh"
#include "wgmma_tile.cuh"

namespace {

using namespace eft::hopper;
using namespace eft::prefill;

// H1 at f32 q/k/v (f32_attention.cuh: bf16x6 on wgmma): the same function,
// masks, spans, traced offsets and bound statistic as the bf16 kernel.
// One block per (batch*q-head, Q tile of BQ rows, KV span), the Q tiles of
// a head next to each other, the last first; BKV-key tiles of K and V,
// each f32 value split into three bf16 pieces by the producer.  O is
// written f32 or bf16 (rounded once), the LSE f32.  The Q tile argument
// (64 or 128 rows) leaves the bf16 kernel's result unchanged and is not
// read here: each row meets the same tiles in the same order either way.
template <int D, bool BOUND>
__global__ void __launch_bounds__(eft::f32::Tiles<D, 3>::THREADS, 1)
prefill_attention_f32_kernel(const float* __restrict__ q,  // [B*Hq, Lq, d]
                             const float* __restrict__ k,  // [B*Hkv, Lkv, d]
                             const float* __restrict__ v,  // [B*Hkv, Lkv, d]
                             void* __restrict__ o, int out_f32,
                             float* __restrict__ lse, int hq, int group,
                             int lq, int lkv, int mask, int diag_off,
                             int window, const int* __restrict__ offs,
                             int kv_span, float scale_log2,
                             const float* __restrict__ kmax, int d) {
  namespace F = eft::f32;
  using T = F::Tiles<D, 3>;
  constexpr int BQ = T::BQ, BKV = T::BKV;
  if (offs != nullptr) diag_off = offs[0] - offs[1];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* empty = full + T::STAGES;
  const int n_qt = (lq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int bhk = (bh / hq) * (hq / group) + (bh % hq) / group;   // GQA
  const int q0 = (n_qt - 1 - blockIdx.x % n_qt) * BQ;
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
  const int n_tiles = kv_end > kv_begin
                          ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
  F::init_bars<D, 3>(full);
  const int warp = threadIdx.x / 32;
  const float* k_h = k + size_t(bhk) * lkv * d;
  const float* v_h = v + size_t(bhk) * lkv * d;

  if (warp >= T::NC * 4) {
    // the producer: each thread CH 8-float pieces of K and of V a tile
    constexpr int CH = BKV * (D / 8) / 128;
    struct Regs { float4 k[CH][2], v[CH][2]; };
    const int ct = threadIdx.x - T::NC * 128;
    // rows of a d that is not a multiple of 4 are read a float at a time
    const bool vec4 = d % 4 == 0;
    auto fetch = [&](int i, Regs& x) {
      const int kv0 = kv_begin + i * BKV;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int e = ct + 128 * c, r = e / (D / 8), ch = e % (D / 8);
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        x.k[c][0] = x.k[c][1] = x.v[c][0] = x.v[c][1] = z;
        if (kv0 + r < lkv && 8 * ch < d) {
          const size_t at = size_t(kv0 + r) * d + 8 * ch;
          load8_f32(k_h + at, d - 8 * ch, vec4, x.k[c][0], x.k[c][1]);
          load8_f32(v_h + at, d - 8 * ch, vec4, x.v[c][0], x.v[c][1]);
        }
      }
    };
    auto put = [&](const Regs& x, unsigned char* sk, unsigned char* sv,
                   float* kc, float*) {
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const int e = ct + 128 * c, r = e / (D / 8), ch = e % (D / 8);
        F::put_split8(sk, T::KV_PIECE, BKV, r, ch, x.k[c][0], x.k[c][1]);
        F::put_split8(sv, T::KV_PIECE, BKV, r, ch, x.v[c][0], x.v[c][1]);
      }
      if (ct < BKV) kc[ct] = scale_log2;
    };
    F::produce<D, 3, Regs>(smem, full, empty, n_tiles, fetch, put);
    return;
  }

  // a consumer warpgroup: rows q0 + 64 wg .. + 63, this thread two of them
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;
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
  const float* q_h = q + size_t(bh) * lq * d;
  F::stage_q<D, 3>(smem + T::q, wg, [&](int r) {
    const int qi = q0 + wg * 64 + r;
    return qi < lq ? q_h + size_t(qi) * d : nullptr;
  }, d);
  float m[2];
  if constexpr (BOUND) {
    // the prefix maximum of |k|^2 at the last tile that the last row of
    // this block's 128-row group sees, as the bf16 kernel reads it; |q|^2
    // of each owned row in f32, its quad's lanes a quarter of it each
    const int n_kv = (lkv + SPAN_TILE - 1) / SPAN_TILE;
    int idx = n_kv - 1;
    if (mask != MASK_NONE) {
      const long long g_last =
          min(q0 / BOUND_ROWS * BOUND_ROWS + BOUND_ROWS, lq) - 1;
      const long long x = g_last + diag_off;
      idx = x < 0 ? 0 : int(clamp64(x / SPAN_TILE, 0, n_kv - 1));
    }
    const float kmax2 = kmax[size_t(bhk) * n_kv + idx];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = 0.f;
      if (row0 + 8 * r < lq) {
        const float* qr = q_h + size_t(row0 + 8 * r) * d;
        if (d % 4 == 0) {
          for (int c = lane % 4; 4 * c < d; c += 4) {
            const float4 x = *reinterpret_cast<const float4*>(qr + 4 * c);
            sum = fmaf(x.x, x.x, sum);
            sum = fmaf(x.y, x.y, sum);
            sum = fmaf(x.z, x.z, sum);
            sum = fmaf(x.w, x.w, sum);
          }
        } else {
          for (int c = lane % 4; c < d; c += 4) sum = fmaf(qr[c], qr[c], sum);
        }
      }
      m[r] = sqrtf(quad_sum(sum) * kmax2) * scale_log2 - BOUND_SHIFT;
    }
  }
  float acc_o[D / 2], l[2];
  F::attend<D, 3, BOUND, false>(smem, wg, full, empty, kv_begin, n_tiles, lo,
                                hi, acc_o, m, l);
  const size_t base = (size_t(bh) * gridDim.z + span) * lq;
  if (d == D)
    store_o_rows<D>(acc_o, l, m, row0, lq, base, o, out_f32, lse);
  else if (d % 8 == 0)
    store_o_rows<D>(acc_o, l, m, row0, lq, base, o, out_f32, lse, d, 0, d);
  else
    store_o_rows<D, true>(acc_o, l, m, row0, lq, base, o, out_f32, lse, d,
                          0, d);
}

template <int D, bool BOUND>
int launch_d(const void* q, const void* k, const void* v, void* o,
             int out_f32, void* lse, int batch, int hq, int hkv, int lq,
             int lkv, int d, int mask, int diag_off, int window,
             const int* offs, int kv_span, float scale, const float* kmax,
             cudaStream_t stream) {
  using T = eft::f32::Tiles<D, 3>;
  const cudaError_t attr = cudaFuncSetAttribute(
      prefill_attention_f32_kernel<D, BOUND>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const int span =
      kv_span ? kv_span : (lkv + SPAN_TILE - 1) / SPAN_TILE * SPAN_TILE;
  const dim3 grid(batch * hq * ((lq + T::BQ - 1) / T::BQ), 1,
                  (lkv + span - 1) / span);
  prefill_attention_f32_kernel<D, BOUND>
      <<<grid, T::THREADS, T::bytes, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), o, out_f32, static_cast<float*>(lse),
          hq, hq / hkv, lq, lkv, mask, diag_off, window, offs, span,
          scale * 1.4426950408889634f, kmax, d);
  return int(cudaGetLastError());
}

}  // namespace

namespace eft {
namespace prefill {

int launch_f32(const void* q, const void* k, const void* v, void* o,
               int out_f32, void* lse, int batch, int hq, int hkv, int lq,
               int lkv, int d, int mask, int diag_off, int window,
               const int* offs, int kv_span, float scale, const float* kmax,
               cudaStream_t stream) {
  // one instance per (D, statistic): D = 64, 128, 256
  auto go = [&](auto dc, auto bound) {
    return launch_d<decltype(dc)::value, decltype(bound)::value>(
        q, k, v, o, out_f32, lse, batch, hq, hkv, lq, lkv, d, mask,
        diag_off, window, offs, kv_span, scale, kmax, stream);
  };
  auto by_bound = [&](auto dc) {
    return kmax ? go(dc, std::true_type{}) : go(dc, std::false_type{});
  };
  if (d <= 64) return by_bound(std::integral_constant<int, 64>{});
  if (d <= 128) return by_bound(std::integral_constant<int, 128>{});
  return by_bound(std::integral_constant<int, 256>{});
}

}  // namespace prefill
}  // namespace eft
