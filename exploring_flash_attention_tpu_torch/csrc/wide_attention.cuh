// The serving kernels' block past d 256: H5's block (dtiled_attention.cuh)
// with what H1 and H6-extend add to attention, for bf16 head dims d from
// 257 to 512.  H1 launches it from prefill_attention_wide.cu (bf16 K and
// V), H6-extend from paged_extend_wide.cu (the paged cache's int8 codes and
// per-token scales); the instances of d up to 256 keep their own blocks.
//
// Why H5's block.  At d = 512 a 64-row O accumulator is 256 f32 registers
// a thread, over the 255 a thread may hold, and H1's 64-key D=256 block
// (S 32 + P 16 + O 128 of its 240) has no room for twice O.  H5 splits O
// by its 128-column d-chunks across NC = ceil(d / 128) consumer warpgroups
// of one block (3 at d 257-384, 4 at 385-512; wide_nc), 64 Q rows a
// block, 64-key K/V tiles cut into 64 x 128 chunks: warpgroup 0 computes S
// over all of the block's chunks and the softmax and hands P and alpha to
// the others through shared memory; warpgroup c holds O's columns [128 c,
// 128 c + 128).  Its budget holds at NC = 4 (~210 KB of shared memory,
// setmaxnreg 40 / 152 / 96).  What it lacked, and this file adds:
//   - masks (none, causal, window) from each owned row's band [lo, hi] of
//     keys, selected on S in the tiles that some row of the block does not
//     wholly see, and the tiles outside every row's band never loaded (the
//     callers' loop bounds, in 64 bits where positions add);
//   - any GQA group (the K/V head of a q head, or the group's q heads
//     flattened into rows), a key range [kv_begin, kv_begin + 64 n_tiles)
//     of whole tiles (a KV span), and the row's LSE;
//   - H1's rounding (P = bf16(p), l summing the rounded P) or H6-extend's
//     and H5's (P = bf16(p * v_scale), l summing the f32 p, each key's
//     k_scale folded into the exp2 constant), by K/V kind;
//   - the bound statistic (H1's softmax="bound"): the row shift fixed
//     before the key loop, no running max, alpha = 1.
// The producers and the epilogues are the callers'.

#pragma once

#include "dtiled_attention.cuh"
#include "prefill_attention.cuh"

namespace {

// the d-chunks (consumer warpgroups) of head dim d, 257 to 512
__host__ __device__ constexpr int wide_nc(int d) { return d <= 384 ? 3 : 4; }

// Each thread's two rows (rl and rl + 8 of the block's 64) see keys
// [lo[r], hi[r]]; every row of the block sees at least [lo_last,
// hi_first], so a tile inside that range is whole and takes the loop
// without the compares.  Past the keys (Lkv, a sequence's length) hi stops.
struct Band {
  int lo[2], hi[2];
  int lo_last, hi_first;
};

// |q|^2 of row `row` of the block's Q tile in shared memory (NC 128-column
// chunks, each two swizzled [64][64] boxes): a row's bytes stay in its own
// 128 bytes of each box under the swizzle, so each lane of the quad sums
// every fourth 16-byte piece and the quad adds
template <int NC>
__device__ __forceinline__ float q_row_sq(const unsigned char* sq, int row) {
  float sum = 0.f;
#pragma unroll
  for (int x = 0; x < 2 * NC; ++x)
#pragma unroll
    for (int c = threadIdx.x % 4; c < 8; c += 4) {
      const uint4 w = *reinterpret_cast<const uint4*>(
          sq + x * BQ * 128 + row * 128 + c * 16);
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = __uint_as_float(ws[j] << 16);
        const float hi = __uint_as_float(ws[j] & 0xffff0000u);
        sum += lo * lo + hi * hi;
      }
    }
  return quad_sum(sum);
}

// Consumer warpgroup 0 of the wide block: over the key tiles [kv_begin,
// kv_begin + 64 n_tiles), S over the block's d-chunks in one fixed order,
// the masked online softmax, P to registers and, for the other
// warpgroups, to the shared tile with each row's alpha, O_0 = alpha O_0 +
// P V_0; then l to the others.  Leaves O_0, m (the exp2 basis) and l (this
// thread's share of its quad's sum) to the caller's epilogue.
// KIND KV_BF16 (H1): s * scale_log2, P = bf16(p), l sums the rounded P.
// KV_INT8 (H6-extend): s * kc[key] and P = bf16(p * vs[key]) from the
// producer's factors (kc = k_scale * scale * log2e, vs = v_scale), l sums
// the f32 p.  BOUND (H1's bound statistic): m is the row's fixed shift,
// sqrt(|q|^2 kmax2) * scale_log2 - BOUND_SHIFT, p = exp2(s scale_log2 -
// m), no rescale.  The Q tile is in shared memory once q_full completes.
template <int NC, int KIND, bool BOUND>
__device__ __forceinline__ void wide_first(unsigned char* smem,
                                           Bars<NC, KIND>* bars,
                                           int kv_begin, int n_tiles,
                                           const Band& band,
                                           float scale_log2, float kmax2,
                                           float (&acc_o)[DC / 2],
                                           float (&m)[2], float (&l)[2]) {
  using C = Cfg<NC, KIND>;
  constexpr bool QUANT = KIND != KV_BF16;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rl = warp * 16 + lane / 4;       // first owned row of the tile
  const int col0 = 2 * (lane % 4);
  const unsigned char* sq = smem + C::q;
  const unsigned char* chunks = smem + C::chunks;
  const float* sscale = reinterpret_cast<const float*>(smem + C::scales);
  float* salpha = reinterpret_cast<float*>(smem + C::alpha);

  m[0] = m[1] = -CUDART_INF_F;
  l[0] = l[1] = 0.f;
#pragma unroll
  for (int e = 0; e < DC / 2; ++e) acc_o[e] = 0.f;
  if (n_tiles > 0) {
    mbar_wait(&bars->q_full, 0);
    if constexpr (BOUND) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        m[r] = sqrtf(q_row_sq<NC>(sq, rl + 8 * r) * kmax2) * scale_log2 -
               eft::prefill::BOUND_SHIFT;
    }
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int kv0 = kv_begin + i * BKV;
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

    // the softmax: each column's factor, the keys outside each row's band
    // masked unless every row sees the whole tile
    const int t = i % 2;
    const float* kc = sscale + t * 2 * BKV + col0;
    const float* vsc = kc + BKV;
    if constexpr (QUANT) mbar_wait(&bars->sc_full[t], (i / 2) & 1);
    const bool whole = kv0 >= band.lo_last && kv0 + BKV - 1 <= band.hi_first;
    float alpha[2] = {1.f, 1.f};
    if constexpr (BOUND) {
      // p = exp2(s * scale_log2 - m) as one FMA; masked keys give 0
      const float neg_m[2] = {-m[0], -m[1]};
      if (whole) {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e)
          acc_s[e] = exp2_approx(
              fmaf(acc_s[e], scale_log2, neg_m[acc_row8(e) / 8]));
      } else {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const int r = acc_row8(e) / 8;
          const int col = kv0 + col0 + acc_col(e);
          acc_s[e] = col >= band.lo[r] && col <= band.hi[r]
                         ? exp2_approx(fmaf(acc_s[e], scale_log2, neg_m[r]))
                         : 0.f;
        }
      }
    } else {
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
      if (whole) {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          acc_s[e] *= QUANT ? kc[acc_col(e)] : scale_log2;
          mx[acc_row8(e) / 8] = fmaxf(mx[acc_row8(e) / 8], acc_s[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < BKV / 2; ++e) {
          const int r = acc_row8(e) / 8;
          const int col = kv0 + col0 + acc_col(e);
          acc_s[e] = col >= band.lo[r] && col <= band.hi[r]
                         ? acc_s[e] * (QUANT ? kc[acc_col(e)] : scale_log2)
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
    // P, the A fragment of P V, and l
    float psum[2] = {0.f, 0.f};
    uint32_t pa[BKV / 4];
#pragma unroll
    for (int j = 0; j < BKV / 4; ++j) {
      if constexpr (QUANT) {
        const int col = acc_col(2 * j);
        psum[j & 1] += acc_s[2 * j] + acc_s[2 * j + 1];
        pa[j] = pack_bf16x2(acc_s[2 * j] * vsc[col],
                            acc_s[2 * j + 1] * vsc[col + 1]);
      } else {
        pa[j] = pack_bf16x2(acc_s[2 * j], acc_s[2 * j + 1], psum[j & 1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
    if constexpr (QUANT) mbar_arrive(&bars->sc_empty[t]);

    // P and alpha for the other warpgroups
    {
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
    if constexpr (!BOUND) rescale(acc_o, alpha);
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

  // hand l over to the other warpgroups
  float* sl = reinterpret_cast<float*>(smem + C::lsum);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    if (col0 == 0) sl[rl + 8 * r] = l_row;
  }
  named_bar_sync(L_BAR, NC * 128);
}

// Consumer warpgroup c > 0 of the wide block: its key loop (H5's
// chunk_loop), then the row sums warpgroup 0 handed over, placed so that
// the epilogue's quad sum returns them
template <int NC, int KIND>
__device__ __forceinline__ void wide_chunk(unsigned char* smem,
                                           Bars<NC, KIND>* bars, int n_tiles,
                                           float (&acc_o)[DC / 2],
                                           float (&l)[2]) {
  using C = Cfg<NC, KIND>;
  const int lane = threadIdx.x % 32;
  const int rl = threadIdx.x / 32 % 4 * 16 + lane / 4;
  chunk_loop<NC, KIND, false>(smem, bars, threadIdx.x / 128, rl, n_tiles,
                              acc_o);
  named_bar_sync(L_BAR, NC * 128);
  const float* sl = reinterpret_cast<const float*>(smem + C::lsum);
  l[0] = lane % 4 == 0 ? sl[rl] : 0.f;
  l[1] = lane % 4 == 0 ? sl[rl + 8] : 0.f;
}

// The block's barriers: a chunk slot's full count (TMA's one arrival, or
// the producer's `full` threads), the consumers' releases, P's hand-over,
// and q_full's `q` arrivals
template <int NC, int KIND>
__device__ __forceinline__ void wide_init(Bars<NC, KIND>* bars, int full,
                                          int q) {
  using C = Cfg<NC, KIND>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
      mbar_init(&bars->chunk_full[s], full);
      mbar_init(&bars->chunk_empty[s], 128);
    }
    for (int s = 0; s < C::CODE_SLOTS; ++s) mbar_init(&bars->code_full[s], 1);
    for (int t = 0; t < 2; ++t) {
      mbar_init(&bars->sc_full[t], CONVERTERS);
      mbar_init(&bars->sc_empty[t], 128);
      mbar_init(&bars->p_full[t], 128);
      mbar_init(&bars->p_empty[t], (NC - 1) * 128);
    }
    mbar_init(&bars->q_full, q);
    mbar_init_fence();
  }
  __syncthreads();
}

}  // namespace
