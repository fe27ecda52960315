// H6-extend past d 256: eft_paged_extend's bf16 launch at head dims d from
// 257 to 512 (paged_extend.cu takes d up to 256 on its own block and calls
// launch_wide above it).  It computes H6-extend's function (the TPU kernels
// B21 and B22 that paged_extend.cu names) with its rounding: each chunk row
// attends causally (and under a window) over its sequence's paged int8
// history, s * (k_scale * scale * log2e) per key, l summing the f32 p, P =
// bf16(p * v_scale), O to bf16 once.
//
// The block is wide_attention.cuh's (H5's, with the masks): 64
// GQA-flattened chunk rows (row t is chunk position t / G and q head kh G
// + t % G, as paged_extend.cu's rows), NC = 3 or 4 consumer warpgroups of
// 128 O columns.  The consumer warpgroups stage the Q rows themselves (the
// flattened rows are no box of q), then warpgroup 0 runs S and the
// softmax, the others their O columns.  The producer warpgroup brings each
// 64-key tile of one page as K and V code chunks of 64 keys x 128 columns:
// its first thread by TMA from the pages viewed as [n_pages * 2 * Hkv, ps,
// d] at (column, offset, page * 2 * Hkv + {0, Hkv} + kh) into a ring of
// four 8 KB code slots (a page is a multiple of 128 keys, so a tile never
// straddles one, and the columns past d arrive as zero codes); where the
// rows of codes are no multiple of 16 bytes (d % 16 != 0: no tensor map
// takes them, PACKED) all 128 threads copy them with cp.async pieces of
// the rows' alignment (wgmma_tile.cuh stage16, zeros past d).  All 128
// convert each chunk exactly to bf16 into six chunk slots and write each
// key's factors, kc = k_scale * scale * log2e and vs = v_scale, both zero
// past the sequence's length (a reused page holds old codes there).
//
// Cost: as paged_extend.cu's, the tensor cores at long histories (a
// 256-token chunk over 4,600 positions at d=512 is 4x the d=128 work).

#include "wide_attention.cuh"

namespace {

// The producer warpgroup of H6-extend's wide block (thread pt of 128): the
// K and V code chunks of tiles [kv_begin, kv_begin + 64 n_tiles) of the
// sequence whose page table row is `table`, KV head kh; its keys' factors
template <int NC, bool PACKED>
__device__ __forceinline__ void produce_paged(
    const CUtensorMap* tkv, unsigned char* smem, Bars<NC, KV_INT8>* bars,
    const int8_t* pages, const float* scales, const int* table, int hkv,
    int kh, int ps, int d, int n, int kv_begin, int n_tiles,
    float scale_log2) {
  using C = Cfg<NC, KV_INT8>;
  const int pt = threadIdx.x - NC * 128;
  unsigned char* codes = smem + C::codes;
  unsigned char* chunks = smem + C::chunks;
  float* sscale = reinterpret_cast<float*>(smem + C::scales);
  const int total = n_tiles * 2 * NC;
  // item j's rows in the pages: K (u < NC) or V code chunk u % NC of tile
  // j / 2 NC, its page row `head` (of n_pages * 2 * Hkv) and first offset
  auto rows_of = [&](int j, int& head, int& off) {
    const int u = j % (2 * NC);
    const int kv0 = kv_begin + j / (2 * NC) * BKV;
    head = (table[kv0 / ps] * 2 + (u < NC ? 0 : 1)) * hkv + kh;
    off = kv0 % ps;
  };
  auto load_codes = [&](int j) {
    int head, off;
    rows_of(j, head, off);
    const int cs = j % C::CODE_SLOTS;
    mbar_arrive_expect_tx(&bars->code_full[cs], C::CODE_BYTES);
    tma_load_3d(codes + cs * C::CODE_BYTES, tkv, &bars->code_full[cs],
                j % NC * DC, off, head);
  };
  // PACKED: item j's codes into its code slot, one cp.async group
  auto stage_codes = [&](int j) {
    int head, off;
    rows_of(j, head, off);
    const int col = j % NC * DC;
    const unsigned char* src = reinterpret_cast<const unsigned char*>(pages) +
                               (size_t(head) * ps + off) * d + col;
    const uint32_t dst =
        smem_u32(codes + (j % C::CODE_SLOTS) * C::CODE_BYTES);
    const int al = row_align(d);
    for (int e = pt; e < BKV * (DC / 16); e += CONVERTERS) {
      const int r = e / (DC / 16), c = (e % (DC / 16)) * 16;
      stage16(dst + r * DC + c, src + size_t(r) * d + c, al, d - col - c);
    }
    cp_async_commit();
  };
  // tile i's factors, zero past the sequence
  auto write_scales = [&](int i) {
    const int kv0 = kv_begin + i * BKV;
    const float* gk =
        scales + (size_t(table[kv0 / ps]) * 2 * hkv + kh) * ps + kv0 % ps;
    const float* gv = gk + size_t(hkv) * ps;
    float* sc = sscale + (i % 2) * 2 * BKV;
    for (int c = pt; c < BKV; c += CONVERTERS) {
      const bool valid = kv0 + c < n;
      sc[c] = valid ? gk[c] * scale_log2 : 0.f;
      sc[BKV + c] = valid ? gv[c] : 0.f;
    }
  };
  if constexpr (PACKED) {
    for (int j = 0; j < C::CODE_SLOTS; ++j) {
      if (j < total) stage_codes(j);
      else cp_async_commit();
    }
  } else if (pt == 0) {
    for (int j = 0; j < C::CODE_SLOTS && j < total; ++j) load_codes(j);
  }
  for (int j = 0; j < total; ++j) {
    const int i = j / (2 * NC);
    if (j % (2 * NC) == 0) {
      mbar_wait(&bars->sc_empty[i % 2], ((i / 2) & 1) ^ 1);
      write_scales(i);
      mbar_arrive(&bars->sc_full[i % 2]);
    }
    const int cs = j % C::CODE_SLOTS, s = j % C::SLOTS;
    mbar_wait(&bars->chunk_empty[s], ((j / C::SLOTS) & 1) ^ 1);
    if constexpr (PACKED) {
      cp_async_wait<C::CODE_SLOTS - 1>();     // this thread's copies of j
      named_bar_sync(SLOT_BAR, CONVERTERS);   // and every thread's
    } else {
      mbar_wait(&bars->code_full[cs], (j / C::CODE_SLOTS) & 1);
    }
    convert_codes_tile<KV_INT8, false, DC>(codes + cs * C::CODE_BYTES,
                                           chunks + s * C::CHUNK_BYTES, BKV,
                                           pt, CONVERTERS);
    fence_proxy_async();
    mbar_arrive(&bars->chunk_full[s]);
    named_bar_sync(SLOT_BAR, CONVERTERS);
    if constexpr (PACKED) {
      if (j + C::CODE_SLOTS < total) stage_codes(j + C::CODE_SLOTS);
      else cp_async_commit();
    } else if (pt == 0 && j + C::CODE_SLOTS < total) {
      load_codes(j + C::CODE_SLOTS);
    }
  }
}

// The block's 64 flattened chunk rows of Q from row t0 on, staged by the
// NC * 128 consumer threads as TMA would lay them out (2 NC swizzled
// [64][64] boxes), zeros past the chunk's rows and past d.  ANY: rows of
// no multiple of 16 bytes (d % 8 != 0), read a value at a time
template <int NC, bool ANY>
__device__ __forceinline__ void stage_q_flat(unsigned char* sq,
                                             const __nv_bfloat16* q_b,
                                             int t0, int rows, int group,
                                             int hq, int d) {
  constexpr int PIECES = NC * DC / 8;      // 16-byte pieces of a row
  for (int x = threadIdx.x; x < BQ * PIECES; x += NC * 128) {
    const int r = x / PIECES, ch = x % PIECES, t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < rows && ch * 8 < d) {
      const __nv_bfloat16* src =
          q_b + (size_t(t / group) * hq + t % group) * d + ch * 8;
      if constexpr (!ANY) {
        val = *reinterpret_cast<const uint4*>(src);
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
        const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (ch * 8 + j < d) w[j / 2] |= uint32_t(h[j]) << (16 * (j % 2));
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(sq + (ch / 8) * BQ * 128 +
                              swz128(r, (ch % 8) * 16)) = val;
  }
}

// O / l of this thread's two flattened rows t and t + 8, columns [col, col
// + 128) cut at d, bf16, at their addresses in o_b (laid out as q_b); a
// row with l = 0 (it saw no key) stores 0.  ANY: a value at a time
template <bool ANY>
__device__ __forceinline__ void store_flat_rows(const float (&acc_o)[DC / 2],
                                                const float (&l)[2],
                                                __nv_bfloat16* o_b, int t,
                                                int rows, int group, int hq,
                                                int d, int col) {
  const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int tr = t + 8 * r;
    if (tr >= rows) continue;
    const float denom = l_row == 0.f ? 1.f : l_row;
    __nv_bfloat16* orow =
        o_b + (size_t(tr / group) * hq + tr % group) * d + col;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      if (col + 8 * j >= d) continue;
      const float x0 = acc_o[4 * j + 2 * r] / denom;
      const float x1 = acc_o[4 * j + 2 * r + 1] / denom;
      const int c = 8 * j + col0;
      if constexpr (!ANY) {
        *reinterpret_cast<__nv_bfloat162*>(orow + c) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col + c < d) orow[c] = __float2bfloat16(x0);
        if (col + c + 1 < d) orow[c + 1] = __float2bfloat16(x1);
      }
    }
  }
}

template <int NC, bool PACKED>
__global__ void __launch_bounds__(Cfg<NC, KV_INT8>::THREADS, 1)
paged_extend_wide_kernel(
    const __grid_constant__ CUtensorMap tkv,  // [P*2*Hkv, ps, d] int8
    const int8_t* __restrict__ pages,         // [n_pages, 2, Hkv, ps, d]
    const __nv_bfloat16* __restrict__ q,      // [B, C, Hq, d]
    const float* __restrict__ scales,         // [n_pages, 2, Hkv, 1, ps]
    const int* __restrict__ page_table,       // [max_seqs, max_pages]
    const int* __restrict__ seq_lens,         // [max_seqs]
    const int* __restrict__ slots,            // [B]
    __nv_bfloat16* __restrict__ o,            // [B, C, Hq, d]
    int c, int hq, int hkv, int d, int ps, int max_pages, int max_seqs,
    int window, float scale_log2) {
  using C = Cfg<NC, KV_INT8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto* bars = reinterpret_cast<Bars<NC, KV_INT8>*>(smem + C::bars);

  const int group = hq / hkv;
  const int rows = c * group;
  // the last row tile first: it sees the most keys
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128;

  const int slot = slots[b];
  const bool valid = slot >= 0 && slot < max_seqs;
  const int n = valid ? min(seq_lens[slot], max_pages * ps) : 0;  // with the chunk
  const int q_start = n - c;                   // position of chunk row 0
  // the key tiles some row of this block sees: up to the last row's
  // position, from the first row's band edge (rounded down to a tile) on
  const int kv_end = max(q_start + (min(t0 + BQ, rows) - 1) / group + 1, 0);
  const int kv_begin =
      window > 0 ? max(q_start + t0 / group - window + 1, 0) / BKV * BKV : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
  const int* table = page_table + size_t(valid ? slot : 0) * max_pages;

  wide_init<NC, KV_INT8>(bars, CONVERTERS, NC * 128);

  if (wg == NC) {
    setmaxnreg_dec<C::PRODUCER_REGS>();
    if (n_tiles > 0)
      produce_paged<NC, PACKED>(&tkv, smem, bars, pages, scales, table, hkv,
                                kh, ps, d, n, kv_begin, n_tiles, scale_log2);
    return;
  }
  // each consumer warpgroup's path runs to its end apart: code that both
  // reach after setmaxnreg is held to the smaller register count (ptxas
  // spilled 344-360 bytes where the paths met, at every split tried)
  const size_t head0 = (size_t(b) * c * hq + size_t(kh) * group) * d;
  const int lane = threadIdx.x % 32;
  const int rl = threadIdx.x / 32 % 4 * 16 + lane / 4;
  auto stage_q = [&]() {
    if (d % 8 != 0)
      stage_q_flat<NC, true>(smem + C::q, q + head0, t0, rows, group, hq, d);
    else
      stage_q_flat<NC, false>(smem + C::q, q + head0, t0, rows, group, hq,
                              d);
    fence_proxy_async();
    mbar_arrive(&bars->q_full);
  };
  auto store = [&](const float (&acc_o)[DC / 2], const float (&l)[2]) {
    if (d % 8 != 0)
      store_flat_rows<true>(acc_o, l, o + head0, t0 + rl, rows, group, hq, d,
                            wg * DC);
    else
      store_flat_rows<false>(acc_o, l, o + head0, t0 + rl, rows, group, hq,
                             d, wg * DC);
  };
  float acc_o[DC / 2], l[2];
  if (wg == 0) {
    setmaxnreg_inc<C::WG0_REGS>();
    stage_q();
    // each owned row sees keys [lo, hi] (a row past the chunk none); every
    // row of the block at least [lo_last, hi_first]
    Band band;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + rl + 8 * r;
      const int pos = q_start + t / group;
      band.hi[r] = t < rows ? pos : -1;
      band.lo[r] = window > 0 ? max(pos - window + 1, 0) : 0;
    }
    band.hi_first = q_start + t0 / group;
    band.lo_last = window > 0
        ? q_start + min(t0 + BQ - 1, rows - 1) / group - window + 1 : 0;
    float m[2];
    wide_first<NC, KV_INT8, false>(smem, bars, kv_begin, n_tiles, band,
                                   scale_log2, 0.f, acc_o, m, l);
    store(acc_o, l);
    return;
  }
  stage_q();
  wide_chunk<NC, KV_INT8>(smem, bars, n_tiles, acc_o, l);
  store(acc_o, l);
}

template <int NC, bool PACKED>
int launch_extend_wide(const void* q, const void* pages, const void* scales,
                       const void* page_table, const void* seq_lens,
                       const void* slots, void* o, int batch, int c, int hq,
                       int hkv, int d, int ps, int max_pages, int max_seqs,
                       int n_pages, int window, float scale,
                       cudaStream_t stream) {
  using C = Cfg<NC, KV_INT8>;
  CUtensorMap tkv = {};
  if constexpr (!PACKED) {
    const int err = make_tmap(&tkv, pages, 1, d, ps, n_pages * 2 * hkv, DC,
                              BKV, 0);
    if (err) return err;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      paged_extend_wide_kernel<NC, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (attr != cudaSuccess) return int(attr);
  const int rows = c * (hq / hkv);
  const dim3 grid((rows + BQ - 1) / BQ, hkv, batch);
  paged_extend_wide_kernel<NC, PACKED><<<grid, C::THREADS, C::bytes, stream>>>(
      tkv, static_cast<const int8_t*>(pages),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const float*>(scales), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<const int*>(slots),
      static_cast<__nv_bfloat16*>(o), c, hq, hkv, d, ps, max_pages,
      max_seqs, window, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

namespace eft {
namespace extend {

int launch_wide(const void* q, const void* pages, const void* scales,
                const void* page_table, const void* seq_lens,
                const void* slots, void* o, int batch, int c, int hq,
                int hkv, int d, int ps, int max_pages, int max_seqs,
                int n_pages, int window, float scale, cudaStream_t stream) {
  auto go = [&](auto nc, auto packed) {
    return launch_extend_wide<decltype(nc)::value, decltype(packed)::value>(
        q, pages, scales, page_table, seq_lens, slots, o, batch, c, hq, hkv,
        d, ps, max_pages, max_seqs, n_pages, window, scale, stream);
  };
  auto by_rows = [&](auto nc) {
    return d % 16 != 0 ? go(nc, std::true_type{}) : go(nc, std::false_type{});
  };
  if (wide_nc(d) == 3) return by_rows(std::integral_constant<int, 3>{});
  return by_rows(std::integral_constant<int, 4>{});
}

}  // namespace extend
}  // namespace eft
