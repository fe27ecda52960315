// H6-decode: paged INT8 decode attention on Hopper (sm_90a), split across
// the SMs, its runs merged by the last block of each (sequence, KV head).
//
// Replaces the TPU kernel B20 _decode_kernel
// (exploring_flash_attention_tpu/serving/decode.py:74): one new token per
// sequence attends over that sequence's paged INT8 KV history, or, with a
// sliding window, over its last `window` positions only.
//
// B20 runs ONE program over a flattened (sequence, page) work list,
// because a TPU core runs its grid in order and a deep DMA window had to
// stay full across sequence boundaries.  Here the card runs blocks in
// parallel, and one block per (sequence, KV head) is 32 blocks on 132 SMs
// at the slice's shape.  So this is the FlashDecoding form: the grid is
// (n_split, Hkv, B) and block (k, kh, b) takes run k of the sequence's
// visible pages, pages_per_split of them from the first in-band page on
// (B20's page list, decode.py:120-121), chosen on the host from the
// cache's shape (serving/decode.py decode_split), so that no host sync
// reads seq_lens.  It writes the run's partial in H2's layout: O [B, Hq,
// n_split, 1, d] normalized over the run and its natural-log LSE [B, Hq,
// n_split, 1], scale included; a run that sees nothing writes the merge
// identity (0, -inf), and so does an empty or invalid slot.
//
// The merge (FUSED, what paged_decode_attention launches: B20 is one
// pallas_call and so is this).  With n_split == 1 the block writes its
// normalized bf16 O [B, Hq, d] directly: no partial, no ticket.  Otherwise
// every block, whatever its run saw, writes its partial, then arrives on
// the ticket of its (batch row, KV head, group chunk): after a barrier,
// thread 0 fences (release) and adds 1 to tickets[b * grid.y +
// blockIdx.y].  The block that draws n_split - 1 is the last: it fences
// (acquire), reads the n_split partials of its G rows through L2 (L1 is
// not coherent across SMs),
// merges them with lse_merge.cuh (H2's arithmetic) into bf16 O, and
// stores 0 back to the ticket, so the buffer is zero for the next launch
// with no host work and no memset (a CUDA graph replays it as it is).  A
// ticket per batch row, not per slot: rows with an invalid slot (-1) do
// not share one.  A ticket, not a thread-block cluster: a cluster caps
// n_split at 8 (16 non-portable), and decode_split plans up to
// 2 * 132 / (B * Hkv) runs (66 at B=1, Hkv=4).  Without FUSED the kernel
// writes the partials only (paged_decode_partials: the kernel alone, for
// the tests and the timings).
//
// Cost: the bytes.  Every visible cached token is one int8 K row and one
// V row of d bytes and two f32 scales per KV head: 138 MB at the JAX
// suite's decode entry (B=32, Hkv=8, d=128, 2048 tokens), 0.041 ms at
// 3.35 TB/s, against 4 flops per (q head, token, d).  The block holds its
// G <= GMAX q heads' rows in registers and stages the pages with 1-D TMA:
//   - the run is cut into tiles of 128 tokens (a page of ps tokens is
//     ps / 128 of them), each tile being four contiguous slabs: K and V codes
//     (128 * d bytes each) and their scales (512 bytes each), which
//     thread 0 brings into a ring of three stages with cp.async.bulk on
//     an mbarrier, so the next two tiles are in flight while one is
//     computed; no thread reads K or V from global memory;
//   - S = q K^T: d / 16 lanes per token, 16 codes (one 16-byte shared
//     load) per lane, converted exactly to f32, the group's rows' dot
//     products summed over the lanes by a shuffle tree, then
//     * k_scale * scale * log2(e); a column outside [first visible,
//     seq_len) is -inf;
//   - the online softmax, one warp per q row: the tile's max by shuffles,
//     p = exp2(s - m), l summing the unscaled p, P * v_scale rounded to
//     bf16 (as B20 rounds it to the q dtype; f32 q keeps it f32, and the
//     q rows and O are f32); a hidden column's P * v_scale
//     is 0 whatever its (possibly reused) page holds;
//   - O += P V: warp w walks the tile's tokens 32w .. 32w + 31, each lane
//     owning d / 32 columns of every q row (one 4-byte shared load of V
//     per token), O rescaled by alpha per tile; the four warps' sums meet
//     in shared memory at the end.
//
// Head dims and groups.  d is any from 1 to 512, bf16 or f32 q, on
// instances D = 32, 64, 128, 256 and 512 (the smallest D >= d; at D=512 a
// stage is 64 tokens, 66 KB, the ring 198 KB): a token's row is
// d bytes in the pages and in the ring, S takes D / 16 lanes a token of
// which the first d / 16 hold q (the rest hold zeros and add zeros to the
// shuffle tree: 5 of 8 busy at d=80), and P V's lane owns D / 32 columns,
// those past d computed on whatever finite codes follow and never stored.
// Neither loop tests d.  A d that is not a multiple of 16 (ODD, its own
// instances of the general form) leaves the last 16-column piece of a row
// partial and the rows of codes aligned to d's largest power-of-two
// divisor (8 bytes at d = 72 or 40, 4 at 36, 1 at 33): each lane's q
// columns are read one at a time, zero past d; the codes are read from the
// ring at the rows' alignment (eft::hopper::load16_al; those past d are
// the next row's, finite, times q's zeros); the merge reads and writes a
// float at a time.  The ring itself needs no change: a tile's K or V
// codes are TILE d contiguous bytes from a 16-byte aligned start.
// A GQA group larger than the instance's GMAX (8; 4 at D=256 and 2 at
// D=512, whose O columns and q rows take twice and four times the
// registers) is cut into chunks of GMAX q heads,
// one block each (grid.y = Hkv * chunks): each chunk streams the run's
// bytes again, mostly from L2, and draws its own ticket.  Any page size
// that is a multiple of 128 holds whole tiles of 128 or 64.
//
// Layout, per serving/kv_cache.py of the port: pages int8
// [n_pages, 2, Hkv, ps, d] (0 = K, 1 = V), scales f32 [n_pages, 2, Hkv, 1, ps].

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "lse_merge.cuh"
#include "wgmma_tile.cuh"

namespace eft {
namespace decode {

// The launch's arguments, as eft_paged_decode takes them.
struct Args {
  const void *q, *pages, *scales, *page_table, *seq_lens, *slots;
  void *o_part, *lse, *o, *tickets;
  int batch, hq, hkv, d, ps, max_pages, max_seqs, window, n_split,
      pages_per_split;
  float scale;
  int q_f32, fused;
};

// eft_paged_decode's launch at a d that is not a multiple of 16
// (paged_decode_odd.cu)
int launch_odd(const Args& a, cudaStream_t stream);

}  // namespace decode
}  // namespace eft

namespace {

using namespace eft::hopper;
using eft::decode::Args;

constexpr int PAGE_TILE = 128;   // a page is a multiple of it
constexpr int STAGES = 3;        // tiles in the ring
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int MERGE_UNROLL = 8;  // 16-byte loads in flight a lane, merging

// the q heads of a block at instance D: a larger group is cut into chunks
template <int D>
constexpr int group_cap() { return D == 512 ? 2 : D == 256 ? 4 : 8; }

// Shared memory of one block: the ring (K codes, V codes, K scales, V
// scales per stage; the codes [TILE][d], d <= D), S [GMAX][TILE], P *
// v_scale [TILE][GMAX], alpha, m, l of each q row, the ticket drawn, the
// barriers.  The four warps' O sums reuse the ring.  TILE tokens a stage:
// 128, and 64 at D=512, where three stages of 128 would take 396 KB
template <int D, int GMAX>
struct Smem {
  static constexpr int TILE = D == 512 ? 64 : PAGE_TILE;
  static constexpr uint32_t CODES = TILE * D;
  static constexpr uint32_t STAGE = 2 * CODES + 2 * TILE * 4;
  static constexpr size_t ring = 0;
  static constexpr size_t s = ring + size_t(STAGES) * STAGE;
  static constexpr size_t p = s + size_t(GMAX) * TILE * 4;
  static constexpr size_t rows = p + size_t(TILE) * GMAX * 4;   // alpha, m, l
  static constexpr size_t ticket = rows + 3 * GMAX * 4;
  static constexpr size_t bars = (ticket + 4 + 15) / 16 * 16;
  static constexpr size_t bytes = bars + 8 * STAGES;
  static_assert(size_t(WARPS) * GMAX * D * 4 <= STAGE, "O sums fit a stage");
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// EXACT: d = D and the group is one chunk, so the instance's d and its
// block's q heads compile as constants, as an instance of that d alone
// would have them; the other instances read d and the chunk at run time.
// F32: q and O are f32 (B20 computes in q's dtype, serving/decode.py:700):
// q is read as f32, P * v_scale is not rounded, O is stored f32; the bf16
// instances compile as before.
template <int D, int GMAX, bool FUSED, bool EXACT, bool F32, bool ODD>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const std::conditional_t<F32, float, __nv_bfloat16>*
                        __restrict__ q,                    // [B, Hq, d]
                    const int8_t* __restrict__ pages,      // [n_pages, 2, Hkv, ps, d]
                    const float* __restrict__ scales,      // [n_pages, 2, Hkv, 1, ps]
                    const int* __restrict__ page_table,    // [max_seqs, max_pages]
                    const int* __restrict__ seq_lens,      // [max_seqs]
                    const int* __restrict__ slots,         // [B]
                    float* __restrict__ o_part,            // [B, Hq, n_split, 1, d]
                    float* __restrict__ lse,               // [B, Hq, n_split, 1]
                    std::conditional_t<F32, float, __nv_bfloat16>*
                        __restrict__ o,                    // [B, Hq, d] (FUSED)
                    int* __restrict__ tickets,             // [B * grid.y] (FUSED)
                    int hq, int hkv, int d_arg, int ps, int max_pages,
                    int max_seqs, int window, int pages_per_split,
                    float scale_log2) {
  using S = Smem<D, GMAX>;
  constexpr int TILE = S::TILE;
  constexpr int LPT = D / 16;          // lanes per token in S = q K^T
  constexpr int TPI = THREADS / LPT;   // tokens per pass of the block
  constexpr int CPL = D / 32;          // O columns per lane in P V
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_s = reinterpret_cast<float*>(smem + S::s);
  float* s_p = reinterpret_cast<float*>(smem + S::p);
  float* s_alpha = reinterpret_cast<float*>(smem + S::rows);
  float* s_m = s_alpha + GMAX;
  float* s_l = s_m + GMAX;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::bars);

  const int split = blockIdx.x, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = hq / hkv;
  const int d = EXACT ? D : d_arg;
  // the chunk of the GQA group (GMAX q heads each) and its KV head
  const int chunks = EXACT ? 1 : gridDim.y / hkv;
  const int kh = EXACT ? int(blockIdx.y) : blockIdx.y / chunks;
  const int g0 = EXACT ? 0 : (blockIdx.y % chunks) * GMAX;
  const int gn = EXACT ? group : min(GMAX, group - g0);  // its q heads
  const size_t row0 = size_t(b) * hq + size_t(kh) * group + g0;  // q row
  const uint32_t codes = uint32_t(TILE) * d;     // bytes of a code tile

  // this block's run: tokens [tok_begin, tok_end) of the sequence
  const int slot = slots[b];
  const bool valid = slot >= 0 && slot < max_seqs;
  const int n = valid ? min(seq_lens[slot], max_pages * ps) : 0;
  const int first_vis = window > 0 ? max(n - window, 0) : 0;
  const int run0 = first_vis / ps + split * pages_per_split;
  const int run1 = min(run0 + pages_per_split, (n + ps - 1) / ps);
  const int tok_begin = max(run0 * ps, first_vis);
  const int tok_end = min(run1 * ps, n);
  const int tile0 = tok_begin / TILE;
  const int n_tiles = tok_end > tok_begin ? (tok_end - 1) / TILE - tile0 + 1
                                          : 0;
  const int* pt = page_table + size_t(valid ? slot : 0) * max_pages;

  auto issue = [&](int i) {            // tile i of the run into its stage
    const int tok = (tile0 + i) * TILE;
    const size_t page = size_t(pt[tok / ps]);
    const int off = tok % ps;
    unsigned char* st = smem + S::ring + size_t(i % STAGES) * S::STAGE;
    uint64_t* bar = &full[i % STAGES];
    const size_t k_slab = (page * 2 * hkv + kh) * ps + off;   // K rows
    const size_t v_slab = k_slab + size_t(hkv) * ps;          // V rows
    mbar_arrive_expect_tx(bar, 2 * codes + 2 * TILE * 4);
    bulk_load(st, pages + k_slab * d, codes, bar);
    bulk_load(st + S::CODES, pages + v_slab * d, codes, bar);
    bulk_load(st + 2 * S::CODES, scales + k_slab, TILE * 4, bar);
    bulk_load(st + 2 * S::CODES + TILE * 4, scales + v_slab, TILE * 4, bar);
  };

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_init_fence();
    for (int i = 0; i < STAGES && i < n_tiles; ++i) issue(i);
  }

  // this lane's 16 columns of every q row of the chunk, in f32.  A lane
  // past d holds zeros: the codes it reads (finite, from the tile's next
  // rows) add exact zeros to S, and its P V columns are never stored, so
  // neither loop tests d
  const int chunk = lane % LPT;
  const int al = ODD ? row_align(d) : 16;    // the code rows' alignment
  float qr[GMAX][16];
#pragma unroll
  for (int g = 0; g < GMAX; ++g) {
#pragma unroll
    for (int e = 0; e < 16; ++e) qr[g][e] = 0.f;
    if (g < gn && chunk * 16 < d) {
      if constexpr (ODD) {
        const auto* src = q + (row0 + g) * d + chunk * 16;
        const int n = d - chunk * 16;
#pragma unroll
        for (int e = 0; e < 16; ++e)
          if (e < n) qr[g][e] = float(src[e]);
      } else if constexpr (F32) {
        const float4* src = reinterpret_cast<const float4*>(
            q + (row0 + g) * d + chunk * 16);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float4 f = src[x];
          qr[g][4 * x] = f.x;
          qr[g][4 * x + 1] = f.y;
          qr[g][4 * x + 2] = f.z;
          qr[g][4 * x + 3] = f.w;
        }
      } else {
        const __nv_bfloat16* src = q + (row0 + g) * d + chunk * 16;
        const uint4 raw[2] = {reinterpret_cast<const uint4*>(src)[0],
                              reinterpret_cast<const uint4*>(src)[1]};
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) qr[g][e] = __bfloat162float(h[e]);
      }
    }
  }
  // the softmax state of rows warp and warp + 4 (this warp's)
  float m_row[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l_row[2] = {0.f, 0.f};
  float acc[GMAX][CPL];
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[g][c] = 0.f;
  __syncthreads();                     // barriers initialized

  for (int i = 0; i < n_tiles; ++i) {
    const unsigned char* st = smem + S::ring + size_t(i % STAGES) * S::STAGE;
    const int8_t* k_s = reinterpret_cast<const int8_t*>(st);
    const int8_t* v_s = k_s + S::CODES;
    const float* ks_s = reinterpret_cast<const float*>(st + 2 * S::CODES);
    const float* vs_s = ks_s + TILE;
    const int base = (tile0 + i) * TILE;
    mbar_wait(&full[i % STAGES], (i / STAGES) & 1);

    // S = q K^T * k_scale * scale * log2(e), -inf outside the run's band
    for (int t = tid / LPT; t < TILE; t += TPI) {
      uint4 raw;
      if constexpr (ODD)
        raw = load16_al(k_s + t * d + chunk * 16, al, 16);
      else
        raw = *reinterpret_cast<const uint4*>(k_s + t * d + chunk * 16);
      const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
      float kf[16];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        float f[4];
        s8x4_to_f32(w[x], f);
#pragma unroll
        for (int e = 0; e < 4; ++e) kf[4 * x + e] = f[e];
      }
      float dot[GMAX];
#pragma unroll
      for (int g = 0; g < GMAX; ++g) {
        float sum = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) sum = fmaf(qr[g][e], kf[e], sum);
#pragma unroll
        for (int off = LPT / 2; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        dot[g] = sum;
      }
      if (chunk == 0) {
        const int col = base + t;
        const bool vis = col >= tok_begin && col < tok_end;
        const float kc = ks_s[t] * scale_log2;
#pragma unroll
        for (int g = 0; g < GMAX; ++g)
          if (g < gn) s_s[g * TILE + t] = vis ? dot[g] * kc : -CUDART_INF_F;
      }
    }
    __syncthreads();

    // the online softmax: warp w takes rows w and w + 4
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + WARPS * r;
      if (g >= gn) continue;
      float x[TILE / 32];
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) {
        x[j] = s_s[g * TILE + lane + 32 * j];
        mx = fmaxf(mx, x[j]);
      }
      const float m_new = fmaxf(m_row[r], warp_max(mx));
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < TILE / 32; ++j) {
        const int t = lane + 32 * j;
        const float p = exp2f(x[j] - m_use);                 // 0 where hidden
        psum += p;
        if constexpr (F32)
          s_p[t * GMAX + g] = x[j] == -CUDART_INF_F ? 0.f : p * vs_s[t];
        else
          s_p[t * GMAX + g] = x[j] == -CUDART_INF_F
              ? 0.f : __bfloat162float(__float2bfloat16(p * vs_s[t]));
      }
      const float alpha = exp2f(m_row[r] - m_use);
      l_row[r] = l_row[r] * alpha + warp_sum(psum);
      m_row[r] = m_new;
      if (lane == 0) s_alpha[g] = alpha;
    }
    __syncthreads();

    // O = alpha O + P V over this warp's TILE / 4 tokens
#pragma unroll
    for (int g = 0; g < GMAX; ++g) {
      const float a = g < gn ? s_alpha[g] : 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[g][c] *= a;
    }
    for (int t = warp * (TILE / WARPS); t < (warp + 1) * (TILE / WARPS);
         ++t) {
      float vf[CPL];
      const int8_t* vrow = v_s + t * d + CPL * lane;
      if constexpr (ODD && CPL >= 4) {
        // the row's alignment may be below CPL bytes
        const uint4 w = load16_al(vrow, min(al, CPL), CPL);
        float f[4];
        s8x4_to_f32(w.x, f);
#pragma unroll
        for (int c = 0; c < 4; ++c) vf[c] = f[c];
        if constexpr (CPL >= 8) {
          s8x4_to_f32(w.y, f);
#pragma unroll
          for (int c = 0; c < 4; ++c) vf[4 + c] = f[c];
        }
        if constexpr (CPL == 16) {
          s8x4_to_f32(w.z, f);
#pragma unroll
          for (int c = 0; c < 4; ++c) vf[8 + c] = f[c];
          s8x4_to_f32(w.w, f);
#pragma unroll
          for (int c = 0; c < 4; ++c) vf[12 + c] = f[c];
        }
      } else if constexpr (CPL == 16) {
        const uint4 w = *reinterpret_cast<const uint4*>(vrow);
        const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float f[4];
          s8x4_to_f32(ws[x], f);
#pragma unroll
          for (int c = 0; c < 4; ++c) vf[4 * x + c] = f[c];
        }
      } else if constexpr (CPL == 8) {
        const uint2 w = *reinterpret_cast<const uint2*>(vrow);
        float f[4];
        s8x4_to_f32(w.x, f);
#pragma unroll
        for (int c = 0; c < 4; ++c) vf[c] = f[c];
        s8x4_to_f32(w.y, f);
#pragma unroll
        for (int c = 0; c < 4; ++c) vf[4 + c] = f[c];
      } else if constexpr (CPL == 4) {
        float f[4];
        s8x4_to_f32(*reinterpret_cast<const uint32_t*>(vrow), f);
#pragma unroll
        for (int c = 0; c < 4; ++c) vf[c] = f[c];
      } else {
#pragma unroll
        for (int c = 0; c < CPL; ++c) vf[c] = float(vrow[c]);
      }
      float pg[GMAX];
      if constexpr (GMAX >= 4) {
#pragma unroll
        for (int g4 = 0; g4 < GMAX / 4; ++g4) {
          const float4 p4 =
              *reinterpret_cast<const float4*>(s_p + t * GMAX + 4 * g4);
          pg[4 * g4] = p4.x;
          pg[4 * g4 + 1] = p4.y;
          pg[4 * g4 + 2] = p4.z;
          pg[4 * g4 + 3] = p4.w;
        }
      } else {
#pragma unroll
        for (int g = 0; g < GMAX; ++g) pg[g] = s_p[t * GMAX + g];
      }
#pragma unroll
      for (int g = 0; g < GMAX; ++g)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[g][c] = fmaf(pg[g], vf[c], acc[g][c]);
    }
    __syncthreads();                   // the stage, S and P are free again
    if (tid == 0 && i + STAGES < n_tiles) issue(i + STAGES);
  }

  // the four warps' O sums meet in the (now idle) ring; rows' m and l
  float* red = reinterpret_cast<float*>(smem + S::ring);   // [WARPS][GMAX][D]
#pragma unroll
  for (int g = 0; g < GMAX; ++g)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      red[(warp * GMAX + g) * D + CPL * lane + c] = acc[g][c];
  if (lane == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int g = warp + WARPS * r;
      if (g < gn) {
        s_m[g] = m_row[r];
        s_l[g] = l_row[r];
      }
    }
  }
  __syncthreads();
  const bool direct = FUSED && n_split == 1;   // normalized bf16 O at once
  for (int g = 0; g < gn; ++g) {
    const float l = s_l[g];
    for (int col = tid; col < d; col += THREADS) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum += red[(w * GMAX + g) * D + col];
      const float val = sum / (l == 0.f ? 1.f : l);
      if (direct) {
        if constexpr (F32)
          o[(row0 + g) * d + col] = val;
        else
          o[(row0 + g) * d + col] = __float2bfloat16(val);
      }
      else
        o_part[((row0 + g) * n_split + split) * d + col] = val;
    }
  }
  if (!direct && tid < gn) {
    const float l = s_l[tid];
    lse[(row0 + tid) * n_split + split] =
        l == 0.f ? -CUDART_INF_F
                 : s_m[tid] * 0.6931471805599453f + logf(l);
  }
  if constexpr (FUSED) {
    if (direct) return;
    // arrive on the ticket once every thread's partial is written
    int* ticket = tickets + size_t(b) * gridDim.y + blockIdx.y;
    int* s_ticket = reinterpret_cast<int*>(smem + S::ticket);
    __syncthreads();
    if (tid == 0) {
      // release the block's partial, acquire the others' (if last)
      asm volatile("atom.add.acq_rel.gpu.global.s32 %0, [%1], 1;"
                   : "=r"(*s_ticket)
                   : "l"(ticket)
                   : "memory");
    }
    __syncthreads();
    if (*s_ticket != n_split - 1) return;
    // the last block: merge the n_split partials of the chunk's rows, a
    // row per L lanes (lse_merge.cuh); at D=512 four 16-byte loads in
    // flight a lane, each of its four chunks (eight would hold 128
    // registers of loads)
    constexpr int L = eft::MergeRow<D>::L;
    constexpr int NV = eft::MergeRow<D>::NV;
    constexpr int UNROLL = D == 512 ? 4 : MERGE_UNROLL;
    constexpr int RPW = 32 / L;        // rows per warp
#pragma unroll
    for (int gb = 0; gb < GMAX; gb += WARPS * RPW) {
      const int gw = gb + warp * RPW;  // this warp's first row
      if (gw >= gn) continue;          // the whole warp: its shuffles agree
      const int g = gw + lane / L;
      const size_t r = row0 + min(g, gn - 1);
      float4 merged[NV];
      eft::lse_merge_row<L, NV, UNROLL, true, ODD>(
          merged, o_part, lse, r * n_split, 1, n_split, d);
      if (g >= gn) continue;
#pragma unroll
      for (int c = 0; c < NV; ++c)
        if (eft::merge_chunk<L>(c, d)) {
          const int col = 4 * (lane % L + L * c);
          if constexpr (ODD)
            eft::store4_any(o + r * d + col, merged[c], d - col);
          else if constexpr (F32)
            *reinterpret_cast<float4*>(o + r * d + 4 * (lane % L + L * c)) =
                merged[c];
          else
            eft::store_bf16x4(o + r * d + 4 * (lane % L + L * c), merged[c]);
        }
    }
    if (tid == 0) *ticket = 0;         // zero again for the next launch
  }
}


template <int D, int GMAX, bool FUSED, bool EXACT, bool F32, bool ODD>
int launch(const Args& a, cudaStream_t stream) {
  using S = Smem<D, GMAX>;
  using TQ = std::conditional_t<F32, float, __nv_bfloat16>;
  const cudaError_t attr = cudaFuncSetAttribute(
      paged_decode_kernel<D, GMAX, FUSED, EXACT, F32, ODD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(S::bytes));
  if (attr != cudaSuccess) return int(attr);
  const int chunks = (a.hq / a.hkv + GMAX - 1) / GMAX;
  const dim3 grid(a.n_split, a.hkv * chunks, a.batch);
  paged_decode_kernel<D, GMAX, FUSED, EXACT, F32, ODD>
      <<<grid, THREADS, S::bytes, stream>>>(
      static_cast<const TQ*>(a.q),
      static_cast<const int8_t*>(a.pages), static_cast<const float*>(a.scales),
      static_cast<const int*>(a.page_table),
      static_cast<const int*>(a.seq_lens), static_cast<const int*>(a.slots),
      static_cast<float*>(a.o_part), static_cast<float*>(a.lse),
      static_cast<TQ*>(a.o), static_cast<int*>(a.tickets), a.hq,
      a.hkv, a.d, a.ps, a.max_pages, a.max_seqs, a.window, a.pages_per_split,
      a.scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

// ODD: the instances of a d that is not a multiple of 16 (alone in their
// own translation unit, paged_decode_odd.cu, which compiles beside this
// one)
template <bool ODD, int D, int GMAX, bool FUSED>
int launch_exact(const Args& a, cudaStream_t stream) {
  if constexpr (ODD) {
    if (a.q_f32) return launch<D, GMAX, FUSED, false, true, true>(a, stream);
    return launch<D, GMAX, FUSED, false, false, true>(a, stream);
  } else {
    // f32 q takes the general instances alone: the tuned EXACT form is
    // the bf16 path's
    if (a.q_f32) return launch<D, GMAX, FUSED, false, true, false>(a, stream);
    if (a.d == D && a.hq / a.hkv <= GMAX)
      return launch<D, GMAX, FUSED, true, false, false>(a, stream);
    return launch<D, GMAX, FUSED, false, false, false>(a, stream);
  }
}

// GMAX: the group rounded up to 1, 2, 4 or 8, at most group_cap<D>()
template <bool ODD, int D, bool FUSED>
int launch_group(const Args& a, cudaStream_t stream) {
  const int group = a.hq / a.hkv;
  if (group == 1) return launch_exact<ODD, D, 1, FUSED>(a, stream);
  if constexpr (group_cap<D>() == 2) {
    return launch_exact<ODD, D, 2, FUSED>(a, stream);
  } else {
    if (group == 2) return launch_exact<ODD, D, 2, FUSED>(a, stream);
    if (group <= 4 || group_cap<D>() == 4)
      return launch_exact<ODD, D, 4, FUSED>(a, stream);
    if constexpr (group_cap<D>() == 8)
      return launch_exact<ODD, D, 8, FUSED>(a, stream);
    return int(cudaErrorInvalidValue);
  }
}

template <bool ODD, int D>
int launch_fused(const Args& a, cudaStream_t stream) {
  return a.fused ? launch_group<ODD, D, true>(a, stream)
                 : launch_group<ODD, D, false>(a, stream);
}

// the instance of the smallest D >= d
template <bool ODD>
int launch_d(const Args& a, cudaStream_t stream) {
  if (a.d <= 32) return launch_fused<ODD, 32>(a, stream);
  if (a.d <= 64) return launch_fused<ODD, 64>(a, stream);
  if (a.d <= 128) return launch_fused<ODD, 128>(a, stream);
  if (a.d <= 256) return launch_fused<ODD, 256>(a, stream);
  return launch_fused<ODD, 512>(a, stream);
}

}  // namespace
