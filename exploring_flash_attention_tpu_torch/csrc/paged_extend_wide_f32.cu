// H6-extend at f32 q past d 256: eft_paged_extend's f32 launch at head dims
// d from 257 to 512 (paged_extend.cu takes f32 d up to 256 on the f32 core
// and calls launch_wide_f32 above it).  It computes H6-extend's function
// (the TPU kernels B21 and B22 that paged_extend.cu names) in q's dtype,
// as B21 and B22 do (serving/decode.py:700, :793): each chunk row attends
// causally (and under a window) over its sequence's paged int8 history, O
// f32.  The rounding is H6-extend f32's (paged_extend.cu): S and P V are
// bf16x3, q's and P * v_scale's three bf16 pieces against the codes, which
// bf16 holds exactly; each key's k_scale * scale * log2(e) folds into the
// exp2 constant, l sums the f32 p.
//
// The block is H5's f32 block in clusters of two (dtiled_attention.cuh,
// prefill_attention_wide_f32.cu says why), at its quantized kind: rank r
// holds d's columns [256 r, 256 r + 256) in two consumer warpgroups, S is
// the sum of the ranks' partials (exchange_s), and 32-key tiles stream
// beside Q's columns.  What H6-extend adds:
//   - the rows: 64 GQA-flattened chunk rows a cluster (row t is chunk
//     position t / G and q head kh G + t % G, as paged_extend.cu's rows).
//     They are no box of q, so the producer's 96 S threads copy them with
//     cp.async each tile (64 columns of 64 rows, 16 KB, from L2 after the
//     first tile) at the rows' alignment, zeros past d and past the chunk;
//     a 4-D tensor map would take them only where G divides 64;
//   - the codes: each 32-key tile lies in one page (a page is a multiple
//     of 128 keys), K and V code halves (64 columns) by TMA from the pages
//     viewed as [n_pages * 2 * Hkv, ps, d] at (column, offset, page * 2 *
//     Hkv + {0, Hkv} + kh), or at d % 16 != 0, where no tensor map takes
//     the rows (PACKED), copied with cp.async at their alignment; the
//     factors kc = k_scale * scale * log2(e) and vs = v_scale from the
//     page's scales, both 0 past the sequence's length (a reused page
//     holds old codes there);
//   - each row's band of keys [lo, hi] (its position, and the window),
//     masked on S; the tiles outside every row's band never loaded.
// Both ranks walk the same tiles: every bound comes from the cluster's
// (row tile, KV head, sequence).
//
// Cost: the tensor cores at long histories, three bf16 products a product
// (a 256-token chunk over 4,600 positions at d=512 is 4x the d=128 work).

#include "dtiled_attention.cuh"

namespace eft {
namespace extend {

int launch_wide_f32(const void* q, const void* pages, const void* scales,
                    const void* page_table, const void* seq_lens,
                    const void* slots, void* o, int batch, int c, int hq,
                    int hkv, int d, int ps, int max_pages, int max_seqs,
                    int n_pages, int window, float scale,
                    cudaStream_t stream);

}  // namespace extend
}  // namespace eft

namespace {

constexpr int WIDE_NC = 2;      // chunks a block; a cluster of two blocks
constexpr int WIDE_RANKS = 2;
// registers a thread after setmaxnreg: the producer's (its S threads copy
// Q's rows and read the page table), warpgroup 0's and warpgroup 1's (O 64
// and the fresh P V 64); the block keeps the launch's 3 x 168
constexpr int PRODUCER_REGS = 72;
constexpr int WG0_REGS = 224;
constexpr int OTHER_REGS = 208;
static_assert(PRODUCER_REGS + WG0_REGS + OTHER_REGS <=
                  3 * FCfg<WIDE_NC, KV_INT8>::LAUNCH_REGS,
              "the block's registers");

// blockIdx.y (AXIS 1) or blockIdx.z (2) read again from its special
// register (wgmma_tile.cuh's ctaid_x_again): what is computed from it is
// not a value kept live since the kernel's start
template <int AXIS>
__device__ __forceinline__ int ctaid_again() {
  uint32_t x;
  if constexpr (AXIS == 1)
    asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(x));
  else
    asm volatile("mov.u32 %0, %%ctaid.z;" : "=r"(x));
  return int(x);
}

// 64 flattened rows from t0 (row t at q_b + ((t / group) hq + t % group)
// d), FH f32 columns from col of each, into a plain [64][FH] f32 staging
// tile at the shared-window address dst, zeros past d and past `rows`;
// this thread's pieces of threads t, t + n, ... (cp.async, the caller
// commits the group; wgmma_tile.cuh stage16)
__device__ __forceinline__ void stage_q_flat_f32(uint32_t dst,
                                                 const float* q_b, int t0,
                                                 int rows, int group, int hq,
                                                 int d, int col, int t,
                                                 int n) {
  constexpr int P = FH * 4 / 16;        // 16-byte pieces a row
  const int al = row_align(4 * d);
  for (int e = t; e < BQ * P; e += n) {
    const int r = e / P, p = e % P, tr = t0 + r;
    const float* src =
        q_b + (size_t(tr / group) * hq + tr % group) * d + col + 4 * p;
    stage16(dst + r * FH * 4 + 16 * p, src, al,
            tr < rows ? 4 * (d - col - 4 * p) : 0);
  }
}

// The producer warpgroup of the block (thread pt of 128): per tile of the
// keys [kv_begin, kv_begin + FKV n_tiles) of the sequence whose page table
// row is `table` and KV head kh, its S halves (Q's flattened rows and K's
// codes, 64 columns each, from the block's first column c0) and its keys'
// factors for S threads 0-95, its V halves for warp 3 (produce_f32's
// loop, the rows and codes from the pages)
template <bool PACKED>
__device__ __forceinline__ void produce_paged_f32(
    const CUtensorMap* tkv, unsigned char* smem, FBars<WIDE_NC>* bars,
    const float* q_b, int t0, int rows, int group, int hq,
    const int8_t* pages, const float* scales, const int* table, int hkv,
    int kh, int ps, int d, int n, int kv_begin, int n_tiles,
    float scale_log2, int c0) {
  constexpr int NC = WIDE_NC;
  using C = FCfg<NC, KV_INT8>;
  const int pt = threadIdx.x - NC * 128;
  // the page row (of n_pages * 2 * Hkv) of K (kv 0) or V (kv 1) at key kv0
  auto page_row = [&](int kv0, int kv) {
    return (table[kv0 / ps] * 2 + kv) * hkv + kh;
  };
  if (pt < S_THREADS) {
    float* fac = reinterpret_cast<float*>(smem + C::fac);
    const int n_items = n_tiles * C::NS;
    // item j (tile j / NS, columns c0 + 64 (j % NS) ..): Q's rows by
    // cp.async, K's codes by TMA (one arrival on stage_full) or PACKED by
    // cp.async; one cp.async group an item
    auto issue = [&](int j) {
      const int s = j % 2, kv0 = kv_begin + j / C::NS * FKV;
      const int col = c0 + (j % C::NS) * FH;
      unsigned char* st = smem + C::stage + s * C::STAGE_BYTES;
      stage_q_flat_f32(smem_u32(st), q_b, t0, rows, group, hq, d, col, pt,
                       S_THREADS);
      if constexpr (PACKED) {
        stage_half<1>(smem_u32(st + C::STAGE_Q), pages,
                      size_t(page_row(kv0, 0)) * ps, kv0 % ps, FKV, ps, d,
                      col, pt, S_THREADS);
      } else if (pt == 0) {
        mbar_arrive_expect_tx(&bars->stage_full[s], C::STAGE_KV);
        tma_load_3d(st + C::STAGE_Q, tkv, &bars->stage_full[s], col,
                    kv0 % ps, page_row(kv0, 0));
      }
      cp_async_commit();
    };
    for (int j = 0; j < 2; ++j) {
      if (j < n_items) issue(j);
      else cp_async_commit();
    }
    for (int j = 0; j < n_items; ++j) {
      const int i = j / C::NS, h = j % C::NS, s = j % 2;
      const unsigned char* st = smem + C::stage + s * C::STAGE_BYTES;
      unsigned char* slot = smem + C::sk + s * C::SK_BYTES;
      mbar_wait(&bars->sk_empty[s], ((j / 2) & 1) ^ 1);
      cp_async_wait<1>();                      // this thread's copies of j
      named_bar_sync(SLOT_BAR, S_THREADS);     // and every thread's
      if constexpr (!PACKED) mbar_wait(&bars->stage_full[s], (j / 2) & 1);
      split_staged<KV_BF16>(slot, FQ_PIECE, BQ, 0, st, pt, S_THREADS);
      split_staged<KV_INT8>(slot + 3 * FQ_PIECE, FK_PIECE, FKV, 0,
                            st + C::STAGE_Q, pt, S_THREADS);
      if (h == 0) {
        // tile i's factors, zero past the sequence
        const int f = i % 2, kv0 = kv_begin + i * FKV;
        const float* gk = scales + size_t(page_row(kv0, 0)) * ps + kv0 % ps;
        const float* gv = scales + size_t(page_row(kv0, 1)) * ps + kv0 % ps;
        mbar_wait(&bars->fac_empty[f], ((i / 2) & 1) ^ 1);
        for (int t = pt; t < FKV; t += S_THREADS) {
          const bool in = kv0 + t < n;
          fac[f * 2 * FKV + t] = in ? gk[t] * scale_log2 : 0.f;
          fac[f * 2 * FKV + FKV + t] = in ? gv[t] : 0.f;
        }
      }
      fence_proxy_async();
      mbar_arrive(&bars->sk_full[s]);
      named_bar_sync(SLOT_BAR, S_THREADS);     // staging s read
      if (j + 2 < n_items) issue(j + 2);
      else cp_async_commit();
    }
  } else {
    // V halves: item j is tile j / (2 NC), the block's chunk j / 2 % NC,
    // columns 64 (j % 2) .. + 63 of the chunk
    const int lane = pt - S_THREADS;
    const int n_items = n_tiles * NC * 2;
    auto issue = [&](int j) {
      const int kv0 = kv_begin + j / (2 * NC) * FKV;
      const int col = c0 + j / 2 % NC * DC + j % 2 * FH;
      unsigned char* st = smem + C::vstage + (j % 2) * C::STAGE_KV;
      if constexpr (PACKED) {
        stage_half<1>(smem_u32(st), pages, size_t(page_row(kv0, 1)) * ps,
                      kv0 % ps, FKV, ps, d, col, lane, 32);
        cp_async_commit();
      } else if (lane == 0) {
        mbar_arrive_expect_tx(&bars->vstage_full[j % 2], C::STAGE_KV);
        tma_load_3d(st, tkv, &bars->vstage_full[j % 2], col, kv0 % ps,
                    page_row(kv0, 1));
      }
    };
    for (int j = 0; j < 2; ++j) {
      if (j < n_items) issue(j);
      else if constexpr (PACKED) cp_async_commit();
    }
    for (int j = 0; j < n_items; ++j) {
      const int jc = j / 2, c = jc % NC, s = jc % C::V_SLOTS;
      if (j % 2 == 0)
        mbar_wait(&bars->v_empty[s], ((jc / C::V_SLOTS) & 1) ^ 1);
      if constexpr (PACKED) {
        cp_async_wait<1>();
        __syncwarp();
      } else {
        mbar_wait(&bars->vstage_full[j % 2], (j / 2) & 1);
      }
      split_staged<KV_INT8>(smem + C::v + s * C::V_BYTES, FV_PIECE, FKV,
                            (j % 2) * FH,
                            smem + C::vstage + (j % 2) * C::STAGE_KV, lane,
                            32);
      if (j % 2 == 1) {
        fence_proxy_async();
        mbar_arrive(&bars->v_full[c]);
      }
      __syncwarp();                            // staging read
      if (j + 2 < n_items) issue(j + 2);
      else if constexpr (PACKED) cp_async_commit();
    }
  }
}

// O / l of this thread's two flattened rows t and t + 8, columns [col, col
// + 128) cut at d, f32, at their addresses in o_b (laid out as q); a row
// with l = 0 (it saw no key) stores 0.  ANY: a value at a time
template <bool ANY>
__device__ __forceinline__ void store_flat_rows_f32(
    const float (&acc_o)[DC / 2], const float (&l)[2], float* o_b, int t,
    int rows, int group, int hq, int d, int col) {
  const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int tr = t + 8 * r;
    if (tr >= rows) continue;
    const float denom = l_row == 0.f ? 1.f : l_row;
    float* orow = o_b + (size_t(tr / group) * hq + tr % group) * d + col;
#pragma unroll
    for (int j = 0; j < DC / 8; ++j) {
      if (col + 8 * j >= d) continue;
      const float x0 = acc_o[4 * j + 2 * r] / denom;
      const float x1 = acc_o[4 * j + 2 * r + 1] / denom;
      const int c = 8 * j + col0;
      if constexpr (!ANY) {
        *reinterpret_cast<float2*>(orow + c) = make_float2(x0, x1);
      } else {
        if (col + c < d) orow[c] = x0;
        if (col + c + 1 < d) orow[c + 1] = x1;
      }
    }
  }
}

template <bool PACKED>
__global__ void __launch_bounds__(FCfg<WIDE_NC, KV_INT8>::THREADS, 1)
paged_extend_wide_f32_kernel(
    const __grid_constant__ CUtensorMap tkv,  // [P*2*Hkv, ps, d] int8
    const int8_t* __restrict__ pages,         // [n_pages, 2, Hkv, ps, d]
    const float* __restrict__ q,              // [B, C, Hq, d]
    const float* __restrict__ scales,         // [n_pages, 2, Hkv, 1, ps]
    const int* __restrict__ page_table,       // [max_seqs, max_pages]
    const int* __restrict__ seq_lens,         // [max_seqs]
    const int* __restrict__ slots,            // [B]
    float* __restrict__ o,                    // [B, C, Hq, d]
    int c, int hq, int hkv, int d, int ps, int max_pages, int max_seqs,
    int window, float scale_log2) {
  constexpr int NC = WIDE_NC;
  using C = FCfg<NC, KV_INT8>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto* bars = reinterpret_cast<FBars<NC>*>(smem + C::bars);

  // the cluster's (row tile, KV head, sequence), the last row tile first:
  // it sees the most keys; rank r holds d's columns [256 r, 256 r + 256)
  const uint32_t ranks = cluster_size();
  const int c0 = int(cluster_rank()) * C::D;
  const int group = hq / hkv;
  const int rows = c * group;
  const int t0 = (gridDim.x / ranks - 1 - blockIdx.x / ranks) * BQ;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int wg = threadIdx.x / 128;

  const int slot = slots[b];
  const bool valid = slot >= 0 && slot < max_seqs;
  const int n = valid ? min(seq_lens[slot], max_pages * ps) : 0;
  const int q_start = n - c;                   // position of chunk row 0
  // the key tiles some row of this block sees: up to the last row's
  // position, from the first row's band edge (rounded down to a tile) on
  const int kv_end = max(q_start + (min(t0 + BQ, rows) - 1) / group + 1, 0);
  const int kv_begin =
      window > 0 ? max(q_start + t0 / group - window + 1, 0) / FKV * FKV : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + FKV - 1) / FKV : 0;
  const int* table = page_table + size_t(valid ? slot : 0) * max_pages;

  init_f32_bars(bars, ranks);
  cluster_sync();             // every rank's barriers ready

  const int lane = threadIdx.x % 32;
  const int rl = threadIdx.x / 32 % 4 * 16 + lane / 4;
  float acc_o[DC / 2], m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  // O / l into the chunk's columns of the rows in q's layout from [b, 0,
  // kh * group], whose offset is found again here from the block's indices
  // read anew: a 64-bit offset kept from the kernel's start stays live over
  // the whole key loop (ptxas spilled it, 8 bytes, at every register split
  // tried)
  auto store = [&](const float (&acc_o)[DC / 2], const float (&l)[2]) {
    const size_t head0 = (size_t(ctaid_again<2>()) * c * hq +
                          size_t(ctaid_again<1>()) * group) * d;
    const int col = c0 + wg * DC;
    if (d % 8 != 0)
      store_flat_rows_f32<true>(acc_o, l, o + head0, t0 + rl, rows, group,
                                hq, d, col);
    else
      store_flat_rows_f32<false>(acc_o, l, o + head0, t0 + rl, rows, group,
                                 hq, d, col);
  };
  if (wg == NC) {
    set_regs<PRODUCER_REGS, C::LAUNCH_REGS>();
    const size_t head0 = (size_t(b) * c * hq + size_t(kh) * group) * d;
    produce_paged_f32<PACKED>(&tkv, smem, bars, q + head0, t0, rows, group,
                              hq, pages, scales, table, hkv, kh, ps, d, n,
                              kv_begin, n_tiles, scale_log2, c0);
  } else if (wg == 0) {
    set_regs<WG0_REGS, C::LAUNCH_REGS>();
    // each owned row sees keys [lo, hi] (a row past the chunk none)
    int lo[2], hi[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = t0 + rl + 8 * r;
      const int pos = q_start + t / group;
      hi[r] = t < rows ? pos : -1;
      lo[r] = window > 0 ? max(pos - window + 1, 0) : 0;
    }
    key_loop_f32<NC, KV_INT8, true>(
        smem, bars, kv_begin, n_tiles,
        [lo, hi](int r, int key) { return key >= lo[r] && key <= hi[r]; },
        acc_o, m, l, ranks);
    share_l_f32<NC, KV_INT8, true>(smem, l);
    store(acc_o, l);
  } else {
    set_regs<OTHER_REGS, C::LAUNCH_REGS>();
    key_loop_f32<NC, KV_INT8, false>(
        smem, bars, kv_begin, n_tiles, [](int, int) { return true; }, acc_o,
        m, l, ranks);
    share_l_f32<NC, KV_INT8, false>(smem, l);
    store(acc_o, l);
  }
  cluster_sync();             // no rank still reads this block's buffer
}

template <bool PACKED>
int launch_extend_wide_f32(const void* q, const void* pages,
                           const void* scales, const void* page_table,
                           const void* seq_lens, const void* slots, void* o,
                           int batch, int c, int hq, int hkv, int d, int ps,
                           int max_pages, int max_seqs, int n_pages,
                           int window, float scale, cudaStream_t stream) {
  using C = FCfg<WIDE_NC, KV_INT8>;
  CUtensorMap tkv = {};
  if constexpr (!PACKED) {
    const int err = make_tmap(&tkv, pages, 1, d, ps, n_pages * 2 * hkv, FH,
                              FKV, 0);
    if (err) return err;
  }
  auto kernel = paged_extend_wide_f32_kernel<PACKED>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::bytes));
  if (attr != cudaSuccess) return int(attr);
  const int rows = c * (hq / hkv);
  const ClusterLaunch l(dim3((rows + BQ - 1) / BQ * WIDE_RANKS, hkv, batch),
                        WIDE_RANKS, C::THREADS, C::bytes, stream);
  const cudaError_t err = cudaLaunchKernelEx(
      &l.cfg, kernel, tkv, static_cast<const int8_t*>(pages),
      static_cast<const float*>(q), static_cast<const float*>(scales),
      static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
      static_cast<const int*>(slots), static_cast<float*>(o), c, hq, hkv, d,
      ps, max_pages, max_seqs, window, scale * 1.4426950408889634f);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // namespace

namespace eft {
namespace extend {

int launch_wide_f32(const void* q, const void* pages, const void* scales,
                    const void* page_table, const void* seq_lens,
                    const void* slots, void* o, int batch, int c, int hq,
                    int hkv, int d, int ps, int max_pages, int max_seqs,
                    int n_pages, int window, float scale,
                    cudaStream_t stream) {
  auto go = [&](auto packed) {
    return launch_extend_wide_f32<decltype(packed)::value>(
        q, pages, scales, page_table, seq_lens, slots, o, batch, c, hq, hkv,
        d, ps, max_pages, max_seqs, n_pages, window, scale, stream);
  };
  // rows of codes of d % 16 != 0 bytes: no tensor map takes them
  return d % 16 != 0 ? go(std::true_type{}) : go(std::false_type{});
}

}  // namespace extend
}  // namespace eft
