// H6-extend: chunked-prefill attention over the paged INT8 KV cache on
// Hopper (sm_90a).  bf16 q, int8 pages, f32 accumulate, bf16 O; f32 q
// takes paged_extend_f32_kernel below (f32_attention.cuh's f32 core on
// wgmma, bf16x3 on q and P * v_scale), O f32.
//
// Replaces two TPU kernels of the JAX package that compute the same
// function and differ only by a VMEM rule (serving/decode.py:645-646):
//   B21 _extend_kernel           exploring_flash_attention_tpu/serving/decode.py:257
//   B22 _extend_onepass_kernel   exploring_flash_attention_tpu/serving/decode.py:455
// B22 holds all of a sequence's pages resident, B21 streams them.  Each
// sequence's C newest tokens are already appended to the cache (so they
// read themselves back quantized) and attend causally over its paged
// history: chunk row i sits at position q_start + i, where q_start =
// seq_lens[slot] - C, and sees column col iff col <= q_start + i and, with
// a sliding window, col >= q_start + i - window + 1 (decode.py:368-369).
//
// Cost at the multi-turn slice (B=8, C=256, Hq=8, Hkv=4, d=128, chunk at
// 279..534): 3.4 GFLOP and 4.6 MB of int8 pages and scales per layer,
// microseconds of either; in the windowed model's second turn (C=256 over
// ~4,600 positions, window 4096) 34 GFLOP, 0.035 ms at 989 TFLOP/s bf16:
// the tensor cores, which only wgmma reaches.
//
// Design (H4-kvq's block, kvquant_attention.cu, on wgmma_tile.cuh).  One
// block per (128-row tile of the GQA-flattened chunk rows, KV head,
// sequence): row r is chunk position r / G and q head kh * G + r % G
// (decode.py:326-329), so the G q heads share every K/V tile the block
// loads; rows past C * G are zero.  Two consumer warpgroups of 64 rows and
// one producer warpgroup (setmaxnreg: 56 and 224 per thread):
//   - each consumer warpgroup stages its 64 Q rows straight from q [B, C,
//     Hq, d] into the 128-byte-swizzled layout a TMA load would give (the
//     flattened rows are not a box of q);
//   - the producer's first thread reads the page table on the device (no
//     host sync) and loads the code tiles K_0, V_0, K_1, ... (128 keys of
//     one page each: the page size is a multiple of 128, so a tile never
//     straddles a page) by TMA through a ring of three code slots, the
//     pages viewed as [n_pages * 2 * Hkv, ps, d] at (0, offset, page * 2 *
//     Hkv + {0, Hkv} + kh); all 128 producer threads convert each tile
//     exactly to bf16, K in the K-major layout S = Q K^T reads and V in the
//     MN-major one P V reads (convert_codes_tile), into two converted
//     stages, and write per key k_scale * scale * log2(e) and v_scale, both
//     zero past seq_lens (a freed and reused page holds old codes past the
//     tail, as B22 guards at decode.py:587-588);
//   - each consumer warpgroup runs H1's loop: S on bf16 wgmma into
//     registers, s * (k_scale * scale * log2 e) per column (B21's S *
//     k_scale in the exp2 basis), the mask by selects in the edge tiles
//     only, the online softmax in f32 with l summing the unscaled p (B21,
//     decode.py:383-386), P * v_scale rounded to bf16 as the A fragment of
//     P V on bf16 wgmma, S of tile i overlapping P V of tile i - 1.
// Tiles are skipped per Q tile: those past the last row's position, and,
// under a window, those before the first row's band (pages wholly before
// every row's band are never read).  A row that sees nothing gives zeros.
// No wgmma sits under a branch of its own (ptxas would serialize them all,
// C7520).
//
// Layout, per serving/kv_cache.py of the port: pages int8
// [n_pages, 2, Hkv, ps, d] (0 = K, 1 = V), scales f32 [n_pages, 2, Hkv, 1, ps];
// q and o [B, C, Hq, d].
//
// Budget at d=128, as H4-kvq's: Q 32 KB, two converted stages of K and V
// 128 KB, three code slots 48 KB, scales 2 KB.
//
// Head dims, groups and pages.  d is any from 1 to 256 (257 to 512:
// paged_extend_wide.cu, on H5's block, and at f32 q
// paged_extend_wide_f32.cu, on H5's f32 block in clusters of two), on
// instances D = 64, 128 and 256 (the smallest D >= d): the code tiles are
// loaded by TMA as boxes of D columns from the pages described with their
// true d, so the columns past d arrive as zero codes, convert to zero K and
// V, add nothing to S and give O columns that the epilogue does not store;
// the consumers stage d columns of Q and zeros past them.  The padded work
// is (D - d) / D of the products (37.5% at d=80).  At D=256 O takes 128
// registers a consumer thread, so the K/V tile is 64 keys (S 32 + P 16 +
// O 128 within the 224), and Q 64 KB + two converted stages 128 KB leave
// room for two code slots (32 KB): 226 KB.  Any group: the chunk rows are
// GQA-flattened (C * G rows), nothing else reads G.  Any page size that is
// a multiple of 128: a tile of 128 (or 64) keys never straddles a page,
// and the box is one tile of one page whatever the page's length.
//
// Rows of codes that are not a multiple of 16 bytes (d % 16 != 0) cannot
// be described to TMA.  There the producer's first thread brings each
// tile as H6-decode does, one 1-D bulk copy of its BKV d contiguous bytes
// (16-byte aligned: a tile starts a multiple of 64 rows into its page)
// into the code slot, and the converters read it at the rows' alignment,
// zero past d (convert_code_rows); q is staged and O stored a value at a
// time where its rows are not 16-byte aligned (d % 8 != 0).  The f32
// kernel's producer reads the codes at the rows' alignment too.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

#include "f32_attention.cuh"
#include "wgmma_tile.cuh"

namespace eft {
namespace extend {

// eft_paged_extend's launch at bf16 d 257 to 512 (paged_extend_wide.cu, on
// wide_attention.cuh's block: H5's, with the masks)
int launch_wide(const void* q, const void* pages, const void* scales,
                const void* page_table, const void* seq_lens,
                const void* slots, void* o, int batch, int c, int hq,
                int hkv, int d, int ps, int max_pages, int max_seqs,
                int n_pages, int window, float scale, cudaStream_t stream);

// its launch at f32 q, d 257 to 512 (paged_extend_wide_f32.cu, on H5's f32
// block in clusters of two: bf16x3 against the codes)
int launch_wide_f32(const void* q, const void* pages, const void* scales,
                    const void* page_table, const void* seq_lens,
                    const void* slots, void* o, int batch, int c, int hq,
                    int hkv, int d, int ps, int max_pages, int max_seqs,
                    int n_pages, int window, float scale,
                    cudaStream_t stream);

}  // namespace extend
}  // namespace eft

namespace {

using namespace eft::hopper;

constexpr int BQ = 128;          // flattened chunk rows per block
constexpr int STAGES = 2;        // converted K/V stages
constexpr int CONSUMERS = 2;     // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * 128;  // + the producer warpgroup
constexpr int CONVERTERS = 128;  // the whole producer warpgroup
constexpr int SLOT_BAR = 1;      // named barrier: a code slot read
constexpr int Q_BAR = 2;         // named barriers 2, 3: a warpgroup's Q rows
// registers per thread after setmaxnreg: 128 * 56 + 256 * 224 = 384 * 168,
// what the launch allocates (more, and the consumers' setmaxnreg.inc waits
// forever)
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS = 224;

// Shared memory of one block.  Q and the converted K and V are boxes of 64
// bf16 columns (128-byte rows, the swizzle width) by their rows, box after
// box; a code slot is a plain [BKV][D] tile of codes.  Each stage's scales:
// k_scale * scale * log2e per key, then v_scale per key.  K/V tiles of BKV
// keys (128; 64 at D=256), SLOTS code slots (3; 2 at D=256).
template <int D>
struct Tiles {
  static constexpr int BKV = D == 256 ? 64 : 128;
  static constexpr int SLOTS = D == 256 ? 2 : 3;
  static constexpr int NBOX = D / 64;
  static constexpr uint32_t Q_BYTES = BQ * D * 2;
  static constexpr uint32_t CONV_BYTES = BKV * D * 2;
  static constexpr uint32_t CODE_BYTES = BKV * D;
  static constexpr int SCALES = 2 * BKV;            // floats per stage
  static constexpr size_t q = 0;
  static constexpr size_t k = q + Q_BYTES;
  static constexpr size_t v = k + size_t(STAGES) * CONV_BYTES;
  static constexpr size_t codes = v + size_t(STAGES) * CONV_BYTES;
  static constexpr size_t scales = codes + size_t(SLOTS) * CODE_BYTES;
  static constexpr size_t bars = scales + size_t(STAGES) * SCALES * 4;
  static constexpr size_t bytes = bars + 8 * (SLOTS + 3 * STAGES) + 1024;
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
    wgmma_rs_bf16_n256(o, a, db,
                       gmma_desc(v_k + 2 * BKV * 128, BKV * 128, 1024, 128));
  else if constexpr (D == 128)
    wgmma_rs_bf16_n128(o, a[0], a[1], a[2], a[3], db, 1);
  else
    wgmma_rs_bf16_n64(o, a[0], a[1], a[2], a[3], db, 1);
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
// k_scale * scale * log2e of this thread's columns), the columns outside
// each row's [lo, hi] masked unless the tile is whole, the new row max
// (quad shuffles), p = exp2(s - m_use) in f32; alpha = exp2(m_old - m_use)
template <int N>
__device__ __forceinline__ void softmax_exp(float (&acc_s)[N],
                                            float (&m)[2], float (&alpha)[2],
                                            bool whole, int col_base,
                                            const int (&lo)[2],
                                            const int (&hi)[2],
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
      const int col = col_base + acc_col(e);
      acc_s[e] = col >= lo[r] && col <= hi[r] ? acc_s[e] * kc[acc_col(e)]
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

// l = l * alpha + the f32 p (unscaled, as B21 sums it); P * v_scale packed
// as the bf16 A fragment of P V (vs: this thread's columns' v_scale)
template <int N>
__device__ __forceinline__ void pack_p(const float (&p)[N],
                                       uint32_t (&pa)[N / 2], float (&l)[2],
                                       const float (&alpha)[2],
                                       const float* vs) {
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const int col = acc_col(2 * j);
    psum[j & 1] += p[2 * j] + p[2 * j + 1];
    pa[j] = pack_bf16x2(p[2 * j] * vs[col], p[2 * j + 1] * vs[col + 1]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
}

// A consumer warpgroup's 64 Q rows from flattened chunk row t0 + 64 wg on,
// zero past the chunk's rows and past d, swizzled as TMA would: flattened
// row t is chunk position t / group and q head t % group of q_b, the
// sequence's [C, Hq, d] from its KV head's first q head on.  PACKED (d %
// 16 != 0): rows that are no multiple of 16 bytes (d % 8 != 0) are read a
// value at a time
template <int D, bool PACKED>
__device__ __forceinline__ void stage_q_rows(unsigned char* sq,
                                             const __nv_bfloat16* q_b,
                                             int wg, int ct, int t0,
                                             int rows, int group, int hq,
                                             int d) {
  for (int x = ct; x < 64 * (D / 8); x += 128) {
    const int r = wg * 64 + x / (D / 8), ch = x % (D / 8);
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < rows && ch * 8 < d) {
      const __nv_bfloat16* src =
          q_b + (size_t(t / group) * hq + t % group) * d + ch * 8;
      if (!PACKED || d % 8 == 0) {
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

// O / l of this thread's two flattened rows t and t + 8, bf16, their first
// d columns at their addresses in o_b (laid out as q_b above); a row with
// l = 0 (it saw no key) stores 0.  PACKED: a value at a time where d % 8
// != 0
template <int D, bool PACKED>
__device__ __forceinline__ void store_chunk_rows(const float (&acc_o)[D / 2],
                                                 const float (&l)[2],
                                                 __nv_bfloat16* o_b, int t,
                                                 int rows, int group, int hq,
                                                 int d) {
  const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int tr = t + 8 * r;
    if (tr >= rows) continue;
    const float denom = l_row == 0.f ? 1.f : l_row;
    __nv_bfloat16* orow = o_b + (size_t(tr / group) * hq + tr % group) * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= d) continue;
      const float x0 = acc_o[4 * j + 2 * r] / denom;
      const float x1 = acc_o[4 * j + 2 * r + 1] / denom;
      const int col = 8 * j + col0;
      if (!PACKED || d % 8 == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) orow[col] = __float2bfloat16(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// A [rows][d] tile of int8 codes packed at src (rows of d bytes, at the
// alignment of d) -> bf16 in the layout convert_codes_tile gives, zeros
// past d (D columns); thread t of n
template <int D>
__device__ __forceinline__ void convert_code_rows(const unsigned char* src,
                                                  unsigned char* dst,
                                                  int rows, int d, int t,
                                                  int n) {
  constexpr int PIECES = D / 16;
  const int al = row_align(d);
  for (int x = t; x < rows * PIECES; x += n) {
    const int row = x / PIECES, c = (x % PIECES) * 16;
    uint32_t out[8];
    codes16_convert<KV_INT8, false>(
        c < d ? load16_al(src + size_t(row) * d + c, al, d - c)
              : make_uint4(0u, 0u, 0u, 0u), out);
    unsigned char* box = dst + (c / 64) * rows * 128;
    const int byte = (c % 64) * 2;
    *reinterpret_cast<uint4*>(box + swz128(row, byte)) =
        make_uint4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint4*>(box + swz128(row, byte + 16)) =
        make_uint4(out[4], out[5], out[6], out[7]);
  }
}

// One consumer warpgroup's 64 rows of the block (this thread owns two):
// stages its Q rows, runs H1's loop over the tiles [kv_begin, kv_begin +
// 128 n_tiles), then writes O / l to its rows of o.  Per tile i, S of tile
// i is issued; O is rescaled by tile i - 1's alpha while it runs; P V of
// tile i - 1 is issued behind it; the softmax of tile i runs while P V is
// in flight; after P V has landed, P of tile i is packed.
template <int D, bool PACKED>
__device__ __forceinline__ void consume(
    unsigned char* sq, const unsigned char* sk, const unsigned char* sv,
    const float* sscale, uint64_t* k_full, uint64_t* v_full, uint64_t* empty,
    const __nv_bfloat16* q, __nv_bfloat16* o, int b, int kh, int c, int hq,
    int group, int d, int t0, int q_start, int window, int kv_begin,
    int n_tiles) {
  using T = Tiles<D>;
  constexpr int BKV = T::BKV;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int ct = threadIdx.x % 128;
  const int rows = c * group;

  // this warpgroup's Q rows, swizzled as TMA would; at d = D inlined
  // apart, with constant strides
  const __nv_bfloat16* q_b =
      q + size_t(b) * c * hq * d + size_t(kh) * group * d;
  if (!PACKED && d == D)
    stage_q_rows<D, false>(sq, q_b, wg, ct, t0, rows, group, hq, D);
  else
    stage_q_rows<D, PACKED>(sq, q_b, wg, ct, t0, rows, group, hq, d);
  fence_proxy_async();
  named_bar_sync(Q_BAR + wg, 128);

  // each owned row sees keys [lo, hi]; a row past the chunk sees none
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + r0 + 8 * r;
    const int pos = q_start + t / group;
    hi[r] = t < rows ? pos : -1;
    lo[r] = window > 0 ? max(pos - window + 1, 0) : 0;
  }
  // a tile is whole (no key of it masked for any row of this warpgroup)
  // when it ends at or before the first row's position and, under a
  // window, starts inside the last row's band
  const int wg_first = q_start + (t0 + wg * 64) / group;
  const int wg_last = q_start + min(t0 + wg * 64 + 63, rows - 1) / group;
  auto is_whole = [&](int kv0) {
    bool whole = kv0 + BKV - 1 <= wg_first;
    if (window > 0) whole = whole && kv0 >= wg_last - window + 1;
    return whole;
  };

  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc_o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_o[i] = 0.f;
  const unsigned char* q_wg = sq + wg * 64 * 128;

  if (n_tiles > 0) {
    float alpha[2];
    uint32_t pa[BKV / 4];
    {
      // tile 0 (O is still zero: no rescale)
      float acc_s[BKV / 2];
      mbar_wait(&k_full[0], 0);
      wgmma_fence();
      issue_qk<D>(acc_s, q_wg, sk);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_s);
      softmax_exp(acc_s, m, alpha, is_whole(kv_begin), kv_begin + col0, lo,
                  hi, sscale + col0);
      mbar_wait(&v_full[0], 0);
      pack_p(acc_s, pa, l, alpha, sscale + BKV + col0);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int s = i % STAGES, prev = (i - 1) % STAGES;
      const int kv0 = kv_begin + i * BKV;
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
      softmax_exp(acc_s, m, alpha, is_whole(kv0), kv0 + col0, lo, hi,
                  sc + col0);
      wgmma_wait<0>();                   // P V of tile i - 1
      fence_regs(acc_o);
      fence_regs(pa);
      mbar_arrive(&empty[prev]);
      mbar_wait(&v_full[s], (i / STAGES) & 1);
      pack_p(acc_s, pa, l, alpha, sc + BKV + col0);
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
  }

  // O / l of the two owned rows; at d = D inlined apart, with constant
  // strides
  __nv_bfloat16* o_b = o + size_t(b) * c * hq * d + size_t(kh) * group * d;
  if (!PACKED && d == D)
    store_chunk_rows<D, false>(acc_o, l, o_b, t0 + r0, rows, group, hq, D);
  else
    store_chunk_rows<D, PACKED>(acc_o, l, o_b, t0 + r0, rows, group, hq, d);
}

// PACKED: d % 16 != 0, the code tiles by bulk copy from the pages (tkv
// unused); the instances of the multiples of 16 compile without it
template <int D, bool PACKED>
__global__ void __launch_bounds__(THREADS, 1)
paged_extend_kernel(const __grid_constant__ CUtensorMap tkv,  // [P*2*Hkv, ps, d] int8
                    const int8_t* __restrict__ pages,      // [n_pages, 2, Hkv, ps, d]
                    const __nv_bfloat16* __restrict__ q,   // [B, C, Hq, d]
                    const float* __restrict__ scales,      // [n_pages, 2, Hkv, 1, ps]
                    const int* __restrict__ page_table,    // [max_seqs, max_pages]
                    const int* __restrict__ seq_lens,      // [max_seqs]
                    const int* __restrict__ slots,         // [B]
                    __nv_bfloat16* __restrict__ o,         // [B, C, Hq, d]
                    int c, int hq, int hkv, int d, int ps, int max_pages,
                    int max_seqs, int window, float scale_log2) {
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

  const int group = hq / hkv;
  const int rows = c * group;
  // the last row tile first: it sees the most keys
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32;

  const int slot = slots[b];
  const bool valid = slot >= 0 && slot < max_seqs;
  const int n = valid ? min(seq_lens[slot], max_pages * ps) : 0;  // with the chunk
  const int q_start = n - c;                   // position of chunk row 0
  // the key tiles some row of this block sees: up to the last row's
  // position, from the first row's band edge (rounded down to a tile) on
  const int kv_end = max(q_start + (min(t0 + BQ, rows) - 1) / group + 1, 0);
  const int kv_begin =
      window > 0 ? max(q_start + t0 / group - window + 1, 0) / BKV * BKV : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BKV - 1) / BKV
                                        : 0;
  const int* pt = page_table + size_t(valid ? slot : 0) * max_pages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < SLOTS; ++s) mbar_init(&code_full[s], 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], CONVERTERS);
      mbar_init(&v_full[s], CONVERTERS);
      mbar_init(&empty[s], CONSUMERS * 128);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer warpgroup: its first thread issues the TMA loads of the
    // code tiles K_0, V_0, K_1, ... through the slots; all 128 threads
    // convert each tile to bf16 and write its keys' factors, and agree (a
    // named barrier) that the slot is read before its next load is issued
    setmaxnreg_dec<PRODUCER_REGS>();
    const int ct = threadIdx.x - CONSUMERS * 128;
    auto load_codes = [&](int j) {
      const int slot_j = j % SLOTS, kv0 = kv_begin + (j / 2) * BKV;
      const int page = pt[kv0 / ps];
      const int head = (page * 2 + (j & 1)) * hkv + kh;
      if constexpr (PACKED) {
        // a [BKV][d] block of the page's rows, packed: one bulk copy
        const uint32_t bytes = uint32_t(BKV) * d;
        mbar_arrive_expect_tx(&code_full[slot_j], bytes);
        bulk_load(scodes + slot_j * T::CODE_BYTES,
                  pages + (size_t(head) * ps + kv0 % ps) * d, bytes,
                  &code_full[slot_j]);
      } else {
        mbar_arrive_expect_tx(&code_full[slot_j], T::CODE_BYTES);
        tma_load_3d(scodes + slot_j * T::CODE_BYTES, &tkv,
                    &code_full[slot_j], 0, kv0 % ps, head);
      }
    };
    // the code tiles' layout in their slot: [BKV][D] boxes, or packed rows
    auto convert = [&](const unsigned char* src, unsigned char* dst) {
      if constexpr (PACKED)
        convert_code_rows<D>(src, dst, BKV, d, ct, CONVERTERS);
      else
        convert_codes_tile<KV_INT8, false, D>(src, dst, BKV, ct, CONVERTERS);
    };
    if (ct == 0)
      for (int j = 0; j < SLOTS && j < 2 * n_tiles; ++j) load_codes(j);
    for (int j = 0; j < 2 * n_tiles; ++j) {
      const int i = j / 2, s = i % STAGES, slot_j = j % SLOTS;
      const int kv0 = kv_begin + i * BKV;
      float* sc = sscale + s * T::SCALES;
      const unsigned char* src = scodes + slot_j * T::CODE_BYTES;
      const size_t page = size_t(pt[kv0 / ps]);
      const float* gsc = scales + ((page * 2 + (j & 1)) * hkv + kh) * ps +
                         kv0 % ps;
      if ((j & 1) == 0) mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
      mbar_wait(&code_full[slot_j], (j / SLOTS) & 1);
      if ((j & 1) == 0) {
        convert(src, sk + s * T::CONV_BYTES);
        for (int t = ct; t < BKV; t += CONVERTERS)
          sc[t] = kv0 + t < n ? gsc[t] * scale_log2 : 0.f;
      } else {
        convert(src, sv + s * T::CONV_BYTES);
        for (int t = ct; t < BKV; t += CONVERTERS)
          sc[BKV + t] = kv0 + t < n ? gsc[t] : 0.f;
      }
      fence_proxy_async();
      mbar_arrive((j & 1) ? &v_full[s] : &k_full[s]);
      named_bar_sync(SLOT_BAR, CONVERTERS);
      if (ct == 0 && j + SLOTS < 2 * n_tiles) load_codes(j + SLOTS);
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  consume<D, PACKED>(sq, sk, sv, sscale, k_full, v_full, empty, q, o, b, kh,
                     c, hq, group, d, t0, q_start, window, kv_begin, n_tiles);
}

template <int D, bool PACKED>
int launch(const void* q, const void* pages, const void* scales,
           const void* page_table, const void* seq_lens, const void* slots,
           void* o, int batch, int c, int hq, int hkv, int d, int ps,
           int max_pages, int max_seqs, int n_pages, int window, float scale,
           cudaStream_t stream) {
  using T = Tiles<D>;
  // boxes of D columns over rows of the true d: the columns past d are
  // zero codes.  Rows that are not a multiple of 16 bytes: bulk copies
  CUtensorMap tkv = {};
  if constexpr (!PACKED) {
    const int err = make_tmap(&tkv, pages, 1, d, ps, n_pages * 2 * hkv, D,
                              T::BKV, 0);
    if (err) return err;
  }
  const cudaError_t attr = cudaFuncSetAttribute(
      paged_extend_kernel<D, PACKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const int rows = c * (hq / hkv);
  const dim3 grid((rows + BQ - 1) / BQ, hkv, batch);
  paged_extend_kernel<D, PACKED><<<grid, THREADS, T::bytes, stream>>>(
      tkv, static_cast<const int8_t*>(pages),
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const float*>(scales), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<const int*>(slots),
      static_cast<__nv_bfloat16*>(o), c, hq, hkv, d, ps, max_pages,
      max_seqs, window, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

// ------------------------------------------------------------ f32 q
// H6-extend at f32 q (f32_attention.cuh: bf16x3 on wgmma), O f32, as B21
// and B22 compute in q's dtype (serving/decode.py:700).  The int8 codes
// are exact in bf16, so K and V are one piece each and S = Q K^T and P V
// are three products (q's pieces, P * v_scale's pieces, against the
// codes): exact f32 products.  One block per (BQ GQA-flattened chunk rows,
// KV head, sequence), the last row tile first; 32-key tiles (never
// straddling a page).  The producer reads each tile's codes from its page,
// converts them exactly to bf16 and writes per key kc = k_scale * scale *
// log2(e) and vs = v_scale, both zero past seq_lens; P * v_scale stays f32
// until it is split, and l sums the unscaled p, as the bf16 kernel.
template <int D>
__global__ void __launch_bounds__(eft::f32::Tiles<D, 1>::THREADS, 1)
paged_extend_f32_kernel(const float* __restrict__ q,         // [B, C, Hq, d]
                        const int8_t* __restrict__ pages,    // [n_pages, 2, Hkv, ps, d]
                        const float* __restrict__ scales,    // [n_pages, 2, Hkv, 1, ps]
                        const int* __restrict__ page_table,  // [max_seqs, max_pages]
                        const int* __restrict__ seq_lens,    // [max_seqs]
                        const int* __restrict__ slots,       // [B]
                        float* __restrict__ o,               // [B, C, Hq, d]
                        int c, int hq, int hkv, int d, int ps, int max_pages,
                        int max_seqs, int window, float scale_log2) {
  namespace F = eft::f32;
  using T = F::Tiles<D, 1>;
  constexpr int BQ = T::BQ, BKV = T::BKV;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::bars);
  uint64_t* empty = full + T::STAGES;
  const int group = hq / hkv;
  const int rows = c * group;
  const int t0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int kh = blockIdx.y, b = blockIdx.z;
  const int slot = slots[b];
  const bool valid = slot >= 0 && slot < max_seqs;
  const int n = valid ? min(seq_lens[slot], max_pages * ps) : 0;
  const int q_start = n - c;
  const int kv_end = max(q_start + (min(t0 + BQ, rows) - 1) / group + 1, 0);
  const int kv_begin =
      window > 0 ? max(q_start + t0 / group - window + 1, 0) / BKV * BKV : 0;
  const int n_tiles = kv_end > kv_begin
                          ? (kv_end - kv_begin + BKV - 1) / BKV : 0;
  const int* pt = page_table + size_t(valid ? slot : 0) * max_pages;
  F::init_bars<D, 1>(full);
  const int warp = threadIdx.x / 32;

  if (warp >= T::NC * 4) {
    // the producer: each thread CH 16-code pieces of K and of V a tile
    constexpr int CH = BKV * (D / 16) / 128;
    struct Regs { uint4 k[CH], v[CH]; size_t k_rows; int kv0; };
    const int ct = threadIdx.x - T::NC * 128;
    const int al = row_align(d);
    auto fetch = [&](int i, Regs& x) {
      x.kv0 = kv_begin + i * BKV;
      const size_t page = size_t(pt[x.kv0 / ps]);
      x.k_rows = (page * 2 * hkv + kh) * ps + x.kv0 % ps;
      const size_t v_rows = x.k_rows + size_t(hkv) * ps;
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int e = ct + 128 * j, r = e / (D / 16), ch = e % (D / 16);
        x.k[j] = x.v[j] = make_uint4(0u, 0u, 0u, 0u);
        if (16 * ch < d) {
          // rows of d bytes: 16-byte loads at d % 16 == 0 (al = 16)
          x.k[j] = load16_al(pages + (x.k_rows + r) * d + 16 * ch, al,
                             d - 16 * ch);
          x.v[j] = load16_al(pages + (v_rows + r) * d + 16 * ch, al,
                             d - 16 * ch);
        }
      }
    };
    auto put = [&](const Regs& x, unsigned char* sk, unsigned char* sv,
                   float* kc, float* vs) {
#pragma unroll
      for (int j = 0; j < CH; ++j) {
        const int e = ct + 128 * j, r = e / (D / 16), ch = e % (D / 16);
        unsigned char* dst[2] = {sk, sv};
        const uint4 in[2] = {x.k[j], x.v[j]};
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          uint32_t w[8];
          codes16_convert<KV_INT8, false>(in[kv], w);
          unsigned char* box = dst[kv] + (ch / 4) * BKV * 128;
          const int byte = (ch % 4) * 32;
          *reinterpret_cast<uint4*>(box + swz128(r, byte)) =
              make_uint4(w[0], w[1], w[2], w[3]);
          *reinterpret_cast<uint4*>(box + swz128(r, byte + 16)) =
              make_uint4(w[4], w[5], w[6], w[7]);
        }
      }
      if (ct < BKV) {
        const bool in = x.kv0 + ct < n;
        kc[ct] = in ? scales[x.k_rows + ct] * scale_log2 : 0.f;
        vs[ct] = in ? scales[x.k_rows + size_t(hkv) * ps + ct] : 0.f;
      }
    };
    F::produce<D, 1, Regs>(smem, full, empty, n_tiles, fetch, put);
    return;
  }

  // a consumer warpgroup: flattened rows t0 + 64 wg .. + 63, this thread
  // two of them; row t is chunk position t / group, q head kh * group + t %
  // group, and sees keys [lo, hi]
  const int lane = threadIdx.x % 32;
  const int wg = warp / 4;
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = t0 + r0 + 8 * r;
    const int pos = q_start + t / group;
    hi[r] = t < rows ? pos : -1;
    lo[r] = window > 0 ? max(pos - window + 1, 0) : 0;
  }
  const size_t q_b = (size_t(b) * c * hq + size_t(kh) * group) * d;
  F::stage_q<D, 1>(smem + T::q, wg, [&](int r) {
    const int t = t0 + wg * 64 + r;
    return t < rows ? q + q_b + (size_t(t / group) * hq + t % group) * d
                    : nullptr;
  }, d);
  float acc_o[D / 2], m[2], l[2];
  F::attend<D, 1, false, true>(smem, wg, full, empty, kv_begin, n_tiles, lo,
                               hi, acc_o, m, l);

  // O / l of the two owned rows; a row that saw nothing stores 0
  const int col0 = 2 * (lane % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int t = t0 + r0 + 8 * r;
    if (t >= rows) continue;
    const float denom = l_row == 0.f ? 1.f : l_row;
    float* orow = o + q_b + (size_t(t / group) * hq + t % group) * d;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (8 * j >= d) continue;
      const float x0 = acc_o[4 * j + 2 * r] / denom;
      const float x1 = acc_o[4 * j + 2 * r + 1] / denom;
      const int col = 8 * j + col0;
      if (d % 8 == 0) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        // a value at a time, those below d
        if (col < d) orow[col] = x0;
        if (col + 1 < d) orow[col + 1] = x1;
      }
    }
  }
}

template <int D>
int launch_f32(const void* q, const void* pages, const void* scales,
               const void* page_table, const void* seq_lens,
               const void* slots, void* o, int batch, int c, int hq, int hkv,
               int d, int ps, int max_pages, int max_seqs, float scale,
               int window, cudaStream_t stream) {
  using T = eft::f32::Tiles<D, 1>;
  const cudaError_t attr = cudaFuncSetAttribute(
      paged_extend_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(T::bytes));
  if (attr != cudaSuccess) return int(attr);
  const int rows = c * (hq / hkv);
  const dim3 grid((rows + T::BQ - 1) / T::BQ, hkv, batch);
  paged_extend_f32_kernel<D><<<grid, T::THREADS, T::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(pages),
      static_cast<const float*>(scales), static_cast<const int*>(page_table),
      static_cast<const int*>(seq_lens), static_cast<const int*>(slots),
      static_cast<float*>(o), c, hq, hkv, d, ps, max_pages, max_seqs, window,
      scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// serving/decode.py has already checked shapes, dtypes, contiguity and
// alignment; the checks here only refuse what would index out of bounds.
// d: 1 to 512 at both dtypes, 257 to 512 on the wide blocks (launch_wide,
// launch_wide_f32); page_size: a multiple of 128.  window: 0 for none.
// q_f32: 0 for bf16 q and O, 1 for f32 (bf16x3: the f32 core up to d 256,
// H5's f32 block past it).
extern "C" int eft_paged_extend(const void* q, const void* pages,
                                const void* scales, const void* page_table,
                                const void* seq_lens, const void* slots,
                                void* o, int batch, int c, int hq, int hkv,
                                int d, int page_size, int max_pages,
                                int max_seqs, int n_pages, int window,
                                float scale, int q_f32, int device,
                                void* stream) {
  if (batch <= 0 || batch > 65535 || c <= 0 || hkv <= 0 || hkv > 65535 ||
      hq % hkv != 0 || page_size <= 0 || page_size % 128 != 0 ||
      d < 1 || d > 512 || max_pages <= 0 || n_pages <= 0 ||
      int64_t(max_pages) * page_size > INT32_MAX ||
      int64_t(n_pages) * 2 * hkv > INT32_MAX ||
      int64_t(c) * (hq / hkv) > INT32_MAX - BQ || window < 0 ||
      (q_f32 != 0 && q_f32 != 1))
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_f32 && d > 256)
    return eft::extend::launch_wide_f32(q, pages, scales, page_table,
                                        seq_lens, slots, o, batch, c, hq,
                                        hkv, d, page_size, max_pages,
                                        max_seqs, n_pages, window, scale, s);
  if (!q_f32 && d > 256)
    return eft::extend::launch_wide(q, pages, scales, page_table, seq_lens,
                                    slots, o, batch, c, hq, hkv, d,
                                    page_size, max_pages, max_seqs, n_pages,
                                    window, scale, s);
  auto go = [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return d % 16 != 0
        ? launch<D, true>(q, pages, scales, page_table, seq_lens, slots, o,
                          batch, c, hq, hkv, d, page_size, max_pages,
                          max_seqs, n_pages, window, scale, s)
        : launch<D, false>(q, pages, scales, page_table, seq_lens, slots, o,
                           batch, c, hq, hkv, d, page_size, max_pages,
                           max_seqs, n_pages, window, scale, s);
  };
  if (q_f32) {
    auto go_f32 = [&](auto dc) {
      return launch_f32<decltype(dc)::value>(
          q, pages, scales, page_table, seq_lens, slots, o, batch, c, hq,
          hkv, d, page_size, max_pages, max_seqs, scale, window, s);
    };
    if (d <= 64) return go_f32(std::integral_constant<int, 64>{});
    if (d <= 128) return go_f32(std::integral_constant<int, 128>{});
    return go_f32(std::integral_constant<int, 256>{});
  }
  if (d <= 64) return go(std::integral_constant<int, 64>{});
  if (d <= 128) return go(std::integral_constant<int, 128>{});
  return go(std::integral_constant<int, 256>{});
}
