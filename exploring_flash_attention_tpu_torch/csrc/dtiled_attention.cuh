// H5: the d-tiled attention forward on Hopper (sm_90a), for head dims d
// from 1 to 2048.  bf16 Q; K and V bf16, or int8 or e4m3 codes with one
// f32 scale per `block` keys; non-causal, f32 accumulate, bf16 or f32 O.
// f32 Q (with f32 K and V, or codes) takes dtiled_attention_f32_kernel, in
// the second half of this file.  The kernels and their launches; the C
// entries are in dtiled_attention.cu, which launches the instances for
// rows TMA cannot describe (STAGED) through dtiled_attention_staged.cu, a
// translation unit of their own so that they compile beside the others.
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
// The plan (ops/attention_v1_dtiled.py h5_plan, checked again by the C
// entry): d is cut into 128-column chunks, ceil(d / 128) of them, and a
// call is one launch of clusters of C blocks, block r of a cluster holding
// chunks [r NC, r NC + NC): C = 1 up to 4 chunks (d 512), 2 up to 8, 4 up
// to 16, NC = ceil(chunks / C) (f32: NC <= 2, C = 1, 2, 4, 8).  Columns at
// or past d, in a block's last chunks, are zero-filled by TMA on the load
// (Q, K and V are described with their true d) and clipped by the store.
// Rows that no tensor map takes, whose stride is no multiple of 16 bytes
// (bf16 d % 8 != 0, f32 d % 4 != 0, codes d % 16 != 0), take the STAGED
// instances of the cluster and f32 kernels: the producer copies them
// itself into the same shared layouts, with cp.async pieces of the rows'
// alignment (a value at a time below 4 bytes), zeros past d, Lq and Lkv,
// and the epilogue stores a value at a time where d % 8 != 0.  A d
// that is 128 NC with C = 1 (128, 256, 384, 512) runs on
// dtiled_attention_kernel, the single-block design below; every other d
// on dtiled_attention_cluster_kernel, the same block with the cluster's
// exchange of S (a cluster of one where C = 1: a d that is not a multiple
// of 128 up to 512), whose epilogue takes the row stride d at run time.
//
// Design (wgmma_tile.cuh).  At d=512 a 64-row O accumulator is 256 f32
// registers per thread of a warpgroup (over the 255 limit) and a 128-row
// bf16 Q tile 128 KB, so O is split by its 128-wide d-chunks across
// warpgroups.  One block per (batch*head, 64-row Q tile) (per cluster
// rank: the C blocks of a cluster neighbours in the grid), the Q tiles of
// a head next to each other in the grid, has NC consumer warpgroups and
// one producer warpgroup:
//   - the producer warpgroup writes each 64-key tile's scale factors
//     (k_scale * scale * log2e, v_scale; 0 past Lkv) into one of two
//     buffers, and its first thread loads the Q tile (the block's
//     columns) once and then streams the tile's K chunks and V chunks (64
//     keys x 128 columns each) by TMA: bf16 straight into a ring of eight
//     16 KB chunk slots; codes into a ring of four 8 KB code slots, from
//     which all its 128 threads convert them into six chunk slots (bf16,
//     exact; wgmma_tile.cuh);
//   - consumer warpgroup 0 computes S = Q K^T over the block's d-chunks on
//     bf16 wgmma (m64n64k16, K-major operands), in one fixed order, so the
//     sum is the same bit for bit from run to run; in a cluster of C > 1
//     that is the block's partial, and S is the sum of the C partials
//     (exchange_s below); then the online softmax in registers (columns
//     at or past Lkv masked, MUFU.EX2), P = bf16(p * v_scale) as its A
//     fragment in registers, and with NC > 1 it also writes P into one of
//     two swizzled shared tiles and each row's alpha beside it;
//   - consumer warpgroup c owns the block's O columns [128 c, 128 c + 128)
//     in 64 f32 registers per thread: O_c = alpha O_c + P V_c on
//     m64n128k16 wgmma, V's chunk MN-major from its slot, P from registers
//     (c = 0) or from the shared tile (c > 0).  No product is repeated;
//   - the epilogue divides by l, which warpgroup 0 hands over in shared
//     memory, and each warpgroup stores its 128 columns.
// Warpgroup 0 carries the S products (half the operations) and the
// softmax: the others' P V of tile i overlaps its S of tile i + 1.
//
// The exchange (cluster instances, C > 1): each block's warpgroup 0 writes
// its partial S of a tile (64 x 64 f32, 16 KB; f32 form 64 x 32, 8 KB)
// into its own exchange buffer, arrives on every rank's "written" barrier,
// waits on its own for all C ranks, reads the C partials through
// distributed shared memory in rank order 0..C-1 and adds them from zero,
// then arrives on every rank's "read" barrier, which a block waits on
// before it writes its next partial.  Every block of a cluster so holds
// the same S bit for bit, and with it the same m, l and P: each computes
// the softmax itself and stores its own columns of O.  The blocks of a
// cluster share (batch*head, Q tile), so they walk the same key tiles.
//
// Budget at NC = 4: shared memory Q 64 KB, eight 16 KB chunk slots (bf16;
// quantized: six, plus four 8 KB code slots), two P tiles 16 KB: ~210 KB,
// and in the cluster instance the 16 KB exchange buffer: 232,416 of the
// 232,448 bytes a block may take.  Registers (setmaxnreg): at NC = 4 640
// threads share 96 each at launch; the producer gives up 56, which
// warpgroup 0 takes (152: S 32 + O 64 + P 16), the other three keep 96 (O
// 64); at NC = 3 warpgroup 0 takes 216.  At NC = 2 the producer's 128
// registers go to both consumer warpgroups (232 each); at NC = 1 a block
// of 256 threads needs no transfer.

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

constexpr int BQ = 64;           // Q rows per block
constexpr int BKV = 64;          // keys per K/V tile
constexpr int DC = 128;          // d-chunk: the columns of one warpgroup's O
constexpr int MAX_NC = 4;        // chunks a block
constexpr int F32_MAX_NC = 2;    // chunks a block of the f32 kernel
constexpr int MAX_CLUSTER = 8;   // blocks a cluster, the portable limit
constexpr int MAX_D = 2048;
constexpr int CONVERTERS = 128;  // quantized: the whole producer warpgroup
constexpr int L_BAR = 1;         // named barrier: l handed over
constexpr int SLOT_BAR = 2;      // named barrier: a code slot (f32: a
                                 // staging buffer) read

// CL: the cluster instance, with the exchange buffer and its barriers
template <int NC, int KIND, bool CL = false>
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
  static constexpr size_t xchg = scales + 4 * BKV * 4;       // [8][128] x 16
  static constexpr uint32_t X_BYTES = CL ? BQ * BKV * 4 : 0;
  static constexpr size_t bars = xchg + X_BYTES;
  static constexpr int N_BARS = 2 * SLOTS + CODE_SLOTS + 1 + 9 + (CL ? 2 : 0);
  static constexpr size_t xbars = bars + 8 * (N_BARS - 2);   // CL: [2]
  static constexpr size_t bytes = bars + 8 * N_BARS + 1024;
  static_assert(bytes <= 232448, "the block's shared memory");
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

// S of one key tile in a cluster of `ranks` blocks (the file's comment):
// this thread's N values of the block's partial s into the exchange buffer
// x (16-byte chunk c of thread t at 128 c + t), then s = the sum from zero
// of every rank's partial, read through distributed shared memory in rank
// order, 16 values (4 loads in flight) at a time: at NC = 4 warpgroup 0
// holds O and S beside them in its 152 registers.  xbar[0]: "written",
// xbar[1]: "read", each completing once a tile on the arrivals of 128
// threads of every rank.
template <int N>
__device__ __forceinline__ void exchange_s(float (&s)[N], float4* x,
                                           uint64_t* xbar, int i,
                                           uint32_t ranks) {
  const int t = threadIdx.x % 128;
  mbar_wait_cluster(&xbar[1], (i & 1) ^ 1);   // every rank read tile i - 1's
#pragma unroll
  for (int c = 0; c < N / 4; ++c) {
    x[128 * c + t] = make_float4(s[4 * c], s[4 * c + 1], s[4 * c + 2],
                                 s[4 * c + 3]);
    s[4 * c] = s[4 * c + 1] = s[4 * c + 2] = s[4 * c + 3] = 0.f;
  }
  for (uint32_t r = 0; r < ranks; ++r)
    mbar_arrive_peer(peer_smem(&xbar[0], r));
  mbar_wait_cluster(&xbar[0], i & 1);
#pragma unroll
  for (int g = 0; g < N / 16; ++g) {
    for (uint32_t r = 0; r < ranks; ++r) {
      const uint32_t at = peer_smem(x + 128 * 4 * g + t, r);
      float4 a[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = ld_peer_v4(at + 128 * 16 * c);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float* v = s + 16 * g + 4 * c;
        v[0] += a[c].x;
        v[1] += a[c].y;
        v[2] += a[c].z;
        v[3] += a[c].w;
      }
    }
  }
  for (uint32_t r = 0; r < ranks; ++r)
    mbar_arrive_peer(peer_smem(&xbar[1], r));
}

// the block's first column of d in its cluster (rank r holds [r D, r D +
// D)), read where it is needed rather than held in a register across the
// key loop (the NC = 4 warpgroups have none to spare)
template <int D>
__device__ __forceinline__ int first_col() {
  return int(cluster_rank()) * D;
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
// agreeing (a named barrier) that a code slot is read before its next load.
// CL: the loads start at the block's first column of d.  STAGED (rows no
// tensor map takes: bf16 d % 8 != 0, codes d % 16 != 0): all 128 threads
// copy Q's rows once, then the bf16 chunks (each handed over once the
// next one's copies are issued) or the code chunks (CODE_SLOTS ahead, a
// cp.async group each), from qg, kg and vg, with cp.async pieces of the
// rows' alignment (wgmma_tile.cuh stage16), zeros past d, Lq and Lkv
template <int NC, int KIND, bool CL, bool STAGED = false>
__device__ __forceinline__ void produce(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    unsigned char* smem, Bars<NC, KIND>* bars, const float* ks,
    const float* vs, int bh, int q0, int lkv, int block, int n_blocks,
    int n_tiles, float scale_log2, const __nv_bfloat16* qg = nullptr,
    const void* kg = nullptr, const void* vg = nullptr, int lq = 0,
    int d = 0) {
  using C = Cfg<NC, KIND, CL>;
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
  // STAGED: item j's chunk (K chunk u, or V chunk u - NC, of tile j / 2
  // NC): its rows [kv0, kv0 + BKV) from global column col on, and this
  // thread's pieces of them, rows of `elem`-byte values
  auto chunk_src = [&](int j, int elem, int& kv0, int& col) {
    const int u = j % (2 * NC);
    kv0 = j / (2 * NC) * BKV;
    col = (CL ? first_col<C::D>() : 0) + (u % NC) * DC;
    return static_cast<const unsigned char*>(u < NC ? kg : vg) +
           ((size_t(bh) * lkv + kv0) * d + col) * elem;
  };
  if constexpr (STAGED) {
    // Q's rows, handed over at once
    const int c0 = CL ? first_col<C::D>() : 0;
    const int al = row_align(2 * d);
    const __nv_bfloat16* q_rows = qg + (size_t(bh) * lq + q0) * d + c0;
    for (int e = pt; e < BQ * (C::D / 8); e += 128) {
      const int r = e / (C::D / 8), c = (e % (C::D / 8)) * 8;
      stage16(smem_u32(smem + C::q) + (c / 64) * BQ * 128 +
                  swz128(r, (c % 64) * 2),
              q_rows + size_t(r) * d + c, al,
              q0 + r < lq ? 2 * (d - c0 - c) : 0);
    }
    cp_async_commit();
    hand_over(smem_u32(&bars->q_full), true);
  } else if (pt == 0) {
    mbar_arrive_expect_tx(&bars->q_full, C::Q_BYTES);
    for (int x = 0; x < 2 * NC; ++x)
      tma_load_3d(smem + C::q + x * BQ * 128, tq, &bars->q_full,
                  (CL ? first_col<C::D>() : 0) + x * 64, q0, bh);
  }
  if constexpr (C::QUANT) {
    unsigned char* codes = smem + C::codes;
    const int total = n_tiles * 2 * NC;
    auto load_codes = [&](int j) {
      const int cs = j % C::CODE_SLOTS, u = j % (2 * NC);
      mbar_arrive_expect_tx(&bars->code_full[cs], C::CODE_BYTES);
      tma_load_3d(codes + cs * C::CODE_BYTES, u < NC ? tk : tv,
                  &bars->code_full[cs],
                  (CL ? first_col<C::D>() : 0) + (u % NC) * DC,
                  j / (2 * NC) * BKV, bh);
    };
    // STAGED: item j's codes into its code slot, one cp.async group
    auto stage_codes = [&](int j) {
      int kv0, col;
      const unsigned char* src = chunk_src(j, 1, kv0, col);
      const uint32_t dst =
          smem_u32(codes + (j % C::CODE_SLOTS) * C::CODE_BYTES);
      const int al = row_align(d);
      for (int e = pt; e < BKV * (DC / 16); e += CONVERTERS) {
        const int r = e / (DC / 16), c = (e % (DC / 16)) * 16;
        stage16(dst + r * DC + c, src + size_t(r) * d + c, al,
                kv0 + r < lkv ? d - col - c : 0);
      }
      cp_async_commit();
    };
    if constexpr (STAGED) {
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
        write_scales(i, pt, CONVERTERS);
        mbar_arrive(&bars->sc_full[i % 2]);
      }
      const int cs = j % C::CODE_SLOTS, s = j % C::SLOTS;
      mbar_wait(&bars->chunk_empty[s], ((j / C::SLOTS) & 1) ^ 1);
      if constexpr (STAGED) {
        cp_async_wait<C::CODE_SLOTS - 1>();     // this thread's copies of j
        named_bar_sync(SLOT_BAR, CONVERTERS);   // and every thread's
      } else {
        mbar_wait(&bars->code_full[cs], (j / C::CODE_SLOTS) & 1);
      }
      convert_codes_tile<KIND, false, DC>(codes + cs * C::CODE_BYTES,
                                          chunks + s * C::CHUNK_BYTES, BKV,
                                          pt, CONVERTERS);
      fence_proxy_async();
      mbar_arrive(&bars->chunk_full[s]);
      named_bar_sync(SLOT_BAR, CONVERTERS);
      if constexpr (STAGED) {
        if (j + C::CODE_SLOTS < total) stage_codes(j + C::CODE_SLOTS);
        else cp_async_commit();
      } else if (pt == 0 && j + C::CODE_SLOTS < total) {
        load_codes(j + C::CODE_SLOTS);
      }
    }
  } else if constexpr (STAGED) {
    // bf16 chunks: each copied by all 128 threads (boxes of 64 columns,
    // 128-byte swizzle), and handed over once the next one's copies are
    // issued; the first warp writes each tile's scale factors
    const int al = row_align(2 * d);
    for (int i = 0; i < n_tiles; ++i) {
      if (pt < 32) {
        mbar_wait(&bars->sc_empty[i % 2], ((i / 2) & 1) ^ 1);
        write_scales(i, pt, 32);
        mbar_arrive(&bars->sc_full[i % 2]);
      }
      for (int u = 0; u < 2 * NC; ++u) {
        const int j = item<NC>(i, u);
        int kv0, col;
        const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(
            chunk_src(j, 2, kv0, col));
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
  } else if (pt < 32) {
    for (int i = 0; i < n_tiles; ++i) {
      mbar_wait(&bars->sc_empty[i % 2], ((i / 2) & 1) ^ 1);
      write_scales(i, pt, 32);
      mbar_arrive(&bars->sc_full[i % 2]);
      if (pt == 0) {
        for (int u = 0; u < 2 * NC; ++u) {
          const int j = item<NC>(i, u);
          const int s = j % C::SLOTS;
          const int col = (CL ? first_col<C::D>() : 0) + (u % NC) * DC;
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

// Consumer warpgroup 0: S over every d-chunk (the block's, then with CL
// the cluster's sum of the ranks' partials), the softmax, P (registers,
// and for the other warpgroups a shared tile), its own O chunk.  CL: the
// row stride of O is d, and the block's columns start at first_col
template <int NC, int KIND, bool CL, bool STAGED = false>
__device__ __forceinline__ void consume_first(
    unsigned char* smem, Bars<NC, KIND>* bars, void* o, int out_f32, int lq,
    int lkv, int q0, int bh, int n_tiles, int d = 0) {
  using C = Cfg<NC, KIND, CL>;
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
    if constexpr (CL) {
      if (cluster_size() > 1)
        exchange_s(acc_s, reinterpret_cast<float4*>(smem + C::xchg),
                   reinterpret_cast<uint64_t*>(smem + C::xbars), i,
                   cluster_size());
    }

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
  if constexpr (STAGED) {
    // a value at a time where d % 8 != 0
    const int c0 = first_col<C::D>();
    if (d % 8 != 0)
      store_o_rows<DC, true>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o,
                             out_f32, nullptr, d, c0, d - c0);
    else
      store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o,
                       out_f32, nullptr, d, c0, d - c0);
  } else if constexpr (CL) {
    const int c0 = first_col<C::D>();
    store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o, out_f32,
                     nullptr, d, c0, d - c0);
  } else
    store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o, out_f32,
                     nullptr, C::D, 0);
}

// The key loop of consumer warpgroup c > 0 (wg): O_c = alpha O_c + P V_c
// over n_tiles tiles, P from the shared tile warpgroup 0 wrote
template <int NC, int KIND, bool CL>
__device__ __forceinline__ void chunk_loop(unsigned char* smem,
                                           Bars<NC, KIND>* bars, int wg,
                                           int rl, int n_tiles,
                                           float (&acc_o)[DC / 2]) {
  using C = Cfg<NC, KIND, CL>;
  const unsigned char* chunks = smem + C::chunks;
  const float* salpha = reinterpret_cast<const float*>(smem + C::alpha);
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
}

// Consumer warpgroup c > 0: its key loop (chunk_loop), then O_c / l
template <int NC, int KIND, bool CL, bool STAGED = false>
__device__ __forceinline__ void consume_chunk(
    unsigned char* smem, Bars<NC, KIND>* bars, void* o, int out_f32, int lq,
    int q0, int bh, int n_tiles, int d = 0) {
  using C = Cfg<NC, KIND, CL>;
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x / 32 % 4;
  const int lane = threadIdx.x % 32;
  const int rl = warp * 16 + lane / 4;
  float acc_o[DC / 2];
  chunk_loop<NC, KIND, CL>(smem, bars, wg, rl, n_tiles, acc_o);

  named_bar_sync(L_BAR, NC * 128);
  const float* sl = reinterpret_cast<const float*>(smem + C::lsum);
  // the row sums, placed so that store_o_rows' quad sum returns them
  const float l[2] = {lane % 4 == 0 ? sl[rl] : 0.f,
                      lane % 4 == 0 ? sl[rl + 8] : 0.f};
  const float m[2] = {0.f, 0.f};
  if constexpr (STAGED) {
    const int col = first_col<C::D>() + wg * DC;
    if (d % 8 != 0)
      store_o_rows<DC, true>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o,
                             out_f32, nullptr, d, col, d - col);
    else
      store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o,
                       out_f32, nullptr, d, col, d - col);
  } else if constexpr (CL) {
    const int col = first_col<C::D>() + wg * DC;
    store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o, out_f32,
                     nullptr, d, col, d - col);
  } else
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
    produce<NC, KIND, false>(&tq, &tk, &tv, smem, bars, ks, vs, bh, q0, lkv,
                             block, n_blocks, n_tiles, scale_log2);
  } else if (wg == 0) {
    if constexpr (C::WG0_REGS > 0) setmaxnreg_inc<C::WG0_REGS>();
    consume_first<NC, KIND, false>(smem, bars, o, out_f32, lq, lkv, q0, bh,
                                   n_tiles);
  } else if constexpr (NC > 1) {
    if constexpr (C::OTHER_REGS > 0) setmaxnreg_inc<C::OTHER_REGS>();
    consume_chunk<NC, KIND, false>(smem, bars, o, out_f32, lq, q0, bh,
                                   n_tiles);
  }
}

// The same block in a cluster of C = %cluster_nctarank blocks along x
// (the launch's cluster dimension; 1 for a d that is not a multiple of
// 128 up to 512), rank r holding d's columns [r D, r D + D) with D = 128
// NC, cut at d (the row stride of q, k, v and o).  STAGED: rows no tensor
// map takes (bf16 d % 8 != 0, codes d % 16 != 0), copied by the producer
// from qg, kg and vg (tq, tk and tv unused)
template <int NC, int KIND, bool STAGED>
__global__ void __launch_bounds__(Cfg<NC, KIND, true>::THREADS, 1)
dtiled_attention_cluster_kernel(
    const __grid_constant__ CUtensorMap tq,  // [BH, Lq, d]
    const __grid_constant__ CUtensorMap tk,  // [BH, Lkv, d]
    const __grid_constant__ CUtensorMap tv,  // [BH, Lkv, d]
    const float* __restrict__ ks,            // [BH, n_blocks] or null
    const float* __restrict__ vs,            // [BH, n_blocks] or null
    void* __restrict__ o,                    // [BH, Lq, d]
    int out_f32, int lq, int lkv, int d, int block, int n_blocks,
    float scale_log2, const __nv_bfloat16* __restrict__ qg,
    const void* __restrict__ kg, const void* __restrict__ vg) {
  using C = Cfg<NC, KIND, true>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto* bars = reinterpret_cast<Bars<NC, KIND>*>(smem + C::bars);
  auto* xbar = reinterpret_cast<uint64_t*>(smem + C::xbars);

  const uint32_t ranks = cluster_size();
  const int n_qt = (lq + BQ - 1) / BQ;
  const int tile = blockIdx.x / ranks;
  const int bh = tile / n_qt;
  const int q0 = (tile % n_qt) * BQ;
  const int n_tiles = (lkv + BKV - 1) / BKV;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::SLOTS; ++s) {
      mbar_init(&bars->chunk_full[s],
                C::QUANT || STAGED ? CONVERTERS : 1);
      mbar_init(&bars->chunk_empty[s], 128);
    }
    for (int s = 0; s < C::CODE_SLOTS; ++s) mbar_init(&bars->code_full[s], 1);
    for (int t = 0; t < 2; ++t) {
      mbar_init(&bars->sc_full[t], C::QUANT ? CONVERTERS : 32);
      mbar_init(&bars->sc_empty[t], 128);
      mbar_init(&bars->p_full[t], 128);
      mbar_init(&bars->p_empty[t], NC > 1 ? (NC - 1) * 128 : 1);
      mbar_init(&xbar[t], 128 * ranks);
    }
    mbar_init(&bars->q_full, STAGED ? 128 : 1);
    mbar_init_fence();
  }
  cluster_sync();             // every rank's barriers ready

  if (wg == NC) {
    if constexpr (C::PRODUCER_REGS > 0) setmaxnreg_dec<C::PRODUCER_REGS>();
    produce<NC, KIND, true, STAGED>(&tq, &tk, &tv, smem, bars, ks, vs, bh,
                                    q0, lkv, block, n_blocks, n_tiles,
                                    scale_log2, qg, kg, vg, lq, d);
  } else if (wg == 0) {
    if constexpr (C::WG0_REGS > 0) setmaxnreg_inc<C::WG0_REGS>();
    consume_first<NC, KIND, true, STAGED>(smem, bars, o, out_f32, lq, lkv,
                                          q0, bh, n_tiles, d);
  } else if constexpr (NC > 1) {
    if constexpr (C::OTHER_REGS > 0) setmaxnreg_inc<C::OTHER_REGS>();
    consume_chunk<NC, KIND, true, STAGED>(smem, bars, o, out_f32, lq, q0,
                                          bh, n_tiles, d);
  }
  cluster_sync();             // no rank still reads this block's buffer
}

// one launch of `kernel` over `tiles` (batch*head, Q tile) pairs, a cluster
// of `ranks` blocks each
template <class Kernel, class... Args>
int launch_clusters(Kernel kernel, int threads, size_t bytes, int tiles,
                    int ranks, cudaStream_t stream, Args... args) {
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (attr != cudaSuccess) return int(attr);
  const ClusterLaunch l(dim3(tiles * ranks), ranks, threads, bytes, stream);
  const cudaError_t err = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

// The most clusters of `ranks` blocks of `kernel` active at once on the
// current device (cudaOccupancyMaxActiveClusters), or minus a cudaError_t
template <class Kernel>
int max_clusters(Kernel kernel, int threads, size_t bytes, int ranks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return -int(err);
  const ClusterLaunch l(dim3(ranks), ranks, threads, bytes, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(
      &n, reinterpret_cast<const void*>(kernel), &l.cfg);
  return err == cudaSuccess ? n : -int(err);
}

// The TMA descriptors of the bf16 and quantized blocks: Q and bf16 K / V in
// 64-column boxes, codes in 128-column ones, described with their true d
template <int KIND>
int make_maps(CUtensorMap* tq, CUtensorMap* tk, CUtensorMap* tv,
              const void* q, const void* k, const void* v, int d, int bh,
              int lq, int lkv) {
  int err = make_tmap(tq, q, 2, d, lq, bh, 64, BQ, 128);
  if (KIND != KV_BF16) {
    if (!err) err = make_tmap(tk, k, 1, d, lkv, bh, DC, BKV, 0);
    if (!err) err = make_tmap(tv, v, 1, d, lkv, bh, DC, BKV, 0);
  } else {
    if (!err) err = make_tmap(tk, k, 2, d, lkv, bh, 64, BKV, 128);
    if (!err) err = make_tmap(tv, v, 2, d, lkv, bh, 64, BKV, 128);
  }
  return err;
}

template <int NC, int KIND>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* o, int out_f32, int bh, int lq, int lkv,
           int block, int n_blocks, float scale_log2, cudaStream_t stream) {
  using C = Cfg<NC, KIND>;
  CUtensorMap tq, tk, tv;
  const int err = make_maps<KIND>(&tq, &tk, &tv, q, k, v, C::D, bh, lq, lkv);
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

template <int NC, int KIND, bool STAGED>
int launch_cluster(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, void* o, int out_f32,
                   int bh, int lq, int lkv, int d, int block, int n_blocks,
                   float scale_log2, int ranks, cudaStream_t stream) {
  using C = Cfg<NC, KIND, true>;
  CUtensorMap tq = {}, tk = {}, tv = {};
  if constexpr (!STAGED) {
    const int err = make_maps<KIND>(&tq, &tk, &tv, q, k, v, d, bh, lq, lkv);
    if (err) return err;
  }
  return launch_clusters(dtiled_attention_cluster_kernel<NC, KIND, STAGED>,
                         C::THREADS, C::bytes, bh * ((lq + BQ - 1) / BQ),
                         ranks, stream, tq, tk, tv,
                         static_cast<const float*>(ks),
                         static_cast<const float*>(vs), o, out_f32, lq, lkv,
                         d, block, n_blocks, scale_log2,
                         static_cast<const __nv_bfloat16*>(q), k, v);
}

// ------------------------------------------------------------ f32
// H5 at f32, as B19 computes for f32 q (attention_v1_dtiled.py): every
// chunk product at HIGHEST (:133, :173), S summed over the 128-column
// d-chunks of Q and K (:121-143), the K scale folded into the exp2
// constant (:103-112), p * v_scale kept in an f32 p_scratch (:159-161,
// :296), O accumulated per chunk at full width (:165-176).  HIGHEST is
// bf16x6 on wgmma, as in the f32 core (f32_attention.cuh, whose split,
// piece order and products this kernel uses): f32 K and V are three
// pieces each (bf16x6 on both products); quantized K and V are codes,
// exact in bf16, one piece each (bf16x3: JAX's k_c.astype(q_c.dtype)).
//
// The problem is shared memory.  At d=512 the three pieces of a 64-row Q
// tile take 192 KB, so Q cannot stay resident as it does in the bf16
// kernel (64 KB).  Q is streamed instead, 64 columns at a time beside K's
// same columns, once per 32-key tile, as the reference CUDA d-tiled
// kernel streams Q's chunks (tiled_d flash_attention_v1.h:154-174, cited
// at attention_v1_dtiled.py:123-125).  What that costs: Q is re-read from
// L2 and re-split once per key tile, at B=4 H=8 L=1024 d=512 about 2 GB
// of L2 reads, and as many bytes of shared memory written again.
//
// One block per (batch*head, 64-row Q tile) and cluster rank (the plan of
// the file's comment: C = 1 up to d 256, 2 up to 512, 4 up to 1024, 8 up
// to 2048, NC = 1 or 2 chunks a block), the Q tiles of a head next to each
// other in the grid, NC consumer warpgroups and a producer warpgroup
// (split in two).  Every load is a TMA copy of f32 (or codes)
// into a staging buffer, zero-filled past Lq and Lkv, which the producer's
// threads split (or convert) from shared memory; a thread that read
// global memory itself would wait on L2 for each 32 bytes:
//   - producer warps 0-2 (96 threads), per tile and 64-column half h of
//     the block's columns: Q's and K's columns of h, staged (two buffers
//     of 24 KB), split or converted into one of two S slots (Q pieces 24
//     KB, K pieces 12 KB or codes 4 KB); with h = 0 the tile's factors
//     (scale * log2e * k_scale and v_scale per key, 0 at or past Lkv);
//   - producer warp 3 (32 threads), per tile, chunk c and half: V's 64
//     columns, staged (two buffers of 8 KB), split or converted into one
//     of two V slots (24 KB or 8 KB a chunk), for warpgroup c;
//   - consumer warpgroup 0, per tile: S_c = Q_c K_c^T in a fresh
//     accumulator per 128-column chunk (its two halves' m64n32k16
//     products, 6 or 3 piece products over 4 k-steps each), S += S_c in
//     f32 in chunk order (with C > 1 the block's partial: S is the sum of
//     the C partials in rank order, exchange_s), the mask, s * kc, the
//     online softmax in f32
//     (exp2f), l summing the f32 p; P * vs split into three bf16 pieces,
//     written side by side as one tile of shared memory (two swizzled
//     boxes), with each row's alpha;
//   - every consumer warpgroup c, warpgroup 0 included: P V_c on
//     m64n128k16 wgmma, both operands from shared memory (P from
//     registers would cost warpgroup 0 24 registers), in a fresh
//     accumulator a tile (the first wgmma with scale-d 0), then O_c =
//     alpha O_c + P V_c in f32, as the f32 core's attend: the tensor core
//     drops an added product's bits below its accumulator's last, so one
//     accumulator over every tile would drift with the number of keys;
//   - the epilogue divides by l (handed over in shared memory) and each
//     warpgroup stores its 128 columns, cut at d.
//
// Budget at NC = 2 (dense): two S slots 72 KB, their staging 48 KB, two V
// slots 48 KB, their staging 16 KB, two P tiles 32 KB, the 8 KB exchange
// buffer, factors, alpha, l, barriers: 226.4 KB of 227.  Registers
// (setmaxnreg; the block keeps what the launch allocates): 384 x 168 >=
// 48 (the producer, which splits from shared memory) + 2 x 224
// (warpgroup 0: O 64, the fresh P V 64, S 16, S_c 16; warpgroup 1: O 64,
// P V 64); at NC = 1 (256 threads) none moved.  A block of more chunks
// would not hold the fresh accumulator beside O (at NC = 4, 640 x 96:
// 48 + 144 + 3 x 96 without it), so d past 256 takes clusters.
//
// H1 and H6-extend at f32 past d 256 run this block in clusters of two
// (prefill_attention_wide_f32.cu, paged_extend_wide_f32.cu): produce_f32
// takes the K/V head and the first key of their loops, key_loop_f32 the
// keys each row sees and the bound statistic, share_l_f32 and
// init_f32_bars as they are.

constexpr int FKV = 32;                      // keys per tile
constexpr int FH = 64;                       // columns of a staged half
constexpr uint32_t FQ_PIECE = BQ * FH * 2;   // a Q half's bf16 piece, 8 KB
constexpr uint32_t FK_PIECE = FKV * FH * 2;  // a K half's piece, 4 KB
constexpr uint32_t FV_PIECE = FKV * DC * 2;  // a V chunk's piece, 8 KB
constexpr int S_THREADS = 96;                // producer warps 0-2

template <int NC>
struct FBars {
  uint64_t stage_full[2], vstage_full[2];   // TMA copies landed
  uint64_t sk_full[2], sk_empty[2];         // the S slots
  uint64_t v_full[NC], v_empty[2];          // V: full per warpgroup
  uint64_t fac_empty[2];                    // a tile's factors read
  uint64_t p_full[2], p_empty[2];           // P and alpha
  uint64_t xbar[2];                         // the exchange: written, read
};

// KIND: the K/V kind of the C entry, KV_BF16 (0, not quantized) standing
// for f32 K and V here
template <int NC, int KIND>
struct FCfg {
  static_assert(NC == 1 || NC == 2, "an f32 block holds one or two chunks");
  static constexpr int D = NC * DC;
  static constexpr int NS = 2 * NC;                     // S halves a tile
  static constexpr int THREADS = (NC + 1) * 128;
  static constexpr bool QUANT = KIND != KV_BF16;
  static constexpr int KP = QUANT ? 1 : 3;              // pieces of K, V
  static constexpr int TERMS = QUANT ? 3 : 6;
  static constexpr int KV_ELEM = QUANT ? 1 : 4;         // staged K/V bytes
  // V slots: at most one per warpgroup, so that warpgroup c's V of tile
  // i + 1 cannot land before it has taken tile i's (v_full's parity)
  static constexpr int V_SLOTS = NC > 1 ? 2 : 1;
  // registers per thread: what the launch gives (65536 over the block's
  // threads, in steps of 8), and after setmaxnreg, the same total
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int PRODUCER_REGS = 48;
  // the STAGED producer copies the rows too: the 8 registers the block
  // leaves over (at 48, NC = 2 e4m3 kept 8 bytes of stack)
  static constexpr int STAGED_PRODUCER_REGS = 56;
  static constexpr int WG0_REGS = 224;
  static constexpr int OTHER_REGS = 224;
  static_assert(NC == 1 || STAGED_PRODUCER_REGS + WG0_REGS
                               + (NC - 1) * OTHER_REGS
                               <= (NC + 1) * LAUNCH_REGS,
                "the block's registers");
  static constexpr uint32_t SK_BYTES = 3 * FQ_PIECE + KP * FK_PIECE;
  static constexpr uint32_t V_BYTES = KP * FV_PIECE;
  static constexpr uint32_t P_BYTES = 2 * BQ * 128;   // boxes [hi | mid], [lo]
  static constexpr uint32_t STAGE_Q = BQ * FH * 4;    // f32 [64][64]
  static constexpr uint32_t STAGE_KV = FKV * FH * KV_ELEM;
  static constexpr uint32_t STAGE_BYTES = STAGE_Q + STAGE_KV;
  static constexpr size_t sk = 0;
  static constexpr size_t v = sk + 2 * size_t(SK_BYTES);
  static constexpr size_t p = v + V_SLOTS * size_t(V_BYTES);
  static constexpr size_t stage = p + 2 * size_t(P_BYTES);
  static constexpr size_t vstage = stage + 2 * size_t(STAGE_BYTES);
  static constexpr size_t alpha = vstage + 2 * size_t(STAGE_KV);  // [2][64]
  static constexpr size_t lsum = alpha + 2 * BQ * 4;              // [64]
  static constexpr size_t fac = lsum + BQ * 4;                    // [2][2][32]
  static constexpr size_t xchg = fac + 2 * 2 * FKV * 4;           // [4][128]
  static constexpr size_t bars = xchg + BQ * FKV * 4;
  static constexpr size_t bytes = bars + sizeof(FBars<NC>) + 1024;
  static_assert(bytes <= 232448, "the block's shared memory");
};

// Staged rows (row-major, 64 f32 or codes a row, zero past the tensor's
// end) into their bf16 pieces in a tile of `rows` rows: f32 (KIND
// KV_BF16, the kind that is not quantized) split into three pieces of
// `piece` bytes, codes converted whole; the 64 columns land at col0 (0 or
// 64: a box of 64 columns).  Threads t, t + n, ...
template <int KIND>
__device__ __forceinline__ void split_staged(unsigned char* tile,
                                             uint32_t piece, int rows,
                                             int col0,
                                             const unsigned char* src,
                                             int t, int n) {
  if constexpr (KIND == KV_BF16) {
    const float* x = reinterpret_cast<const float*>(src);
#pragma unroll 1
    for (int e = t; e < rows * (FH / 8); e += n) {
      const int r = e / (FH / 8), ch = e % (FH / 8);
      const float4* at = reinterpret_cast<const float4*>(x + r * FH + 8 * ch);
      eft::f32::put_split8(tile, piece, rows, r, col0 / 8 + ch, at[0],
                           at[1]);
    }
  } else {
    convert_codes_tile<KIND, false, FH>(src, tile + (col0 / 64) * rows * 128,
                                        rows, t, n);
  }
}

// STAGED: rows [row0, row0 + rows) of a head's [L, d] rows of E-byte
// values (f32 or codes) from column col, FH columns of each, into a plain
// staged tile at the shared-window address dst, zeros past d and past L;
// this thread's pieces of threads t, t + n, ... (cp.async, the caller
// commits the group; wgmma_tile.cuh stage16)
template <int E>
__device__ __forceinline__ void stage_half(uint32_t dst, const void* g,
                                           size_t head, int row0, int rows,
                                           int l, int d, int col, int t,
                                           int n) {
  constexpr int P = FH * E / 16;        // 16-byte pieces a row
  const int al = row_align(E * d);
  const unsigned char* src =
      static_cast<const unsigned char*>(g) + ((head + row0) * d + col) * E;
  for (int e = t; e < rows * P; e += n) {
    const int r = e / P, p = e % P;
    stage16(dst + r * FH * E + 16 * p, src + size_t(r) * d * E + 16 * p, al,
            row0 + r < l ? E * (d - col) - 16 * p : 0);
  }
}

// column col (0..95) of the P tile, pieces side by side: piece p's 32
// columns at 32 p, boxes of 64 columns (128-byte rows, 128-byte swizzle)
__device__ __forceinline__ uint32_t p_offset(int row, int col) {
  return (col / 64) * BQ * 128 + swz128(row, (col % 64) * 2);
}

// STAGED (rows no tensor map takes: f32 d % 4 != 0, codes d % 16 != 0):
// the staging buffers are filled by the threads that split them, from qg,
// kg and vg, two items ahead, a cp.async group an item.  Q rows [q0, q0 +
// 64) of head bh; the keys [kv_begin, kv_begin + FKV n_tiles) of K/V head
// bhk (H5: bh and 0; H1's wide f32 block: its GQA head and its span)
template <int NC, int KIND, bool STAGED>
__device__ __forceinline__ void produce_f32(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const float* ks, const float* vs, unsigned char* smem, FBars<NC>* bars,
    int bh, int q0, int lkv, int block, int n_blocks, int n_tiles,
    float scale_log2, int c0, const void* qg, const void* kg,
    const void* vg, int lq, int d, int bhk, int kv_begin) {
  using C = FCfg<NC, KIND>;
  const int pt = threadIdx.x - NC * 128;
  if (pt < S_THREADS) {
    // S halves: item j is tile j / NS, the block's columns 64 (j % NS) ..
    // + 63
    float* fac = reinterpret_cast<float*>(smem + C::fac);
    const float* ksb = ks + size_t(bhk) * n_blocks;
    const float* vsb = vs + size_t(bhk) * n_blocks;
    const int n_items = n_tiles * C::NS;
    auto load = [&](int j) {
      unsigned char* st = smem + C::stage + (j % 2) * C::STAGE_BYTES;
      const int col = c0 + (j % C::NS) * FH;
      mbar_arrive_expect_tx(&bars->stage_full[j % 2], C::STAGE_BYTES);
      tma_load_3d(st, tq, &bars->stage_full[j % 2], col, q0, bh);
      tma_load_3d(st + C::STAGE_Q, tk, &bars->stage_full[j % 2], col,
                  kv_begin + j / C::NS * FKV, bhk);
    };
    auto stage = [&](int j) {
      const uint32_t st = smem_u32(smem + C::stage + (j % 2) * C::STAGE_BYTES);
      const int col = c0 + (j % C::NS) * FH;
      stage_half<4>(st, qg, size_t(bh) * lq, q0, BQ, lq, d, col, pt,
                    S_THREADS);
      stage_half<C::KV_ELEM>(st + C::STAGE_Q, kg, size_t(bhk) * lkv,
                             kv_begin + j / C::NS * FKV, FKV, lkv, d, col,
                             pt, S_THREADS);
      cp_async_commit();
    };
    if constexpr (STAGED) {
      for (int j = 0; j < 2; ++j) {
        if (j < n_items) stage(j);
        else cp_async_commit();
      }
    } else if (pt == 0) {
      for (int j = 0; j < 2 && j < n_items; ++j) load(j);
    }
    for (int j = 0; j < n_items; ++j) {
      const int i = j / C::NS, h = j % C::NS, s = j % 2;
      const unsigned char* st = smem + C::stage + s * C::STAGE_BYTES;
      unsigned char* slot = smem + C::sk + s * C::SK_BYTES;
      mbar_wait(&bars->sk_empty[s], ((j / 2) & 1) ^ 1);
      if constexpr (STAGED) {
        cp_async_wait<1>();                      // this thread's copies of j
        named_bar_sync(SLOT_BAR, S_THREADS);     // and every thread's
      } else {
        mbar_wait(&bars->stage_full[s], (j / 2) & 1);
      }
      split_staged<KV_BF16>(slot, FQ_PIECE, BQ, 0, st, pt, S_THREADS);
      split_staged<KIND>(slot + 3 * FQ_PIECE, FK_PIECE, FKV, 0,
                         st + C::STAGE_Q, pt, S_THREADS);
      if (h == 0) {
        const int f = i % 2;
        mbar_wait(&bars->fac_empty[f], ((i / 2) & 1) ^ 1);
        for (int t = pt; t < FKV; t += S_THREADS) {
          const int key = kv_begin + i * FKV + t;
          const bool in = key < lkv;
          fac[f * 2 * FKV + t] =
              in ? (C::QUANT ? ksb[key / block] : 1.f) * scale_log2 : 0.f;
          fac[f * 2 * FKV + FKV + t] =
              in ? (C::QUANT ? vsb[key / block] : 1.f) : 0.f;
        }
      }
      fence_proxy_async();
      mbar_arrive(&bars->sk_full[s]);
      named_bar_sync(SLOT_BAR, S_THREADS);       // staging s read
      if constexpr (STAGED) {
        if (j + 2 < n_items) stage(j + 2);
        else cp_async_commit();
      } else if (pt == 0 && j + 2 < n_items) {
        load(j + 2);
      }
    }
  } else {
    // V halves: item j is tile j / (2 NC), the block's chunk j / 2 % NC,
    // columns 64 (j % 2) .. + 63 of the chunk
    const int lane = pt - S_THREADS;
    const int n_items = n_tiles * NC * 2;
    auto load = [&](int j) {
      mbar_arrive_expect_tx(&bars->vstage_full[j % 2], C::STAGE_KV);
      tma_load_3d(smem + C::vstage + (j % 2) * C::STAGE_KV, tv,
                  &bars->vstage_full[j % 2], c0 + j / 2 % NC * DC + j % 2 * FH,
                  kv_begin + j / (2 * NC) * FKV, bhk);
    };
    auto stage = [&](int j) {
      stage_half<C::KV_ELEM>(
          smem_u32(smem + C::vstage + (j % 2) * C::STAGE_KV), vg,
          size_t(bhk) * lkv, kv_begin + j / (2 * NC) * FKV, FKV, lkv, d,
          c0 + j / 2 % NC * DC + j % 2 * FH, lane, 32);
      cp_async_commit();
    };
    if constexpr (STAGED) {
      for (int j = 0; j < 2; ++j) {
        if (j < n_items) stage(j);
        else cp_async_commit();
      }
    } else if (lane == 0) {
      for (int j = 0; j < 2 && j < n_items; ++j) load(j);
    }
    for (int j = 0; j < n_items; ++j) {
      const int jc = j / 2, c = jc % NC, s = jc % C::V_SLOTS;
      if (j % 2 == 0)
        mbar_wait(&bars->v_empty[s], ((jc / C::V_SLOTS) & 1) ^ 1);
      if constexpr (STAGED) {
        cp_async_wait<1>();
        __syncwarp();
      } else {
        mbar_wait(&bars->vstage_full[j % 2], (j / 2) & 1);
      }
      split_staged<KIND>(smem + C::v + s * C::V_BYTES, FV_PIECE, FKV,
                         (j % 2) * FH,
                         smem + C::vstage + (j % 2) * C::STAGE_KV, lane, 32);
      if (j % 2 == 1) {
        fence_proxy_async();
        mbar_arrive(&bars->v_full[c]);
      }
      __syncwarp();                               // staging read
      if constexpr (STAGED) {
        if (j + 2 < n_items) stage(j + 2);
        else cp_async_commit();
      } else if (lane == 0 && j + 2 < n_items) {
        load(j + 2);
      }
    }
  }
}

// S_c's products of one S slot (a 64-column half) added into acc (issued,
// not waited for)
template <int NC, int KIND>
__device__ __forceinline__ void issue_s_half(float (&acc)[FKV / 2],
                                             const unsigned char* slot) {
  using C = FCfg<NC, KIND>;
  namespace F = eft::f32;
#pragma unroll
  for (int t = 0; t < C::TERMS; ++t) {
    const unsigned char* a = slot + F::piece_a<C::TERMS>(t) * FQ_PIECE;
    const unsigned char* b =
        slot + 3 * FQ_PIECE + F::piece_b<C::TERMS>(t) * FK_PIECE;
#pragma unroll
    for (int kk = 0; kk < FH / 16; ++kk)
      F::wgmma_ss_bf16_n32(acc, gmma_desc(a + kk * 32, 16, 1024, 128),
                           gmma_desc(b + kk * 32, 16, 1024, 128));
  }
}

// Warpgroup 0's part of tile i, keys kv0 .. kv0 + FKV - 1: S over the
// d-chunks (with ranks > 1 the block's partial, then the cluster's sum),
// the mask (visible(r, key): whether owned row r sees the key), s * kc,
// the online softmax (m, l updated), P * vs as three bf16 tiles at sp,
// alpha at sa.  BOUND (H1's bound statistic): m holds each row's fixed
// shift, alpha = 1
template <int NC, int KIND, bool BOUND, class Visible>
__device__ __forceinline__ void softmax_tile_f32(
    unsigned char* smem, FBars<NC>* bars, int i, int kv0, Visible visible,
    float (&m)[2], float (&l)[2], unsigned char* sp, float* sa,
    uint32_t ranks) {
  using C = FCfg<NC, KIND>;
  namespace F = eft::f32;
  const int lane = threadIdx.x % 32;
  const int rl = threadIdx.x / 32 * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  // S = the sum over the d-chunks of S_c, each in a fresh accumulator
  // over its two 64-column halves
  float acc_s[FKV / 2];
#pragma unroll
  for (int e = 0; e < FKV / 2; ++e) acc_s[e] = 0.f;
  for (int c = 0; c < NC; ++c) {
    float part[FKV / 2];
#pragma unroll
    for (int e = 0; e < FKV / 2; ++e) part[e] = 0.f;
    for (int h = 2 * c; h < 2 * c + 2; ++h) {
      const int j = i * C::NS + h, s = j % 2;
      mbar_wait(&bars->sk_full[s], (j / 2) & 1);
      wgmma_fence();
      issue_s_half<NC, KIND>(part, smem + C::sk + s * C::SK_BYTES);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      mbar_arrive(&bars->sk_empty[s]);
    }
#pragma unroll
    for (int e = 0; e < FKV / 2; ++e) acc_s[e] += part[e];
  }
  if (ranks > 1)
    exchange_s(acc_s, reinterpret_cast<float4*>(smem + C::xchg), bars->xbar,
               i, ranks);

  // the mask, s * kc, the online softmax in the exp2 basis
  const float* kc = reinterpret_cast<const float*>(smem + C::fac) +
                    (i % 2) * 2 * FKV;
  const float* vsc = kc + FKV;
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int e = 0; e < FKV / 2; ++e) {
    const int r = acc_row8(e) / 8, col = col0 + acc_col(e);
    acc_s[e] = visible(r, kv0 + col) ? acc_s[e] * kc[col] : -CUDART_INF_F;
    mx[r] = fmaxf(mx[r], acc_s[e]);
  }
  float alpha[2], m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if constexpr (BOUND) {
      m_use[r] = m[r];
      alpha[r] = 1.f;
    } else {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
    }
  }
  // p, l, and P * vs split into three bf16 pieces, piece p in columns
  // 32 p .. 32 p + 31 of the tile
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < FKV / 4; ++j) {
    const int r = acc_row8(2 * j) / 8, col = col0 + acc_col(2 * j);
    const float p0 = exp2f(acc_s[2 * j] - m_use[r]);        // 0 where masked
    const float p1 = exp2f(acc_s[2 * j + 1] - m_use[r]);
    psum[r] += p0 + p1;
    uint32_t w[3];
    F::split3x2(p0 * vsc[col], p1 * vsc[col + 1], w);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint32_t*>(sp + p_offset(rl + 8 * r, 32 * p + col)) =
          w[p];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
  if (col0 == 0) {
    sa[rl] = alpha[0];
    sa[rl + 8] = alpha[1];
  }
  mbar_arrive(&bars->fac_empty[i % 2]);
}

// A consumer warpgroup's key loop (wg < NC; FIRST: warpgroup 0, a code
// path of its own, so that each keeps the registers setmaxnreg gives it),
// over the n_tiles tiles from key kv_begin: per tile, warpgroup 0 computes
// S, the softmax and P (softmax_tile_f32, the keys `visible` says each
// row sees); then every warpgroup c computes P V_c in a fresh accumulator,
// P's three pieces from the shared tile (SS wgmma), and adds it to its O
// chunk rescaled by alpha.  On return acc_o is O_c unnormalized and, in
// warpgroup 0, m each row's shift and l its share of the row's sum; m and
// l start as the caller set them
template <int NC, int KIND, bool FIRST, bool BOUND = false, class Visible>
__device__ __forceinline__ void key_loop_f32(unsigned char* smem,
                                             FBars<NC>* bars, int kv_begin,
                                             int n_tiles, Visible visible,
                                             float (&acc_o)[DC / 2],
                                             float (&m)[2], float (&l)[2],
                                             uint32_t ranks) {
  using C = FCfg<NC, KIND>;
  namespace F = eft::f32;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int rl = threadIdx.x / 32 % 4 * 16 + lane / 4;
  float* salpha = reinterpret_cast<float*>(smem + C::alpha);

#pragma unroll
  for (int e = 0; e < DC / 2; ++e) acc_o[e] = 0.f;
  for (int i = 0; i < n_tiles; ++i) {
    const int b = i % 2;
    unsigned char* sp = smem + C::p + b * C::P_BYTES;
    if constexpr (FIRST) {
      mbar_wait(&bars->p_empty[b], ((i / 2) & 1) ^ 1);
      softmax_tile_f32<NC, KIND, BOUND>(smem, bars, i, kv_begin + i * FKV,
                                        visible, m, l, sp, salpha + b * BQ,
                                        ranks);
      fence_proxy_async();
      mbar_arrive(&bars->p_full[b]);
    }
    mbar_wait(&bars->p_full[b], (i / 2) & 1);
    const float a[2] = {salpha[b * BQ + rl], salpha[b * BQ + rl + 8]};
    const int sv = (i * NC + wg) % C::V_SLOTS;
    mbar_wait(&bars->v_full[wg], i & 1);
    const unsigned char* v_s = smem + C::v + sv * C::V_BYTES;
    float part[DC / 2];
    wgmma_fence();
#pragma unroll
    for (int t = 0; t < C::TERMS; ++t) {
      const int pp = F::piece_a<C::TERMS>(t);
      const unsigned char* vp = v_s + F::piece_b<C::TERMS>(t) * FV_PIECE;
#pragma unroll
      for (int kk = 0; kk < FKV / 16; ++kk) {
        const int col = 32 * pp + 16 * kk;
        wgmma_ss_bf16_n128_tb(
            part,
            gmma_desc(sp + (col / 64) * BQ * 128 + (col % 64) * 2, 16, 1024,
                      128),
            gmma_desc(vp + kk * 16 * 128, FKV * 128, 1024, 128),
            t > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    mbar_arrive(&bars->v_empty[sv]);
    mbar_arrive(&bars->p_empty[b]);
#pragma unroll
    for (int e = 0; e < DC / 2; ++e)
      acc_o[e] = fmaf(acc_o[e], a[acc_row8(e) / 8], part[e]);
  }
}

// After the key loop: warpgroup 0 hands l over to the others, whose l is
// then placed so that store_o_rows' quad sum returns each row's sum
template <int NC, int KIND, bool FIRST>
__device__ __forceinline__ void share_l_f32(unsigned char* smem,
                                            float (&l)[2]) {
  using C = FCfg<NC, KIND>;
  if constexpr (NC > 1) {
    const int lane = threadIdx.x % 32;
    const int rl = threadIdx.x / 32 % 4 * 16 + lane / 4;
    float* sl = reinterpret_cast<float*>(smem + C::lsum);
    if constexpr (FIRST) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l_row = quad_sum(l[r]);
        if (lane % 4 == 0) sl[rl + 8 * r] = l_row;
      }
    }
    named_bar_sync(L_BAR, NC * 128);
    if constexpr (!FIRST) {
      l[0] = lane % 4 == 0 ? sl[rl] : 0.f;
      l[1] = lane % 4 == 0 ? sl[rl + 8] : 0.f;
    }
  }
}

// A consumer warpgroup of H5's f32 block: its key loop over every key
// (those past Lkv masked), then O_c / l stored in the chunk's columns (the
// block's first column c0, cut at d, the row stride)
template <int NC, int KIND, bool FIRST>
__device__ __forceinline__ void consume_f32(unsigned char* smem,
                                            FBars<NC>* bars, void* o,
                                            int out_f32, int lq, int lkv,
                                            int q0, int bh, int n_tiles,
                                            int d, int c0, uint32_t ranks) {
  const int wg = threadIdx.x / 128;
  const int rl = threadIdx.x / 32 % 4 * 16 + threadIdx.x % 32 / 4;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float acc_o[DC / 2];
  key_loop_f32<NC, KIND, FIRST>(
      smem, bars, 0, n_tiles, [lkv](int, int key) { return key < lkv; },
      acc_o, m, l, ranks);
  share_l_f32<NC, KIND, FIRST>(smem, l);
  // a value at a time where d % 8 != 0
  if (d % 8 != 0)
    store_o_rows<DC, true>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o,
                           out_f32, nullptr, d, c0 + wg * DC,
                           d - c0 - wg * DC);
  else
    store_o_rows<DC>(acc_o, l, m, q0 + rl, lq, size_t(bh) * lq, o, out_f32,
                     nullptr, d, c0 + wg * DC, d - c0 - wg * DC);
}

// The f32 block's barriers (thread 0), in a cluster of `ranks` blocks;
// the caller's cluster_sync makes them ready for every rank
template <int NC>
__device__ __forceinline__ void init_f32_bars(FBars<NC>* bars,
                                              uint32_t ranks) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bars->stage_full[s], 1);
      mbar_init(&bars->vstage_full[s], 1);
      mbar_init(&bars->sk_full[s], S_THREADS);
      mbar_init(&bars->sk_empty[s], 128);
      mbar_init(&bars->v_empty[s], 128);
      mbar_init(&bars->fac_empty[s], 128);
      mbar_init(&bars->p_full[s], 128);
      mbar_init(&bars->p_empty[s], NC * 128);
      mbar_init(&bars->xbar[s], 128 * ranks);
    }
    for (int c = 0; c < NC; ++c) mbar_init(&bars->v_full[c], 32);
    mbar_init_fence();
  }
}

// setmaxnreg from the launch's registers per thread to N (a no-op when
// they are equal)
template <int N, int LAUNCH>
__device__ __forceinline__ void set_regs() {
  if constexpr (N > LAUNCH) setmaxnreg_inc<N>();
  else if constexpr (N < LAUNCH) setmaxnreg_dec<N>();
}

// In clusters of C = %cluster_nctarank blocks along x (the launch's
// cluster dimension, 1 up to d 256), rank r holding d's columns [r D,
// r D + D) with D = 128 NC, cut at d (the row stride).  STAGED: rows no
// tensor map takes (f32 d % 4 != 0, codes d % 16 != 0), copied by the
// producer from qg, kg and vg (tq, tk and tv unused)
template <int NC, int KIND, bool STAGED>
__global__ void __launch_bounds__(FCfg<NC, KIND>::THREADS, 1)
dtiled_attention_f32_kernel(
    const __grid_constant__ CUtensorMap tq,  // [BH, Lq, d] f32
    const __grid_constant__ CUtensorMap tk,  // [BH, Lkv, d] f32 or codes
    const __grid_constant__ CUtensorMap tv,  // [BH, Lkv, d] f32 or codes
    const float* __restrict__ ks,            // [BH, n_blocks] or null
    const float* __restrict__ vs,            // [BH, n_blocks] or null
    void* __restrict__ o,                    // [BH, Lq, d]
    int out_f32, int lq, int lkv, int d, int block, int n_blocks,
    float scale_log2, const void* __restrict__ qg,
    const void* __restrict__ kg, const void* __restrict__ vg) {
  using C = FCfg<NC, KIND>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  auto* bars = reinterpret_cast<FBars<NC>*>(smem + C::bars);

  const uint32_t ranks = cluster_size();
  const int c0 = int(cluster_rank()) * C::D;
  const int n_qt = (lq + BQ - 1) / BQ;
  const int tile = blockIdx.x / ranks;
  const int bh = tile / n_qt;
  const int q0 = (tile % n_qt) * BQ;
  const int n_tiles = (lkv + FKV - 1) / FKV;
  const int wg = threadIdx.x / 128;

  init_f32_bars(bars, ranks);
  cluster_sync();             // every rank's barriers ready

  if (wg == NC) {
    if constexpr (NC > 1)
      set_regs<STAGED ? C::STAGED_PRODUCER_REGS : C::PRODUCER_REGS,
               C::LAUNCH_REGS>();
    produce_f32<NC, KIND, STAGED>(&tq, &tk, &tv, ks, vs, smem, bars, bh, q0,
                                  lkv, block, n_blocks, n_tiles, scale_log2,
                                  c0, qg, kg, vg, lq, d, bh, 0);
  } else if (wg == 0) {
    if constexpr (NC > 1) set_regs<C::WG0_REGS, C::LAUNCH_REGS>();
    consume_f32<NC, KIND, true>(smem, bars, o, out_f32, lq, lkv, q0, bh,
                                n_tiles, d, c0, ranks);
  } else if constexpr (NC > 1) {
    set_regs<C::OTHER_REGS, C::LAUNCH_REGS>();
    consume_f32<NC, KIND, false>(smem, bars, o, out_f32, lq, lkv, q0, bh,
                                 n_tiles, d, c0, ranks);
  }
  cluster_sync();             // no rank still reads this block's buffer
}

template <int NC, int KIND, bool STAGED>
int launch_f32(const void* q, const void* k, const void* v, const void* ks,
               const void* vs, void* o, int out_f32, int bh, int lq, int lkv,
               int d, int block, int n_blocks, float scale_log2, int ranks,
               cudaStream_t stream) {
  using C = FCfg<NC, KIND>;
  CUtensorMap tq = {}, tk = {}, tv = {};
  if constexpr (!STAGED) {
    int err = make_tmap(&tq, q, 4, d, lq, bh, FH, BQ, 0);
    if (!err) err = make_tmap(&tk, k, C::KV_ELEM, d, lkv, bh, FH, FKV, 0);
    if (!err) err = make_tmap(&tv, v, C::KV_ELEM, d, lkv, bh, FH, FKV, 0);
    if (err) return err;
  }
  return launch_clusters(dtiled_attention_f32_kernel<NC, KIND, STAGED>,
                         C::THREADS, C::bytes, bh * ((lq + BQ - 1) / BQ),
                         ranks, stream, tq, tk, tv,
                         static_cast<const float*>(ks),
                         static_cast<const float*>(vs), o, out_f32, lq, lkv,
                         d, block, n_blocks, scale_log2, q, k, v);
}

// H5's plan for head dim d (ops/attention_v1_dtiled.py h5_plan): false
// outside the rule, else the cluster size and the chunks a block
bool h5_plan(int d, int in_f32, int* ranks, int* nc) {
  if (d < 1 || d > MAX_D) return false;
  const int chunks = (d + DC - 1) / DC;
  const int per_block = in_f32 ? F32_MAX_NC : MAX_NC;
  int c = 1;
  while (c * per_block < chunks) c *= 2;
  *ranks = c;
  *nc = (chunks + c - 1) / c;
  return c <= MAX_CLUSTER;
}

// whether a call's rows take the STAGED instances: a row stride that is
// no multiple of 16 bytes (bf16 d % 8 != 0, f32 d % 4 != 0, codes d % 16
// != 0), which no tensor map takes
bool staged_rows(int d, int in_f32, int kv_kind) {
  if (kv_kind != KV_BF16) return d % 16 != 0;
  return in_f32 ? d % 4 != 0 : d % 8 != 0;
}

// go(integral_constant<int, NC>) for nc in 1..MAX
template <int MAX, class Go>
int with_nc(int nc, Go go) {
  switch (nc) {
    case 1:
      return go(std::integral_constant<int, 1>{});
    case 2:
      if constexpr (MAX >= 2) return go(std::integral_constant<int, 2>{});
      break;
    case 3:
      if constexpr (MAX >= 3) return go(std::integral_constant<int, 3>{});
      break;
    case 4:
      if constexpr (MAX >= 4) return go(std::integral_constant<int, 4>{});
      break;
  }
  return int(cudaErrorInvalidValue);
}

// go(integral_constant<int, KIND>) for the C entry's kv_kind
template <class Go>
int with_kind(int kv_kind, Go go) {
  switch (kv_kind) {
    case KV_BF16:
      return go(std::integral_constant<int, KV_BF16>{});
    case KV_INT8:
      return go(std::integral_constant<int, KV_INT8>{});
    case KV_FP8:
      return go(std::integral_constant<int, KV_FP8>{});
  }
  return int(cudaErrorInvalidValue);
}

}  // namespace

namespace eft {
namespace dtiled {

// One launch of a STAGED instance (dtiled_attention_staged.cu): the C
// entry's arguments, its plan (cluster, nc) already checked
int launch_staged(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, void* o, int out_f32,
                  int bh, int lq, int lkv, int d, int block, int n_blocks,
                  int kv_kind, float scale_log2, int in_f32, int cluster,
                  int nc, cudaStream_t stream);

}  // namespace dtiled
}  // namespace eft
