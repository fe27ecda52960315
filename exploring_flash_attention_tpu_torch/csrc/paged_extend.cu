// H6-extend: chunked-prefill attention over the paged INT8 KV cache on
// Hopper (sm_90a).  bf16 q, int8 pages, f32 accumulate.
//
// Replaces two TPU kernels of the JAX package that compute the same
// function and differ only by a VMEM rule (serving/decode.py:645-646):
//   B21 _extend_kernel           exploring_flash_attention_tpu/serving/decode.py:257
//   B22 _extend_onepass_kernel   exploring_flash_attention_tpu/serving/decode.py:455
// B22 holds all of a sequence's pages resident, B21 streams them.  Each
// sequence's C newest tokens are already appended to the cache (so they
// read themselves back quantized) and attend causally over its whole
// paged history: chunk row i sits at position q_start + i, where
// q_start = seq_lens[slot] - C, and sees column col iff col <= q_start + i.
//
// Design.  B21 runs one program per sequence because a TPU core runs its
// grid in order.  Here one block takes one (batch row, KV head) and one
// tile of 64 of the GQA-flattened rows: row r is chunk position r / G and
// q head kh * G + r % G (decode.py:326-329), so the G q heads share every
// K/V tile the block loads.  The block reads slots[b], seq_lens[slot] and
// the page-table row on the device (no host sync) and walks 64-column
// tiles of its pages only up to the last column its own rows can see: the
// causal skip, whose bound is per sequence because histories are ragged.
// Each tile's int8 K and V convert to bf16 exactly, so K enters the
// tensor-core product unscaled.  The dequant folds as in B21
// (decode.py:373-392): S = (q . K) * scale * k_scale[col] in the exp2
// basis, an online softmax in f32 whose l sums the unscaled p, and
// P * v_scale[col] rounded to bf16 before P V.  Columns at or past
// seq_lens are masked before the exp and their v_scale is zeroed, as B22
// does (decode.py:587-588): a freed and reused page holds old codes past
// the tail.  The tensor-core products and the layout are
// attention_tile.cuh's (WMMA through shared memory).
//
// Layout, per serving/kv_cache.py of the port: pages int8
// [n_pages, 2, Hkv, ps, d] (0 = K, 1 = V), scales f32 [n_pages, 2, Hkv, 1, ps];
// q and o [B, C, Hq, d], read and written in place of the TPU wrapper's
// [B, Hkv, C*G, d] transpose.
//
// Cost at the multi-turn slice (B=8, C=256, Hq=8, Hkv=4, d=128, chunk at
// 279..534): about 4*8*8*256*(279 + 128.5)*128 = 3.4 GFLOP per layer, and
// about 4.4 MB of int8 pages plus 0.14 MB of scales per layer, over
// 8 * 4 * 8 = 256 blocks.  That is a few microseconds of tensor-core work
// and of HBM time: latency-bound.  A fast version would run wgmma
// on register-resident S/P/O, convert and stage pages through a TMA or
// cp.async ring with producer/consumer warps, and split long histories
// across SMs with an (O, LSE) merge.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_tile.cuh"

namespace {

using namespace eft;

// 16 int8 values -> 16 bf16 (exact for |x| <= 127) in shared memory
__device__ __forceinline__ void int8x16_to_bf16(__nv_bfloat16* dst,
                                                const int8_t* src) {
  const int4 raw = *reinterpret_cast<const int4*>(src);
  const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
  __align__(16) __nv_bfloat16 out[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = __float2bfloat16(float(x[e]));
  reinterpret_cast<uint4*>(dst)[0] = reinterpret_cast<const uint4*>(out)[0];
  reinterpret_cast<uint4*>(dst)[1] = reinterpret_cast<const uint4*>(out)[1];
}

template <int D>
__global__ void __launch_bounds__(THREADS)
paged_extend_kernel(const __nv_bfloat16* __restrict__ q,   // [B, C, Hq, D]
                    const int8_t* __restrict__ pages,      // [n_pages, 2, Hkv, ps, D]
                    const float* __restrict__ scales,      // [n_pages, 2, Hkv, 1, ps]
                    const int* __restrict__ page_table,    // [max_seqs, max_pages]
                    const int* __restrict__ seq_lens,      // [max_seqs]
                    const int* __restrict__ slots,         // [B]
                    __nv_bfloat16* __restrict__ o,         // [B, C, Hq, D]
                    int c, int hq, int hkv, int page_size, int max_pages,
                    int max_seqs, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem + L::q);
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem + L::k);
  __nv_bfloat16* sv = reinterpret_cast<__nv_bfloat16*>(smem + L::v);
  float* ss = reinterpret_cast<float*>(smem + L::s);
  __nv_bfloat16* sp = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  float* so = reinterpret_cast<float*>(smem + L::o);
  float* sm = reinterpret_cast<float*>(smem + L::m);
  float* sl = reinterpret_cast<float*>(smem + L::l);
  float* salpha = reinterpret_cast<float*>(smem + L::alpha);
  float* sks = reinterpret_cast<float*>(smem + L::bytes);   // k_scale * scale * log2e
  float* svs = sks + BKV;                                   // v_scale, 0 past seq_lens

  const int group = hq / hkv;
  const int rows = c * group;                  // GQA-flattened chunk rows
  const int t0 = blockIdx.x * BQ;              // this block's first row
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  const int slot = slots[b];
  const bool valid = slot >= 0 && slot < max_seqs;
  const int n = valid ? seq_lens[slot] : 0;    // includes the chunk
  const int q_start = n - c;                   // position of chunk row 0
  // the tile's last row sees columns [0, kv_end); later tiles are skipped
  const int kv_end = min(n, q_start + (min(t0 + BQ, rows) - 1) / group + 1);

  // Q rows straight from [B, C, Hq, D]; rows past the chunk are zero
  constexpr int VEC = 8;                       // bf16 per 16 bytes
  for (int i = threadIdx.x; i < BQ * (D / VEC); i += THREADS) {
    const int r = i / (D / VEC);
    const int col = (i % (D / VEC)) * VEC;
    const int t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < rows) {
      const size_t row = (size_t(b) * c + t / group) * hq + kh * group + t % group;
      val = *reinterpret_cast<const uint4*>(q + row * D + col);
    }
    *reinterpret_cast<uint4*>(sq + r * L::LDH + col) = val;
  }
  for (int i = threadIdx.x; i < BQ * L::LDO; i += THREADS) so[i] = 0.f;
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    sm[r] = -CUDART_INF_F;
    sl[r] = 0.f;
  }

  const int* pt = page_table + size_t(valid ? slot : 0) * max_pages;
  const size_t slab = size_t(page_size) * D;   // one (K or V, head) of a page
  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    // page_size is a multiple of BKV, so a tile never straddles two pages
    const size_t page = size_t(pt[kv0 / page_size]);
    const int off = kv0 % page_size;
    const int8_t* kp = pages + ((page * 2 + 0) * hkv + kh) * slab + size_t(off) * D;
    const int8_t* vp = pages + ((page * 2 + 1) * hkv + kh) * slab + size_t(off) * D;
    const float* ksc = scales + ((page * 2 + 0) * hkv + kh) * page_size + off;
    const float* vsc = scales + ((page * 2 + 1) * hkv + kh) * page_size + off;
    __syncthreads();               // Q staged / previous tile consumed
    for (int i = threadIdx.x; i < BKV * (D / 16); i += THREADS) {
      const int t = i / (D / 16);
      const int col = (i % (D / 16)) * 16;
      int8x16_to_bf16(sk + t * L::LDH + col, kp + size_t(t) * D + col);
      int8x16_to_bf16(sv + t * L::LDH + col, vp + size_t(t) * D + col);
    }
    for (int t = threadIdx.x; t < BKV; t += THREADS) {
      sks[t] = ksc[t] * scale_log2;
      svs[t] = kv0 + t < n ? vsc[t] : 0.f;
    }
    __syncthreads();

    warp_qk<D>(sq, sk, ss, r0);            // S = Q K^T, this warp's rows
    __syncwarp();

    // online softmax over the warp's rows, in the exp2 basis; the mask is
    // per row: row t sees columns up to q_start + t / G
    for (int r = r0; r < r0 + 16; ++r) {
      const int t = t0 + r;
      const int lim = t < rows ? q_start + t / group : -1;   // last visible
      float s[BKV / 32];
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const int col = lane + 32 * j;
        s[j] = kv0 + col <= lim ? ss[r * L::LDS + col] * sks[col]
                                : -CUDART_INF_F;
        tmax = fmaxf(tmax, s[j]);
      }
      tmax = warp_max(tmax);
      const float m_old = sm[r];
      const float m_new = fmaxf(m_old, tmax);
      const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < BKV / 32; ++j) {
        const int col = lane + 32 * j;
        const float p = exp2f(s[j] - m_use);
        psum += p;                                  // l sums the unscaled p
        sp[r * L::LDP + col] = __float2bfloat16(p * svs[col]);
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        sm[r] = m_new;
        sl[r] = sl[r] * alpha + psum;
        salpha[r] = alpha;
      }
    }
    __syncwarp();

    warp_rescale_pv<D>(sp, sv, so, salpha, r0, lane);   // O = alpha O + P V
  }
  __syncthreads();                 // O, l complete (also when no tile ran)

  for (int r = r0; r < r0 + 16; ++r) {
    const int t = t0 + r;
    if (t >= rows) break;
    const float denom = sl[r] == 0.f ? 1.f : sl[r];
    const size_t row = (size_t(b) * c + t / group) * hq + kh * group + t % group;
    __nv_bfloat16* orow = o + row * D;
    for (int col = lane; col < D; col += 32)
      orow[col] = __float2bfloat16(so[r * L::LDO + col] / denom);
  }
}

template <int D>
int launch(const void* q, const void* pages, const void* scales,
           const void* page_table, const void* seq_lens, const void* slots,
           void* o, int batch, int c, int hq, int hkv, int page_size,
           int max_pages, int max_seqs, float scale, cudaStream_t stream) {
  const size_t bytes = Layout<D>::bytes + 2 * BKV * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      paged_extend_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  const int rows = c * (hq / hkv);
  const dim3 grid((rows + BQ - 1) / BQ, hkv, batch);
  paged_extend_kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(pages), static_cast<const float*>(scales),
      static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
      static_cast<const int*>(slots), static_cast<__nv_bfloat16*>(o), c, hq,
      hkv, page_size, max_pages, max_seqs, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// serving/decode.py has already checked shapes, dtypes and contiguity; the
// checks here only refuse what would index out of bounds.
extern "C" int eft_paged_extend(const void* q, const void* pages,
                                const void* scales, const void* page_table,
                                const void* seq_lens, const void* slots,
                                void* o, int batch, int c, int hq, int hkv,
                                int d, int page_size, int max_pages,
                                int max_seqs, float scale, int device,
                                void* stream) {
  if (batch <= 0 || c <= 0 || hkv <= 0 || hq % hkv != 0 || page_size <= 0 ||
      page_size % BKV != 0)
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, pages, scales, page_table, seq_lens, slots, o,
                        batch, c, hq, hkv, page_size, max_pages, max_seqs,
                        scale, s);
    case 128:
      return launch<128>(q, pages, scales, page_table, seq_lens, slots, o,
                         batch, c, hq, hkv, page_size, max_pages, max_seqs,
                         scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
