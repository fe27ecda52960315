// H6-decode: paged INT8 decode attention on Hopper (sm_90a).
//
// Replaces the TPU kernel B20 _decode_kernel
// (exploring_flash_attention_tpu/serving/decode.py:74): one new token per
// sequence attends over that sequence's whole paged INT8 KV history.
//
// B20 runs ONE program over a flattened (sequence, page) work list,
// because a TPU core runs its grid in order and a deep DMA window had to
// stay full across sequence boundaries.  Here the card runs blocks in
// parallel, so the design is one block per (batch row, KV head).  The
// block serves the head's whole GQA group (G q heads read the same K/V),
// reads its own slot, seq_lens[slot] and page-table row from device memory
// (no host sync), and walks the pages with an online softmax.  Dequant is
// folded as in B20: S = (q . K^T) * scale * k_scale[col]; columns at or past
// the sequence length are masked; l sums the unscaled p; P * v_scale[col]
// is rounded to the q dtype (bf16) before P V.
//
// Layout, per serving/kv_cache.py of the port: pages int8
// [n_pages, 2, Hkv, ps, d] (0 = K, 1 = V), scales f32 [n_pages, 2, Hkv, 1, ps].
//
// Cost: per layer and step the block set reads B*ctx*Hkv*d*2 bytes of int8
// plus 8 bytes of scales per (token, head): about 2.3 MB at B=8, ctx~280,
// Hkv=4, d=128.  That is bandwidth work, and tiny: with B*Hkv = 32 blocks
// on 132 SMs the kernel is latency-bound.  A fast version splits each
// sequence's pages across several blocks (split-KV) and merges the
// (O, LSE) partials in a second pass, and loads pages with cp.async/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int MAX_G = 8;          // q heads per KV head served by one block
constexpr int MAX_SMEM = 48 * 1024;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One block of D threads per (batch row, KV head).  Thread t owns output
// column t of every q head of the group; for Q K^T each warp takes one key
// row at a time with its lanes splitting d.
template <int D>
__global__ void __launch_bounds__(D)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,   // [B, Hq, D]
                    const int8_t* __restrict__ pages,      // [n_pages, 2, Hkv, ps, D]
                    const float* __restrict__ scales,      // [n_pages, 2, Hkv, 1, ps]
                    const int* __restrict__ page_table,    // [max_seqs, max_pages]
                    const int* __restrict__ seq_lens,      // [max_seqs]
                    const int* __restrict__ slots,         // [B]
                    __nv_bfloat16* __restrict__ o,         // [B, Hq, D]
                    int hq, int hkv, int page_size, int max_pages,
                    int max_seqs, float scale) {
  constexpr int NW = D / 32;
  constexpr int EPL = D / 32;                  // d elements per lane
  extern __shared__ __align__(16) float dsmem[];
  __shared__ float red[MAX_G][NW];
  const int group = hq / hkv;
  float* sq = dsmem;                           // [group][D] q in f32
  float* sp = sq + group * D;                  // [group][page_size] S, then P

  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const int slot = slots[b];
  const int n = (slot >= 0 && slot < max_seqs) ? seq_lens[slot] : 0;
  const __nv_bfloat16* qb = q + (size_t(b) * hq + size_t(hk) * group) * D;
  for (int g = 0; g < group; ++g) sq[g * D + tid] = __bfloat162float(qb[g * D + tid]);

  float m[MAX_G], l[MAX_G], acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = -CUDART_INF_F;
    l[g] = 0.f;
    acc[g] = 0.f;
  }

  const size_t slab = size_t(page_size) * D;   // one (K or V, head) of a page
  const int n_pages = (n + page_size - 1) / page_size;
  for (int j = 0; j < n_pages; ++j) {
    const size_t page = size_t(page_table[size_t(slot) * max_pages + j]);
    const int ntok = min(n - j * page_size, page_size);
    const int8_t* kp = pages + ((page * 2 + 0) * hkv + hk) * slab;
    const int8_t* vp = pages + ((page * 2 + 1) * hkv + hk) * slab;
    const float* ks = scales + ((page * 2 + 0) * hkv + hk) * page_size;
    const float* vs = scales + ((page * 2 + 1) * hkv + hk) * page_size;
    __syncthreads();                 // q staged / previous page's P consumed

    // S = (q . k) * scale * k_scale for the page's visible rows
    for (int t = warp; t < ntok; t += NW) {
      const int8_t* kr = kp + size_t(t) * D + lane * EPL;
      float kf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = float(kr[e]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < group) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part += sq[g * D + lane * EPL + e] * kf[e];
          part = warp_sum(part);
          if (lane == 0) sp[g * page_size + t] = part * scale * ks[t];
        }
      }
    }
    __syncthreads();

    float m_new[MAX_G], alpha[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < group) {
        float pm = -CUDART_INF_F;
        for (int t = 0; t < ntok; ++t) pm = fmaxf(pm, sp[g * page_size + t]);
        m_new[g] = fmaxf(m[g], pm);
        alpha[g] = expf(m[g] - m_new[g]);      // 0 while m was -inf
      }
    }
    __syncthreads();                 // every thread has read S

    // P = exp(S - m_new); l sums the unscaled p; the stored P carries the
    // V scale and is rounded to bf16, the q dtype
    float psum[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) psum[g] = 0.f;
    for (int t = tid; t < ntok; t += D) {
      const float vsc = vs[t];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < group) {
          const float p = expf(sp[g * page_size + t] - m_new[g]);
          psum[g] += p;
          sp[g * page_size + t] = __bfloat162float(__float2bfloat16(p * vsc));
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < group) {
        const float w = warp_sum(psum[g]);
        if (lane == 0) red[g][warp] = w;
      }
    }
    __syncthreads();

    float pv[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      pv[g] = 0.f;
      if (g < group) {
        float total = 0.f;
#pragma unroll
        for (int w = 0; w < NW; ++w) total += red[g][w];
        l[g] = l[g] * alpha[g] + total;
      }
    }
    // O column tid += P V
    for (int t = 0; t < ntok; ++t) {
      const float vv = float(vp[size_t(t) * D + tid]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < group) pv[g] += sp[g * page_size + t] * vv;
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < group) {
        acc[g] = acc[g] * alpha[g] + pv[g];
        m[g] = m_new[g];
      }
    }
  }

  __nv_bfloat16* ob = o + (size_t(b) * hq + size_t(hk) * group) * D;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < group) {
      const float denom = l[g] == 0.f ? 1.f : l[g];
      ob[g * D + tid] = __float2bfloat16(acc[g] / denom);
    }
  }
}

template <int D>
int launch(const void* q, const void* pages, const void* scales,
           const void* page_table, const void* seq_lens, const void* slots,
           void* o, int batch, int hq, int hkv, int page_size, int max_pages,
           int max_seqs, float scale, cudaStream_t stream) {
  const int group = hq / hkv;
  const size_t bytes = size_t(group) * (D + page_size) * sizeof(float);
  if (group > MAX_G || bytes > MAX_SMEM) return int(cudaErrorInvalidValue);
  const dim3 grid(batch, hkv);
  paged_decode_kernel<D><<<grid, D, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(pages), static_cast<const float*>(scales),
      static_cast<const int*>(page_table), static_cast<const int*>(seq_lens),
      static_cast<const int*>(slots), static_cast<__nv_bfloat16*>(o), hq, hkv,
      page_size, max_pages, max_seqs, scale);
  return int(cudaGetLastError());
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// serving/decode.py has already checked shapes, dtypes and contiguity.
extern "C" int eft_paged_decode(const void* q, const void* pages,
                                const void* scales, const void* page_table,
                                const void* seq_lens, const void* slots,
                                void* o, int batch, int hq, int hkv, int d,
                                int page_size, int max_pages, int max_seqs,
                                float scale, int device, void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || page_size <= 0)
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 64:
      return launch<64>(q, pages, scales, page_table, seq_lens, slots, o,
                        batch, hq, hkv, page_size, max_pages, max_seqs, scale,
                        s);
    case 128:
      return launch<128>(q, pages, scales, page_table, seq_lens, slots, o,
                         batch, hq, hkv, page_size, max_pages, max_seqs,
                         scale, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}
