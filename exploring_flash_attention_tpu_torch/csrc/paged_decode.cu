// H6-decode's C entry and its instances at the multiples of 16; the
// kernel, its design and its launches are in paged_decode.cuh, and the
// instances of the other head dims in paged_decode_odd.cu.

#include "paged_decode.cuh"

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// serving/decode.py has already checked shapes, dtypes, contiguity and
// alignment and planned the split; the checks here only refuse what would
// index out of bounds.  d: 1 to 512, bf16 or f32 q; page_size: a multiple
// of 128.  window: 0 for none.  fused: 1 merges the runs into
// o [B, Hq, d] in q's dtype (o_part and lse are then the workspace, tickets
// B * Hkv * chunks zeroed ints, chunks = cdiv(group, 8), cdiv(group, 4)
// at d > 128, cdiv(group, 2) at d > 256); 0 writes the partials only (o
// and tickets unused).  q_f32: 0 for bf16 q and o, 1 for f32.
extern "C" int eft_paged_decode(const void* q, const void* pages,
                                const void* scales, const void* page_table,
                                const void* seq_lens, const void* slots,
                                void* o_part, void* lse, void* o,
                                void* tickets, int batch, int hq, int hkv,
                                int d, int page_size, int max_pages,
                                int max_seqs, int window, int n_split,
                                int pages_per_split, int fused, float scale,
                                int q_f32, int device, void* stream) {
  const int group = hkv > 0 ? hq / hkv : 0;
  const int cap = d > 256 ? 2 : d > 128 ? 4 : 8;
  if (batch <= 0 || batch > 65535 || hkv <= 0 || hq % hkv != 0 ||
      int64_t(hkv) * ((group + cap - 1) / cap) > 65535 || d < 1 ||
      d > 512 || page_size % PAGE_TILE != 0 ||
      page_size <= 0 ||
      max_pages <= 0 || int64_t(max_pages) * page_size > INT32_MAX ||
      window < 0 || n_split <= 0 || n_split > INT32_MAX / 65535 ||
      pages_per_split <= 0 ||
      (window == 0 && int64_t(n_split) * pages_per_split < max_pages) ||
      (fused && (o == nullptr || tickets == nullptr)) ||
      ((!fused || n_split > 1) && (o_part == nullptr || lse == nullptr)) ||
      (q_f32 != 0 && q_f32 != 1))
    return int(cudaErrorInvalidValue);
  // this library links its own CUDA runtime: select the tensors' device
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, pages, scales, page_table, seq_lens, slots, o_part, lse, o,
               tickets, batch, hq, hkv, d, page_size, max_pages, max_seqs,
               window, n_split, pages_per_split, scale, q_f32, fused};
  return d % 16 != 0 ? eft::decode::launch_odd(a, s) : launch_d<false>(a, s);
}
