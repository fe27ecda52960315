// H5's STAGED instances (dtiled_attention.cuh): rows whose stride is no
// multiple of 16 bytes (bf16 d % 8 != 0, f32 d % 4 != 0, codes d % 16 !=
// 0), copied by the producer itself.  A translation unit of their own, so
// that they compile beside the others; eft_dtiled_attention
// (dtiled_attention.cu) launches them.

#include "dtiled_attention.cuh"

namespace eft {
namespace dtiled {

int launch_staged(const void* q, const void* k, const void* v,
                  const void* ks, const void* vs, void* o, int out_f32,
                  int bh, int lq, int lkv, int d, int block, int n_blocks,
                  int kv_kind, float scale_log2, int in_f32, int cluster,
                  int nc, cudaStream_t stream) {
  return with_kind(kv_kind, [&](auto kind) {
    constexpr int KIND = decltype(kind)::value;
    if (in_f32)
      return with_nc<F32_MAX_NC>(nc, [&](auto n) {
        return launch_f32<decltype(n)::value, KIND, true>(
            q, k, v, ks, vs, o, out_f32, bh, lq, lkv, d, block, n_blocks,
            scale_log2, cluster, stream);
      });
    return with_nc<MAX_NC>(nc, [&](auto n) {
      return launch_cluster<decltype(n)::value, KIND, true>(
          q, k, v, ks, vs, o, out_f32, bh, lq, lkv, d, block, n_blocks,
          scale_log2, cluster, stream);
    });
  });
}

}  // namespace dtiled
}  // namespace eft
