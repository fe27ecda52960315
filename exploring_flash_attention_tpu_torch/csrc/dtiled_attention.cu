// H5's C entries and its instances whose rows TMA describes; the kernels,
// their design and their launches are in dtiled_attention.cuh, and the
// STAGED instances in dtiled_attention_staged.cu.

#include "dtiled_attention.cuh"

// Returns the cudaError_t of the launch (0 on success).  The wrapper in
// ops/attention_v1_dtiled.py has already checked shapes, dtypes,
// contiguity and alignment; the checks here only refuse what would index
// out of bounds.  kv_kind: 0 bf16 (f32 with in_f32; ks, vs unused), 1
// int8, 2 e4m3; d from 1 to 2048; scale_log2 = softmax
// scale * log2(e); in_f32: 0 for bf16 q (and K/V), 1 for f32 (the f32
// kernel); cluster, nc: the plan the wrapper computed for d, which must be
// this file's (h5_plan).
extern "C" int eft_dtiled_attention(const void* q, const void* k,
                                    const void* v, const void* ks,
                                    const void* vs, void* o, int batch,
                                    int heads, int lq, int lkv, int d,
                                    int block, int n_blocks, int kv_kind,
                                    int out_f32, float scale_log2,
                                    int in_f32, int cluster, int nc,
                                    int device, void* stream) {
  int want_c = 0, want_nc = 0;
  if (batch <= 0 || heads <= 0 || lq <= 0 || lkv <= 0 ||
      (in_f32 != 0 && in_f32 != 1) || !h5_plan(d, in_f32, &want_c, &want_nc) ||
      cluster != want_c || nc != want_nc ||
      (kv_kind != KV_BF16 &&
       (block <= 0 || n_blocks != (lkv + block - 1) / block)))
    return int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return int(dev_err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bh = batch * heads;
  if (long(bh) * ((lq + BQ - 1) / BQ) * cluster > 0x7fffffffL)
    return int(cudaErrorInvalidValue);
  if (staged_rows(d, in_f32, kv_kind))
    return eft::dtiled::launch_staged(q, k, v, ks, vs, o, out_f32, bh, lq,
                                      lkv, d, block, n_blocks, kv_kind,
                                      scale_log2, in_f32, cluster, nc, s);
  return with_kind(kv_kind, [&](auto kind) {
    constexpr int KIND = decltype(kind)::value;
    if (in_f32)
      return with_nc<F32_MAX_NC>(nc, [&](auto n) {
        return launch_f32<decltype(n)::value, KIND, false>(
            q, k, v, ks, vs, o, out_f32, bh, lq, lkv, d, block, n_blocks,
            scale_log2, cluster, s);
      });
    if (cluster == 1 && d == nc * DC)       // the single-block instances
      return with_nc<MAX_NC>(nc, [&](auto n) {
        return launch<decltype(n)::value, KIND>(
            q, k, v, ks, vs, o, out_f32, bh, lq, lkv, block, n_blocks,
            scale_log2, s);
      });
    return with_nc<MAX_NC>(nc, [&](auto n) {
      return launch_cluster<decltype(n)::value, KIND, false>(
          q, k, v, ks, vs, o, out_f32, bh, lq, lkv, d, block, n_blocks,
          scale_log2, cluster, s);
    });
  });
}

// The most clusters of the instance a call at head dim d launches (the
// cluster instance of bf16 and quantized K/V, whose single-block instances
// are not clusters; the STAGED instances take the same threads and shared
// memory) that can be active on `device` at once
// (cudaOccupancyMaxActiveClusters), or minus a cudaError_t
extern "C" int eft_dtiled_clusters(int d, int in_f32, int kv_kind,
                                   int device) {
  int ranks = 0, nc = 0;
  if (!h5_plan(d, in_f32, &ranks, &nc)) return -int(cudaErrorInvalidValue);
  const cudaError_t dev_err = cudaSetDevice(device);
  if (dev_err != cudaSuccess) return -int(dev_err);
  return with_kind(kv_kind, [&](auto kind) {
    constexpr int KIND = decltype(kind)::value;
    if (in_f32)
      return with_nc<F32_MAX_NC>(nc, [&](auto n) {
        constexpr int NC = decltype(n)::value;
        using C = FCfg<NC, KIND>;
        return max_clusters(dtiled_attention_f32_kernel<NC, KIND, false>,
                            C::THREADS, C::bytes, ranks);
      });
    return with_nc<MAX_NC>(nc, [&](auto n) {
      constexpr int NC = decltype(n)::value;
      using C = Cfg<NC, KIND, true>;
      return max_clusters(dtiled_attention_cluster_kernel<NC, KIND, false>,
                          C::THREADS, C::bytes, ranks);
    });
  });
}
