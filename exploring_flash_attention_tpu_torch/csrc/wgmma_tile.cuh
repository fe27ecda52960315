// The Hopper mainloop pieces shared by H1 (prefill_attention.cu), H3
// (attention_bwd.cu), H4-int8 (int8_attention.cu), H4-kvq
// (kvquant_attention.cu), H5 (dtiled_attention.cu), H6-extend
// (paged_extend.cu) and, for its barriers and 1-D bulk copies, H6-decode
// (paged_decode.cu), for sm_90a:
//
// - TMA descriptors, made on the host for each call with
//   cuTensorMapEncodeTiled (reached through cudaGetDriverEntryPoint, so the
//   library needs no -lcuda).  A [B*H, L, d] tensor is described in 3-D
//   (d, L, B*H), so a tile that runs past L is zero-filled at its own
//   head's end and never reads the next head's rows.  A box row is 128 or
//   64 bytes and carries the swizzle of its width, which the wgmma
//   descriptors below then name: bf16 d=128 is two 64-column boxes, bf16
//   d=64 and int8 d=128 one 128-byte box, int8 d=256 two of them, bf16
//   d=32 and int8 d=64 one 64-byte box.  A tensor whose d is below its kernel instance's D (a
//   multiple of 16, so every global row stride stays a multiple of 16
//   bytes) is described with its true d: the box columns past d, or a
//   whole box past it, are zero-filled, so they add nothing to Q K^T and
//   give O columns that the epilogue does not store.
// - The ring of K/V stages between the producer warpgroup and the consumer
//   warpgroups: mbarriers "full" (the producer's expect_tx, completed by
//   the TMA bytes) and "empty" (one arrival per consumer thread).
// - wgmma in inline PTX: bf16 -> f32 with A from shared memory or from
//   registers and B K-major or MN-major (transposed), s8 -> s32 with both
//   operands K-major; the fence / commit_group / wait_group discipline.
// - Row helpers on the accumulator layout.  Thread t of a warpgroup owns
//   element i of an m64nN accumulator (N/2 per thread) at
//       row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2)
//       col 8 * (i / 4) + 2 * (t % 4) + i % 2,
//   two rows of each 64-row tile, whose other columns sit in the three
//   neighbouring lanes of its quad.  Consecutive pairs (i, i + 1) of an f32
//   accumulator, packed to bf16x2, are the bf16 A fragment of the next
//   product: k-step kk of P V takes the pairs of columns 16 kk .. 16 kk +
//   15, registers 4 kk .. 4 kk + 3.  An s32 accumulator has no such map to
//   the s8 A fragment.
// - The conversion of int8 or e4m3 codes into bf16 or fp16 in shared
//   memory, in the swizzled layout a TMA load of the 16-bit tile would
//   give (convert_codes_tile): wgmma has no bf16 x int8 or bf16 x e4m3
//   form, so the quantized forwards convert K and V where they land.
// - The cluster helpers (distributed shared memory: mapa, loads from and
//   stores into a peer block's shared memory, arrivals on its mbarriers,
//   the cluster barrier) of H3's f32 D=256 instance and H5's clusters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace eft {
namespace hopper {

// element type of K and V (the kv_kind argument of the C entry points)
enum KvKind : int { KV_BF16 = 0, KV_INT8 = 1, KV_FP8 = 2 };

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The descriptor of a contiguous [bh, rows, cols] tensor of elem_bytes-wide
// elements (f32, bf16 or one-byte codes), loaded as boxes of box_cols x
// box_rows.  swizzle_bytes is 128,
// 64 or 0 (none); a swizzled box row must be exactly that wide.  Returns a
// cudaError_t (0 on success).
inline int make_tmap(CUtensorMap* map, const void* base, int elem_bytes,
                     int cols, int rows, int bh, int box_cols, int box_rows,
                     int swizzle_bytes) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(bh)};
  const cuuint64_t strides[2] = {cuuint64_t(cols) * elem_bytes,
                                 cuuint64_t(cols) * elem_bytes * rows};
  const cuuint32_t box[3] = {cuuint32_t(box_cols), cuuint32_t(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUtensorMapSwizzle swz =
      swizzle_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : swizzle_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_NONE;
  const CUresult res = fn(
      map, elem_bytes == 4   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
           : elem_bytes == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                             : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      3, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swz, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// The launch configuration of a grid in clusters of `cluster_x` blocks
// along x, for cudaLaunchKernelEx and cudaOccupancyMaxActiveClusters.  Used
// in place (cfg points at attr).
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch(dim3 grid, int cluster_x, int threads, size_t bytes,
                cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster_x;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = grid;
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// -------------------------------------------------- shared memory, barriers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes, the alignment a
// 128-byte swizzle pattern repeats at (the launch asks 1024 bytes more)
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + ((1024u - (a & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// after every mbar_init, before any thread uses the barriers
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// (each barrier helper also takes the barrier's shared-window address)
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  mbar_arrive(smem_u32(bar));
}

// arrive, and expect `bytes` more of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// rows [c1, c1 + box_rows), columns [c0, c0 + box_cols) of head c2 into
// shared memory at dst, completing on bar
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` contiguous bytes (a multiple of 16; both addresses 16-byte
// aligned) from global memory into shared memory at dst, completing on bar:
// the 1-D form of TMA, which needs no descriptor
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// shared-memory writes of the generic proxy (plain stores) made visible to
// the async proxy (wgmma operand reads); then a barrier among the writers
// and readers
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A warpgroup's registers per thread from here on: the producer gives some
// up, the consumers take them.  The block's total must stay what the launch
// allocated, or the consumers' increase waits forever.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// p itself, but opaque to the compiler: what is computed from it after this
// point (wgmma descriptors, swizzled addresses) is computed there, not
// hoisted out of the loop around it, where its registers would stay live
// over the whole loop (and spill, in H4-int8's D=256 instance)
template <class T>
__device__ __forceinline__ T* opaque(T* p) {
  asm volatile("" : "+l"(p));
  return p;
}

// blockIdx.x and threadIdx.x read again from their special registers:
// values computed from them here are not ones kept live since the kernel's
// start
__device__ __forceinline__ int ctaid_x_again() {
  uint32_t x;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(x));
  return int(x);
}
__device__ __forceinline__ int tid_x_again() {
  uint32_t x;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(x));
  return int(x);
}

// a named barrier over `threads` threads (id 0 is __syncthreads)
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ------------------------------------------- rows of any alignment
// Where a row of a tensor is not a multiple of 16 bytes (bf16 d % 8 != 0,
// f32 d % 4 != 0, int8 codes d % 16 != 0) a TMA descriptor cannot name its
// stride, and a 16-byte load of a piece of it is misaligned.  Such rows
// are read by these, at the widest width the row's start allows.

// the alignment in bytes (1 to 16) of every row start of rows of `bytes`
// bytes after a 16-byte aligned base
__device__ __forceinline__ int row_align(int bytes) {
  return min(bytes & -bytes, 16);
}

// cp.async (the per-thread asynchronous copy): BYTES (4, 8 or 16) from
// global src into shared dst, both BYTES-aligned; of them the first
// src_bytes are read and the rest zero-filled (0: zeros, src not read).
// cp_async_commit closes a group of them, cp_async_wait<N> waits until at
// most N groups of this thread are in flight; the copies are then this
// thread's generic-proxy writes (fence_proxy_async before wgmma reads).
// (dst: a shared-window address; src need not be valid where src_bytes
// is 0)
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src,
                                               int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(dst), "l"(src), "n"(BYTES), "r"(src_bytes)
               : "memory");
}

// 16 bytes to shared memory at the shared-window address dst
__device__ __forceinline__ void st_shared_v4(uint32_t dst, uint4 x) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(x.x), "r"(x.y), "r"(x.z), "r"(x.w)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// 16 bytes at p (global or shared), read in pieces of `al` bytes (1, 2,
// 4, 8 or 16; p is al-aligned), the bytes from n on zero (n >= 16: none)
__device__ __forceinline__ uint4 load16_al(const void* p, int al, int n) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  const unsigned char* b = static_cast<const unsigned char*>(p);
  if (al >= 16 && n >= 16) {
    const uint4 x = *reinterpret_cast<const uint4*>(b);
    w[0] = x.x, w[1] = x.y, w[2] = x.z, w[3] = x.w;
  } else if (al >= 4) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * i < n) w[i] = *reinterpret_cast<const uint32_t*>(b + 4 * i);
  } else if (al == 2) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (2 * i < n)
        w[i / 2] |= uint32_t(*reinterpret_cast<const uint16_t*>(b + 2 * i))
                    << (16 * (i % 2));
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i)
      if (i < n) w[i / 4] |= uint32_t(b[i]) << (8 * (i % 4));
  }
  // a piece read whole past n (a 4-byte word, n not a multiple of 4)
  // keeps only its first n bytes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int keep = n - 4 * i;
    if (keep < 4) w[i] = keep <= 0 ? 0u : w[i] & ((1u << (8 * keep)) - 1u);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// 8 f32 of a row at p (n of them before the row's end: 8 or more, all),
// 16-byte loads where the row's stride allows (vec4: d % 4 == 0), else one
// f32 at a time; zeros from n on
__device__ __forceinline__ void load8_f32(const float* p, int n, bool vec4,
                                          float4& x0, float4& x1) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  if (vec4) {
    x0 = n >= 4 ? *reinterpret_cast<const float4*>(p) : z;
    x1 = n >= 8 ? *reinterpret_cast<const float4*>(p + 4) : z;
    return;
  }
  float x[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = i < n ? p[i] : 0.f;
  x0 = make_float4(x[0], x[1], x[2], x[3]);
  x1 = make_float4(x[4], x[5], x[6], x[7]);
}

// ------------------------------------------------------------- clusters
// The blocks of a thread block cluster (launched with the cluster
// dimension attribute) run at once on neighbouring SMs and may write each
// other's shared memory and arrive on each other's mbarriers (distributed
// shared memory).  mapa turns an address of this block's shared memory
// into the same offset in a peer's, as st.shared::cluster and
// mbarrier.arrive.shared::cluster take it.  A write into a peer's shared
// memory is handed over by the arrival after it (release at cluster
// scope) and read after the peer's wait on that barrier (acquire at
// cluster scope).  H3's f32 instance at D=256 (attention_bwd.cu) and H5's
// cluster instances (dtiled_attention.cu) are the port's cluster kernels.

// this block's rank in its cluster
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// the number of blocks in this block's cluster
__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(n));
  return n;
}

// p (this block's shared memory) at the same offset in block `rank`'s
__device__ __forceinline__ uint32_t peer_smem(const void* p, uint32_t rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// 16 bytes into a peer's shared memory (an address from peer_smem)
__device__ __forceinline__ void st_peer_v4(uint32_t addr, float4 x) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(addr), "f"(x.x), "f"(x.y), "f"(x.z), "f"(x.w)
               : "memory");
}

// 16 bytes from a peer's shared memory (an address from peer_smem)
__device__ __forceinline__ float4 ld_peer_v4(uint32_t addr) {
  float4 x;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x.x), "=f"(x.y), "=f"(x.z), "=f"(x.w)
               : "r"(addr)
               : "memory");
  return x;
}

// arrive on a peer's mbarrier (an address from peer_smem), releasing this
// thread's earlier writes, those into the peer's shared memory among them
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
      :: "r"(bar) : "memory");
}

// mbar_wait acquiring at cluster scope: what the arriving peers released
// is visible after it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// every thread of every block of the cluster arrives, then waits for the
// others (release / acquire): after the barriers' init, before a block's
// shared memory is written by a peer, and before a block exits while a
// peer may still reach into it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n"
               ::: "memory");
}

// ---------------------------------------------------------------- wgmma

// The shared-memory matrix descriptor of wgmma.  Addresses and offsets are
// in bytes.  For a K-major operand in a swizzled layout, rows of
// swizzle_bytes follow each other and sbo is the step between 8-row groups
// (8 rows); lbo is not read.  For an MN-major operand, a row of
// swizzle_bytes holds consecutive MN elements of one k, sbo is the step
// between groups of 8 k and lbo the step between swizzle-wide MN blocks.
// A k-step inside a K-major swizzled row advances the start address by its
// bytes (the swizzle is a function of the address bits, so the pattern's
// base must be aligned to 8 rows: 1024 bytes at 128, 512 at 64).
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, uint32_t lbo,
                                              uint32_t sbo,
                                              int swizzle_bytes) {
  const uint64_t layout = swizzle_bytes == 128 ? 1 : swizzle_bytes == 64 ? 2
                          : swizzle_bytes == 32 ? 3 : 0;
  return uint64_t((smem_u32(smem) & 0x3FFFF) >> 4)
         | (uint64_t((lbo >> 4) & 0x3FFF) << 16)
         | (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed groups of this warpgroup are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Pin an accumulator's registers at this point of the program: reads and
// writes of them are not moved across an asynchronous wgmma's issue or its
// wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 -> f32, A and B in shared
// memory (descriptors), both K-major.
__device__ __forceinline__ void wgmma_ss_bf16_n128(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], bf16 -> f32, A in registers (the
// bf16 A fragment, 4 registers), B in shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_bf16_n32(float (&d)[16], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 -> f32, A in registers (the
// bf16 A fragment, 4 registers), B in shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_bf16_n64(float (&d)[32], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 -> f32, A in registers (the
// bf16 A fragment, 4 registers), B in shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_bf16_n128(float (&d)[64], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// D[64 x 256] (+)= A[64 x 16] B[16 x 256], bf16 -> f32, A in registers, B
// in shared memory MN-major: two m64n128k16 products, one per 128-column
// half of B (descriptors db_lo, db_hi).  The halves of D are the registers
// 0..63 and 64..127, the m64n256 accumulator's own layout.
__device__ __forceinline__ void wgmma_rs_bf16_n256(float (&d)[128],
                                                 const uint32_t* a,
                                                 uint64_t db_lo,
                                                 uint64_t db_hi) {
  wgmma_rs_bf16_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a[0], a[1],
                     a[2], a[3], db_lo, 1);
  wgmma_rs_bf16_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a[0], a[1],
                     a[2], a[3], db_hi, 1);
}

// As wgmma_rs_bf16_n64 in fp16: D[64 x 64] (+)= A[64 x 16] B[16 x 64],
// A the fp16 A fragment in registers, B fp16 in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_f16_n64(float (&d)[32], uint32_t a0,
                                                uint32_t a1, uint32_t a2,
                                                uint32_t a3, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// As wgmma_rs_bf16_n128 in fp16: D[64 x 128] (+)= A[64 x 16] B[16 x 128],
// A the fp16 A fragment in registers, B fp16 in shared memory MN-major.
__device__ __forceinline__ void wgmma_rs_f16_n128(float (&d)[64], uint32_t a0,
                                                 uint32_t a1, uint32_t a2,
                                                 uint32_t a3, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(scale_d));
}

// As wgmma_rs_bf16_n256 in fp16: D[64 x 256] (+)= A[64 x 16] B[16 x 256]
// as two m64n128k16 products, one per 128-column half of B.
__device__ __forceinline__ void wgmma_rs_f16_n256(float (&d)[128],
                                                const uint32_t* a,
                                                uint64_t db_lo,
                                                uint64_t db_hi) {
  wgmma_rs_f16_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a[0], a[1], a[2],
                    a[3], db_lo, 1);
  wgmma_rs_f16_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a[0], a[1], a[2],
                    a[3], db_hi, 1);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], bf16 -> f32, A and B in shared
// memory (descriptors), both K-major.
__device__ __forceinline__ void wgmma_ss_bf16_n64(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// As wgmma_ss_bf16_n64 with scale-d false: D = A B, whatever D held.
__device__ __forceinline__ void wgmma_ss_bf16_n64_first(float (&d)[32],
                                                      uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 -> f32, A in shared memory
// K-major, B in shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_bf16_n128_tb(float (&d)[64],
                                                    uint64_t da, uint64_t db,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 32] B[32 x 64], s8 -> s32 (exact), A and B in
// shared memory, both K-major (the only form integer wgmma takes).
__device__ __forceinline__ void wgmma_ss_s8_n64(int (&d)[32], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 32] B[32 x 128], s8 -> s32 (exact), A and B in
// shared memory, both K-major (the only form integer wgmma takes).
__device__ __forceinline__ void wgmma_ss_s8_n128(int (&d)[64], uint64_t da,
                                               uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]),
        "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]),
        "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]),
        "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// As wgmma_ss_bf16_n128 with scale-d false: D = A B, whatever D held (the
// first k-step of a fresh product; D is written only).
__device__ __forceinline__ void wgmma_ss_bf16_n128_first(float (&d)[64], uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// As wgmma_ss_s8_n64 with scale-d false: D = A B, whatever D held (the
// first k-step of a fresh product; D is written only).
__device__ __forceinline__ void wgmma_ss_s8_n64_first(int (&d)[32], uint64_t da,
                                                      uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
        "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]),
        "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]),
        "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]),
        "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
        "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]),
        "=r"(d[28]), "=r"(d[29]), "=r"(d[30]), "=r"(d[31])
      : "l"(da), "l"(db), "r"(0));
}

// As wgmma_ss_s8_n128 with scale-d false: D = A B, whatever D held (the
// first k-step of a fresh product; D is written only).
__device__ __forceinline__ void wgmma_ss_s8_n128_first(int (&d)[64], uint64_t da,
                                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3]),
        "=r"(d[4]), "=r"(d[5]), "=r"(d[6]), "=r"(d[7]),
        "=r"(d[8]), "=r"(d[9]), "=r"(d[10]), "=r"(d[11]),
        "=r"(d[12]), "=r"(d[13]), "=r"(d[14]), "=r"(d[15]),
        "=r"(d[16]), "=r"(d[17]), "=r"(d[18]), "=r"(d[19]),
        "=r"(d[20]), "=r"(d[21]), "=r"(d[22]), "=r"(d[23]),
        "=r"(d[24]), "=r"(d[25]), "=r"(d[26]), "=r"(d[27]),
        "=r"(d[28]), "=r"(d[29]), "=r"(d[30]), "=r"(d[31]),
        "=r"(d[32]), "=r"(d[33]), "=r"(d[34]), "=r"(d[35]),
        "=r"(d[36]), "=r"(d[37]), "=r"(d[38]), "=r"(d[39]),
        "=r"(d[40]), "=r"(d[41]), "=r"(d[42]), "=r"(d[43]),
        "=r"(d[44]), "=r"(d[45]), "=r"(d[46]), "=r"(d[47]),
        "=r"(d[48]), "=r"(d[49]), "=r"(d[50]), "=r"(d[51]),
        "=r"(d[52]), "=r"(d[53]), "=r"(d[54]), "=r"(d[55]),
        "=r"(d[56]), "=r"(d[57]), "=r"(d[58]), "=r"(d[59]),
        "=r"(d[60]), "=r"(d[61]), "=r"(d[62]), "=r"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

// ------------------------------------------ rows of the accumulator layout

// the accumulator row (0 or 8, plus the thread's base row) and column
// (plus 2 * (t % 4)) of element i
__device__ __forceinline__ constexpr int acc_row8(int i) {
  return ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ constexpr int acc_col(int i) {
  return (i >> 2) * 8 + (i & 1);
}

// max and sum over the four lanes of a quad (one row's columns)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// lo and hi rounded to bf16 (to nearest even) and packed, lo in the low
// half: one register of a bf16 A fragment
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// as above, and the rounded values are added to `sum`
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi,
                                                float& sum) {
  const uint32_t r = pack_bf16x2(lo, hi);
  sum += __uint_as_float(r << 16) + __uint_as_float(r & 0xffff0000u);
  return r;
}

// lo and hi rounded to fp16 (to nearest even) and packed, lo in the low
// half: one register of an fp16 A fragment
__device__ __forceinline__ uint32_t pack_f16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.f16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The epilogue of an m64nD f32 O accumulator: O / l of the two rows this
// thread owns (rows row0 and row0 + 8, each l summed over the quad), as
// bf16 or f32, at o + (base + row) * ld + col for the rows below lq (ld
// and col set where D is a slice of a wider row); a row with l = 0 (it
// saw no key) stores O = 0.  Only the first ncols columns are stored: a
// head dim d below the instance's D runs on zero-filled columns past d,
// whose O columns are dropped here.  ncols is a multiple of 8 unless ANY,
// which stores one column at a time (any ld and ncols).  With lse, its
// natural-log LSE too, m ln 2 + ln l (m in the exp2 basis), -inf where
// l = 0.
template <int D, bool ANY = false>
__device__ __forceinline__ void store_o_rows(const float (&acc_o)[D / 2],
                                             const float (&l)[2],
                                             const float (&m)[2], int row0,
                                             int lq, size_t base, void* o,
                                             int out_f32, float* lse,
                                             int ld = D, int col = 0,
                                             int ncols = D) {
  const int col0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = quad_sum(l[r]);
    const int qi = row0 + 8 * r;
    if (qi >= lq) continue;
    const float denom = l_row == 0.f ? 1.f : l_row;
    const size_t row = base + qi;
    if (out_f32) {
      float* orow = static_cast<float*>(o) + row * ld + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (8 * j >= ncols) continue;
        const float x0 = acc_o[4 * j + 2 * r] / denom;
        const float x1 = acc_o[4 * j + 2 * r + 1] / denom;
        const int c = 8 * j + col0;
        if constexpr (ANY) {
          if (c < ncols) orow[c] = x0;
          if (c + 1 < ncols) orow[c + 1] = x1;
        } else {
          *reinterpret_cast<float2*>(orow + c) = make_float2(x0, x1);
        }
      }
    } else {
      __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(o) + row * ld + col;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (8 * j >= ncols) continue;
        const float x0 = acc_o[4 * j + 2 * r] / denom;
        const float x1 = acc_o[4 * j + 2 * r + 1] / denom;
        const int c = 8 * j + col0;
        if constexpr (ANY) {
          if (c < ncols) orow[c] = __float2bfloat16(x0);
          if (c + 1 < ncols) orow[c + 1] = __float2bfloat16(x1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(orow + c) =
              __floats2bfloat162_rn(x0, x1);
        }
      }
    }
    if (lse != nullptr && col0 == 0)
      lse[row] = l_row == 0.f ? -CUDART_INF_F
                              : m[r] * 0.6931471805599453f + logf(denom);
  }
}

// 2^x on the special-function unit (MUFU.EX2, within 2 ulp); results
// below 2^-126 flush to zero, and 2^-inf = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// ------------------------------------------------------ code conversion

// the byte offset of (row, byte) in a 128-byte-swizzled tile of 128-byte
// rows: 16-byte chunk c of row r sits at chunk c ^ (r % 8)
__device__ __forceinline__ uint32_t swz128(int row, int byte) {
  return row * 128 + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

// the same in a 64-byte-swizzled tile of 64-byte rows: 16-byte chunk c of
// row r sits at chunk c ^ ((r / 2) % 4) (the pattern repeats every 512
// bytes, where the tile must start)
__device__ __forceinline__ uint32_t swz64(int row, int byte) {
  return row * 64 + ((((byte >> 4) ^ (row >> 1)) & 3) << 4) + (byte & 15);
}

// (row, byte) in a tile of ROW-byte rows under the ROW-byte swizzle (ROW
// 64 or 128)
template <int ROW>
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  static_assert(ROW == 64 || ROW == 128, "a swizzle width");
  if constexpr (ROW == 128) return swz128(row, byte);
  else return swz64(row, byte);
}

// ------------------------------------------------------- staged rows
// Tiles whose rows no tensor map takes (bf16 rows of 2d bytes, d % 8 !=
// 0), loaded by a producer warpgroup itself into the layout its TMA boxes
// would give, a row a thread (H1's and H3's staged forms):
//   - the columns from the last whole 8-column chunk before d up to D are
//     zeroed once in every tile (zero_tail), before any copy lands;
//   - d even: the row as pieces of its alignment (8 or 4 bytes, 2 d's
//     largest power-of-two divisor), one cp.async each into the swizzled
//     place, zero-filled past the rows (a tile's rows past L);
//   - d odd (rows 2-byte aligned): the row's 8-column chunks read a bf16
//     at a time and stored as one 16-byte word, zeros past d or past the
//     rows;
//   - a tile's copies are a cp.async group; each thread hands its share
//     over (its copies landed, fence, arrive on the tile's full barrier,
//     which counts the 128 producer threads).

// zero columns [8 floor(d / 8), D) of row r of a tile of `rows` rows in
// boxes of BOX columns at the shared-window address tile
template <int D, int BOX>
__device__ __forceinline__ void zero_tail(uint32_t tile, int rows, int r,
                                          int d) {
  constexpr int ROW = BOX * 2;
#pragma unroll 1
  for (int c = d / 8 * 8; c < D; c += 8)
    st_shared_v4(tile + (c / BOX) * rows * ROW + swz<ROW>(r, (c % BOX) * 2),
                 make_uint4(0u, 0u, 0u, 0u));
}

// row r of a tile of `rows` rows in boxes of BOX columns (at the
// shared-window address tile), its columns below d, from src (a row of
// the bf16 matrix; in: the row exists, else zeros and src is not read)
template <int BOX>
__device__ __forceinline__ void stage_row(uint32_t tile, int rows, int r,
                                          const __nv_bfloat16* src, bool in,
                                          int d) {
  constexpr int ROW = BOX * 2;
  const int al = row_align(2 * d);              // 8, 4 or 2 bytes
  if (al >= 4) {
    const int e = al / 2;                       // columns a piece
#pragma unroll 1
    for (int c = 0; c < d; c += e) {
      const uint32_t dst =
          tile + (c / BOX) * rows * ROW + swz<ROW>(r, (c % BOX) * 2);
      if (al == 8) cp_async_zfill<8>(dst, src + c, in ? 8 : 0);
      else cp_async_zfill<4>(dst, src + c, in ? 4 : 0);
    }
    return;
  }
  // a chunk's 8 values at immediate offsets from one pointer: with an
  // address a value, ptxas held eight 64-bit addresses and spilled
  const unsigned short* h = reinterpret_cast<const unsigned short*>(src);
#pragma unroll 1
  for (int c = 0; c < d; c += 8, h += 8) {
    uint32_t x[4] = {0u, 0u, 0u, 0u};
    const int n = d - c;
    if (in) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j < n) x[j / 2] |= uint32_t(__ldg(h + j)) << (16 * (j % 2));
    }
    st_shared_v4(tile + (c / BOX) * rows * ROW + swz<ROW>(r, (c % BOX) * 2),
                 make_uint4(x[0], x[1], x[2], x[3]));
  }
}

// this thread's share of the tile behind the barrier at bar landed: hand
// it over
__device__ __forceinline__ void hand_over(uint32_t bar, bool all) {
  if (all) cp_async_wait<0>();
  else cp_async_wait<1>();
  fence_proxy_async();
  mbar_arrive(bar);
}

// 4 int8 codes -> 4 f32, exact: each byte with its sign bit flipped, u =
// code + 128, is the low byte of the f32 2^23 + u, from which 2^23 + 128
// is taken
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float (&f)[4]) {
  const uint32_t x = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7540)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7541)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7542)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7543)) - 8388736.f;
}

// two f32 that bf16 holds exactly -> bf16x2 (their high halves), lo low
__device__ __forceinline__ uint32_t exact_bf16x2(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 4 int8 codes -> two fp16x2, exact: the byte, sign flipped, is the low
// byte of the fp16 1024 + u, from which 1024 + 128 is taken
__device__ __forceinline__ void s8x4_to_f16x2(uint32_t w, uint32_t& h0,
                                              uint32_t& h1) {
  const uint32_t x = w ^ 0x80808080u;
  const uint32_t a = __byte_perm(x, 0x64646464u, 0x4140);
  const uint32_t b = __byte_perm(x, 0x64646464u, 0x4342);
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(h0) : "r"(a), "r"(0x64806480u));
  asm("sub.rn.f16x2 %0, %1, %2;\n" : "=r"(h1) : "r"(b), "r"(0x64806480u));
}

// 4 e4m3 codes -> two fp16x2 (exact, the byte order kept), sm_89 and up
__device__ __forceinline__ void e4m3x4_to_f16x2(uint32_t w, uint32_t& h0,
                                                uint32_t& h1) {
  asm("{\n.reg .b16 lo, hi;\nmov.b32 {lo, hi}, %2;\n"
      "cvt.rn.f16x2.e4m3x2 %0, lo;\ncvt.rn.f16x2.e4m3x2 %1, hi;\n}\n"
      : "=r"(h0), "=r"(h1) : "r"(w));
}

// fp16x2 -> bf16x2 through f32, exact for the values of e4m3
__device__ __forceinline__ uint32_t f16x2_to_bf16x2(uint32_t h) {
  uint32_t r;
  asm("{\n.reg .b16 lo, hi;\n.reg .f32 flo, fhi;\nmov.b32 {lo, hi}, %1;\n"
      "cvt.f32.f16 flo, lo;\ncvt.f32.f16 fhi, hi;\n"
      "cvt.rn.bf16x2.f32 %0, fhi, flo;\n}\n"
      : "=r"(r) : "r"(h));
  return r;
}

// 16 codes (KIND int8 or e4m3) -> 16 bf16 or fp16 values, exact (every
// int8 and e4m3 value fits either type), in order: out[i] holds codes 2i
// and 2i + 1, the first in the low half
template <int KIND, bool TO_F16>
__device__ __forceinline__ void codes16_convert(const uint4& in,
                                                uint32_t (&out)[8]) {
  const uint32_t w[4] = {in.x, in.y, in.z, in.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (KIND == KV_INT8 && TO_F16) {
      s8x4_to_f16x2(w[i], out[2 * i], out[2 * i + 1]);
    } else if constexpr (KIND == KV_INT8) {
      float f[4];
      s8x4_to_f32(w[i], f);
      out[2 * i] = exact_bf16x2(f[0], f[1]);
      out[2 * i + 1] = exact_bf16x2(f[2], f[3]);
    } else {
      uint32_t h0, h1;
      e4m3x4_to_f16x2(w[i], h0, h1);
      out[2 * i] = TO_F16 ? h0 : f16x2_to_bf16x2(h0);
      out[2 * i + 1] = TO_F16 ? h1 : f16x2_to_bf16x2(h1);
    }
  }
}

// A [rows][COLS] tile of codes (row-major, COLS bytes a row, COLS 64, 128
// or 256) -> 16-bit values in the layout a TMA load of the 16-bit tile gives:
// COLS / 64 boxes of [rows][64], 128-byte rows, 128-byte swizzle, box after
// box (rows a multiple of 8).  Thread t of n converts the 16-byte pieces
// t, t + n, ...; the caller fences (fence_proxy_async) before wgmma reads.
template <int KIND, bool TO_F16, int COLS>
__device__ __forceinline__ void convert_codes_tile(const unsigned char* src,
                                                   unsigned char* dst,
                                                   int rows, int t, int n) {
  constexpr int PIECES = COLS / 16;
  for (int x = t; x < rows * PIECES; x += n) {
    const int row = x / PIECES, c = (x % PIECES) * 16;
    const uint4 in = *reinterpret_cast<const uint4*>(src + row * COLS + c);
    uint32_t out[8];
    codes16_convert<KIND, TO_F16>(in, out);
    unsigned char* box = dst + (c / 64) * rows * 128;
    const int byte = (c % 64) * 2;
    *reinterpret_cast<uint4*>(box + swz128(row, byte)) =
        make_uint4(out[0], out[1], out[2], out[3]);
    *reinterpret_cast<uint4*>(box + swz128(row, byte + 16)) =
        make_uint4(out[4], out[5], out[6], out[7]);
  }
}

}  // namespace hopper
}  // namespace eft
