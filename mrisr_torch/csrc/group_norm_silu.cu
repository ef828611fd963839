// Fused GroupNorm + SiLU on NCHW for Hopper (sm_90a), with a plain C interface
// (built by mrisr_torch/_build.py, loaded with ctypes by
// mrisr_torch/ops/groupnorm.py).
//
// Replaces the TPU kernel mrisr_tpu/ops/groupnorm.py::_gn_silu_kernel,
// launched by _gn_silu_forward: per (image, group) the mean and E[x^2] in
// fp32, var = max(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps), the affine
// folded into a per-channel scale and shift, and y * sigmoid(y) written in
// the input dtype.
//
// What bounds it on an H100 SXM (3.35 TB/s): bytes, one read and one write
// of x.  The largest call of the serving chain, 8 x 96 x 256^2 bf16, moves
// 201 MB: 60 us.  The smallest, 8 x 128 x 32^2, moves 2 MB: under 1 us, so
// there the launch and the wrapper's host time set the time.
//
// Design.  In NCHW an (image, group) span is contiguous: cg = C / groups
// channels of H*W elements.  The TPU kernel keeps a whole image resident in
// VMEM and reads it once; here one thread-block cluster takes one span, and
// the span is cut into one slice per CTA of the cluster, sized to fit the
// CTA's shared memory (the plan, made by the wrapper: groupnorm.py::gn_plan):
//   * the cluster has 1, 2, 4 or 8 CTAs, the fewest that keep a slice at
//     kSliceTarget bytes or under (a span of up to 64 KB takes one CTA; the
//     largest of the chain, 786 KB in bf16, 8 CTAs of 98 KB);
//   * each CTA streams its slice from device memory into shared memory, in
//     the storage dtype, 16 bytes a thread a load (one element where a
//     channel's H*W is no multiple of 16 bytes or x is not aligned), and sums
//     x and x^2 in fp32 on the way;
//   * the CTA's two sums go to its shared memory; behind a cluster barrier
//     every CTA reads all of them through distributed shared memory (mapa,
//     ld.shared::cluster), in rank order, so every CTA of the cluster gets
//     the same mean and rstd;
//   * then each CTA normalizes and applies SiLU from shared memory and stores
//     y: x is read from device memory once.  A slice larger than
//     kMaxSliceBytes (fp32 spans beyond 8 x 224 KB, none on the chain) is not
//     kept: the same kernel reads it a second time instead.
// A cluster barrier before the kernel ends keeps every CTA's shared memory
// alive until the other CTAs of its cluster have read its sums.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 512 threads, 4 loads in flight each and registers for 3 CTAs an SM (40 a
// thread; a chunk's index is 32-bit).  Over the chain's bf16 shapes, 2 loads
// with room for 4 CTAs (it spills) were 7 % slower, room for only 2 CTAs
// 9 %, 8 loads with no cap 36 %, 256 threads 7 %, slices aimed at 32 or
// 128 KB 5-6 % (mrisr_torch/tools/gn_sweep.py; PERF.md).
constexpr int kThreads = 512;               // threads a CTA
constexpr int kBatch = 4;                   // 16-byte loads in flight a thread
constexpr int kMinBlocks = 3;               // CTAs an SM the registers must leave room for               // CTAs an SM the registers must leave room for
constexpr int kMaxCluster = 8;              // CTAs a cluster, at most (the portable limit)
constexpr int kSliceTarget = 64 * 1024;     // bytes of a slice the plan aims at
constexpr int kMaxSliceBytes = 224 * 1024;  // bytes of a slice a CTA may keep in shared memory

// ---- thread-block clusters -------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster arrives, then waits for all: the
// release/acquire pair makes shared-memory writes before the arrive visible
// to reads after the wait, in any CTA of the cluster.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The float at `p` (a __shared__ variable) in the shared memory of CTA `rank` of the cluster.
__device__ __forceinline__ float ld_shared_cluster(const float* p, uint32_t rank) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// ---- element types ---------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half_rn(x); }

// VE elements of T loaded and stored as one unit (16 bytes, or one element).
template <typename T, int VE>
struct alignas(sizeof(T) * VE) Pack {
  T v[VE];
};

template <typename T, int VE>
__device__ __forceinline__ Pack<T, VE> load_global(const Pack<T, VE>* p) {
  if constexpr (sizeof(Pack<T, VE>) == 16) {
    const uint4 r = __ldg(reinterpret_cast<const uint4*>(p));
    return *reinterpret_cast<const Pack<T, VE>*>(&r);
  } else {
    return *p;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One cluster per (image, group) span of `span` elements, one slice of
// `chunk` elements (a multiple of VE) per CTA of it.  `resident`: the slice
// is kept in shared memory between the two passes.
template <typename T, int VE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    gn_silu_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b, T* __restrict__ y,
                   long long span, int hw, int cg, int groups, long long chunk, int resident, float inv_count,
                   float eps) {
  using P = Pack<T, VE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* buf = reinterpret_cast<P*>(smem_raw);
  __shared__ float red[2][kThreads / 32];
  __shared__ float sums[2];   // this CTA's sums of x and x^2, read by the whole cluster
  __shared__ float stats[2];  // mean, rstd

  const uint32_t rank = cluster_ctarank(), n_ctas = cluster_nctarank();
  const uint32_t span_id = blockIdx.x / n_ctas;
  const long long lo = rank * chunk;
  const long long hi = lo + chunk < span ? lo + chunk : span;
  // Units of this CTA's slice: a chunk is under 2^31 elements (the entry point checks it).
  const int units = hi > lo ? (int)((hi - lo) / VE) : 0;
  const P* xs = reinterpret_cast<const P*>(x + span_id * span + lo);
  P* ys = reinterpret_cast<P*>(y + span_id * span + lo);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Pass 1: the slice into shared memory (when kept), its sums in fp32.
  float s1 = 0.f, s2 = 0.f;
  auto add = [&](const P& p) {
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float f = to_f32(p.v[e]);
      s1 += f;
      s2 = fmaf(f, f, s2);
    }
  };
  // kBatch loads in flight a thread (predicated, so a slice of any length
  // issues them together), then their stores to shared memory and sums.
  for (int u0 = threadIdx.x; u0 < units; u0 += kBatch * kThreads) {
    P p[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (u0 + i * kThreads < units) p[i] = load_global(xs + u0 + i * kThreads);
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (u0 + i * kThreads < units) {
        if (resident) buf[u0 + i * kThreads] = p[i];
        add(p[i]);
      }
    }
  }
  s1 = warp_sum(s1);
  s2 = warp_sum(s2);
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = warp_sum(lane < kThreads / 32 ? red[0][lane] : 0.f);
    s2 = warp_sum(lane < kThreads / 32 ? red[1][lane] : 0.f);
    if (lane == 0) {
      sums[0] = s1;
      sums[1] = s2;
    }
  }
  // The cluster's sums, in rank order in every CTA.
  cluster_arrive();
  cluster_wait();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
    for (uint32_t r = 0; r < n_ctas; ++r) {
      t1 += ld_shared_cluster(&sums[0], r);
      t2 += ld_shared_cluster(&sums[1], r);
    }
    const float mean = t1 * inv_count;
    stats[0] = mean;
    stats[1] = rsqrtf(fmaxf(t2 * inv_count - mean * mean, 0.f) + eps);
  }
  cluster_arrive();  // this CTA has read the others' sums (waited for before it exits)
  __syncthreads();

  // Pass 2: y = SiLU(x * scale_c + shift_c), from shared memory (or x again).
  const float mean = stats[0], rstd = stats[1];
  const int c0 = (int)(span_id % (uint32_t)groups) * cg;
  const long long lo_c = lo / hw;            // the channel and offset in it of the slice's first element
  const uint32_t lo_r = (uint32_t)(lo - lo_c * hw);
  for (int u = threadIdx.x; u < units; u += kThreads) {
    const P p = resident ? buf[u] : load_global(xs + u);
    // A unit lies in one channel: H*W is a multiple of VE.
    const int c = c0 + (int)lo_c + (int)((lo_r + (uint32_t)u * VE) / (uint32_t)hw);
    const float sc = to_f32(w[c]) * rstd, sh = to_f32(b[c]) - mean * sc;
    P out;
#pragma unroll
    for (int e = 0; e < VE; ++e) {
      const float v = fmaf(to_f32(p.v[e]), sc, sh);
      out.v[e] = from_f32<T>(__fdividef(v, 1.f + __expf(-v)));  // -0 where exp(-v) overflows
    }
    ys[u] = out;
  }
  cluster_wait();
}

template <typename T, int VE>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, long long n_spans, long long span, int hw,
                   int cg, int groups, int cluster, long long chunk, int resident, float eps, cudaStream_t stream) {
  auto kernel = gn_silu_kernel<T, VE>;
  static const cudaError_t attr =  // once per kernel: allow the largest slice
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSliceBytes);
  if (attr != cudaSuccess) return attr;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_spans * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = resident ? (size_t)chunk * sizeof(T) : 0;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[1];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(b),
                            static_cast<T*>(y), span, hw, cg, groups, chunk, resident, (float)(1.0 / (double)span),
                            eps);
}

template <typename T>
cudaError_t launch_dtype(int vec, const void* x, const void* w, const void* b, void* y, long long n_spans,
                         long long span, int hw, int cg, int groups, int cluster, long long chunk, int resident,
                         float eps, cudaStream_t stream) {
  constexpr int VE = 16 / sizeof(T);
  if (vec) {
    if (hw % VE != 0 || chunk % VE != 0) return cudaErrorInvalidValue;
    return launch<T, VE>(x, w, b, y, n_spans, span, hw, cg, groups, cluster, chunk, resident, eps, stream);
  }
  return launch<T, 1>(x, w, b, y, n_spans, span, hw, cg, groups, cluster, chunk, resident, eps, stream);
}

}  // namespace

// x, y [B, C, H, W] contiguous, of dtype 0 (fp32), 1 (bf16) or 2 (fp16); w, b
// [C] of the same dtype.  n_spans = B * groups spans of
// span = (C / groups) * H * W elements.  The plan (groupnorm.py::gn_plan):
// `cluster` CTAs a span (1, 2, 4 or 8), `chunk` elements a CTA (the last may
// have fewer), `resident` when a chunk is kept in shared memory (chunk times
// the element size at most kMaxSliceBytes), `vec` for 16-byte units (x and y
// 16-byte aligned, H*W and chunk multiples of 16 bytes).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int mrisr_group_norm_silu(const void* x, const void* w, const void* b, void* y, long long n_spans,
                                     long long span, int hw, int cg, int groups, int dtype, int cluster,
                                     long long chunk, int resident, int vec, float eps, void* stream) {
  const int elem = dtype == 0 ? 4 : 2;
  if (n_spans <= 0 || span <= 0 || hw <= 0 || cg <= 0 || groups <= 0 || chunk <= 0 || cluster < 1 ||
      cluster > kMaxCluster || (cluster & (cluster - 1)) != 0 || chunk * cluster < span ||
      (resident && chunk * elem > kMaxSliceBytes) || chunk + hw > 0x7fffffffLL || n_spans * cluster > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch_dtype<float>(vec, x, w, b, y, n_spans, span, hw, cg, groups, cluster, chunk, resident, eps, st);
    case 1: return (int)launch_dtype<__nv_bfloat16>(vec, x, w, b, y, n_spans, span, hw, cg, groups, cluster, chunk, resident, eps, st);
    case 2: return (int)launch_dtype<__half>(vec, x, w, b, y, n_spans, span, hw, cg, groups, cluster, chunk, resident, eps, st);
  }
  return (int)cudaErrorInvalidValue;
}
