// Probes of the tf32 wgmma forms that csrc/flash_attn_bwd.cu builds on, one
// warpgroup each (built and run by tools/tf32_probe.py):
//   * tf32_probe_ss: D[64 x 32] = A[64 x K] B[32 x K]^T, both operands raw fp32
//     read K-major from shared memory through TMA (K = 32: 128B swizzle; K =
//     16: 64B swizzle).  Held against A and B rounded to tf32 both ways, it
//     shows what the tensor cores read of a raw fp32 operand.
//   * tf32_probe_rs: C[64 x 64] = X[64 x 32] Y[32 x 64], X taken from an
//     accumulator-layout register tile through to_tf32_frags (3xTF32) and Y
//     as the transposed, permuted copies Yt (hi) and Yt_lo [64 x 32]; C1 is
//     the hi-hi product alone (1xTF32).
#include "../csrc/flash_common.cuh"
#include "../csrc/hopper.cuh"

namespace {

template <int K>
__global__ void __launch_bounds__(128) probe_ss_kernel(const __grid_constant__ CUtensorMap ta,
                                                       const __grid_constant__ CUtensorMap tb, float* d_out) {
  using R = SwizzledRows<K, 4>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t a_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_s = a_s + 64 * K * 4;
  const uint32_t bar = b_s + 32 * K * 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 96 * K * 4);
    R::load(a_s, &ta, bar, 0, 0, 64, 0);
    R::load(b_s, &tb, bar, 0, 0, 32, 0);
  }
  mbar_wait(bar, 0);
  float d[16];
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) wgmma_tf32_ss<32>(d, R::k_major(a_s, 64, 0, kk), R::k_major(b_s, 32, 0, kk), kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  store_rows_f32<32>(d, d_out, warp * 16 + (lane >> 2), 64, 1.f, lane & 3);
}

__global__ void __launch_bounds__(128) probe_rs_kernel(const float* x, const __grid_constant__ CUtensorMap tyt,
                                                       const __grid_constant__ CUtensorMap tyt_lo, float* c3,
                                                       float* c1) {
  using R = SwizzledRows<32, 4>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t y_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t ylo_s = y_s + 64 * 32 * 4;
  const uint32_t bar = ylo_s + 64 * 32 * 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, 2 * 64 * 32 * 4);
    R::load(y_s, &tyt, bar, 0, 0, 64, 0);
    R::load(ylo_s, &tyt_lo, bar, 0, 0, 64, 0);
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3, row = warp * 16 + g;
  float s[16];  // X in the m64n32 accumulator layout
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[4 * j] = x[row * 32 + 8 * j + 2 * t4];
    s[4 * j + 1] = x[row * 32 + 8 * j + 2 * t4 + 1];
    s[4 * j + 2] = x[(row + 8) * 32 + 8 * j + 2 * t4];
    s[4 * j + 3] = x[(row + 8) * 32 + 8 * j + 2 * t4 + 1];
  }
  uint32_t hi[4][4], lo[4][4];
  to_tf32_frags<32>(s, hi, lo);
  mbar_wait(bar, 0);
  float acc[32], one[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.f;
    one[i] = 0.f;
  }
  fence_regs(acc);
  fence_regs(one);
  fence_regs(hi);
  fence_regs(lo);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    wgmma_tf32_rs<64>(acc, lo[kk], R::k_major(y_s, 64, 0, kk));
    wgmma_tf32_rs<64>(acc, hi[kk], R::k_major(ylo_s, 64, 0, kk));
    wgmma_tf32_rs<64>(acc, hi[kk], R::k_major(y_s, 64, 0, kk));
    wgmma_tf32_rs<64>(one, hi[kk], R::k_major(y_s, 64, 0, kk));
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(one);
  store_rows_f32<64>(acc, c3, row, 64, 1.f, t4);
  store_rows_f32<64>(one, c1, row, 64, 1.f, t4);
}

constexpr int kSmem = 2 * 64 * 32 * 4 + 64 + 1024;

}  // namespace

// a [64, k], b [32, k], d [64, 32]; k is 32 or 16.
extern "C" int tf32_probe_ss(const void* a, const void* b, void* d, int k, void* stream) {
  CUtensorMap ta, tb;
  const int box = k < 32 ? k : 32;
  if (!encode_map(&ta, a, 1, 64, k, box, 64, 4) || !encode_map(&tb, b, 1, 32, k, box, 32, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  auto kernel = k == 32 ? probe_ss_kernel<32> : probe_ss_kernel<16>;
  const cudaError_t err = allow_smem(kernel, kSmem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<1, 128, kSmem, static_cast<cudaStream_t>(stream)>>>(ta, tb, static_cast<float*>(d));
  return (int)cudaGetLastError();
}

// x [64, 32]; yt, yt_lo [64, 32] (Y^T with each group of 8 k permuted); c3, c1 [64, 64].
extern "C" int tf32_probe_rs(const void* x, const void* yt, const void* yt_lo, void* c3, void* c1, void* stream) {
  CUtensorMap ty, tylo;
  if (!encode_map(&ty, yt, 1, 64, 32, 32, 64, 4) || !encode_map(&tylo, yt_lo, 1, 64, 32, 32, 64, 4)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t err = allow_smem(probe_rs_kernel, kSmem);
  if (err != cudaSuccess) return (int)err;
  probe_rs_kernel<<<1, 128, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), ty, tylo, static_cast<float*>(c3), static_cast<float*>(c1));
  return (int)cudaGetLastError();
}
