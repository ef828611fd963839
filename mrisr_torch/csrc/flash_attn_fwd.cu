// Flash-attention forward for Hopper (sm_90a), with a plain C interface
// (built by mrisr_torch/_build.py, loaded with ctypes by
// mrisr_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel mrisr_tpu/ops/flash_attention.py::_flash_kernel,
// launched by _flash_forward: non-causal softmax(scale * Q K^T) V on [B, N, D]
// with an online softmax over K/V tiles, the running max, sum and accumulator
// in fp32, O written in the input dtype and the row logsumexp (natural log)
// in fp32.
//
// What bounds it on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), at the
// heaviest call of the serving chain -- the cross-attention at the 128^2 skip,
// exact profile: B=8, N=M=16384, D=32, bf16:
//   * matrix products: 4*B*N*M*D = 275 GFLOP -> 0.28 ms on the tensor cores;
//   * exponentials: B*N*M = 2.1 G -> about 0.6 ms at the ~3.7 T/s rate of the
//     special-function units.  At D=32 the exponentials, not the tensor
//     cores, set the floor (the TPU kernel was VPU-bound for the same reason);
//   * bytes: ~34 MB -> 10 us.
// With K/V pooled 8x8 (M=256) the call moves ~17 MB and is bound by bytes
// (about 5 us).
//
// Design (simple and right first; wgmma/TMA are later work):
//   * One thread block per (batch, 64-row Q tile).  The TPU carried m/l/acc
//     across a sequential grid axis in VMEM scratch; Hopper blocks run in no
//     order, so the loop over K/V tiles runs inside the block instead.
//   * bf16: 4 warps, 16 Q rows each.  K/V tiles of 64 rows are staged in
//     shared memory (rows padded by 16 bytes, so fragment loads are free of
//     bank conflicts).  S = Q K^T and O += P V run on mma.sync m16n8k16 with
//     fp32 accumulators; m, l and O stay in registers.  The scale is applied
//     in fp32 to S and folded with log2(e), so each probability is one exp2.
//     P is rounded to bf16 for the PV product, and the denominator sums the
//     same rounded values.
//   * fp32: plain FMA (no TF32), 4 threads per Q row, each owning a quarter
//     of D; K/V tiles of 32 rows in shared memory, 16 keys per softmax update.
//   * Ragged N and M: rows past N are computed on zeros and not stored, keys
//     past M are zero-filled and masked to -inf before the softmax.
#include "flash_common.cuh"

namespace {

constexpr int kBlockQ = 64;

template <int D>
__global__ void __launch_bounds__(128)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int N, int M, float scale_log2) {
  constexpr int BK = 64;
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;  // k-steps of the QK^T product
  constexpr int ND = D / 8;   // n-blocks of the output
  constexpr int NS = BK / 8;  // n-blocks of the score tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;
  const uint16_t* Vs16 = reinterpret_cast<const uint16_t*>(Vs);

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBlockQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the 8-row group
  const int tig = lane & 3;  // thread in group
  const __nv_bfloat16* qb = q + (size_t)b * N * D;
  const __nv_bfloat16* kb = k + (size_t)b * M * D;
  const __nv_bfloat16* vb = v + (size_t)b * M * D;

  load_tile_bf16<D, kBlockQ, LD, 128>(Qs, qb, q0, N);
  __syncthreads();

  // A fragments of this warp's 16 Q rows, kept in registers for all tiles.
  uint32_t qa[KD][4];
  const int r0 = warp * 16;
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    const __nv_bfloat16* base = Qs + (r0 + g) * LD + kd * 16 + tig * 2;
    qa[kd][0] = *reinterpret_cast<const uint32_t*>(base);
    qa[kd][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
    qa[kd][2] = *reinterpret_cast<const uint32_t*>(base + 8);
    qa[kd][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
  }

  // Rows g and g+8 of the warp's slice: running max (log2 units), this
  // thread's share of the denominator, and the output accumulator.
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;

  const int n_tiles = (M + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // every warp is done with the previous tile
    load_tile_bf16<D, BK, LD, 128>(Ks, kb, k0, M);
    load_tile_bf16<D, BK, LD, 128>(Vs, vb, k0, M);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        const __nv_bfloat16* kp = Ks + (j * 8 + g) * LD + kd * 16 + tig * 2;
        mma_bf16_16816(s[j], qa[kd], *reinterpret_cast<const uint32_t*>(kp),
                       *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tig * 2 + (e & 1);
        const float val = key < M ? s[j][e] * scale_log2 : -INFINITY;
        s[j][e] = val;
        mx[e >> 1] = fmaxf(mx[e >> 1], val);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // Key k0 is always valid, so m_new is finite and alpha is exp2(-inf)=0
      // on the first tile.
      const float m_new = fmaxf(m_run[r], mx[r]);
      alpha[r] = exp2f(m_run[r] - m_new);
      m_run[r] = m_new;
      l_run[r] *= alpha[r];
    }

    // P in bf16, laid out directly as the A fragments of the PV product.
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const __nv_bfloat162 lo =
          __floats2bfloat162_rn(exp2f(s[j][0] - m_run[0]), exp2f(s[j][1] - m_run[0]));
      const __nv_bfloat162 hi =
          __floats2bfloat162_rn(exp2f(s[j][2] - m_run[1]), exp2f(s[j][3] - m_run[1]));
      const float2 flo = __bfloat1622float2(lo);
      const float2 fhi = __bfloat1622float2(hi);
      l_run[0] += flo.x + flo.y;
      l_run[1] += fhi.x + fhi.y;
      pa[j >> 1][(j & 1) * 2 + 0] = bf162_bits(lo);
      pa[j >> 1][(j & 1) * 2 + 1] = bf162_bits(hi);
    }

#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const int key = kk * 16 + tig * 2;
#pragma unroll
      for (int nd = 0; nd < ND; ++nd) {
        const int col = nd * 8 + g;
        const uint32_t b0 = (uint32_t)Vs16[key * LD + col] |
                            ((uint32_t)Vs16[(key + 1) * LD + col] << 16);
        const uint32_t b1 = (uint32_t)Vs16[(key + 8) * LD + col] |
                            ((uint32_t)Vs16[(key + 9) * LD + col] << 16);
        mma_bf16_16816(acc[nd], pa[kk], b0, b1);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
    l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
  }
  const float inv0 = l_run[0] > 0.f ? 1.f / l_run[0] : 1.f;
  const float inv1 = l_run[1] > 0.f ? 1.f / l_run[1] : 1.f;
  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;
  __nv_bfloat16* ob = o + (size_t)b * N * D;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + tig * 2;
    if (row_a < N) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(acc[nd][0] * inv0, acc[nd][1] * inv0);
    }
    if (row_b < N) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(acc[nd][2] * inv1, acc[nd][3] * inv1);
    }
  }
  if (tig == 0) {
    if (row_a < N) lse[(size_t)b * N + row_a] = m_run[0] * kLn2 + logf(fmaxf(l_run[0], 1e-37f));
    if (row_b < N) lse[(size_t)b * N + row_b] = m_run[1] * kLn2 + logf(fmaxf(l_run[1], 1e-37f));
  }
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int N, int M, float scale_log2) {
  constexpr int BK = 32;     // keys per shared-memory tile
  constexpr int CK = 16;     // keys per softmax update
  constexpr int V4 = D / 16; // float4s of D owned by each of the 4 threads of a row
  extern __shared__ float4 smem_f4[];
  float4* Ks = smem_f4;
  float4* Vs = smem_f4 + BK * (D / 4);

  const int b = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int qrow = blockIdx.x * kBlockQ + row;
  const bool valid = qrow < N;
  // Thread `part` owns the float4s j*4 + part of its row, so the 4 threads of
  // a row read 64 consecutive bytes of a K/V row: no bank conflicts.
  float4 qv[V4], acc[V4];
  const float4* qr = reinterpret_cast<const float4*>(q + ((size_t)b * N + qrow) * D);
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    qv[j] = valid ? qr[j * 4 + part] : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float4* kb = reinterpret_cast<const float4*>(k + (size_t)b * M * D);
  const float4* vb = reinterpret_cast<const float4*>(v + (size_t)b * M * D);

  float m_run = -INFINITY, l_run = 0.f;
  const int n_tiles = (M + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    for (int c = threadIdx.x; c < BK * (D / 4); c += 256) {
      const int r = c / (D / 4);
      const bool in = k0 + r < M;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      Ks[c] = in ? kb[(size_t)k0 * (D / 4) + c] : zero;
      Vs[c] = in ? vb[(size_t)k0 * (D / 4) + c] : zero;
    }
    __syncthreads();

    for (int c0 = 0; c0 < BK; c0 += CK) {
      float sc[CK];
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float4* kr = Ks + (c0 + c) * (D / 4);
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < V4; ++j) {
          const float4 kk = kr[j * 4 + part];
          d = fmaf(qv[j].x, kk.x, d);
          d = fmaf(qv[j].y, kk.y, d);
          d = fmaf(qv[j].z, kk.z, d);
          d = fmaf(qv[j].w, kk.w, d);
        }
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        sc[c] = (k0 + c0 + c < M) ? d * scale_log2 : -INFINITY;
        mx = fmaxf(mx, sc[c]);
      }
      // Chunk 0 of tile 0 holds key 0, so m_new is always finite.
      const float m_new = fmaxf(m_run, mx);
      const float alpha = exp2f(m_run - m_new);
      m_run = m_new;
      l_run *= alpha;
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        acc[j].x *= alpha;
        acc[j].y *= alpha;
        acc[j].z *= alpha;
        acc[j].w *= alpha;
      }
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        const float p = exp2f(sc[c] - m_run);
        l_run += p;
        const float4* vr = Vs + (c0 + c) * (D / 4);
#pragma unroll
        for (int j = 0; j < V4; ++j) {
          const float4 vv = vr[j * 4 + part];
          acc[j].x = fmaf(p, vv.x, acc[j].x);
          acc[j].y = fmaf(p, vv.y, acc[j].y);
          acc[j].z = fmaf(p, vv.z, acc[j].z);
          acc[j].w = fmaf(p, vv.w, acc[j].w);
        }
      }
    }
  }

  if (valid) {
    const float inv = l_run > 0.f ? 1.f / l_run : 1.f;
    float4* orow = reinterpret_cast<float4*>(o + ((size_t)b * N + qrow) * D);
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      orow[j * 4 + part] =
          make_float4(acc[j].x * inv, acc[j].y * inv, acc[j].z * inv, acc[j].w * inv);
    }
    if (part == 0) lse[(size_t)b * N + qrow] = m_run * kLn2 + logf(fmaxf(l_run, 1e-37f));
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                        int N, int M, float scale_log2, cudaStream_t stream) {
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B);
  const size_t smem = (size_t)(kBlockQ + 64 + 64) * (D + 8) * sizeof(__nv_bfloat16);
  const cudaError_t err = allow_smem(flash_fwd_bf16_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_bf16_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), lse, N, M,
      scale_log2);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int N, int M, float scale_log2, cudaStream_t stream) {
  const dim3 grid((N + kBlockQ - 1) / kBlockQ, B);
  const size_t smem = (size_t)2 * 32 * D * sizeof(float);
  const cudaError_t err = allow_smem(flash_fwd_f32_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  flash_fwd_f32_kernel<D><<<grid, 256, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, N, M, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [B,N,D], k and v [B,M,D], o [B,N,D] (all contiguous, same dtype), lse
// [B,N] fp32.  is_bf16 selects bf16 (1) or fp32 (0); D is 32, 64 or 128.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int mrisr_flash_attn_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int N, int M, int D, int is_bf16,
                                    float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const float sl2 = scale * kLog2e;
  float* l = static_cast<float*>(lse);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    switch (D) {
      case 32: return (int)launch_bf16<32>(q, k, v, o, l, B, N, M, sl2, st);
      case 64: return (int)launch_bf16<64>(q, k, v, o, l, B, N, M, sl2, st);
      case 128: return (int)launch_bf16<128>(q, k, v, o, l, B, N, M, sl2, st);
    }
  } else {
    switch (D) {
      case 32: return (int)launch_f32<32>(q, k, v, o, l, B, N, M, sl2, st);
      case 64: return (int)launch_f32<64>(q, k, v, o, l, B, N, M, sl2, st);
      case 128: return (int)launch_f32<128>(q, k, v, o, l, B, N, M, sl2, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
