// Flash-attention backward for Hopper (sm_90a), with a plain C interface
// (built by mrisr_torch/_build.py, loaded with ctypes by
// mrisr_torch/ops/flash_attention.py).
//
// Replaces the TPU kernels mrisr_tpu/ops/flash_attention.py::
// _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel, launched by _flash_backward.
// With lse the forward's row logsumexp and delta = rowsum(dO * O) (computed by
// the caller, as in the reference):
//   P  = exp(scale * Q K^T - lse)          [N, M], recomputed, never stored
//   dP = dO V^T
//   dS = P * (dP - delta)
//   dQ = scale * dS K        (kernel 1, summed over K/V tiles)
//   dV = P^T dO              (kernel 2, summed over Q tiles)
//   dK = scale * dS^T Q      (kernel 2)
// Sums are fp32; dQ, dK, dV are written once, in the input dtype.
//
// What bounds them on an H100 SXM (989 TFLOP/s bf16 dense, 67 TFLOP/s fp32,
// 3.35 TB/s), at the heaviest call of a training step -- the cross-attention
// at the 128^2 skip: B=8, N=M=16384, D=32.  The dQ kernel does three products
// (6 B N M D = 0.41 TFLOP: 0.42 ms bf16, 6.2 ms fp32), the dK/dV kernel four
// (8 B N M D = 0.55 TFLOP: 0.56 ms bf16, 8.2 ms fp32); each recomputes
// B N M = 2.1 G exponentials (about 0.6 ms at ~3.7 T/s), which at D=32 is
// the higher floor in bf16.  Bytes are ~50 MB a kernel (15 us).
//
// Design (simple and right first; wgmma, TMA and a fused one-pass backward
// are later work):
//   * The TPU kernels carried their accumulators in VMEM scratch across a
//     sequential grid axis.  Hopper blocks run in no order, so the reduction
//     loop runs inside the block: the dQ kernel owns 64 Q rows and loops over
//     K/V tiles, the dK/dV kernel owns 64 K/V rows and loops over Q tiles.
//     No atomics: a result does not depend on the order of the blocks.
//   * bf16: 4 warps, 16 owned rows each; mma.sync m16n8k16 with fp32
//     accumulators, which stay in registers.  The dK/dV kernel works on the
//     transposed tile (S^T = K Q^T), so that P^T and dS^T come out of the
//     accumulators already laid out as the A operand of the next product.
//     The tile walked over has 64 rows (32 at D=128, to bound registers).
//     The reference casts dO and V to fp32 for dP and keeps P^T in fp32 for
//     dV; here all products take bf16 operands (dO, V as given; P and dS
//     rounded to bf16, 2^-9 relative) with fp32 accumulation.  The effect is
//     a relative error of a few 1e-3 in each gradient, the same order as the
//     bf16 rounding of the outputs themselves.
//   * P is recomputed against the lse of this package's forward kernel, with
//     the same folding of scale * log2(e) into one exp2.  In bf16 that
//     forward sums bf16-rounded p into its denominator, so sum_j P_ij here is
//     1 only to ~2^-9: the reference has the same mismatch and accepts it at
//     bf16 tolerance.  In fp32 the pair is consistent to rounding.
//   * fp32: plain FMA (no TF32), 4 threads per owned row, each holding a
//     quarter of D; the tile walked over has 32 rows in shared memory.
//   * Ragged N and M: tiles are zero-filled past the end and rows past the
//     end are not stored.  bf16: keys past M get probability 0 in the dQ
//     kernel, queries past N get lse = +inf (probability 0) in the dK/dV
//     kernel.  fp32: the inner loop stops at the last valid row of the tile.
#include "flash_common.cuh"

namespace {

constexpr int kBlockRows = 64;  // rows owned by a block (Q rows for dQ, K/V rows for dK/dV)

// A fragment (16 rows x 16 columns at column kd*16) of a shared-memory tile.
template <int LD>
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const __nv_bfloat16* tile, int row0,
                                            int kd, int g, int tig) {
  const __nv_bfloat16* base = tile + (row0 + g) * LD + kd * 16 + tig * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(base);
  a[1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(base + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
}

// acc[ND] (16 x D) += A (16 x 16*KK, as packed fragments) * T, where T is a
// [16*KK, D] row-major shared-memory tile: its B fragments pair two
// consecutive rows of one column, gathered with 16-bit loads.
template <int ND, int KK, int LD>
__device__ __forceinline__ void mma_a_tile(float acc[][4], uint32_t a[][4],
                                           const uint16_t* tile16, int g, int tig) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int r = kk * 16 + tig * 2;
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      const int col = nd * 8 + g;
      const uint32_t b0 =
          (uint32_t)tile16[r * LD + col] | ((uint32_t)tile16[(r + 1) * LD + col] << 16);
      const uint32_t b1 =
          (uint32_t)tile16[(r + 8) * LD + col] | ((uint32_t)tile16[(r + 9) * LD + col] << 16);
      mma_bf16_16816(acc[nd], a[kk], b0, b1);
    }
  }
}

// Pack a 16 x (8*NS) fp32 accumulator tile into bf16 A fragments.
template <int NS>
__device__ __forceinline__ void pack_a(uint32_t a[][4], float s[][4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    a[j >> 1][(j & 1) * 2 + 0] = bf162_bits(__floats2bfloat162_rn(s[j][0], s[j][1]));
    a[j >> 1][(j & 1) * 2 + 1] = bf162_bits(__floats2bfloat162_rn(s[j][2], s[j][3]));
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                             const __nv_bfloat16* __restrict__ v,
                             const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                             const float* __restrict__ delta, __nv_bfloat16* __restrict__ dq, int N,
                             int M, float scale_log2, float scale) {
  constexpr int BK = D == 128 ? 32 : 64;
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NS = BK / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dOs = Qs + kBlockRows * LD;
  __nv_bfloat16* Ks = dOs + kBlockRows * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r0 = warp * 16;
  const __nv_bfloat16* kb = k + (size_t)b * M * D;
  const __nv_bfloat16* vb = v + (size_t)b * M * D;

  load_tile_bf16<D, kBlockRows, LD, 128>(Qs, q + (size_t)b * N * D, q0, N);
  load_tile_bf16<D, kBlockRows, LD, 128>(dOs, dout + (size_t)b * N * D, q0, N);

  // Rows g and g+8 of the warp's slice.
  const int row_a = q0 + r0 + g;
  const int row_b = row_a + 8;
  float lse2[2], dl[2];
  lse2[0] = row_a < N ? lse[(size_t)b * N + row_a] * kLog2e : 0.f;
  lse2[1] = row_b < N ? lse[(size_t)b * N + row_b] * kLog2e : 0.f;
  dl[0] = row_a < N ? delta[(size_t)b * N + row_a] : 0.f;
  dl[1] = row_b < N ? delta[(size_t)b * N + row_b] : 0.f;

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

    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t qa[4], da[4];
      load_a_frag<LD>(qa, Qs, r0, kd, g, tig);
      load_a_frag<LD>(da, dOs, r0, kd, g, tig);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int off = (j * 8 + g) * LD + kd * 16 + tig * 2;
        mma_bf16_16816(s[j], qa, *reinterpret_cast<const uint32_t*>(Ks + off),
                       *reinterpret_cast<const uint32_t*>(Ks + off + 8));
        mma_bf16_16816(dp[j], da, *reinterpret_cast<const uint32_t*>(Vs + off),
                       *reinterpret_cast<const uint32_t*>(Vs + off + 8));
      }
    }

    // dS, in place of S.
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + tig * 2 + (e & 1);
        const int r = e >> 1;
        const float p = key < M ? exp2f(s[j][e] * scale_log2 - lse2[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]);
      }
    }
    uint32_t dsa[BK / 16][4];
    pack_a<NS>(dsa, s);
    mma_a_tile<ND, BK / 16, LD>(acc, dsa, reinterpret_cast<const uint16_t*>(Ks), g, tig);
  }

  __nv_bfloat16* ob = dq + (size_t)b * N * D;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + tig * 2;
    if (row_a < N) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(acc[nd][0] * scale, acc[nd][1] * scale);
    }
    if (row_b < N) {
      *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(acc[nd][2] * scale, acc[nd][3] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    flash_bwd_dkv_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                              const float* __restrict__ delta, __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int N, int M, float scale_log2,
                              float scale) {
  constexpr int BQ = D == 128 ? 32 : 64;
  constexpr int LD = D + 8;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NS = BQ / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + kBlockRows * LD;
  __nv_bfloat16* Qs = Vs + kBlockRows * LD;
  __nv_bfloat16* dOs = Qs + BQ * LD;
  float* lse2s = reinterpret_cast<float*>(dOs + BQ * LD);
  float* dls = lse2s + BQ;

  const int b = blockIdx.y;
  const int k0 = blockIdx.x * kBlockRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r0 = warp * 16;
  const __nv_bfloat16* qb = q + (size_t)b * N * D;
  const __nv_bfloat16* dob = dout + (size_t)b * N * D;

  load_tile_bf16<D, kBlockRows, LD, 128>(Ks, k + (size_t)b * M * D, k0, M);
  load_tile_bf16<D, kBlockRows, LD, 128>(Vs, v + (size_t)b * M * D, k0, M);

  float dka[ND][4], dva[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    dka[nd][0] = dka[nd][1] = dka[nd][2] = dka[nd][3] = 0.f;
    dva[nd][0] = dva[nd][1] = dva[nd][2] = dva[nd][3] = 0.f;
  }

  const int n_tiles = (N + BQ - 1) / BQ;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // every warp is done with the previous tile
    load_tile_bf16<D, BQ, LD, 128>(Qs, qb, q0, N);
    load_tile_bf16<D, BQ, LD, 128>(dOs, dob, q0, N);
    if (threadIdx.x < BQ) {
      const int row = q0 + threadIdx.x;
      // +inf gives probability 0 to queries past N.
      lse2s[threadIdx.x] = row < N ? lse[(size_t)b * N + row] * kLog2e : INFINITY;
      dls[threadIdx.x] = row < N ? delta[(size_t)b * N + row] : 0.f;
    }
    __syncthreads();

    // Transposed tiles: rows are this warp's 16 keys, columns the BQ queries.
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
      dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
    }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t ka[4], va[4];
      load_a_frag<LD>(ka, Ks, r0, kd, g, tig);
      load_a_frag<LD>(va, Vs, r0, kd, g, tig);
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const int off = (j * 8 + g) * LD + kd * 16 + tig * 2;
        mma_bf16_16816(st[j], ka, *reinterpret_cast<const uint32_t*>(Qs + off),
                       *reinterpret_cast<const uint32_t*>(Qs + off + 8));
        mma_bf16_16816(dpt[j], va, *reinterpret_cast<const uint32_t*>(dOs + off),
                       *reinterpret_cast<const uint32_t*>(dOs + off + 8));
      }
    }

    // P^T in place of S^T, dS^T in place of dP^T.
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = j * 8 + tig * 2 + (e & 1);
        const float p = exp2f(st[j][e] * scale_log2 - lse2s[qc]);
        st[j][e] = p;
        dpt[j][e] = p * (dpt[j][e] - dls[qc]);
      }
    }
    uint32_t pa[BQ / 16][4], dsa[BQ / 16][4];
    pack_a<NS>(pa, st);
    pack_a<NS>(dsa, dpt);
    mma_a_tile<ND, BQ / 16, LD>(dva, pa, reinterpret_cast<const uint16_t*>(dOs), g, tig);
    mma_a_tile<ND, BQ / 16, LD>(dka, dsa, reinterpret_cast<const uint16_t*>(Qs), g, tig);
  }

  const int row_a = k0 + r0 + g;
  const int row_b = row_a + 8;
  __nv_bfloat16* dkb = dk + (size_t)b * M * D;
  __nv_bfloat16* dvb = dv + (size_t)b * M * D;
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    const int col = nd * 8 + tig * 2;
    if (row_a < M) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(dka[nd][0] * scale, dka[nd][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(dva[nd][0], dva[nd][1]);
    }
    if (row_b < M) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(dka[nd][2] * scale, dka[nd][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvb + (size_t)row_b * D + col) =
          __floats2bfloat162_rn(dva[nd][2], dva[nd][3]);
    }
  }
}

// fp32 kernels: thread `part` of a row owns the float4s j*4 + part of it, so
// the 4 threads of a row read 64 consecutive bytes of a shared-memory row.
constexpr int kTileF32 = 32;  // rows of the tile walked over

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float4& y, float a, float4 x) {
  y.x = fmaf(a, x.x, y.x);
  y.y = fmaf(a, x.y, y.y);
  y.z = fmaf(a, x.z, y.z);
  y.w = fmaf(a, x.w, y.w);
}

__device__ __forceinline__ float sum_over_row_threads(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Stage rows [row0, row0 + kTileF32) of two [rows_total, D] fp32 matrices,
// zero-filling rows past rows_total.
template <int D>
__device__ __forceinline__ void load_tiles_f32(float4* dst_a, float4* dst_b, const float4* src_a,
                                               const float4* src_b, int row0, int rows_total) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c = threadIdx.x; c < kTileF32 * (D / 4); c += 256) {
    const bool in = row0 + c / (D / 4) < rows_total;
    dst_a[c] = in ? src_a[(size_t)row0 * (D / 4) + c] : zero;
    dst_b[c] = in ? src_b[(size_t)row0 * (D / 4) + c] : zero;
  }
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ dout,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, int N, int M, float scale_log2, float scale) {
  constexpr int V4 = D / 16;  // float4s of D owned by each of the 4 threads of a row
  extern __shared__ float4 smem_f4[];
  float4* Ks = smem_f4;
  float4* Vs = smem_f4 + kTileF32 * (D / 4);

  const int b = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int qrow = blockIdx.x * kBlockRows + row;
  const bool valid = qrow < N;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 qv[V4], dov[V4], acc[V4];
  const float4* qr = reinterpret_cast<const float4*>(q + ((size_t)b * N + qrow) * D);
  const float4* dor = reinterpret_cast<const float4*>(dout + ((size_t)b * N + qrow) * D);
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    qv[j] = valid ? qr[j * 4 + part] : zero;
    dov[j] = valid ? dor[j * 4 + part] : zero;
    acc[j] = zero;
  }
  const float lse2 = valid ? lse[(size_t)b * N + qrow] * kLog2e : 0.f;
  const float dl = valid ? delta[(size_t)b * N + qrow] : 0.f;
  const float4* kb = reinterpret_cast<const float4*>(k + (size_t)b * M * D);
  const float4* vb = reinterpret_cast<const float4*>(v + (size_t)b * M * D);

  const int n_tiles = (M + kTileF32 - 1) / kTileF32;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTileF32;
    __syncthreads();
    load_tiles_f32<D>(Ks, Vs, kb, vb, k0, M);
    __syncthreads();
    const int n_keys = min(kTileF32, M - k0);
    for (int c = 0; c < n_keys; ++c) {
      const float4* kr = Ks + c * (D / 4);
      const float4* vr = Vs + c * (D / 4);
      float4 kk[V4];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        kk[j] = kr[j * 4 + part];
        s = dot4(qv[j], kk[j], s);
        dp = dot4(dov[j], vr[j * 4 + part], dp);
      }
      s = sum_over_row_threads(s);
      dp = sum_over_row_threads(dp);
      const float ds = exp2f(s * scale_log2 - lse2) * (dp - dl);
#pragma unroll
      for (int j = 0; j < V4; ++j) axpy4(acc[j], ds, kk[j]);
    }
  }

  if (valid) {
    float4* orow = reinterpret_cast<float4*>(dq + ((size_t)b * N + qrow) * D);
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      orow[j * 4 + part] =
          make_float4(acc[j].x * scale, acc[j].y * scale, acc[j].z * scale, acc[j].w * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dout,
                             const float* __restrict__ lse, const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv, int N, int M,
                             float scale_log2, float scale) {
  constexpr int V4 = D / 16;
  extern __shared__ float4 smem_f4[];
  float4* Qs = smem_f4;
  float4* dOs = smem_f4 + kTileF32 * (D / 4);
  float* lse2s = reinterpret_cast<float*>(dOs + kTileF32 * (D / 4));
  float* dls = lse2s + kTileF32;

  const int b = blockIdx.y;
  const int row = threadIdx.x >> 2;
  const int part = threadIdx.x & 3;
  const int krow = blockIdx.x * kBlockRows + row;
  const bool valid = krow < M;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 kv[V4], vv[V4], dka[V4], dva[V4];
  const float4* kr = reinterpret_cast<const float4*>(k + ((size_t)b * M + krow) * D);
  const float4* vr = reinterpret_cast<const float4*>(v + ((size_t)b * M + krow) * D);
#pragma unroll
  for (int j = 0; j < V4; ++j) {
    kv[j] = valid ? kr[j * 4 + part] : zero;
    vv[j] = valid ? vr[j * 4 + part] : zero;
    dka[j] = zero;
    dva[j] = zero;
  }
  const float4* qb = reinterpret_cast<const float4*>(q + (size_t)b * N * D);
  const float4* dob = reinterpret_cast<const float4*>(dout + (size_t)b * N * D);

  const int n_tiles = (N + kTileF32 - 1) / kTileF32;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kTileF32;
    __syncthreads();
    load_tiles_f32<D>(Qs, dOs, qb, dob, q0, N);
    if (threadIdx.x < kTileF32) {
      const int r = q0 + threadIdx.x;
      lse2s[threadIdx.x] = r < N ? lse[(size_t)b * N + r] * kLog2e : 0.f;
      dls[threadIdx.x] = r < N ? delta[(size_t)b * N + r] : 0.f;
    }
    __syncthreads();
    const int n_rows = min(kTileF32, N - q0);
    for (int c = 0; c < n_rows; ++c) {
      const float4* qr = Qs + c * (D / 4);
      const float4* dor = dOs + c * (D / 4);
      float4 qq[V4], dd[V4];
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        qq[j] = qr[j * 4 + part];
        dd[j] = dor[j * 4 + part];
        s = dot4(kv[j], qq[j], s);
        dp = dot4(vv[j], dd[j], dp);
      }
      s = sum_over_row_threads(s);
      dp = sum_over_row_threads(dp);
      const float p = exp2f(s * scale_log2 - lse2s[c]);
      const float ds = p * (dp - dls[c]);
#pragma unroll
      for (int j = 0; j < V4; ++j) {
        axpy4(dva[j], p, dd[j]);
        axpy4(dka[j], ds, qq[j]);
      }
    }
  }

  if (valid) {
    float4* dkr = reinterpret_cast<float4*>(dk + ((size_t)b * M + krow) * D);
    float4* dvr = reinterpret_cast<float4*>(dv + ((size_t)b * M + krow) * D);
#pragma unroll
    for (int j = 0; j < V4; ++j) {
      dkr[j * 4 + part] =
          make_float4(dka[j].x * scale, dka[j].y * scale, dka[j].z * scale, dka[j].w * scale);
      dvr[j * 4 + part] = dva[j];
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  int B, N, M;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, void* dq, bool bf16) {
  const dim3 grid((a.N + kBlockRows - 1) / kBlockRows, a.B);
  const float sl2 = a.scale * kLog2e;
  if (bf16) {
    constexpr int BK = D == 128 ? 32 : 64;
    const size_t smem = (size_t)(2 * kBlockRows + 2 * BK) * (D + 8) * sizeof(__nv_bfloat16);
    const cudaError_t err = allow_smem(flash_bwd_dq_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    using T = __nv_bfloat16;
    flash_bwd_dq_bf16_kernel<D><<<grid, 128, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dq), a.N, a.M, sl2, a.scale);
  } else {
    const size_t smem = (size_t)2 * kTileF32 * D * sizeof(float);
    const cudaError_t err = allow_smem(flash_bwd_dq_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    using T = float;
    flash_bwd_dq_f32_kernel<D><<<grid, 256, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dq), a.N, a.M, sl2, a.scale);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv, bool bf16) {
  const dim3 grid((a.M + kBlockRows - 1) / kBlockRows, a.B);
  const float sl2 = a.scale * kLog2e;
  if (bf16) {
    constexpr int BQ = D == 128 ? 32 : 64;
    const size_t smem = (size_t)(2 * kBlockRows + 2 * BQ) * (D + 8) * sizeof(__nv_bfloat16) +
                        2 * BQ * sizeof(float);
    const cudaError_t err = allow_smem(flash_bwd_dkv_bf16_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    using T = __nv_bfloat16;
    flash_bwd_dkv_bf16_kernel<D><<<grid, 128, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv),
        a.N, a.M, sl2, a.scale);
  } else {
    const size_t smem = (size_t)2 * kTileF32 * D * sizeof(float) + 2 * kTileF32 * sizeof(float);
    const cudaError_t err = allow_smem(flash_bwd_dkv_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    using T = float;
    flash_bwd_dkv_f32_kernel<D><<<grid, 256, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), a.lse, a.delta, static_cast<T*>(dk), static_cast<T*>(dv),
        a.N, a.M, sl2, a.scale);
  }
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq [B,N,D]; k, v, dk, dv [B,M,D] (all contiguous, same dtype);
// lse, delta [B,N] fp32.  is_bf16 selects bf16 (1) or fp32 (0); D is 32, 64
// or 128.  Each returns the cudaError_t of its launch (0 on success).
extern "C" int mrisr_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                       const void* dout, const void* lse, const void* delta,
                                       void* dq, int B, int N, int M, int D, int is_bf16,
                                       float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, N, M, scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_dq<32>(a, dq, is_bf16 != 0);
    case 64: return (int)launch_dq<64>(a, dq, is_bf16 != 0);
    case 128: return (int)launch_dq<128>(a, dq, is_bf16 != 0);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int mrisr_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dk, void* dv, int B, int N, int M, int D,
                                        int is_bf16, float scale, void* stream) {
  if (B <= 0 || N <= 0 || M <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, dout, static_cast<const float*>(lse), static_cast<const float*>(delta),
               B, N, M, scale, static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return (int)launch_dkv<32>(a, dk, dv, is_bf16 != 0);
    case 64: return (int)launch_dkv<64>(a, dk, dv, is_bf16 != 0);
    case 128: return (int)launch_dkv<128>(a, dk, dv, is_bf16 != 0);
  }
  return (int)cudaErrorInvalidValue;
}
