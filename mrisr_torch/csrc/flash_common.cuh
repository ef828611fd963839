// Helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the bf16 tensor-core instruction, tile staging into
// shared memory, and the opt-in for more than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// D += A B with A 16x16 (row major), B 16x8 (column major), bf16 inputs and
// fp32 accumulators.  With g = lane / 4 and tig = lane % 4 a thread holds
//   A: a0 (row g, cols 2tig..+1), a1 (row g+8, same cols), a2/a3 the same
//      rows at cols 2tig+8..+9;
//   B: b0 (k 2tig..+1, n g), b1 (k 2tig+8..+9, n g);
//   C: c0,c1 (row g, cols 2tig..+1), c2,c3 (row g+8, same cols).
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4], uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy rows [row0, row0 + ROWS) of a [rows_total, D] bf16 matrix into shared
// memory with row stride LD, zero-filling rows past rows_total.
template <int D, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               int row0, int rows_total) {
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  for (int c = threadIdx.x; c < ROWS * kChunksPerRow; c += THREADS) {
    const int r = c / kChunksPerRow;
    const int cc = c % kChunksPerRow;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < rows_total) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + cc * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + cc * 8) = val;
  }
}

// Kernels above 48 KB of dynamic shared memory must opt in first.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
