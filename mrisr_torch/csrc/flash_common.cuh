// Helpers shared by the flash-attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): the log constants and the opt-in for more than 48 KB of
// dynamic shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Kernels above 48 KB of dynamic shared memory must opt in first.  The launch
// sites call this once per kernel (a static), so a launch under CUDA graph
// capture sets no function attribute.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace
