// Helpers B9's sources share (csrc/flash_attention.cu, the forward, and
// csrc/flash_attention_bwd.cuh, the gradient): rounding to bf16 as
// torch rounds, typed stores, and the dynamic shared-memory opt-in.
#pragma once

#include "common.cuh"

namespace {

// fp32 -> bf16 bits, round to nearest even (as torch's .to(bfloat16))
__device__ __forceinline__ uint16_t to_bf16(float f) {
  uint32_t u = __float_as_uint(f);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return 0x7FC0;
  u += 0x7FFFu + ((u >> 16) & 1u);
  return static_cast<uint16_t>(u >> 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(uint16_t* p, float v) {
  *p = to_bf16(v);
}

// raise the dynamic shared-memory limit of `kern` to `bytes`, once per
// device for each instance (the decode step launches it every layer)
template <typename K>
cudaError_t allow_smem(K kern, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

}  // namespace
