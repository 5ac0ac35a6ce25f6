// Shared helpers for the merge kernels: widening loads and the launch
// geometry. Every kernel reads its stacked input as fp32 or bf16 and
// widens in registers (bf16 -> fp32 is exact: the 16 bits are the top
// half of the fp32 pattern), so a bf16 batch never has an fp32 copy in
// device memory.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace merge {

__device__ __forceinline__ float widen(float v) { return v; }

__device__ __forceinline__ float widen(uint16_t bits) {
  return __uint_as_float(static_cast<uint32_t>(bits) << 16);
}

// NaN-propagating max, as jnp.max: fmaxf would drop a NaN operand.
__device__ __forceinline__ float nanmax(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// jnp.sign: +1 / -1, and the argument itself for +0, -0 and NaN.
__device__ __forceinline__ float sign_of(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : v);
}

// VEC adjacent columns of one row, widened to fp32: fp32 rows in 16-byte
// float4 loads, bf16 rows in 16-byte loads of 8 values each.
template <int VEC>
__device__ __forceinline__ void load_row(const float* p, float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; j += 4) {
    float4 q = *reinterpret_cast<const float4*>(p + j);
    v[j] = q.x; v[j + 1] = q.y; v[j + 2] = q.z; v[j + 3] = q.w;
  }
}

template <int VEC>
__device__ __forceinline__ void load_row(const uint16_t* p, float (&v)[VEC]) {
#pragma unroll
  for (int j = 0; j < VEC; j += 8) {
    uint4 q = *reinterpret_cast<const uint4*>(p + j);
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      v[j + 2 * h] = __uint_as_float(w[h] << 16);
      v[j + 2 * h + 1] = __uint_as_float(w[h] & 0xFFFF0000u);
    }
  }
}

// The two steps of the fused TIES arithmetic (repro/kernels/ties.py
// `ties_tile`) that touch one row of one column: `trim` keeps tau = x - b
// where |tau| >= th (times 0 elsewhere, so a NaN stays NaN); `agree` adds
// a trimmed value that has the elected sign, and is not zero, to the
// column's count and sum. B5 (csrc/histogram.cu) and B7 (csrc/ties.cu)
// both run them, every sum over k in index order from zero.
__device__ __forceinline__ float trim(float x, float b, float th) {
  const float t = __fsub_rn(x, b);
  return __fmul_rn(t, fabsf(t) >= th ? 1.f : 0.f);
}

__device__ __forceinline__ void agree(float tr, float elected, float& cnt,
                                      float& acc) {
  const float ag = (sign_of(tr) == elected && tr != 0.f) ? 1.f : 0.f;
  cnt = __fadd_rn(cnt, ag);
  acc = __fadd_rn(acc, __fmul_rn(tr, ag));
}

// Grid for a grid-stride loop over `items` with `threads` per block:
// enough blocks to cover the work, capped so huge batches still launch.
inline unsigned int grid_for(long long items, int threads) {
  long long blocks = (items + threads - 1) / threads;
  const long long cap = 132LL * 64;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  return static_cast<unsigned int>(blocks);
}

}  // namespace merge

extern "C" const char* merge_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
