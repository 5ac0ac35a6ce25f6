// B2 quant_nary: int8 merge-on-arrival.
//   x[i, c]  = float(q[i, c]) * scale[tile(c), i]      (decompress_tree's op)
//   out[c]   = base[c] + sum_i w[i] * (x[i, c] - base[c])
//
// Replaces the TPU kernel `repro/kernels/quant.py` (`quant_nary_pallas` /
// `_quant_nary_kernel`), which the merge engine reaches for linear-family
// groups whose every slice arrived as an int8 payload (`_kernel_batch`).
//
// Bound: device-memory bytes. One byte per stacked element is read, the
// fp32 base once and the fp32 output written once, at 4 flops per stacked
// element. The dequantized stack never exists in device memory: each
// thread widens its int8 values in registers.
// Design: one thread owns 16 adjacent columns (one 16-byte load per row),
// all in one `block`-wide tile, so one scale per row serves all 16; it
// loops over the k rows in index order with the fp32 accumulator in
// registers. __fmul_rn / __fsub_rn / __fadd_rn with --fmad=false pin the
// op sequence of the plain version (`kernels/quant.py`), so the two agree
// bitwise.
#include "common.cuh"

namespace {

constexpr int VEC = 16;

__global__ void quant_nary_kernel(const int8_t* __restrict__ q,
                                  const float* __restrict__ base,
                                  const float* __restrict__ scale_meta,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, int k,
                                  long long np, int block) {
  const long long nvec = np / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < nvec; v += stride) {
    const long long c = v * VEC;
    const float* srow = scale_meta + (c / block) * k;
    float b[VEC], acc[VEC];
    merge::load_row<VEC>(base + c, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int i = 0; i < k; ++i) {
      const int4 raw =
          *reinterpret_cast<const int4*>(q + static_cast<long long>(i) * np + c);
      const int8_t* qv = reinterpret_cast<const int8_t*>(&raw);
      const float s = srow[i], wi = w[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float x = __fmul_rn(static_cast<float>(qv[j]), s);
        acc[j] = __fadd_rn(acc[j], __fmul_rn(wi, __fsub_rn(x, b[j])));
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      float4 o;
      o.x = __fadd_rn(b[j], acc[j]);
      o.y = __fadd_rn(b[j + 1], acc[j + 1]);
      o.z = __fadd_rn(b[j + 2], acc[j + 2]);
      o.w = __fadd_rn(b[j + 3], acc[j + 3]);
      *reinterpret_cast<float4*>(out + c + j) = o;
    }
  }
}

}  // namespace

// `np` and `block` must be multiples of 16 and every pointer 16-byte
// aligned (the Python wrapper checks all three).
extern "C" int quant_nary(const void* q, const void* base,
                          const void* scale_meta, const void* w, void* out,
                          int k, long long np, int block, void* stream) {
  const int threads = 256;
  quant_nary_kernel<<<merge::grid_for(np / VEC, threads), threads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(base),
      static_cast<const float*>(scale_meta), static_cast<const float*>(w),
      static_cast<float*>(out), k, np, block);
  return static_cast<int>(cudaGetLastError());
}
