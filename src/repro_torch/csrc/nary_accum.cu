// B1 nary_accum: out[c] = base[c] + sum_i w[i] * (x[i, c] - base[c]).
//
// Replaces the TPU kernel `repro/kernels/nary_accum.py`
// (`nary_accum_pallas` / `_nary_kernel`), which the merge engine's
// linear-family batches reach through `_nary_pallas_batch`.
//
// Bound: device-memory bytes. Each element of the [k, Np] stack is read
// once, the base once and the output written once, with 3 flops per
// stacked element: far below the H100's ~20 flops per byte balance point
// for fp32 outside the tensor cores.
// Design: one thread owns VEC adjacent columns (4 fp32 or 8 bf16 = one
// 16-byte load per row), loops over the k rows in index order and keeps
// the fp32 accumulator in registers. bf16 rows stay bf16 in memory and
// widen in registers. The rounded intrinsics (__fsub_rn, __fmul_rn,
// __fadd_rn), together with --fmad=false, pin the op sequence so the
// result is bitwise the plain version's (`kernels/nary_accum.py`).
#include "common.cuh"

namespace {

template <typename T, int VEC>
__global__ void nary_accum_kernel(const T* __restrict__ x,
                                  const float* __restrict__ base,
                                  const float* __restrict__ w,
                                  float* __restrict__ out, int k,
                                  long long np) {
  const long long nvec = np / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < nvec; v += stride) {
    const long long c = v * VEC;
    float b[VEC], acc[VEC], xv[VEC];
    merge::load_row<VEC>(base + c, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int i = 0; i < k; ++i) {
      merge::load_row<VEC>(x + static_cast<long long>(i) * np + c, xv);
      const float wi = w[i];
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[j] = __fadd_rn(acc[j], __fmul_rn(wi, __fsub_rn(xv[j], b[j])));
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

template <typename T, int VEC>
int launch(const void* x, const float* base, const float* w, float* out,
           int k, long long np, cudaStream_t stream) {
  const int threads = 256;
  nary_accum_kernel<T, VEC>
      <<<merge::grid_for(np / VEC, threads), threads, 0, stream>>>(
          static_cast<const T*>(x), base, w, out, k, np);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `np` must be a multiple of 8 and every pointer 16-byte aligned (the
// Python wrapper checks both).
extern "C" int nary_accum_f32(const void* x, const void* base, const void* w,
                              void* out, int k, long long np, void* stream) {
  return launch<float, 4>(x, static_cast<const float*>(base),
                          static_cast<const float*>(w),
                          static_cast<float*>(out), k, np,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int nary_accum_bf16(const void* x, const void* base, const void* w,
                               void* out, int k, long long np, void* stream) {
  return launch<uint16_t, 8>(x, static_cast<const float*>(base),
                             static_cast<const float*>(w),
                             static_cast<float*>(out), k, np,
                             static_cast<cudaStream_t>(stream));
}
