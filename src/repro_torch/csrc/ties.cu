// B7 ties_leaf: replaces repro/kernels/ties.py `ties_pallas` (`_ties_kernel`
// -> `ties_tile`), the per-leaf fused TIES of `ops.ties_merge(
// trim_method="quantile")`: trim every contribution at its own threshold
// (one per row, the leaf's exact |tau| quantile), elect the sign of the
// k-sum, mean of the agreeing entries.
//
// Bound: device-memory bytes. The [k, np] stack is read once (a few flops
// per byte), the fp32 base read and the fp32 output written once.
// Design: one thread per column in a grid-stride loop, neighbouring
// threads on neighbouring columns so every row read is coalesced; rows are
// read as fp32 or bf16 and widened in registers (exact), so a bf16 leaf is
// never copied to fp32. The column arithmetic is `merge::ties_column`, the
// same function B5 runs with per-tile thresholds; the k thresholds are one
// broadcast address per row. Rounded intrinsics and --fmad=false make the
// kernel bitwise equal to its plain version (`kernels/ties.py`).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T, int KMAX>
__global__ void ties_leaf_kernel(const T* __restrict__ x,
                                 const float* __restrict__ base,
                                 const float* __restrict__ thr,
                                 float* __restrict__ out, int k,
                                 long long np) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < np; c += stride)
    out[c] = merge::ties_column<T, KMAX>(x, np, c, k, base[c], thr);
}

template <typename T>
int ties_leaf_launch(const void* x, const void* base, const void* thr,
                     void* out, int k, long long np, cudaStream_t stream) {
  const unsigned int grid = merge::grid_for(np, kThreads);
  const T* xp = static_cast<const T*>(x);
  const float* bp = static_cast<const float*>(base);
  const float* tp = static_cast<const float*>(thr);
  float* op = static_cast<float*>(out);
  if (k <= 4)
    ties_leaf_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xp, bp, tp, op, k,
                                                         np);
  else if (k <= 16)
    ties_leaf_kernel<T, 16><<<grid, kThreads, 0, stream>>>(xp, bp, tp, op, k,
                                                          np);
  else
    ties_leaf_kernel<T, 0><<<grid, kThreads, 0, stream>>>(xp, bp, tp, op, k,
                                                         np);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [k, np] fp32 or bf16 (raw bits), base: [np] fp32, thr: [k] fp32;
// the Python wrapper checks shapes, dtypes and devices.
extern "C" int ties_leaf_f32(const void* x, const void* base, const void* thr,
                             void* out, int k, long long np, void* stream) {
  return ties_leaf_launch<float>(x, base, thr, out, k, np,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int ties_leaf_bf16(const void* x, const void* base,
                              const void* thr, void* out, int k, long long np,
                              void* stream) {
  return ties_leaf_launch<uint16_t>(x, base, thr, out, k, np,
                                    static_cast<cudaStream_t>(stream));
}
