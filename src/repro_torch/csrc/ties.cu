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
// never copied to fp32. The column arithmetic is `ties_column`, built
// from the `trim` and `agree` steps B5 runs with per-tile thresholds; the
// k thresholds are one broadcast address per row.
// Rounded intrinsics and --fmad=false make the kernel bitwise equal to its
// plain version (`kernels/ties.py`).
#include "common.cuh"

namespace {

using merge::agree;
using merge::sign_of;
using merge::trim;
using merge::widen;

constexpr int kThreads = 256;

// B7's column: trim at th[i], elect the sign of the k-sum, mean of the
// agreeing entries, for one column c of a [k, np] stack. KMAX > 0: the k
// trimmed values stay in registers (k <= KMAX, unrolled so every index is
// a constant); KMAX == 0: any k, the second pass re-reads the column.
template <typename T, int KMAX>
__device__ __forceinline__ float ties_column(const T* __restrict__ x,
                                             long long np, long long c,
                                             int k, float b,
                                             const float* __restrict__ th) {
  float tv[KMAX > 0 ? KMAX : 1];
  float s = 0.f;
  if (KMAX > 0) {
#pragma unroll
    for (int i = 0; i < (KMAX > 0 ? KMAX : 1); ++i) {
      if (i < k) {
        tv[i] = trim(widen(x[static_cast<long long>(i) * np + c]), b, th[i]);
        s = __fadd_rn(s, tv[i]);
      }
    }
  } else {
    for (int i = 0; i < k; ++i)
      s = __fadd_rn(s, trim(widen(x[static_cast<long long>(i) * np + c]), b,
                            th[i]));
  }
  const float elected = sign_of(s);
  float cnt = 0.f, acc = 0.f;
  if (KMAX > 0) {
#pragma unroll
    for (int i = 0; i < (KMAX > 0 ? KMAX : 1); ++i)
      if (i < k) agree(tv[i], elected, cnt, acc);
  } else {
    for (int i = 0; i < k; ++i)
      agree(trim(widen(x[static_cast<long long>(i) * np + c]), b, th[i]),
            elected, cnt, acc);
  }
  return __fadd_rn(b, __fdiv_rn(acc, fmaxf(cnt, 1.f)));
}

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
    out[c] = ties_column<T, KMAX>(x, np, c, k, base[c], thr);
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
