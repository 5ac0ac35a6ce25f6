// The three passes of histogram-trim TIES over a block-aligned flat
// batch: every `block`-wide column tile belongs to one leaf, and the
// per-leaf scalars ride in per-tile metadata rows.
//
//   B3 block_amax  replaces repro/kernels/histogram.py `block_amax_pallas`
//                  (`_amax_kernel`): out[b, i] = max_c |x[i, c] - base[c]|
//                  over tile b, NaN-propagating as jnp.max.
//   B4 block_hist  replaces `block_hist_pallas` (`_hist_kernel`): per tile
//                  and contribution, counts of
//                  clip(int(|x - base| / amax * bins), 0, bins - 1) over
//                  the tile's valid columns.
//   B5 ties_block  replaces `ties_block_pallas` (`_ties_block_kernel` ->
//                  repro/kernels/ties.py `ties_tile`): trim at the tile's
//                  per-contribution threshold, elect the sign of the
//                  k-sum, mean of the agreeing entries.
//
// Bound: device-memory bytes, for all three. Each streams the [k, Np]
// stack once (B5 reads it twice within one thread when k exceeds its
// register budget, the second time from L1/L2) at a few flops per byte.
// Design: x is read as fp32 or bf16 and widened in registers, so the
// engine's bf16 batch is never copied to fp32 (widening is exact: the
// result is the reference's fp32 `pad_stacked` copy's). Neighbouring
// threads take neighbouring columns, so every row read is coalesced.
// B3 and B4 run one CUDA block per (tile, contribution); B4 keeps its
// `bins` counters in shared memory, and integer atomics make the counts
// exact in any order. B5 gives each thread one column and sums over k in
// index order. All arithmetic is pinned with rounded intrinsics and
// --fmad=false, so each kernel is bitwise its plain version in
// `kernels/histogram.py`; the bin index divides, then multiplies, as the
// reference does (no reciprocal).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void block_amax_kernel(const T* __restrict__ x,
                                  const float* __restrict__ base,
                                  float* __restrict__ out, int k, long long np,
                                  int block) {
  const long long tile = blockIdx.x;
  const int i = blockIdx.y;
  const T* row = x + static_cast<long long>(i) * np + tile * block;
  const float* brow = base + tile * block;
  float m = 0.f;
  for (int c = threadIdx.x; c < block; c += blockDim.x)
    m = merge::nanmax(m, fabsf(__fsub_rn(merge::widen(row[c]), brow[c])));
  for (int off = 16; off > 0; off >>= 1)
    m = merge::nanmax(m, __shfl_down_sync(0xffffffffu, m, off));
  __shared__ float part[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = part[0];
    for (int j = 1; j < blockDim.x / 32; ++j) r = merge::nanmax(r, part[j]);
    out[tile * k + i] = r;
  }
}

template <typename T>
__global__ void block_hist_kernel(const T* __restrict__ x,
                                  const float* __restrict__ base,
                                  const float* __restrict__ amax,
                                  const int* __restrict__ valid,
                                  int* __restrict__ out, int k, long long np,
                                  int block, int bins) {
  extern __shared__ unsigned int hist[];
  const long long tile = blockIdx.x;
  const int i = blockIdx.y;
  for (int j = threadIdx.x; j < bins; j += blockDim.x) hist[j] = 0u;
  __syncthreads();
  const T* row = x + static_cast<long long>(i) * np + tile * block;
  const float* brow = base + tile * block;
  const float am = amax[tile * k + i];
  const float fbins = static_cast<float>(bins);
  const int nvalid = valid[tile];
  for (int c = threadIdx.x; c < nvalid; c += blockDim.x) {
    const float a = fabsf(__fsub_rn(merge::widen(row[c]), brow[c]));
    int idx = __float2int_rz(__fmul_rn(__fdiv_rn(a, am), fbins));
    idx = idx < 0 ? 0 : (idx > bins - 1 ? bins - 1 : idx);
    atomicAdd(&hist[idx], 1u);
  }
  __syncthreads();
  int* o = out + (tile * k + i) * static_cast<long long>(bins);
  for (int j = threadIdx.x; j < bins; j += blockDim.x)
    o[j] = static_cast<int>(hist[j]);
}

// One thread per column (grid-stride); the tile arithmetic is
// `merge::ties_column`, with the column's tile's [k] thresholds.
template <typename T, int KMAX>
__global__ void ties_block_kernel(const T* __restrict__ x,
                                  const float* __restrict__ base,
                                  const float* __restrict__ thr,
                                  float* __restrict__ out, int k, long long np,
                                  int block) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long c = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       c < np; c += stride)
    out[c] = merge::ties_column<T, KMAX>(x, np, c, k, base[c],
                                         thr + (c / block) * k);
}

template <typename T>
int amax_launch(const void* x, const void* base, void* out, int k,
                long long np, int block, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned int>(np / block), k);
  block_amax_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(base),
      static_cast<float*>(out), k, np, block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int hist_launch(const void* x, const void* base, const void* amax,
                const void* valid, void* out, int k, long long np, int block,
                int bins, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(bins) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        block_hist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(static_cast<unsigned int>(np / block), k);
  block_hist_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(base),
      static_cast<const float*>(amax), static_cast<const int*>(valid),
      static_cast<int*>(out), k, np, block, bins);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int ties_launch(const void* x, const void* base, const void* thr, void* out,
                int k, long long np, int block, cudaStream_t stream) {
  const unsigned int grid = merge::grid_for(np, kThreads);
  const T* xp = static_cast<const T*>(x);
  const float* bp = static_cast<const float*>(base);
  const float* tp = static_cast<const float*>(thr);
  float* op = static_cast<float*>(out);
  if (k <= 4)
    ties_block_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xp, bp, tp, op, k,
                                                          np, block);
  else if (k <= 16)
    ties_block_kernel<T, 16><<<grid, kThreads, 0, stream>>>(xp, bp, tp, op,
                                                           k, np, block);
  else
    ties_block_kernel<T, 0><<<grid, kThreads, 0, stream>>>(xp, bp, tp, op, k,
                                                          np, block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [k, np] fp32 or bf16 (raw bits), base: [np] fp32, np a multiple of
// `block`; the Python wrappers check shapes, dtypes and devices.
extern "C" int block_amax_f32(const void* x, const void* base, void* out,
                              int k, long long np, int block, void* stream) {
  return amax_launch<float>(x, base, out, k, np, block,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int block_amax_bf16(const void* x, const void* base, void* out,
                               int k, long long np, int block, void* stream) {
  return amax_launch<uint16_t>(x, base, out, k, np, block,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int block_hist_f32(const void* x, const void* base,
                              const void* amax, const void* valid, void* out,
                              int k, long long np, int block, int bins,
                              void* stream) {
  return hist_launch<float>(x, base, amax, valid, out, k, np, block, bins,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int block_hist_bf16(const void* x, const void* base,
                               const void* amax, const void* valid, void* out,
                               int k, long long np, int block, int bins,
                               void* stream) {
  return hist_launch<uint16_t>(x, base, amax, valid, out, k, np, block, bins,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int ties_block_f32(const void* x, const void* base, const void* thr,
                              void* out, int k, long long np, int block,
                              void* stream) {
  return ties_launch<float>(x, base, thr, out, k, np, block,
                            static_cast<cudaStream_t>(stream));
}

extern "C" int ties_block_bf16(const void* x, const void* base,
                               const void* thr, void* out, int k, long long np,
                               int block, void* stream) {
  return ties_launch<uint16_t>(x, base, thr, out, k, np, block,
                               static_cast<cudaStream_t>(stream));
}
