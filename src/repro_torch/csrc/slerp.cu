// B8 slerp, both passes of repro/kernels/slerp.py `slerp_pallas`:
//
//   slerp_reduce   replaces `_reduce_kernel`: per tile of `block` columns,
//                  the partial sums (u.v, u.u, v.v) -> [nb, 3] fp32.
//   slerp_combine  replaces `_combine_kernel`: out = c[0] * u + c[1] * v,
//                  fp32, with c the two scalars the wrapper computes on the
//                  device between the passes (no host sync).
//
// Bound: device-memory bytes. The reduce reads u and v once and writes 12
// bytes per tile; the combine reads u and v once more and writes fp32.
// Design: u and v are read as fp32 or bf16 and widened in registers
// (exact), 8 adjacent columns per thread, one 16-byte load per bf16 row
// (two for fp32). The reduce runs one CUDA block of block / 8 threads per
// tile: each thread adds its 8 products in index order, then a
// stride-halving tree in shared memory (p[t] += p[t + h], h = threads / 2
// down to 1). The plain versions (`kernels/slerp.py`) repeat that order on
// a [nb, threads, 8] view, and rounded intrinsics with --fmad=false make
// kernel and plain version bitwise equal.
#include "common.cuh"

namespace {

constexpr int kVec = 8;
constexpr int kCombineThreads = 256;

template <typename T>
__global__ void slerp_reduce_kernel(const T* __restrict__ u,
                                    const T* __restrict__ v,
                                    float* __restrict__ out, int block) {
  extern __shared__ float part[];           // 3 * blockDim.x
  const int n = blockDim.x, t = threadIdx.x;
  const long long off = static_cast<long long>(blockIdx.x) * block +
                        static_cast<long long>(t) * kVec;
  float a[kVec], b[kVec];
  merge::load_row<kVec>(u + off, a);
  merge::load_row<kVec>(v + off, b);
  float d = __fmul_rn(a[0], b[0]);
  float p = __fmul_rn(a[0], a[0]);
  float q = __fmul_rn(b[0], b[0]);
#pragma unroll
  for (int j = 1; j < kVec; ++j) {
    d = __fadd_rn(d, __fmul_rn(a[j], b[j]));
    p = __fadd_rn(p, __fmul_rn(a[j], a[j]));
    q = __fadd_rn(q, __fmul_rn(b[j], b[j]));
  }
  float* pd = part;
  float* pu = part + n;
  float* pv = part + 2 * n;
  pd[t] = d;
  pu[t] = p;
  pv[t] = q;
  __syncthreads();
  for (int h = n / 2; h > 0; h >>= 1) {
    if (t < h) {
      pd[t] = __fadd_rn(pd[t], pd[t + h]);
      pu[t] = __fadd_rn(pu[t], pu[t + h]);
      pv[t] = __fadd_rn(pv[t], pv[t + h]);
    }
    __syncthreads();
  }
  if (t == 0) {
    float* o = out + static_cast<long long>(blockIdx.x) * 3;
    o[0] = pd[0];
    o[1] = pu[0];
    o[2] = pv[0];
  }
}

template <typename T>
__global__ void slerp_combine_kernel(const T* __restrict__ u,
                                     const T* __restrict__ v,
                                     const float* __restrict__ c,
                                     float* __restrict__ out, long long np) {
  const float c1 = c[0], c2 = c[1];
  const long long groups = np / kVec;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       g < groups; g += stride) {
    float a[kVec], b[kVec];
    merge::load_row<kVec>(u + g * kVec, a);
    merge::load_row<kVec>(v + g * kVec, b);
    float r[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      r[j] = __fadd_rn(__fmul_rn(c1, a[j]), __fmul_rn(c2, b[j]));
    float4* o = reinterpret_cast<float4*>(out + g * kVec);
    o[0] = make_float4(r[0], r[1], r[2], r[3]);
    o[1] = make_float4(r[4], r[5], r[6], r[7]);
  }
}

template <typename T>
int reduce_launch(const void* u, const void* v, void* out, long long np,
                  int block, cudaStream_t stream) {
  const int threads = block / kVec;
  const unsigned int grid = static_cast<unsigned int>(np / block);
  slerp_reduce_kernel<T><<<grid, threads, 3 * threads * sizeof(float),
                           stream>>>(static_cast<const T*>(u),
                                     static_cast<const T*>(v),
                                     static_cast<float*>(out), block);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int combine_launch(const void* u, const void* v, const void* c, void* out,
                   long long np, cudaStream_t stream) {
  const unsigned int grid = merge::grid_for(np / kVec, kCombineThreads);
  slerp_combine_kernel<T><<<grid, kCombineThreads, 0, stream>>>(
      static_cast<const T*>(u), static_cast<const T*>(v),
      static_cast<const float*>(c), static_cast<float*>(out), np);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u, v: [np] fp32 or bf16 (raw bits), 16-byte aligned, np a multiple of
// `block`; block / 8 a power of two of at most 1024 threads. The Python
// wrappers check shapes, dtypes, alignment and devices.
extern "C" int slerp_reduce_f32(const void* u, const void* v, void* out,
                                long long np, int block, void* stream) {
  return reduce_launch<float>(u, v, out, np, block,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int slerp_reduce_bf16(const void* u, const void* v, void* out,
                                 long long np, int block, void* stream) {
  return reduce_launch<uint16_t>(u, v, out, np, block,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int slerp_combine_f32(const void* u, const void* v, const void* c,
                                 void* out, long long np, void* stream) {
  return combine_launch<float>(u, v, c, out, np,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int slerp_combine_bf16(const void* u, const void* v,
                                  const void* c, void* out, long long np,
                                  void* stream) {
  return combine_launch<uint16_t>(u, v, c, out, np,
                                  static_cast<cudaStream_t>(stream));
}
