// B6 dare_block: DARE with a counter-hash RNG, over a block-aligned flat
// batch whose per-tile metadata rows carry (seed, leaf padded length,
// start column in the leaf):
//   idx      = row * npad + start + (c - tile * block)      (uint32, wraps)
//   keep     = hash_uniform(idx, seed) >= p
//   tau[i]   = (x[i, c] - base[c]) * keep * rescale,  rescale = f32(1/(1-p))
//   out[c]   = base[c] + (sum_i tau[i]) * f32(1/k)
//
// Replaces the TPU kernel `repro/kernels/dare.py` (`dare_block_pallas` /
// `_dare_kernel`, also behind `dare_pallas`), which the merge engine
// reaches for DARE groups when `kernel_env.dare_kernel_rng` is set.
//
// Bound: device-memory bytes. The stack is read once (bf16 stays bf16 and
// widens in registers), the base once, the output written once. The hash
// costs about 17 integer operations per stacked element and the merge 4
// fp32 ones; at the card's scalar rate that is below the byte time (see
// PERF.md), so the mask is recomputed, never stored.
// Design: one thread owns VEC adjacent columns (one 16-byte load per row)
// of one tile; the k rows are summed in index order. The hash is exact
// uint32 arithmetic, so masks are bitwise the reference's; __f*_rn with
// --fmad=false pin the merge to the plain version's (`kernels/dare.py`).
// The mean multiplies by the fp32 reciprocal of k, as XLA lowers the
// reference's `jnp.mean` (a division would differ at k = 3, 5, ...).
#include "common.cuh"

namespace {

__device__ __forceinline__ float hash_uniform(uint32_t idx, uint32_t seed) {
  uint32_t h = idx * 2654435761u;
  h ^= seed;
  h ^= h >> 15;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  // (h >> 8) < 2^24 converts exactly; the scale is a power of two
  return __fmul_rn(static_cast<float>(h >> 8), 5.9604644775390625e-08f);
}

template <typename T, int VEC>
__global__ void dare_kernel(const T* __restrict__ x,
                            const float* __restrict__ base,
                            const uint32_t* __restrict__ meta,
                            float* __restrict__ out, int k, long long np,
                            int block, float p, float rescale, float rk) {
  const long long nvec = np / VEC;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       v < nvec; v += stride) {
    const long long c = v * VEC;
    const long long tile = c / block;
    const uint32_t seed = meta[tile * 3], npad = meta[tile * 3 + 1];
    const uint32_t col0 =
        meta[tile * 3 + 2] + static_cast<uint32_t>(c - tile * block);
    float b[VEC], acc[VEC], xv[VEC];
    merge::load_row<VEC>(base + c, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int i = 0; i < k; ++i) {
      merge::load_row<VEC>(x + static_cast<long long>(i) * np + c, xv);
      const uint32_t rowbase = static_cast<uint32_t>(i) * npad + col0;
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float keep =
            hash_uniform(rowbase + static_cast<uint32_t>(j), seed) >= p
                ? 1.f : 0.f;
        const float t =
            __fmul_rn(__fmul_rn(__fsub_rn(xv[j], b[j]), keep), rescale);
        acc[j] = __fadd_rn(acc[j], t);
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; j += 4) {
      float4 o;
      o.x = __fadd_rn(b[j], __fmul_rn(acc[j], rk));
      o.y = __fadd_rn(b[j + 1], __fmul_rn(acc[j + 1], rk));
      o.z = __fadd_rn(b[j + 2], __fmul_rn(acc[j + 2], rk));
      o.w = __fadd_rn(b[j + 3], __fmul_rn(acc[j + 3], rk));
      *reinterpret_cast<float4*>(out + c + j) = o;
    }
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* base, const void* meta, void* out,
           int k, long long np, int block, float p, float rescale,
           void* stream) {
  const int threads = 256;
  dare_kernel<T, VEC><<<merge::grid_for(np / VEC, threads), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const float*>(base),
      static_cast<const uint32_t*>(meta), static_cast<float*>(out), k, np,
      block, p, rescale, 1.0f / static_cast<float>(k));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `np` and `block` must be multiples of 8 and x, base and out 16-byte
// aligned (the Python wrapper checks); meta is [np / block, 3] uint32.
extern "C" int dare_block_f32(const void* x, const void* base,
                              const void* meta, void* out, int k,
                              long long np, int block, float p,
                              float rescale, void* stream) {
  return launch<float, 4>(x, base, meta, out, k, np, block, p, rescale,
                          stream);
}

extern "C" int dare_block_bf16(const void* x, const void* base,
                               const void* meta, void* out, int k,
                               long long np, int block, float p,
                               float rescale, void* stream) {
  return launch<uint16_t, 8>(x, base, meta, out, k, np, block, p, rescale,
                             stream);
}
