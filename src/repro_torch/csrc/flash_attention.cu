// B9 flash attention, replacing repro/kernels/flash_attention.py
// `flash_attention` (its Pallas kernel `_flash_kernel`): online-softmax
// attention with GQA and a causal mask by position.
//
//   q [B, Sq, H, D], k and v [B, Sk, HK, D], fp32 or bf16 (all three
//   alike), read in place through their strides (the last dimension
//   contiguous); out [B, Sq, H, D] contiguous, in q's dtype. Query head h
//   reads KV head h / (H / HK). Query row i sits at position q_offset + i;
//   with `causal`, key j is visible to it iff j <= q_offset + i. Keys at
//   or past Sk are never read (the reference pads them with zeros, and
//   without `causal` leaves the zeros in its softmax; here they are
//   masked). logits = (q . k) * scale in fp32; a running max m, normalizer
//   l and fp32 accumulator of p * v per query row; out = acc / max(l,
//   1e-30), rounded to q's dtype. A row that sees no key gives 0.
//
// Bound on the H100: operations for prefill (4 D flops per visible
// (query, key) pair against 2 bytes per element read), bytes for decode
// (one query row streams its whole K and V prefix). This first kernel
// runs on the scalar fp32 pipes with explicit fmaf (the build's
// --fmad=false only stops implicit contraction), and stays far from the
// tensor-core bound; `wgmma` and TMA are a later change.
//
// Design: one CUDA block of 256 threads per (query tile, head, batch);
// the query tile is 64 rows (16 row groups x 4 rows), or 16 rows (x 1)
// when Sq <= 16, so a decode step does not waste 63 of 64 rows. The
// tile's queries stay in shared memory as fp32 for the whole key loop.
// Per tile of 64 keys, K (transposed) and V are staged in shared memory
// widened to fp32 with 16-byte loads; thread (ty, tx) computes the
// logits of its 4 (or 1) rows and keys tx, tx+16, tx+32, tx+48, reduces
// max and sum across its 16 lanes with shuffles (no atomics: keys are
// consumed in index order, so every launch gives the same bits), writes
// p to shared memory, then accumulates p * v into head dims tx + 16 j
// of its rows in registers. A causal block stops at the last key tile
// any of its rows can see. Shared memory exceeds the default 48 KB for
// D = 96 (93 KB at 64 rows), so the launch raises the limit.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;                 // lanes across keys and head dims
constexpr int kTY = kThreads / kTX;     // row groups
constexpr int kBK = 64;                 // keys per tile

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

template <int D, int RQ>
constexpr int smem_floats() {
  return D * (kTY * RQ + 4)      // Qs [D][BQ + 4]
         + D * (kBK + 1)         // Ks [D][BK + 1]
         + kBK * D               // Vs [BK][D]
         + kTY * RQ * (kBK + 4); // Ps [BQ][BK + 4]
}

template <typename T, int D, int RQ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
             int h, int hk, long long qsb, long long qss, long long qsh,
             long long ksb, long long kss, long long ksh, long long vsb,
             long long vss, long long vsh, float scale, int causal,
             int q_offset) {
  constexpr int BQ = kTY * RQ;
  constexpr int DC = D / kTX;           // head dims per thread
  constexpr int U = D / 8;              // 8-element units per row
  constexpr int QLD = BQ + 4, KLD = kBK + 1, PLD = kBK + 4;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + D * QLD;
  float* Vs = Ks + D * KLD;
  float* Ps = Vs + kBK * D;

  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  // the longest causal tiles first, so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kh = hh / (h / hk);
  const int rows = min(BQ, sq - q0);
  const T* qb = q + b * qsb + hh * qsh;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  for (int u = tid; u < BQ * U; u += kThreads) {
    const int r = u / U, d8 = (u % U) * 8;
    float x[8];
    if (r < rows) {
      merge::load_row<8>(qb + static_cast<long long>(q0 + r) * qss + d8, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) Qs[(d8 + e) * QLD + r] = x[e];
  }

  // keys [0, kend) are read; with `causal` no row of the tile sees past
  // position q_offset + q0 + rows - 1
  const int kend = causal ? max(0, min(sk, q_offset + q0 + rows)) : sk;

  float m[RQ], l[RQ], acc[RQ][DC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();   // Q staged; the previous tile's K, V, P all read
    for (int u = tid; u < kBK * U; u += kThreads) {
      const int c = u / U, d8 = (u % U) * 8;
      float x[8], y[8];
      if (k0 + c < kend) {
        const long long key = k0 + c;
        merge::load_row<8>(kb + key * kss + d8, x);
        merge::load_row<8>(vb + key * vss + d8, y);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = y[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        Ks[(d8 + e) * KLD + c] = x[e];
        Vs[c * D + d8 + e] = y[e];
      }
    }
    __syncthreads();

    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[RQ];
      if constexpr (RQ == 4) {
        const float4 a4 =
            *reinterpret_cast<const float4*>(Qs + d * QLD + ty * RQ);
        a[0] = a4.x; a[1] = a4.y; a[2] = a4.z; a[3] = a4.w;
      } else {
#pragma unroll
        for (int i = 0; i < RQ; ++i) a[i] = Qs[d * QLD + ty * RQ + i];
      }
      float kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[d * KLD + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q_offset + q0 + ty * RQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + kTX * j;
        const bool seen = key < kend && (!causal || key <= qpos);
        s[i][j] = seen ? __fmul_rn(s[i][j], scale) : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      // no key seen yet: subtract 0, so exp(-inf) = 0 and no NaN
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(__fsub_rn(m[i], m_use));
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(__fsub_rn(s[i][j], m_use));
        rs = __fadd_rn(rs, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        rs = __fadd_rn(rs, __shfl_xor_sync(0xffffffffu, rs, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] = __fmul_rn(acc[i][j], alpha);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        Ps[(ty * RQ + i) * PLD + tx + kTX * j] = s[i][j];
    }
    __syncthreads();

    // keys past kend carry p = 0 and zero V rows: the full tile is safe
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float p[RQ][4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + (ty * RQ + i) * PLD + c);
        p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float vv = Vs[(c + cc) * D + tx + kTX * j];
#pragma unroll
          for (int i = 0; i < RQ; ++i)
            acc[i][j] = fmaf(p[i][cc], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int r = ty * RQ + i;
    if (r < rows) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* orow = o + ((static_cast<long long>(b) * sq + q0 + r) * h + hh) * D;
#pragma unroll
      for (int j = 0; j < DC; ++j)
        store(orow + tx + kTX * j, __fdiv_rn(acc[i][j], denom));
    }
  }
}

template <typename T, int D, int RQ>
int launch_one(const void* q, const void* k, const void* v, void* o, int b,
               int sq, int sk, int h, int hk, const long long* st,
               float scale, int causal, int q_offset, cudaStream_t stream) {
  constexpr int bytes = smem_floats<D, RQ>() * static_cast<int>(sizeof(float));
  auto kern = flash_kernel<T, D, RQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BQ = kTY * RQ;
  const dim3 grid((sq + BQ - 1) / BQ, h, b);
  kern<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, hk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], scale, causal,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int RQ>
int by_head_dim(int d, const void* q, const void* k, const void* v, void* o,
                int b, int sq, int sk, int h, int hk, const long long* st,
                float scale, int causal, int q_offset, cudaStream_t stream) {
  switch (d) {
    case 16: return launch_one<T, 16, RQ>(q, k, v, o, b, sq, sk, h, hk, st,
                                          scale, causal, q_offset, stream);
    case 32: return launch_one<T, 32, RQ>(q, k, v, o, b, sq, sk, h, hk, st,
                                          scale, causal, q_offset, stream);
    case 64: return launch_one<T, 64, RQ>(q, k, v, o, b, sq, sk, h, hk, st,
                                          scale, causal, q_offset, stream);
    case 96: return launch_one<T, 96, RQ>(q, k, v, o, b, sq, sk, h, hk, st,
                                          scale, causal, q_offset, stream);
    case 128: return launch_one<T, 128, RQ>(q, k, v, o, b, sq, sk, h, hk, st,
                                            scale, causal, q_offset, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int hk, int d, long long qsb,
           long long qss, long long qsh, long long ksb, long long kss,
           long long ksh, long long vsb, long long vss, long long vsh,
           float scale, int causal, int q_offset, void* stream) {
  if (b == 0 || sq == 0 || h == 0) return 0;
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (sq <= kTY)
    return by_head_dim<T, 1>(d, q, k, v, o, b, sq, sk, h, hk, st, scale,
                             causal, q_offset, s);
  return by_head_dim<T, 4>(d, q, k, v, o, b, sq, sk, h, hk, st, scale,
                           causal, q_offset, s);
}

}  // namespace

// q, k, v: fp32 or bf16 (raw bits) with element strides (batch, seq,
// head) and a contiguous last dimension, 16-byte aligned rows; d in
// {16, 32, 64, 96, 128}; h a multiple of hk; q_offset >= 0. out:
// contiguous [b, sq, h, d] of the same dtype. The Python wrapper checks
// all of this.
extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int b, int sq,
    int sk, int h, int hk, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale, int causal,
    int q_offset, void* stream) {
  return launch<float>(q, k, v, o, b, sq, sk, h, hk, d, qsb, qss, qsh, ksb,
                       kss, ksh, vsb, vss, vsh, scale, causal, q_offset,
                       stream);
}

extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int b, int sq,
    int sk, int h, int hk, int d, long long qsb, long long qss,
    long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, float scale, int causal,
    int q_offset, void* stream) {
  return launch<uint16_t>(q, k, v, o, b, sq, sk, h, hk, d, qsb, qss, qsh,
                          ksb, kss, ksh, vsb, vss, vsh, scale, causal,
                          q_offset, stream);
}
