#pragma once

#include <math.h>

#include "b9_common.cuh"

namespace {

// B9's gradient, replacing no TPU kernel: the reference's Pallas B9
// (repro/kernels/flash_attention.py) has no backward, and its model
// trains through XLA's autodiff of `chunked_attention`
// (repro/models/layers.py:149). This computes the same dQ, dK and dV of
// csrc/flash_attention.cu's prefill function (causal or full, GQA,
// q_offset 0), so that training's forward can run on B9.
//
// FlashAttention-2's backward, made deterministic: no float is summed
// with atomics, and every sum runs in one fixed order. Three kernels on
// the scalar fp32 pipes (explicit fmaf), q, k, v, o, dO contiguous
// [B, S, H(K), D] in the input dtype, widened to fp32 in shared memory;
// the forward's per-row log-sum-exp `lse` [B, H, Sq] (natural units)
// recomputes P = exp(q.k scale - lse) with no running max:
//  1. `bwd_dot`: Dd[b, h, i] = sum_d dO[i, d] O[i, d], one warp a row,
//     lanes over d, then a shuffle tree.
//  2. `bwd_dkdv`: one block per (key tile of 64, KV head, batch). K and V
//     stay in shared memory; for each query head of the GQA group in
//     order, and each query tile that sees the key tile (causal: from the
//     diagonal on) in order, it recomputes S = Q K^T and dP = dO V^T,
//     P = exp(S scale - lse), dS = P (dP - Dd), and accumulates
//     dV += P^T dO and dK += dS^T Q in registers, query by query. dK is
//     scaled once at the end.
//  3. `bwd_dq`: one block per (query tile of 64, head, batch). It loops
//     over the key tiles the rows see, recomputes P and dS the same way,
//     and accumulates dQ += dS K.
// Q K^T and dO V^T are computed twice (kernels 2 and 3): the price of
// writing dQ with no atomics. Thread (ty, tx) of 16 x 16 computes S and
// dP of rows 4 ty .. 4 ty + 3 and keys tx + 16 j; the accumulations give
// each thread 4 keys (rows) tx + 16 i and head dims ty + 16 j. Tiles are
// stored transposed ([D][68]: 16-byte rows for float4 reads, columns read
// by 16 lanes in 16 banks) and P, dS as [64][68]. Bound: operations (5
// causal matmuls' worth of work at the least; this design does 7 on the
// fp32 pipes, where the tensor cores would do them 15x faster in bf16:
// `mma.sync` fragments, then `wgmma` and TMA, are the next redesign).
// Rows that see no key (queries past Sq; the forward writes lse 0 for
// them) give P = 0, so dQ 0. Head dims 16, 64, 96 and 128 (the configs'
// and the smoke's); a source of its own (csrc/flash_attention_bwd.cu),
// so it builds beside the forward's.

constexpr int kBwdThreads = 256;
constexpr int kBwdT = 16;            // tx, ty in [0, 16)
constexpr int kBwdB = 64;            // query and key rows per tile
constexpr int kBwdLD = kBwdB + 4;    // transposed tile row stride

template <int D>
constexpr int bwd_dkdv_smem() {      // Kt, Vt, Qt, dOt, Pt, dSt, lse, Dd
  return (4 * D * kBwdLD + 2 * kBwdB * kBwdLD + 2 * kBwdB) * 4;
}

template <int D>
constexpr int bwd_dq_smem() {        // Qt, dOt, Kt, Vt, dS, lse, Dd
  return (4 * D * kBwdLD + kBwdB * kBwdLD + 2 * kBwdB) * 4;
}

// rows [r0, r0 + 64) of x [., S, NH, D] at head hh, transposed into
// xt[D][kBwdLD] in fp32; rows at or past n are zero. Consecutive threads
// take consecutive rows, so the shared-memory writes hit distinct banks.
template <typename T, int D>
__device__ __forceinline__ void load_tile_t(const T* __restrict__ x,
                                            float* __restrict__ xt, int r0,
                                            int n, long long row_stride) {
  constexpr int U = D / 8;
  for (int u = threadIdx.x; u < kBwdB * U; u += kBwdThreads) {
    const int c = u % kBwdB, d8 = (u / kBwdB) * 8;
    float y[8];
    if (r0 + c < n) {
      merge::load_row<8>(x + static_cast<long long>(r0 + c) * row_stride + d8,
                         y);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) y[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) xt[(d8 + e) * kBwdLD + c] = y[e];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(256)
bwd_dot(const T* __restrict__ o, const T* __restrict__ dout,
        float* __restrict__ dd, int b, int sq, int h) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * 8
                        + (threadIdx.x >> 5);      // (b, s, hh) row
  if (row >= static_cast<long long>(b) * sq * h) return;
  const T* orow = o + row * D;
  const T* grow = dout + row * D;
  float a = 0.f;
  for (int d = lane; d < D; d += 32)
    a = fmaf(merge::widen(grow[d]), merge::widen(orow[d]), a);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
  if (lane == 0) {
    const int hh = static_cast<int>(row % h);
    const long long bs = row / h;
    const int s = static_cast<int>(bs % sq), bb = static_cast<int>(bs / sq);
    dd[(static_cast<long long>(bb) * h + hh) * sq + s] = a;
  }
}

// S and dP of the tile: rows 4 ty + i, keys tx + 16 j; P and dS from them
template <int D>
__device__ __forceinline__ void bwd_scores(
    const float* __restrict__ Qt, const float* __restrict__ dOt,
    const float* __restrict__ Kt, const float* __restrict__ Vt,
    const float* __restrict__ lse_s, const float* __restrict__ dd_s,
    int q0, int k0, int sq, int sk, int causal, float scale,
    float (&p)[4][4], float (&ds)[4][4]) {
  const int tx = threadIdx.x % kBwdT, ty = threadIdx.x / kBwdT;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    const float4 a4 = *reinterpret_cast<const float4*>(Qt + d * kBwdLD
                                                       + ty * 4);
    const float4 g4 = *reinterpret_cast<const float4*>(dOt + d * kBwdLD
                                                       + ty * 4);
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float g[4] = {g4.x, g4.y, g4.z, g4.w};
    float kk[4], vv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kk[j] = Kt[d * kBwdLD + tx + kBwdT * j];
      vv[j] = Vt[d * kBwdLD + tx + kBwdT * j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], kk[j], s[i][j]);
        dp[i][j] = fmaf(g[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, q = q0 + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + kBwdT * j;
      const bool seen = q < sq && key < sk && (!causal || key <= q);
      p[i][j] = seen ? expf(__fsub_rn(__fmul_rn(s[i][j], scale), lse_s[r]))
                     : 0.f;
      ds[i][j] = __fmul_rn(p[i][j], __fsub_rn(dp[i][j], dd_s[r]));
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dd,
         T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
         int hk, float scale, int causal) {
  constexpr int DJ = D / kBwdT;         // head dims per thread
  extern __shared__ __align__(16) float smb[];
  float* Kt = smb;
  float* Vt = Kt + D * kBwdLD;
  float* Qt = Vt + D * kBwdLD;
  float* dOt = Qt + D * kBwdLD;
  float* Pt = dOt + D * kBwdLD;
  float* dSt = Pt + kBwdB * kBwdLD;
  float* lse_s = dSt + kBwdB * kBwdLD;
  float* dd_s = lse_s + kBwdB;

  const int tid = threadIdx.x, tx = tid % kBwdT, ty = tid / kBwdT;
  const int k0 = blockIdx.x * kBwdB, kh = blockIdx.y, b = blockIdx.z;
  const int g = h / hk;
  load_tile_t<T, D>(k + (static_cast<long long>(b) * sk * hk + kh) * D, Kt,
                    k0, sk, static_cast<long long>(hk) * D);
  load_tile_t<T, D>(v + (static_cast<long long>(b) * sk * hk + kh) * D, Vt,
                    k0, sk, static_cast<long long>(hk) * D);

  float akd[4][DJ], avd[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) akd[i][j] = avd[i][j] = 0.f;

  const int nqt = (sq + kBwdB - 1) / kBwdB;
  const int first = causal ? k0 / kBwdB : 0;   // q_offset 0: rows >= k0
  for (int r = 0; r < g; ++r) {
    const int hh = kh * g + r;
    for (int qt = first; qt < nqt; ++qt) {
      const int q0 = qt * kBwdB;
      __syncthreads();   // the previous tile's Q, dO, P, dS all read
      load_tile_t<T, D>(q + (static_cast<long long>(b) * sq * h + hh) * D,
                        Qt, q0, sq, static_cast<long long>(h) * D);
      load_tile_t<T, D>(dout + (static_cast<long long>(b) * sq * h + hh) * D,
                        dOt, q0, sq, static_cast<long long>(h) * D);
      if (tid < kBwdB) {
        const long long row = (static_cast<long long>(b) * h + hh) * sq + q0
                              + tid;
        lse_s[tid] = q0 + tid < sq ? lse[row] : 0.f;
        dd_s[tid] = q0 + tid < sq ? dd[row] : 0.f;
      }
      __syncthreads();
      float p[4][4], ds[4][4];
      bwd_scores<D>(Qt, dOt, Kt, Vt, lse_s, dd_s, q0, k0, sq, sk, causal,
                    scale, p, ds);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = tx + kBwdT * j;
        *reinterpret_cast<float4*>(Pt + key * kBwdLD + ty * 4) =
            make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
        *reinterpret_cast<float4*>(dSt + key * kBwdLD + ty * 4) =
            make_float4(ds[0][j], ds[1][j], ds[2][j], ds[3][j]);
      }
      __syncthreads();
      // dV[key, d] += sum_q P[q, key] dO[q, d]; dK[key, d] += dS[q, key]
      // Q[q, d], q in order
#pragma unroll 2
      for (int c = 0; c < kBwdB; c += 4) {
        float4 p4[4], s4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p4[i] = *reinterpret_cast<const float4*>(
              Pt + (tx + kBwdT * i) * kBwdLD + c);
          s4[i] = *reinterpret_cast<const float4*>(
              dSt + (tx + kBwdT * i) * kBwdLD + c);
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          const float4 o4 = *reinterpret_cast<const float4*>(
              dOt + (ty + kBwdT * j) * kBwdLD + c);
          const float4 x4 = *reinterpret_cast<const float4*>(
              Qt + (ty + kBwdT * j) * kBwdLD + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float a = avd[i][j], e = akd[i][j];
            a = fmaf(p4[i].x, o4.x, a);
            a = fmaf(p4[i].y, o4.y, a);
            a = fmaf(p4[i].z, o4.z, a);
            a = fmaf(p4[i].w, o4.w, a);
            e = fmaf(s4[i].x, x4.x, e);
            e = fmaf(s4[i].y, x4.y, e);
            e = fmaf(s4[i].z, x4.z, e);
            e = fmaf(s4[i].w, x4.w, e);
            avd[i][j] = a;
            akd[i][j] = e;
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + tx + kBwdT * i;
    if (key >= sk) continue;
    const long long base =
        ((static_cast<long long>(b) * sk + key) * hk + kh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      store(dk + base + ty + kBwdT * j, __fmul_rn(akd[i][j], scale));
      store(dv + base + ty + kBwdT * j, avd[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
       const T* __restrict__ v, const T* __restrict__ dout,
       const float* __restrict__ lse, const float* __restrict__ dd,
       T* __restrict__ dq, int sq, int sk, int h, int hk, float scale,
       int causal) {
  constexpr int DJ = D / kBwdT;
  extern __shared__ __align__(16) float smb[];
  float* Qt = smb;
  float* dOt = Qt + D * kBwdLD;
  float* Kt = dOt + D * kBwdLD;
  float* Vt = Kt + D * kBwdLD;
  float* dSs = Vt + D * kBwdLD;          // [q][key]
  float* lse_s = dSs + kBwdB * kBwdLD;
  float* dd_s = lse_s + kBwdB;

  const int tid = threadIdx.x, tx = tid % kBwdT, ty = tid / kBwdT;
  // the longest causal tiles first, so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBwdB;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kh = hh / (h / hk);
  const int rows = min(kBwdB, sq - q0);
  load_tile_t<T, D>(q + (static_cast<long long>(b) * sq * h + hh) * D, Qt,
                    q0, sq, static_cast<long long>(h) * D);
  load_tile_t<T, D>(dout + (static_cast<long long>(b) * sq * h + hh) * D,
                    dOt, q0, sq, static_cast<long long>(h) * D);
  if (tid < kBwdB) {
    const long long row = (static_cast<long long>(b) * h + hh) * sq + q0
                          + tid;
    lse_s[tid] = tid < rows ? lse[row] : 0.f;
    dd_s[tid] = tid < rows ? dd[row] : 0.f;
  }
  const int kend = causal ? min(sk, q0 + rows) : sk;

  float aq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) aq[i][j] = 0.f;

  for (int k0 = 0; k0 < kend; k0 += kBwdB) {
    __syncthreads();   // Q staged; the previous tile's K, V, dS all read
    load_tile_t<T, D>(k + (static_cast<long long>(b) * sk * hk + kh) * D,
                      Kt, k0, sk, static_cast<long long>(hk) * D);
    load_tile_t<T, D>(v + (static_cast<long long>(b) * sk * hk + kh) * D,
                      Vt, k0, sk, static_cast<long long>(hk) * D);
    __syncthreads();
    float p[4][4], ds[4][4];
    bwd_scores<D>(Qt, dOt, Kt, Vt, lse_s, dd_s, q0, k0, sq, sk, causal,
                  scale, p, ds);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dSs[(ty * 4 + i) * kBwdLD + tx + kBwdT * j] = ds[i][j];
    __syncthreads();
    // dQ[q, d] += sum_key dS[q, key] K[key, d], keys in order
#pragma unroll 2
    for (int c = 0; c < kBwdB; c += 4) {
      float4 s4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        s4[i] = *reinterpret_cast<const float4*>(
            dSs + (tx + kBwdT * i) * kBwdLD + c);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            Kt + (ty + kBwdT * j) * kBwdLD + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float a = aq[i][j];
          a = fmaf(s4[i].x, k4.x, a);
          a = fmaf(s4[i].y, k4.y, a);
          a = fmaf(s4[i].z, k4.z, a);
          a = fmaf(s4[i].w, k4.w, a);
          aq[i][j] = a;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tx + kBwdT * i;
    if (r >= rows) continue;
    const long long base =
        ((static_cast<long long>(b) * sq + q0 + r) * h + hh) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      store(dq + base + ty + kBwdT * j, __fmul_rn(aq[i][j], scale));
  }
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dd, void* dq,
               void* dk, void* dv, int b, int sq, int sk, int h, int hk,
               float scale, int causal, cudaStream_t stream) {
  static bool done_kv[64], done_q[64];
  auto kkv = bwd_dkdv<T, D>;
  auto kq = bwd_dq<T, D>;
  cudaError_t err = allow_smem(kkv, bwd_dkdv_smem<D>(), done_kv);
  if (err == cudaSuccess) err = allow_smem(kq, bwd_dq_smem<D>(), done_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rows = static_cast<long long>(b) * sq * h;
  bwd_dot<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), dd, b, sq, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gkv((sk + kBwdB - 1) / kBwdB, hk, b);
  kkv<<<gkv, kBwdThreads, bwd_dkdv_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
      static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, h, hk, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gq((sq + kBwdB - 1) / kBwdB, h, b);
  kq<<<gq, kBwdThreads, bwd_dq_smem<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
      static_cast<T*>(dq), sq, sk, h, hk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dd, void* dq, void* dk,
             void* dv, int b, int sq, int sk, int h, int hk, int d,
             float scale, int causal, void* stream) {
  if (b == 0 || sq == 0 || sk == 0 || h == 0) return 0;
  if (hk == 0 || h % hk) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ls = static_cast<const float*>(lse);
  auto* ddf = static_cast<float*>(dd);
  switch (d) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, dout, ls, ddf, dq, dk, dv,
                                      b, sq, sk, h, hk, scale, causal, st);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dout, ls, ddf, dq, dk, dv,
                                      b, sq, sk, h, hk, scale, causal, st);
    case 96: return launch_bwd<T, 96>(q, k, v, o, dout, ls, ddf, dq, dk, dv,
                                      b, sq, sk, h, hk, scale, causal, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, ls, ddf, dq, dk, dv, b, sq,
                                sk, h, hk, scale, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dq, dk, dv of csrc/flash_attention.cu's prefill function (q_offset 0),
// all tensors contiguous:
// q, o, dout, dq [b, sq, h, d]; k, v, dk, dv [b, sk, hk, d], in one dtype;
// lse [b, h, sq] from the forward; dd, fp32 scratch of b * h * sq floats.
#define B9_BWD_ARGS                                                      \
  const void *q, const void *k, const void *v, const void *o,            \
      const void *dout, const void *lse, void *dd, void *dq, void *dk,   \
      void *dv, int b, int sq, int sk, int h, int hk, int d, float scale, \
      int causal, void *stream
