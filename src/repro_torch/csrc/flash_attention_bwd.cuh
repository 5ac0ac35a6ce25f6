#pragma once

#include <math.h>

#include <type_traits>

#include "b9_common.cuh"

namespace {

// B9's gradient, replacing no TPU kernel: the reference's Pallas B9
// (repro/kernels/flash_attention.py) has no backward, and its model
// trains through XLA's autodiff of `chunked_attention`
// (repro/models/layers.py:149). This computes the same dQ, dK and dV of
// csrc/flash_attention.cu's prefill function (causal or full, GQA,
// q_offset 0, with gemma2's softcap and sliding window), so that
// training's forward can run on B9.
//
// FlashAttention-2's backward, made deterministic: no float is summed
// with atomics, and every sum runs in one fixed order. q, k, v, o, dO
// contiguous [B, S, H(K), D] in the input dtype; the forward's per-row
// log-sum-exp `lse` [B, H, Sq] (natural units) recomputes
// P = exp(s - lse) with no running max, s the logit as the forward's own
// design computed it: x = q.k scale, and with a softcap c > 0,
// s = c tanh(x / c) (tanhf; the tensor-core design multiplies by the
// forward's correctly rounded 1/c). Three kernels:
//  1. `bwd_dot` / `bwd_dot_mma`: Dd[b, h, i] = sum_d dO[i, d] O[i, d],
//     summed in the very order the kernels below sum dP (fp32: one fmaf
//     chain over d; bf16: the same tensor-core chain, once for each of
//     kernels 2 and 3). In a row that sees one key O is that key's V, bit
//     for bit, so dP - Dd is exactly 0 there, as the reference's autodiff
//     gives (its softmax VJP subtracts sum_k P dP, which is dP when P is
//     1): the kernels then leave dQ and dK exactly 0, not noise.
//  2. dK and dV: one block per (key tile of 64, KV head, batch). For each
//     query head of the GQA group in order, and each query tile that sees
//     the key tile (causal: from the diagonal on; with a window W, up to
//     the last tile holding a query q with q - key < W for a key of the
//     tile) in order, it recomputes S = Q K^T and dP = dO V^T, P, dS = P
//     (dP - Dd), times 1 - t^2 with t = tanh(x / c) under a softcap, and
//     accumulates dV += P^T dO and dK += dS^T Q in registers. dK is
//     scaled once at the end.
//  3. dQ: one block per (query tile of 64, head, batch), the longest
//     causal tiles first. It loops over the key tiles the rows see (with
//     a window, from the tile holding the first key its first row sees,
//     as the forward's `window_start`), recomputes P and dS the same way,
//     and accumulates dQ += dS K.
// S and dP are computed twice (kernels 2 and 3): the price of writing dQ
// with no atomics. Rows that see no key (queries past Sq; the forward
// writes lse 0 for them) give P = 0, so dQ 0. Softcap and window are
// runtime arguments: one branch a tile picks the capped instructions, so
// the uncapped tile runs without them, and masks by the window apply on
// edge tiles only. Head dims 16, 64, 96 and 128 (the configs' and the
// smoke's); a source of its own (csrc/flash_attention_bwd.cu), so it
// builds beside the forward's.
//
// Bound on the H100: operations (5 products over the visible (query, key)
// pairs at the least, against 2 bytes an element read). Two designs, by dtype:
//
// bf16, `bwd_dkdv_mma` and `bwd_dq_mma`: the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate), built from the bf16 prefill's
// parts (csrc/b9_common.cuh). Blocks of 4 warps, 16 rows a warp: keys in
// kernel 2, queries in kernel 3. Kernel 2 stages the K and V tile in
// shared memory once (bf16, rows padded by 16 bytes for ldmatrix) and
// holds their A fragments in registers where they fit (D <= 96; at D =
// 128 the dK and dV accumulators take 128 registers a thread, so the
// fragments are read again from shared memory each step); the Q, dO, lse
// and Dd tiles of the query loop are double-buffered with cp.async, so
// the next loads while this one computes. Each warp computes S^T = K Q^T
// and dP^T = V dO^T, 16 or 32 queries at a time (`dkdv_cols`): keys are
// the rows, so P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - Dd) sit
// in the accumulator layout that repacks into A fragments in registers,
// and dV += P^T dO, dK += dS^T Q take dO and Q by ldmatrix.trans. P and
// dS never touch shared memory. Kernel 3 holds Q and dO as A fragments
// for the whole key loop, double-buffers the K and V tiles, computes
// S = Q K^T and dP = dO V^T 32 keys at a time and dQ += dS K (K by
// ldmatrix.trans). Causal and Sq / Sk masks on edge tiles only.
// Precision: P and dS, where they are an A operand, go in three bf16
// terms (hi, mid, lo: csrc/b9_common.cuh `split_bf16`) that carry their
// fp32 value exactly, the small terms first; products of bf16 values are
// exact in the fp32 accumulator, so S and dP (bf16 operands already)
// need no split. Two terms would leave up to 2^-17 of each P and dS: the
// forward found that puts outputs near zero beyond its rule
// (csrc/flash_attention.cu), and the CPU model of these kernels
// (tests/test_torch_flash_bwd_split.py) puts two-term gradients 3e-6 of
// their magnitude from jax.grad's, beyond the 2e-6 the plain version is
// held to there (three terms: 2e-7 to 1e-6). Three cost 13 products'
// worth of tensor-core work (S and dP twice, dV, dK and dQ three times
// each). exp is 2^x on the special-function unit of (S scale - lse)
// log2 e (~2^-22 relative).
//
// fp32, `bwd_dkdv` and `bwd_dq`: the scalar fp32 pipes (explicit fmaf),
// tiles widened to fp32 and stored transposed in shared memory. Thread
// (ty, tx) of 16 x 16 computes S and dP of rows 4 ty .. 4 ty + 3 and keys
// tx + 16 j; the accumulations give each thread 4 keys (rows) tx + 16 i
// and head dims ty + 16 j. Tiles are stored transposed ([D][68]: 16-byte
// rows for float4 reads, columns read by 16 lanes in 16 banks) and P, dS
// as [64][68]. 7 products on the fp32 pipes (a 3xTF32 design on the
// tensor cores is the way on, ROADMAP B).

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

constexpr int kDotRows = 32;        // rows a block of the fp32 bwd_dot
constexpr int kDotThreads = 128;

// fp32: Dd as one fmaf chain over d = 0 .. D - 1 from 0, the chain
// `bwd_scores` sums dP[i, j] with (kernel 1 above). 32 rows a block,
// staged through shared memory so the loads stay coalesced (rows of D + 1
// floats: the 32 threads read 32 banks), then one thread a row.
template <int D>
__global__ void __launch_bounds__(kDotThreads)
bwd_dot(const float* __restrict__ o, const float* __restrict__ dout,
        float* __restrict__ dd, int b, int sq, int h) {
  __shared__ float so[kDotRows][D + 1], sg[kDotRows][D + 1];
  const long long rows = static_cast<long long>(b) * sq * h;
  const long long r0 = static_cast<long long>(blockIdx.x) * kDotRows;
  for (int u = threadIdx.x; u < kDotRows * D; u += kDotThreads) {
    const int r = u / D, c = u % D;
    const bool in = r0 + r < rows;
    so[r][c] = in ? o[(r0 + r) * D + c] : 0.f;
    sg[r][c] = in ? dout[(r0 + r) * D + c] : 0.f;
  }
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= kDotRows || r0 + r >= rows) return;
  float a = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) a = fmaf(sg[r][d], so[r][d], a);
  const long long row = r0 + r;                 // (b, s, hh) row
  const int hh = static_cast<int>(row % h);
  const long long bs = row / h;
  const int s = static_cast<int>(bs % sq), bb = static_cast<int>(bs / sq);
  dd[(static_cast<long long>(bb) * h + hh) * sq + s] = a;
}

// S and dP of the tile: rows 4 ty + i, keys tx + 16 j; P and dS from them.
// The softcap's branch holds the whole tile.
template <int D>
__device__ __forceinline__ void bwd_scores(
    const float* __restrict__ Qt, const float* __restrict__ dOt,
    const float* __restrict__ Kt, const float* __restrict__ Vt,
    const float* __restrict__ lse_s, const float* __restrict__ dd_s,
    int q0, int k0, int sq, int sk, int causal, float scale, float softcap,
    int window, float (&p)[4][4], float (&ds)[4][4]) {
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
  auto tile = [&](auto cap) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, q = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + kBwdT * j;
        const bool seen = q < sq && key < sk && (!causal || key <= q)
                          && (!window || q - key < window);
        const float x = __fmul_rn(s[i][j], scale);
        if constexpr (decltype(cap)::value) {
          // the forward's `soft_cap`: c tanh(x / c)
          const float t = tanhf(__fdiv_rn(x, softcap));
          p[i][j] = seen ? expf(__fsub_rn(__fmul_rn(softcap, t), lse_s[r]))
                         : 0.f;
          ds[i][j] = __fmul_rn(__fmul_rn(p[i][j],
                                         __fsub_rn(dp[i][j], dd_s[r])),
                               __fmul_rn(__fsub_rn(1.f, t),
                                         __fadd_rn(1.f, t)));
        } else {
          p[i][j] = seen ? expf(__fsub_rn(x, lse_s[r])) : 0.f;
          ds[i][j] = __fmul_rn(p[i][j], __fsub_rn(dp[i][j], dd_s[r]));
        }
      }
    }
  };
  if (softcap > 0.f) tile(std::true_type{});
  else tile(std::false_type{});
}

// the last query tile of `nqt` (tiles of `bq` rows) that sees a key of
// [k0, k0 + bk): every one with a window W (query q sees key j iff
// q - j < W), so the tile of query k0 + bk - 2 + W at the latest
__device__ __forceinline__ int last_query_tile(int k0, int bk, int bq,
                                               int nqt, int window) {
  if (!window) return nqt - 1;
  const long long t = (static_cast<long long>(k0) + bk - 2 + window) / bq;
  return t < nqt - 1 ? static_cast<int>(t) : nqt - 1;
}

template <typename T, int D>
__global__ void __launch_bounds__(kBwdThreads)
bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
         const T* __restrict__ v, const T* __restrict__ dout,
         const float* __restrict__ lse, const float* __restrict__ dd,
         T* __restrict__ dk, T* __restrict__ dv, int sq, int sk, int h,
         int hk, float scale, int causal, float softcap, int window) {
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
  const int last = last_query_tile(k0, kBwdB, kBwdB, nqt, window);
  for (int r = 0; r < g; ++r) {
    const int hh = kh * g + r;
    for (int qt = first; qt <= last; ++qt) {
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
                    scale, softcap, window, p, ds);
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
       int causal, float softcap, int window) {
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
  // with a window, from the tile of the first key row q0 sees
  const int kbeg = window_start(q0, window, kend, kBwdB);

  float aq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) aq[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kBwdB) {
    __syncthreads();   // Q staged; the previous tile's K, V, dS all read
    load_tile_t<T, D>(k + (static_cast<long long>(b) * sk * hk + kh) * D,
                      Kt, k0, sk, static_cast<long long>(hk) * D);
    load_tile_t<T, D>(v + (static_cast<long long>(b) * sk * hk + kh) * D,
                      Vt, k0, sk, static_cast<long long>(hk) * D);
    __syncthreads();
    float p[4][4], ds[4][4];
    bwd_scores<D>(Qt, dOt, Kt, Vt, lse_s, dd_s, q0, k0, sq, sk, causal,
                  scale, softcap, window, p, ds);
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

// ---- bf16 on the tensor cores

constexpr int kMmaBwdWarps = 4;
constexpr int kMmaBwdThreads = 32 * kMmaBwdWarps;
constexpr int kMmaBwdB = 16 * kMmaBwdWarps;  // rows: keys, or queries
// blocks an SM, for __launch_bounds__ (what shared memory holds at D >=
// 96): without it ptxas capped dQ at 168 registers, to fit three, and
// spilled; the gradient ran 5 % slower (H100, tools/b9bwd_time.py
// --variants)
constexpr int kMmaBwdMinBlocks = 2;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kMmaBwdThreads == 2 * kMmaBwdB, "one thread per lse and Dd");

// bf16 elements per shared-memory row: D plus 16 bytes, so the 8 rows an
// ldmatrix reads start in 8 distinct 16-byte bank groups (D / 8 is even)
template <int D>
__host__ __device__ constexpr int bwd_mma_ld() { return D + 8; }

template <int D>
constexpr int bwd_dkdv_mma_smem() {   // K, V, 2 x (Q, dO); 2 x (lse, Dd)
  return 6 * kMmaBwdB * bwd_mma_ld<D>() * 2 + 4 * kMmaBwdB * 4;
}

template <int D>
constexpr int bwd_dq_mma_smem() {     // Q, dO, 2 x (K, V)
  return 6 * kMmaBwdB * bwd_mma_ld<D>() * 2;
}

// rows [r0, r0 + 64) of x (row stride rs elements) into the bf16 tile
// dst [64][LD] by 16-byte cp.async; rows at or past n are zero-filled
template <int D>
__device__ __forceinline__ void stage_rows(uint16_t* dst, const uint16_t* x,
                                           int r0, int n, long long rs) {
  constexpr int LD = bwd_mma_ld<D>(), U = D / 8;
  for (int u = threadIdx.x; u < kMmaBwdB * U; u += kMmaBwdThreads) {
    const int r = u / U, d8 = (u % U) * 8;
    const bool in = r0 + r < n;
    cp_async16(dst + r * LD + d8,
               in ? x + static_cast<long long>(r0 + r) * rs + d8 : x, in);
  }
}

// Columns of S a step computes (C: 16 or 32) and whether dK / dV hold
// K's and V's A fragments in registers, by head dim. A thread holds D / 2
// dK and D / 2 dV accumulators, C / 2 of S and dP, and D / 2 registers of
// K and V fragments: with 32 columns, ptxas spilled at D = 96 with the
// fragments and at D = 128 without them. D = 96 with the fragments and
// 16 columns (252 registers) ran 3 % faster than without them and 32
// columns (228); D = 128 reads K and V from shared memory every step
// (H100, nvcc 12.8, tools/b9bwd_time.py --variants)
template <int D>
__host__ __device__ constexpr int dkdv_cols() { return D >= 96 ? 16 : 32; }
template <int D>
__host__ __device__ constexpr bool dkdv_kv_regs() { return D <= 96; }
constexpr int kDqCols = 32;

// s = A1 X^T and p = A2 Y^T for this warp's 16 rows and C columns: X and
// Y rows c0 .. c0 + C - 1 of [.][LD] bf16 tiles (ldmatrix), A1 and A2 the
// A fragments `afrag(ks, a1, a2)` gives for k-step ks; C / 8 tiles of 8
// columns each, in the accumulator layout
template <int D, int C, typename FA>
__device__ __forceinline__ void scores_mma(const FA& afrag,
                                           const uint16_t* X,
                                           const uint16_t* Y, int c0,
                                           float (&s)[C / 8][4],
                                           float (&p)[C / 8][4]) {
  constexpr int LD = bwd_mma_ld<D>();
  const int lane = threadIdx.x & 31;
  const int r = c0 + (lane & 7) + ((lane >> 4) << 3);
  const int c = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int j = 0; j < C / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = p[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a1[4], a2[4];
    afrag(ks, a1, a2);
#pragma unroll
    for (int np = 0; np < C / 16; ++np) {
      uint32_t bx[4], by[4];
      ldmatrix_x4(bx, X + (r + np * 16) * LD + ks * 16 + c);
      ldmatrix_x4(by, Y + (r + np * 16) * LD + ks * 16 + c);
      mma_bf16(s[2 * np], a1, bx[0], bx[1]);
      mma_bf16(s[2 * np + 1], a1, bx[2], bx[3]);
      mma_bf16(p[2 * np], a2, by[0], by[1]);
      mma_bf16(p[2 * np + 1], a2, by[2], by[3]);
    }
  }
}

// acc += x Z for this warp's 16 rows: x the 16 x C values in the
// accumulator layout (tiles 2 kk and 2 kk + 1 make the A fragment of
// k-step kk), each split into three bf16 terms, the small ones first so
// they are not lost beside the large; Z rows c0 .. c0 + C - 1 of a
// [.][LD] bf16 tile, by ldmatrix.trans
template <int D, int C>
__device__ __forceinline__ void accum_mma(float (&acc)[D / 8][4],
                                          const float (&x)[C / 8][4],
                                          const uint16_t* Z, int c0) {
  constexpr int LD = bwd_mma_ld<D>();
  const int lane = threadIdx.x & 31;
  const int r = c0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    uint32_t hi[4], mid[4], lo[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], mid[0], lo[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], mid[1], lo[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], mid[2], lo[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], mid[3], lo[3]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t z[4];
      ldmatrix_x4_trans(z, Z + (r + kk * 16) * LD + dp * 16 + c);
      mma_bf16(acc[2 * dp], lo, z[0], z[1]);
      mma_bf16(acc[2 * dp], mid, z[0], z[1]);
      mma_bf16(acc[2 * dp], hi, z[0], z[1]);
      mma_bf16(acc[2 * dp + 1], lo, z[2], z[3]);
      mma_bf16(acc[2 * dp + 1], mid, z[2], z[3]);
      mma_bf16(acc[2 * dp + 1], hi, z[2], z[3]);
    }
  }
}

// P = exp(s scale - lse), computed as 2^((s scale - lse) log2 e)
__device__ __forceinline__ float prob(float s, float scale, float lse) {
  return exp2_approx(__fmul_rn(__fsub_rn(__fmul_rn(s, scale), lse), kLog2e));
}

// P and dS of one logit, s = q.k and dp = dO.v: P as `prob`, 0 where
// `hidden`, and dS = P (dP - Dd); under the softcap (CAP) the logit is
// c tanh(s scale (1/c)) as the bf16 forward computes it (`rcap` its
// correctly rounded 1/c), and dS is also multiplied by
// 1 - t^2 = (1 - t)(1 + t), t that tanh: the derivative of c tanh(x / c)
template <bool CAP>
__device__ __forceinline__ void p_ds(float s, float dp, float lse, float dd,
                                     float scale, float softcap, float rcap,
                                     bool hidden, float& p, float& ds) {
  if constexpr (CAP) {
    const float t = tanhf(__fmul_rn(__fmul_rn(s, scale), rcap));
    p = hidden ? 0.f
               : exp2_approx(__fmul_rn(
                     __fsub_rn(__fmul_rn(softcap, t), lse), kLog2e));
    ds = __fmul_rn(__fmul_rn(p, __fsub_rn(dp, dd)),
                   __fmul_rn(__fsub_rn(1.f, t), __fadd_rn(1.f, t)));
  } else {
    p = hidden ? 0.f : prob(s, scale, lse);
    ds = __fmul_rn(p, __fsub_rn(dp, dd));
  }
}

// bf16: Dd twice, each summed as the tensor cores sum dP in the kernel
// that reads it (kernel 1 above): dd[i] the diagonal of dO O^T (A = dO,
// B = O, as `bwd_dq_mma`'s dP = dO V^T) and dd[n + i], n = b h sq, that
// of O dO^T (as `bwd_dkdv_mma`'s dP^T = V dO^T): one m16n8k16 chain over
// the k-steps 0 .. D / 16 - 1 from 0, fragments in the layout ldmatrix
// gives those kernels. A warp takes 16 rows and loads their fragments
// straight from global memory (bf16 pairs); row g's diagonal lands in the
// lane whose t is g / 2 (column g = 2t + g % 2 of the first 8-column
// tile), row g + 8's in the same lane's second tile. At q, dO [2, 4096,
// 32, 96] it takes 0.095 ms where the shuffle-tree dot it replaced took
// 0.053 (H100, tools/b9bwd_time.py, both checkouts by one clock).
template <int D>
__global__ void __launch_bounds__(kMmaBwdThreads)
bwd_dot_mma(const uint16_t* __restrict__ o,
            const uint16_t* __restrict__ dout, float* __restrict__ dd,
            int b, int sq, int h) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long n = static_cast<long long>(b) * sq * h;
  const long long w0 =
      (static_cast<long long>(blockIdx.x) * kMmaBwdWarps + warp) * 16;
  if (w0 >= n) return;                        // the whole warp
  const long long r_lo = w0 + g, r_hi = r_lo + 8;
  auto ld = [&](const uint16_t* x, long long r, int c) -> uint32_t {
    return r < n ? *reinterpret_cast<const uint32_t*>(x + r * D + c) : 0u;
  };
  float cq[2][4], ck[2][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) cq[0][e] = cq[1][e] = ck[0][e] = ck[1][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    const uint32_t ga[4] = {ld(dout, r_lo, c), ld(dout, r_hi, c),
                            ld(dout, r_lo, c + 8), ld(dout, r_hi, c + 8)};
    const uint32_t oa[4] = {ld(o, r_lo, c), ld(o, r_hi, c),
                            ld(o, r_lo, c + 8), ld(o, r_hi, c + 8)};
    mma_bf16(cq[0], ga, oa[0], oa[2]);        // O rows 0-7 as B
    mma_bf16(cq[1], ga, oa[1], oa[3]);        // O rows 8-15
    mma_bf16(ck[0], oa, ga[0], ga[2]);
    mma_bf16(ck[1], oa, ga[1], ga[3]);
  }
  if (t != g >> 1) return;
  const int e = g & 1;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long row = half ? r_hi : r_lo;  // (b, s, hh) row
    if (row >= n) continue;
    const int hh = static_cast<int>(row % h);
    const long long bs = row / h;
    const int s = static_cast<int>(bs % sq), bb = static_cast<int>(bs / sq);
    const long long i = (static_cast<long long>(bb) * h + hh) * sq + s;
    dd[i] = cq[half][2 * half + e];
    dd[n + i] = ck[half][2 * half + e];
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaBwdThreads, kMmaBwdMinBlocks)
bwd_dkdv_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
             const uint16_t* __restrict__ v,
             const uint16_t* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dd,
             uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int sq,
             int sk, int h, int hk, float scale, int causal, float softcap,
             int window) {
  constexpr int LD = bwd_mma_ld<D>(), KS = D / 16, DT = D / 8;
  constexpr int B = kMmaBwdB, C = dkdv_cols<D>();
  constexpr bool kv_regs = dkdv_kv_regs<D>();
  extern __shared__ __align__(16) uint16_t smh[];
  uint16_t* Ks = smh;
  uint16_t* Vs = Ks + B * LD;
  uint16_t* Qs = Vs + B * LD;       // [2][B][LD]
  uint16_t* Gs = Qs + 2 * B * LD;   // dO, [2][B][LD]
  float* Ls = reinterpret_cast<float*>(Gs + 2 * B * LD);   // lse [2][B]
  float* Ds = Ls + 2 * B;                                  // Dd [2][B]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int k0 = blockIdx.x * B, kh = blockIdx.y, b = blockIdx.z;
  const int grp = h / hk;
  const long long krs = static_cast<long long>(hk) * D;
  const long long qrs = static_cast<long long>(h) * D;
  const long long koff = (static_cast<long long>(b) * sk * hk + kh) * D;
  stage_rows<D>(Ks, k + koff, k0, sk, krs);
  stage_rows<D>(Vs, v + koff, k0, sk, krs);
  const int nqt = (sq + B - 1) / B;
  const int first = causal ? k0 / B : 0;   // q_offset 0: rows >= k0
  const int last = last_query_tile(k0, B, B, nqt, window);
  const int per = last >= first ? last - first + 1 : 0;
  const int n = grp * per;   // the group's heads in order, then query tiles
  auto load_step = [&](int it, int buf) {
    const int hh = kh * grp + it / per, q0 = (first + it % per) * B;
    const long long qoff = (static_cast<long long>(b) * sq * h + hh) * D;
    stage_rows<D>(Qs + buf * B * LD, q + qoff, q0, sq, qrs);
    stage_rows<D>(Gs + buf * B * LD, dout + qoff, q0, sq, qrs);
    const long long row = (static_cast<long long>(b) * h + hh) * sq + q0;
    const int r = tid % B;
    const bool in = q0 + r < sq;
    if (tid < B) cp_async4(Ls + buf * B + r, in ? lse + row + r : lse, in);
    else cp_async4(Ds + buf * B + r, in ? dd + row + r : dd, in);
  };
  if (n > 0) load_step(0, 0);
  cp_async_commit();

  float adk[DT][4], adv[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;
  uint32_t kf[kv_regs ? KS : 1][4], vf[kv_regs ? KS : 1][4];
  const int arow = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  auto afrag = [&](int ks, uint32_t (&a1)[4], uint32_t (&a2)[4]) {
    if constexpr (kv_regs) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a1[i] = kf[ks][i];
        a2[i] = vf[ks][i];
      }
    } else {
      ldmatrix_x4(a1, Ks + arow + ks * 16);
      ldmatrix_x4(a2, Vs + arow + ks * 16);
    }
  };
  // keys of rows g and g + 8 of this warp's 16
  const int key_lo = k0 + warp * 16 + (lane >> 2), key_hi = key_lo + 8;
  const bool capped = softcap > 0.f;
  const float rcap = capped ? __frcp_rn(softcap) : 0.f;

  for (int it = 0; it < n; ++it) {
    const int buf = it & 1;
    if (it + 1 < n) load_step(it + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (kv_regs) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          ldmatrix_x4(kf[ks], Ks + arow + ks * 16);
          ldmatrix_x4(vf[ks], Vs + arow + ks * 16);
        }
      }
    }
    const int q0 = (first + it % per) * B;
    const uint16_t* Qt = Qs + buf * B * LD;
    const uint16_t* Gt = Gs + buf * B * LD;
    const float* Lt = Ls + buf * B;
    const float* Dt = Ds + buf * B;
    const bool edge = q0 + B > sq || k0 + B > sk
                      || (causal && q0 < k0 + B - 1)
                      || (window && q0 + B - 1 - k0 >= window);
#pragma unroll 1
    for (int c0 = 0; c0 < B; c0 += C) {
      // S^T = K Q^T and dP^T = V dO^T: keys (rows) x C queries
      float st[C / 8][4], pt[C / 8][4];
      scores_mma<D, C>(afrag, Qt, Gt, c0, st, pt);
      // P^T into st, dS^T into pt; the softcap's branch holds the tile
      auto tile = [&](auto cap) {
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = c0 + j * 8 + 2 * t + (e & 1);
            bool hidden = false;
            if (edge) {
              const int key = e < 2 ? key_lo : key_hi, pos = q0 + qc;
              hidden = pos >= sq || key >= sk || (causal && key > pos)
                       || (window && pos - key >= window);
            }
            p_ds<decltype(cap)::value>(st[j][e], pt[j][e], Lt[qc], Dt[qc],
                                       scale, softcap, rcap, hidden,
                                       st[j][e], pt[j][e]);
          }
        }
      };
      if (capped) tile(std::true_type{});
      else tile(std::false_type{});
      accum_mma<D, C>(adv, st, Gt, c0);   // dV += P^T dO
      accum_mma<D, C>(adk, pt, Qt, c0);   // dK += dS^T Q
    }
    __syncthreads();   // this buffer is refilled two steps on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = key_lo + 8 * half;
    if (key >= sk) continue;
    const long long base =
        ((static_cast<long long>(b) * sk + key) * hk + kh) * D;
    uint32_t* krow = reinterpret_cast<uint32_t*>(dk + base);
    uint32_t* vrow = reinterpret_cast<uint32_t*>(dv + base);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      krow[j * 4 + t] = pack_bf16(__fmul_rn(adk[j][2 * half], scale),
                                  __fmul_rn(adk[j][2 * half + 1], scale));
      vrow[j * 4 + t] = pack_bf16(adv[j][2 * half], adv[j][2 * half + 1]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaBwdThreads, kMmaBwdMinBlocks)
bwd_dq_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
           const uint16_t* __restrict__ v, const uint16_t* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dd,
           uint16_t* __restrict__ dq, int sq, int sk, int h, int hk,
           float scale, int causal, float softcap, int window) {
  constexpr int LD = bwd_mma_ld<D>(), KS = D / 16, DT = D / 8;
  constexpr int B = kMmaBwdB, C = kDqCols;
  extern __shared__ __align__(16) uint16_t smh[];
  uint16_t* Qs = smh;
  uint16_t* Gs = Qs + B * LD;       // dO
  uint16_t* Ks = Gs + B * LD;       // [2][B][LD]
  uint16_t* Vs = Ks + 2 * B * LD;   // [2][B][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  // the longest causal tiles first, so the short ones fill the tail
  const int q0 = (gridDim.x - 1 - blockIdx.x) * B;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kh = hh / (h / hk);
  const int rows = min(B, sq - q0);
  const long long qrs = static_cast<long long>(h) * D;
  const long long krs = static_cast<long long>(hk) * D;
  const long long qoff = (static_cast<long long>(b) * sq * h + hh) * D;
  const long long koff = (static_cast<long long>(b) * sk * hk + kh) * D;
  stage_rows<D>(Qs, q + qoff, q0, sq, qrs);
  stage_rows<D>(Gs, dout + qoff, q0, sq, qrs);
  const int kend = causal ? min(sk, q0 + rows) : sk;
  const int ntiles = (kend + B - 1) / B;
  // with a window, from the tile of the first key row q0 sees
  const int t0 = window_start(q0, window, kend, B) / B;
  auto load_tile = [&](int tile, int buf) {
    stage_rows<D>(Ks + buf * B * LD, k + koff, tile * B, kend, krs);
    stage_rows<D>(Vs + buf * B * LD, v + koff, tile * B, kend, krs);
  };
  if (t0 < ntiles) load_tile(t0, 0);
  cp_async_commit();
  const bool capped = softcap > 0.f;
  const float rcap = capped ? __frcp_rn(softcap) : 0.f;

  // rows g and g + 8 of this warp's 16
  const int r_lo = warp * 16 + (lane >> 2), r_hi = r_lo + 8;
  const long long lrow = (static_cast<long long>(b) * h + hh) * sq + q0;
  const float lse_lo = r_lo < rows ? lse[lrow + r_lo] : 0.f;
  const float lse_hi = r_hi < rows ? lse[lrow + r_hi] : 0.f;
  const float dd_lo = r_lo < rows ? dd[lrow + r_lo] : 0.f;
  const float dd_hi = r_hi < rows ? dd[lrow + r_hi] : 0.f;
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[KS][4], gf[KS][4];
  auto afrag = [&](int ks, uint32_t (&a1)[4], uint32_t (&a2)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a1[i] = qf[ks][i];
      a2[i] = gf[ks][i];
    }
  };

  for (int tile = t0; tile < ntiles; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < ntiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (tile == t0) {
      const int arow = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        ldmatrix_x4(qf[ks], Qs + arow + ks * 16);
        ldmatrix_x4(gf[ks], Gs + arow + ks * 16);
      }
    }
    const int k0 = tile * B;
    const uint16_t* Kt = Ks + buf * B * LD;
    const uint16_t* Vt = Vs + buf * B * LD;
    const bool edge = k0 + B > kend || (causal && k0 + B - 1 > q0)
                      || (window && q0 + B - 1 - k0 >= window);
#pragma unroll 1
    for (int c0 = 0; c0 < B; c0 += C) {
      // S = Q K^T and dP = dO V^T: queries (rows) x C keys
      float s[C / 8][4], dp[C / 8][4];
      scores_mma<D, C>(afrag, Kt, Vt, c0, s, dp);
      // dS into s; the softcap's branch holds the tile
      auto tile_ds = [&](auto cap) {
#pragma unroll
        for (int j = 0; j < C / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e >= 2;
            bool hidden = false;
            if (edge) {
              const int key = k0 + c0 + j * 8 + 2 * t + (e & 1);
              const int pos = q0 + (hi ? r_hi : r_lo);
              hidden = key >= kend || (causal && key > pos)
                       || (window && pos - key >= window);
            }
            float p;
            p_ds<decltype(cap)::value>(s[j][e], dp[j][e],
                                       hi ? lse_hi : lse_lo,
                                       hi ? dd_hi : dd_lo, scale, softcap,
                                       rcap, hidden, p, s[j][e]);
          }
        }
      };
      if (capped) tile_ds(std::true_type{});
      else tile_ds(std::false_type{});
      accum_mma<D, C>(acc, s, Kt, c0);   // dQ += dS K
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r_hi : r_lo;
    if (r >= rows) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        dq + ((static_cast<long long>(b) * sq + q0 + r) * h + hh) * D);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      orow[j * 4 + t] = pack_bf16(__fmul_rn(acc[j][2 * half], scale),
                                  __fmul_rn(acc[j][2 * half + 1], scale));
  }
}

// ---- launch

// the gradient's runtime arguments past the shapes
struct BwdOpts {
  float scale;
  int causal;
  float softcap;   // 0: none
  int window;      // 0: none; else only with causal
};

template <int D>
int launch_bwd_mma(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const float* lse,
                   float* dd, void* dq, void* dk, void* dv, int b, int sq,
                   int sk, int h, int hk, const BwdOpts& a,
                   cudaStream_t stream) {
  static bool done_kv[64], done_q[64];
  auto kkv = bwd_dkdv_mma<D>;
  auto kq = bwd_dq_mma<D>;
  cudaError_t err = allow_smem(kkv, bwd_dkdv_mma_smem<D>(), done_kv);
  if (err == cudaSuccess)
    err = allow_smem(kq, bwd_dq_mma_smem<D>(), done_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = uint16_t;
  const long long n = static_cast<long long>(b) * sq * h;
  bwd_dot_mma<D><<<static_cast<unsigned>((n + kMmaBwdB - 1) / kMmaBwdB),
                   kMmaBwdThreads, 0, stream>>>(
      static_cast<const bf*>(o), static_cast<const bf*>(dout), dd, b, sq, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gkv((sk + kMmaBwdB - 1) / kMmaBwdB, hk, b);
  kkv<<<gkv, kMmaBwdThreads, bwd_dkdv_mma_smem<D>(), stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, dd + n,
      static_cast<bf*>(dk), static_cast<bf*>(dv), sq, sk, h, hk, a.scale,
      a.causal, a.softcap, a.window);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gq((sq + kMmaBwdB - 1) / kMmaBwdB, h, b);
  kq<<<gq, kMmaBwdThreads, bwd_dq_mma_smem<D>(), stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), lse, dd,
      static_cast<bf*>(dq), sq, sk, h, hk, a.scale, a.causal, a.softcap,
      a.window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dd, void* dq,
               void* dk, void* dv, int b, int sq, int sk, int h, int hk,
               const BwdOpts& a, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch_bwd_mma<D>(q, k, v, o, dout, lse, dd, dq, dk, dv, b, sq,
                             sk, h, hk, a, stream);
  } else {
    static bool done_kv[64], done_q[64];
    auto kkv = bwd_dkdv<T, D>;
    auto kq = bwd_dq<T, D>;
    cudaError_t err = allow_smem(kkv, bwd_dkdv_smem<D>(), done_kv);
    if (err == cudaSuccess) err = allow_smem(kq, bwd_dq_smem<D>(), done_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long n = static_cast<long long>(b) * sq * h;
    bwd_dot<D><<<static_cast<unsigned>((n + kDotRows - 1) / kDotRows),
                 kDotThreads, 0, stream>>>(
        static_cast<const float*>(o), static_cast<const float*>(dout), dd, b,
        sq, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 gkv((sk + kBwdB - 1) / kBwdB, hk, b);
    kkv<<<gkv, kBwdThreads, bwd_dkdv_smem<D>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
        static_cast<T*>(dk), static_cast<T*>(dv), sq, sk, h, hk, a.scale,
        a.causal, a.softcap, a.window);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 gq((sq + kBwdB - 1) / kBwdB, h, b);
    kq<<<gq, kBwdThreads, bwd_dq_smem<D>(), stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout), lse, dd,
        static_cast<T*>(dq), sq, sk, h, hk, a.scale, a.causal, a.softcap,
        a.window);
    return static_cast<int>(cudaGetLastError());
  }
}

template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dd, void* dq, void* dk,
             void* dv, int b, int sq, int sk, int h, int hk, int d,
             const BwdOpts& a, void* stream) {
  if (b == 0 || sq == 0 || sk == 0 || h == 0) return 0;
  if (hk == 0 || h % hk || !(a.softcap >= 0.f) || a.window < 0
      || (a.window && !a.causal))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ls = static_cast<const float*>(lse);
  auto* ddf = static_cast<float*>(dd);
  switch (d) {
    case 16: return launch_bwd<T, 16>(q, k, v, o, dout, ls, ddf, dq, dk, dv,
                                      b, sq, sk, h, hk, a, st);
    case 64: return launch_bwd<T, 64>(q, k, v, o, dout, ls, ddf, dq, dk, dv,
                                      b, sq, sk, h, hk, a, st);
    case 96: return launch_bwd<T, 96>(q, k, v, o, dout, ls, ddf, dq, dk, dv,
                                      b, sq, sk, h, hk, a, st);
    case 128:
      return launch_bwd<T, 128>(q, k, v, o, dout, ls, ddf, dq, dk, dv, b, sq,
                                sk, h, hk, a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dq, dk, dv of csrc/flash_attention.cu's prefill function (q_offset 0),
// all tensors contiguous:
// q, o, dout, dq [b, sq, h, d]; k, v, dk, dv [b, sk, hk, d], in one dtype;
// lse [b, h, sq] from the forward (`flash_attention_lse_*` with the same
// softcap and window); dd, fp32 scratch of 2 b h sq floats; softcap >= 0
// and window >= 0 (0: off; a window only with causal).
#define B9_BWD_ARGS                                                      \
  const void *q, const void *k, const void *v, const void *o,            \
      const void *dout, const void *lse, void *dd, void *dq, void *dk,   \
      void *dv, int b, int sq, int sk, int h, int hk, int d, float scale, \
      int causal, float softcap, int window, void *stream
