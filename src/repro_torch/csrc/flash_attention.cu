// B9 flash attention, replacing repro/kernels/flash_attention.py
// `flash_attention` (its Pallas kernel `_flash_kernel`): online-softmax
// attention with GQA and a causal mask by position, and gemma2's logit
// softcap and sliding window (the reference model's `_attn_core`,
// repro/models/layers.py:121-146).
//
//   q [B, Sq, H, D], k and v [B, Sk, HK, D], fp32 or bf16 (all three
//   alike), read in place through their strides (the last dimension
//   contiguous); out [B, Sq, H, D] contiguous, in q's dtype. Query head h
//   reads KV head h / (H / HK). Query row i sits at position q_offset + i;
//   with `causal`, key j is visible to it iff j <= q_offset + i. Keys at
//   or past Sk are never read (the reference pads them with zeros, and
//   without `causal` leaves the zeros in its softmax; here they are
//   masked). With a `window` W > 0 (only with `causal`) key j is visible
//   to row i only if q_offset + i - j < W as well. logits = (q . k) *
//   scale in fp32, and with a `softcap` c > 0, c tanh(logits / c) (tanhf,
//   correctly rounded division and product, as the plain version's
//   ops); a running max m, normalizer l and fp32 accumulator of p * v
//   per query row; out = acc / max(l, 1e-30), rounded to q's dtype. A
//   row that sees no key gives 0. Softcap and window are runtime
//   arguments, so they add no instance.
//
// Bound on the H100: operations for prefill (4 D flops per visible
// (query, key) pair against 2 bytes per element read), bytes for decode
// (one query row streams its whole K and V prefix). Three designs, by
// dtype and query count:
//
// bf16 prefill (Sq > 16), `flash_kernel_mma`: FlashAttention-2 shaped, on
// the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate). One
// block of 4 warps per (64-query tile, head, batch), 16 rows a warp. Q is
// staged once in shared memory and held in registers as A fragments
// (ldmatrix) for the whole key loop; K and V tiles of 64 keys stay bf16
// in shared memory, double-buffered with 16-byte cp.async copies, rows
// padded by 16 bytes so ldmatrix hits no bank twice. S = Q K^T in fp32;
// scale (times log2 e), the causal and Sk masks (on the diagonal tile
// only) and the online softmax per row in fp32, with quad shuffles and
// 2^x on the special-function unit: its error on p is ~2^-22 relative
// plus |x| 2^-24 from the folded scale, far inside the bf16 rule (the
// card's tests hold it; expf cost 10 % more time). P . V keeps fp32
// accuracy: P is split into three bf16 terms (hi, mid, lo) that carry
// its 24 bits exactly, all repacked from S's accumulator layout into A
// fragments in registers, and acc += P_lo V + P_mid V + P_hi V (V by
// ldmatrix.trans). Rounding P to one bf16 value would leave a 2^-9
// relative error per term, and two terms 2^-18: enough to put outputs
// near zero beyond one bf16 ulp + 1e-6 of the plain version in rows that
// see few keys (H100: 5 of 50M elements at the serving shape). Three
// terms cost 2x a plain kernel's tensor-core work. Products of bf16
// values are exact in the fp32 accumulator, so Q K^T needs no split.
//
// fp32 prefill (Sq > 16), `flash_kernel`: the scalar fp32 pipes with
// explicit fmaf (the build's --fmad=false only stops implicit
// contraction). One block of 256 threads per (64-query tile, head,
// batch); per tile of 64 keys, K (transposed) and V are staged in shared
// memory widened to fp32; thread (ty, tx) computes the logits of its 4
// rows and keys tx + 16 j, reduces max and sum across its 16 lanes with
// shuffles, writes p to shared memory, then accumulates p * v into head
// dims tx + 16 j of its rows in registers.
//
// Decode (Sq <= 16, both dtypes), `flash_kernel_decode`: the keys are
// split across blocks. One block of 4 warps per (key chunk, KV head and
// row group, batch) holds every query row that reads that KV head (Sq x
// H / HK rows, in groups of R = 1 or 16), so K and V are read once per KV
// head. K and V tiles of 32 keys stream through a 3-stage cp.async ring
// (two tiles in flight); in a tile each warp takes 8 keys, four lanes a
// key (a quarter of D each), so no lane idles. Each warp keeps its own
// online softmax; at the chunk's end the warps combine in index order.
// With one chunk the block writes the output; otherwise it writes fp32
// (m, l, acc[D]) per row to scratch, and the last block of its group
// (an integer ticket, atomicAdd after __threadfence: it decides who
// combines, never what is summed) combines the chunks in chunk order,
// divides and rounds, and resets the ticket for the next call.
//
// The prefill design writes each row's log-sum-exp to `lse` when the
// gradient's forward asks for it (`flash_attention_lse_*`; the served
// forward passes none). The gradient is csrc/flash_attention_bwd.cuh.
//
// Every design consumes keys in a fixed order and sums no float with
// atomics, so every launch gives the same bits. A causal block stops at
// the last key tile any of its rows can see, and with a window starts
// at the tile that holds the first key its first row sees: key tiles
// wholly below every row's window are neither loaded nor computed.
// Prefill launches the longest query tiles first, so the short ones
// fill the tail.
#include <math.h>

#include <type_traits>

#include "b9_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;                 // lanes across keys and head dims
constexpr int kTY = kThreads / kTX;     // row groups
constexpr int kBK = 64;                 // keys per tile
constexpr int kRQ = 4;                  // query rows per thread

// -inf where no key was seen, so exp(s - m) stays 0 and never NaN
__device__ __forceinline__ float finite_or_zero(float m) {
  return m == -INFINITY ? 0.f : m;
}

// gemma2's attention softcap on a scaled logit: c tanh(x / c) for c > 0
__device__ __forceinline__ float soft_cap(float x, float c) {
  return c > 0.f ? __fmul_rn(c, tanhf(__fdiv_rn(x, c))) : x;
}

template <int D>
constexpr int smem_floats() {
  return D * (kTY * kRQ + 4)        // Qs [D][BQ + 4]
         + D * (kBK + 1)            // Ks [D][BK + 1]
         + kBK * D                  // Vs [BK][D]
         + kTY * kRQ * (kBK + 4);   // Ps [BQ][BK + 4]
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int sq,
             int sk, int h, int hk, long long qsb, long long qss,
             long long qsh, long long ksb, long long kss, long long ksh,
             long long vsb, long long vss, long long vsh, float scale,
             int causal, int q_offset, float softcap, int window,
             float* __restrict__ lse) {
  constexpr int BQ = kTY * kRQ;
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
  const float* qb = q + b * qsb + hh * qsh;
  const float* kb = k + b * ksb + kh * ksh;
  const float* vb = v + b * vsb + kh * vsh;

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

  // keys [kbeg, kend) are read; with `causal` no row of the tile sees
  // past position q_offset + q0 + rows - 1, and with a window none below
  // q_offset + q0 - window + 1
  const int kend = causal ? max(0, min(sk, q_offset + q0 + rows)) : sk;
  const int kbeg = window_start(q_offset + q0, window, kend, kBK);

  float m[kRQ], l[kRQ], acc[kRQ][DC];
#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = kbeg; k0 < kend; k0 += kBK) {
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

    float s[kRQ][4];
#pragma unroll
    for (int i = 0; i < kRQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a4 =
          *reinterpret_cast<const float4*>(Qs + d * QLD + ty * kRQ);
      const float a[kRQ] = {a4.x, a4.y, a4.z, a4.w};
      float kk[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = Ks[d * KLD + tx + kTX * j];
#pragma unroll
      for (int i = 0; i < kRQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRQ; ++i) {
      const int qpos = q_offset + q0 + ty * kRQ + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + kTX * j;
        const bool seen = key < kend && (!causal || key <= qpos)
                          && (!window || qpos - key < window);
        s[i][j] = seen ? soft_cap(__fmul_rn(s[i][j], scale), softcap)
                       : -INFINITY;
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
        Ps[(ty * kRQ + i) * PLD + tx + kTX * j] = s[i][j];
    }
    __syncthreads();

    // keys past kend carry p = 0 and zero V rows: the full tile is safe
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float p[kRQ][4];
#pragma unroll
      for (int i = 0; i < kRQ; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(Ps + (ty * kRQ + i) * PLD + c);
        p[i][0] = p4.x; p[i][1] = p4.y; p[i][2] = p4.z; p[i][3] = p4.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int j = 0; j < DC; ++j) {
          const float vv = Vs[(c + cc) * D + tx + kTX * j];
#pragma unroll
          for (int i = 0; i < kRQ; ++i)
            acc[i][j] = fmaf(p[i][cc], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRQ; ++i) {
    const int r = ty * kRQ + i;
    if (lse != nullptr && tx == 0 && r < rows)
      lse[(static_cast<long long>(b) * h + hh) * sq + q0 + r] =
          l[i] > 0.f ? __fadd_rn(m[i], logf(l[i])) : 0.f;
    if (r < rows) {
      const float denom = fmaxf(l[i], 1e-30f);
      float* orow =
          o + ((static_cast<long long>(b) * sq + q0 + r) * h + hh) * D;
#pragma unroll
      for (int j = 0; j < DC; ++j)
        store(orow + tx + kTX * j, __fdiv_rn(acc[i][j], denom));
    }
  }
}

// ---- bf16 prefill on the tensor cores

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaBQ = 16 * kMmaWarps;  // query rows per block
constexpr int kMmaBK = 64;              // keys per tile

// bf16 elements per shared-memory row: D plus 16 bytes, so the 8 rows an
// ldmatrix reads start in 8 distinct 16-byte bank groups (D / 8 is even)
template <int D>
__host__ __device__ constexpr int mma_ld() { return D + 8; }

template <int D>
constexpr int mma_smem_bytes() {
  return (kMmaBQ + 4 * kMmaBK) * mma_ld<D>() * 2;  // Q, 2 x (K, V)
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_kernel_mma(const uint16_t* __restrict__ q,
                 const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 int sq, int sk, int h, int hk, long long qsb, long long qss,
                 long long qsh, long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh, float scale,
                 int causal, int q_offset, float softcap, int window,
                 float* __restrict__ lse) {
  constexpr int LD = mma_ld<D>();
  constexpr int U = D / 8;       // 16-byte units per row
  constexpr int KS = D / 16;     // k-steps of Q . K^T
  constexpr int NT = kMmaBK / 8; // 8-key tiles of S
  constexpr int DT = D / 8;      // 8-dim tiles of the output
  extern __shared__ __align__(16) uint16_t sm[];
  uint16_t* Qs = sm;
  uint16_t* Ks = Qs + kMmaBQ * LD;      // [2][BK][LD]
  uint16_t* Vs = Ks + 2 * kMmaBK * LD;  // [2][BK][LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int kh = hh / (h / hk);
  const int rows = min(kMmaBQ, sq - q0);
  const uint16_t* qb = q + b * qsb + hh * qsh;
  const uint16_t* kb = k + b * ksb + kh * ksh;
  const uint16_t* vb = v + b * vsb + kh * vsh;
  const int kend = causal ? max(0, min(sk, q_offset + q0 + rows)) : sk;
  const int ntiles = (kend + kMmaBK - 1) / kMmaBK;
  // with a window, the first tile holding a key the block's first row
  // sees (no later row sees an earlier key)
  const int t0 = window_start(q_offset + q0, window, kend, kMmaBK) / kMmaBK;
  // logits in base-2 units: exp(x scale) = 2^(x scale log2 e); with a
  // softcap c, exp(c tanh(x scale / c)) = 2^(c tanh(x scale (1/c)) log2 e),
  // 1/c correctly rounded (a division per logit took 53 % longer on an
  // H100 at gemma2's shapes, with the same outputs)
  const bool capped = softcap > 0.f;
  const float scale2 = __fmul_rn(scale, 1.4426950408889634f);
  const float rcap = capped ? __frcp_rn(softcap) : 0.f;

  for (int u = tid; u < kMmaBQ * U; u += kMmaThreads) {
    const int r = u / U, d8 = (u % U) * 8;
    const bool in = r < rows;
    cp_async16(Qs + r * LD + d8,
               in ? qb + static_cast<long long>(q0 + r) * qss + d8 : qb, in);
  }
  auto load_tile = [&](int tile, int buf) {
    const int k0 = tile * kMmaBK;
    uint16_t* kd = Ks + buf * kMmaBK * LD;
    uint16_t* vd = Vs + buf * kMmaBK * LD;
    for (int u = tid; u < kMmaBK * U; u += kMmaThreads) {
      const int c = u / U, d8 = (u % U) * 8;
      const long long key = k0 + c;
      const bool in = key < kend;
      cp_async16(kd + c * LD + d8, in ? kb + key * kss + d8 : kb, in);
      cp_async16(vd + c * LD + d8, in ? vb + key * vss + d8 : vb, in);
    }
  };
  if (t0 < ntiles) load_tile(t0, 0);
  cp_async_commit();

  // rows g and g + 8 of this warp's 16
  const int r_lo = warp * 16 + g;
  const int pos_lo = q_offset + q0 + r_lo, pos_hi = pos_lo + 8;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;
  float acc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[KS][4];

  for (int tile = t0; tile < ntiles; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < ntiles) load_tile(tile + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (tile == t0) {
#pragma unroll
      for (int s = 0; s < KS; ++s)
        ldmatrix_x4(qf[s], Qs + (warp * 16 + (lane & 15)) * LD + s * 16
                               + (lane >> 4) * 8);
    }
    const uint16_t* kt = Ks + buf * kMmaBK * LD;
    const uint16_t* vt = Vs + buf * kMmaBK * LD;

    // S = Q K^T, 16 rows x 64 keys per warp
    float sc[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int s = 0; s < KS; ++s) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD
                            + s * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sc[2 * np], qf[s], kf[0], kf[1]);
        mma_bf16(sc[2 * np + 1], qf[s], kf[2], kf[3]);
      }
    }

    const int k0 = tile * kMmaBK;
    // a tile past Sk, above the first row's diagonal, or below the last
    // row's window is masked key by key
    const bool edge = k0 + kMmaBK > kend
                      || (causal && k0 + kMmaBK - 1 > q_offset + q0)
                      || (window && q_offset + q0 + kMmaBQ - 1 - k0 >= window);
    // the softcap's branch holds a whole tile, so the tile without one
    // runs the uncapped instructions alone
    if (capped) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sc[n][e] = __fmul_rn(
              __fmul_rn(softcap,
                        tanhf(__fmul_rn(__fmul_rn(sc[n][e], scale), rcap))),
              1.4426950408889634f);
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = __fmul_rn(sc[n][e], scale2);
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e];
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int pos = e < 2 ? pos_lo : pos_hi;
          if (key >= kend || (causal && key > pos)
              || (window && pos - key >= window))
            x = -INFINITY;
        }
        sc[n][e] = x;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(sc[n][0], sc[n][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(sc[n][2], sc[n][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float mu_lo = finite_or_zero(mn_lo), mu_hi = finite_or_zero(mn_hi);
    const float al_lo = exp2_approx(__fsub_rn(m_lo, mu_lo));
    const float al_hi = exp2_approx(__fsub_rn(m_hi, mu_hi));
    m_lo = mn_lo;
    m_hi = mn_hi;
    // this thread's share of l; the quad's four shares are summed once,
    // after the key loop
    float rs_lo = 0.f, rs_hi = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      sc[n][0] = exp2_approx(__fsub_rn(sc[n][0], mu_lo));
      sc[n][1] = exp2_approx(__fsub_rn(sc[n][1], mu_lo));
      sc[n][2] = exp2_approx(__fsub_rn(sc[n][2], mu_hi));
      sc[n][3] = exp2_approx(__fsub_rn(sc[n][3], mu_hi));
      rs_lo = __fadd_rn(rs_lo, __fadd_rn(sc[n][0], sc[n][1]));
      rs_hi = __fadd_rn(rs_hi, __fadd_rn(sc[n][2], sc[n][3]));
    }
    l_lo = __fadd_rn(__fmul_rn(l_lo, al_lo), rs_lo);
    l_hi = __fadd_rn(__fmul_rn(l_hi, al_hi), rs_hi);
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      acc[j][0] = __fmul_rn(acc[j][0], al_lo);
      acc[j][1] = __fmul_rn(acc[j][1], al_lo);
      acc[j][2] = __fmul_rn(acc[j][2], al_hi);
      acc[j][3] = __fmul_rn(acc[j][3], al_hi);
    }

    // acc += P_lo V + P_mid V + P_hi V, 16 keys a step; S's accumulator
    // layout of key tiles 2 ks and 2 ks + 1 is the A fragment of step ks
#pragma unroll
    for (int ks = 0; ks < kMmaBK / 16; ++ks) {
      uint32_t ph[4], pm[4], pl[4];
      split_bf16(sc[2 * ks][0], sc[2 * ks][1], ph[0], pm[0], pl[0]);
      split_bf16(sc[2 * ks][2], sc[2 * ks][3], ph[1], pm[1], pl[1]);
      split_bf16(sc[2 * ks + 1][0], sc[2 * ks + 1][1], ph[2], pm[2], pl[2]);
      split_bf16(sc[2 * ks + 1][2], sc[2 * ks + 1][3], ph[3], pm[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (ks * 16 + (lane & 7)
                                    + ((lane >> 3) & 1) * 8) * LD
                                  + dp * 16 + (lane >> 4) * 8);
        // the small terms first, so they are not lost beside the large
        mma_bf16(acc[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(acc[2 * dp], pm, vf[0], vf[1]);
        mma_bf16(acc[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pl, vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], pm, vf[2], vf[3]);
        mma_bf16(acc[2 * dp + 1], ph, vf[2], vf[3]);
      }
    }
    __syncthreads();   // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo = __fadd_rn(l_lo, __shfl_xor_sync(0xffffffffu, l_lo, off));
    l_hi = __fadd_rn(l_hi, __shfl_xor_sync(0xffffffffu, l_hi, off));
  }
  const float den_lo = fmaxf(l_lo, 1e-30f), den_hi = fmaxf(l_hi, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r_lo + 8 * half;
    if (r >= rows) continue;
    const float den = half ? den_hi : den_lo;
    if (lse != nullptr && t == 0) {
      // m is in base-2 units: lse = (m + log2 l) ln 2
      const float lh = half ? l_hi : l_lo, mh = half ? m_hi : m_lo;
      lse[(static_cast<long long>(b) * h + hh) * sq + q0 + r] =
          lh > 0.f ? __fmul_rn(__fadd_rn(mh, log2f(lh)), 0.6931471805599453f)
                   : 0.f;
    }
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        o + ((static_cast<long long>(b) * sq + q0 + r) * h + hh) * D);
#pragma unroll
    for (int j = 0; j < DT; ++j)
      orow[j * 4 + t] = pack_bf16(__fdiv_rn(acc[j][2 * half], den),
                                  __fdiv_rn(acc[j][2 * half + 1], den));
  }
}

// ---- decode: the keys split across blocks

constexpr int kDecWarps = 4;
constexpr int kDecThreads = 32 * kDecWarps;
constexpr int kDecBK = 32;       // keys per tile, 8 a warp
constexpr int kDecStages = 3;    // two tiles in flight while one is read
constexpr int kDecRowsMax = 16;  // query rows per block

template <typename T, int D>
struct DecLayout {
  static constexpr int VEC = 16 / sizeof(T);  // elements per 16 bytes
  // K / V rows padded by 16 bytes: D / VEC is even, so the row stride is
  // an odd number of 16-byte units and 8 lanes reading 8 keys' rows hit
  // 8 distinct bank groups
  static constexpr int LD = D + VEC;
  static constexpr int NQ = D / 4;            // dims per lane (a quarter)
  static constexpr int QQ = NQ + 4;           // a padded quarter of Q
  static constexpr int NL = D < 32 ? D : 32;  // lanes across head dims
  static constexpr int KG = 32 / NL;          // key groups in p . v
  static constexpr int DPL = D / NL;          // head dims per lane
};

template <typename T, int D, int R>
constexpr int dec_smem_bytes() {
  using Ly = DecLayout<T, D>;
  constexpr int ring = kDecStages * 2 * kDecBK * Ly::LD * sizeof(T);
  constexpr int comb = kDecWarps * R * (D + 2) * 4;
  return R * 4 * Ly::QQ * 4 + (ring > comb ? ring : comb);
}

// N consecutive elements from shared memory, widened to fp32
template <int N>
__device__ __forceinline__ void load_smem(const float* p, float (&x)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    const float4 w = *reinterpret_cast<const float4*>(p + j);
    x[j] = w.x; x[j + 1] = w.y; x[j + 2] = w.z; x[j + 3] = w.w;
  }
}

template <int N>
__device__ __forceinline__ void load_smem(const uint16_t* p,
                                          float (&x)[N]) {
  if constexpr (N % 8 == 0) {
    merge::load_row<N>(p, x);
  } else {
    static_assert(N == 4, "bf16 quarter rows are 4 or 8k elements");
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    x[0] = __uint_as_float(w.x << 16);
    x[1] = __uint_as_float(w.x & 0xFFFF0000u);
    x[2] = __uint_as_float(w.y << 16);
    x[3] = __uint_as_float(w.y & 0xFFFF0000u);
  }
}

template <typename T, int D, int R>
__global__ void __launch_bounds__(kDecThreads)
flash_kernel_decode(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o, int sq,
                    int sk, int h, int hk, long long qsb, long long qss,
                    long long qsh, long long ksb, long long kss,
                    long long ksh, long long vsb, long long vss,
                    long long vsh, float scale, int causal, int q_offset,
                    float softcap, int window, int chunk,
                    float* __restrict__ part, int* __restrict__ tickets) {
  using Ly = DecLayout<T, D>;
  constexpr int LD = Ly::LD, VEC = Ly::VEC, NQ = Ly::NQ, QQ = Ly::QQ;
  constexpr int NL = Ly::NL, KG = Ly::KG, DPL = Ly::DPL;
  constexpr int U = D / VEC;
  constexpr int PS = D + 2;      // (m, l, acc[D]) per row
  extern __shared__ __align__(16) float smf[];
  float* Qs = smf;                                      // [R][4][QQ]
  T* Ks = reinterpret_cast<T*>(Qs + R * 4 * QQ);        // [3][BK][LD]
  T* Vs = Ks + kDecStages * kDecBK * LD;                // [3][BK][LD]
  float* comb = Qs + R * 4 * QQ;   // [warps][R][PS], after the key loop
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = h / hk, nrows = sq * g;
  const int rgroups = (nrows + R - 1) / R;
  const int kh = blockIdx.y / rgroups, rg = blockIdx.y % rgroups;
  const int b = blockIdx.z, splits = gridDim.x;
  const int grp = b * gridDim.y + blockIdx.y;
  // the chunks split keys [kbeg, kend): with a window the first row
  // (position q_offset) sees none below q_offset - window + 1
  const int kend = causal ? max(0, min(sk, q_offset + sq)) : sk;
  const int kbeg = window_start(q_offset, window, kend, 1);
  const int c0 = kbeg + blockIdx.x * chunk, c1 = min(c0 + chunk, kend);
  const int ntiles = c1 > c0 ? (c1 - c0 + kDecBK - 1) / kDecBK : 0;
  const T* kb = k + b * ksb + kh * ksh;
  const T* vb = v + b * vsb + kh * vsh;

  auto load_tile = [&](int tile) {
    const int k0 = c0 + tile * kDecBK, st = tile % kDecStages;
    T* kd = Ks + st * kDecBK * LD;
    T* vd = Vs + st * kDecBK * LD;
    for (int u = tid; u < kDecBK * U; u += kDecThreads) {
      const int c = u / U, e = (u % U) * VEC;
      const long long key = k0 + c;
      const bool in = key < c1;
      cp_async16(kd + c * LD + e, in ? kb + key * kss + e : kb, in);
      cp_async16(vd + c * LD + e, in ? vb + key * vss + e : vb, in);
    }
  };
  if (ntiles > 0) load_tile(0);
  cp_async_commit();
  if (ntiles > 1) load_tile(1);
  cp_async_commit();

  // row r of the group: query i = row / g of head kh * g + row % g
  int pos[R];
  bool valid[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int row = rg * R + r;
    valid[r] = row < nrows;
    pos[r] = q_offset + (valid[r] ? row / g : 0);
  }
  for (int u = tid; u < R * D; u += kDecThreads) {
    const int r = u / D, d = u % D, row = rg * R + r;
    float x = 0.f;
    if (row < nrows)
      x = merge::widen(q[b * qsb + static_cast<long long>(row / g) * qss
                         + (kh * g + row % g) * qsh + d]);
    Qs[r * 4 * QQ + (d / NQ) * QQ + d % NQ] = x;
  }

  const int kl = lane & 7, qt = lane >> 3;   // key of 8, quarter of D
  const int dl = lane % NL, kg = lane / NL;  // p . v: head dim, key group
  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
  }

  for (int tile = 0; tile < ntiles; ++tile) {
    if (tile + 2 < ntiles) load_tile(tile + 2);
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();
    const int st = tile % kDecStages;
    const T* kt = Ks + (st * kDecBK + warp * 8) * LD;
    const T* vt = Vs + (st * kDecBK + warp * 8) * LD;
    const int key = c0 + tile * kDecBK + warp * 8 + kl;

    float kx[NQ];
    load_smem<NQ>(kt + kl * LD + qt * NQ, kx);
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float qx[NQ];
      load_smem<NQ>(Qs + r * 4 * QQ + qt * QQ, qx);
      float a = 0.f;
#pragma unroll
      for (int e = 0; e < NQ; ++e) a = fmaf(qx[e], kx[e], a);
      // the four quarters' sums, alike in the four lanes of a key
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, 8));
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, 16));
      const bool seen = valid[r] && key < c1 && (!causal || key <= pos[r])
                        && (!window || pos[r] - key < window);
      s[r] = seen ? soft_cap(__fmul_rn(a, scale), softcap) : -INFINITY;
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float mx = s[r];
#pragma unroll
      for (int off = 1; off < 8; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float mu = finite_or_zero(m_new);
      const float alpha = expf(__fsub_rn(m[r], mu));
      s[r] = expf(__fsub_rn(s[r], mu));
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha), s[r]);   // this lane's key
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] = __fmul_rn(acc[r][j], alpha);
    }
#pragma unroll
    for (int mm = 0; mm < 8 / KG; ++mm) {
      const int kk = kg + KG * mm;
      float p[R];
#pragma unroll
      for (int r = 0; r < R; ++r) p[r] = __shfl_sync(0xffffffffu, s[r], kk);
#pragma unroll
      for (int j = 0; j < DPL; ++j) {
        const float vv = merge::widen(vt[kk * LD + dl + NL * j]);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r][j] = fmaf(p[r], vv, acc[r][j]);
      }
    }
    __syncthreads();   // this stage is refilled three tiles on
  }
  cp_async_wait<0>();
  __syncthreads();     // the ring becomes the combine area

  // the warp's l over its 8 key lanes; acc over its key groups
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int off = 1; off < 8; off <<= 1)
      l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], off));
    if constexpr (KG == 2) {
#pragma unroll
      for (int j = 0; j < DPL; ++j)
        acc[r][j] = __fadd_rn(acc[r][j],
                              __shfl_xor_sync(0xffffffffu, acc[r][j], 16));
    }
    float* cw = comb + (warp * R + r) * PS;
    if (lane == 0) {
      cw[0] = m[r];
      cw[1] = l[r];
    }
    if (lane < NL) {
#pragma unroll
      for (int j = 0; j < DPL; ++j) cw[2 + dl + NL * j] = acc[r][j];
    }
  }
  __syncthreads();

  // the four warps in index order; then the output, or this chunk's
  // partial
  float* mine = splits == 1 ? nullptr
                : part + (static_cast<long long>(grp) * splits + blockIdx.x)
                             * R * PS;
  for (int u = tid; u < R * D; u += kDecThreads) {
    const int r = u / D, d = u % D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w)
      mx = fmaxf(mx, comb[(w * R + r) * PS]);
    const float mu = finite_or_zero(mx);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecWarps; ++w) {
      const float* cw = comb + (w * R + r) * PS;
      const float wt = expf(__fsub_rn(cw[0], mu));
      lsum = __fadd_rn(lsum, __fmul_rn(wt, cw[1]));
      a = __fadd_rn(a, __fmul_rn(wt, cw[2 + d]));
    }
    const int row = rg * R + r;
    if (splits == 1) {
      if (row < nrows)
        store(o + ((static_cast<long long>(b) * sq + row / g) * h + kh * g
                   + row % g) * D + d,
              __fdiv_rn(a, fmaxf(lsum, 1e-30f)));
    } else {
      mine[r * PS + 2 + d] = a;
      if (d == 0) {
        mine[r * PS] = mx;
        mine[r * PS + 1] = lsum;
      }
    }
  }
  if (splits == 1) return;

  // the last block of the group to finish combines every chunk
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(tickets + grp, 1) == splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const float* all = part + static_cast<long long>(grp) * splits * R * PS;
  for (int u = tid; u < R * D; u += kDecThreads) {
    const int r = u / D, d = u % D, row = rg * R + r;
    if (row >= nrows) continue;
    float mx = -INFINITY;
    for (int c = 0; c < splits; ++c)
      mx = fmaxf(mx, __ldcg(all + (c * R + r) * PS));
    const float mu = finite_or_zero(mx);
    float lsum = 0.f, a = 0.f;
    for (int c = 0; c < splits; ++c) {
      const float* pc = all + (c * R + r) * PS;
      const float wt = expf(__fsub_rn(__ldcg(pc), mu));
      lsum = __fadd_rn(lsum, __fmul_rn(wt, __ldcg(pc + 1)));
      a = __fadd_rn(a, __fmul_rn(wt, __ldcg(pc + 2 + d)));
    }
    store(o + ((static_cast<long long>(b) * sq + row / g) * h + kh * g
               + row % g) * D + d,
          __fdiv_rn(a, fmaxf(lsum, 1e-30f)));
  }
  if (tid == 0) tickets[grp] = 0;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int b, sq, sk, h, hk;
  const long long* st;
  float scale;
  int causal, q_offset;
  float softcap;          // 0: none
  int window;             // 0: none; else only with causal
  cudaStream_t stream;
  float* lse = nullptr;   // prefill only: per-row log-sum-exp, or none
};

template <int D>
int launch_scalar(const Args& a) {
  constexpr int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  static bool done[64];
  auto kern = flash_kernel<D>;
  cudaError_t err = allow_smem(kern, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int BQ = kTY * kRQ;
  const long long* st = a.st;
  const dim3 grid((a.sq + BQ - 1) / BQ, a.h, a.b);
  kern<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.sq, a.sk,
      a.h, a.hk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], a.scale, a.causal, a.q_offset, a.softcap, a.window, a.lse);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_mma(const Args& a) {
  constexpr int bytes = mma_smem_bytes<D>();
  static bool done[64];
  auto kern = flash_kernel_mma<D>;
  cudaError_t err = allow_smem(kern, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* st = a.st;
  const dim3 grid((a.sq + kMmaBQ - 1) / kMmaBQ, a.h, a.b);
  kern<<<grid, kMmaThreads, bytes, a.stream>>>(
      static_cast<const uint16_t*>(a.q), static_cast<const uint16_t*>(a.k),
      static_cast<const uint16_t*>(a.v), static_cast<uint16_t*>(a.o), a.sq,
      a.sk, a.h, a.hk, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
      st[7], st[8], a.scale, a.causal, a.q_offset, a.softcap, a.window,
      a.lse);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int R>
int launch_decode_r(const Args& a, int splits, int chunk, float* part,
                    int* tickets) {
  constexpr int bytes = dec_smem_bytes<T, D, R>();
  static bool done[64];
  auto kern = flash_kernel_decode<T, D, R>;
  cudaError_t err = allow_smem(kern, bytes, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long* st = a.st;
  const int rgroups = (a.sq * (a.h / a.hk) + R - 1) / R;
  const dim3 grid(splits, a.hk * rgroups, a.b);
  kern<<<grid, kDecThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.sq, a.sk, a.h,
      a.hk, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8],
      a.scale, a.causal, a.q_offset, a.softcap, a.window, chunk, part,
      tickets);
  return static_cast<int>(cudaGetLastError());
}

// rows: query rows per block, 1 (a decode step of a model with as many
// KV heads as query heads) or 16 (any other group of up to 16 rows)
template <typename T, int D>
int launch_decode(const Args& a, int rows, int splits, int chunk,
                  float* part, int* tickets) {
  switch (rows) {
    case 1: return launch_decode_r<T, D, 1>(a, splits, chunk, part, tickets);
    case kDecRowsMax:
      return launch_decode_r<T, D, kDecRowsMax>(a, splits, chunk, part,
                                                tickets);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// rows == 0: the prefill design (bf16 on the tensor cores, fp32 scalar);
// else the decode design with that many query rows per block
template <typename T, int D>
int launch_d(const Args& a, int rows, int splits, int chunk, float* part,
             int* tickets) {
  if (rows) return launch_decode<T, D>(a, rows, splits, chunk, part, tickets);
  if constexpr (sizeof(T) == 2) return launch_mma<D>(a);
  else return launch_scalar<D>(a);
}

template <typename T>
int launch(const Args& a, int d, int rows, int splits, int chunk,
           float* part, int* tickets) {
  if (a.b == 0 || a.sq == 0 || a.h == 0) return 0;
  switch (d) {
    case 16: return launch_d<T, 16>(a, rows, splits, chunk, part, tickets);
    case 32: return launch_d<T, 32>(a, rows, splits, chunk, part, tickets);
    case 64: return launch_d<T, 64>(a, rows, splits, chunk, part, tickets);
    case 96: return launch_d<T, 96>(a, rows, splits, chunk, part, tickets);
    case 128:
      return launch_d<T, 128>(a, rows, splits, chunk, part, tickets);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// keys [kbeg, kend) that some query row of a decode call sees; returns
// kend - kbeg (the kernel's `window_start` and key range)
int visible_keys(int sq, int sk, int causal, int q_offset, int window) {
  if (!causal) return sk;
  const int last = q_offset + sq;
  const int kend = last < 0 ? 0 : (last < sk ? last : sk);
  if (!window) return kend;
  const int first = q_offset - window + 1;
  return first <= 0 ? kend : (first < kend ? kend - first : 0);
}

// softcap >= 0; a window >= 0, and only with causal
bool bad_options(int causal, float softcap, int window) {
  return !(softcap >= 0.f) || window < 0 || (window && !causal);
}

template <typename T>
int prefill_or_decode(const void* q, const void* k, const void* v, void* o,
                      int b, int sq, int sk, int h, int hk, int d,
                      const long long* st, float scale, int causal,
                      int q_offset, float softcap, int window,
                      void* stream) {
  if (bad_options(causal, softcap, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, b, sq, sk, h, hk, st, scale, causal, q_offset,
               softcap, window, static_cast<cudaStream_t>(stream)};
  if (sq > kDecRowsMax) return launch<T>(a, d, 0, 1, 0, nullptr, nullptr);
  // a single chunk of 16-row groups needs no scratch
  const int n = visible_keys(sq, sk, causal, q_offset, window);
  return launch<T>(a, d, kDecRowsMax, 1, n > 1 ? n : 1, nullptr, nullptr);
}

template <typename T>
int decode_split(const void* q, const void* k, const void* v, void* o,
                 int b, int sq, int sk, int h, int hk, int d,
                 const long long* st, float scale, int causal, int q_offset,
                 float softcap, int window, int rows, int splits, int chunk,
                 void* part, void* tickets, void* stream) {
  if (bad_options(causal, softcap, window))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n = visible_keys(sq, sk, causal, q_offset, window);
  if (sq > kDecRowsMax || rows < 1 || splits < 1 || chunk < 1
      || static_cast<long long>(splits) * chunk < n
      || (splits > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, o, b, sq, sk, h, hk, st, scale, causal, q_offset,
               softcap, window, static_cast<cudaStream_t>(stream)};
  return launch<T>(a, d, rows, splits, chunk, static_cast<float*>(part),
                   static_cast<int*>(tickets));
}

template <typename T>
int forward_lse(const void* q, const void* k, const void* v, void* o, int b,
                int sq, int sk, int h, int hk, int d, const long long* st,
                float scale, int causal, int q_offset, float softcap,
                int window, void* lse, void* stream) {
  if (q_offset != 0 || bad_options(causal, softcap, window))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, o, b, sq, sk, h, hk, st, scale, causal, 0, softcap,
         window, static_cast<cudaStream_t>(stream)};
  a.lse = static_cast<float*>(lse);
  return launch<T>(a, d, 0, 1, 0, nullptr, nullptr);
}

}  // namespace

// q, k, v: fp32 or bf16 (raw bits) with element strides (batch, seq,
// head) and a contiguous last dimension, 16-byte aligned rows; d in
// {16, 32, 64, 96, 128}; h a multiple of hk; q_offset >= 0; softcap >= 0
// and window >= 0 (0: off; a window only with causal). out: contiguous
// [b, sq, h, d] of the same dtype. The Python wrapper checks all of
// this. sq > 16 takes the prefill design (bf16 on the tensor cores,
// fp32 scalar), sq <= 16 the decode design in one key chunk.
#define B9_ARGS                                                          \
  const void *q, const void *k, const void *v, void *o, int b, int sq,   \
      int sk, int h, int hk, int d, long long qsb, long long qss,        \
      long long qsh, long long ksb, long long kss, long long ksh,        \
      long long vsb, long long vss, long long vsh, float scale,          \
      int causal, int q_offset, float softcap, int window

extern "C" int flash_attention_f32(B9_ARGS, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return prefill_or_decode<float>(q, k, v, o, b, sq, sk, h, hk, d, st,
                                  scale, causal, q_offset, softcap, window,
                                  stream);
}

extern "C" int flash_attention_bf16(B9_ARGS, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return prefill_or_decode<uint16_t>(q, k, v, o, b, sq, sk, h, hk, d, st,
                                     scale, causal, q_offset, softcap,
                                     window, stream);
}

// The decode design (sq <= 16) with `rows` query rows per block (1 or
// 16; the sq x h / hk rows of a KV head make ceil(sq h / hk / rows)
// groups) over `splits` key chunks of `chunk` keys (chunk c reads keys
// [kbeg + c chunk, min(kbeg + (c + 1) chunk, kend)), kbeg the first key
// the window lets a row see, else 0). With splits > 1: part, fp32
// scratch of b * hk * groups * splits * rows * (d + 2) floats; tickets,
// b * hk * groups ints, zero before the call and zero after it.
extern "C" int flash_decode_f32(B9_ARGS, int rows, int splits, int chunk,
                                void* part, void* tickets, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return decode_split<float>(q, k, v, o, b, sq, sk, h, hk, d, st, scale,
                             causal, q_offset, softcap, window, rows, splits,
                             chunk, part, tickets, stream);
}

extern "C" int flash_decode_bf16(B9_ARGS, int rows, int splits, int chunk,
                                 void* part, void* tickets, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return decode_split<uint16_t>(q, k, v, o, b, sq, sk, h, hk, d, st, scale,
                                causal, q_offset, softcap, window, rows,
                                splits, chunk, part, tickets, stream);
}

// Dynamic shared memory of one instance, for reports: design 0 prefill
// (bf16 on the tensor cores, fp32 scalar), 1 decode with `rows` query
// rows per block (1 or 16). -1 for an instance that does not exist.
extern "C" int flash_attention_smem(int design, int bf16, int d, int rows) {
  auto pick = [&](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if (design == 0)
      return bf16 ? mma_smem_bytes<D>()
                  : smem_floats<D>() * static_cast<int>(sizeof(float));
    if (rows != 1 && rows != kDecRowsMax) return -1;
    if (bf16)
      return rows == 1 ? dec_smem_bytes<uint16_t, D, 1>()
                       : dec_smem_bytes<uint16_t, D, kDecRowsMax>();
    return rows == 1 ? dec_smem_bytes<float, D, 1>()
                     : dec_smem_bytes<float, D, kDecRowsMax>();
  };
  switch (d) {
    case 16: return pick(std::integral_constant<int, 16>{});
    case 32: return pick(std::integral_constant<int, 32>{});
    case 64: return pick(std::integral_constant<int, 64>{});
    case 96: return pick(std::integral_constant<int, 96>{});
    case 128: return pick(std::integral_constant<int, 128>{});
    default: return -1;
  }
}

// The prefill design at any Sq (q_offset 0; with the softcap and the
// window, as the served forward), also writing each row's log-sum-exp of
// its (capped) logits, natural units, to lse [b, h, sq] fp32 (0 for a
// row that sees no key): the forward of the gradient.
extern "C" int flash_attention_lse_f32(B9_ARGS, void* lse, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return forward_lse<float>(q, k, v, o, b, sq, sk, h, hk, d, st, scale,
                            causal, q_offset, softcap, window, lse, stream);
}

extern "C" int flash_attention_lse_bf16(B9_ARGS, void* lse, void* stream) {
  const long long st[9] = {qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh};
  return forward_lse<uint16_t>(q, k, v, o, b, sq, sk, h, hk, d, st, scale,
                               causal, q_offset, softcap, window, lse,
                               stream);
}
