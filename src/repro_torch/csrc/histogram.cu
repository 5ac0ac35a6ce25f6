// The three passes of histogram-trim TIES over a block-aligned flat
// batch: every `block`-wide column tile belongs to one leaf, and the
// per-leaf scalars ride in per-tile metadata rows. x is read as fp32 or
// bf16 and widened in registers, so the engine's bf16 batch is never
// copied to fp32 (widening is exact: the result is the reference's fp32
// `pad_stacked` copy's). All arithmetic is pinned with rounded
// intrinsics and --fmad=false, so each kernel is bitwise its plain
// version in `kernels/histogram.py`.
//
//   B3 block_amax  replaces repro/kernels/histogram.py `block_amax_pallas`
//                  (`_amax_kernel`): out[b, i] = max_c |x[i, c] - base[c]|
//                  over tile b, NaN-propagating as jnp.max (merge::nanmax;
//                  a NaN stays in its own tile and row).
//   B4 block_hist  replaces `block_hist_pallas` (`_hist_kernel`): per tile
//                  and contribution, exact integer counts of
//                  clip(int(|x - base| / amax * bins), 0, bins - 1) over
//                  the tile's valid columns. The bin index divides, then
//                  multiplies, as the reference does (a reciprocal would
//                  move bucket edges).
//
// B3 and B4 are bound by device-memory bytes: the [k, Np] stack and the
// base read once, B4's [nb, k * bins] counts written once, at a few (B3)
// to ~20 (B4: the division) operations per element. Their first design
// (one CUDA block per tile and contribution) lost three ways, and the
// design below answers each:
//   1. The base was read once per contribution: blocks of contribution i
//      ran long after those of contribution 0, when the tile's base had
//      left L2. Now one warp owns a tile and all k contributions
//      (`walk_tile`): it loads each segment's base into registers once
//      and walks the k rows over it. B4 takes the rows in groups of G
//      whose counters fit its share of shared memory (`hist_plan`, the
//      same rule as kernels/histogram.py); with more than one group the
//      base comes again from L1 / L2, which the warp filled moments
//      before. On the main path (k = 4, 512 bins) there is one group.
//   2. Two-byte scalar loads in a loop of runtime length. Now a segment
//      is 1024 columns and a lane owns 32 of them as 4 vectors of 8
//      adjacent columns: one 16-byte load per vector and row for bf16
//      (two for fp32), the 4 issued together, the lanes of a warp on 512
//      contiguous bytes. Neither kernel issues the next row's loads
//      before this row's arithmetic: the second row's registers cost more
//      warps than the overlap gains (`tools/hist_time.py --variants`
//      times that, and a 2048- and a 512-column segment).
//   3. 1.56 M short blocks, each ending in a block-wide reduction (B3) or
//      zeroing, synchronising and writing 512 counters (B4). Now every
//      sync is a __syncwarp. B3 reduces each row by warp shuffles and
//      keeps row i's max in lane i, so a tile's k maxima leave in one
//      coalesced store (16 bytes at k = 4). B4 keeps a private histogram
//      of G x bins counters per warp in shared memory (no contention
//      between warps; integer atomics make the counts exact in any
//      order), reads each row's amax from a lane that loaded it ahead of
//      the walk, writes a group's counts with 16-byte stores while
//      zeroing them for the next group, and sets the shared-memory limit
//      once per instance. atomicAdd of 1 compiles to ATOMS.POPC.INC,
//      which the hardware aggregates over the lanes that hit one
//      counter, so counts crowded into a few bins cost no more than
//      spread ones; __match_any_sync aggregation in software measured
//      slower on both inputs.
//
//   B5 ties_block  replaces `ties_block_pallas` (`_ties_block_kernel` ->
//                  repro/kernels/ties.py `ties_tile`): trim at the tile's
//                  per-contribution threshold, elect the sign of the
//                  k-sum, mean of the agreeing entries (`merge::trim`,
//                  `merge::agree`, every sum over k in index order).
//
// B5 is bound by device-memory bytes too: the stack and the base read
// once, the fp32 output written once, ~12 operations per stacked element.
// Its first design ran one thread per column in a grid-stride loop and
// lost three ways (62 % of its bound at k = 4, 45 % at k = 5); the design
// below answers each:
//   1. Each column found its tile's thresholds through a 64-bit division
//      by the runtime block, and read them again for every row. Now one
//      CTA of 128 threads owns a tile: its k thresholds are read once
//      into registers (a broadcast load) and nothing is divided.
//   2. Two-byte scalar loads, a row at a time. Now a thread owns V
//      adjacent columns at a time (V = 8, or 4 where k is 9-16; two
//      vectors a thread at a 2048-column tile): one 16-byte load per row
//      for bf16 (two for fp32), the base in 16-byte loads, the output in
//      16-byte stores, all k rows' loads issued before the arithmetic.
//   3. Register instances for 4, 8 and 16 rows whose unrolled loops were
//      predicated on the runtime k, so k = 5 walked 3 dead rows. Now
//      there is an instance per exact k up to 16, every loop unrolled
//      with no predicate, the k trimmed values kept in registers for the
//      agreement pass; k = 9-16 take 4 columns a thread so that ptxas
//      gives them few enough registers for 5-9 CTAs an SM (8 columns
//      with a second pass that loads the rows again read up to 11 %
//      slower). Above 16 rows one instance takes any k in chunks of 4
//      loads (8 took 13 % longer at k = 17) and loads the rows again for
//      its second pass.
// Occupancy sets the pace: ptxas is left to choose the registers, which
// it keeps low; the one instance where that spills has launch bounds of
// its own. `tools/ties_time.py --variants` times each choice above.
#include "common.cuh"

namespace {

// ------------------------------------------------------------- B3, B4

constexpr int kLanes = 32;
constexpr int kVec = 8;         // adjacent columns a lane loads at once
constexpr int kSegVecs = 4;     // vectors a lane holds
constexpr int kSeg = kLanes * kSegVecs * kVec;  // 1024 columns a segment
constexpr int kAmaxWarps = 8;   // B3: tiles a block
// B4's plan, the same rule as kernels/histogram.py `hist_plan`
constexpr long long kSmemPerBlock = 232448;  // H100: a block's most
constexpr long long kWarpSmem = 16 * 1024;   // a warp's share of counters
constexpr int kHistWarps = 4;

struct HistPlan {
  int warps, group, smem;
};

// Warps per block, contributions per pass and dynamic shared bytes of
// B4's launch, from k and bins alone; false where a bins-wide histogram
// does not fit a block.
bool hist_plan(int k, int bins, HistPlan* p) {
  const long long row = 4LL * bins;
  if (k < 1 || bins < 1 || row > kSmemPerBlock) return false;
  long long group = kWarpSmem / row;
  group = group < 1 ? 1 : (group > k ? k : group);
  long long warps = kSmemPerBlock / (group * row);
  warps = warps > kHistWarps ? kHistWarps : warps;
  p->warps = static_cast<int>(warps);
  p->group = static_cast<int>(group);
  p->smem = static_cast<int>(warps * group * row);
  return true;
}

using Seg = float[kSegVecs][kVec];

// One lane's share of a segment of one row, as loaded: vector j holds the
// kVec columns from (j * 32 + lane) * kVec, one 16-byte load of bf16 (two
// of fp32), the kSegVecs loads issued together; vectors at or past `nv`
// read as 0. `widen` turns it into fp32 columns (bf16 widening is exact).
// Loading and widening apart, rather than through `merge::load_row`,
// leaves B4 fewer registers a thread and so more warps an SM (variant
// `load_row` of `tools/hist_time.py`; PERF.md section 6).
template <typename T>
struct Raw;
template <>
struct Raw<uint16_t> {
  uint4 q[kSegVecs];
};
template <>
struct Raw<float> {
  float4 q[kSegVecs][2];
};

__device__ __forceinline__ void load_raw(const uint16_t* __restrict__ p,
                                         int nv, int lane, Raw<uint16_t>& r) {
#pragma unroll
  for (int j = 0; j < kSegVecs; ++j) {
    const int q = j * kLanes + lane;
    r.q[j] = q < nv ? *reinterpret_cast<const uint4*>(p + q * kVec)
                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void load_raw(const float* __restrict__ p, int nv,
                                         int lane, Raw<float>& r) {
#pragma unroll
  for (int j = 0; j < kSegVecs; ++j) {
    const int q = j * kLanes + lane;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      r.q[j][h] = q < nv ? *reinterpret_cast<const float4*>(p + q * kVec +
                                                             4 * h)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void widen(const Raw<uint16_t>& r, Seg& v) {
#pragma unroll
  for (int j = 0; j < kSegVecs; ++j) {
    const uint32_t w[4] = {r.q[j].x, r.q[j].y, r.q[j].z, r.q[j].w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      v[j][2 * h] = __uint_as_float(w[h] << 16);
      v[j][2 * h + 1] = __uint_as_float(w[h] & 0xFFFF0000u);
    }
  }
}

__device__ __forceinline__ void widen(const Raw<float>& r, Seg& v) {
#pragma unroll
  for (int j = 0; j < kSegVecs; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[j][4 * h] = r.q[j][h].x;
      v[j][4 * h + 1] = r.q[j][h].y;
      v[j][4 * h + 2] = r.q[j][h].z;
      v[j][4 * h + 3] = r.q[j][h].w;
    }
}

// The walk B3 and B4 share: one warp over one tile, the k rows in groups
// of `group`, each group segment by segment. `row(i, slot, s0, v, b)`
// sees row i (slot i - g0 of its group) of the segment from column s0;
// `done(g0, g1)` closes a group. The segment's base is loaded once per
// group: once per tile wherever the k rows fit one group (k <= 32 for
// B3; B4's main path), else again from L1 / L2.
template <typename T, typename Row, typename Done>
__device__ __forceinline__ void walk_tile(const T* __restrict__ x,
                                          const float* __restrict__ base,
                                          long long np, long long tile,
                                          int block, int k, int group,
                                          int lane, Row&& row, Done&& done) {
  const long long t0 = tile * block;
  for (int g0 = 0; g0 < k; g0 += group) {
    const int g1 = min(k, g0 + group);
    for (int s0 = 0; s0 < block; s0 += kSeg) {
      const int nv = min(kSeg, block - s0) / kVec;
      const T* col = x + t0 + s0;
      Raw<T> r;
      Raw<float> rb;
      load_raw(base + t0 + s0, nv, lane, rb);
      Seg b;
      widen(rb, b);
      for (int i = g0; i < g1; ++i) {
        Seg v;
        load_raw(col + static_cast<long long>(i) * np, nv, lane, r);
        widen(r, v);
        row(i, i - g0, s0, v, b);
      }
    }
    done(g0, g1);
  }
}

// One warp per tile; row i's max lives in lane i - g0 of its group of 32.
template <typename T>
__global__ void __launch_bounds__(kAmaxWarps * kLanes)
    block_amax_kernel(const T* __restrict__ x,
                      const float* __restrict__ base,
                      float* __restrict__ out, int k, long long np,
                      int block) {
  const int lane = threadIdx.x & (kLanes - 1);
  const long long tile =
      static_cast<long long>(blockIdx.x) * kAmaxWarps + (threadIdx.x >> 5);
  if (tile >= np / block) return;
  float mine = 0.f;
  walk_tile(
      x, base, np, tile, block, k, kLanes, lane,
      [&](int, int slot, int, const Seg& v, const Seg& b) {
        float m[kVec];
#pragma unroll
        for (int e = 0; e < kVec; ++e) m[e] = 0.f;
#pragma unroll
        for (int j = 0; j < kSegVecs; ++j)
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            m[e] = merge::nanmax(m[e], fabsf(__fsub_rn(v[j][e], b[j][e])));
#pragma unroll
        for (int e = 1; e < kVec; ++e) m[0] = merge::nanmax(m[0], m[e]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          m[0] = merge::nanmax(m[0], __shfl_xor_sync(0xffffffffu, m[0], off));
        if (lane == slot) mine = merge::nanmax(mine, m[0]);
      },
      [&](int g0, int g1) {
        if (lane < g1 - g0) out[tile * k + g0 + lane] = mine;
        mine = 0.f;
      });
}

// One warp per tile, with a private [group, bins] histogram in shared
// memory, zeroed at the start and after each group's counts are out.
template <typename T>
__global__ void __launch_bounds__(kHistWarps * kLanes)
    block_hist_kernel(const T* __restrict__ x,
                      const float* __restrict__ base,
                      const float* __restrict__ amax,
                      const int* __restrict__ valid, int* __restrict__ out,
                      int k, long long np, int block, int bins, int group) {
  extern __shared__ __align__(16) unsigned int smem[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warp = threadIdx.x >> 5;
  const long long tile =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  if (tile >= np / block) return;
  unsigned int* hist = smem + static_cast<long long>(warp) * group * bins;
  const bool wide = bins % 4 == 0;  // 16-byte counter moves
  const int n = group * bins;
  if (wide) {
    for (int e = lane; e < n / 4; e += kLanes)
      reinterpret_cast<uint4*>(hist)[e] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    for (int e = lane; e < n; e += kLanes) hist[e] = 0u;
  }
  __syncwarp();
  const int nvalid = valid[tile];
  const float fbins = static_cast<float>(bins);
  // the first 32 rows' amax, one a lane, loaded ahead of the walk
  const float ams = lane < k ? amax[tile * k + lane] : 0.f;
  walk_tile(
      x, base, np, tile, block, k, group, lane,
      [&](int i, int slot, int s0, const Seg& v, const Seg& b) {
        const float am = i < kLanes
                             ? __shfl_sync(0xffffffffu, ams, i)
                             : amax[tile * k + i];
        unsigned int* h = hist + slot * bins;
#pragma unroll
        for (int j = 0; j < kSegVecs; ++j) {
          const int c0 = s0 + (j * kLanes + lane) * kVec;
#pragma unroll
          for (int e = 0; e < kVec; ++e) {
            const float a = fabsf(__fsub_rn(v[j][e], b[j][e]));
            int idx = __float2int_rz(__fmul_rn(__fdiv_rn(a, am), fbins));
            idx = idx < 0 ? 0 : (idx > bins - 1 ? bins - 1 : idx);
            const bool keep = c0 + e < nvalid;
            if (keep) atomicAdd(&h[idx], 1u);
          }
        }
      },
      [&](int g0, int g1) {
        __syncwarp();
        const int m = (g1 - g0) * bins;
        const bool more = g1 < k;
        int* o = out + (tile * k + g0) * static_cast<long long>(bins);
        if (wide) {
          uint4* h4 = reinterpret_cast<uint4*>(hist);
          for (int e = lane; e < m / 4; e += kLanes) {
            const uint4 c = h4[e];
            reinterpret_cast<int4*>(o)[e] =
                make_int4(static_cast<int>(c.x), static_cast<int>(c.y),
                          static_cast<int>(c.z), static_cast<int>(c.w));
            if (more) h4[e] = make_uint4(0u, 0u, 0u, 0u);
          }
        } else {
          for (int e = lane; e < m; e += kLanes) {
            o[e] = static_cast<int>(hist[e]);
            if (more) hist[e] = 0u;
          }
        }
        __syncwarp();
      });
}

// ------------------------------------------------------------- B5

constexpr int kTiesThreads = 128;  // a tile's CTA: 2 vectors a thread
constexpr int kTiesChunk = 4;      // rows a thread loads at once, any k

// V adjacent columns of one row, as loaded: V * sizeof(T) bytes in 16-byte
// loads (one 8-byte load for 4 bf16 columns); `operator[]` widens column
// e to fp32 (exact).
template <typename T, int V>
struct Cols {
  static constexpr int kWords = V * static_cast<int>(sizeof(T)) / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* __restrict__ p) {
    if constexpr (kWords % 4 == 0) {
#pragma unroll
      for (int j = 0; j < kWords; j += 4) {
        const uint4 q = reinterpret_cast<const uint4*>(p)[j / 4];
        w[j] = q.x;
        w[j + 1] = q.y;
        w[j + 2] = q.z;
        w[j + 3] = q.w;
      }
    } else {
      static_assert(kWords == 2, "4 bf16 columns: one 8-byte load");
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      w[0] = q.x;
      w[1] = q.y;
    }
  }

  __device__ __forceinline__ float operator[](int e) const {
    if constexpr (sizeof(T) == 2)
      return __uint_as_float((e & 1) ? (w[e >> 1] & 0xFFFF0000u)
                                     : (w[e >> 1] << 16));
    else
      return __uint_as_float(w[e]);
  }
};

// One CTA per tile; thread q owns the V columns from q * V of it. K > 0:
// exactly K rows, every loop unrolled, the thresholds and the K x V
// trimmed values in registers for the agreement pass. K == 0: any k, in
// chunks of kTiesChunk rows, with the second pass loading again.
template <typename T, int K, int V>
__device__ __forceinline__ void ties_tile(const T* __restrict__ x,
                                          const float* __restrict__ base,
                                          const float* __restrict__ thr,
                                          float* __restrict__ out, int k,
                                          long long np, int block) {
  const long long tile = blockIdx.x;
  const float* __restrict__ th = thr + tile * (K > 0 ? K : k);
  float thv[K > 0 ? K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int i = 0; i < K; ++i) thv[i] = th[i];
  }
  const int nv = block / V;
  for (int q = threadIdx.x; q < nv; q += kTiesThreads) {
    const long long c = tile * block + static_cast<long long>(q) * V;
    const T* __restrict__ col = x + c;
    Cols<float, V> b;
    b.load(base + c);
    float s[V], el[V], cnt[V], acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) s[e] = cnt[e] = acc[e] = 0.f;
    if constexpr (K > 0) {
      Cols<T, V> r[K];
#pragma unroll
      for (int i = 0; i < K; ++i) r[i].load(col + i * np);
      float tv[K][V];
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          tv[i][e] = merge::trim(r[i][e], b[e], thv[i]);
          s[e] = __fadd_rn(s[e], tv[i][e]);
        }
#pragma unroll
      for (int e = 0; e < V; ++e) el[e] = merge::sign_of(s[e]);
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e)
          merge::agree(tv[i][e], el[e], cnt[e], acc[e]);
    } else {
      for (int i0 = 0; i0 < k; i0 += kTiesChunk) {
        Cols<T, V> r[kTiesChunk];
#pragma unroll
        for (int j = 0; j < kTiesChunk; ++j)
          if (i0 + j < k) r[j].load(col + (i0 + j) * np);
#pragma unroll
        for (int j = 0; j < kTiesChunk; ++j)
          if (i0 + j < k) {
            const float t = th[i0 + j];
#pragma unroll
            for (int e = 0; e < V; ++e)
              s[e] = __fadd_rn(s[e], merge::trim(r[j][e], b[e], t));
          }
      }
#pragma unroll
      for (int e = 0; e < V; ++e) el[e] = merge::sign_of(s[e]);
      for (int i0 = 0; i0 < k; i0 += kTiesChunk) {
        Cols<T, V> r[kTiesChunk];
#pragma unroll
        for (int j = 0; j < kTiesChunk; ++j)
          if (i0 + j < k) r[j].load(col + (i0 + j) * np);
#pragma unroll
        for (int j = 0; j < kTiesChunk; ++j)
          if (i0 + j < k) {
            const float t = th[i0 + j];
#pragma unroll
            for (int e = 0; e < V; ++e)
              merge::agree(merge::trim(r[j][e], b[e], t), el[e], cnt[e],
                           acc[e]);
          }
      }
    }
    float o[V];
#pragma unroll
    for (int e = 0; e < V; ++e)
      o[e] = __fadd_rn(b[e], __fdiv_rn(acc[e], fmaxf(cnt[e], 1.f)));
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(out + c + j) =
          make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
  }
}

// Left to itself, ptxas takes 44-128 registers (4-11 CTAs an SM); launch
// bounds that cap them at 128 or 255 make it take more, and cost 2-20 %
// at k >= 5.
template <typename T, int K, int V>
__global__ void __launch_bounds__(kTiesThreads)
    ties_block_kernel(const T* __restrict__ x,
                      const float* __restrict__ base,
                      const float* __restrict__ thr,
                      float* __restrict__ out, int k, long long np,
                      int block) {
  ties_tile<T, K, V>(x, base, thr, out, k, np, block);
}

// The same, held to 96 registers (5 CTAs an SM): left to itself, ptxas
// gives bf16 at K = 14 96 registers and spills 8 bytes; held, it spills
// none (`tools/ties_time.py --variants`, min_blocks5).
template <typename T, int K, int V>
__global__ void __launch_bounds__(kTiesThreads, 5)
    ties_block_kernel_r96(const T* __restrict__ x,
                          const float* __restrict__ base,
                          const float* __restrict__ thr,
                          float* __restrict__ out, int k, long long np,
                          int block) {
  ties_tile<T, K, V>(x, base, thr, out, k, np, block);
}

// ------------------------------------------------------------- launches

template <typename T>
int amax_launch(const void* x, const void* base, void* out, int k,
                long long np, int block, cudaStream_t stream) {
  const long long nb = np / block;
  const unsigned int grid =
      static_cast<unsigned int>((nb + kAmaxWarps - 1) / kAmaxWarps);
  block_amax_kernel<T><<<grid, kAmaxWarps * kLanes, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(base),
      static_cast<float*>(out), k, np, block);
  return static_cast<int>(cudaGetLastError());
}

// Raise an instance's dynamic shared-memory limit to a block's most,
// once per device.
template <typename K>
cudaError_t allow_smem(K kern, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemPerBlock));
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

template <typename T>
int hist_launch(const void* x, const void* base, const void* amax,
                const void* valid, void* out, int k, long long np, int block,
                int bins, cudaStream_t stream) {
  HistPlan p;
  if (!hist_plan(k, bins, &p)) return static_cast<int>(cudaErrorInvalidValue);
  static bool done[64] = {};
  if (p.smem > 48 * 1024) {
    const cudaError_t e = allow_smem(block_hist_kernel<T>, done);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long nb = np / block;
  const unsigned int grid =
      static_cast<unsigned int>((nb + p.warps - 1) / p.warps);
  block_hist_kernel<T><<<grid, p.warps * kLanes, p.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(base),
      static_cast<const float*>(amax), static_cast<const int*>(valid),
      static_cast<int*>(out), k, np, block, bins, p.group);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
using TiesKernel = void (*)(const T*, const float*, const float*, float*,
                            int, long long, int);

// The instance for exactly K rows (K <= 16): 8 columns a thread up to 8
// rows, 4 from 9 to 16.
template <typename T, int K>
TiesKernel<T> ties_instance() {
  if constexpr (K == 14 && sizeof(T) == 2)
    return ties_block_kernel_r96<T, K, 4>;
  else if constexpr (K > 8)
    return ties_block_kernel<T, K, 4>;
  else
    return ties_block_kernel<T, K, 8>;
}

template <typename T>
int ties_launch(const void* x, const void* base, const void* thr, void* out,
                int k, long long np, int block, cudaStream_t stream) {
  const long long nb = np / block;
  if (nb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  TiesKernel<T> kern;
  switch (k) {
    case 1: kern = ties_instance<T, 1>(); break;
    case 2: kern = ties_instance<T, 2>(); break;
    case 3: kern = ties_instance<T, 3>(); break;
    case 4: kern = ties_instance<T, 4>(); break;
    case 5: kern = ties_instance<T, 5>(); break;
    case 6: kern = ties_instance<T, 6>(); break;
    case 7: kern = ties_instance<T, 7>(); break;
    case 8: kern = ties_instance<T, 8>(); break;
    case 9: kern = ties_instance<T, 9>(); break;
    case 10: kern = ties_instance<T, 10>(); break;
    case 11: kern = ties_instance<T, 11>(); break;
    case 12: kern = ties_instance<T, 12>(); break;
    case 13: kern = ties_instance<T, 13>(); break;
    case 14: kern = ties_instance<T, 14>(); break;
    case 15: kern = ties_instance<T, 15>(); break;
    case 16: kern = ties_instance<T, 16>(); break;
    default:
      kern = ties_block_kernel<T, 0, 8>;
  }
  kern<<<static_cast<unsigned int>(nb), kTiesThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(base),
      static_cast<const float*>(thr), static_cast<float*>(out), k, np,
      block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: [k, np] fp32 or bf16 (raw bits), base: [np] fp32, np a multiple of
// `block`; the Python wrappers check shapes, dtypes and devices, and that
// block is a multiple of 8 and x, base and out are 16-byte aligned.
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

// B4's plan for (k, bins) into plan[3] (warps per block, contributions
// per pass, dynamic shared bytes); cudaErrorInvalidValue where it has none.
extern "C" int block_hist_plan(int k, int bins, int* plan) {
  HistPlan p;
  if (!hist_plan(k, bins, &p)) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = p.warps;
  plan[1] = p.group;
  plan[2] = p.smem;
  return 0;
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
