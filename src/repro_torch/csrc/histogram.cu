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
//                  k-sum, mean of the agreeing entries. Bound: bytes; it
//                  streams the stack once (twice within one thread when k
//                  exceeds its register budget, the second time from L1 /
//                  L2). Each thread owns one column and sums over k in
//                  index order; neighbouring threads take neighbouring
//                  columns, so every row read is coalesced.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // B5

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
int ties_launch(const void* x, const void* base, const void* thr, void* out,
                int k, long long np, int block, cudaStream_t stream) {
  const unsigned int grid = merge::grid_for(np, kThreads);
  const T* xp = static_cast<const T*>(x);
  const float* bp = static_cast<const float*>(base);
  const float* tp = static_cast<const float*>(thr);
  float* op = static_cast<float*>(out);
  // the smallest register budget that holds k: an instance for more
  // rows runs its unrolled, predicated loops that much longer (at k = 5
  // the 16-row instance streamed 808 GB/s on an H100, the 4-row one 2062
  // GB/s at k = 4)
  if (k <= 4)
    ties_block_kernel<T, 4><<<grid, kThreads, 0, stream>>>(xp, bp, tp, op, k,
                                                          np, block);
  else if (k <= 8)
    ties_block_kernel<T, 8><<<grid, kThreads, 0, stream>>>(xp, bp, tp, op, k,
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
// `block`; the Python wrappers check shapes, dtypes and devices, and for
// B3 and B4 that block is a multiple of 8 and x, base and out are 16-byte
// aligned.
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
