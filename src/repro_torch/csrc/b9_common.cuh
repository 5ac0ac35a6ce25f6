// Helpers B9's sources share (csrc/flash_attention.cu, the forward, and
// csrc/flash_attention_bwd.cuh, the gradient): rounding to bf16 as
// torch rounds, typed stores, the dynamic shared-memory opt-in, the
// sliding window's first key tile, and the tensor-core building blocks
// of the bf16 designs (cp.async, ldmatrix, mma.sync, P split into three
// bf16 terms, 2^x on the SFU).
#pragma once

#include "common.cuh"

namespace {

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

// raise the dynamic shared-memory limit of `kern` to `bytes`, once per
// device for each instance (the decode step launches it every layer)
template <typename K>
cudaError_t allow_smem(K kern, int bytes, bool (&done)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// the first key a row at position `pos` sees under a window (0: none),
// rounded down to a multiple of `tile`, and never past `kend`
__device__ __forceinline__ int window_start(int pos, int window, int kend,
                                            int tile) {
  if (!window) return 0;
  const int first = min(kend, max(0, pos - window + 1));
  return first / tile * tile;
}

// ---- PTX wrappers: cp.async, ldmatrix, mma.sync (sm_80 and later)

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; zero-filled when !pred (the
// source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// 4 bytes (an fp32 row statistic), cached in L1 too; zero-filled when
// !pred
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a . b: a 16x16 bf16 (row), b 16x8 bf16 (col), c 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> packed bf16x2 (x0 in the low half), round to nearest even
// in one instruction (NaN is not kept as torch keeps it: for P and dS
// only)
__device__ __forceinline__ uint32_t pack_rn(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// two outputs -> packed bf16x2, rounded as torch's .to(bfloat16)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  return static_cast<uint32_t>(to_bf16(x0))
         | (static_cast<uint32_t>(to_bf16(x1)) << 16);
}

// p = hi + mid + lo, each a bf16 pair: hi = bf16(p), mid = bf16(p - hi),
// lo = bf16(p - hi - mid). Each difference is exact in fp32 and holds 8
// fewer significant bits than the last, so the three carry p's 24 bits
// exactly (two would leave 2^-17 of p: in the forward, one to a few 1e-6
// on outputs near zero of rows that see few keys, beyond its bf16 rule's
// 1e-6)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
  hi = pack_rn(x0, x1);
  x0 = __fsub_rn(x0, __uint_as_float(hi << 16));
  x1 = __fsub_rn(x1, __uint_as_float(hi & 0xFFFF0000u));
  mid = pack_rn(x0, x1);
  lo = pack_rn(__fsub_rn(x0, __uint_as_float(mid << 16)),
               __fsub_rn(x1, __uint_as_float(mid & 0xFFFF0000u)));
}

// 2^x on the special-function unit (ex2.approx.ftz: a relative error of
// ~2^-22, results below 2^-126 flushed to 0; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
