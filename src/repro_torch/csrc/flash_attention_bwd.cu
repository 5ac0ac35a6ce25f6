// B9's gradient: the kernels are csrc/flash_attention_bwd.cuh; a source
// of its own so that it compiles beside csrc/flash_attention.cu.
#include <type_traits>

#include "flash_attention_bwd.cuh"

extern "C" int flash_attention_bwd_f32(B9_BWD_ARGS) {
  return backward<float>(q, k, v, o, dout, lse, dd, dq, dk, dv, b, sq, sk, h,
                         hk, d, {scale, causal, softcap, window}, stream);
}

extern "C" int flash_attention_bwd_bf16(B9_BWD_ARGS) {
  return backward<uint16_t>(q, k, v, o, dout, lse, dd, dq, dk, dv, b, sq, sk,
                            h, hk, d, {scale, causal, softcap, window},
                            stream);
}

// Dynamic shared memory of one instance, for reports: kernel 0 dK / dV,
// 1 dQ (`bwd_dot` takes none); bf16 the tensor-core design, else the
// scalar fp32 one. -1 for an instance that does not exist.
extern "C" int flash_attention_bwd_smem(int kernel, int bf16, int d) {
  auto pick = [&](auto dc) -> int {
    constexpr int D = decltype(dc)::value;
    if (kernel == 0) return bf16 ? bwd_dkdv_mma_smem<D>() : bwd_dkdv_smem<D>();
    if (kernel == 1) return bf16 ? bwd_dq_mma_smem<D>() : bwd_dq_smem<D>();
    return -1;
  };
  switch (d) {
    case 16: return pick(std::integral_constant<int, 16>{});
    case 64: return pick(std::integral_constant<int, 64>{});
    case 96: return pick(std::integral_constant<int, 96>{});
    case 128: return pick(std::integral_constant<int, 128>{});
    default: return -1;
  }
}
