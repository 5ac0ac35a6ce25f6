// B9's gradient: the kernels are csrc/flash_attention_bwd.cuh; a source
// of its own so that it compiles beside csrc/flash_attention.cu.
#include "flash_attention_bwd.cuh"

extern "C" int flash_attention_bwd_f32(B9_BWD_ARGS) {
  return backward<float>(q, k, v, o, dout, lse, dd, dq, dk, dv, b, sq, sk, h,
                         hk, d, scale, causal, stream);
}

extern "C" int flash_attention_bwd_bf16(B9_BWD_ARGS) {
  return backward<uint16_t>(q, k, v, o, dout, lse, dd, dq, dk, dv, b, sq, sk,
                            h, hk, d, scale, causal, stream);
}
