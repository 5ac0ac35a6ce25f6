"""DeepSeek-V2 236B — MLA + fine-grained MoE [arXiv:2405.04434].

60L, d_model=5120, 128 heads, MLA kv_lora=512 (rope head 64), expert
d_ff=1536, vocab=102400, 160 routed experts top-6 + 2 shared. First layer
uses a dense FFN (d_ff=12288) as in the paper; bf16 Adam moments so the
full fp32-master-free state fits 16 GB/chip at 512 chips.
"""
from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      register)

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,                # MLA: logical heads (cache is latent)
    head_dim=128,
    d_ff=12288,                    # dense FFN width (layer 0)
    vocab_size=102400,
    mlp_variant="swiglu",
    tie_embeddings=False,
    rope_theta=10000.0,
    mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536,
                  d_head_nope=128, d_head_rope=64, d_head_v=128),
    moe=MoEConfig(num_experts=160, top_k=6, d_ff_expert=1536,
                  num_shared_experts=2, d_ff_shared=1536,
                  interval=1, offset=1),   # layer 0 dense, rest MoE
    opt_state_dtype="bfloat16",
))
