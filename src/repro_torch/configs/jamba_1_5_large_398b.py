"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7, MoE [arXiv:2403.19887].

72L, d_model=8192, 64 heads (GQA kv=8), d_ff=24576, vocab=65536,
MoE 16 experts top-2 on every 2nd layer. Period-8 blocks: layer 4 of each
period is attention, the other 7 are mamba mixers. Runs long_500k (hybrid).
bf16 Adam moments (398B fp32 moments would not fit 16 GB/chip).

The reference keeps the default `rope_theta`, so its attention layers
apply RoPE, where the published model uses no positional encoding; the
port follows the reference (ROADMAP C, reference-side hazards).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, MoEConfig, \
    register

CONFIG = register(ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    mlp_variant="swiglu",
    tie_embeddings=False,
    hybrid_period=8,
    hybrid_attn_index=4,
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=128,
                      n_groups=1, chunk_size=256),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff_expert=24576,
                  interval=2, offset=1),
    supports_long_context=True,
    opt_state_dtype="bfloat16",
))
