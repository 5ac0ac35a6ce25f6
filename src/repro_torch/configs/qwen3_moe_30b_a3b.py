"""Qwen3-MoE 30B-A3B [hf:Qwen/Qwen3-30B-A3B].

48L, d_model=2048, 32 heads (GQA kv=4), expert d_ff=768, vocab=151936,
128 experts top-8, head_dim=128 (q inner dim 4096 > d_model), no shared
expert. kv=4 heads do not divide model=16 -> KV projections replicated.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                      # expert width (spec)
    vocab_size=151936,
    mlp_variant="swiglu",
    tie_embeddings=False,
    rope_theta=1000000.0,
    moe=MoEConfig(num_experts=128, top_k=8, d_ff_expert=768),
))
