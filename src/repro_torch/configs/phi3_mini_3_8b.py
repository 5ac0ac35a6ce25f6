"""Phi-3-mini 3.8B — RoPE + SwiGLU + (here) MHA [arXiv:2404.14219].

32L, d_model=3072, 32 heads (kv=32), d_ff=8192, vocab=32064.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi3-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_variant="swiglu",
    tie_embeddings=False,
    rope_theta=10000.0,
))
