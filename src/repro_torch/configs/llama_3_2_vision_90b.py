"""Llama-3.2-Vision 90B backbone [hf:meta-llama/Llama-3.2-11B-Vision].

100L, d_model=8192, 64 heads (GQA kv=8), d_ff=28672, vocab=128256.
Every 5th layer is a gated cross-attention layer over patch embeddings
(tanh gates on its mixer's and its FFN's outputs, initialised to 0); the
vision frontend is a stub, as in the reference: a batch carries
precomputed patch embeddings [B, 1601, 8192] (`make_batch`'s "patches").
bf16 Adam moments.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    mlp_variant="swiglu",
    tie_embeddings=False,
    rope_theta=500000.0,
    cross_attn_interval=5,
    num_patches=1601,
    opt_state_dtype="bfloat16",
))
