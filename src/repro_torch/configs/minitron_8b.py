"""Minitron-8B — pruned Nemotron [arXiv:2407.14679].

32L, d_model=4096, 32 heads (GQA kv=8), d_ff=16384, vocab=256000.
Minitron/Nemotron uses a squared-ReLU *non-gated* MLP and untied embeddings.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=256000,
    mlp_variant="relu2",
    tie_embeddings=False,
    rope_theta=500000.0,
))
