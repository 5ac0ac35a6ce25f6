"""MiniCPM-2B — WSD schedule, llama-like [arXiv:2404.06395].

40L, d_model=2304, 36 heads (MHA: kv=36), d_ff=5760, vocab=122753.
MiniCPM uses µP-style depth-scaled residuals (scale_depth=1.4) and tied
embeddings with an output logit multiplier. 36 heads do not divide the
16-way model axis -> attention weights stay TP-replicated (see DESIGN.md).
"""
import math

from repro_torch.configs.base import ModelConfig, register

_SCALE_DEPTH = 1.4

CONFIG = register(ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    mlp_variant="swiglu",
    tie_embeddings=True,
    residual_scale=_SCALE_DEPTH / math.sqrt(40),
    logit_mult=1.0 / 9.0,          # d_model / dim_model_base(256)
    emb_scale=12.0,
    schedule="wsd",
    rope_theta=10000.0,
))
