"""Gemma-2 27B — local+global alternating attention, logit softcaps
[arXiv:2408.00118].

46L, d_model=4608, 32 heads (GQA kv=16), d_ff=36864, vocab=256000.
head_dim=128 (attention inner dim 4096 != d_model), GeGLU MLP, sandwich
norms, attn softcap 50, final logit softcap 30, sliding window 4096 on
alternating (even) layers, query scale 1/sqrt(query_pre_attn_scalar=144).
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=36864,
    vocab_size=256000,
    mlp_variant="geglu",
    tie_embeddings=True,
    attn_softcap=50.0,
    final_softcap=30.0,
    sliding_window=4096,
    local_global_pattern=True,
    sandwich_norms=True,
    query_scale=144.0 ** -0.5,     # query_pre_attn_scalar = d_model/n_heads
    emb_scale=4608.0 ** 0.5,
    rope_theta=10000.0,
))
