"""Mamba2-780m — SSD (state-space duality) [arXiv:2405.21060].

48L, d_model=1536, attention-free, vocab=50280, ssm_state=128.
d_inner = 2*d_model = 3072, head_dim=64 -> 48 SSD heads. Runs long_500k
(O(1) recurrent decode state).
"""
from repro_torch.configs.base import MambaConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    n_layers=48,
    d_model=1536,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    mamba=MambaConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk_size=256),
    supports_long_context=True,
))
