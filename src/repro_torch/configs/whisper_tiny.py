"""Whisper-tiny — encoder-decoder audio backbone [arXiv:2212.04356].

4L encoder + 4L decoder, d_model=384, 6 heads, d_ff=1536, vocab=51865.
The conv audio frontend is a stub, as in the reference: a batch carries
precomputed frame embeddings [B, 1500, 384] (`make_batch`'s "frames").
No RoPE (rope_theta 0): sinusoidal positions on the encoder's frames and
the decoder's tokens.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,                    # decoder layers
    n_encoder_layers=4,
    encoder_seq=1500,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51865,
    mlp_variant="gelu",
    tie_embeddings=True,
    rope_theta=0.0,                # whisper uses learned/sinusoidal pos
))
