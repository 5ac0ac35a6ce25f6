"""Shared layer library (`repro.models.layers`, the dense family's part):
norms, RoPE, MLPs and GQA attention, with gemma2's sliding window and
logit softcap.

Everything is a plain function over a param dict, in the reference's
order of operations and roundings. Attention goes to B9
(`kernels.flash_attention`), which takes the place of the reference's
query-chunked `chunked_attention` and applies its softcap and window
mask (`_attn_core`): on CUDA tensors its CUDA kernel, on CPU tensors
its plain version. Both keep p . v in fp32, where `chunked_attention`
rounds the probabilities to the compute dtype first (`layers.py:144`):
in bf16 the two differ by that rounding.

`sinusoidal_positions` (whisper) serves another family and waits for
ROADMAP A7.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.schema import PDef

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def rmsnorm_def(d: int) -> PDef:
    return PDef((d,), (None,), init="ones")


def rmsnorm(w, x, eps: float = 1e-6):
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * w.to(torch.float32)).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x, positions, theta: float):
    """x: [..., S, H, D]; positions: [S] integer positions."""
    if theta <= 0.0:
        return x
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)          # [D/2]
    ang = positions[..., None].to(torch.float32) * freqs   # [S, D/2]
    cos = torch.cos(ang)[..., None, :]                     # [S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_def(d: int, f: int, variant: str, scale: float) -> dict:
    if variant in ("swiglu", "geglu"):
        return {
            "w_gate": PDef((d, f), ("fsdp", "tp"), scale=scale),
            "w_up": PDef((d, f), ("fsdp", "tp"), scale=scale),
            "w_down": PDef((f, d), ("tp", "fsdp"), scale=scale),
        }
    return {  # non-gated (relu2 / gelu)
        "w_up": PDef((d, f), ("fsdp", "tp"), scale=scale),
        "w_down": PDef((f, d), ("tp", "fsdp"), scale=scale),
    }


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp(p: dict, x, variant: str, compute_dtype):
    x = x.to(compute_dtype)
    if variant in ("swiglu", "geglu"):
        g = x @ p["w_gate"].to(compute_dtype)
        u = x @ p["w_up"].to(compute_dtype)
        act = F.silu(g) if variant == "swiglu" else _gelu(g)
        h = act * u
    else:
        u = x @ p["w_up"].to(compute_dtype)
        if variant == "relu2":
            r = F.relu(u)
            h = r * r
        else:
            h = _gelu(u)
    return h @ p["w_down"].to(compute_dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def attn_def(d: int, n_heads: int, n_kv: int, head_dim: int,
             scale: float) -> dict:
    return {
        "wq": PDef((d, n_heads * head_dim), ("fsdp", "tp"), scale=scale),
        "wk": PDef((d, n_kv * head_dim), ("fsdp", "tp"), scale=scale),
        "wv": PDef((d, n_kv * head_dim), ("fsdp", "tp"), scale=scale),
        "wo": PDef((n_heads * head_dim, d), ("tp", "fsdp"), scale=scale),
    }


def gqa_attention(p: dict, x, *, n_heads: int, n_kv: int, head_dim: int,
                  rope_theta: float, window: int = 0, softcap: float = 0.0,
                  q_scale: float = 0.0, compute_dtype=torch.bfloat16,
                  attention: Optional[Callable] = None):
    """Causal self-attention sub-layer (projections, RoPE, B9 with the
    sliding `window` and logit `softcap` of the reference's
    `gqa_attention`, output projection). No cache. B9 tiles the queries
    itself, so the reference's `q_chunk` has no counterpart; its
    cross-attention (`kv_x`) and offset queries serve the enc-dec and
    VLM families (ROADMAP A7). `attention` replaces B9 with a function
    of its signature (the chip smoke passes B9's plain version, to
    compare the two on the card)."""
    attend = attention or flash_attention
    b, s, _ = x.shape
    x = x.to(compute_dtype)
    q = (x @ p["wq"].to(compute_dtype)).reshape(b, s, n_heads, head_dim)
    k = (x @ p["wk"].to(compute_dtype)).reshape(b, s, n_kv, head_dim)
    v = (x @ p["wv"].to(compute_dtype)).reshape(b, s, n_kv, head_dim)
    if rope_theta > 0.0:
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    out = attend(q, k, v, causal=True, scale=q_scale, window=window,
                 softcap=softcap)
    out = out.reshape(b, s, n_heads * head_dim)
    return out @ p["wo"].to(compute_dtype)
