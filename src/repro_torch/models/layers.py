"""Shared layer library (`repro.models.layers`): norms, RoPE, sinusoidal
positions, MLPs and GQA attention (self- or cross-attention, causal or
not), with gemma2's sliding window and logit softcap.

Everything is a plain function over a param dict, in the reference's
order of operations and roundings. Attention goes to B9
(`kernels.flash_attention`), which takes the place of the reference's
query-chunked `chunked_attention` and applies its softcap and window
mask (`_attn_core`): on CUDA tensors its CUDA kernel, on CPU tensors
its plain version. Both keep p . v in fp32, where `chunked_attention`
rounds the probabilities to the compute dtype first (`layers.py:144`):
in bf16 the two differ by that rounding. B9 masks the keys past Sk
with or without `causal`, as `chunked_attention` (which never pads keys)
sees them: Whisper's 1500 encoder frames and the VLM's 1601 patches are
not multiples of a key tile.
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


def _sinusoid(pos: torch.Tensor, d: int) -> torch.Tensor:
    """[..., d] fp32: sin(pos * div) at the even columns, cos at the odd
    ones, for fp32 positions `pos` [...], with the reference's
    frequencies div = exp(arange(0, d, 2) * (-log(10000) / d))."""
    scale = (-torch.log(torch.tensor(10000.0, dtype=torch.float32))
             / d).item()
    div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                 device=pos.device) * scale)
    ang = pos[..., None] * div
    return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1) \
        .reshape(pos.shape + (d,))


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """[seq, d] fp32 sinusoidal positions (Whisper's frames and tokens)."""
    return _sinusoid(torch.arange(seq, dtype=torch.float32, device=device),
                     d)


def sinusoidal_at(pos: int, d: int, device=None) -> torch.Tensor:
    """[1, 1, d] fp32: row `pos` of `sinusoidal_positions` on the same
    device, bit for bit (the same products and functions; a decode step's
    position, the reference's `_sinusoidal_at`). The position is filled
    on the device, so no copy from the host waits on it."""
    p = torch.full((1, 1), float(pos), dtype=torch.float32, device=device)
    return _sinusoid(p, d)


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
             scale: float, kv_input_dim: int = 0) -> dict:
    dk = kv_input_dim or d
    return {
        "wq": PDef((d, n_heads * head_dim), ("fsdp", "tp"), scale=scale),
        "wk": PDef((dk, n_kv * head_dim), ("fsdp", "tp"), scale=scale),
        "wv": PDef((dk, n_kv * head_dim), ("fsdp", "tp"), scale=scale),
        "wo": PDef((n_heads * head_dim, d), ("tp", "fsdp"), scale=scale),
    }


def gqa_attention(p: dict, x, *, n_heads: int, n_kv: int, head_dim: int,
                  rope_theta: float, causal: bool = True, window: int = 0,
                  softcap: float = 0.0, q_scale: float = 0.0,
                  compute_dtype=torch.bfloat16, kv_x=None,
                  use_rope: bool = True,
                  attention: Optional[Callable] = None):
    """Attention sub-layer (projections, RoPE, B9 with the sliding
    `window` and logit `softcap` of the reference's `gqa_attention`,
    output projection). No cache. With `kv_x` the keys and values are
    projected from it (cross-attention over Whisper's encoder output or
    the VLM's patches), without `causal` every query sees every key, and
    without `use_rope` no RoPE is applied. B9 tiles the queries itself,
    so the reference's `q_chunk` has no counterpart. `attention` replaces
    B9 with a function of its signature (the chip smoke passes B9's
    plain version, to compare the two on the card)."""
    attend = attention or flash_attention
    b, s, _ = x.shape
    x = x.to(compute_dtype)
    kv_src = x if kv_x is None else kv_x.to(compute_dtype)
    sk = kv_src.shape[1]
    q = (x @ p["wq"].to(compute_dtype)).reshape(b, s, n_heads, head_dim)
    k = (kv_src @ p["wk"].to(compute_dtype)).reshape(b, sk, n_kv, head_dim)
    v = (kv_src @ p["wv"].to(compute_dtype)).reshape(b, sk, n_kv, head_dim)
    if use_rope and rope_theta > 0.0:
        q = apply_rope(q, torch.arange(s, device=x.device), rope_theta)
        k = apply_rope(k, torch.arange(sk, device=x.device), rope_theta)
    out = attend(q, k, v, causal=causal, scale=q_scale, window=window,
                 softcap=softcap)
    out = out.reshape(b, s, n_heads * head_dim)
    return out @ p["wo"].to(compute_dtype)
