"""Plain reference of the "dense" family's training loss: a pre-norm
decoder (Phi-3-mini, arXiv:2404.14219, on the Llama-2 block): token
embedding; per layer RMSNorm, multi-head causal attention with RoPE on
the two halves of each head (theta from the file, softmax scale
1/sqrt(head_dim)), the residual, RMSNorm, a SiLU-gated MLP, the
residual; a final RMSNorm; an untied output head; the mean next-token
cross-entropy over every position but the last.

Plain PyTorch in the precision the caller's `mm` gives the products
(fp32 with TF32 off for the reference). Attention runs in blocks of
queries so that no [S, S] score matrix of all heads is alive at once.
Each layer runs under `torch.utils.checkpoint`, so a row of 4096 tokens
keeps only the layers' inputs for the backward.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

Q_BLOCK = 512


def rmsnorm(w, x, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x, theta: float):
    """x [S, H, D]: rotate (first half, second half) pairs by position."""
    s, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, mm: Callable):
    """q, k, v [S, H, D] -> [S, H * D], causal, in query blocks."""
    s, h, d = q.shape
    scale = d ** -0.5
    qh, kh, vh = (t.transpose(0, 1) for t in (q, k, v))      # [H, S, D]
    outs = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        sc = mm(qh[:, q0:q1], kh[:, :q1].transpose(1, 2)) * scale
        mask = torch.arange(q0, q1, device=q.device)[:, None] \
            >= torch.arange(q1, device=q.device)[None, :]
        p = torch.softmax(sc.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(mm(p, vh[:, :q1]))
    return torch.cat(outs, dim=1).transpose(0, 1).reshape(s, h * d)


def layer(cfg: Dict, mm: Callable, x, pre, wq, wk, wv, wo, post, wg, wu,
          wd):
    s = x.shape[0]
    h, hd = cfg["n_heads"], cfg["head_dim"]
    hk = cfg["n_kv_heads"]
    y = rmsnorm(pre, x, cfg["rms_eps"])
    q = rope(mm(y, wq).reshape(s, h, hd), cfg["rope_theta"])
    k = rope(mm(y, wk).reshape(s, hk, hd), cfg["rope_theta"])
    v = mm(y, wv).reshape(s, hk, hd)
    if hk != h:
        k = k.repeat_interleave(h // hk, dim=1)
        v = v.repeat_interleave(h // hk, dim=1)
    x = x + mm(attention(q, k, v, mm), wo)
    y = rmsnorm(post, x, cfg["rms_eps"])
    return x + mm(F.silu(mm(y, wg)) * mm(y, wu), wd)


def row_loss(cfg: Dict, p: Dict, tokens: torch.Tensor, mm: Callable):
    """Mean cross-entropy of one row of tokens [S]; p maps the layout's
    paths to tensors (autograd leaves)."""
    blk = ("blocks", "sub0")
    x = p[("embed",)][tokens]
    for i in range(cfg["n_layers"]):
        x = checkpoint(
            layer, cfg, mm, x, p[blk + ("pre_norm",)][i],
            *(p[blk + ("attn", w)][i] for w in ("wq", "wk", "wv", "wo")),
            p[blk + ("ffn_norm",)][i],
            *(p[blk + ("ffn", w)][i] for w in ("w_gate", "w_up", "w_down")),
            use_reentrant=False)
    x = rmsnorm(p[("final_norm",)], x, cfg["rms_eps"])
    head = p[("embed",)].T if cfg["tie_embeddings"] else p[("lm_head",)]
    logits = mm(x[:-1], head)
    return F.cross_entropy(logits, tokens[1:])
