"""The fused TIES tile arithmetic (`repro/kernels/ties.py:ties_tile`),
as the plain PyTorch version of the `ties_block` CUDA kernel.

trim -> sign-elect -> agreeing mean over the k rows of each column:
    tau = x - base; trimmed = tau * (|tau| >= thr)
    elected = sign(sum_k trimmed)
    agree = (sign(trimmed) == elected) & (trimmed != 0)
    out = base + sum_k(trimmed * agree) / max(sum_k agree, 1)
Every sum runs over k in index order from zero, in fp32, as the kernel
does; with both pinned the two agree bitwise.
"""
from __future__ import annotations

import torch


def ties_tile(x: torch.Tensor, base: torch.Tensor,
              thr: torch.Tensor) -> torch.Tensor:
    """x [k, n] fp32|bf16, base [n] fp32, thr [k, n] (or broadcastable)
    fp32 -> [n] fp32."""
    k = x.shape[0]
    trimmed = []
    s = torch.zeros_like(base)
    for i in range(k):
        t = x[i].to(torch.float32) - base
        tr = t * (t.abs() >= thr[i]).to(torch.float32)
        trimmed.append(tr)
        s = s + tr
    elected = torch.sign(s)
    cnt = torch.zeros_like(base)
    acc = torch.zeros_like(base)
    for tr in trimmed:
        ag = ((torch.sign(tr) == elected) & (tr != 0)).to(torch.float32)
        cnt = cnt + ag
        acc = acc + tr * ag
    return base + acc / torch.clamp_min(cnt, 1.0)
