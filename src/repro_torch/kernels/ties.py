"""The fused TIES tile arithmetic (`repro/kernels/ties.py:ties_tile`) and
B7 `ties_leaf`, the per-leaf kernel with one trim threshold per
contribution (`ties_pallas`, in CUDA: `csrc/ties.cu`).

trim -> sign-elect -> agreeing mean over the k rows of each column:
    tau = x - base; trimmed = tau * (|tau| >= thr)
    elected = sign(sum_k trimmed)
    agree = (sign(trimmed) == elected) & (trimmed != 0)
    out = base + sum_k(trimmed * agree) / max(sum_k agree, 1)
Every sum runs over k in index order from zero, in fp32, as the kernels
do; with both pinned, kernel and plain version agree bitwise. `ties_tile`
is the plain version of both B5 (`histogram.ties_block`, per-tile
thresholds) and B7 (one threshold per row).

B7 is bound by device-memory bytes: one read of the [k, Np] stack (bf16
rows stay bf16 and widen in registers) and of the fp32 base, one fp32
write. Its thresholds are the leaf's exact |tau| quantiles
(`quantile.quantile_threshold`).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# columns per chunk of the plain version (bounds its temporaries)
_CHUNK = 1 << 24


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


# ---------------------------------------------------------------- B7


def _check(stacked, base, thr, block: int) -> None:
    if stacked.dim() != 2 or base.dim() != 1 or thr.dim() != 1 \
            or base.shape[0] != stacked.shape[1] \
            or thr.shape[0] != stacked.shape[0]:
        raise ValueError("expected stacked [k, Np], base [Np], thr [k]")
    if stacked.shape[1] % block:
        raise ValueError(f"Np={stacked.shape[1]} is not a multiple of "
                         f"block={block}")
    if stacked.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stacked must be fp32 or bf16, got {stacked.dtype}")
    if base.dtype != torch.float32 or thr.dtype != torch.float32:
        raise TypeError("base and thr must be fp32")


def ties_leaf_plain(stacked, base, thr, block: int) -> torch.Tensor:
    """[Np] fp32: `ties_tile` with one threshold per row."""
    out = torch.empty_like(base)
    th = thr.reshape(-1, 1)
    for c0 in range(0, stacked.shape[1], _CHUNK):
        sl = slice(c0, c0 + _CHUNK)
        out[sl] = ties_tile(stacked[:, sl], base[sl], th)
    return out


def ties_leaf(stacked, base, thr, block: int) -> torch.Tensor:
    """Fused TIES of one padded leaf: stacked [k, Np] fp32|bf16, base [Np]
    fp32, thr [k] fp32 -> [Np] fp32. The CUDA kernel on CUDA tensors, the
    plain version on CPU tensors."""
    _check(stacked, base, thr, block)
    if build.on_host(stacked, base, thr):
        return ties_leaf_plain(stacked, base, thr, block)
    out = torch.empty_like(base)
    symbol = "ties_leaf_bf16" if stacked.dtype == torch.bfloat16 \
        else "ties_leaf_f32"
    code = build.function(symbol)(
        stacked.data_ptr(), base.data_ptr(), thr.data_ptr(), out.data_ptr(),
        stacked.shape[0], stacked.shape[1],
        torch.cuda.current_stream(stacked.device).cuda_stream)
    ties_leaf.launches += 1
    build.check(code, symbol)
    return out


ties_leaf.launches = 0
