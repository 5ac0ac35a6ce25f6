"""Per-leaf oracles (`repro/kernels/ref.py`, in PyTorch).

Each batch route must reproduce, for every leaf, what these compute on
that leaf alone. They share the op order of the kernels' plain versions
(index-ordered k sums, a true fp32 division for the cdf, the mean as a
multiply by the fp32 reciprocal of k),
so the comparison is bitwise. `dare_ref` draws its mask over the layout
it is given: hand it the leaf padded to its tile multiple, as a
standalone launch sees it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import hash_uniform, M32
from repro_torch.kernels.dare import rescale_of
from repro_torch.kernels.histogram import _bin_index
from repro_torch.kernels.nary_accum import nary_accum_plain as nary_accum_ref
from repro_torch.kernels.slerp import slerp_scalars
from repro_torch.kernels.ties import ties_tile

__all__ = ["nary_accum_ref", "hist_threshold_ref", "ties_ref",
           "ties_hist_ref", "dare_ref", "quant_nary_ref", "slerp_ref"]


def hist_threshold_ref(stacked, base, trim: float = 0.2,
                       bins: int = 512) -> torch.Tensor:
    """[k, 1] trim thresholds of one leaf: stacked [k, n], base [n]."""
    a = (stacked.to(torch.float32) - base.to(torch.float32)).abs()
    f32 = dict(dtype=torch.float32, device=a.device)
    amax = a.amax(dim=1, keepdim=True) + torch.tensor(1e-12, **f32)
    idx = _bin_index(a, amax, bins)
    counts = torch.stack([torch.bincount(r, minlength=bins) for r in idx])
    cdf = counts.cumsum(dim=1).to(torch.float32) / torch.tensor(
        float(a.shape[1]), **f32)
    bucket = (cdf >= torch.tensor(trim, **f32)).to(torch.uint8).argmax(dim=1)
    return (bucket[:, None].to(torch.float32)
            / torch.tensor(float(bins), **f32)) * amax


def ties_ref(stacked, base, thresholds) -> torch.Tensor:
    """Fused TIES of one leaf with [k, 1] thresholds; [n] fp32."""
    return ties_tile(stacked, base.to(torch.float32), thresholds)


def ties_hist_ref(stacked, base, trim: float = 0.2,
                  bins: int = 512) -> torch.Tensor:
    return ties_ref(stacked, base,
                    hist_threshold_ref(stacked, base, trim, bins))


def dare_ref(stacked, base, seed: int, p: float = 0.5) -> torch.Tensor:
    """DARE of one leaf: stacked [k, N], base [N], mask index
    row * N + col under the uint32 `seed`; [N] fp32."""
    k, n = stacked.shape
    f32 = dict(dtype=torch.float32, device=base.device)
    idx = (torch.arange(k, device=base.device).reshape(-1, 1) * n
           + torch.arange(n, device=base.device)) & M32
    keep = (hash_uniform(idx, seed & M32)
            >= torch.tensor(p, **f32)).to(torch.float32)
    b = base.to(torch.float32)
    tau = (stacked.to(torch.float32) - b) * keep \
        * torch.tensor(rescale_of(p), **f32)
    acc = torch.zeros_like(b)
    for i in range(k):
        acc = acc + tau[i]
    return b + acc * (torch.tensor(1.0, **f32)
                      / torch.tensor(float(k), **f32))


def quant_nary_ref(q_stacked, scales, base, weights) -> torch.Tensor:
    """Dequantize-then-merge: `decompress_tree`'s op (f32(q) * scale)
    per row, then `nary_accum_ref`. q [k, N] int8, scales [k] fp32."""
    x = q_stacked.to(torch.float32) * scales.reshape(-1, 1)
    return nary_accum_ref(x, base, weights)


def slerp_ref(u, v, t: float = 0.5) -> torch.Tensor:
    """SLERP of one pair, u, v [n] -> [n] fp32, straight from the
    formula (`repro/kernels/ref.py:slerp_ref`): whole-row fp32 sums in
    torch's own order, so it is held to the kernel path within a
    tolerance, not bitwise. The trig steps are `slerp_scalars`'."""
    u, v = u.to(torch.float32), v.to(torch.float32)
    sums = torch.stack([(u * v).sum(), (u * u).sum(), (v * v).sum()])
    c = slerp_scalars(sums.reshape(1, 3), t)
    return c[0] * u + c[1] * v
