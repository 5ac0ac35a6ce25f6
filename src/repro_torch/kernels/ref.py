"""Per-leaf oracles (`repro/kernels/ref.py`, in PyTorch).

Each batch route must reproduce, for every leaf, what these compute on
that leaf alone, unpadded. They share the op order of the kernels' plain
versions (index-ordered k sums, a true fp32 division for the cdf), so
the comparison is bitwise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.histogram import _bin_index
from repro_torch.kernels.nary_accum import nary_accum_plain as nary_accum_ref
from repro_torch.kernels.ties import ties_tile

__all__ = ["nary_accum_ref", "hist_threshold_ref", "ties_ref",
           "ties_hist_ref"]


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
