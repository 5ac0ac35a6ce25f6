"""The yardstick's arithmetic: one H100's peaks, least-time bounds, the
byte counts of the merge kernels and the operation counts of attention
and of a training step. Frozen: later changes add functions, and edit
none.

Copied from `chip_smoke.py` (`HBM_BYTES_PER_S`, `FP32_OPS_PER_S`,
`BF16_OPS_PER_S`, `bound_ms`) and from PERF.md's kernel table (each
input and output counted once; B9's visible causal pairs), and from
`src/repro_torch/launch/dryrun.py:_model_flops` (6 x non-embedding
parameters x tokens), completed here with attention's causal products.
"""
from __future__ import annotations

from typing import Tuple

# NVIDIA's data sheet, H100 SXM, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
FP32_FLOPS_PER_S = 67e12


def bytes_ms(nbytes: float) -> float:
    """Least milliseconds to move `nbytes` through device memory."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def flops_ms(flops: float, peak: float = BF16_FLOPS_PER_S) -> float:
    """Least milliseconds to compute `flops` at `peak` operations/s."""
    return flops / peak * 1e3


def bound_ms(nbytes: float, flops: float,
             peak: float = BF16_FLOPS_PER_S) -> Tuple[float, str]:
    """(least ms, "bytes" | "operations"): the larger of the two."""
    tb, to = bytes_ms(nbytes), flops_ms(flops, peak)
    return (tb, "bytes") if tb >= to else (to, "operations")


# ------------------------------------------------- merge kernels (bytes)
# Each kernel reads the [k, n] stack in its own dtype and the base row
# widened to fp32, once, and writes its output once; per-tile metadata
# (a few bytes per 2048 columns) is left out as negligible.

def nary_accum_bytes(k: int, n: int, itemsize: int = 2) -> float:
    """B1: k rows + fp32 base in, fp32 out."""
    return float(n) * (k * itemsize + 4 + 4)


def block_amax_bytes(k: int, n: int, itemsize: int = 2) -> float:
    """B3: k rows + fp32 base in (its [tiles, k] output is negligible)."""
    return float(n) * (k * itemsize + 4)


def block_hist_bytes(k: int, n: int, itemsize: int = 2) -> float:
    """B4: k rows + fp32 base in (its per-tile counts are negligible)."""
    return float(n) * (k * itemsize + 4)


def ties_block_bytes(k: int, n: int, itemsize: int = 2) -> float:
    """B5: k rows + fp32 base in, fp32 out."""
    return float(n) * (k * itemsize + 4 + 4)


def ties_hist_bytes(k: int, n: int, itemsize: int = 2) -> float:
    """The three launches of one histogram-TIES batch (B3, B4, B5)."""
    return (block_amax_bytes(k, n, itemsize) + block_hist_bytes(k, n, itemsize)
            + ties_block_bytes(k, n, itemsize))


def resolve_least_bytes(k: int, n_params: int, itemsize: int = 2) -> float:
    """The least bytes of one resolve: k contributions and the base
    read once, the merged tree written once, all in the leaves' dtype."""
    return float(n_params) * itemsize * (k + 2)


# ------------------------------------------------- attention (operations)

def causal_pairs(s: int) -> int:
    """Visible (query, key) pairs of one causal row-head of s tokens."""
    return s * (s + 1) // 2


def b9_forward_flops(b: int, s: int, h: int, d: int) -> float:
    """B9's forward over causal pairs: q.k and p.v, 2 flops a MAC."""
    return 4.0 * b * h * d * causal_pairs(s)


def b9_backward_flops(b: int, s: int, h: int, d: int) -> float:
    """B9's gradient: five products (q.k again, dP, dV, dQ, dK)."""
    return 10.0 * b * h * d * causal_pairs(s)


# ------------------------------------------------- a training step

def train_step_flops(non_embedding_params: int, tokens: int,
                     n_attn_layers: int = 0, n_heads: int = 0,
                     head_dim: int = 0, batch: int = 0,
                     seq_len: int = 0) -> float:
    """Useful flops of one training step: 6 x non-embedding parameters x
    tokens (`_model_flops`), plus attention's causal products once
    forward and twice backward. Remat's recomputation is not useful
    work and is not counted; neither are an SSD's products."""
    flops = 6.0 * non_embedding_params * tokens
    if n_attn_layers:
        flops += 3.0 * n_attn_layers * b9_forward_flops(batch, seq_len,
                                                        n_heads, head_dim)
    return flops
