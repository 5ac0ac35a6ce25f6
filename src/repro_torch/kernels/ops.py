"""The merge engine's flat-batch kernel entry points
(`repro/kernels/ops.py`, the routes the engine takes).

Many same-dtype leaves, each zero-padded to a multiple of the tile width
and concatenated into one [k, Np] batch, so every tile belongs to exactly
one leaf: one kernel launch per batch (three for histogram TIES) instead
of one per tensor. The batch is built in place from each leaf's rows, in
the leaves' own dtype (bf16 stays bf16; other float types go to fp32),
so neither a per-leaf [k, n] stack nor an fp32 copy of a bf16 batch is
made on the way.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch.kernels.common import padded_len
from repro_torch.kernels.config import kernel_env
from repro_torch.kernels.histogram import batch_layout, ties_hist_batch
from repro_torch.kernels.nary_accum import nary_accum

# A leaf's k contribution rows: a [k, n] tensor or k tensors of n elements.
Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


def _flat_batch(leaves: Sequence[Rows], base_leaves: Sequence[torch.Tensor],
                block: int) -> Tuple[torch.Tensor, torch.Tensor, List[int],
                                     List[int]]:
    """(stacked [k, Np], base [Np] fp32, lengths, offsets): leaf j's
    rows start at column offsets[j], zero-padded to a block multiple."""
    lengths = [int(b.numel()) for b in base_leaves]
    _, _, total = batch_layout(lengths, block)
    first = leaves[0][0]
    dtype = first.dtype if first.dtype in (torch.float32, torch.bfloat16) \
        else torch.float32
    k = len(leaves[0])
    stacked = torch.zeros((k, total), dtype=dtype, device=first.device)
    base = torch.zeros((total,), dtype=torch.float32, device=first.device)
    offsets = []
    off = 0
    for rows, b, n in zip(leaves, base_leaves, lengths):
        if len(rows) != k:
            raise ValueError("every leaf of a batch needs the same k")
        for i in range(k):
            stacked[i, off:off + n] = rows[i].reshape(-1)
        base[off:off + n] = b.reshape(-1)
        offsets.append(off)
        off += padded_len(n, block)
    return stacked, base, lengths, offsets


def _split_flat(out: torch.Tensor, lengths: Sequence[int],
                offsets: Sequence[int]) -> List[torch.Tensor]:
    return [out[off:off + n] for off, n in zip(offsets, lengths)]


def ties_batch_merge(leaves: Sequence[Rows],
                     base_leaves: Sequence[torch.Tensor],
                     trim: float = 0.2, *, bins: Optional[int] = None,
                     block: Optional[int] = None) -> List[torch.Tensor]:
    """Histogram-trim TIES over many leaves in one flat-batch dispatch
    (block_amax, block_hist, ties_block). Bitwise per leaf equal to
    `ref.ties_hist_ref`. Returns unpadded fp32 1-D tensors."""
    block = kernel_env.block if block is None else block
    bins = kernel_env.hist_bins if bins is None else bins
    stacked, base, lengths, offsets = _flat_batch(leaves, base_leaves,
                                                  block)
    out = ties_hist_batch(stacked, base, lengths, trim=trim, bins=bins,
                          block=block)
    return _split_flat(out, lengths, offsets)


def nary_flat_merge(leaves: Sequence[Rows],
                    base_leaves: Sequence[torch.Tensor],
                    weights: Sequence[float], *,
                    block: Optional[int] = None) -> List[torch.Tensor]:
    """out = base + sum_i w_i (x_i - base) over many leaves in one
    launch. `weights`: k scalars. Returns unpadded fp32 1-D tensors."""
    block = kernel_env.block if block is None else block
    stacked, base, lengths, offsets = _flat_batch(leaves, base_leaves,
                                                  block)
    w = torch.tensor(list(weights), dtype=torch.float32,
                     device=stacked.device)
    return _split_flat(nary_accum(stacked, base, w), lengths, offsets)
