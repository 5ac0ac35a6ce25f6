"""The merge engine's flat-batch kernel entry points
(`repro/kernels/ops.py`, the routes the engine takes).

Many same-dtype leaves, each zero-padded to a multiple of the tile width
and concatenated into one [k, Np] batch, so every tile belongs to exactly
one leaf: one kernel launch per batch (three for histogram TIES) instead
of one per tensor. The batch is built in place from each leaf's rows, in
the leaves' own dtype (bf16 stays bf16, int8 wire payloads stay int8;
other types widen to fp32), so neither a per-leaf [k, n] stack nor an fp32
copy of a bf16 or int8 batch is made on the way.

`dare_merge` is the per-leaf entry point over whole contribution trees;
it launches the same `dare_block` kernel, one leaf at a time.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from repro_torch import pytree
from repro_torch.kernels.common import padded_len
from repro_torch.kernels.config import kernel_env
from repro_torch.kernels.dare import dare_block, leaf_meta
from repro_torch.kernels.histogram import batch_layout, ties_hist_batch
from repro_torch.kernels.nary_accum import nary_accum
from repro_torch.kernels.quant import quant_nary

# A leaf's k contribution rows: a [k, n] tensor or k tensors of n elements.
Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


def _flat_batch(leaves: Sequence[Rows], base_leaves: Sequence[torch.Tensor],
                block: int, dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, List[int], List[int]]:
    """(stacked [k, Np], base [Np] fp32, lengths, offsets): leaf j's
    rows start at column offsets[j], zero-padded to a block multiple.
    The stack keeps fp32 and bf16 rows as they are and widens any other
    type to fp32, unless `dtype` names its type."""
    lengths = [int(b.numel()) for b in base_leaves]
    _, _, total = batch_layout(lengths, block)
    first = leaves[0][0]
    if dtype is None:
        dtype = first.dtype if first.dtype in (torch.float32,
                                               torch.bfloat16) \
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


def dare_batch_merge(leaves: Sequence[Rows],
                     base_leaves: Sequence[torch.Tensor],
                     seeds: Sequence[int], p: float = 0.5, *,
                     block: Optional[int] = None) -> List[torch.Tensor]:
    """Counter-RNG DARE over many leaves in one `dare_block` launch,
    bitwise per leaf equal to a launch over that leaf alone with the
    same seed. `seeds[j]` is leaf j's seed; its low 32 bits are used.
    Returns unpadded fp32 1-D tensors."""
    block = kernel_env.block if block is None else block
    stacked, base, lengths, offsets = _flat_batch(leaves, base_leaves,
                                                  block)
    meta = torch.cat([leaf_meta(s, padded_len(n, block), block,
                                device=base.device)
                      for s, n in zip(seeds, lengths)])
    out = dare_block(stacked, base, meta, p, block)
    return _split_flat(out, lengths, offsets)


def quant_batch_merge(q_leaves: Sequence[Rows],
                      scales: Sequence[torch.Tensor],
                      base_leaves: Sequence[torch.Tensor],
                      weights: Sequence[float], *,
                      block: Optional[int] = None) -> List[torch.Tensor]:
    """int8 merge-on-arrival over many leaves in one `quant_nary`
    launch. `q_leaves[j]`: leaf j's k int8 rows; `scales[j]`: [k] fp32
    dequantization scales; `weights`: k scalars. Bitwise per leaf equal
    to `ref.quant_nary_ref`. Returns unpadded fp32 1-D tensors."""
    block = kernel_env.block if block is None else block
    if q_leaves[0][0].dtype != torch.int8:
        raise TypeError(f"q rows must be int8, got {q_leaves[0][0].dtype}")
    stacked, base, lengths, offsets = _flat_batch(q_leaves, base_leaves,
                                                  block, torch.int8)
    leaf_id, _, _ = batch_layout(lengths, block)
    lid = torch.tensor(leaf_id, dtype=torch.int64, device=base.device)
    scale_meta = torch.stack([s.reshape(-1).to(torch.float32)
                              for s in scales])[lid].contiguous()
    w = torch.tensor(list(weights), dtype=torch.float32, device=base.device)
    out = quant_nary(stacked, base, scale_meta, w, block)
    return _split_flat(out, lengths, offsets)


def dare_merge(contribs: Sequence, base=None, seed: int = 0,
               p: float = 0.5, *, block: Optional[int] = None):
    """Per-leaf counter-RNG DARE over contribution pytrees: leaf i with
    seed `seed + i`, each leaf one `dare_block` launch. Float leaves
    only (the kernel accumulates in fp32)."""
    flat = [pytree.flatten(c)[0] for c in contribs]
    leaves0, treedef = pytree.flatten(contribs[0])
    bases = treedef.flatten_up_to(base) if base is not None \
        else [torch.zeros_like(x) for x in leaves0]
    outs = []
    for i, (x0, b) in enumerate(zip(leaves0, bases)):
        if not x0.dtype.is_floating_point:
            raise TypeError(f"kernel output cannot be cast to "
                            f"{x0.dtype}: merge kernels accumulate in "
                            "fp32; integer leaves take the exact path")
        rows = [f[i].reshape(-1) for f in flat]
        out, = dare_batch_merge([rows], [b.reshape(-1).to(torch.float32)],
                                [seed + i], p, block=block)
        outs.append(out.reshape(x0.shape).to(x0.dtype))
    return treedef.unflatten(outs)
