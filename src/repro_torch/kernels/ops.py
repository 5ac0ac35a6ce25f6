"""The merge engine's flat-batch kernel entry points
(`repro/kernels/ops.py`, the routes the engine takes).

Many same-dtype leaves, each zero-padded to a multiple of the tile width
and concatenated into one [k, Np] batch, so every tile belongs to exactly
one leaf: one kernel launch per batch (three for histogram TIES) instead
of one per tensor. The batch is built in place from each leaf's rows, in
the leaves' own dtype (bf16 stays bf16, int8 wire payloads stay int8;
other types widen to fp32), so neither a per-leaf [k, n] stack nor an fp32
copy of a bf16 or int8 batch is made on the way.

The per-leaf entry points over whole contribution pytrees
(`repro.kernels` exports the same six): `weighted_merge`,
`weight_average_merge` and `task_arithmetic_merge` (one `nary_accum`
launch per leaf), `ties_merge` (histogram trim: the flat batch above,
three launches for the whole tree; quantile trim: exact per-row
thresholds, then one `ties_leaf` launch per leaf), `slerp_merge`
(`slerp_reduce` and `slerp_combine` per leaf) and `dare_merge` (one
`dare_block` launch per leaf). Each keeps bf16 rows bf16, hands a leaf
whose length is a tile multiple to the kernels as it is (slerp: the rows
themselves; quantile TIES: one [k, n] stack) and pads only ragged ones,
and casts the fp32 result back to the leaf's dtype; integer leaves raise `TypeError`, as the reference's
`_unpad` guard does (the kernels accumulate in fp32).
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
from repro_torch.kernels.quantile import quantile_threshold
from repro_torch.kernels.slerp import slerp_combine, slerp_reduce, \
    slerp_scalars
from repro_torch.kernels.ties import ties_leaf
from repro_torch.obs import span

# A leaf's k contribution rows: a [k, n] tensor or k tensors of n elements.
Rows = Union[torch.Tensor, Sequence[torch.Tensor]]


def _kernel_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype a kernel reads a leaf's rows in: fp32 and bf16 as they
    are, any other float type widened to fp32."""
    return x.dtype if x.dtype in (torch.float32, torch.bfloat16) \
        else torch.float32


def _flat_batch(leaves: Sequence[Rows],
                base_leaves: Sequence[Optional[torch.Tensor]],
                block: int, dtype: Optional[torch.dtype] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, List[int], List[int]]:
    """(stacked [k, Np], base [Np] fp32, lengths, offsets): leaf j's
    rows start at column offsets[j], zero-padded to a block multiple; a
    None base leaf stays zero. The stack keeps fp32 and bf16 rows as
    they are and widens any other type to fp32, unless `dtype` names its
    type."""
    lengths = [int(rows[0].numel()) for rows in leaves]
    _, _, total = batch_layout(lengths, block)
    first = leaves[0][0]
    if dtype is None:
        dtype = _kernel_dtype(first)
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
        if b is not None:
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


# ------------------------------------------------------------- per-leaf --


def _per_leaf(contribs: Sequence, base=None):
    """(rows per leaf: k tensors; base leaves, None without a base, as
    no zero tree is made; treedef), refusing integer leaves up front."""
    flat = [pytree.flatten(c)[0] for c in contribs]
    leaves0, treedef = pytree.flatten(contribs[0])
    for x in leaves0:
        if not x.dtype.is_floating_point:
            raise TypeError(f"kernel output cannot be cast to {x.dtype}: "
                            "merge kernels accumulate in fp32; integer "
                            "leaves take the exact path")
    bases = treedef.flatten_up_to(base) if base is not None \
        else [None] * len(leaves0)
    rows = [[f[i] for f in flat] for i in range(len(leaves0))]
    return rows, bases, treedef


def _as_leaf(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """An unpadded fp32 row back in the leaf's shape and dtype, cast as
    soon as it is made, so no more than one leaf's fp32 output is live."""
    return out.reshape(like.shape).to(like.dtype)


def weighted_merge(contribs: Sequence, weights: Sequence[float], base=None,
                   *, block: Optional[int] = None):
    """out = base + sum_i w_i (x_i - base) per leaf, one `nary_accum`
    launch per leaf. `weights`: k scalars."""
    rows, bases, treedef = _per_leaf(contribs, base)
    return treedef.unflatten([_as_leaf(nary_flat_merge(
        [[x.reshape(-1) for x in r]], [b], weights, block=block)[0],
        r[0]) for r, b in zip(rows, bases)])


def weight_average_merge(contribs: Sequence, base=None, **kw):
    """The mean of the contributions (any base is ignored, as in the
    reference): weights fp32(1 / k) over a zero base."""
    k = len(contribs)
    return weighted_merge(contribs, [1.0 / k] * k, None, **kw)


def task_arithmetic_merge(contribs: Sequence, base, lam: float = 1.0, **kw):
    """base + lam * sum_i (x_i - base)."""
    return weighted_merge(contribs, [lam] * len(contribs), base, **kw)


def ties_merge(contribs: Sequence, base=None, trim: float = 0.2, *,
               trim_method: str = "histogram",
               block: Optional[int] = None):
    """Fused TIES per leaf. `trim_method="histogram"` (the default)
    resolves the thresholds with the 512-bucket histogram kernels, all
    leaves in one flat batch, as the engine does; `"quantile"` takes the
    exact per-contribution quantile of |x - base| (`quantile.
    quantile_threshold`, one row at a time, traced as the span
    `kernels.quantile_threshold`), then one `ties_leaf` launch per
    leaf."""
    if trim_method not in ("histogram", "quantile"):
        raise ValueError(f"unknown trim_method {trim_method!r}")
    block = kernel_env.block if block is None else block
    rows, bases, treedef = _per_leaf(contribs, base)
    if trim_method == "histogram":
        outs = ties_batch_merge([[x.reshape(-1) for x in r] for r in rows],
                                bases, trim, block=block)
        return treedef.unflatten([_as_leaf(o, r[0])
                                  for o, r in zip(outs, rows)])
    outs = []
    for r, b in zip(rows, bases):
        if b is None:
            b = torch.zeros_like(r[0])              # this leaf's only
        n = b.numel()
        flat = [x.reshape(-1) for x in r]
        with span("kernels.quantile_threshold", n=n, k=len(r)):
            thr = torch.stack([quantile_threshold(x, b.reshape(-1), trim)
                               for x in flat])
        if n % block == 0 and all(x.dtype == _kernel_dtype(x) == r[0].dtype
                                  for x in r):
            stacked = torch.stack(flat)             # [k, n], no padding
            bp = b.reshape(-1).to(torch.float32).contiguous()
        else:
            stacked, bp, _, _ = _flat_batch([flat], [b], block)
        outs.append(_as_leaf(ties_leaf(stacked, bp, thr, block)[:n], r[0]))
        del stacked, bp
    return treedef.unflatten(outs)


def slerp_merge(a, b_tree, t: float = 0.5, *, block: Optional[int] = None):
    """Spherical interpolation of two trees, leaf by leaf: one
    `slerp_reduce` and one `slerp_combine` launch per leaf, the trig
    scalars between them on the device."""
    block = kernel_env.block if block is None else block
    rows, _, treedef = _per_leaf([a, b_tree])
    outs = []
    for u, v in rows:
        n = u.numel()
        dt = _kernel_dtype(u)
        pu, pv = u.reshape(-1), v.reshape(-1)
        if not (n % block == 0 and dt == u.dtype == v.dtype
                and all(x.is_contiguous() and x.data_ptr() % 16 == 0
                        for x in (pu, pv))):
            # ragged, widened or unaligned rows: a padded copy
            uv = torch.zeros((2, padded_len(n, block)), dtype=dt,
                             device=u.device)
            uv[0, :n] = pu
            uv[1, :n] = pv
            pu, pv = uv
        c = slerp_scalars(slerp_reduce(pu, pv, block), t)
        outs.append(_as_leaf(slerp_combine(pu, pv, c, block)[:n], u))
        del pu, pv
    return treedef.unflatten(outs)


def dare_merge(contribs: Sequence, base=None, seed: int = 0,
               p: float = 0.5, *, block: Optional[int] = None):
    """Per-leaf counter-RNG DARE over contribution pytrees: leaf i with
    seed `seed + i`, each leaf one `dare_block` launch."""
    rows, bases, treedef = _per_leaf(contribs, base)
    return treedef.unflatten([_as_leaf(dare_batch_merge(
        [[x.reshape(-1) for x in r]], [b], [seed + i], p,
        block=block)[0], r[0])
        for i, (r, b) in enumerate(zip(rows, bases))])
