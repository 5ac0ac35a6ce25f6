"""Histogram-trim TIES over a block-aligned flat batch: three kernels
and the glue between them (`repro/kernels/histogram.py`, on CUDA).

  pass A  `block_amax`  (B3) per-tile max|tau| -> segment max over the
          leaf's tiles, + 1e-12 (exact: max is associative)
  pass B  `block_hist`  (B4) per-tile |tau| histograms -> segment sum
          (exact integer counts)
  resolve `hist_thresholds`: cdf / first crossing / scale per (leaf,
          contribution), O(L*k*bins) scalars in plain torch
  pass C  `ties_block`  (B5) fused trim / sign-elect / agreeing mean
          with per-tile thresholds

Each wrapper launches its CUDA kernel (`csrc/histogram.cu`) for CUDA
tensors and runs its plain version, in this module, for CPU tensors;
the two agree bitwise. All three are bound by device-memory bytes:
each streams the [k, Np] stack once. The kernels read bf16 stacks as
bf16 and widen in registers, so the batch is never copied to fp32 in
device memory (the reference pads an fp32 copy; widening is exact, so
the result is the same).

Layout: `stacked` [k, Np] fp32|bf16 holds L leaves, each zero-padded to
a multiple of `block` and concatenated; `base` [Np] fp32; per-tile
metadata rows are indexed by `leaf_id` [nb]; `valid` [nb] int32 counts
each tile's unpadded columns.

Counts: the reference sums fp32 counts, exact only below 2^24 per
bucket and cdf entry; the port sums exact integers and rounds the
cumulative count to fp32 once, before the division by n. Below 2^24
the two agree bitwise.

B3 and B4 run one warp per tile over all k contributions, reading the
tile's base once and x in 16-byte loads; B5 one CTA per tile, its k
thresholds read once, a thread on 8 (or 4) adjacent columns of all k
rows in 16-byte loads, with an instance per exact k up to 16. So on
CUDA tensors `block` must be a multiple of 8 and `stacked`, `base` and
the output 16-byte aligned, else the wrapper raises. `hist_plan` sizes
B4's launch.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.common import padded_len
from repro_torch.kernels.config import block_name
from repro_torch.kernels.ties import ties_tile

# columns per chunk of the plain versions (bounds their temporaries)
_PLAIN_CHUNK = 1 << 24
# B4's launch plan (`csrc/histogram.cu` `hist_plan` is the same rule):
# the shared memory one block can use on an H100, a warp's share of
# histogram counters, and the most warps (tiles) a block
SMEM_PER_BLOCK = 232_448
_WARP_SMEM = 16 * 1024
_HIST_WARPS = 4


def _tiles(stacked: torch.Tensor, block: int) -> int:
    k, np_ = stacked.shape
    if np_ % block:
        raise ValueError(f"Np={np_} is not a multiple of block={block}")
    return np_ // block


def _check_inputs(stacked, base) -> None:
    if stacked.dim() != 2 or base.dim() != 1 \
            or base.shape[0] != stacked.shape[1]:
        raise ValueError("expected stacked [k, Np] and base [Np]")
    if stacked.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"stacked must be fp32 or bf16, got {stacked.dtype}")
    if base.dtype != torch.float32:
        raise TypeError("base must be fp32")


def _check_vectors(block: int, *tensors) -> None:
    """B3-B5 on CUDA read 8 adjacent columns in 16-byte loads."""
    if block % 8:
        raise ValueError(f"{block_name(block)}: on CUDA the block must be "
                         "a multiple of 8")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("stacked, base and the output must be 16-byte "
                         "aligned")


def _launch(symbol: str, *args) -> None:
    build.check(build.function(symbol)(*args), symbol)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _suffix(t: torch.Tensor) -> str:
    return "bf16" if t.dtype == torch.bfloat16 else "f32"


# ---------------------------------------------------------------- B3 amax


def block_amax_plain(stacked, base, block: int) -> torch.Tensor:
    """[nb, k] fp32: per tile and contribution, max|x - base| (NaN
    propagates, as jnp.max)."""
    k = stacked.shape[0]
    nb = _tiles(stacked, block)
    out = torch.empty((nb, k), dtype=torch.float32, device=stacked.device)
    step = max(1, _PLAIN_CHUNK // block)
    for t0 in range(0, nb, step):
        t1 = min(nb, t0 + step)
        sl = slice(t0 * block, t1 * block)
        a = (stacked[:, sl].to(torch.float32) - base[sl]).abs()
        out[t0:t1] = a.reshape(k, t1 - t0, block).amax(dim=2).T
    return out


def block_amax(stacked, base, block: int) -> torch.Tensor:
    _check_inputs(stacked, base)
    nb = _tiles(stacked, block)
    if build.on_host(stacked, base):
        return block_amax_plain(stacked, base, block)
    k = stacked.shape[0]
    out = torch.empty((nb, k), dtype=torch.float32, device=stacked.device)
    _check_vectors(block, stacked, base, out)
    _launch(f"block_amax_{_suffix(stacked)}", stacked.data_ptr(),
            base.data_ptr(), out.data_ptr(), k, stacked.shape[1], block,
            _stream(stacked))
    block_amax.launches += 1
    return out


block_amax.launches = 0


# ---------------------------------------------------------------- B4 hist


def _bin_index(a, amax, bins: int):
    """clip(int(a / amax * bins), 0, bins - 1): divide, then multiply,
    as the reference bins (no reciprocal)."""
    return (a / amax * float(bins)).to(torch.int32).clamp_(0, bins - 1)


def hist_plan(k: int, bins: int) -> Tuple[int, int, int]:
    """(warps per block, contributions per pass, dynamic shared bytes)
    of B4's launch, from the shapes alone. Each warp owns one tile and a
    private [group, bins] int32 histogram: as many contributions as fit
    its 16 KB share (at least one, at most k), then as many warps (at
    most 4) as fit a block."""
    row = 4 * bins
    if k < 1 or bins < 1 or row > SMEM_PER_BLOCK:
        raise ValueError(f"no B4 launch for k={k}, bins={bins}: one "
                         f"bins-wide histogram takes {row} bytes, a block "
                         f"has {SMEM_PER_BLOCK}")
    group = max(1, min(k, _WARP_SMEM // row))
    warps = min(_HIST_WARPS, SMEM_PER_BLOCK // (group * row))
    return warps, group, warps * group * row


def block_hist_plain(stacked, base, amax_meta, valid, bins: int,
                     block: int) -> torch.Tensor:
    """[nb, k * bins] int32 counts of the bin index over each tile's
    valid columns."""
    k = stacked.shape[0]
    nb = _tiles(stacked, block)
    out = torch.empty((nb, k * bins), dtype=torch.int32,
                      device=stacked.device)
    col = torch.arange(block, device=stacked.device)
    step = max(1, _PLAIN_CHUNK // block)
    for t0 in range(0, nb, step):
        t1 = min(nb, t0 + step)
        n = t1 - t0
        sl = slice(t0 * block, t1 * block)
        a = (stacked[:, sl].to(torch.float32) - base[sl]).abs() \
            .reshape(k, n, block)
        am = amax_meta[t0:t1].T.reshape(k, n, 1)
        idx = _bin_index(a, am, bins).to(torch.int64)
        # one bincount over (tile, contribution, bucket); masked
        # columns go to one overflow slot past the end
        seg = (torch.arange(n, device=a.device).reshape(1, n, 1) * k
               + torch.arange(k, device=a.device).reshape(k, 1, 1)) * bins
        keep = col.reshape(1, 1, block) < valid[t0:t1].reshape(1, n, 1)
        flat = torch.where(keep, seg + idx, torch.full_like(idx, n * k * bins))
        counts = torch.bincount(flat.reshape(-1), minlength=n * k * bins + 1)
        out[t0:t1] = counts[:n * k * bins].reshape(n, k * bins).to(
            torch.int32)
    return out


def block_hist(stacked, base, amax_meta, valid, bins: int,
               block: int) -> torch.Tensor:
    _check_inputs(stacked, base)
    nb = _tiles(stacked, block)
    k = stacked.shape[0]
    if amax_meta.shape != (nb, k) or amax_meta.dtype != torch.float32:
        raise ValueError("amax_meta must be [nb, k] fp32")
    if valid.shape != (nb,) or valid.dtype != torch.int32:
        raise ValueError("valid must be [nb] int32")
    if build.on_host(stacked, base, amax_meta, valid):
        return block_hist_plain(stacked, base, amax_meta, valid, bins,
                                block)
    hist_plan(k, bins)
    out = torch.empty((nb, k * bins), dtype=torch.int32,
                      device=stacked.device)
    _check_vectors(block, stacked, base, out)
    _launch(f"block_hist_{_suffix(stacked)}", stacked.data_ptr(),
            base.data_ptr(), amax_meta.data_ptr(), valid.data_ptr(),
            out.data_ptr(), k, stacked.shape[1], block, bins,
            _stream(stacked))
    block_hist.launches += 1
    return out


block_hist.launches = 0


# ---------------------------------------------------------------- B5 ties


def ties_block_plain(stacked, base, thr_meta, block: int) -> torch.Tensor:
    """[Np] fp32: `ties_tile` with each tile's [k] thresholds."""
    nb = _tiles(stacked, block)
    out = torch.empty_like(base)
    step = max(1, _PLAIN_CHUNK // block)
    for t0 in range(0, nb, step):
        t1 = min(nb, t0 + step)
        sl = slice(t0 * block, t1 * block)
        thr = thr_meta[t0:t1].T.repeat_interleave(block, dim=1)
        out[sl] = ties_tile(stacked[:, sl], base[sl], thr)
    return out


def ties_block(stacked, base, thr_meta, block: int) -> torch.Tensor:
    _check_inputs(stacked, base)
    nb = _tiles(stacked, block)
    k = stacked.shape[0]
    if thr_meta.shape != (nb, k) or thr_meta.dtype != torch.float32:
        raise ValueError("thr_meta must be [nb, k] fp32")
    if build.on_host(stacked, base, thr_meta):
        return ties_block_plain(stacked, base, thr_meta, block)
    out = torch.empty_like(base)
    _check_vectors(block, stacked, base, out)
    _launch(f"ties_block_{_suffix(stacked)}", stacked.data_ptr(),
            base.data_ptr(), thr_meta.data_ptr(), out.data_ptr(), k,
            stacked.shape[1], block, _stream(stacked))
    ties_block.launches += 1
    return out


ties_block.launches = 0


# ---------------------------------------------------------------- glue


def batch_layout(lengths: Sequence[int], block: int
                 ) -> Tuple[List[int], List[int], int]:
    """Per-tile metadata of a block-aligned concatenation of leaves:
    (leaf_id per tile, valid columns per tile, total padded length).
    A leaf of length 0 still takes one tile."""
    leaf_id, valid = [], []
    for li, n in enumerate(lengths):
        nb = padded_len(n, block) // block
        for b in range(nb):
            leaf_id.append(li)
            valid.append(min(block, n - b * block))
    return leaf_id, valid, len(leaf_id) * block


def hist_thresholds(counts, lengths, amax, trim: float,
                    bins: int) -> torch.Tensor:
    """Per-(leaf, contribution) trim thresholds [L, k] from exact
    integer counts [L, k, bins], true leaf lengths [L] and amax [L, k]
    (already + 1e-12): first bucket whose cdf reaches `trim`, scaled.
    The cdf divides as a true fp32 division (a reciprocal would move
    bucket edges)."""
    f32 = dict(dtype=torch.float32, device=counts.device)
    cdf = counts.cumsum(dim=2).to(torch.float32) / torch.tensor(
        [float(n) for n in lengths], **f32).reshape(-1, 1, 1)
    bucket = (cdf >= torch.tensor(trim, **f32)).to(torch.uint8).argmax(dim=2)
    return (bucket.to(torch.float32) / torch.tensor(float(bins), **f32)) \
        * amax


def ties_hist_batch(stacked, base, lengths: Sequence[int], *, trim: float,
                    bins: int, block: int) -> torch.Tensor:
    """Histogram-trim TIES over a flat batch in three launches; [Np]
    fp32 out."""
    leaf_id, valid, total = batch_layout(lengths, block)
    if total != stacked.shape[1]:
        raise ValueError("stacked does not match the leaves' layout")
    dev = stacked.device
    starts = [0]
    for n in lengths:
        starts.append(starts[-1] + padded_len(n, block) // block)
    bmax = block_amax(stacked, base, block)                         # [nb, k]
    amax = torch.stack([bmax[starts[j]:starts[j + 1]].amax(dim=0)
                        for j in range(len(lengths))])
    amax = amax + torch.tensor(1e-12, dtype=torch.float32, device=dev)
    lid = torch.tensor(leaf_id, dtype=torch.int64, device=dev)
    counts_b = block_hist(stacked, base, amax[lid].contiguous(),
                          torch.tensor(valid, dtype=torch.int32, device=dev),
                          bins, block)                        # [nb, k*bins]
    counts = torch.stack([
        counts_b[starts[j]:starts[j + 1]].to(torch.int64).sum(dim=0)
        for j in range(len(lengths))]).reshape(len(lengths), -1, bins)
    thr = hist_thresholds(counts, lengths, amax, trim, bins)        # [L, k]
    return ties_block(stacked, base, thr[lid].contiguous(), block)
