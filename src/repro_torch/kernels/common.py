"""The flat batch's tiling rule (`repro.kernels.common`).

Merge kernels stream [k, N] stacked contributions in column tiles of
`block`; each leaf is zero-padded to a multiple of `block` (a leaf of
length 0 still takes one tile), so one tile never spans two leaves and
per-leaf scalars ride on per-tile metadata. The port builds its flat
batch in place (`ops._flat_batch`), so the reference's per-array
padding helpers have no counterpart here.
"""
from __future__ import annotations


def padded_len(n: int, block: int) -> int:
    """Columns leaf of length `n` takes in the flat batch."""
    return max(1, -(-n // block)) * block
