"""The flat batch's tiling rule and the counter-hash RNG
(`repro.kernels.common`).

Merge kernels stream [k, N] stacked contributions in column tiles of
`block`; each leaf is zero-padded to a multiple of `block` (a leaf of
length 0 still takes one tile), so one tile never spans two leaves and
per-leaf scalars ride on per-tile metadata. The port builds its flat
batch in place (`ops._flat_batch`), so the reference's per-array
padding helpers have no counterpart here.

`hash_uniform` is the DARE kernel route's RNG: a 3-round xorshift-
multiply hash of a uint32 element index and a uint32 seed, exact
integer arithmetic, so every replica (and the CUDA kernel,
`csrc/dare.cu`) draws the same mask.
"""
from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def padded_len(n: int, block: int) -> int:
    """Columns leaf of length `n` takes in the flat batch."""
    return max(1, -(-n // block)) * block


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for uint32 values held in int64, in two 16-bit
    halves of `c` so no product leaves int64's positive range."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash_uniform(idx: torch.Tensor, seed) -> torch.Tensor:
    """Uniform [0, 1) fp32 from uint32 element indices (int64 tensor of
    uint32 values) and a uint32 seed (an int, or an int64 tensor
    broadcasting against `idx`); bit-equal to the reference's
    `hash_uniform`. The fp32 value is (h >> 8) * 2^-24, exact."""
    h = _mul32(idx & M32, 2654435761)
    h = h ^ (seed & M32)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return (h >> 8).to(torch.float32) * torch.tensor(
        2.0 ** -24, dtype=torch.float32, device=h.device)
