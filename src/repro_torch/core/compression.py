"""Deterministic int8 payload compression (`repro.core.compression`).

Symmetric per-tensor int8 quantization with an fp32 scale:

    scale = f32(max|a| / 127 + 1e-12)
    q     = int8(clip(round_half_even(a / scale), -127, 127))
    a'    = (f32(q) * scale) cast to the leaf's dtype

with a the leaf widened to fp32 and every step an fp32 op, so the port
produces the reference's bytes (`q`, `scale`) and every replica
reconstructs bit-identical tensors from them. Content identity is
defined on the dequantized tensors, so a compressed contribution keeps
one element id everywhere.

The port keeps `q` as an int8 tensor on the leaf's device and `scale`
as a 0-dim fp32 tensor beside it: the merge engine's `quant_nary`
kernel reads the int8 rows in place. Top-k sparsification
(`topk_sparsify`) is not ported (ROADMAP A5).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Tuple

import torch

from repro_torch import pytree


@dataclass
class CompressedLeaf:
    q: torch.Tensor          # int8 payload, the leaf's shape
    scale: torch.Tensor      # 0-dim fp32, on q's device
    shape: Tuple[int, ...]
    dtype: torch.dtype       # the leaf's dtype before compression


@dataclass
class CompressedTree:
    leaves: List[CompressedLeaf]
    treedef: Any

    def nbytes(self) -> int:
        return sum(leaf.q.numel() + 8 for leaf in self.leaves)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=device)


def compress_leaf(x: torch.Tensor) -> CompressedLeaf:
    """One leaf, on its own device; fp32 temporaries of one leaf."""
    a = x.to(torch.float32, copy=True)      # divided in place below
    scale = a.abs().amax() / _f32(127.0, a.device) + _f32(1e-12, a.device)
    a = a.div_(scale).round_().clamp_(-127, 127)
    return CompressedLeaf(a.to(torch.int8), scale, tuple(x.shape), x.dtype)


def dequantize_leaf(leaf: CompressedLeaf) -> torch.Tensor:
    """`decompress_tree`'s op on one leaf: f32(q) * scale, then the
    leaf's dtype."""
    return (leaf.q.to(torch.float32) * leaf.scale).reshape(
        leaf.shape).to(leaf.dtype)


def compress_tree(tree: Any) -> CompressedTree:
    flat, treedef = pytree.flatten(tree)
    return CompressedTree([compress_leaf(x) for x in flat], treedef)


def decompress_tree(ct: CompressedTree) -> Any:
    return ct.treedef.unflatten([dequantize_leaf(leaf)
                                 for leaf in ct.leaves])


def to_device(tree: Any, device: Any) -> Any:
    """`tree` with every tensor on `device`: plain leaves, and each
    `CompressedLeaf`'s `q` and `scale` (a `CompressedTree` is one leaf
    of the port's pytree). Tensors already there are not copied; other
    leaves pass through."""
    def move(x: Any) -> Any:
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, CompressedLeaf):
            return CompressedLeaf(x.q.to(device), x.scale.to(device),
                                  x.shape, x.dtype)
        if isinstance(x, CompressedTree):
            return CompressedTree([move(leaf) for leaf in x.leaves],
                                  x.treedef)
        return x
    return pytree.tree_map(move, tree)


def compressed_tree_to_structure(ct: CompressedTree) -> Any:
    """Container tree (dict/list/tuple nesting) with CompressedLeaf
    leaves."""
    return ct.treedef.unflatten(ct.leaves)


def compressed_tree_from_structure(structure: Any) -> CompressedTree:
    leaves, treedef = pytree.flatten(structure)
    if not all(isinstance(leaf, CompressedLeaf) for leaf in leaves):
        raise TypeError("structure leaves must all be CompressedLeaf")
    return CompressedTree(leaves, treedef)
