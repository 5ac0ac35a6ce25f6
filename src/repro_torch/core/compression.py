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
kernel reads the int8 rows in place.

Top-k sparsification of task-vector deltas (`topk_sparsify`,
`topk_reconstruct`): per leaf, the m = max(1, int(n * k_frac)) entries
of tau = leaf - base (fp32) with the largest |tau|, ties broken by the
lower index (a stable sort of -|tau| on the leaf's device, the
reference's `lexsort` order), as (indices int32 [m] ascending, values
fp32 [m], n), bit for bit the reference's. The indices are int32 as in
the reference, so a leaf of more than 2^31 - 1 elements (Qwen3-MoE's
stacked experts hold 9.66e9) raises `ValueError` where the reference's
`astype(np.int32)` would wrap (ROADMAP C).
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


# ---------------------------------------------------------------------------
# Top-k sparsification of task-vector deltas
# ---------------------------------------------------------------------------

_INT32_MAX = 2 ** 31 - 1


def _topk_leaf(x: torch.Tensor, b: torch.Tensor, k_frac: float):
    tau = (x.to(torch.float32) - b.to(torch.float32)).reshape(-1)
    n = tau.numel()
    if n > _INT32_MAX:
        raise ValueError(
            f"a leaf of {n} elements: top-k indices are int32, which "
            f"address at most {_INT32_MAX} elements")
    m = max(1, int(n * k_frac))
    order = torch.sort(-tau.abs(), stable=True).indices[:m]
    idx = torch.sort(order).values
    return idx.to(torch.int32), tau[idx], n


def topk_sparsify(tree: Any, base: Any, k_frac: float = 0.05) -> Any:
    """Per leaf: keep the top k_frac fraction of |leaf - base| entries.

    Returns a pytree of (indices int32 [m], values fp32 [m], size)
    tuples, the tensors on the leaf's device. Deterministic: ties are
    broken by index (a stable sort of -|tau|). Raises `ValueError` for a
    leaf of more than 2^31 - 1 elements."""
    return pytree.tree_map(lambda x, b: _topk_leaf(x, b, k_frac), tree,
                           base)


def topk_reconstruct(sparse_tree: Any, base: Any) -> Any:
    """base + the scattered values, per leaf, in fp32 and the base's
    shape."""
    def leaf(b: torch.Tensor, sp) -> torch.Tensor:
        idx, vals, size = sp
        tau = torch.zeros((size,), dtype=torch.float32, device=b.device)
        tau[idx.long()] = vals.to(torch.float32)
        return (b.to(torch.float32).reshape(-1) + tau).reshape(b.shape)
    return pytree.tree_map(leaf, base, sparse_tree)
