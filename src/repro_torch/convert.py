"""Carry parameter pytrees between numpy and the port's tensors.

The reference package's parameters come out as numpy arrays (bf16 as
ml_dtypes `bfloat16`); `from_numpy_tree` turns them into torch tensors
with the same bytes, so both packages hash and merge the same values.
The caller names the device: there is no default, since a merge on the
card needs its inputs on the card. bf16 crosses through a uint16 view
(numpy has no native bf16). `to_numpy_tree` goes back.
`from_numpy_compressed` carries an int8 `CompressedTree` across.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch import pytree


def _to_tensor(a: Any, device) -> torch.Tensor:
    # a C-ordered copy keeps 0-dim arrays 0-dim (np.ascontiguousarray
    # would make them 1-dim, and change their digest)
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def from_numpy_tree(tree: Any, device: Any) -> Any:
    return pytree.tree_map(lambda a: _to_tensor(a, device), tree)


def to_numpy_tree(tree: Any) -> Any:
    return pytree.tree_map(_to_numpy, tree)


def from_numpy_compressed(ct: Any, device: Any):
    """The port's `CompressedTree` with the same bytes as a reference
    one (numpy int8 `q`, `np.float32` scale, dtype name, treedef). The
    reference's treedef rebuilds its container structure through its
    own `unflatten` method, so nothing of JAX is imported here."""
    from repro_torch.core.compression import CompressedLeaf, CompressedTree
    from repro_torch.dtypes import BY_NAME

    def leaf(cl):
        q = torch.from_numpy(np.array(cl.q, dtype=np.int8, order="C"))
        return CompressedLeaf(
            q.to(device),
            torch.tensor(float(cl.scale), dtype=torch.float32,
                         device=device),
            tuple(cl.shape), BY_NAME[str(cl.dtype)])

    structure = ct.treedef.unflatten(list(ct.leaves))
    flat, treedef = pytree.flatten(structure)
    return CompressedTree([leaf(cl) for cl in flat], treedef)
