"""Content hashing for model contributions (`repro.core.hashing`).

`tensor_digest` / `pytree_digest` are SHA-256 over canonical bytes:
numpy dtype name | shape as a Python tuple | row-major data, with the
leaves of a pytree combined in sorted `keystr` order. These are the
paper's canonical identifiers (Assumption 11), so the port reproduces
the reference's bytes exactly: a torch replica and a JAX replica name
the same contribution with the same element id.

A CUDA tensor is copied to the host leaf by leaf to be hashed.
"""
from __future__ import annotations

import hashlib
from typing import Tuple

import torch

from repro_torch import pytree
from repro_torch.dtypes import dtype_name, host_view


def tensor_digest(t: torch.Tensor) -> bytes:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor leaf, got "
                        f"{type(t).__name__}")
    h = hashlib.sha256()
    h.update(dtype_name(t.dtype).encode())
    h.update(b"|")
    h.update(str(tuple(t.shape)).encode())
    h.update(b"|")
    h.update(host_view(t))
    return h.digest()


def pytree_digest(tree) -> bytes:
    """SHA-256 of a parameter pytree: leaves hashed, combined in path
    order."""
    flat, _ = pytree.flatten_with_path(tree)
    h = hashlib.sha256()
    for key, leaf in sorted(((pytree.keystr(p), leaf) for p, leaf in flat),
                            key=lambda kv: kv[0]):
        h.update(key.encode())
        h.update(tensor_digest(leaf))
    return h.digest()


def leaf_paths_of(tree) -> Tuple[str, ...]:
    """Canonical sorted `keystr` paths of a pytree's leaves — the leaf
    coverage descriptor of a (possibly partial) contribution."""
    flat, _ = pytree.flatten_with_path(tree)
    return tuple(sorted(pytree.keystr(p) for p, _ in flat))
