"""Logical-axis -> mesh resolution (`repro.sharding.policy`, its pure
part).

Logical axes:
  fsdp -> ('pod','data')   ZeRO-style parameter/optimizer sharding
  tp   -> ('model',)       tensor parallel
  ep   -> ('model',)       expert parallel
  dp   -> ('pod','data')   batch (activations)
  sp   -> ('pod','data')   sequence (long-context KV; used when batch=1)

Resolution drops an axis (replicates the dim) when the dimension is not
divisible by the mesh extent, e.g. minicpm's 36 attention heads or odd
vocab sizes stay replicated.

The reference resolves against a `jax.sharding.Mesh` and reads only its
`shape`, the mapping from axis name to size; the port takes that
mapping itself and returns the spec as a plain tuple (an axis name, a
tuple of names, or None a dimension), the entries of the reference's
`PartitionSpec`. The port runs on one card, a mesh of size 1, where
every spec resolves to replication; lowering onto a device mesh, the
shardings themselves and `--mesh` beyond 1x1 are out of scope (ROADMAP,
"Out of scope").
"""
from __future__ import annotations

from typing import Iterator, Mapping, Optional, Tuple

AXIS_MAP = {
    "fsdp": ("pod", "data"),
    "dp": ("pod", "data"),
    "sp": ("pod", "data"),
    "sp_any": ("pod", "data", "model"),   # KV-cache seq: any free axis
    "tp": ("model",),
    "ep": ("model",),
}

Spec = Tuple[Optional[object], ...]


def _candidates(axes: Tuple[str, ...],
                mesh_shape: Mapping[str, int]) -> Iterator[Tuple[str, ...]]:
    """Prefer the widest sharding: full tuple, then suffixes."""
    present = tuple(a for a in axes if a in mesh_shape)
    for i in range(len(present)):
        yield present[i:]


def resolve_leaf_spec(logical: Tuple, shape: Tuple[int, ...],
                      mesh_shape: Mapping[str, int]) -> Spec:
    """The mesh spec of a leaf of `shape` whose dimensions carry the
    logical axes `logical`, over a mesh of `mesh_shape` ({axis name:
    size}): per dimension the widest candidate of its axes whose size is
    above 1, unused by an earlier dimension, and divides it; None when
    none does."""
    used: set = set()
    entries = []
    for dim, name in zip(shape, logical):
        if name is None:
            entries.append(None)
            continue
        chosen = None
        for trial in _candidates(AXIS_MAP[name], mesh_shape):
            size = 1
            for a in trial:
                size *= int(mesh_shape[a])
            if size <= 1 or any(a in used for a in trial):
                continue
            if dim % size == 0:
                chosen = trial
                break
        if chosen is None:
            entries.append(None)
        else:
            used.update(chosen)
            entries.append(chosen if len(chosen) > 1 else chosen[0])
    return tuple(entries)
