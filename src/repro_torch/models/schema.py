"""Declarative parameter schema (`repro.models.schema`).

A model's parameters are described once as a pytree of `PDef`s; from it
`init_from_schema` materializes tensors on a device. Each leaf draws
from its own `torch.Generator`, seeded from the run seed and a hash of
the leaf's path, so a leaf's values do not depend on which other
leaves exist or in which order they are made. (They differ from the
reference's `jax.random` draws: parity tests hand both packages the same
numpy arrays instead.)
"""
from __future__ import annotations

import hashlib
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.dtypes import BY_NAME


class PDef(NamedTuple):
    shape: Tuple[int, ...]
    spec: Tuple[Optional[str], ...]
    init: str = "normal"        # normal | zeros | ones
    scale: float = 0.02
    dtype: str = "float32"


def _leaf_seed(seed: int, path: str) -> int:
    digest = hashlib.sha256(f"{seed}|{path}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & 0x7FFFFFFFFFFFFFFF


def _flatten_schema(schema):
    """[(path, PDef)] in flatten order. PDefs are NamedTuples (tuples),
    so they are walked explicitly rather than by the generic pytree
    walk."""
    if isinstance(schema, PDef):
        return [((), schema)]
    if isinstance(schema, dict):
        return [((("key", k),) + p, leaf) for k in sorted(schema)
                for p, leaf in _flatten_schema(schema[k])]
    raise TypeError(f"schema nodes are dicts of PDefs, got "
                    f"{type(schema).__name__}")


def schema_leaves(schema):
    """[(keystr path, PDef)] in flatten order."""
    return [(pytree.keystr(p), d) for p, d in _flatten_schema(schema)]


def init_from_schema(schema, *, seed: int, device: Any = "cuda",
                     dtype: Optional[torch.dtype] = None):
    """Materialize parameters from a schema (deterministic per path).
    `dtype` overrides every PDef's dtype (e.g. bf16 weights)."""
    out = {}
    for path, pdef in _flatten_schema(schema):
        dt = dtype if dtype is not None else BY_NAME[pdef.dtype]
        if pdef.init == "zeros":
            leaf = torch.zeros(pdef.shape, dtype=dt, device=device)
        elif pdef.init == "ones":
            leaf = torch.ones(pdef.shape, dtype=dt, device=device)
        else:
            g = torch.Generator(device=device)
            g.manual_seed(_leaf_seed(seed, pytree.keystr(path)))
            leaf = torch.randn(pdef.shape, generator=g, dtype=torch.float32,
                               device=device).mul_(pdef.scale).to(dt)
        node = out
        for _, key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1][1]] = leaf
    return out


def param_count(schema) -> int:
    n = 0
    for _, pdef in _flatten_schema(schema):
        c = 1
        for d in pdef.shape:
            c *= d
        n += c
    return n
