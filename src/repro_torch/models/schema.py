"""Declarative parameter schema (`repro.models.schema`).

A model's parameters are described once as a pytree of `PDef`s; from it
two initialisers materialize tensors on a device:

  * `init_from_key(schema, key)` is the reference's `init_from_schema`
    bit for bit: leaf key `fold_in(key, first 4 bytes of SHA-256(path),
    little-endian)`, then `normal * scale` in fp32 through the port's
    threefry (`repro_torch.random`), which draws on the host: fine at
    smoke and test sizes, slow at billions of parameters.
  * `init_from_schema(schema, seed=)` draws each leaf from its own
    `torch.Generator` on the device, seeded from the run seed and a hash
    of the leaf's path, so a leaf's values do not depend on which other
    leaves exist or in which order they are made. Its values differ
    from the reference's: the chip smoke's random full-size models. A
    leaf of more than 2^32 elements (Qwen3-MoE's stacked experts, 9.66e9)
    is drawn one slice of its leading axis at a time, each slice from
    its own generator, so its fp32 draw never takes more than a slice
    (a whole draw would take 38.6 GB beside the model).
"""
from __future__ import annotations

import hashlib
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch import random as prng
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


def _insert(out: dict, path, leaf) -> None:
    node = out
    for _, key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1][1]] = leaf


def init_from_key(schema, key: prng.Key, *, device: Any = "cuda") -> dict:
    """The reference's `init_from_schema(schema, key)`, bit for bit."""
    out: dict = {}
    for path, pdef in _flatten_schema(schema):
        dt = BY_NAME[pdef.dtype]
        if pdef.init == "zeros":
            leaf = torch.zeros(pdef.shape, dtype=dt, device=device)
        elif pdef.init == "ones":
            leaf = torch.ones(pdef.shape, dtype=dt, device=device)
        else:
            name = "/".join(str(k) for _, k in path)
            fold = int.from_bytes(hashlib.sha256(name.encode()).digest()[:4],
                                  "little")
            leaf = (prng.normal(prng.fold_in(key, fold), pdef.shape,
                                torch.float32, device=device)
                    * pdef.scale).to(dt)
        _insert(out, path, leaf)
    return out


# leaves above this many elements are drawn a leading-axis slice at a
# time (`init_from_schema`)
_WHOLE_DRAW_ELEMS = 1 << 32


def _draw(shape, seed: int, scale: float, dt, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float32,
                       device=device).mul_(scale).to(dt)


def init_from_schema(schema, *, seed: int, device: Any = "cuda",
                     dtype: Optional[torch.dtype] = None):
    """Materialize parameters from a schema (deterministic per path).
    `dtype` overrides every PDef's dtype (e.g. bf16 weights)."""
    out = {}
    for path, pdef in _flatten_schema(schema):
        dt = dtype if dtype is not None else BY_NAME[pdef.dtype]
        n = param_count(pdef)
        if pdef.init == "zeros":
            leaf = torch.zeros(pdef.shape, dtype=dt, device=device)
        elif pdef.init == "ones":
            leaf = torch.ones(pdef.shape, dtype=dt, device=device)
        elif n > _WHOLE_DRAW_ELEMS and len(pdef.shape) > 1:
            name = pytree.keystr(path)
            leaf = torch.empty(pdef.shape, dtype=dt, device=device)
            for i in range(pdef.shape[0]):
                leaf[i] = _draw(pdef.shape[1:],
                                _leaf_seed(seed, f"{name}[{i}]"),
                                pdef.scale, dt, device)
        else:
            leaf = _draw(pdef.shape, _leaf_seed(seed, pytree.keystr(path)),
                         pdef.scale, dt, device)
        _insert(out, path, leaf)
    return out


def meta_from_schema(schema, dtype: Optional[torch.dtype] = None) -> dict:
    """The parameters' shapes and dtypes as meta tensors (no
    allocation), as the reference's `shapes_from_schema`; `dtype`
    overrides every PDef's dtype."""
    out: dict = {}
    for path, pdef in _flatten_schema(schema):
        _insert(out, path, torch.empty(
            pdef.shape, dtype=dtype or BY_NAME[pdef.dtype], device="meta"))
    return out


def specs_from_schema(schema) -> dict:
    """Each leaf's logical sharding axes, as the reference's
    `specs_from_schema`."""
    out: dict = {}
    for path, pdef in _flatten_schema(schema):
        _insert(out, path, pdef.spec)
    return out


def param_count(schema) -> int:
    n = 0
    for _, pdef in _flatten_schema(schema):
        c = 1
        for d in pdef.shape:
            c *= d
        n += c
    return n
