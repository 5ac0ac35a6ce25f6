"""Strategy interface (`repro.strategies.base`, in PyTorch).

A strategy is an n-ary pure function over an ORDERED list of
contribution pytrees (paper Assumption 9): σ(contribs, base, seed,
**cfg) -> merged. Two execution protocols share one registration:

  * whole-tree (`__call__`): stack k full pytrees and run `fn` — the
    reference path `core.resolve.reference_apply` takes;
  * leafwise (`apply_leaf`): the planner/executor engine
    (`core/engine`) calls `leaf_fn` one tensor at a time.

`elementwise=True` marks leaf functions that reduce only over the
leading k axis, so the engine may fuse many leaves into one flattened
[k, N] dispatch without changing any output byte. `cfg_schema`
declares every knob ``{name: (type, default)}`` so `MergeSpec` can
validate. Incremental strategies declare a `LeafFold`: an explicit
left fold over the ordered contributions of ONE leaf, driven by
`run_fold` for both the full recompute and the engine's resumption
from a cached accumulator, so the two are bit-equal by construction.

Stochastic strategies (`needs_key`) get a threefry key per leaf,
`fold_in(PRNGKey(seed & 0x7FFFFFFF), leaf_index)` with the leaf's global
flatten index, from `repro_torch.random`, which draws `jax.random`'s
bits: both protocols derive the same key, so per-leaf execution equals
the whole-tree path bitwise, and both equal the reference's draws.
`binary_only` strategies (slerp) merge exactly two contributions; for
k > 2 the engine and `reference_apply` fold them pairwise with
`pairwise_fold`, in sequence or as a balanced tree
(`MergeSpec.reduction`), with per-step seeds. The
five whole-model strategies are ROADMAP A3.6.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch import random as prng


@dataclass(frozen=True)
class LeafFold:
    """Sequential left fold: acc = init(x_0); acc = step(acc, x_j) for
    j = 1..k-1; out = finalize(acc, k). The accumulator is float32 and
    strictly sequential in canonical order, so a cached accumulator
    extends with new contributions to a bit-identical result. `min_k`
    guards regime switches (`linear` interpolates at k == 2)."""
    init: Callable      # init(x0, base, **cfg) -> acc (float32)
    step: Callable      # step(acc, x, base, **cfg) -> acc
    finalize: Callable  # finalize(acc, k, base, dtype, **cfg) -> leaf
    min_k: int = 1


def run_fold(fold: LeafFold, stacked, base, *, acc=None, start: int = 0,
             finalize: bool = True, k: Optional[int] = None, **cfg):
    """Drive a LeafFold over stacked[start:]. `stacked` is a [k, ...]
    tensor or a list of leaves; a resumption passes only the NEW leaves
    plus the cached `acc` and the TOTAL count via `k=`.

    Returns (value_or_None, acc)."""
    i = start
    if acc is None:
        acc = fold.init(stacked[i].to(torch.float32), base, **cfg)
        i += 1
    while i < len(stacked):
        acc = fold.step(acc, stacked[i].to(torch.float32), base, **cfg)
        i += 1
    if not finalize:
        return None, acc
    total = (len(stacked) - start) if k is None else k
    return fold.finalize(acc, total, base, stacked[0].dtype, **cfg), acc


def pairwise_fold(items: List[Any], combine: Callable, seed: int,
                  reduction: str = "fold") -> Any:
    """A binary-only merge of k >= 1 ordered items, as the reference
    folds it: in sequence, acc = combine(acc, items[j], seed + j) for
    j = 1..k-1 (`reduction="fold"`), or as a balanced tree of depth
    ceil(log2 k) (`"tree"`, equal influence: paper Remark 7) with the
    pairs numbered seed + 1, seed + 2, ... level by level and an odd item
    out moved up a level unchanged. `combine(a, b, seed)` merges two."""
    if reduction != "tree":
        acc = items[0]
        for j in range(1, len(items)):
            acc = combine(acc, items[j], seed + j)
        return acc
    level = list(items)
    rnd = 0
    while len(level) > 1:
        nxt = []
        for j in range(0, len(level) - 1, 2):
            rnd += 1
            nxt.append(combine(level[j], level[j + 1], seed + rnd))
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    return level[0]


@dataclass(frozen=True)
class Strategy:
    name: str
    fn: Callable                 # fn(stacked_tree, base_tree, seed, **cfg)
    binary_only: bool = False
    defaults: Dict[str, Any] = field(default_factory=dict)
    leaf_fn: Optional[Callable] = None  # leaf_fn(stacked[k,...], base, [key])
    needs_key: bool = False           # leaf_fn consumes a PRNG key
    elementwise: bool = False         # reduces only over the k axis
    cfg_schema: Optional[Dict[str, Tuple[type, Any]]] = None
    fold: Optional[LeafFold] = None

    def __call__(self, contribs: List[Any], *, base: Any = None,
                 seed: int = 0, **cfg) -> Any:
        if len(contribs) < 1:
            raise ValueError(
                f"strategy {self.name!r} requires at least one "
                "contribution, got an empty list")
        stacked = pytree.tree_map(lambda *xs: torch.stack(list(xs)),
                                  *contribs)
        if base is None:
            base = pytree.tree_map(torch.zeros_like, contribs[0])
        kw = dict(self.defaults)
        kw.update(cfg)
        return self.fn(stacked, base, seed, **kw)

    def apply_leaf(self, stacked, base, *, leaf_index: int = 0,
                   seed: int = 0, **cfg) -> Any:
        """Merge ONE leaf: stacked [k, ...] slices + base leaf. A
        stochastic strategy's key is derived as `leafwise` derives it,
        from the seed and the global leaf index."""
        kw = dict(self.defaults)
        kw.update(cfg)
        if self.needs_key:
            return self.leaf_fn(stacked, base, leaf_key(seed, leaf_index),
                                **kw)
        return self.leaf_fn(stacked, base, **kw)

    @property
    def batchable(self) -> bool:
        """True when leaves may be fused into one flattened dispatch
        without changing output bytes."""
        return (self.elementwise and not self.needs_key
                and not self.binary_only and self.leaf_fn is not None)


REGISTRY: Dict[str, Strategy] = {}


def register(strategy: Strategy) -> Strategy:
    REGISTRY[strategy.name] = strategy
    return strategy


# the reference's whole-model strategies (population search, SVD), not
# ported yet
WHOLE_MODEL = ("adarank", "evolutionary_merge", "genetic_merge", "star",
               "svd_knot_tying")


def get_strategy(name: str) -> Strategy:
    if name in WHOLE_MODEL:
        raise KeyError(f"strategy {name!r} is a whole-model strategy, not "
                       "ported yet (ROADMAP A3.6)")
    if name not in REGISTRY:
        raise KeyError(f"unknown strategy {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


def list_strategies() -> List[str]:
    return sorted(REGISTRY)


def leaf_key(seed: int, leaf_index: int) -> prng.Key:
    """The key of leaf `leaf_index` of a merge seeded `seed`."""
    return prng.fold_in(prng.PRNGKey(seed & 0x7FFFFFFF), leaf_index)


def leafwise(leaf_fn: Callable, needs_key: bool = False) -> Callable:
    """Lift a per-leaf function (stacked [k,...], base, [key]) -> leaf."""
    def nary(stacked, base, seed, **cfg):
        leaves_s, treedef = pytree.flatten(stacked)
        leaves_b = treedef.flatten_up_to(base)
        outs = []
        for i, (sl, bl) in enumerate(zip(leaves_s, leaves_b)):
            if needs_key:
                outs.append(leaf_fn(sl, bl, leaf_key(seed, i), **cfg))
            else:
                outs.append(leaf_fn(sl, bl, **cfg))
        return treedef.unflatten(outs)
    return nary
