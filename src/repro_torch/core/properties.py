"""Algebraic audit harness (`repro.core.properties`, paper §3, §6.1-6.3).

Phase 1 audits RAW strategy applications (no CRDT wrapper): stochastic
strategies receive a fresh seed per call, reflecting their default
behaviour (paper Appendix F). Phase 2 audits the same strategies through
`CRDTMergeState` and checks the four properties of Table 4
(commutativity, associativity, idempotency, 3-replica convergence) with
BITWISE equality. The test tensors come from numpy (seed 42) as in the
reference and are placed on the device the caller names.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import pytree
from repro_torch.api.spec import MergeSpec
from repro_torch.core.resolve import reference_apply, resolve_spec
from repro_torch.core.state import CRDTMergeState
from repro_torch.strategies import list_strategies

TOL = 1e-5


@dataclass
class PropertyResult:
    strategy: str
    commutative: bool
    associative: bool
    idempotent: bool

    @property
    def crdt(self) -> bool:
        return self.commutative and self.associative and self.idempotent


class _SeedCounter:
    """Fresh seed per raw call — models unseeded default stochasticity
    deterministically (so tests are reproducible)."""

    def __init__(self, start: int = 1000):
        self.c = start

    def __call__(self) -> int:
        self.c += 1
        return self.c


def _allclose(a, b, tol=TOL) -> bool:
    return all(bool(torch.allclose(x, y, atol=tol, rtol=tol))
               for x, y in zip(pytree.leaves(a), pytree.leaves(b)))


def _bitwise_equal(a, b) -> bool:
    return all(torch.equal(x, y)
               for x, y in zip(pytree.leaves(a), pytree.leaves(b)))


# ---------------------------------------------------------------------------
# Phase 1 — raw strategy properties
# ---------------------------------------------------------------------------


def audit_raw(strategy_name: str, tensors: List[Any], base: Any = None,
              tol: float = TOL, trials: int = 3) -> PropertyResult:
    """tensors: >= 3 * trials contributions (pytrees or bare tensors)."""
    seeds = _SeedCounter()

    def f2(x, y):
        return reference_apply(strategy_name, [x, y], base=base,
                               seed=seeds())

    comm = assoc = idem = True
    for i in range(trials):
        a, b, c = tensors[3 * i], tensors[3 * i + 1], tensors[3 * i + 2]
        comm &= _allclose(f2(a, b), f2(b, a), tol)
        assoc &= _allclose(f2(f2(a, b), c), f2(a, f2(b, c)), tol)
        idem &= _allclose(f2(a, a), a, tol)
    return PropertyResult(strategy_name, comm, assoc, idem)


def audit_all_raw(tensors: List[Any], base: Any = None,
                  tol: float = TOL) -> Dict[str, PropertyResult]:
    return {s: audit_raw(s, tensors, base, tol) for s in list_strategies()}


# ---------------------------------------------------------------------------
# Phase 2 — through CRDTMergeState (bitwise)
# ---------------------------------------------------------------------------


@dataclass
class WrappedResult:
    strategy: str
    commutative: bool
    associative: bool
    idempotent: bool
    convergent: bool

    @property
    def crdt(self) -> bool:
        return (self.commutative and self.associative and self.idempotent
                and self.convergent)


def _single_states(tensors, n=3) -> List[CRDTMergeState]:
    return [CRDTMergeState().add(t, node=f"n{i}")
            for i, t in enumerate(tensors[:n])]


def audit_wrapped(strategy_name: str, tensors: List[Any],
                  base: Any = None) -> WrappedResult:
    s1, s2, s3 = _single_states(tensors, 3)
    spec = MergeSpec(strategy_name)

    def r(st):
        return resolve_spec(st, spec, base=base, use_cache=False)

    comm = _bitwise_equal(r(s1.merge(s2)), r(s2.merge(s1)))
    assoc = _bitwise_equal(r(s1.merge(s2).merge(s3)),
                           r(s1.merge(s2.merge(s3))))
    idem = _bitwise_equal(r(s1.merge(s2).merge(s1.merge(s2))),
                          r(s1.merge(s2)))
    # 3-replica convergence over all six delivery permutations
    results = []
    for perm in itertools.permutations([s1, s2, s3]):
        acc = perm[0]
        for st in perm[1:]:
            acc = acc.merge(st)
        results.append(r(acc))
    conv = all(_bitwise_equal(results[0], x) for x in results[1:])
    return WrappedResult(strategy_name, comm, assoc, idem, conv)


def audit_all_wrapped(tensors: List[Any],
                      base: Any = None) -> Dict[str, WrappedResult]:
    return {s: audit_wrapped(s, tensors, base) for s in list_strategies()}


# ---------------------------------------------------------------------------
# Test tensors (paper: seed 42)
# ---------------------------------------------------------------------------


def controlled_tensors(n: int = 9, shape=(4, 4), seed: int = 42,
                       dtype=torch.float64, *, device) -> List[torch.Tensor]:
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(shape), dtype=dtype,
                         device=device) for _ in range(n)]


def production_slices(cfg, n: int = 9, slice_dim: int = 128,
                      seed: int = 42, dtype=torch.float32, *, device):
    """Tier-2 style: synthetic base + low-rank task-vector fine-tunes at a
    production tensor shape. `cfg` is not read (the reference's
    signature)."""
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((slice_dim, slice_dim)) * 0.02
    outs = []
    for _ in range(n):
        u = rng.standard_normal((slice_dim, 8)) * 0.05
        v = rng.standard_normal((8, slice_dim)) * 0.05
        sparse = (rng.random((slice_dim, slice_dim)) < 0.01) * \
            rng.standard_normal((slice_dim, slice_dim)) * 0.02
        outs.append(torch.tensor(base + u @ v + sparse, dtype=dtype,
                                 device=device))
    return torch.tensor(base, dtype=dtype, device=device), outs


# Expected Table 3 pattern (C, A, I) — asserted by tests.
TABLE3_EXPECTED: Dict[str, Tuple[bool, bool, bool]] = {
    "ada_merging": (True, False, True),
    "adarank": (True, False, False),
    "dam": (True, False, True),
    "dare": (False, False, False),
    "dare_ties": (False, False, False),
    "della": (False, False, False),
    "dual_projection": (True, False, True),
    "emr": (True, False, False),
    "evolutionary_merge": (False, False, False),
    "fisher_merge": (True, False, True),
    "genetic_merge": (True, False, True),
    "led_merge": (True, False, True),
    "linear": (True, False, True),
    "model_breadcrumbs": (True, False, False),
    "negative_merge": (True, False, False),
    "regression_mean": (True, False, True),
    "representation_surgery": (True, False, True),
    "safe_merge": (True, False, True),
    "slerp": (True, False, True),
    "split_unlearn_merge": (True, False, False),
    "star": (True, False, False),
    "svd_knot_tying": (False, False, True),
    "task_arithmetic": (True, True, False),
    "ties": (True, False, False),
    "weight_average": (True, False, True),
    "weight_scope_alignment": (True, False, True),
}
