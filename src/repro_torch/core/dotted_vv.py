"""Dotted version vectors (paper §7.2 L1; Preguiça/Baquero [24]).

Plain version vectors carry one counter per node FOREVER — O(n) metadata
that the paper flags as the scaling limit past ~1,000 nodes. A dotted
version vector separates the *contiguous* causal past (a compact VV) from
a sparse set of *dots* (node, counter) above it, so transient nodes that
contributed a handful of updates compact away once their dots become
contiguous with the causal context.

Used as a drop-in alternative causal-metadata implementation; the OR-Set
correctness never depended on the vector (paper §4.2), so swapping it is
purely a metadata-size optimization. A copy of `repro.core.dotted_vv`
(pure Python; the port imports nothing of `repro`):
tests/test_torch_delta_dvv.py holds both to the same semilattice laws,
contexts, dots and reprs.
"""
from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, Mapping, Set, Tuple

Dot = Tuple[str, int]


class DottedVersionVector:
    __slots__ = ("context", "dots")

    def __init__(self, context: Mapping[str, int] | None = None,
                 dots: Iterable[Dot] = ()):
        self.context: Dict[str, int] = dict(context or {})
        self.dots: FrozenSet[Dot] = frozenset(dots)
        self._compact()

    # ------------------------------------------------------------ internals

    def _compact(self) -> None:
        """Fold dots contiguous with the context into it."""
        changed = True
        dots: Set[Dot] = set(self.dots)
        while changed:
            changed = False
            for node, c in sorted(dots):
                if c == self.context.get(node, 0) + 1:
                    self.context[node] = c
                    dots.discard((node, c))
                    changed = True
        # drop dots already dominated by the context
        self.dots = frozenset((n, c) for n, c in dots
                              if c > self.context.get(n, 0))

    # -------------------------------------------------------------- update

    def next_dot(self, node: str) -> Dot:
        """The next event dot for `node` (max of context and dots + 1)."""
        top = self.context.get(node, 0)
        for n, c in self.dots:
            if n == node:
                top = max(top, c)
        return (node, top + 1)

    def add_dot(self, dot: Dot) -> "DottedVersionVector":
        return DottedVersionVector(self.context, self.dots | {dot})

    def increment(self, node: str) -> "DottedVersionVector":
        return self.add_dot(self.next_dot(node))

    # --------------------------------------------------------------- query

    def contains(self, dot: Dot) -> bool:
        node, c = dot
        return c <= self.context.get(node, 0) or dot in self.dots

    def get(self, node: str) -> int:
        top = self.context.get(node, 0)
        for n, c in self.dots:
            if n == node:
                top = max(top, c)
        return top

    def metadata_size(self) -> int:
        """Entries carried on the wire (the L1 scaling metric)."""
        return len(self.context) + len(self.dots)

    # --------------------------------------------------------------- merge

    def merge(self, other: "DottedVersionVector") -> "DottedVersionVector":
        ctx = {k: max(self.context.get(k, 0), other.context.get(k, 0))
               for k in set(self.context) | set(other.context)}
        return DottedVersionVector(ctx, self.dots | other.dots)

    # ------------------------------------------------------------ lattice

    def __le__(self, other: "DottedVersionVector") -> bool:
        return (all(v <= other.get(k) for k, v in self.context.items())
                and all(other.contains(d) for d in self.dots))

    def __eq__(self, other) -> bool:
        if not isinstance(other, DottedVersionVector):
            return NotImplemented
        return self.context == other.context and self.dots == other.dots

    def __hash__(self):
        return hash((tuple(sorted(self.context.items())), self.dots))

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}:{v}" for k, v in
                          sorted(self.context.items()))
        extra = "".join(f" +{n}.{c}" for n, c in sorted(self.dots))
        return f"DVV({inner}{extra})"
