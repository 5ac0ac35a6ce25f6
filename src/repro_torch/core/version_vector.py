"""Version vectors (Lamport-style causal metadata, paper Def. 5 'V').

Correctness of the OR-Set does NOT depend on these (merge is CvRDT);
they serve the optimisation role of identifying which updates a peer
already has (delta sync) — see paper §4.2.
"""
from __future__ import annotations

from typing import Dict, Mapping


class VersionVector:
    __slots__ = ("clocks",)

    def __init__(self, clocks: Mapping[str, int] | None = None):
        self.clocks: Dict[str, int] = dict(clocks or {})

    def increment(self, node: str) -> "VersionVector":
        c = dict(self.clocks)
        c[node] = c.get(node, 0) + 1
        return VersionVector(c)

    def get(self, node: str) -> int:
        return self.clocks.get(node, 0)

    def merge(self, other: "VersionVector") -> "VersionVector":
        keys = set(self.clocks) | set(other.clocks)
        return VersionVector({k: max(self.get(k), other.get(k))
                              for k in keys})

    # partial order ---------------------------------------------------------

    def __le__(self, other: "VersionVector") -> bool:
        return all(v <= other.get(k) for k, v in self.clocks.items())

    def __eq__(self, other) -> bool:
        if not isinstance(other, VersionVector):
            return NotImplemented
        keys = set(self.clocks) | set(other.clocks)
        return all(self.get(k) == other.get(k) for k in keys)

    def __hash__(self):
        return hash(tuple(sorted((k, v) for k, v in self.clocks.items()
                                 if v)))

    def concurrent_with(self, other: "VersionVector") -> bool:
        return not (self <= other) and not (other <= self)

    def dominates(self, other: "VersionVector") -> bool:
        return other <= self and not (self == other)

    def to_dict(self) -> Dict[str, int]:
        return dict(self.clocks)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}:{v}" for k, v in sorted(self.clocks.items()))
        return f"VV({inner})"
