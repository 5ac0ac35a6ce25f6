"""Trust-as-CRDT Byzantine extension (`repro.core.trust`, paper §7.2 L4).

Trust evidence is a grow-only set (a monotonic CRDT): each entry names
an element_id, an evidence kind, a reporting node and a severity. Set
union is a semilattice, so honest nodes converge to the same evidence,
the same scores and the same gating decision at the Layer-2 boundary.
`gated_visible` deterministically excludes contributions whose
converged score falls below the threshold; `resolve_spec` then runs on
the gated set (a spec's `trust_threshold`).

`gated_resolve` is the reference's deprecated shim over that path: it
warns and calls `resolve_spec(state, MergeSpec.lenient(...,
trust_threshold=...), trust=...)`, as `Replica.resolve` does with a
spec's threshold.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Optional

from repro_torch.core.state import CRDTMergeState

DEFAULT_WEIGHTS = {
    "equivocation": 1.0,         # same node, conflicting roots
    "divergent_root": 0.6,       # Merkle-root mismatch on re-computation
    "fingerprint_anomaly": 0.5,  # content hash != announced hash
    "statistical_outlier": 0.25,  # parameter-distribution anomaly
}


@dataclass(frozen=True, order=True)
class Evidence:
    element_id: str
    kind: str
    reporter: str
    severity: float = 1.0


class TrustState:
    """Grow-only evidence set + derived scores."""

    __slots__ = ("evidence",)

    def __init__(self, evidence: FrozenSet[Evidence] = frozenset()):
        self.evidence = frozenset(evidence)

    def report(self, element_id: str, kind: str, reporter: str,
               severity: float = 1.0) -> "TrustState":
        return TrustState(self.evidence |
                          {Evidence(element_id, kind, reporter, severity)})

    def merge(self, other: "TrustState") -> "TrustState":
        return TrustState(self.evidence | other.evidence)

    def score(self, element_id: str,
              weights: Optional[Dict[str, float]] = None) -> float:
        """1.0 = fully trusted; decreases with the element's evidence,
        summed in the evidence's sorted order."""
        w = weights or DEFAULT_WEIGHTS
        penalty = 0.0
        for ev in sorted(self.evidence):
            if ev.element_id == element_id:
                penalty += w.get(ev.kind, 0.25) * ev.severity
        return max(0.0, 1.0 - penalty)

    def __eq__(self, other):
        return isinstance(other, TrustState) and \
            self.evidence == other.evidence

    def __hash__(self):
        return hash(self.evidence)


def gated_visible(state: CRDTMergeState, trust: TrustState,
                  threshold: float = 0.5) -> FrozenSet[str]:
    """Deterministic trust gate at the Layer-2 boundary."""
    return frozenset(e for e in state.visible()
                     if trust.score(e) >= threshold)


def gated_resolve(state: CRDTMergeState, trust: TrustState,
                  strategy: str, base=None, threshold: float = 0.5, **cfg):
    """DEPRECATED: resolve with the trust gate folded into the spec,
    `resolve_spec(state, MergeSpec(strategy, cfg, trust_threshold=...),
    trust=trust)` (or `Replica.resolve` on a replica holding the trust
    state). `reduction` and `fetch` are taken out of `cfg`; the rest is
    the lenient spec's unvalidated cfg. The same bytes as that path: the
    seed derives from the Merkle root of the gated id set."""
    from repro_torch.api.spec import MergeSpec
    from repro_torch.core.resolve import _warn_shim, resolve_spec
    _warn_shim("gated_resolve()", "resolve(state, MergeSpec(strategy, cfg, "
               "trust_threshold=...), trust=trust) or Replica.resolve(spec)")
    reduction = cfg.pop("reduction", "fold")
    fetch = cfg.pop("fetch", None)
    spec = MergeSpec.lenient(strategy, cfg, reduction=reduction,
                             trust_threshold=threshold)
    return resolve_spec(state, spec, base=base, trust=trust, fetch=fetch)
