"""Replica — one object owning a replica's merge lifecycle
(`repro.api.replica`, local part).

    rep = Replica("inst-a")                # tensors live on "cuda"
    eid = rep.contribute(fine_tune)
    rep.merge(other_rep)                   # CRDT join (evidence too)
    rep.report(bad_eid, "statistical_outlier")
    merged = rep.resolve(MergeSpec("ties", {"trim": 0.3},
                                   trust_threshold=0.5))

A replica owns its Layer-1 state with the payload store, a per-replica
`EngineCache`, its trust evidence (`core.trust.TrustState`, a grow-only
CRDT joined by `merge`) and its registered bases. Contributions and bases are
moved to the replica's device. The device is CUDA unless the caller
asks for the CPU: without CUDA, `Replica()` raises rather than run on
the host.

Durability (`path=`), `attach` to a sync node and fetch-on-resolve
wait for ROADMAP A6.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch import pytree
from repro_torch.api.spec import MergeSpec
from repro_torch.core.engine import CacheInfo, EngineCache
from repro_torch.core.hashing import pytree_digest
from repro_torch.core.state import CRDTMergeState
from repro_torch.core.trust import TrustState
from repro_torch.obs import MetricsRegistry

__all__ = ["Replica"]


def resolve_device(device: Any = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. A CUDA device without CUDA raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the host")
    return dev


class Replica:
    """Facade over state + store + per-replica cache + trust."""

    def __init__(self, node_id: str = "local", *, device: Any = None,
                 state: Optional[CRDTMergeState] = None,
                 trust: Optional[TrustState] = None,
                 cache: Optional[EngineCache] = None,
                 obs: Optional[MetricsRegistry] = None):
        self.node_id = node_id
        self.device = resolve_device(device)
        self.state = state if state is not None else CRDTMergeState()
        self.trust = trust
        self.obs = obs if obs is not None else MetricsRegistry()
        self.cache = cache if cache is not None else EngineCache(
            obs=self.obs)
        self._bases: Dict[str, Any] = {}

    def _to_device(self, tree: Any) -> Any:
        return pytree.tree_map(lambda t: t.to(self.device), tree)

    # ----------------------------------------------------------- state

    def contribute(self, contribution: Any,
                   element_id: Optional[str] = None, *,
                   leaves: Optional[Iterable[str]] = None) -> str:
        """Publish a model contribution; returns its element id (the
        content hash that names it everywhere). `leaves` declares a
        sparse contribution: the pytree carries exactly those leaves
        (canonical keystr paths); a resolve merges each leaf over the
        contributions covering it, and a leaf none covers inherits the
        base."""
        contribution = self._to_device(contribution)
        eid = element_id or pytree_digest(contribution).hex()
        self.state = self.state.add(contribution, self.node_id,
                                    element_id=eid, leaf_paths=leaves)
        return eid

    def add(self, contribution: Any, *,
            leaves: Optional[Iterable[str]] = None,
            element_id: Optional[str] = None) -> str:
        """Alias of `contribute` with the sparse-first signature."""
        return self.contribute(contribution, element_id, leaves=leaves)

    def retract(self, element_id: str) -> None:
        """OR-Set remove: tombstone every observed tag of the element."""
        self.state = self.state.remove(element_id, self.node_id)

    def merge(self, other: Any) -> "Replica":
        """CRDT join with another Replica or a raw CRDTMergeState. Trust
        evidence joins too (it is itself a grow-only CRDT)."""
        if isinstance(other, Replica):
            state, trust = other.state, other.trust
        elif isinstance(other, CRDTMergeState):
            state, trust = other, None
        else:
            raise TypeError(f"cannot merge {type(other).__name__}")
        self.state = self.state.merge(state)
        if trust is not None:
            self.trust = trust if self.trust is None \
                else self.trust.merge(trust)
        return self

    def visible(self):
        return self.state.visible()

    def merkle_root(self) -> bytes:
        return self.state.merkle_root()

    # ----------------------------------------------------------- trust

    def report(self, element_id: str, kind: str,
               reporter: Optional[str] = None,
               severity: float = 1.0) -> "Replica":
        """File trust evidence against a contribution (grow-only CRDT;
        evidence merges with merge())."""
        base = self.trust if self.trust is not None else TrustState()
        self.trust = base.report(element_id, kind,
                                 reporter or self.node_id, severity)
        return self

    # ------------------------------------------------------------ base

    def register_base(self, payload: Any) -> str:
        """Pin a base model; returns its content ref for
        `MergeSpec(base_ref=...)`."""
        payload = self._to_device(payload)
        ref = pytree_digest(payload).hex()
        self._bases[ref] = payload
        return ref

    # --------------------------------------------------------- resolve

    def resolve(self, spec: MergeSpec, *, base: Any = None,
                use_cache: bool = True) -> Any:
        """Layer-2 resolve of `spec` over this replica's visible set,
        through the engine's exact path with this replica's cache, gated
        by this replica's trust evidence when the spec asks."""
        if not isinstance(spec, MergeSpec):
            raise TypeError(
                "Replica.resolve() takes a MergeSpec — e.g. "
                f"MergeSpec({spec!r}) — not {type(spec).__name__}")
        from repro_torch.core.resolve import resolve_spec
        verify_base = True
        if base is None and spec.base_ref is not None:
            try:
                base = self._bases[spec.base_ref]
            except KeyError:
                raise KeyError(
                    f"base_ref {spec.base_ref[:16]}… not registered on "
                    "this replica; call register_base(payload) first"
                    ) from None
            # keyed by its digest at register_base time: no re-hash
            verify_base = False
        elif base is not None:
            base = self._to_device(base)
        return resolve_spec(self.state, spec, base=base, trust=self.trust,
                            cache=self.cache, use_cache=use_cache,
                            verify_base=verify_base)

    # ----------------------------------------------------------- cache

    def set_cache_limit(self, entries: Optional[int] = None, *,
                        bytes: Optional[int] = None) -> None:  # noqa: A002
        """Bound THIS replica's merge-output cache."""
        self.cache.set_limit(entries, bytes=bytes)

    def cache_info(self) -> CacheInfo:
        return self.cache.info()

    def clear_cache(self) -> None:
        self.cache.clear()

    def __repr__(self) -> str:
        return (f"Replica({self.node_id!r}, device={self.device}, "
                f"visible={len(self.state.visible())}, "
                f"cache={self.cache.info().entries})")
