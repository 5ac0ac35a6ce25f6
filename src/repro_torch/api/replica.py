"""Replica — one object owning a replica's merge lifecycle
(`repro.api.replica`).

    rep = Replica("inst-a")                # tensors live on "cuda"
    eid = rep.contribute(fine_tune)
    rep.merge(other_rep)                   # CRDT join (evidence too)
    rep.report(bad_eid, "statistical_outlier")
    merged = rep.resolve(MergeSpec("ties", {"trim": 0.3},
                                   trust_threshold=0.5))

A replica owns its Layer-1 state with the payload store, a per-replica
`EngineCache`, its trust evidence (`core.trust.TrustState`, a grow-only
CRDT joined by `merge`) and its registered bases. Contributions and bases are
moved to the replica's device, an int8 payload's `q` and `scale` too.
The device is CUDA unless the caller asks for the CPU: without CUDA,
`Replica()` raises rather than run on the host.

`Replica(path=...)` makes the replica durable (`core.journal`): the
directory's blob log + Layer-1 WAL replay on open — a restart recovers
the exact pre-crash Merkle root and every locally held blob, decoded
onto the replica's device — and every later state change is recorded
before it is acknowledged. `close()` flushes and releases the storage
(idempotent); `with Replica(path=...) as rep:` scopes it. A directory
written by the reference's `Replica(path=...)` opens here, and the
reverse.

`attach(sync_node)` hands state ownership to a `net.SyncNode`:
contributions, retractions and merges flow through the node (so its
partial-blob bookkeeping stays coherent), a durable replica's storage
goes with the state, and resolves pull non-resident payloads through
the node's fetch hook — the facade over a sharded, anti-entropy-synced
deployment. `detach()` takes state and storage back.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional

import torch

from repro_torch import pytree
from repro_torch.api.spec import MergeSpec
from repro_torch.core.compression import (
    CompressedLeaf, CompressedTree, to_device)
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
    """Facade over state + store + per-replica cache + trust + sync."""

    def __init__(self, node_id: str = "local", *, device: Any = None,
                 state: Optional[CRDTMergeState] = None,
                 trust: Optional[TrustState] = None,
                 cache: Optional[EngineCache] = None,
                 obs: Optional[MetricsRegistry] = None,
                 path: Optional[str] = None):
        self.node_id = node_id
        self.device = resolve_device(device)
        self._state = state if state is not None else CRDTMergeState()
        self.trust = trust
        # a fresh cache shares the replica's registry, so engine
        # counters surface through metrics(); an injected cache keeps
        # its own (metrics() merges both)
        self.obs = obs if obs is not None else MetricsRegistry()
        self.cache = cache if cache is not None else EngineCache(
            obs=self.obs)
        self._bases: Dict[str, Any] = {}
        self._node = None                  # attached net.SyncNode
        self._storage = None               # core.journal.DurableStore
        self._closed = False
        if path is not None:
            from repro_torch.core.journal import DurableStore
            self._storage = DurableStore(path, obs=self.obs,
                                         device=self.device)
            recovered = self._storage.load()
            merged = recovered.merge(self._state)
            if merged != recovered \
                    or merged.store.keys() != recovered.store.keys():
                self._storage.record_transition(recovered, merged)
            self._state = merged

    def _to_device(self, tree: Any) -> Any:
        return to_device(tree, self.device)

    # ----------------------------------------------------------- state

    @property
    def state(self) -> CRDTMergeState:
        return self._node.state if self._node is not None else self._state

    @state.setter
    def state(self, value: CRDTMergeState) -> None:
        if self._node is not None:
            self._node.state = value
        else:
            self._set_state(value)

    def _set_state(self, value: CRDTMergeState) -> None:
        """Unattached write path: durable write-through when a storage
        directory is open (attached, the node's own setter records)."""
        if self._storage is not None and value is not self._state:
            self._storage.record_transition(self._state, value)
        self._state = value

    def contribute(self, contribution: Any,
                   element_id: Optional[str] = None, *,
                   leaves: Optional[Iterable[str]] = None) -> str:
        """Publish a model contribution; returns its element id (the
        content hash that names it everywhere). `leaves` declares a
        sparse contribution: the pytree carries exactly those leaves
        (canonical keystr paths); a resolve merges each leaf over the
        contributions covering it, and a leaf none covers inherits the
        base.

        An int8 payload (`CompressedTree`) needs `element_id`: its
        content id is the digest of its dequantized tensors, and the
        reference's `pytree_digest` of a `CompressedTree` is no content
        hash (it differs from call to call), so neither package can
        name one by itself."""
        if element_id is None and _holds_int8(contribution):
            raise TypeError(
                "an int8 payload (CompressedTree / CompressedLeaf) needs "
                "element_id=...: its content id is the digest of the "
                "dequantized tensors, e.g. pytree_digest("
                "decompress_tree(ct)).hex()")
        contribution = self._to_device(contribution)
        eid = element_id or pytree_digest(contribution).hex()
        if self._node is not None:
            self._node.contribute(contribution, element_id=eid,
                                  leaves=leaves)
        else:
            self._set_state(self._state.add(contribution, self.node_id,
                                            element_id=eid,
                                            leaf_paths=leaves))
        return eid

    def add(self, contribution: Any, *,
            leaves: Optional[Iterable[str]] = None,
            element_id: Optional[str] = None) -> str:
        """Alias of `contribute` with the sparse-first signature."""
        return self.contribute(contribution, element_id, leaves=leaves)

    def retract(self, element_id: str) -> None:
        """OR-Set remove: tombstone every observed tag of the element."""
        if self._node is not None:
            self._node.retract(element_id)
        else:
            self._set_state(self._state.remove(element_id, self.node_id))

    def merge(self, other: Any) -> "Replica":
        """CRDT join with another Replica (attached or not) or a raw
        CRDTMergeState. Trust evidence joins too (it is itself a
        grow-only CRDT)."""
        if isinstance(other, Replica):
            state, trust = other.state, other.trust
        elif isinstance(other, CRDTMergeState):
            state, trust = other, None
        else:
            raise TypeError(f"cannot merge {type(other).__name__}")
        if self._node is not None:
            self._node.join(state)
        else:
            self._set_state(self._state.merge(state))
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
        by this replica's trust evidence when the spec asks, fetching
        non-resident payloads through the attached node's hook
        (leaf-granular: warm re-resolves fetch nothing)."""
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
                            fetch=self._fetch_hook(), cache=self.cache,
                            use_cache=use_cache, verify_base=verify_base)

    def _fetch_hook(self):
        # the node's counted wrapper, so Replica-routed and node-routed
        # resolves account blob pulls identically
        return self._node._counted_fetch() if self._node is not None \
            else None

    # ------------------------------------------------------------ sync

    def attach(self, node: Any) -> "Replica":
        """Hand state ownership to a `net.SyncNode`: the node's state
        absorbs this replica's, and from here on contribute / retract /
        merge / resolve all operate through the node (blob bookkeeping,
        placement filtering, fetch-on-resolve). A durable replica's
        storage follows the state into the node."""
        if self._node is not None:
            raise RuntimeError("already attached; detach() first")
        if self._storage is not None and hasattr(node, "attach_storage"):
            # the node's write-through takes over recording. Every state
            # of this replica was recorded, so its state is what the
            # store replays: handed over instead of decoding every blob
            # a second time, and node.join below is a no-op on disk
            storage, self._storage = self._storage, None
            node.attach_storage(storage, recovered=self._state)
        node.join(self._state)
        self._node = node
        # the node owns the state now: no second reference to payloads
        # it may later shed
        self._state = CRDTMergeState()
        return self

    def detach(self) -> "Replica":
        """Take the state (and any durable storage handed over by
        attach) back from the attached node."""
        if self._node is None:
            raise RuntimeError("not attached")
        self._state = self._node.state
        if self._storage is None and getattr(self._node, "storage", None) \
                is not None:
            self._storage = self._node.release_storage()
        self._node = None
        return self

    @property
    def node(self):
        return self._node

    # ------------------------------------------------------- lifecycle

    def close(self) -> None:
        """Flush and release every owned resource — the durable storage
        (held directly or handed to an attached node) and the attached
        node's transfer bookkeeping. Idempotent; the replica stays
        readable (state / merkle_root) but must not be written again
        when durable. Reopen with `Replica(path=...)` to resume."""
        if self._closed:
            return
        if self._node is not None:
            if hasattr(self._node, "close"):
                self._node.close()
            self._state = self._node.state
            self._node = None
        if self._storage is not None:
            self._storage.close()
            self._storage = None
        self._closed = True

    @property
    def closed(self) -> bool:
        return self._closed

    def __enter__(self) -> "Replica":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ----------------------------------------------------------- cache

    def set_cache_limit(self, entries: Optional[int] = None, *,
                        bytes: Optional[int] = None) -> None:  # noqa: A002
        """Bound THIS replica's merge-output cache."""
        self.cache.set_limit(entries, bytes=bytes)

    def cache_info(self) -> CacheInfo:
        return self.cache.info()

    def clear_cache(self) -> None:
        self.cache.clear()

    # --------------------------------------------------- observability

    def metrics(self, *, deterministic_only: bool = False
                ) -> Dict[str, float]:
        """Snapshot of every metric series in this replica's scope: its
        own registry, its engine cache's and — when attached — the sync
        node's. With `deterministic_only`, just the aggregates that are
        a pure function of the converged contribution set (identical
        across replicas and delivery orders)."""
        scopes = [self.obs]
        if self.cache.obs is not self.obs:
            scopes.append(self.cache.obs)
        node_obs = getattr(self._node, "obs", None)
        if node_obs is not None and node_obs is not self.obs:
            scopes.append(node_obs)
        if deterministic_only:
            out: Dict[str, float] = {}
            for s in scopes:
                out.update(s.aggregate())
            return out
        return scopes[0].merged(*scopes[1:])

    def trace_to(self, path: str) -> int:
        """Export this replica's telemetry as JSONL: one meta header,
        the process tracer's finished spans (if tracing is on), then
        every metric series from metrics(). Returns lines written."""
        from repro_torch.obs import (
            current_tracer, NULL_TRACER, to_events, write_jsonl)
        tracer = current_tracer()
        events = to_events(
            tracer=None if tracer is NULL_TRACER else tracer,
            meta={"node": self.node_id})
        for name, value in sorted(self.metrics().items()):
            events.append({"kind": "metric", "name": name,
                           "value": value})
        return write_jsonl(path, events)

    def __repr__(self) -> str:
        where = f" via {self._node.node_id!r}" if self._node else ""
        return (f"Replica({self.node_id!r}{where}, device={self.device}, "
                f"visible={len(self.state.visible())}, "
                f"cache={self.cache.info().entries})")


def _holds_int8(tree: Any) -> bool:
    return any(isinstance(leaf, (CompressedTree, CompressedLeaf))
               for leaf in pytree.leaves(tree))
