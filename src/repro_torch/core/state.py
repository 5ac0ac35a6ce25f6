"""CRDTMergeState — Layer 1 of the two-layer architecture (paper §4.2),
ported from `repro.core.state` unchanged: it is pure Python over
content hashes, and `pytree_digest` is the port's byte-exact copy.

State S = (A, R, V, H):
  A — add entries (element_id, tag, node, leaf_paths); element_id =
      SHA-256 content hash of the contribution (dedup + canonical
      ordering, paper Def. 5). `leaf_paths` is the *leaf coverage
      descriptor* of a sparse contribution: the sorted `keystr` paths of
      the leaves the partial pytree actually carries (None = dense,
      covers every leaf). Coverage is intrinsic to the element id — the
      content hash already folds the paths in — and is additionally
      folded into the tag hash so sparse re-adds after GC cannot collide
      with a dense add of the same (element, node, clock);
  R — removed tags (tombstones; OR-Set add-wins semantics);
  V — version vector (optimisation metadata, not needed for correctness);
  H — Merkle root over the visible element ids (recomputed lazily).

merge(S1, S2) = (A1 ∪ A2, R1 ∪ R2, max(V1, V2), H') — commutative,
associative, idempotent (Theorem 8; the reference's tests prove it, and
tests/test_torch_layer1.py checks the laws on the port).

`visible_per_leaf()` projects the OR-Set onto leaves: for each model
leaf, the set of visible elements whose coverage includes it. The
projection is itself a join-semilattice value (`PerLeafVisible.__or__`)
and inherits commutativity/associativity/idempotency from merge — a
leaf untouched by a sparse add keeps an identical per-leaf visible set,
which is what lets Layer-2 re-resolve O(changed leaves).

Contribution payloads (parameter pytrees) live in a content-addressed
store keyed by element_id, carried alongside the metadata. The store
union is also a semilattice (keys are content hashes, so equal keys bind
equal values — Assumption 11).
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, FrozenSet, Iterable, Mapping, Optional, Tuple

from repro_torch.core.hashing import leaf_paths_of, pytree_digest
from repro_torch.core.merkle import merkle_root
from repro_torch.core.version_vector import VersionVector


@dataclass(frozen=True, order=True)
class AddEntry:
    element_id: str      # hex SHA-256 of contribution content
    tag: str             # unique tag (hash of element, node, node clock)
    node: str
    # Leaf coverage descriptor: sorted keystr paths of the leaves this
    # (partial) contribution carries; None = dense. Last-with-default so
    # legacy 3-field construction keeps working; ordering never reaches
    # it for distinct entries because the tag already encodes coverage.
    leaf_paths: Optional[Tuple[str, ...]] = None


@dataclass(frozen=True)
class PerLeafVisible:
    """Per-leaf projection of the OR-Set: which visible elements cover
    which leaves. `dense` elements cover every leaf; `sparse` maps a
    leaf path to the extra elements covering only it. The value is a
    join-semilattice (`|` is pointwise union), so the projection of a
    merged state is order-insensitive exactly like `visible()`."""
    dense: Tuple[str, ...]
    sparse: Tuple[Tuple[str, Tuple[str, ...]], ...]

    @staticmethod
    def build(dense: Iterable[str],
              sparse: Mapping[str, Iterable[str]]) -> "PerLeafVisible":
        return PerLeafVisible(
            tuple(sorted(set(dense))),
            tuple(sorted((p, tuple(sorted(set(eids))))
                         for p, eids in sparse.items() if eids)))

    def leaves(self) -> Tuple[str, ...]:
        """Leaf paths with sparse-only coverage (dense elements cover
        every leaf of the model, whatever its structure)."""
        return tuple(p for p, _ in self.sparse)

    def at(self, leaf_path: str) -> Tuple[str, ...]:
        """Visible element ids covering `leaf_path`, in canonical
        (sorted-eid) order."""
        extra = dict(self.sparse).get(leaf_path, ())
        return tuple(sorted(set(self.dense) | set(extra)))

    def __or__(self, other: "PerLeafVisible") -> "PerLeafVisible":
        merged: Dict[str, set] = {p: set(e) for p, e in self.sparse}
        for p, eids in other.sparse:
            merged.setdefault(p, set()).update(eids)
        return PerLeafVisible.build(
            set(self.dense) | set(other.dense), merged)


class CRDTMergeState:
    """Immutable-style OR-Set state over model contributions."""

    __slots__ = ("adds", "removes", "vv", "store", "_root")

    def __init__(self,
                 adds: FrozenSet[AddEntry] = frozenset(),
                 removes: FrozenSet[str] = frozenset(),
                 vv: Optional[VersionVector] = None,
                 store: Optional[Dict[str, Any]] = None):
        self.adds = frozenset(adds)
        self.removes = frozenset(removes)
        self.vv = vv or VersionVector()
        self.store = dict(store or {})
        self._root: Optional[bytes] = None

    # ------------------------------------------------------------- update

    def add(self, contribution: Any, node: str,
            element_id: Optional[str] = None,
            leaf_paths: Optional[Iterable[str]] = None) -> "CRDTMergeState":
        """Contribute a model (paper: participant publishes a fine-tune).

        `leaf_paths` declares a *sparse* contribution: the pytree is
        partial, carrying exactly the listed leaves (canonical `keystr`
        paths). The descriptor must match the pytree's own leaf paths —
        the element id is the content hash, so coverage is part of the
        element's identity. Dense adds (leaf_paths=None) are unchanged
        byte-for-byte: same element id, same tag.
        """
        eid = element_id or pytree_digest(contribution).hex()
        clock = self.vv.get(node) + 1
        if leaf_paths is None:
            cover: Optional[Tuple[str, ...]] = None
            tag_src = f"{eid}|{node}|{clock}"
        else:
            cover = tuple(sorted(set(leaf_paths)))
            if not cover:
                raise ValueError("sparse add with empty leaf_paths")
            actual = leaf_paths_of(contribution)
            if actual != cover:
                raise ValueError(
                    "leaf_paths does not match the contribution's leaves: "
                    f"declared {cover}, pytree has {actual}")
            # coverage folded into the tag: a sparse re-add of identical
            # content after tombstone GC + VV reset can never collide
            # with a dense add of the same (element, node, clock)
            tag_src = f"{eid}|{node}|{clock}|{','.join(cover)}"
        tag = hashlib.sha256(tag_src.encode()).hexdigest()[:32]
        store = dict(self.store)
        store[eid] = contribution
        return CRDTMergeState(
            self.adds | {AddEntry(eid, tag, node, cover)},
            self.removes, self.vv.increment(node), store)

    def remove(self, element_id: str, node: str) -> "CRDTMergeState":
        """Retract: tombstone all *observed* tags of the element (OR-Set:
        concurrent adds elsewhere survive — add-wins)."""
        observed = {e.tag for e in self.adds if e.element_id == element_id}
        return CRDTMergeState(self.adds, self.removes | observed,
                              self.vv.increment(node), self.store)

    # -------------------------------------------------------------- query

    def visible(self) -> FrozenSet[str]:
        return frozenset(e.element_id for e in self.adds
                         if e.tag not in self.removes)

    def visible_contributions(self) -> Dict[str, Any]:
        return {eid: self.store[eid] for eid in self.visible()
                if eid in self.store}

    def visible_per_leaf(self) -> PerLeafVisible:
        """Per-leaf projection of the visible set (see PerLeafVisible).
        Dense elements land in `dense`; each sparse element lands under
        every leaf path its coverage descriptor names."""
        dense: set = set()
        sparse: Dict[str, set] = {}
        for e in self.adds:
            if e.tag in self.removes:
                continue
            if e.leaf_paths is None:
                dense.add(e.element_id)
            else:
                for p in e.leaf_paths:
                    sparse.setdefault(p, set()).add(e.element_id)
        return PerLeafVisible.build(dense, sparse)

    def coverage(self) -> Dict[str, Optional[Tuple[str, ...]]]:
        """Visible element id → leaf coverage descriptor (None = dense).
        If one element was added both densely and sparsely, dense wins —
        it covers every leaf the sparse entry covers; independent sparse
        adds of the same element union their coverage."""
        cov: Dict[str, Optional[Tuple[str, ...]]] = {}
        for e in sorted(self.adds):
            if e.tag in self.removes:
                continue
            prev = cov.get(e.element_id, ())
            if e.leaf_paths is None or prev is None:
                cov[e.element_id] = None
            else:
                cov[e.element_id] = tuple(sorted(
                    set(prev) | set(e.leaf_paths)))
        return cov

    def merkle_root(self) -> bytes:
        if self._root is None:
            leaves = [bytes.fromhex(e) for e in sorted(self.visible())]
            self._root = merkle_root(leaves)
        return self._root

    # -------------------------------------------------------------- merge

    def merge(self, other: "CRDTMergeState") -> "CRDTMergeState":
        store = dict(self.store)
        store.update(other.store)
        return CRDTMergeState(self.adds | other.adds,
                              self.removes | other.removes,
                              self.vv.merge(other.vv), store)

    __or__ = merge

    # ------------------------------------------------------ partial order

    def leq(self, other: "CRDTMergeState") -> bool:
        """S1 ⊑ S2 on metadata (paper Eq. 9)."""
        return (self.adds <= other.adds and self.removes <= other.removes
                and self.vv <= other.vv)

    def __eq__(self, other) -> bool:
        if not isinstance(other, CRDTMergeState):
            return NotImplemented
        return (self.adds == other.adds and self.removes == other.removes
                and self.vv == other.vv)

    def __hash__(self):
        return hash((self.adds, self.removes))

    # ----------------------------------------------------- garbage collect

    def gc_tombstones(self, stable_tags: Iterable[str]) -> "CRDTMergeState":
        """Causal-stability GC (paper §7.2 L3): drop tombstoned add entries
        and their tombstones once observed by all replicas. Must only be
        invoked after resolve() output dissemination."""
        stable = set(stable_tags) & self.removes
        adds = frozenset(e for e in self.adds if e.tag not in stable)
        removes = self.removes - stable
        live = {e.element_id for e in adds}
        store = {k: v for k, v in self.store.items() if k in live}
        return CRDTMergeState(adds, removes, self.vv, store)

    def __repr__(self) -> str:
        return (f"CRDTMergeState(|A|={len(self.adds)}, |R|={len(self.removes)}"
                f", visible={len(self.visible())}, vv={self.vv})")
