"""Delta-state CRDT propagation (`repro.core.delta`; paper §7.2 L1,
Almeida et al. [2]).

The OR-Set merge decomposes into independent set unions, so a delta is
simply (new add entries, new removed tags, payloads for new elements).
`apply_delta(S, delta_since(S', vv_seen)) == S.merge(S')` whenever
vv_seen captures what the receiver already has
(tests/test_torch_delta_dvv.py checks it against the reference).
Payloads may be int8-compressed (`core.compression`) for gossip
bandwidth.

Payloads travel by reference: a delta holds the sender's tensors and
`apply_delta` puts the same tensors into the receiver's store, so an
in-process fleet keeps one copy of each element on the device.
`approx_bytes` counts a tensor's bytes from its size and element
width, without reading it.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet

from repro_torch import pytree
from repro_torch.core.compression import (
    compress_tree, CompressedTree, decompress_tree)
from repro_torch.core.state import AddEntry, CRDTMergeState
from repro_torch.core.version_vector import VersionVector


@dataclass
class Delta:
    adds: FrozenSet[AddEntry]
    removes: FrozenSet[str]
    vv: VersionVector
    payloads: Dict[str, Any] = field(default_factory=dict)
    compressed: bool = False

    def approx_bytes(self) -> int:
        # 96B per entry approximates the fixed wire envelope (eid + tag
        # + node length prefixes); a sparse entry additionally ships its
        # coverage descriptor — the joined path strings plus the
        # separator bytes.
        meta = 96 * (len(self.adds) + len(self.removes))
        for e in self.adds:
            if e.leaf_paths is not None:
                meta += sum(len(p) for p in e.leaf_paths) \
                    + len(e.leaf_paths)
        data = 0
        for v in self.payloads.values():
            if isinstance(v, CompressedTree):
                data += v.nbytes()
            else:
                data += sum(x.numel() * x.element_size()
                            for x in pytree.leaves(v))
        return meta + data


def delta_since(state: CRDTMergeState, seen: VersionVector,
                compress: bool = False) -> Delta:
    """Entries the peer (whose knowledge is `seen`) may be missing.

    Conservative per-node clock filter: an add/remove originating at node
    n with clock > seen[n] is included. Tags embed no clock, so removes
    are filtered by the remove-set difference heuristic: all removes are
    sent when the peer's vv is stale anywhere (removes are tiny).
    """
    new_adds = frozenset(
        e for e in state.adds
        if state.vv.get(e.node) > seen.get(e.node))
    stale = any(state.vv.get(k) > seen.get(k)
                for k in state.vv.to_dict())
    new_removes = state.removes if stale else frozenset()
    need = {e.element_id for e in new_adds}
    payloads: Dict[str, Any] = {}
    for eid in need:
        if eid in state.store:
            p = state.store[eid]
            payloads[eid] = compress_tree(p) if compress else p
    return Delta(new_adds, new_removes, state.vv, payloads,
                 compressed=compress)


def delta_for_entries(state: CRDTMergeState,
                      adds: FrozenSet[AddEntry],
                      removes: FrozenSet[str],
                      include_payloads: bool = False,
                      compress: bool = False) -> Delta:
    """Delta carrying an *explicit* entry subset of `state` (what
    anti-entropy ships once Merkle bucket digests have localised the
    symmetric difference). Payloads are optional: the sync protocol
    moves blobs in a phase of its own."""
    payloads: Dict[str, Any] = {}
    if include_payloads:
        for eid in {e.element_id for e in adds}:
            if eid in state.store:
                p = state.store[eid]
                payloads[eid] = compress_tree(p) if compress else p
    return Delta(frozenset(adds), frozenset(removes), state.vv, payloads,
                 compressed=compress)


def apply_delta(state: CRDTMergeState, delta: Delta) -> CRDTMergeState:
    """Join a delta into a state. Payloads the store lacks are taken as
    they are (decompressed when they arrive int8), never cloned."""
    store = dict(state.store)
    for eid, payload in delta.payloads.items():
        if eid not in store:
            store[eid] = (decompress_tree(payload)
                          if isinstance(payload, CompressedTree)
                          else payload)
    return CRDTMergeState(state.adds | delta.adds,
                          state.removes | delta.removes,
                          state.vv.merge(delta.vv), store)
