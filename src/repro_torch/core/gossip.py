"""Multi-node convergence simulation (`repro.core.gossip`; paper Tier 3,
§6.5).

In-process network of CRDT nodes with explicit message delivery, so a
caller controls ordering, duplication, loss and partitions. Two
protocols:

  * all-pairs push (the paper's prototype: n(n-1) directed merges a
    round);
  * epidemic (randomised fanout) push gossip [18] — the paper's
    suggested production protocol beyond ~50 nodes (O(n·fanout) a
    round).

Delta-state propagation (paper §7.2 L1, `core.delta`) plugs in with
`use_deltas=True`: nodes send only the add/remove entries the peer has
not acknowledged. Delivery is by reference: a node's store holds the
sender's tensors, so a fleet in one process keeps one copy of each
payload on the device. The network's `random.Random(seed)` is drawn
exactly as the reference draws it, so both packages shuffle and sample
the same peers for the same seed.

Contributions live on the network's device: CUDA unless the caller
names another.

Transports (`net.transport`): passing `transport=` routes every send
through the versioned wire codec and a transport (in-memory queues,
per-frame loopback TCP, or persistent per-peer TCP connections), so
gossip is an actual byte protocol; `bytes_sent` then counts real frame
bytes, and `compress_payloads` ships delta payloads as int8. Received
frames decode onto the transport's device and land on the receiving
node's. With `placement=` (`net.store.Placement`) pushes carry the full
Layer-1 metadata but payloads only to their placement holders. The
default (no transport) keeps the in-process delivery by reference.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, \
    Tuple

from repro_torch import pytree
from repro_torch.api.replica import resolve_device
from repro_torch.api.spec import coerce_spec, MergeSpec
from repro_torch.core.compression import to_device
from repro_torch.core.delta import apply_delta, Delta, delta_since
from repro_torch.core.resolve import resolve, resolve_spec
from repro_torch.core.state import CRDTMergeState
from repro_torch.core.version_vector import VersionVector
from repro_torch.obs import MetricsRegistry


class GossipNode:
    def __init__(self, node_id: str, device: Any = None):
        self.node_id = node_id
        self.device = resolve_device(device)
        self.state = CRDTMergeState()
        self.known: Dict[str, dict] = {}   # peer -> last vv (delta sync)
        self.merge_calls = 0

    def _to_device(self, tree: Any) -> Any:
        return pytree.tree_map(lambda t: t.to(self.device), tree)

    def contribute(self, contribution: Any,
                   element_id: Optional[str] = None, *,
                   leaves: Optional[Iterable[str]] = None) -> None:
        """Add a contribution, moved to the node's device (a no-op when
        it is there already). `leaves` declares a sparse contribution,
        as `CRDTMergeState.add(leaf_paths=...)` does."""
        self.state = self.state.add(self._to_device(contribution),
                                    self.node_id, element_id=element_id,
                                    leaf_paths=leaves)

    def retract(self, element_id: str) -> None:
        self.state = self.state.remove(element_id, self.node_id)

    def receive_state(self, other: CRDTMergeState) -> None:
        self.state = self.state.merge(other)
        self.merge_calls += 1

    def receive_delta(self, delta: Delta) -> None:
        self.state = apply_delta(self.state, delta)
        self.merge_calls += 1

    def receive_wire(self, msg) -> None:
        """Apply a decoded wire message (StateMsg or DeltaMsg); its
        payloads land on the node's device."""
        from repro_torch.net.wire import (
            DeltaMsg, msg_to_delta, msg_to_state, StateMsg)
        if isinstance(msg, StateMsg):
            self.receive_state(msg_to_state(msg, device=self.device))
        elif isinstance(msg, DeltaMsg):
            d = msg_to_delta(msg)
            self.receive_delta(Delta(
                d.adds, d.removes, d.vv,
                {e: to_device(p, self.device) for e, p in d.payloads.items()},
                d.compressed))
        else:
            raise TypeError(f"GossipNode cannot apply {type(msg)}; "
                            "sync messages need net.SyncNode")

    def root(self) -> bytes:
        return self.state.merkle_root()

    def resolve(self, spec, base: Any = None, *, trust: Any = None, **cfg):
        """Resolve this node's state. Takes a MergeSpec (with `trust=`
        supplying the TrustState a `trust_threshold` spec gates on);
        the string form delegates to the deprecated `core.resolve.
        resolve` shim (and warns like it)."""
        if base is not None:
            base = self._to_device(base)
        if isinstance(spec, MergeSpec):
            use_cache = cfg.pop("use_cache", True)
            return resolve_spec(self.state, coerce_spec(spec, cfg),
                                base=base, trust=trust,
                                use_cache=use_cache)
        return resolve(self.state, spec, base=base, trust=trust, **cfg)


class GossipNetwork:
    def __init__(self, n: int, seed: int = 0, use_deltas: bool = False,
                 transport=None, compress_payloads: bool = False,
                 placement=None, obs: Optional[MetricsRegistry] = None,
                 device: Any = None):
        self.obs = obs if obs is not None else MetricsRegistry()
        self.device = resolve_device(device)
        self.nodes = [GossipNode(f"node{i:03d}", self.device)
                      for i in range(n)]
        self.rng = random.Random(seed)
        self.use_deltas = use_deltas
        self.compress_payloads = compress_payloads
        # sharded store (net.store.Placement): pushes still carry the
        # full Layer-1 metadata, but payloads ship only to their
        # placement holders. Each node additionally keeps the payloads
        # it contributed (merge unions stores; filtering is sender-side).
        self.placement = placement
        self.transport = transport
        if transport is not None:
            for node in self.nodes:
                transport.register(node.node_id)
        self.partitions: Optional[List[Set[int]]] = None
        self.bytes_sent = 0

    # ------------------------------------------------------------ topology

    def partition(self, groups: Sequence[Sequence[int]]) -> None:
        self.partitions = [set(g) for g in groups]

    def heal(self) -> None:
        self.partitions = None

    def _can_send(self, i: int, j: int) -> bool:
        if self.partitions is None:
            return True
        return any(i in g and j in g for g in self.partitions)

    # ------------------------------------------------------------ delivery

    def _placed_payloads(self, dst_id: str, payloads: Dict) -> Dict:
        """Payloads `dst_id` should receive under the placement (all of
        them when no placement is configured)."""
        if self.placement is None:
            self.obs.counter("gossip_payloads_shipped_total").inc(
                len(payloads))
            return payloads
        placed = {eid: p for eid, p in payloads.items()
                  if self.placement.is_holder(dst_id, eid)}
        self.obs.counter("gossip_payloads_shipped_total").inc(len(placed))
        self.obs.counter("gossip_payloads_filtered_total").inc(
            len(payloads) - len(placed))
        return placed

    def _send(self, i: int, j: int) -> None:
        self.obs.counter("gossip_sends_total").inc()
        src, dst = self.nodes[i], self.nodes[j]
        if self.transport is not None:
            self._send_wire(src, dst)
        elif self.use_deltas:
            seen = VersionVector(src.known.get(dst.node_id, {}))
            d = delta_since(src.state, seen)
            d = Delta(d.adds, d.removes, d.vv,
                      self._placed_payloads(dst.node_id, d.payloads),
                      d.compressed)
            dst.receive_delta(d)
            self.bytes_sent += d.approx_bytes()
            src.known[dst.node_id] = src.state.vv.to_dict()
        else:
            # full-state pushes count no payloads, as in the reference
            # (it counts them only where a placement filters them)
            s = src.state
            if self.placement is not None:
                s = CRDTMergeState(s.adds, s.removes, s.vv,
                                   self._placed_payloads(dst.node_id,
                                                         s.store))
            dst.receive_state(s)

    def _send_wire(self, src: GossipNode, dst: GossipNode) -> None:
        """Serialize through the wire codec and a transport; delivery
        stays synchronous (the rounds are the schedule)."""
        from repro_torch.net.wire import DeltaMsg, StateMsg
        if self.use_deltas:
            seen = VersionVector(src.known.get(dst.node_id, {}))
            d = delta_since(src.state, seen,
                            compress=self.compress_payloads)
            msg = DeltaMsg(src.node_id, d.adds, d.removes, d.vv,
                           self._placed_payloads(dst.node_id, d.payloads),
                           d.compressed)
            src.known[dst.node_id] = src.state.vv.to_dict()
        else:
            s = src.state
            msg = StateMsg(src.node_id, s.adds, s.removes, s.vv,
                           self._placed_payloads(dst.node_id,
                                                 dict(s.store)))
        self.bytes_sent += self.transport.send(src.node_id, dst.node_id,
                                               msg)
        for _peer, received in self.transport.recv_ready(dst.node_id):
            dst.receive_wire(received)

    def drain(self, max_iters: int = 10_000) -> None:
        """Deliver every in-flight transport frame (socket transports may
        lag a send by a kernel round trip; queues drain in order).
        Spooling transports (persistent connections) are flushed each
        pass so bytes the kernel deferred keep moving."""
        if self.transport is None:
            return
        import time
        for _ in range(max_iters):
            progressed = False
            for node in self.nodes:
                for _src, msg in self.transport.recv_ready(node.node_id):
                    node.receive_wire(msg)
                    progressed = True
            if not progressed:
                self.transport.flush()
                if self.transport.pending() == 0:
                    return
                time.sleep(0.001)
        raise RuntimeError("transport did not drain")

    def all_pairs_round(self, order: Optional[List[Tuple[int, int]]] = None
                        ) -> None:
        """The paper's prototype: every directed pair, in a (possibly
        shuffled) order."""
        self.obs.counter("gossip_rounds_total").inc(protocol="all_pairs")
        n = len(self.nodes)
        pairs = order or [(i, j) for i in range(n) for j in range(n)
                          if i != j]
        if order is None:
            self.rng.shuffle(pairs)
        for i, j in pairs:
            if self._can_send(i, j):
                self._send(i, j)
        self.drain()

    def epidemic_round(self, fanout: int = 3) -> None:
        self.obs.counter("gossip_rounds_total").inc(protocol="epidemic")
        n = len(self.nodes)
        for i in range(n):
            peers = [j for j in range(n) if j != i and self._can_send(i, j)]
            if not peers:
                continue
            for j in self.rng.sample(peers, min(fanout, len(peers))):
                self._send(i, j)
        self.drain()

    def run_epidemic(self, fanout: int = 3, max_rounds: int = 64) -> int:
        """Gossip until all (reachable) roots agree; returns rounds used."""
        for r in range(1, max_rounds + 1):
            self.epidemic_round(fanout)
            if self.converged():
                return r
        return max_rounds

    # ---------------------------------------------------------- inspection

    def roots(self) -> List[bytes]:
        return [n.root() for n in self.nodes]

    def converged(self) -> bool:
        if self.partitions is None:
            rs = self.roots()
            return all(r == rs[0] for r in rs)
        for g in self.partitions:
            rs = [self.nodes[i].root() for i in g]
            if not all(r == rs[0] for r in rs):
                return False
        return True

    def resolve_all(self, spec, base: Any = None, *, use_cache: bool = True,
                    trust: Any = None, **cfg) -> List[Any]:
        """Every node independently resolves the same spec (convergence
        harness). `spec` is a MergeSpec or a strategy name + cfg (the
        name form builds a validated spec — no deprecation detour)."""
        spec = coerce_spec(spec, cfg,
                           reduction=cfg.pop("reduction", None))
        if base is not None:
            base = pytree.tree_map(lambda t: t.to(self.device), base)
        return [resolve_spec(n.state, spec, base=base, trust=trust,
                             use_cache=use_cache) for n in self.nodes]

    # ------------------------------------------------- tombstone GC (L3)

    def stable_tombstones(self) -> set:
        """Causal stability (paper §7.2 L3 / Baquero et al. [3]): a
        tombstone is stable once EVERY node has observed it."""
        if not self.nodes:
            return set()
        stable = set(self.nodes[0].state.removes)
        for n in self.nodes[1:]:
            stable &= n.state.removes
        return stable

    def gc_round(self) -> int:
        """Prune causally-stable tombstones everywhere. Must run only
        after resolve() outputs have been disseminated (the paper's GC
        precondition). Returns the number of tombstones collected."""
        stable = self.stable_tombstones()
        if stable:
            for n in self.nodes:
                n.state = n.state.gc_tombstones(stable)
        return len(stable)
