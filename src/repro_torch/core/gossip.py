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
names another. Transports (`transport=`), sharded placement
(`placement=`) and `GossipNode.receive_wire` need the wire and the
sync stack of ROADMAP A6 and raise until then; the reference's
`compress_payloads` and `drain`, which act on transport frames only,
come with them.
"""
from __future__ import annotations

import random
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, \
    Tuple

from repro_torch import pytree
from repro_torch.api.replica import resolve_device
from repro_torch.api.spec import coerce_spec, MergeSpec
from repro_torch.core.delta import apply_delta, Delta, delta_since
from repro_torch.core.resolve import resolve, resolve_spec
from repro_torch.core.state import CRDTMergeState
from repro_torch.core.version_vector import VersionVector
from repro_torch.obs import MetricsRegistry

_A6 = "waits for the wire and sync stack (ROADMAP A6)"


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
        raise NotImplementedError(f"GossipNode.receive_wire {_A6}")

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
                 transport=None, placement=None,
                 obs: Optional[MetricsRegistry] = None,
                 device: Any = None):
        if transport is not None:
            raise NotImplementedError(f"GossipNetwork(transport=) {_A6}")
        if placement is not None:
            raise NotImplementedError(f"GossipNetwork(placement=) {_A6}")
        self.obs = obs if obs is not None else MetricsRegistry()
        self.device = resolve_device(device)
        self.nodes = [GossipNode(f"node{i:03d}", self.device)
                      for i in range(n)]
        self.rng = random.Random(seed)
        self.use_deltas = use_deltas
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

    def _send(self, i: int, j: int) -> None:
        self.obs.counter("gossip_sends_total").inc()
        src, dst = self.nodes[i], self.nodes[j]
        if self.use_deltas:
            seen = VersionVector(src.known.get(dst.node_id, {}))
            d = delta_since(src.state, seen)
            self.obs.counter("gossip_payloads_shipped_total").inc(
                len(d.payloads))
            dst.receive_delta(d)
            self.bytes_sent += d.approx_bytes()
            src.known[dst.node_id] = src.state.vv.to_dict()
        else:
            # full-state pushes count no payloads, as in the reference
            # (it counts them only where a placement filters them)
            dst.receive_state(src.state)

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

    def epidemic_round(self, fanout: int = 3) -> None:
        self.obs.counter("gossip_rounds_total").inc(protocol="epidemic")
        n = len(self.nodes)
        for i in range(n):
            peers = [j for j in range(n) if j != i and self._can_send(i, j)]
            if not peers:
                continue
            for j in self.rng.sample(peers, min(fanout, len(peers))):
                self._send(i, j)

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
