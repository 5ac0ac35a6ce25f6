"""Asynchronous network simulator: event loop with a virtual clock
(`repro.net.simulator`).

Messages are encoded to wire frames at send time, experience per-link
latency, bandwidth serialization delay, probabilistic loss, duplication,
and reordering jitter, and are delivered to node handlers in virtual-time
order. The event loop is deterministic for a fixed seed, so convergence
under adversarial network conditions is reproducible. Timer callbacks
(`call_at`) share the event queue, which is how the multi-source chunk
scheduler's straggler timeouts fire in virtual time.

SimGossipNetwork ports the gossip protocols (all-pairs push, epidemic
push) plus Merkle anti-entropy onto the simulator; every node is a
`net.antientropy.SyncNode`, so modes interoperate and all traffic crosses
the codec. Placement-aware helpers (`seed_placement`,
`install_fetch_hooks`, `fetch_blobs`) set up sharded-store scenarios.

The network's `random.Random(seed)` and the fleet's
`random.Random(seed ^ 0x5EED)` are drawn exactly as the reference draws
them, so for one seed both packages drop, duplicate, delay and reorder
the same frames and pick the same peers: their delivery traces (virtual
time, sender, destination, frame bytes) are equal. Frames decode onto
the network's device (`device=`, CUDA unless the caller names another),
which is also every node's.
"""
from __future__ import annotations

import heapq
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterable, List, Optional, \
    Sequence, Set, Tuple

from repro_torch.api.replica import resolve_device
from repro_torch.core.state import CRDTMergeState
from repro_torch.core.version_vector import VersionVector
from repro_torch.net.antientropy import SyncNode
from repro_torch.net.store import Placement
from repro_torch.net.wire import (
    decode_frame, delta_to_msg, encode_message, Message, state_to_msg)
from repro_torch.obs import (
    ConvergenceProbe, MetricsRegistry, Tracer, wire_phase)

Handler = Callable[["SimNetwork", str, str, Message], None]
#          (net, dst, src, msg) -> None; may call net.send() to reply


@dataclass
class LinkSpec:
    """Per-directed-link network conditions."""
    latency: float = 0.001          # propagation delay, seconds
    jitter: float = 0.0             # uniform extra delay in [0, jitter]
    bandwidth: Optional[float] = None   # bytes/sec; None = unlimited
    loss: float = 0.0               # P(frame silently dropped)
    duplicate: float = 0.0          # P(frame delivered twice)
    reorder: float = 0.0            # P(frame gets extra delay -> overtaken)
    reorder_delay: float = 0.01     # the extra delay applied when reordered


class SimNetwork:
    """Discrete-event loop: heapq of (time, seq, dst, src, frame)."""

    def __init__(self, seed: int = 0,
                 default_link: Optional[LinkSpec] = None,
                 obs: Optional[MetricsRegistry] = None,
                 device: Any = None):
        self.device = resolve_device(device)
        self.rng = random.Random(seed)
        self.default_link = default_link or LinkSpec()
        self.links: Dict[Tuple[str, str], LinkSpec] = {}
        self.handlers: Dict[str, Handler] = {}
        self.clock = 0.0
        self._events: List[Tuple[float, int, str, str, bytes]] = []
        self._seq = 0
        self._callbacks: Dict[int, Callable[["SimNetwork"], None]] = {}
        self._link_busy_until: Dict[Tuple[str, str], float] = {}
        self.partitions: Optional[List[Set[str]]] = None
        # accounting (mirrored as labeled series on self.obs: frame and
        # byte counters by type, per-peer bytes, wire-phase attribution,
        # in-flight bytes and event-queue depth gauges)
        self.obs = obs if obs is not None else MetricsRegistry()
        self.bytes_sent = 0
        self.msgs_sent = 0
        self.msgs_delivered = 0
        self.msgs_dropped = 0
        self.msgs_duplicated = 0
        self.max_frame_seen = 0         # largest single frame transmitted
        self.inflight_bytes = 0         # bytes queued, not yet delivered
        self.peak_inflight_bytes = 0    # resident-memory bound on the wire

    # ------------------------------------------------------------ topology

    def register(self, node_id: str, handler: Handler) -> None:
        self.handlers[node_id] = handler

    def set_link(self, src: str, dst: str, spec: LinkSpec) -> None:
        self.links[(src, dst)] = spec

    def set_uplinks(self, src: str, spec: LinkSpec) -> None:
        """Apply `spec` to every link out of `src` (placement scenarios:
        cap a storage node's serving bandwidth in one call)."""
        for dst in self.handlers:
            if dst != src:
                self.links[(src, dst)] = spec

    def set_downlinks(self, dst: str, spec: LinkSpec) -> None:
        """Apply `spec` to every link into `dst`."""
        for src in self.handlers:
            if src != dst:
                self.links[(src, dst)] = spec

    def partition(self, groups: Sequence[Sequence[str]]) -> None:
        self.partitions = [set(g) for g in groups]

    def heal(self) -> None:
        self.partitions = None

    def _reachable(self, src: str, dst: str) -> bool:
        if self.partitions is None:
            return True
        return any(src in g and dst in g for g in self.partitions)

    # ------------------------------------------------------------- sending

    def send(self, src: str, dst: str, msg: Message) -> int:
        """Encode, apply link conditions, schedule delivery. Returns frame
        bytes (counted even for frames the link then drops — they were
        transmitted)."""
        frame = encode_message(msg)
        n = len(frame)
        self.bytes_sent += n
        self.msgs_sent += 1
        if n > self.max_frame_seen:
            self.max_frame_seen = n
        mtype = type(msg).__name__
        self.obs.counter("net_bytes_total").inc(n, type=mtype)
        self.obs.counter("net_frames_total").inc(type=mtype)
        self.obs.counter("net_peer_bytes_total").inc(n, src=src, dst=dst)
        phase = wire_phase(mtype)
        self.obs.counter("sync_wire_bytes_total").inc(n, phase=phase)
        self.obs.counter("sync_wire_frames_total").inc(phase=phase)
        if not self._reachable(src, dst):
            self.msgs_dropped += 1
            return n
        spec = self.links.get((src, dst), self.default_link)
        if spec.loss and self.rng.random() < spec.loss:
            self.msgs_dropped += 1
            return n
        copies = 1
        if spec.duplicate and self.rng.random() < spec.duplicate:
            copies = 2
            self.msgs_duplicated += 1
        for _ in range(copies):
            start = self.clock
            if spec.bandwidth:
                key = (src, dst)
                start = max(start, self._link_busy_until.get(key, 0.0))
                tx = n / spec.bandwidth
                self._link_busy_until[key] = start + tx
                start += tx
            delay = spec.latency
            if spec.jitter:
                delay += self.rng.random() * spec.jitter
            if spec.reorder and self.rng.random() < spec.reorder:
                delay += spec.reorder_delay
            self._seq += 1
            heapq.heappush(self._events,
                           (start + delay, self._seq, dst, src, frame))
            self.inflight_bytes += n
            if self.inflight_bytes > self.peak_inflight_bytes:
                self.peak_inflight_bytes = self.inflight_bytes
        self.obs.gauge("sim_inflight_bytes").set(self.inflight_bytes)
        self.obs.gauge("net_queue_depth").set(len(self._events))
        return n

    # ---------------------------------------------------------- event loop

    def idle(self) -> bool:
        return not self._events

    def call_at(self, t: float, fn: Callable[["SimNetwork"], None]) -> None:
        """Schedule `fn(net)` at virtual time `t` (timer event; shares
        the event queue with frames, so run()/step() fire it in order)."""
        self._seq += 1
        self._callbacks[self._seq] = fn
        heapq.heappush(self._events, (max(t, self.clock), self._seq,
                                      "", "", b""))

    def step(self) -> bool:
        """Deliver the next event; returns False when the queue is empty."""
        if not self._events:
            return False
        t, seq, dst, src, frame = heapq.heappop(self._events)
        self.clock = max(self.clock, t)
        fn = self._callbacks.pop(seq, None)
        if fn is not None:
            fn(self)
            return True
        self.inflight_bytes -= len(frame)
        self.obs.gauge("sim_inflight_bytes").set(self.inflight_bytes)
        self.obs.gauge("net_queue_depth").set(len(self._events))
        handler = self.handlers.get(dst)
        if handler is not None:
            msg, _ = decode_frame(frame, device=self.device)
            self.msgs_delivered += 1
            handler(self, dst, src, msg)
        return True

    def run(self, until: Optional[float] = None,
            max_events: int = 10_000_000) -> int:
        """Drain the event loop (optionally up to virtual time `until`)."""
        n = 0
        while self._events and n < max_events:
            if until is not None and self._events[0][0] > until:
                break
            self.step()
            n += 1
        return n


# ---------------------------------------------------------------------------
# Gossip protocols ported onto the simulator
# ---------------------------------------------------------------------------


class SimGossipNetwork:
    """GossipNetwork's protocols over the simulator + wire codec.

    mode:
      * 'state'       — full-state push (the paper's prototype semantics);
      * 'delta'       — vv-filtered delta push (paper §7.2 L1);
      * 'antientropy' — Merkle-diff sessions (the production primitive).
    """

    def __init__(self, n: int, seed: int = 0, mode: str = "antientropy",
                 link: Optional[LinkSpec] = None,
                 compress_blobs: bool = False,
                 delta_refresh_every: int = 4,
                 max_frame_bytes: Optional[int] = None,
                 chunk_window: int = 8,
                 placement: Optional[Placement] = None,
                 replication: Optional[int] = None,
                 chunk_timeout: Optional[float] = None,
                 device: Any = None):
        if mode not in ("state", "delta", "antientropy"):
            raise ValueError(f"unknown mode {mode!r}")
        self.device = resolve_device(device)
        self.mode = mode
        # vv-delta push records known[peer] optimistically at send time,
        # which is sound only on reliable channels: a dropped frame would
        # otherwise suppress its entries forever (the receiver's vv never
        # catches up, but the sender believes it has). Periodically
        # forgetting the bookkeeping bounds that staleness — the resent
        # delta is redundant on clean links, corrective on lossy ones.
        # Merkle anti-entropy needs no such crutch; that is its point.
        self.delta_refresh_every = delta_refresh_every
        self._round = 0
        self.net = SimNetwork(seed=seed, default_link=link,
                              device=self.device)
        self.rng = random.Random(seed ^ 0x5EED)
        ids = [f"node{i:03d}" for i in range(n)]
        # sharded store: `replication=r` builds a rendezvous placement
        # over all simulated nodes; pass `placement=` directly to make
        # only a subset storage nodes (clients stay out of the domain)
        if placement is None and replication is not None:
            placement = Placement(ids, replication)
        self.placement = placement
        self.chunk_timeout = chunk_timeout
        node_kw = dict(compress_blobs=compress_blobs,
                       chunk_window=chunk_window, placement=placement,
                       chunk_timeout=chunk_timeout, device=self.device)
        if max_frame_bytes is not None:
            node_kw["max_frame_bytes"] = max_frame_bytes
        self._node_kw = node_kw            # crash/restart rebuilds
        self.nodes: List[SyncNode] = [
            SyncNode(nid, **node_kw) for nid in ids]
        self.by_id: Dict[str, SyncNode] = {x.node_id: x for x in self.nodes}
        self._tick_armed: Set[str] = set()
        self._storage_dir: Optional[str] = None
        for node in self.nodes:
            self.net.register(node.node_id, self._make_handler(node))

    def _make_handler(self, node: SyncNode) -> Handler:
        def handler(net: SimNetwork, _dst: str, _src: str,
                    msg: Message) -> None:
            node.clock = net.clock
            for peer, reply in node.handle(msg):
                net.send(node.node_id, peer, reply)
            self._arm_tick(node)
        return handler

    def _arm_tick(self, node: SyncNode) -> None:
        """Schedule a straggler-timeout check while the node has chunk
        windows outstanding (one timer per node at a time; it re-arms
        itself until nothing is pending)."""
        if (self.chunk_timeout is None or not node._chunk_pending
                or node.node_id in self._tick_armed):
            return
        self._tick_armed.add(node.node_id)

        def fire(net: SimNetwork) -> None:
            if self.by_id.get(node.node_id) is not node:
                return          # node crashed (or was replaced) meanwhile
            self._tick_armed.discard(node.node_id)
            node.clock = net.clock
            for peer, reply in node.tick(net.clock):
                net.send(node.node_id, peer, reply)
            self._arm_tick(node)

        self.net.call_at(self.net.clock + self.chunk_timeout, fire)

    # ------------------------------------------------------------- seeding

    def contribute_all(self, make_contribution) -> None:
        """make_contribution(i) -> payload for node i."""
        for i, node in enumerate(self.nodes):
            node.contribute(make_contribution(i))

    # ------------------------------------------------- sharded-store setup

    def seed_placement(self) -> None:
        """Jump to the placed steady state: every node holds the full
        Layer-1 metadata, and each payload is resident exactly at its
        placement holders (as if replication already converged). Test
        and benchmark scaffolding — production reaches this state via
        anti-entropy rounds plus shed_blobs()."""
        if self.placement is None:
            raise ValueError("seed_placement needs a placement")
        adds = frozenset().union(*(x.state.adds for x in self.nodes))
        removes = frozenset().union(*(x.state.removes for x in self.nodes))
        vv = VersionVector()
        payloads: Dict[str, object] = {}
        for x in self.nodes:
            vv = vv.merge(x.state.vv)
            payloads.update(x.state.store)
        for node in self.nodes:
            store = {eid: p for eid, p in payloads.items()
                     if self.placement.is_holder(node.node_id, eid)}
            node.state = CRDTMergeState(adds, removes, vv, store)

    def install_fetch_hooks(self) -> None:
        """Give every node a fetch-on-resolve hook: pin the missing eids,
        HaveReq their placement holders, drain the event loop, unpin.
        Must be invoked from outside the event loop (resolve() is an
        application-level call, not a message handler)."""
        for node in self.nodes:
            node.fetch_hook = self._fetch_hook

    # -------------------------------------------- durability: crash/restart

    def attach_storage(self, dirname: str) -> None:
        """Make every node durable: one `DurableStore` directory per
        node under `dirname`, write-through from here on. Prerequisite
        for crash_node/restart_node round trips."""
        import os
        from repro_torch.core.journal import DurableStore
        self._storage_dir = dirname
        for node in self.nodes:
            node.attach_storage(
                DurableStore(os.path.join(dirname, node.node_id),
                             device=self.device))

    def crash_node(self, node_id: str) -> None:
        """Kill a node with no shutdown courtesy — a process death, not
        a clean stop. Its handler is deregistered (frames addressed to
        it silently vanish, exactly like a dead host), pending timers
        are orphaned, and nothing is flushed or detached: whatever its
        durable directory holds at this instant is what a restart gets.
        (Write paths flush eagerly, so dropping the handles loses no
        acknowledged bytes — the file close below is byte-neutral and
        only returns descriptors to the OS.)"""
        node = self.by_id.pop(node_id)
        self.nodes.remove(node)
        self.net.handlers.pop(node_id, None)
        self._tick_armed.discard(node_id)
        storage = getattr(node, "storage", None)
        if storage is not None:
            for log in (storage.blobs._log, storage.journal._log):
                try:
                    log._f.close()
                except OSError:
                    pass
            storage.closed = True

    def restart_node(self, node_id: str) -> SyncNode:
        """Bring a crashed node back as a fresh process: a brand-new
        SyncNode whose only knowledge is what `attach_storage`'s durable
        directory replays — recovered Layer-1 metadata at the exact
        pre-crash Merkle root, every locally-held blob served with zero
        network bytes. Re-registers the handler and re-installs the
        fetch hook if the fleet uses one."""
        import os
        from repro_torch.core.journal import DurableStore
        if node_id in self.by_id:
            raise ValueError(f"{node_id} is still alive")
        node = SyncNode(node_id, **self._node_kw)
        if self._storage_dir is not None:
            node.attach_storage(
                DurableStore(os.path.join(self._storage_dir, node_id),
                             device=self.device))
        self.nodes.append(node)
        self.nodes.sort(key=lambda x: x.node_id)
        self.by_id[node_id] = node
        self.net.register(node_id, self._make_handler(node))
        if any(x.fetch_hook is not None for x in self.nodes if x is not node):
            node.fetch_hook = self._fetch_hook
        return node

    def _fetch_hook(self, node: SyncNode,
                    eids: Sequence[str]) -> Dict[str, object]:
        got = self.fetch_blobs(node, eids)
        return {e: node.state.store[e] for e in got}

    def fetch_blobs(self, node: SyncNode,
                    eids: Optional[Iterable[str]] = None,
                    peers: Optional[Sequence[str]] = None) -> List[str]:
        """Pull blobs to `node` by multi-source chunk fetch and return
        the eids obtained. Discovery goes to `peers` if given, else to
        each eid's placement holders."""
        want = tuple(eids) if eids is not None else node.missing_blobs()
        want = tuple(e for e in want if e not in node.state.store)
        if not want:
            return []
        node.want_blobs(want)
        node.clock = self.net.clock
        try:
            for peer, msg in node.query_holders(want, peers=peers):
                self.net.send(node.node_id, peer, msg)
            self.net.run()
        finally:
            node.unwant_blobs(want)
        return [e for e in want if e in node.state.store]

    # -------------------------------------------------------------- rounds

    def _push(self, src: SyncNode, dst: SyncNode) -> None:
        if self.mode == "state":
            self.net.send(src.node_id, dst.node_id,
                          state_to_msg(src.state, src.node_id))
        elif self.mode == "delta":
            from repro_torch.core.delta import delta_since
            seen = VersionVector(src.known.get(dst.node_id, {}))
            d = delta_since(src.state, seen)
            self.net.send(src.node_id, dst.node_id,
                          delta_to_msg(d, src.node_id))
            src.known[dst.node_id] = src.state.vv.to_dict()
        else:
            self.net.send(src.node_id, dst.node_id,
                          src.begin_sync(dst.node_id))

    def _start_round(self) -> None:
        self._round += 1
        if (self.mode == "delta" and self.delta_refresh_every
                and self._round % self.delta_refresh_every == 0):
            for node in self.nodes:
                node.known.clear()

    def all_pairs_round(self) -> None:
        self._start_round()
        self.net.obs.counter("gossip_rounds_total").inc(
            protocol="all_pairs")
        n = len(self.nodes)
        pairs = [(i, j) for i in range(n) for j in range(n) if i != j]
        self.rng.shuffle(pairs)
        for i, j in pairs:
            self._push(self.nodes[i], self.nodes[j])
        self.net.run()

    def epidemic_round(self, fanout: int = 3) -> None:
        self._start_round()
        self.net.obs.counter("gossip_rounds_total").inc(
            protocol="epidemic")
        n = len(self.nodes)
        for i in range(n):
            peers = [j for j in range(n) if j != i]
            for j in self.rng.sample(peers, min(fanout, len(peers))):
                self._push(self.nodes[i], self.nodes[j])
        self.net.run()

    def run_epidemic(self, fanout: int = 3, max_rounds: int = 64,
                     require_blobs: bool = False) -> int:
        """Rounds until all roots agree (or max_rounds). Lossy links may
        need several rounds — anti-entropy retries are the recovery
        mechanism, not retransmission. With require_blobs, also gossip
        until every store holds every referenced payload (metadata roots
        converge first; blob shipping can trail by a round under loss)."""
        for r in range(1, max_rounds + 1):
            self.epidemic_round(fanout)
            if self.converged(require_blobs=require_blobs):
                return r
        return max_rounds

    # ---------------------------------------------------------- inspection

    def roots(self) -> List[bytes]:
        return [x.root() for x in self.nodes]

    def converged(self, require_blobs: bool = False) -> bool:
        rs = self.roots()
        if not all(r == rs[0] for r in rs):
            return False
        if require_blobs:
            return all(not x.missing_blobs() for x in self.nodes)
        return True

    # ------------------------------------------------------- observability

    def make_tracer(self, **meta) -> Tracer:
        """A Tracer on the simulator's virtual clock: spans recorded
        while the loop runs are deterministic for a fixed seed and
        schedule (same run -> byte-identical JSONL trace)."""
        return Tracer(clock=lambda: self.net.clock, **meta)

    def make_probe(self,
                   registry: Optional[MetricsRegistry] = None
                   ) -> ConvergenceProbe:
        """A ConvergenceProbe on the virtual clock; feed it with
        `observe_convergence` after each round. Time-to-convergence is
        then measured in simulated seconds — a property of the
        schedule, not the host machine."""
        return ConvergenceProbe(
            registry=registry if registry is not None else self.net.obs,
            clock=lambda: self.net.clock)

    def observe_convergence(self, probe: ConvergenceProbe) -> bool:
        """Record every node's current Merkle root into the probe."""
        return probe.observe(
            {x.node_id: x.root().hex() for x in self.nodes})

    def resolve_all(self, spec, base=None, *, use_cache: bool = True,
                    trust=None, **cfg):
        """Every node independently resolves the same spec. `spec` is a
        MergeSpec or a strategy name + cfg (the name form builds a
        validated MergeSpec — no deprecation detour); `trust=` supplies
        the converged TrustState for `trust_threshold` specs."""
        from repro_torch.api.spec import coerce_spec
        spec = coerce_spec(spec, cfg,
                           reduction=cfg.pop("reduction", None))
        return [x.resolve_spec(spec, base=base, trust=trust,
                               use_cache=use_cache)
                for x in self.nodes]

    @property
    def bytes_sent(self) -> int:
        return self.net.bytes_sent
