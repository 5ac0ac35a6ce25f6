"""Merkle-partitioned anti-entropy reconciliation (`repro.net.
antientropy`; digest-driven sync).

The production sync primitive for state-based CRDTs (Preguiça, arXiv:
1806.10254 §5): instead of pushing full states (O(state) per message) or
trusting version-vector bookkeeping (delta_since — kept as the fast
path), two replicas compare digests and ship exactly the symmetric
difference of their OR-Set entries plus the store blobs the peer lacks.

Session flow (initiator A, responder B), all messages via `net.wire`:

    A -> B  SyncReq(root_A, bits, vv_A)
    B -> A  SyncDone(vv_B)                 if root_B == root_A
            BucketsMsg(bucket digests)     otherwise
    A -> B  BucketItemsMsg(A's entries in differing buckets, want=those)
    B -> A  BucketItemsMsg(B's entries in want buckets)  [+ BlobReq]
    A -> B  BlobReq(eids A's store lacks)
    B -> A  BlobResp(blobs)                [symmetrically A -> B]

Blob transfer is size-aware: blobs whose canonical encoding fits the
frame budget are batched into BlobResp frames; larger ones are announced
with a BlobManifest (per-chunk SHA-256) and stream as windowed
ChunkReq/ChunkData exchanges, every frame bounded by max_frame_bytes.
Reassembly state lives on the node, not the session, so a transfer
killed mid-stream resumes in the next session without re-shipping any
verified chunk. Chunk fetch is multi-source: every peer that announces
a manifest for an in-progress blob, or answers a HaveReq with a HaveMap
claiming it, joins that blob's source pool, and the scheduler keeps one
disjoint window of missing chunks outstanding per source. A window that
stalls past `chunk_timeout` (harness-driven `tick(now)`) marks its
source slow and re-assigns its chunks to the remaining sources.

With a `Placement` (`net.store`), blobs are partitioned across storage
nodes by rendezvous hashing: `missing_blobs()` shrinks to the eids this
node is responsible for (plus `want_blobs` pins, the fetch-on-resolve
path), `shed_blobs()` drops payloads placed elsewhere, and
`query_holders()` aims HaveReq discovery at the placement's holders.
Layer-1 metadata stays fully replicated.

The protocol is the reference's, handler for handler: for the same
inputs a port node sends the same frames, byte for byte and in the same
order, and the two packages' nodes finish sessions with each other.
What is the port's own is where payloads live: a node holds its store
on `device` (CUDA unless the caller names another). Payloads that
arrive — a StateMsg or DeltaMsg push, a BlobResp, a reassembled chunk
stream — are decoded or moved onto it, so a CUDA node merges what it
receives on the card; `keep_quantized=True` keeps int8 payloads as
`CompressedTree`s there (merge on arrival, B2). A reassembled blob's
chunks are released once joined.
"""
from __future__ import annotations

import hashlib
import time
from collections import Counter, OrderedDict
from typing import (Any, Callable, Dict, FrozenSet, Iterable, List, Optional,
                    Sequence, Set, Tuple)

from repro_torch.api.replica import resolve_device
from repro_torch.api.spec import coerce_spec, MergeSpec
from repro_torch.core.compression import (
    compress_tree, CompressedTree, decompress_tree, to_device)
from repro_torch.core.delta import apply_delta, Delta
from repro_torch.core.merkle import (
    bucket_digests, diff_buckets, pick_bucket_bits, prefix_bucket)
from repro_torch.core.resolve import resolve as _legacy_resolve
from repro_torch.core.resolve import resolve_spec as _resolve_spec
from repro_torch.core.state import AddEntry, CRDTMergeState
from repro_torch.net.store import (
    bitmap_indices, BlobSource, chunk_bitmap, payload_nbytes, Placement)
from repro_torch.net.wire import (
    BlobManifest, BlobReq, BlobResp, BucketItemsMsg, BucketsMsg,
    CHUNK_ENVELOPE, ChunkData, ChunkReq, decode_blob, DEFAULT_MAX_FRAME,
    DeltaMsg, encode_blob, HaveEntry, HaveMap, HaveReq, leaf_refs,
    manifest_entry, ManifestEntry, Message, msg_to_delta, msg_to_state,
    ResolveSpecMsg, SparseManifest, SparseManifestEntry, StateMsg, SyncDone,
    SyncReq, WireError)
from repro_torch.obs import CounterView, MetricsRegistry
from repro_torch.obs import enabled as _obs_enabled
from repro_torch.obs import span as _span

Reply = Tuple[str, Message]


# ---------------------------------------------------------------------------
# Reconciliation items: hashable wire identities for OR-Set entries
# ---------------------------------------------------------------------------


def _add_hash(e: AddEntry) -> bytes:
    return hashlib.sha256(
        f"add|{e.element_id}|{e.tag}|{e.node}".encode()).digest()


def _rm_hash(tag: str) -> bytes:
    return hashlib.sha256(f"rm|{tag}".encode()).digest()


def state_items(state: CRDTMergeState) -> Dict[bytes, Tuple[str, Any]]:
    """hash -> ('add', AddEntry) | ('rm', tag) over the full item set."""
    items: Dict[bytes, Tuple[str, Any]] = {}
    for e in state.adds:
        items[_add_hash(e)] = ("add", e)
    for tag in state.removes:
        items[_rm_hash(tag)] = ("rm", tag)
    return items


def _root_of_items(items: Dict[bytes, Tuple[str, Any]]) -> bytes:
    h = hashlib.sha256(b"antientropy/root")
    for item in sorted(items):
        h.update(item)
    return h.digest()


def reconcile_root(state: CRDTMergeState) -> bytes:
    """Digest of the full item set (adds ∪ tombstones), order-independent."""
    return _root_of_items(state_items(state))


def _entries_in_buckets(items: Dict[bytes, Tuple[str, Any]], bits: int,
                        wanted: Iterable[int]
                        ) -> Tuple[FrozenSet[AddEntry], FrozenSet[str]]:
    wanted = set(wanted)
    adds, removes = [], []
    for h, (kind, val) in items.items():
        if prefix_bucket(h, bits) in wanted:
            (adds if kind == "add" else removes).append(val)
    return frozenset(adds), frozenset(removes)


_MAX_BITS = 16          # prefix_bucket's domain; wire allows a full u8


def _bits_ok(bits: int) -> bool:
    return 0 <= bits <= _MAX_BITS


# ---------------------------------------------------------------------------
# Chunk reassembly
# ---------------------------------------------------------------------------


class _PartialBlob:
    """Reassembly state for one streaming blob.

    Lives on the SyncNode (not the session): verified chunks survive lost
    frames, dead sessions, and peer changes, so a resumed transfer only
    requests — and the peer only re-ships — chunks never verified."""

    __slots__ = ("eid", "chunk_size", "total_size", "digests", "chunks")

    def __init__(self, entry: ManifestEntry):
        self.eid = entry.eid
        self.chunk_size = entry.chunk_size
        self.total_size = entry.total_size
        self.digests = entry.digests
        self.chunks: Dict[int, bytes] = {}

    def matches(self, entry: ManifestEntry) -> bool:
        return (self.chunk_size == entry.chunk_size
                and self.total_size == entry.total_size
                and self.digests == entry.digests)

    def missing(self) -> List[int]:
        return [i for i in range(len(self.digests)) if i not in self.chunks]

    def complete(self) -> bool:
        return len(self.chunks) == len(self.digests)

    def assemble(self) -> bytes:
        return b"".join(self.chunks[i] for i in range(len(self.digests)))


def _manifest_entry_ok(entry: ManifestEntry) -> bool:
    n, cs = len(entry.digests), entry.chunk_size
    if n == 0 or cs <= 0:
        return False
    return (n - 1) * cs < entry.total_size <= n * cs


# ---------------------------------------------------------------------------
# SyncNode
# ---------------------------------------------------------------------------


class SyncNode:
    """A replica that speaks the full wire message set.

    handle(msg) -> [(dst, reply), ...] is transport-agnostic: the
    synchronous pump (transport.pump), the discrete-event simulator, and
    loopback sockets all drive the same handler. Also accepts plain
    StateMsg/DeltaMsg pushes, so the legacy gossip protocols and
    anti-entropy can interoperate on one node.
    """

    def __init__(self, node_id: str,
                 state: Optional[CRDTMergeState] = None,
                 compress_blobs: bool = False,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME,
                 chunk_window: int = 8,
                 placement: Optional[Placement] = None,
                 chunk_timeout: Optional[float] = None,
                 max_fetch_timeouts: int = 8,
                 keep_quantized: bool = False,
                 obs: Optional[MetricsRegistry] = None,
                 device: Any = None):
        if max_frame_bytes <= CHUNK_ENVELOPE:
            raise ValueError(f"max_frame_bytes must exceed {CHUNK_ENVELOPE}")
        self.node_id = node_id
        # where the store's payloads live; arriving ones land here
        self.device = resolve_device(device)
        # durable write-through (core.journal.DurableStore): when
        # set, every replacement of self.state records its transition to
        # disk before the assignment is visible. None = in-memory node.
        # Set before _state so the property setter can consult it.
        self.storage = None
        self._state = state or CRDTMergeState()
        self.compress_blobs = compress_blobs
        # merge-on-arrival opt-in: keep arriving int8 payloads
        # (CompressedTree) in the store un-densified — the merge engine
        # plans against their announced/derived metadata and merges the
        # int8 bytes directly in the quant_nary kernel. Off by default:
        # the store holds dequantized tensors.
        self.keep_quantized = keep_quantized
        self.max_frame_bytes = max_frame_bytes
        self.chunk_window = max(1, chunk_window)
        # sharded store: when set, this node is responsible only for the
        # eids the placement function assigns it (plus want_blobs pins)
        self.placement = placement
        # straggler detection: a chunk window with no progress for this
        # many (harness-clock) seconds is re-assigned by tick(). None
        # disables timeouts — lost windows then fall to session GC.
        self.chunk_timeout = chunk_timeout
        self.max_fetch_timeouts = max(1, max_fetch_timeouts)
        # harness-maintained clock (simulator virtual time or wall time);
        # only read relative to itself, so the epoch is irrelevant
        self.clock = 0.0
        # fetch-on-resolve: hook(self, missing_eids) -> {eid: payload},
        # installed by the harness (e.g. SimGossipNetwork) to pull
        # non-resident blobs over the network when resolve() needs them
        self.fetch_hook: Optional[
            Callable[["SyncNode", Tuple[str, ...]], Dict[str, Any]]] = None
        # data budget per frame: a full chunk + envelope stays <= max
        self._chunk_payload = max_frame_bytes - CHUNK_ENVELOPE
        self.known: Dict[str, dict] = {}      # peer -> last-sent vv (deltas)
        self.merge_calls = 0
        # per-node metrics registry (injectable; never shared between
        # nodes by default — each node's counts are its own). stats is
        # the Counter-shaped view over sync_events_total{event=...}.
        self.obs = obs if obs is not None else MetricsRegistry()
        self.stats = CounterView(self.obs, "sync_events_total")
        self._sid = 0
        # eids with a BlobResp/BlobManifest pending, per (peer, session):
        # a response only retires its own session's requests, never those
        # pending against other peers (concurrent sessions in one round
        # would otherwise re-fetch every blob fanout-times over).
        self._blob_inflight: Dict[Tuple[str, int], Set[str]] = {}
        # eid -> reassembly state; persists across sessions (resume)
        self._partials: Dict[str, _PartialBlob] = {}
        # (peer, sid, eid) -> chunk indices awaited from that session
        self._chunk_pending: Dict[Tuple[str, int, str], Set[int]] = {}
        # multi-source pool: eid -> {peer -> BlobSource}; every peer that
        # announced a manifest or claimed the blob in a HaveMap. The
        # scheduler keeps one disjoint window outstanding per source.
        self._sources: Dict[str, Dict[str, BlobSource]] = {}
        # eid -> peers whose window timed out (skipped until the pool
        # would otherwise idle); eid -> consecutive timeout count
        self._slow: Dict[str, Set[str]] = {}
        self._timeouts: Counter = Counter()
        # (peer, sid, eid) -> clock time of last progress on that window
        self._req_time: Dict[Tuple[str, int, str], float] = {}
        # eids pinned fetchable regardless of placement responsibility
        self._wanted: Set[str] = set()
        # latest resolve description gossiped by each peer (wire v2
        # ResolveSpecMsg): what to resolve converges like everything
        # else. "Latest" is by the sender's sid, not arrival order —
        # the network reorders and duplicates frames.
        self.specs_seen: Dict[str, Any] = {}
        self._spec_sids: Dict[str, int] = {}
        # request-state generation stamps: entries carry the value of
        # self._sessions at creation/refresh; anything older than the
        # latest begin_sync() is a dead session's leftovers (nothing a
        # prior session sent can still be in flight once a new one
        # starts) and is GC'd so its eids become requestable again —
        # from ANY peer, not just the one the dead session spoke to.
        self._sessions = 0
        self._req_stamp: Dict[tuple, int] = {}
        # responder-side cache of canonical blob encodings (chunk source)
        self._enc_cache: "OrderedDict[str, bytes]" = OrderedDict()
        self._enc_cache_limit = 4
        # item-hash memo: states are immutable, so the per-entry SHA-256
        # pass is recomputed only when self.state is replaced (mirrors
        # CRDTMergeState._root). Keyed by identity; holding the state ref
        # keeps the id stable.
        self._items_for: Optional[CRDTMergeState] = None
        self._items: Dict[bytes, Tuple[str, Any]] = {}

    # -- durable state: write-through + lifecycle --------------------------

    @property
    def state(self) -> CRDTMergeState:
        return self._state

    @state.setter
    def state(self, new: CRDTMergeState) -> None:
        """Every state replacement funnels here. With storage attached,
        the transition is durable *before* the in-memory assignment —
        an operation the node acknowledges is one recovery replays."""
        old = self._state
        if self.storage is not None and new is not old:
            self.storage.record_transition(old, new)
        self._state = new

    def attach_storage(self, storage,
                       recovered: Optional[CRDTMergeState] = None) -> None:
        """Adopt a `DurableStore`: replay its recovered state into this
        node (CRDT join — safe whether the node is fresh or mid-flight),
        persist anything the node already held that the store did not,
        then turn on write-through. After this call the node serves every
        recovered blob locally; a warm restart fetches zero bytes.

        `recovered` is the state the store already holds, from a caller
        that replayed it and recorded every change since (a durable
        `Replica` handing its storage over): it stands in for a second
        `storage.load()`, which would decode every blob once more."""
        if recovered is None:
            recovered = storage.load()
        merged = recovered.merge(self._state)
        if (merged != recovered
                or merged.store.keys() != recovered.store.keys()):
            storage.record_transition(recovered, merged)
        self._state = merged
        self.storage = storage

    def release_storage(self):
        """Detach and return the durable store (flushed, still open);
        subsequent state replacements are in-memory only."""
        storage, self.storage = self.storage, None
        if storage is not None:
            storage.flush()
        return storage

    def close(self) -> None:
        """Idempotent shutdown: flush + close the durable store (if any)
        and drop transfer bookkeeping. The node object stays queryable
        (state/root) but must not be driven further."""
        storage, self.storage = self.storage, None
        if storage is not None:
            storage.close()
        self._partials.clear()
        self._sources.clear()
        self._chunk_pending.clear()
        self._blob_inflight.clear()

    # -- local updates -----------------------------------------------------

    def contribute(self, contribution: Any,
                   element_id: Optional[str] = None, *,
                   leaves: Optional[Iterable[str]] = None) -> None:
        """Add a contribution, moved to the node's device (a no-op when
        it is there already)."""
        self.state = self.state.add(to_device(contribution, self.device),
                                    self.node_id,
                                    element_id=element_id,
                                    leaf_paths=leaves)
        self._gc_partials()

    def retract(self, element_id: str) -> None:
        self.state = self.state.remove(element_id, self.node_id)
        self._gc_partials()

    def join(self, state: CRDTMergeState) -> None:
        """CRDT-join an externally produced state (e.g. a Replica
        attaching) and refresh partial-blob bookkeeping."""
        self.state = self.state.merge(state)
        self.merge_calls += 1
        self._gc_partials()

    def root(self) -> bytes:
        return self.state.merkle_root()

    def _counted_fetch(self):
        if self.fetch_hook is None:
            return None
        hook = self.fetch_hook

        def counted(eids):
            self.stats["resolve_blob_pulls"] += len(eids)
            return hook(self, eids)

        return counted

    def resolve_spec(self, spec: MergeSpec, base=None, *, trust=None,
                     cache=None, use_cache: bool = True):
        """Layer-2 resolve of a MergeSpec over this node's state,
        pulling absent blobs through the fetch hook. The merge engine's
        pulls are leaf-granular: the hook is invoked only for payloads
        some cache-missed leaf task actually needs, so a warm re-resolve
        on a replica that shed its blobs ships zero chunks
        (stats["resolve_blob_pulls"] counts what was pulled)."""
        if base is not None:
            base = to_device(base, self.device)
        return _resolve_spec(self.state, spec, base=base, trust=trust,
                             fetch=self._counted_fetch(), cache=cache,
                             use_cache=use_cache)

    def resolve(self, spec, base=None, *, trust=None, **cfg):
        """Resolve this node's state. Takes a MergeSpec (`trust=`
        supplies the TrustState a `trust_threshold` spec gates on); the
        historical `resolve("ties", trim=0.3)` string form is
        DEPRECATED (it rides the core.resolve shim, warning
        included)."""
        if isinstance(spec, MergeSpec):
            use_cache = cfg.pop("use_cache", True)
            return self.resolve_spec(coerce_spec(spec, cfg), base=base,
                                     trust=trust, use_cache=use_cache)
        if base is not None:
            base = to_device(base, self.device)
        return _legacy_resolve(self.state, spec, base=base, trust=trust,
                               fetch=self._counted_fetch(), **cfg)

    def missing_blobs(self) -> Tuple[str, ...]:
        """Visible elements whose payload the store lacks. Tombstoned
        elements are excluded: resolve() never reads them, GC drops their
        blobs, and requesting them forever would re-ship dead payloads in
        every session (or never terminate once no peer retains them).
        Under a placement, only eids this node is responsible for (or
        has pinned via want_blobs) count — partial replication means
        most blobs are *supposed* to live elsewhere."""
        missing = self.state.visible() - self.state.store.keys()
        if self.placement is not None:
            missing = {e for e in missing if e in self._wanted
                       or self.placement.is_holder(self.node_id, e)}
        return tuple(sorted(missing))

    # -- sharded store: pins and shedding ----------------------------------

    def want_blobs(self, eids: Iterable[str]) -> None:
        """Pin eids as fetchable/retained regardless of placement (the
        fetch-on-resolve path: resolve needs every visible payload)."""
        self._wanted.update(eids)

    def unwant_blobs(self, eids: Iterable[str]) -> None:
        self._wanted.difference_update(eids)
        self._gc_partials()

    def shed_blobs(self,
                   budget_bytes: Optional[int] = None) -> Tuple[str, ...]:
        """Drop store payloads placed on other nodes (and not pinned).

        With `budget_bytes`, additionally sheds size-aware down to the
        budget: while resident payload bytes exceed it, the largest
        non-pinned blob whose placement names this node as a *backup*
        holder (not the primary — `placement.holders(eid)[0]`) is
        dropped, largest-first so one oversized checkpoint frees budget
        before a pile of adapters is touched. Primary copies and pinned
        eids are never shed under budget pressure — the budget is a
        target, not a guarantee, when primaries alone exceed it.

        Returns the dropped eids. Call only once the payload is resident
        at its holders (e.g. after a converged sync round) — shedding
        the last copy would orphan the blob until its contributor
        reappears."""
        if self.placement is None:
            return ()
        drop = sorted(
            eid for eid in self.state.store
            if eid not in self._wanted
            and not self.placement.is_holder(self.node_id, eid))
        if budget_bytes is not None:
            dead = set(drop)
            sizes = {eid: payload_nbytes(p)
                     for eid, p in self.state.store.items()
                     if eid not in dead}
            resident = sum(sizes.values())
            shedable = sorted(
                (eid for eid in sizes
                 if eid not in self._wanted
                 and self.placement.holders(eid)[0] != self.node_id),
                key=lambda e: (-sizes[e], e))
            for eid in shedable:
                if resident <= budget_bytes:
                    break
                drop.append(eid)
                resident -= sizes[eid]
                self.obs.counter("repair_events_total").inc(
                    event="budget_shed")
        if drop:
            dead = set(drop)
            store = {e: p for e, p in self.state.store.items()
                     if e not in dead}
            self.state = CRDTMergeState(self.state.adds, self.state.removes,
                                        self.state.vv, store)
            self.stats["blobs_shed"] += len(drop)
        return tuple(sorted(drop))

    def repair_membership(self, departed: str) -> List[Reply]:
        """Re-place blobs after a storage node leaves the membership.

        Shrinks the placement with `Placement.without(departed)` (HRW:
        only the departed node's blobs re-place), purges the departed
        peer from every source pool and session record, and returns the
        HaveReq discovery frames for blobs this node just became
        responsible for but does not hold — send them and pump the
        transport to restore the replication factor. No-op (empty list)
        without a placement or if `departed` is not a member."""
        if self.placement is None or departed not in self.placement.nodes:
            return []
        before = self.placement
        self.placement = before.without(departed)
        # the departed peer can serve nothing: drop its sources, pending
        # windows, and delta bookkeeping so the scheduler re-aims
        for eid, pool in list(self._sources.items()):
            if pool.pop(departed, None) is not None and not pool:
                del self._sources[eid]
        for key in [k for k in self._chunk_pending if k[0] == departed]:
            self._drop_window(key)
        for key in [k for k in self._blob_inflight if k[0] == departed]:
            del self._blob_inflight[key]
        self.known.pop(departed, None)
        for peers in self._slow.values():
            peers.discard(departed)
        # newly-responsible misses: held nowhere locally, placed here now
        # but not before the membership change
        gained = tuple(sorted(
            eid for eid in self.state.visible() - self.state.store.keys()
            if self.placement.is_holder(self.node_id, eid)
            and not before.is_holder(self.node_id, eid)))
        for _ in gained:
            self.obs.counter("repair_events_total").inc(event="replaced_eid")
        if not gained:
            return []
        self.obs.counter("repair_events_total").inc(event="repair_round")
        return self.query_holders(gained)

    def items(self) -> Dict[bytes, Tuple[str, Any]]:
        """Reconciliation items of the current state (memoized)."""
        if self._items_for is not self.state:
            self._items = state_items(self.state)
            self._items_for = self.state
        return self._items

    # -- session initiation ------------------------------------------------

    def begin_sync(self, peer: str) -> SyncReq:
        """Start an anti-entropy session; send the returned msg to `peer`.

        Sessions carry no server-side bookkeeping: the bucket bit-width
        travels in every message that needs it (SyncReq, BucketsMsg,
        BucketItemsMsg), so a replica can answer any session message
        statelessly and a lost frame leaves nothing behind."""
        self._sid += 1
        self._sessions += 1
        # A lost BlobReq/BlobResp/ChunkData must not pin eids as in-flight
        # forever: a fresh session with this peer supersedes every older
        # request held against it. Requests pending against *other* peers
        # stay — wiping them would make their blobs requestable again and
        # re-fetch fanout-times over under concurrent sessions. (Stale
        # entries for other peers fall to the generation GC instead.)
        self._expire_peer(peer)
        bits = pick_bucket_bits(len(self.items()))
        self.stats["sessions_started"] += 1
        return SyncReq(self.node_id, self._sid,
                       _root_of_items(self.items()), bits, self.state.vv)

    def propose_spec(self, spec: MergeSpec,
                     peers: Iterable[str]) -> List[Reply]:
        """Gossip *what to resolve*: one ResolveSpecMsg per peer, so a
        consortium can converge on the resolve description (strategy,
        cfg, threshold) in-band instead of via out-of-band config.
        Receivers record the latest spec per sender in `specs_seen`;
        the codec strict-validates the spec on decode."""
        self._sid += 1
        self.stats["specs_proposed"] += 1
        return [(p, ResolveSpecMsg(self.node_id, self._sid, spec))
                for p in sorted(peers) if p != self.node_id]

    # -- message handling --------------------------------------------------

    def handle(self, msg: Message) -> List[Reply]:
        """Dispatch one wire message; instrumented with a `sync.handle`
        span and a per-type handle-time histogram (skipped entirely
        when obs is disabled), plus window/pool depth gauges."""
        if not _obs_enabled():
            return self._dispatch(msg)
        mtype = type(msg).__name__
        t0 = time.perf_counter()
        with _span("sync.handle", node=self.node_id, type=mtype):
            replies = self._dispatch(msg)
        self.obs.histogram("sync_handle_seconds").observe(
            time.perf_counter() - t0, type=mtype)
        self.obs.gauge("sync_chunk_windows").set(len(self._chunk_pending))
        self.obs.gauge("sync_source_pool").set(
            sum(len(s) for s in self._sources.values()))
        return replies

    def _dispatch(self, msg: Message) -> List[Reply]:
        if isinstance(msg, StateMsg):
            self.state = self.state.merge(
                msg_to_state(msg, keep_quantized=self.keep_quantized,
                             device=self.device))
            self.merge_calls += 1
            self._gc_partials()
            return []
        if isinstance(msg, DeltaMsg):
            d = msg_to_delta(msg)
            d = Delta(d.adds, d.removes, d.vv,
                      {e: to_device(p, self.device)
                       for e, p in d.payloads.items()}, d.compressed)
            self.state = apply_delta(self.state, d)
            self.merge_calls += 1
            self._gc_partials()
            return []
        if isinstance(msg, SyncReq):
            return self._on_sync_req(msg)
        if isinstance(msg, BucketsMsg):
            return self._on_buckets(msg)
        if isinstance(msg, BucketItemsMsg):
            return self._on_bucket_items(msg)
        if isinstance(msg, BlobReq):
            return self._on_blob_req(msg)
        if isinstance(msg, BlobResp):
            return self._on_blob_resp(msg)
        if isinstance(msg, BlobManifest):
            return self._on_blob_manifest(msg)
        if isinstance(msg, SparseManifest):
            return self._on_sparse_manifest(msg)
        if isinstance(msg, ChunkReq):
            return self._on_chunk_req(msg)
        if isinstance(msg, ChunkData):
            return self._on_chunk_data(msg)
        if isinstance(msg, HaveReq):
            return self._on_have_req(msg)
        if isinstance(msg, HaveMap):
            return self._on_have_map(msg)
        if isinstance(msg, ResolveSpecMsg):
            # the codec already strict-validated the spec on decode.
            # Adopt only non-stale proposals: a reorder-delayed or
            # duplicated older frame must not overwrite a newer spec
            # (sids are per-sender monotonic).
            self.stats["specs_received"] += 1
            if msg.sid >= self._spec_sids.get(msg.sender, -1):
                self._spec_sids[msg.sender] = msg.sid
                self.specs_seen[msg.sender] = msg.spec
            else:
                self.stats["specs_stale"] += 1
            return []
        if isinstance(msg, SyncDone):
            self.state = CRDTMergeState(self.state.adds, self.state.removes,
                                        self.state.vv.merge(msg.vv),
                                        self.state.store)
            self.stats["sessions_in_sync"] += 1
            return self._maybe_blob_req(msg.sender, msg.sid)
        raise TypeError(f"unknown message {type(msg)}")

    def _protocol_error(self, what: str) -> List[Reply]:
        """Semantically invalid (but well-framed) message: drop it. The
        session silently dies; anti-entropy's retry-forever design makes
        that safe, and the replica state is untouched."""
        self.stats[f"protocol_error_{what}"] += 1
        return []

    # responder: digest comparison entry point
    def _on_sync_req(self, msg: SyncReq) -> List[Reply]:
        if not _bits_ok(msg.bits):
            return self._protocol_error("bits")
        if _root_of_items(self.items()) == msg.root:
            # Item sets identical => safe to adopt the peer's vv; reply
            # symmetrically and fetch any blobs we still lack.
            self.state = CRDTMergeState(self.state.adds, self.state.removes,
                                        self.state.vv.merge(msg.vv),
                                        self.state.store)
            done = SyncDone(self.node_id, msg.sid, self.state.vv)
            return [(msg.sender, done)] + self._maybe_blob_req(
                msg.sender, msg.sid)
        digests = bucket_digests(list(self.items()), msg.bits)
        return [(msg.sender,
                 BucketsMsg(self.node_id, msg.sid, msg.bits, digests))]

    # initiator: localise difference, ship our side, request theirs
    def _on_buckets(self, msg: BucketsMsg) -> List[Reply]:
        if not _bits_ok(msg.bits):
            return self._protocol_error("bits")
        mine = bucket_digests(list(self.items()), msg.bits)
        differing = diff_buckets(mine, msg.digests)
        self.stats["buckets_diffed"] += len(differing)
        adds, removes = _entries_in_buckets(self.items(), msg.bits,
                                            differing)
        return [(msg.sender,
                 BucketItemsMsg(self.node_id, msg.sid, msg.bits, adds,
                                removes, self.state.vv,
                                want=tuple(differing)))]

    def _on_bucket_items(self, msg: BucketItemsMsg) -> List[Reply]:
        if not _bits_ok(msg.bits):
            return self._protocol_error("bits")
        replies: List[Reply] = []
        if msg.want:
            adds, removes = _entries_in_buckets(self.items(), msg.bits,
                                                msg.want)
            replies.append((msg.sender,
                            BucketItemsMsg(self.node_id, msg.sid, msg.bits,
                                           adds, removes, self.state.vv)))
        # Join the peer's entries (a payload-less delta). The peer sent
        # everything it holds in every differing bucket, so after this
        # join we dominate its item set there and merging its vv is sound.
        self.state = apply_delta(self.state, Delta(msg.adds, msg.removes,
                                                   msg.vv))
        self.merge_calls += 1
        self.stats["items_received"] += len(msg.adds) + len(msg.removes)
        # a received tombstone may have killed an in-progress transfer
        self._gc_partials()
        replies.extend(self._maybe_blob_req(msg.sender, msg.sid))
        return replies

    # -- blob transfer: small batched responses + chunked streaming --------

    def _wire_payload(self, eid: str) -> Any:
        payload = self.state.store[eid]
        if self.compress_blobs:
            payload = compress_tree(payload)
        return payload

    def _cache_encoding(self, eid: str, enc: bytes) -> None:
        self._enc_cache[eid] = enc
        self._enc_cache.move_to_end(eid)
        while len(self._enc_cache) > self._enc_cache_limit:
            self._enc_cache.popitem(last=False)

    def _encoded_blob(self, eid: str) -> bytes:
        """Canonical encoding of the wire payload (LRU-cached: the chunk
        source is re-read once per ChunkReq window, not re-encoded)."""
        enc = self._enc_cache.get(eid)
        if enc is None:
            enc = encode_blob(self._wire_payload(eid))
        self._cache_encoding(eid, enc)
        return enc

    def _on_blob_req(self, msg: BlobReq) -> List[Reply]:
        """Serve requested blobs: small ones batched into BlobResp frames
        bounded by the frame budget, large ones announced via a manifest
        and streamed as chunks on demand."""
        replies: List[Reply] = []
        small: Dict[str, Any] = {}
        small_bytes = 0
        entries: List[ManifestEntry] = []
        sparse_entries: List[SparseManifestEntry] = []
        coverages = self.state.coverage()

        def flush_small() -> None:
            nonlocal small, small_bytes
            if small:
                self.stats["blobs_served"] += len(small)
                replies.append((msg.sender,
                                BlobResp(self.node_id, msg.sid, dict(small),
                                         self.compress_blobs)))
                small, small_bytes = {}, 0

        for eid in sorted(set(msg.eids)):
            if eid not in self.state.store:
                continue
            # one _wire_payload per eid: compress_blobs would otherwise
            # quantize every small blob twice (measure + respond)
            payload = self._wire_payload(eid)
            enc = self._enc_cache.get(eid) or encode_blob(payload)
            if len(enc) > self._chunk_payload:
                self._cache_encoding(eid, enc)      # chunk source
                me = manifest_entry(eid, enc, self._chunk_payload)
                self.stats["blobs_announced"] += 1
                if coverages.get(eid) is not None:
                    # sparse blobs announce at leaf granularity: the
                    # SparseManifest embeds the same chunking manifest
                    # (transfer can start from it) plus per-leaf refs so
                    # the requester's planner can key per-leaf subsets —
                    # and skip the fetch entirely — before any chunk
                    # arrives. Leaf refs describe the wire-format
                    # payload, i.e. what the receiver's store will hold;
                    # leaf_refs dequantizes CompressedTree leaves one at
                    # a time for digesting and carries each int8 leaf's
                    # scale so the planner can merge-on-arrival.
                    sparse_entries.append(
                        SparseManifestEntry(me, leaf_refs(payload)))
                    self.stats["sparse_manifests_sent"] += 1
                else:
                    entries.append(me)
                continue
            # +128 approximates the per-entry envelope (eid + lengths)
            if small and small_bytes + len(enc) + 128 > self._chunk_payload:
                flush_small()
            small[eid] = payload
            small_bytes += len(enc) + 128
        flush_small()
        if entries:
            replies.append((msg.sender,
                            BlobManifest(self.node_id, msg.sid,
                                         tuple(entries))))
        if sparse_entries:
            replies.append((msg.sender,
                            SparseManifest(self.node_id, msg.sid,
                                           tuple(sparse_entries))))
        return replies

    def _on_blob_resp(self, msg: BlobResp) -> List[Reply]:
        store = dict(self.state.store)
        for eid, payload in msg.payloads.items():
            if eid not in store:
                payload = to_device(payload, self.device)
                store[eid] = (decompress_tree(payload)
                              if isinstance(payload, CompressedTree)
                              and not self.keep_quantized
                              else payload)
        self.stats["blobs_received"] += len(msg.payloads)
        self.state = CRDTMergeState(self.state.adds, self.state.removes,
                                    self.state.vv, store)
        # Retire only the eids THIS frame carried, only in this session:
        # one BlobReq can be answered by several BlobResp frames (the
        # responder flushes at the frame budget) plus a manifest, so
        # dropping the whole session entry on the first frame would make
        # the still-coming eids requestable again — the fanout-times
        # duplicate fetch this tracking exists to prevent. Eids the peer
        # lacks entirely stay pinned until the session is superseded
        # (begin_sync with that peer) or the generation GC retires it.
        key = (msg.sender, msg.sid)
        inflight = self._blob_inflight.get(key)
        if inflight is not None:
            inflight.difference_update(msg.payloads)
            if not inflight:
                del self._blob_inflight[key]
                self._req_stamp.pop(key, None)
        return []

    def _on_sparse_manifest(self, msg: SparseManifest) -> List[Reply]:
        """Leaf-granular announcement: feed every entry's per-leaf refs
        into the planner's digest memo (`engine.note_meta`) — resolve
        can then plan per-leaf contribution subsets, and complete warm
        or fold-resumable plans, with the payload still on the wire —
        then adopt the embedded chunk manifests exactly as a
        BlobManifest (the announcer joins each blob's source pool)."""
        from repro_torch.core import engine
        for e in msg.entries:
            engine.note_meta(e.eid,
                             [l.path for l in e.leaves],
                             [l.digest for l in e.leaves],
                             [l.shape for l in e.leaves],
                             [l.dtype for l in e.leaves],
                             scales=[l.scale for l in e.leaves])
        self.stats["sparse_manifests_received"] += len(msg.entries)
        return self._on_blob_manifest(
            BlobManifest(msg.sender, msg.sid,
                         tuple(e.manifest for e in msg.entries)))

    def _on_blob_manifest(self, msg: BlobManifest) -> List[Reply]:
        self._gc_stale_requests()
        self._gc_partials()
        replies: List[Reply] = []
        inflight = self._blob_inflight.get((msg.sender, msg.sid))
        missing = set(self.missing_blobs())
        for entry in msg.entries:
            if inflight is not None:
                inflight.discard(entry.eid)
            if entry.eid not in missing:
                continue
            if not _manifest_entry_ok(entry):
                self.stats["protocol_error_manifest"] += 1
                continue
            if entry.chunk_size > self._chunk_payload:
                # adopting a chunking above our own frame budget would
                # invite ChunkData frames exceeding max_frame_bytes (and
                # a partial no smaller-budget peer could ever complete);
                # wait for a peer whose chunking fits our config
                self.stats["manifest_oversize"] += 1
                continue
            partial = self._partials.get(entry.eid)
            if partial is None or (not partial.matches(entry)
                                   and not partial.chunks):
                # adopt: fresh transfer, or an empty partial re-chunked
                partial = _PartialBlob(entry)
                self._partials[entry.eid] = partial
            elif not partial.matches(entry):
                # a differently-chunked announcement cannot extend the
                # verified chunks we hold; wait for a matching peer
                self.stats["manifest_mismatch"] += 1
                continue
            # The announcer holds the whole blob: it joins the source
            # pool. A second session announcing an in-progress blob used
            # to be dropped (one stream per blob, deduped); now it is an
            # extra source and the scheduler fans disjoint windows of
            # the same blob across every source in parallel.
            srcs = self._sources.setdefault(entry.eid, {})
            if srcs and msg.sender not in srcs:
                self.stats["chunk_stream_joined"] += 1
            srcs[msg.sender] = BlobSource(msg.sid, None, self._sessions)
            self._slow.get(entry.eid, set()).discard(msg.sender)
            replies.extend(self._pump_chunk_reqs(entry.eid))
        if inflight is not None and not inflight:
            self._blob_inflight.pop((msg.sender, msg.sid), None)
            self._req_stamp.pop((msg.sender, msg.sid), None)
        return replies

    def _next_chunk_req(self, peer: str, sid: int, partial: _PartialBlob,
                        have: Optional[FrozenSet[int]] = None
                        ) -> Optional[Reply]:
        """Request the next window of chunks this node neither holds nor
        awaits elsewhere (optionally restricted to the chunks `peer` can
        serve). Windowing bounds bytes in flight: at most chunk_window
        frames of this blob traverse one link at once."""
        elsewhere: Set[int] = set()
        for (_p, _s, eid), idxs in self._chunk_pending.items():
            if eid == partial.eid:
                elsewhere |= idxs
        want = [i for i in partial.missing()
                if i not in elsewhere and (have is None or i in have)]
        want = want[:self.chunk_window]
        if not want:
            return None
        key = (peer, sid, partial.eid)
        self._chunk_pending[key] = set(want)
        self._req_stamp[key] = self._sessions
        self._req_time[key] = self.clock
        self.stats["chunk_reqs"] += 1
        return (peer, ChunkReq(self.node_id, sid, partial.eid,
                               partial.chunk_size, tuple(want)))

    def _pump_chunk_reqs(self, eid: str) -> List[Reply]:
        """Multi-source scheduling: give every idle source one disjoint
        window of the blob's missing chunks. Sources marked slow are
        skipped while any other source is active; once the pool would
        idle entirely, slow sources are forgiven and retried (they may
        merely be behind a congested link)."""
        partial = self._partials.get(eid)
        srcs = self._sources.get(eid)
        if partial is None or not srcs:
            return []
        busy = {k[0] for k in self._chunk_pending if k[2] == eid}
        slow = self._slow.get(eid, set())
        idle = [p for p in srcs if p not in busy and p not in slow]
        if not idle and not busy:
            self._slow.pop(eid, None)
            idle = list(srcs)
        replies: List[Reply] = []
        for peer in sorted(idle):
            src = srcs[peer]
            req = self._next_chunk_req(peer, src.sid, partial,
                                       have=src.indices)
            if req is not None:
                replies.append(req)
        return replies

    def _on_chunk_req(self, msg: ChunkReq) -> List[Reply]:
        if msg.chunk_size <= 0 or msg.chunk_size > self._chunk_payload:
            return self._protocol_error("chunk_size")
        replies: List[Reply] = []
        if msg.eid in self.state.store:
            enc = self._encoded_blob(msg.eid)
            view = memoryview(enc)        # chunks are views, not copies
            for i in sorted(set(msg.indices)):
                start = i * msg.chunk_size
                if start >= len(enc):
                    self.stats["chunk_req_range"] += 1
                    continue
                self.stats["chunks_served"] += 1
                replies.append((msg.sender,
                                ChunkData(self.node_id, msg.sid, msg.eid, i,
                                          view[start:start
                                               + msg.chunk_size])))
            return replies
        # Partial holder: _on_have_req advertised this reassembly's
        # verified chunks, so serve them — requesters restrict windows
        # to the bitmap, and every chunk re-verifies against the
        # manifest digest on arrival. Chunking must match ours exactly
        # (indices are meaningless across different chunk sizes).
        partial = self._partials.get(msg.eid)
        if partial is None or partial.chunk_size != msg.chunk_size:
            self.stats["chunk_req_unknown"] += 1
            return []
        for i in sorted(set(msg.indices)):
            data = partial.chunks.get(i)
            if data is None:
                self.stats["chunk_req_range"] += 1
                continue
            self.stats["chunks_served"] += 1
            replies.append((msg.sender,
                            ChunkData(self.node_id, msg.sid, msg.eid, i,
                                      data)))
        return replies

    def _on_chunk_data(self, msg: ChunkData) -> List[Reply]:
        key = (msg.sender, msg.sid, msg.eid)
        pending = self._chunk_pending.get(key)
        if pending is not None:
            pending.discard(msg.index)
            self._req_time[key] = self.clock      # the window made progress
        partial = self._partials.get(msg.eid)
        if partial is None:
            # transfer already finished (or never started) — stale frame
            self.stats["chunk_orphan"] += 1
            self._drop_window(key)
            return []
        if not (0 <= msg.index < len(partial.digests)):
            self.stats["chunk_req_range"] += 1
        elif msg.index in partial.chunks:
            self.stats["chunks_redundant"] += 1
        elif hashlib.sha256(msg.data).digest() != partial.digests[msg.index]:
            self.stats["chunk_digest_mismatch"] += 1
        else:
            partial.chunks[msg.index] = msg.data
            self.stats["chunks_verified"] += 1
            self._timeouts.pop(msg.eid, None)     # fetch is progressing
        if partial.complete():
            self._finish_blob(msg.eid, partial)
            return []
        if pending is not None and not pending:
            # window drained but blob incomplete: refill every idle
            # source, not just this one (a source that joined while all
            # chunks were assigned elsewhere gets its first window here)
            self._drop_window(key)
            return self._pump_chunk_reqs(msg.eid)
        return []

    def _finish_blob(self, eid: str, partial: _PartialBlob) -> None:
        blob = partial.assemble()
        partial.chunks = {}       # the joined blob holds the bytes now
        del self._partials[eid]
        self._sources.pop(eid, None)
        self._slow.pop(eid, None)
        self._timeouts.pop(eid, None)
        for key in [k for k in self._chunk_pending if k[2] == eid]:
            self._drop_window(key)
        try:
            payload = decode_blob(blob, device=self.device)
        except WireError:
            # every chunk matched its manifest digest, so the manifest
            # itself was bogus; drop it all and refetch from scratch
            self.stats["blob_decode_error"] += 1
            return
        del blob
        if isinstance(payload, CompressedTree) and not self.keep_quantized:
            payload = decompress_tree(payload)
        if eid not in self.state.store:
            store = dict(self.state.store)
            store[eid] = payload
            self.state = CRDTMergeState(self.state.adds, self.state.removes,
                                        self.state.vv, store)
        self.stats["blobs_assembled"] += 1
        self.stats["blobs_received"] += 1

    def _drop_window(self, key: Tuple[str, int, str]) -> None:
        """Retire one outstanding chunk window's bookkeeping."""
        self._chunk_pending.pop(key, None)
        self._req_stamp.pop(key, None)
        self._req_time.pop(key, None)

    def _expire_peer(self, peer: str) -> None:
        """Drop request bookkeeping held against `peer` (superseded by a
        new session with it); verified chunks in _partials survive."""
        for key in [k for k in self._blob_inflight if k[0] == peer]:
            del self._blob_inflight[key]
            self._req_stamp.pop(key, None)
        for key in [k for k in self._chunk_pending if k[0] == peer]:
            self._drop_window(key)

    def _gc_stale_requests(self) -> None:
        """Drop request state from sessions older than the latest
        begin_sync(): by the time this node starts a new session, a prior
        session's lost BlobResp/ChunkData is never going to arrive, and
        keeping its bookkeeping would pin those eids/chunks as
        un-requestable from every OTHER peer forever (e.g. a transfer
        started from a peer that then left the network)."""
        horizon = self._sessions - 1
        for key in [k for k, s in self._req_stamp.items() if s <= horizon]:
            self._blob_inflight.pop(key, None)
            self._chunk_pending.pop(key, None)
            self._req_time.pop(key, None)
            del self._req_stamp[key]
        # Source records age out on the same horizon: a peer last
        # confirmed before the latest begin_sync may be gone, and a
        # scheduler window aimed at a dead peer would stall the fetch
        # (or, with timeouts off, pin its chunks until the next GC).
        # Live peers re-enter the pool via manifest/HaveMap for free.
        for eid in list(self._sources):
            srcs = self._sources[eid]
            for peer in [p for p, s in srcs.items() if s.gen <= horizon]:
                del srcs[peer]
            if not srcs:
                del self._sources[eid]

    def _gc_partials(self) -> None:
        """Chunk-level tombstone GC interplay (sharded-store invariant):
        a partial reassembly whose eid was retracted by a tombstone (or
        completed elsewhere) is dropped outright — late ChunkData frames
        for it count as orphans. An eid that merely left missing_blobs()
        because its want-pin was released (an interrupted fetch) only
        stops *fetching*: its verified chunks are kept so the next
        want/fetch resumes instead of re-shipping the blob."""
        if not self._partials:
            return
        fetchable = self.state.visible() - self.state.store.keys()
        active = set(self.missing_blobs())
        for eid in [e for e in self._partials if e not in active]:
            for key in [k for k in self._chunk_pending if k[2] == eid]:
                self._drop_window(key)
            self._sources.pop(eid, None)
            self._slow.pop(eid, None)
            self._timeouts.pop(eid, None)
            if eid not in fetchable:
                del self._partials[eid]
                self.stats["partials_dropped"] += 1

    # -- sharded-store discovery: who holds what ---------------------------

    def query_holders(self, eids: Optional[Iterable[str]] = None,
                      peers: Optional[Sequence[str]] = None) -> List[Reply]:
        """HaveReq frames asking who holds this node's missing blobs.

        With no explicit `peers`, targets come from the placement
        function — the deterministic holder set of each eid — so
        discovery needs no directory service. The replies (HaveMap)
        populate the multi-source pool; send the returned messages and
        pump the transport."""
        targets = tuple(eids) if eids is not None else self.missing_blobs()
        if not targets:
            return []
        self._sid += 1
        by_peer: Dict[str, List[str]] = {}
        for eid in targets:
            if peers is not None:
                holders: Iterable[str] = peers
            elif self.placement is not None:
                holders = self.placement.holders(eid)
            else:
                holders = ()
            for p in holders:
                if p != self.node_id:
                    by_peer.setdefault(p, []).append(eid)
        self.stats["have_reqs_sent"] += len(by_peer)
        return [(p, HaveReq(self.node_id, self._sid, tuple(sorted(es))))
                for p, es in sorted(by_peer.items())]

    def _on_have_req(self, msg: HaveReq) -> List[Reply]:
        """Advertise holdings: complete blobs as bare entries, partial
        reassemblies as chunk bitmaps (a partial holder can serve the
        chunks it has verified — useful before any replica is whole)."""
        entries: List[HaveEntry] = []
        for eid in sorted(set(msg.eids)):
            if eid in self.state.store:
                entries.append(HaveEntry(eid, 0))
                continue
            partial = self._partials.get(eid)
            if partial is not None and partial.chunks:
                n = len(partial.digests)
                entries.append(
                    HaveEntry(eid, n, chunk_bitmap(partial.chunks, n)))
        self.stats["have_reqs_served"] += 1
        return [(msg.sender, HaveMap(self.node_id, msg.sid, tuple(entries)))]

    def _on_have_map(self, msg: HaveMap) -> List[Reply]:
        """Fold a peer's holdings into the source pools. Complete holders
        of blobs we have no manifest for yet are sent a BlobReq (the
        manifest bootstraps chunking); everything else joins the
        multi-source scheduler directly."""
        self._gc_stale_requests()
        self._gc_partials()
        missing = set(self.missing_blobs())
        replies: List[Reply] = []
        need_manifest: List[str] = []
        for e in msg.entries:
            if e.eid not in missing:
                continue
            partial = self._partials.get(e.eid)
            if e.n_chunks == 0:
                indices: Optional[FrozenSet[int]] = None
            else:
                if partial is None or len(partial.digests) != e.n_chunks:
                    # a partial holder is only usable once we share its
                    # exact chunking; manifest digests still guard every
                    # chunk, this just avoids doomed requests
                    self.stats["have_map_unusable"] += 1
                    continue
                indices = frozenset(bitmap_indices(e.bitmap, e.n_chunks))
                if not indices:
                    continue
            srcs = self._sources.setdefault(e.eid, {})
            if srcs and msg.sender not in srcs:
                self.stats["chunk_stream_joined"] += 1
            srcs[msg.sender] = BlobSource(msg.sid, indices, self._sessions)
            self._slow.get(e.eid, set()).discard(msg.sender)
            if partial is not None:
                replies.extend(self._pump_chunk_reqs(e.eid))
            elif indices is None:
                need_manifest.append(e.eid)
        if need_manifest:
            inflight: Set[str] = set()
            for eids in self._blob_inflight.values():
                inflight |= eids
            ask = tuple(e for e in need_manifest if e not in inflight)
            if ask:
                key = (msg.sender, msg.sid)
                self._blob_inflight.setdefault(key, set()).update(ask)
                self._req_stamp[key] = self._sessions
                replies.append((msg.sender,
                                BlobReq(self.node_id, msg.sid, ask)))
        return replies

    # -- straggler recovery ------------------------------------------------

    def tick(self, now: float) -> List[Reply]:
        """Re-assign chunk windows that stalled past chunk_timeout.

        Harness-driven (simulator virtual clock or pump wall clock): a
        window with no progress since `chunk_timeout` ago marks its
        source slow and its chunks return to the pool, so the remaining
        sources pick them up — a straggling or partitioned peer delays
        a transfer by one timeout, not forever. After max_fetch_timeouts
        consecutive barren timeouts the fetch attempt is abandoned (the
        partial's verified chunks survive for the next session)."""
        if self.chunk_timeout is None or not self._chunk_pending:
            return []
        self.clock = max(self.clock, now)
        expired = sorted(k for k, t in self._req_time.items()
                         if k in self._chunk_pending
                         and now - t >= self.chunk_timeout)
        touched: Set[str] = set()
        for key in expired:
            peer, _sid, eid = key
            self._drop_window(key)
            self._slow.setdefault(eid, set()).add(peer)
            self._timeouts[eid] += 1
            self.stats["chunk_timeouts"] += 1
            touched.add(eid)
        replies: List[Reply] = []
        for eid in sorted(touched):
            if self._timeouts[eid] >= self.max_fetch_timeouts:
                # nobody is delivering: stop re-requesting so the event
                # loop can quiesce; the next anti-entropy session resumes
                # the partial from its verified chunks
                self._sources.pop(eid, None)
                self._slow.pop(eid, None)
                self._timeouts.pop(eid, None)
                self.stats["chunk_fetch_abandoned"] += 1
                continue
            replies.extend(self._pump_chunk_reqs(eid))
        return replies

    def _maybe_blob_req(self, peer: str, sid: int) -> List[Reply]:
        # Skip eids with a response pending in any live session or an
        # active chunk stream (concurrent sessions in one gossip round
        # would otherwise fetch every blob fanout-times over). Partially
        #-transferred blobs with no live stream ARE requested again: the
        # peer's manifest resumes them from the verified chunks held.
        self._gc_stale_requests()
        inflight: Set[str] = set()
        for eids in self._blob_inflight.values():
            inflight |= eids
        streaming = {k[2] for k in self._chunk_pending}
        missing = self.missing_blobs()
        replies: List[Reply] = []
        # Blobs mid-stream are not re-requested wholesale, but this peer
        # may hold them too: probe with a HaveReq so it can join the
        # multi-source pool for the in-progress transfers.
        probe = tuple(e for e in missing
                      if e in streaming
                      and peer not in self._sources.get(e, {}))
        if probe:
            self.stats["have_reqs_sent"] += 1
            replies.append((peer, HaveReq(self.node_id, sid, probe)))
        want = tuple(e for e in missing
                     if e not in inflight and e not in streaming)
        if want:
            key = (peer, sid)
            self._blob_inflight.setdefault(key, set()).update(want)
            self._req_stamp[key] = self._sessions
            replies.append((peer, BlobReq(self.node_id, sid, want)))
        return replies
