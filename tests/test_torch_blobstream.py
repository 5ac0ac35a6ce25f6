"""Streaming chunked blob transfer on the port (`repro_torch.net`) against
the reference: the scenarios of tests/test_net_blobstream.py on both
packages from the same numpy inputs (tests/_net_twins.py).

Bitwise across the packages: every frame sent, in order (sender,
destination, encoded bytes) — or, on the simulator, every frame
delivered with its virtual time — roots, `sync_events_total`, and the
payload bytes every store ends with. The reference's invariants hold on
the port's nodes: no frame above the frame budget, a killed session
resumes without re-shipping a verified chunk, concurrent sessions fetch
each blob once, chunked transfer converges under loss, reordering,
duplication and a partition, windowing bounds bytes in flight, and
`PersistentLoopbackTransport` reuses one connection per directed pair.
"""
import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _net_twins as T  # noqa: E402
from _net_twins import PORT, REF  # noqa: E402

torch.set_num_threads(1)

MAX_FRAME = 2048          # tiny budget => many chunks from small payloads


def _node(pkg, name, **kw):
    kw.setdefault("max_frame_bytes", MAX_FRAME)
    kw.setdefault("chunk_window", 3)
    return pkg.SyncNode(name, **kw)


def _result(log, *nodes, **extra):
    out = {"trace": list(log),
           "roots": [n.root() for n in nodes],
           "stats": [T.stats(n) for n in nodes],
           "stores": [{e: T.tree_bytes(p)
                       for e, p in sorted(n.state.store.items())}
                      for n in nodes],
           "nodes": nodes}
    out.update(extra)
    return out


def _check(p, r, *extra):
    T.same(p, r, "trace", "roots", "stats", "stores", *extra)


# ------------------------------------------------------------ blob codec


def test_blob_roundtrip_and_chunk_digests():
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    blob = PORT.wire.encode_blob({"w": PORT.tensor(a)})
    assert blob == REF.wire.encode_blob({"w": REF.tensor(a)})
    out = PORT.wire.decode_blob(blob, device="cpu")
    assert T.nbytes(out["w"]) == a.tobytes()
    digests = PORT.wire.chunk_digests(blob, 1000)
    assert digests == REF.wire.chunk_digests(blob, 1000)
    assert len(digests) == (len(blob) + 999) // 1000
    assert digests[0] == hashlib.sha256(blob[:1000]).digest()
    entry = PORT.wire.manifest_entry("e" * 64, blob, 1000)
    assert PORT.wire.encode_message(PORT.wire.BlobManifest(
        "a", 1, (entry,))) == REF.wire.encode_message(REF.wire.BlobManifest(
            "a", 1, (REF.wire.manifest_entry("e" * 64, blob, 1000),)))
    assert entry.total_size == len(blob) and entry.n_chunks == len(digests)


# --------------------------------------------------------- chunked sync


def _bounded(pkg, shapes, **kw):
    rng = np.random.default_rng(kw.pop("seed", 1))
    a, b = _node(pkg, "a", **kw), _node(pkg, "b", **kw)
    for s in shapes:
        a.contribute(T.payload(pkg, rng, s))
    t = T.sync(pkg, b, a)
    return _result(t.log, a, b, frame=t.max_frame_seen,
                   types=dict(t.bytes_by_type),
                   missing=b.missing_blobs(),
                   clean=not b._partials and not b._chunk_pending)


@pytest.mark.parametrize("shapes,seed", [
    ([(64, 64)], 1),                        # one blob, many chunks
    ([(4, 4)] * 3, 2),                      # small ones batched
    ([(8, 8)] * 12, 3),                     # BlobResp split at the budget
    ([(64, 64), (4, 4)], 4),                # both in one session
])
def test_blobs_stream_in_bounded_frames(shapes, seed):
    p, r = T.run(_bounded, shapes, seed=seed)
    _check(p, r, "frame", "types", "missing", "clean")
    a, b = p["nodes"]
    assert b.root() == a.root() and not p["missing"] and p["clean"]
    assert p["frame"] <= MAX_FRAME
    big = sum(1 for s in shapes if s == (64, 64))
    assert a.stats["blobs_announced"] == big
    assert a.stats["blobs_served"] == len(shapes) - big
    if big:
        assert a.stats["chunks_served"] == b.stats["chunks_verified"] > 4
        assert b.stats["blobs_assembled"] == 1
    else:
        assert "ChunkData" not in p["types"]


def test_compressed_chunked_blob_reconstructs_deterministically():
    p, r = T.run(_bounded, [(80, 80)], seed=5, compress_blobs=True)
    _check(p, r, "frame")
    a, b = p["nodes"]
    eid = next(iter(a.state.visible()))
    expect = PORT.decompress_tree(PORT.compress_tree(a.state.store[eid]))
    assert T.tree_bytes(expect) == T.tree_bytes(b.state.store[eid])


# ------------------------------------------------------- resume semantics


def _partial_pump(nodes, transport, deliveries):
    """Deliver at most `deliveries` messages, then stop (dead session).
    Returns the messages in flight when the session died."""
    done = 0
    dead = False
    lost = []
    while not dead:
        progressed = False
        for node_id, node in nodes.items():
            batch = transport.recv_ready(node_id)
            for _src, msg in batch:
                if dead:
                    lost.append(msg)
                    continue
                progressed = True
                for dst, reply in node.handle(msg):
                    transport.send(node_id, dst, reply)
                done += 1
                dead = done >= deliveries
        if not progressed and not dead:
            return lost
    for node_id in nodes:
        lost.extend(m for _s, m in transport.recv_ready(node_id))
    return lost


def _killed(pkg, peer_change):
    rng = np.random.default_rng(6 if not peer_change else 7)
    a, b, c = _node(pkg, "a"), _node(pkg, "b"), _node(pkg, "c")
    a.contribute(T.payload(pkg, rng, (64, 64)))
    c.state = c.state.merge(a.state)
    t1 = T.traced(pkg, pkg.InMemoryTransport())
    t1.register("a")
    t1.register("b")
    t1.send("b", "a", b.begin_sync("a"))
    in_flight = _partial_pump({"a": a, "b": b}, t1, deliveries=8)
    verified = b.stats["chunks_verified"]
    eid = next(iter(a.state.visible()))
    n_chunks = len(pkg.wire.chunk_digests(
        pkg.wire.encode_blob(a.state.store[eid]), b._chunk_payload))
    lost = sum(isinstance(m, pkg.wire.ChunkData) for m in in_flight)
    was_missing = bool(b.missing_blobs())
    t2 = T.sync(pkg, b, c if peer_change else a)
    return _result(t1.log + t2.log, a, b, c, verified=verified,
                   n_chunks=n_chunks, lost=lost, was_missing=was_missing)


@pytest.mark.parametrize("peer_change", [False, True])
def test_killed_session_resumes_without_reshipping(peer_change):
    """A session dies mid-stream; a new one — with the same peer, or
    with another holding the identical chunking — completes the blob
    without shipping a verified chunk twice."""
    p, r = T.run(_killed, peer_change)
    _check(p, r, "verified", "n_chunks", "lost", "was_missing")
    a, b, c = p["nodes"]
    assert 0 < p["verified"] < p["n_chunks"] and p["was_missing"]
    assert not b.missing_blobs()
    assert b.stats["chunks_redundant"] == 0
    assert a.stats["chunks_served"] + c.stats["chunks_served"] == \
        b.stats["chunks_verified"] + p["lost"]


# ------------------------------------------- concurrent-session regression


def _concurrent(pkg):
    rng = np.random.default_rng(8)
    peers = [pkg.SyncNode(f"p{i}") for i in range(3)]
    payloads = [T.payload(pkg, rng) for _ in range(4)]
    for p in peers:
        for pl in payloads:
            p.contribute(pl)
    for p in peers[1:]:
        p.state = peers[0].state
    z = pkg.SyncNode("z")
    z.state = T.metadata_only(pkg, peers[0].state)
    missing = z.missing_blobs()
    t = T.traced(pkg, pkg.InMemoryTransport())
    for n in [z] + peers:
        t.register(n.node_id)
    for p in peers:
        t.send("z", p.node_id, z.begin_sync(p.node_id))
    pkg.pump({n.node_id: n for n in [z] + peers}, t)
    return _result(t.log, z, *peers, missing=len(missing),
                   served=sum(p.stats["blobs_served"] for p in peers))


def test_concurrent_sessions_fetch_each_blob_exactly_once():
    p, r = T.run(_concurrent)
    _check(p, r, "missing", "served")
    assert p["missing"] == 4 == p["served"]
    assert not p["nodes"][0].missing_blobs()


def _own_session(pkg):
    rng = np.random.default_rng(9)
    p1, p2 = T.payload(pkg, rng), T.payload(pkg, rng)
    x, y, w = pkg.SyncNode("x"), pkg.SyncNode("y"), pkg.SyncNode("w")
    x.contribute(p1)
    x.contribute(p2)
    y.state = x.state
    w.state = x.state
    e1, e2 = sorted(x.state.visible())
    z = pkg.SyncNode("z")
    z.state = pkg.apply_delta(z.state, pkg.delta_for_entries(
        x.state, {a for a in x.state.adds if a.element_id == e1},
        frozenset()))
    [(_, req_x)] = z._maybe_blob_req("x", 101)
    z.state = pkg.apply_delta(z.state, pkg.delta_for_entries(
        x.state, {a for a in x.state.adds if a.element_id == e2},
        frozenset()))
    [(_, req_y)] = z._maybe_blob_req("y", 202)
    [(_, resp_x)] = x.handle(req_x)
    z.handle(resp_x)
    third = z._maybe_blob_req("w", 303)
    [(_, resp_y)] = y.handle(req_y)
    z.handle(resp_y)
    enc = pkg.wire.encode_message
    return _result([enc(m) for m in (req_x, req_y, resp_x, resp_y)],
                   x, y, w, z, e=(e1, e2), reqs=(set(req_x.eids),
                                                 set(req_y.eids)),
                   third=third)


def test_blob_resp_clears_only_its_own_session():
    p, r = T.run(_own_session)
    _check(p, r, "e", "reqs", "third")
    e1, e2 = p["e"]
    assert p["reqs"] == ({e1}, {e2}) and p["third"] == []
    x, y, w, z = p["nodes"]
    assert not z.missing_blobs()
    assert sum(n.stats["blobs_served"] for n in (x, y, w)) == 2


def _multi_frame(pkg):
    rng = np.random.default_rng(21)
    x = _node(pkg, "x")
    for _ in range(12):
        x.contribute(T.payload(pkg, rng, (8, 8)))
    z = _node(pkg, "z")
    z.state = pkg.apply_delta(z.state, pkg.delta_for_entries(
        x.state, x.state.adds, frozenset()))
    missing = z.missing_blobs()
    [(_, req)] = z._maybe_blob_req("x", 1)
    frames = [m for _, m in x.handle(req)]
    z.handle(frames[0])
    still = set(missing) - set(frames[0].payloads)
    again = z._maybe_blob_req("w", 2)
    for m in frames[1:]:
        z.handle(m)
    enc = pkg.wire.encode_message
    return _result([enc(m) for m in [req] + frames], x, z,
                   n_frames=len(frames), still=bool(still), again=again)


def test_multi_frame_blob_resp_retires_eids_incrementally():
    p, r = T.run(_multi_frame)
    _check(p, r, "n_frames", "still", "again")
    assert p["n_frames"] > 1 and p["still"] and p["again"] == []
    x, z = p["nodes"]
    assert not z.missing_blobs() and x.stats["blobs_served"] == 12


def _oversized(pkg):
    rng = np.random.default_rng(22)
    a = pkg.SyncNode("a", max_frame_bytes=8192)
    a.contribute(T.payload(pkg, rng, (100, 100)))
    b = _node(pkg, "b")
    t = T.sync(pkg, b, a)
    rejected = (b.stats["manifest_oversize"], bool(b.missing_blobs()),
                bool(b._partials))
    c = _node(pkg, "c")
    c.state = c.state.merge(a.state)
    T.sync(pkg, b, c, t)
    return _result(t.log, a, b, c, rejected=rejected)


def test_oversized_manifest_chunking_rejected():
    p, r = T.run(_oversized)
    _check(p, r, "rejected")
    assert p["rejected"][0] >= 1 and p["rejected"][1:] == (True, False)
    assert not p["nodes"][1].missing_blobs()


def _unpin(pkg):
    rng = np.random.default_rng(10)
    a, z = pkg.SyncNode("a"), pkg.SyncNode("z")
    a.contribute(T.payload(pkg, rng))
    z.state = pkg.apply_delta(z.state, pkg.delta_for_entries(
        a.state, a.state.adds, frozenset()))
    first = z._maybe_blob_req("a", 1)
    pinned = z._maybe_blob_req("b", 2)
    z.begin_sync("a")
    again = z._maybe_blob_req("a", z._sid)
    enc = pkg.wire.encode_message
    return _result([enc(m) for _, m in first + again], a, z,
                   pinned=pinned)


def test_new_session_with_peer_unpins_lost_requests():
    p, r = T.run(_unpin)
    _check(p, r, "pinned")
    assert p["pinned"] == [] and len(p["trace"]) == 2


# --------------------------------------------------- adversarial networks


def _sim(pkg, n, seed, shape=(64, 64), **kw):
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(
        n, seed=seed, mode="antientropy", max_frame_bytes=MAX_FRAME,
        chunk_window=3, **kw))
    g.nodes[0].contribute(T.payload(pkg, np.random.default_rng(seed),
                                    shape))
    return g


def _sim_result(g, **extra):
    return _result(g.net.log, *g.nodes, frame=g.net.max_frame_seen,
                   dropped=g.net.msgs_dropped,
                   duplicated=g.net.msgs_duplicated,
                   peak=g.net.peak_inflight_bytes, **extra)


def _lossy(pkg):
    g = _sim(pkg, 3, 13, link=pkg.LinkSpec(loss=0.15, reorder=0.3,
                                           jitter=0.002))
    rounds = g.run_epidemic(fanout=2, max_rounds=60, require_blobs=True)
    return _sim_result(g, rounds=rounds,
                       converged=g.converged(require_blobs=True))


def test_chunked_transfer_under_loss_and_reorder():
    p, r = T.run(_lossy)
    _check(p, r, "rounds", "converged", "frame", "dropped")
    assert p["converged"] and p["frame"] <= MAX_FRAME
    assert len(set(map(str, p["stores"]))) == 1


def _partition(pkg):
    g = _sim(pkg, 2, 14)
    ids = [x.node_id for x in g.nodes]
    g.net.send(ids[1], ids[0], g.nodes[1].begin_sync(ids[0]))
    for _ in range(6):
        g.net.step()
    g.net.partition([{ids[0]}, {ids[1]}])
    g.net.run()
    cut = (bool(g.nodes[1].missing_blobs()),
           g.nodes[1].stats["chunks_verified"])
    g.net.heal()
    g.run_epidemic(fanout=1, max_rounds=10, require_blobs=True)
    return _sim_result(g, cut=cut,
                       converged=g.converged(require_blobs=True))


def test_chunked_transfer_survives_partition_mid_transfer():
    p, r = T.run(_partition)
    _check(p, r, "cut", "converged")
    n1 = p["nodes"][1]
    assert p["cut"][0] and p["converged"]
    assert n1.stats["chunks_redundant"] == 0
    assert n1.stats["chunks_verified"] > p["cut"][1]


def _duplicated(pkg):
    g = _sim(pkg, 2, 15, link=pkg.LinkSpec(duplicate=0.5))
    g.run_epidemic(fanout=1, max_rounds=10, require_blobs=True)
    return _sim_result(g, converged=g.converged(require_blobs=True))


def test_duplicated_chunk_frames_are_idempotent():
    p, r = T.run(_duplicated)
    _check(p, r, "converged", "duplicated")
    n1 = p["nodes"][1]
    assert p["converged"] and p["duplicated"] > 0
    assert n1.stats["blobs_assembled"] == 1
    assert n1.stats["chunks_redundant"] + n1.stats["chunk_orphan"] > 0


def _windowed(pkg):
    g = _sim(pkg, 2, 16, link=pkg.LinkSpec(bandwidth=50_000.0))
    g.run_epidemic(fanout=1, max_rounds=6, require_blobs=True)
    return _sim_result(g, converged=g.converged(require_blobs=True))


def test_windowing_bounds_inflight_bytes():
    p, r = T.run(_windowed)
    _check(p, r, "converged", "peak")
    assert p["converged"] and p["peak"] <= MAX_FRAME * (3 + 4)


# ------------------------------------------------- persistent connections


def _persistent(pkg):
    rng = np.random.default_rng(17)
    t = T.traced(pkg, pkg.PersistentLoopbackTransport())
    try:
        a, b = _node(pkg, "a"), _node(pkg, "b")
        a.contribute(T.payload(pkg, rng, (64, 64)))
        a.contribute(T.payload(pkg, rng, (4, 4)))
        T.sync(pkg, b, a, t, max_steps=20_000)
    finally:
        t.close()
    return _result(t.log, a, b, frame=t.max_frame_seen, sent=t.msgs_sent,
                   conns=t.connections_opened)


def test_persistent_transport_reuses_connections():
    p, r = T.run(_persistent)
    _check(p, r, "frame", "sent", "conns")
    a, b = p["nodes"]
    assert not b.missing_blobs() and b.root() == a.root()
    assert p["frame"] <= MAX_FRAME and p["sent"] > 10
    assert p["conns"] <= 2


def _gossip_persistent(pkg):
    rng = np.random.default_rng(18)
    t = pkg.PersistentLoopbackTransport()
    try:
        net = pkg.GossipNetwork(3, seed=19, transport=t)
        for node in net.nodes:
            node.contribute(T.payload(pkg, rng, (8, 8)))
        roots = []
        for _ in range(2):
            net.all_pairs_round()
            roots.append(net.roots())
    finally:
        t.close()
    return {"roots": roots, "conns": t.connections_opened,
            "bytes": net.bytes_sent, "converged": net.converged()}


def test_gossip_network_over_persistent_transport():
    p, r = T.run(_gossip_persistent)
    T.same(p, r, "roots", "bytes", "converged")
    assert p["converged"] and p["conns"] <= 6


def _interleaved(pkg):
    t = T.traced(pkg, pkg.PersistentLoopbackTransport())
    try:
        nodes = {n: _node(pkg, n) for n in ("a", "b", "c")}
        rng = np.random.default_rng(20)
        for n in nodes.values():
            n.contribute(T.payload(pkg, rng, (16, 16)))
            t.register(n.node_id)
        for src in ("b", "c"):
            t.send(src, "a", nodes[src].begin_sync("a"))
        pkg.pump(nodes, t, max_steps=20_000)
    finally:
        t.close()
    return _result([], *nodes.values(), frames=sorted(t.log))


def test_persistent_transport_interleaved_senders():
    """Arrival order across two connections is up to the kernel: the
    frames compare as a multiset, the end state exactly."""
    p, r = T.run(_interleaved)
    T.same(p, r, "frames", "roots")
    assert len(set(p["roots"])) <= 2
    assert not p["nodes"][0].missing_blobs()
