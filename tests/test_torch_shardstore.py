"""The port's sharded store (`repro_torch.net.store`, placement-aware
`SyncNode`, fetch-on-resolve) against the reference: the scenarios of
tests/test_net_shardstore.py on both packages from the same numpy
inputs (tests/_net_twins.py), plus the warm re-resolve after
`shed_blobs` and `engine.note_meta` fed by a SparseManifest.

Bitwise across the packages: the frames sent (or delivered on the
simulator, with their virtual times), roots, `sync_events_total`, the
payload bytes every store ends with, and resolves of weight_average.
The reference's invariants hold on the port's nodes: multi-source fetch
streams disjoint chunk windows with zero duplicates on clean links and
completes under loss, duplication and a mid-fetch partition; a partial
reassembly of a retracted eid is dropped; a replica without payloads
resolves byte-identically by fetching them, and a warm re-resolve after
`shed_blobs` pulls nothing; placement-aware gossip ships payloads only
to their holders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _net_twins as T  # noqa: E402
from _net_twins import PORT, REF  # noqa: E402

from repro_torch.core import engine  # noqa: E402

torch.set_num_threads(1)

MAX_FRAME = 2048


@pytest.fixture(autouse=True)
def _clear_caches():
    yield
    PORT.clear_cache()
    REF.clear_cache()


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


def _n_chunks(pkg, payload):
    return -(-len(pkg.wire.encode_blob(payload))
             // (MAX_FRAME - pkg.wire.CHUNK_ENVELOPE))


# ------------------------------------------------------------- placement


def test_rendezvous_placement_balanced_and_minimally_disrupted():
    nodes = [f"n{i}" for i in range(6)]
    p, q = PORT.Placement(nodes, r=2), REF.Placement(nodes, r=2)
    counts = {n: 0 for n in nodes}
    for i in range(300):
        eid = f"{i:064x}"
        assert p.holders(eid) == q.holders(eid)
        for h in p.holders(eid):
            counts[h] += 1
    assert all(40 <= c <= 180 for c in counts.values()), counts
    p5 = PORT.Placement(nodes[:5], r=2)
    p4 = p5.without("n3")
    for i in range(200):
        eid = f"{i:064x}"
        before, after = p5.holders(eid), p4.holders(eid)
        if "n3" in before:
            assert set(before) - {"n3"} <= set(after)
        else:
            assert before == after


# ------------------------------------------------------ multi-source fetch


def _shard_net(pkg, n_sources, seed, *, shape=(64, 64), link=None,
               chunk_timeout=None, window=3):
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(
        n_sources + 1, seed=seed, mode="antientropy",
        max_frame_bytes=MAX_FRAME, chunk_window=window, link=link,
        chunk_timeout=chunk_timeout))
    storage = [g.nodes[i].node_id for i in range(n_sources)]
    g.placement = pkg.Placement(storage, r=n_sources)
    for node in g.nodes:
        node.placement = g.placement
    g.nodes[0].contribute(T.payload(pkg, np.random.default_rng(seed),
                                    shape))
    g.seed_placement()
    eid = next(iter(g.nodes[0].state.visible()))
    return g, eid


def _fetch(pkg, n_sources, seed, **kw):
    g, eid = _shard_net(pkg, n_sources, seed, **kw)
    req = g.nodes[n_sources]
    responsible = req.missing_blobs()
    got = g.fetch_blobs(req, [eid])
    return _result(g.net.log, *g.nodes, got=got, eid=eid,
                   responsible=responsible,
                   n_chunks=_n_chunks(pkg, g.nodes[0].state.store[eid]),
                   dup=g.net.msgs_duplicated,
                   clean=not (req._partials or req._chunk_pending
                              or req._sources))


@pytest.mark.parametrize("case", ["clean", "loss", "duplicate"])
def test_multi_source_fetch(case):
    kw = {"clean": dict(seed=21),
          "loss": dict(seed=22, chunk_timeout=0.05),
          "duplicate": dict(seed=23)}[case]
    if case != "clean":
        kw["link"] = {"loss": lambda pkg: pkg.LinkSpec(loss=0.15,
                                                       jitter=0.002),
                      "duplicate": lambda pkg: pkg.LinkSpec(
                          duplicate=0.4)}[case]
    res = []
    for pkg in (PORT, REF):
        k = dict(kw)
        if "link" in k:
            k["link"] = k["link"](pkg)
        res.append(_fetch(pkg, 3, **k))
    p, r = res
    _check(p, r, "got", "responsible", "n_chunks", "dup", "clean")
    nodes = p["nodes"]
    req = nodes[3]
    assert p["got"] == [p["eid"]] and p["responsible"] == ()
    assert T.tree_bytes(req.state.store[p["eid"]]) == \
        T.tree_bytes(nodes[0].state.store[p["eid"]])
    assert p["clean"]
    served = [nodes[i].stats["chunks_served"] for i in range(3)]
    if case == "clean":
        assert sum(served) == p["n_chunks"] == req.stats["chunks_verified"]
        assert req.stats["chunks_redundant"] == 0
        assert sum(1 for s in served if s) >= 2
    elif case == "loss":
        assert req.stats["chunk_timeouts"] > 0
    else:
        assert p["dup"] > 0 and req.stats["blobs_assembled"] == 1


def _mid_fetch_partition(pkg, heal_retry):
    g, eid = _shard_net(pkg, 2, 24 if not heal_retry else 33,
                        shape=(90, 90), chunk_timeout=0.05)
    req = g.nodes[2]
    ids = [x.node_id for x in g.nodes]
    req.want_blobs([eid])
    for peer, msg in req.query_holders([eid]):
        g.net.send(req.node_id, peer, msg)
    for _ in range(10 if not heal_retry else 12):
        g.net.step()
    if not heal_retry:
        g.net.partition([{ids[0]}, {ids[1], ids[2]}])
        g.net.run()
        return _result(g.net.log, *g.nodes, eid=eid,
                       done=eid in req.state.store)
    g.net.partition([{ids[0], ids[1]}, {ids[2]}])
    g.net.run()
    req.unwant_blobs([eid])
    verified = len(req._partials[eid].chunks)
    idle = not req._chunk_pending and not req._sources
    before = sum(g.nodes[i].stats["chunks_served"] for i in range(2))
    g.net.heal()
    got = g.fetch_blobs(req, [eid])
    after = sum(g.nodes[i].stats["chunks_served"] for i in range(2))
    return _result(g.net.log, *g.nodes, eid=eid, got=got,
                   verified=verified, idle=idle, shipped=after - before,
                   n_chunks=_n_chunks(pkg, g.nodes[0].state.store[eid]))


def test_mid_fetch_partition_reassigns_to_live_sources():
    p, r = T.run(_mid_fetch_partition, False)
    _check(p, r, "done")
    req = p["nodes"][2]
    assert p["done"] and req.stats["chunk_timeouts"] > 0
    assert p["nodes"][1].stats["chunks_served"] > 0


def test_interrupted_fetch_keeps_verified_chunks_for_retry():
    p, r = T.run(_mid_fetch_partition, True)
    _check(p, r, "got", "verified", "idle", "shipped")
    req = p["nodes"][2]
    assert p["verified"] > 0 and p["idle"] and p["got"] == [p["eid"]]
    assert req.stats["chunks_redundant"] == 0
    assert p["shipped"] <= p["n_chunks"] - p["verified"] + 2


def _joins_stream(pkg):
    rng = np.random.default_rng(25)
    a, b, z = (pkg.SyncNode(n, max_frame_bytes=MAX_FRAME, chunk_window=2)
               for n in "abz")
    a.contribute(T.payload(pkg, rng, (64, 64)))
    b.state = b.state.merge(a.state)
    z.state = T.metadata_only(pkg, a.state)
    t = T.traced(pkg, pkg.InMemoryTransport())
    for n in (a, b, z):
        t.register(n.node_id)
    t.send("z", "a", z.begin_sync("a"))
    for _ in range(3):
        for node_id, node in (("a", a), ("z", z)):
            for _src, msg in t.recv_ready(node_id):
                for dst, reply in node.handle(msg):
                    t.send(node_id, dst, reply)
    midway = bool(z._chunk_pending and z.missing_blobs())
    t.send("z", "b", z.begin_sync("b"))
    pkg.pump({"a": a, "b": b, "z": z}, t)
    return _result(t.log, a, b, z, midway=midway)


def test_session_peer_joins_inflight_stream():
    p, r = T.run(_joins_stream)
    _check(p, r, "midway")
    a, b, z = p["nodes"]
    assert p["midway"] and not z.missing_blobs()
    assert z.stats["chunks_redundant"] == 0
    assert b.stats["have_reqs_served"] >= 1 and b.stats["chunks_served"] > 0
    assert a.stats["chunks_served"] + b.stats["chunks_served"] == \
        z.stats["chunks_verified"]


# ---------------------------------------- tombstone GC interplay (partials)


def _retract_partial(pkg):
    rng = np.random.default_rng(26)
    a = pkg.SyncNode("a", max_frame_bytes=MAX_FRAME, chunk_window=2)
    z = pkg.SyncNode("z", max_frame_bytes=MAX_FRAME, chunk_window=2)
    a.contribute(T.payload(pkg, rng, (64, 64)))
    eid = next(iter(a.state.visible()))
    z.state = T.metadata_only(pkg, a.state)
    t = T.traced(pkg, pkg.InMemoryTransport())
    t.register("a")
    t.register("z")
    t.send("z", "a", z.begin_sync("a"))
    for _ in range(3):
        for node_id, node in (("a", a), ("z", z)):
            for _src, msg in t.recv_ready(node_id):
                for dst, reply in node.handle(msg):
                    t.send(node_id, dst, reply)
    partial = eid in z._partials and bool(z._partials[eid].chunks)
    late = [m for _s, m in t.recv_ready("z")
            if isinstance(m, pkg.wire.ChunkData)]
    a.retract(eid)
    z.state = pkg.apply_delta(z.state, pkg.delta_for_entries(
        a.state, frozenset(), a.state.removes))
    z._gc_partials()
    dropped = (eid not in z._partials, not z._chunk_pending,
               not z._sources, z.missing_blobs())
    orphan = [z.handle(m) for m in late]
    return _result(t.log, a, z, partial=partial, dropped=dropped,
                   late=len(late), orphan=orphan)


def test_retraction_drops_partial_reassembly():
    p, r = T.run(_retract_partial)
    _check(p, r, "partial", "dropped", "late", "orphan")
    a, z = p["nodes"]
    assert p["partial"] and p["dropped"] == (True, True, True, ())
    assert z.stats["partials_dropped"] == 1
    assert z.stats["chunk_orphan"] == p["late"] and \
        all(o == [] for o in p["orphan"])


def _retract_session(pkg):
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(
        2, seed=27, mode="antientropy", max_frame_bytes=MAX_FRAME,
        chunk_window=2))
    g.nodes[0].contribute(T.payload(pkg, np.random.default_rng(27),
                                    (64, 64)))
    eid = next(iter(g.nodes[0].state.visible()))
    ids = [x.node_id for x in g.nodes]
    g.net.send(ids[1], ids[0], g.nodes[1].begin_sync(ids[0]))
    for _ in range(6):
        g.net.step()
    g.nodes[0].retract(eid)
    g.run_epidemic(fanout=1, max_rounds=6, require_blobs=True)
    return _result(g.net.log, *g.nodes,
                   converged=g.converged(require_blobs=True),
                   gone=eid not in g.nodes[1]._partials)


def test_retraction_mid_transfer_via_sync_session():
    p, r = T.run(_retract_session)
    _check(p, r, "converged", "gone")
    assert p["converged"] and p["gone"]
    assert not p["nodes"][1].missing_blobs()


# --------------------------------------------------- fetch-on-resolve


def _fetch_on_resolve(pkg, use_cache):
    n_storage = 3
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(
        n_storage + 1, seed=28, mode="antientropy",
        max_frame_bytes=MAX_FRAME, chunk_window=3))
    storage = [g.nodes[i].node_id for i in range(n_storage)]
    g.placement = pkg.Placement(storage, r=2)
    for node in g.nodes:
        node.placement = g.placement
    rng = np.random.default_rng(28)
    for i in range(n_storage):
        g.nodes[i].contribute(T.payload(pkg, rng, (16, 16)))
    g.seed_placement()
    g.install_fetch_hooks()
    client = g.nodes[n_storage]
    empty = not client.state.store
    spec = pkg.MergeSpec("weight_average")
    with pytest.raises(KeyError):
        pkg.resolve_spec(client.state, spec, use_cache=False)
    out = client.resolve(spec, use_cache=use_cache)
    full = g.nodes[0].state
    for i in range(1, n_storage):
        full = full.merge(g.nodes[i].state)
    want = pkg.resolve_spec(full, spec, use_cache=False)
    pulls = client.stats["resolve_blob_pulls"]
    resident = len(client.state.store)
    shed = client.shed_blobs()
    emptied = not client.state.store
    frames = len(g.net.log)
    again = client.resolve(spec, use_cache=use_cache)
    return _result(g.net.log, *g.nodes, empty=empty, pulls=pulls,
                   resident=resident, shed=shed, emptied=emptied,
                   out=T.nbytes(out["w"]),
                   want=T.nbytes(want["w"]),
                   again=T.nbytes(again["w"]),
                   pulls_after=client.stats["resolve_blob_pulls"],
                   new_frames=len(g.net.log) - frames)


@pytest.mark.parametrize("use_cache", [False, True])
def test_fetch_on_resolve_pulls_missing_payloads(use_cache):
    """A client outside the storage domain resolves by pulling every
    payload; after `shed_blobs` a warm re-resolve pulls nothing and
    ships no frame, where a cold one pulls them all again."""
    p, r = T.run(_fetch_on_resolve, use_cache)
    _check(p, r, "empty", "pulls", "resident", "shed", "emptied", "out",
           "want", "again", "pulls_after", "new_frames")
    assert p["empty"] and p["pulls"] == 3 == p["resident"]
    assert p["out"] == p["want"] == p["again"]
    assert len(p["shed"]) == 3 and p["emptied"]
    if use_cache:
        assert p["pulls_after"] == 3 and p["new_frames"] == 0
    else:
        assert p["pulls_after"] == 6 and p["new_frames"] > 0


def _shed(pkg):
    nodes = ["a", "b", "c"]
    pl = pkg.Placement(nodes, r=1)
    rng = np.random.default_rng(29)
    a = pkg.SyncNode("a", placement=pl)
    for _ in range(6):
        a.contribute(T.payload(pkg, rng))
    eids = sorted(a.state.visible())
    pinned = next(e for e in eids if not pl.is_holder("a", e))
    a.want_blobs([pinned])
    dropped = a.shed_blobs()
    resident = sorted(a.state.store)
    missing = a.missing_blobs()
    a.unwant_blobs([pinned])
    again = a.shed_blobs()
    return _result([], a, eids=eids, pinned=pinned, dropped=dropped,
                   resident=resident, missing=missing, again=again)


def test_shed_blobs_respects_placement_and_pins():
    p, r = T.run(_shed)
    _check(p, r, "eids", "pinned", "dropped", "resident", "missing",
           "again")
    pl = PORT.Placement(["a", "b", "c"], r=1)
    assert p["pinned"] not in p["dropped"] and p["missing"] == ()
    assert p["resident"] == sorted(
        e for e in p["eids"] if pl.is_holder("a", e) or e == p["pinned"])
    assert p["pinned"] in p["again"]


def _sharded_epidemic(pkg):
    g = T.traced_sim(pkg, pkg.SimGossipNetwork(
        5, seed=30, mode="antientropy", max_frame_bytes=MAX_FRAME,
        chunk_window=3, replication=2))
    rng = np.random.default_rng(30)
    for i in range(3):
        g.nodes[i].contribute(T.payload(pkg, rng, (16, 16)))
    rounds = g.run_epidemic(fanout=2, max_rounds=30, require_blobs=True)
    return _result(g.net.log, *g.nodes, rounds=rounds,
                   converged=g.converged(require_blobs=True), g=g)


def test_sharded_antientropy_converges_to_placed_residency():
    p, r = T.run(_sharded_epidemic)
    _check(p, r, "rounds", "converged")
    g = p["g"]
    assert p["converged"]
    for eid in g.nodes[0].state.visible():
        for h in g.placement.holders(eid):
            assert eid in g.by_id[h].state.store


# --------------------------------------------- placement-aware gossip


def _gossip_placement(pkg):
    p = pkg.Placement([f"node{i:03d}" for i in range(4)], r=2)
    net = pkg.GossipNetwork(4, seed=31, placement=p)
    rng = np.random.default_rng(31)
    for node in net.nodes:
        node.contribute(T.payload(pkg, rng, (8, 8)))
    roots = []
    for _ in range(3):
        net.all_pairs_round()
        roots.append(net.roots())
    return {"roots": roots, "converged": net.converged(), "net": net,
            "stores": [sorted(n.state.store) for n in net.nodes],
            "shipped": net.obs.counter(
                "gossip_payloads_shipped_total").value(),
            "filtered": net.obs.counter(
                "gossip_payloads_filtered_total").value(), "p": p}


def test_gossip_placement_partial_replication():
    p, r = T.run(_gossip_placement)
    T.same(p, r, "roots", "converged", "stores", "shipped", "filtered")
    assert p["converged"] and p["filtered"] > 0
    pl = p["p"]
    for node in p["net"].nodes:
        for eid in node.state.visible():
            holder = pl.is_holder(node.node_id, eid)
            contributed = any(e.element_id == eid and e.node == node.node_id
                              for e in node.state.adds)
            assert (eid in node.state.store) == (holder or contributed)


# ------------------------------------------- review-found regressions


def _partial_holder(pkg):
    rng = np.random.default_rng(32)
    o, a, z = (pkg.SyncNode(n, max_frame_bytes=MAX_FRAME, chunk_window=2)
               for n in "oaz")
    o.contribute(T.payload(pkg, rng, (64, 64)))
    eid = next(iter(o.state.visible()))
    a.state = T.metadata_only(pkg, o.state)
    z.state = T.metadata_only(pkg, o.state)
    t1 = T.traced(pkg, pkg.InMemoryTransport())
    t1.register("o")
    t1.register("a")
    t1.send("a", "o", a.begin_sync("o"))
    for _ in range(3):
        for node_id, node in (("o", o), ("a", a)):
            for _src, msg in t1.recv_ready(node_id):
                for dst, reply in node.handle(msg):
                    t1.send(node_id, dst, reply)
    held = sorted(a._partials[eid].chunks)
    t2 = T.traced(pkg, pkg.InMemoryTransport())
    t2.register("a")
    t2.register("z")
    z.want_blobs([eid])
    blob = pkg.wire.encode_blob(o.state.store[eid])
    entry = pkg.wire.manifest_entry(eid, blob, o._chunk_payload)
    z.handle(pkg.wire.BlobManifest("o", 99, (entry,)))
    z.begin_sync("o")
    for peer, msg in z.query_holders([eid], peers=["a"]):
        t2.send("z", peer, msg)
    pkg.pump({"a": a, "z": z}, t2)
    return _result(t1.log + t2.log, o, a, z, held=held,
                   got=sorted(z._partials[eid].chunks))


def test_partial_holder_serves_its_verified_chunks():
    p, r = T.run(_partial_holder)
    _check(p, r, "held", "got")
    o, a, z = p["nodes"]
    assert p["held"] and set(p["got"]) >= set(p["held"])
    assert a.stats["chunks_served"] == len(p["held"])
    assert z.stats["chunks_redundant"] == 0


# ---------------------------------- SparseManifest -> engine.note_meta


def _plan_before_chunks(pkg):
    """A warm cache and a SparseManifest are enough to resolve: the
    manifest's leaf refs feed the planner memo, so the plan completes
    with the sparse payload still on the wire (no fetch)."""
    rng = np.random.default_rng(34)
    dense = {"emb": pkg.tensor(rng.standard_normal((64, 64)).astype(
        np.float32)), "ln": pkg.tensor(rng.standard_normal(8).astype(
            np.float32))}
    sparse = {"emb": pkg.tensor(rng.standard_normal((64, 64)).astype(
        np.float32))}
    a = pkg.SyncNode("a", max_frame_bytes=MAX_FRAME)
    a.contribute(dense)
    a.contribute(sparse, leaves=["['emb']"])
    spec = pkg.MergeSpec("weight_average")
    if pkg is PORT:
        cache = engine.EngineCache()
    else:
        from repro.core.engine import EngineCache
        cache = EngineCache()
    warm = pkg.resolve_spec(a.state, spec, cache=cache)
    pkg.clear_cache()                       # planner memo too
    z = pkg.SyncNode("z", max_frame_bytes=MAX_FRAME)
    z.state = T.metadata_only(pkg, a.state)
    sp_eid = next(e for e, c in a.state.coverage().items() if c)
    dn_eid = next(e for e, c in a.state.coverage().items() if c is None)
    store = dict(z.state.store)
    store[dn_eid] = a.state.store[dn_eid]
    z.state = pkg.CRDTMergeState(z.state.adds, z.state.removes, z.state.vv,
                                 store)
    [(_, req)] = z._maybe_blob_req("a", 1)
    frames = [m for _, m in a.handle(req)]
    types = [type(m).__name__ for m in frames]
    z.handle(next(m for m in frames
                  if isinstance(m, pkg.wire.SparseManifest)))
    asked = []

    def hook(eids):
        asked.append(tuple(eids))
        raise AssertionError("the plan should need no payload")

    out = pkg.resolve_spec(z.state, spec, cache=cache, fetch=hook)
    return _result([pkg.wire.encode_message(m) for m in frames], a, z,
                   types=types, asked=asked,
                   out=T.tree_bytes(out), warm=T.tree_bytes(warm),
                   missing=z.missing_blobs())


def test_note_meta_from_sparse_manifest_plans_before_chunks():
    p, r = T.run(_plan_before_chunks)
    _check(p, r, "types", "asked", "out", "warm", "missing")
    assert "SparseManifest" in p["types"] and p["asked"] == []
    assert p["out"] == p["warm"] and len(p["missing"]) == 1
    assert p["stats"][1]["sparse_manifests_received"] == 1
