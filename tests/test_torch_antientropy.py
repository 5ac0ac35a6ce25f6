"""The port's Merkle anti-entropy (`repro_torch.net.antientropy`) against
the reference (`repro.net.antientropy`): the scenarios of
tests/test_net_antientropy.py and the sync cases of tests/test_api.py,
each run on both packages from the same numpy inputs
(tests/_net_twins.py).

Bitwise: every frame sent, in order (sender, destination, encoded
bytes); Merkle and reconciliation roots after each session;
`sync_events_total` of every node; payload bytes in the stores. Resolves
are bitwise between the port's replicas and against the reference for
weight_average; TIES and slerp within `TOL` of the reference's
magnitude (tests/test_torch_gossip.py's rule).

The mixed fleet: a port SyncNode and a reference SyncNode finish a
session over loopback TCP, each on its own package's
`LoopbackSocketTransport` with the peer's listening port: every frame is
encoded by the sender's package and decoded by the receiver's. Both
initiators, equal roots, and each holds the other's payloads bitwise.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _net_twins as T  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from _net_twins import PORT, REF  # noqa: E402

from repro_torch.api import Replica  # noqa: E402
from repro_torch.core.compression import CompressedTree  # noqa: E402
from repro_torch.net import reconcile_root, SyncNode  # noqa: E402

torch.set_num_threads(1)

TOL = 2e-5


@pytest.fixture(autouse=True)
def _clear_caches():
    yield
    PORT.clear_cache()
    REF.clear_cache()


def _converged(a, b, stores=True):
    assert a.root() == b.root()
    assert a.state.adds == b.state.adds
    assert a.state.removes == b.state.removes
    if stores:
        assert set(a.state.store) == set(b.state.store)


def _result(t, *nodes, **extra):
    out = {"trace": list(t.log) if t is not None else [],
           "roots": [n.root() for n in nodes],
           "stats": [T.stats(n) for n in nodes],
           "stores": [{e: T.tree_bytes(p) if not isinstance(
               p, (PORT.CompressedTree, REF.CompressedTree)) else None
                       for e, p in sorted(n.state.store.items())}
                      for n in nodes],
           "nodes": nodes}
    out.update(extra)
    return out


def _check(p, r, *extra):
    T.same(p, r, "trace", "roots", "stats", "stores", *extra)


def _close(got, want, name):
    g, w = T.nbytes(got), T.nbytes(want)
    if name == "weight_average":
        assert g == w, name
        return
    g = np.frombuffer(g, np.float32).astype(np.float64)
    w = np.frombuffer(w, np.float32).astype(np.float64)
    err = float(np.max(np.abs(g - w)))
    assert err <= TOL * max(1.0, float(np.max(np.abs(w)))), (name, err)


# ------------------------------------------------------------- two-node


def _two_node(pkg):
    rng = np.random.default_rng(3)
    a, b = pkg.SyncNode("a"), pkg.SyncNode("b")
    for _ in range(4):
        a.contribute(T.payload(pkg, rng))
    for _ in range(3):
        b.contribute(T.payload(pkg, rng))
    t = T.sync(pkg, a, b)
    out = {n.node_id: n.resolve_spec(pkg.MergeSpec("weight_average"),
                                     use_cache=False)["w"] for n in (a, b)}
    return _result(t, a, b, reconcile=[pkg is PORT and reconcile_root(
        a.state)], out=out)


def test_two_node_sync_bidirectional():
    p, r = T.run(_two_node)
    _check(p, r)
    a, b = p["nodes"]
    _converged(a, b)
    assert reconcile_root(a.state) == reconcile_root(b.state)
    from repro.net.antientropy import reconcile_root as jroot
    assert reconcile_root(a.state) == jroot(r["nodes"][0].state)
    assert T.nbytes(p["out"]["a"]) == T.nbytes(p["out"]["b"]) == \
        T.nbytes(r["out"]["a"])


def _tombstones(pkg):
    rng = np.random.default_rng(4)
    a, b = pkg.SyncNode("a"), pkg.SyncNode("b")
    shared = T.payload(pkg, rng)
    a.contribute(shared)
    b.contribute(shared)
    t = T.traced(pkg, pkg.InMemoryTransport())
    T.sync(pkg, a, b, t)
    victim = sorted(a.state.visible())[0]
    a.retract(victim)
    seen_before = victim in b.state.visible()
    T.sync(pkg, a, b, t)
    return _result(t, a, b, victim=victim, seen_before=seen_before)


def test_sync_propagates_tombstones():
    p, r = T.run(_tombstones)
    _check(p, r, "victim")
    a, b = p["nodes"]
    _converged(a, b)
    assert p["seen_before"] and p["victim"] not in b.state.visible()


def _in_sync(pkg):
    rng = np.random.default_rng(5)
    a, b = pkg.SyncNode("a"), pkg.SyncNode("b")
    for _ in range(5):
        a.contribute(T.payload(pkg, rng, (16, 16)))
    t1 = T.sync(pkg, a, b)
    t2 = T.sync(pkg, a, b)
    full = pkg.wire.frame_size(pkg.wire.state_to_msg(a.state, "a"))
    return _result(t2, a, b, first=t1.log, types=dict(t2.bytes_by_type),
                   sent=t2.bytes_sent, full=full)


def test_in_sync_replicas_exchange_only_digests():
    p, r = T.run(_in_sync)
    _check(p, r, "first", "types", "sent", "full")
    assert set(p["types"]) == {"SyncReq", "SyncDone"}
    assert p["sent"] < p["full"] / 10


def _small_difference(pkg):
    rng = np.random.default_rng(6)
    a, b = pkg.SyncNode("a"), pkg.SyncNode("b")
    for _ in range(20):
        a.contribute(T.payload(pkg, rng, (32, 32)))
    T.sync(pkg, a, b)
    a.contribute(T.payload(pkg, rng, (32, 32)))
    t = T.sync(pkg, a, b)
    full = pkg.wire.frame_size(pkg.wire.state_to_msg(a.state, "a"))
    return _result(t, a, b, sent=t.bytes_sent, full=full)


def test_small_difference_ships_small_bytes():
    p, r = T.run(_small_difference)
    _check(p, r, "sent", "full")
    assert p["sent"] < p["full"] / 3
    _converged(*p["nodes"])


def _blob_recovery(pkg):
    rng = np.random.default_rng(7)
    a, b = pkg.SyncNode("a"), pkg.SyncNode("b")
    a.contribute(T.payload(pkg, rng))
    d = pkg.delta_for_entries(a.state, a.state.adds, a.state.removes)
    b.state = pkg.apply_delta(b.state, d)
    missing = b.missing_blobs()
    t = T.sync(pkg, b, a)
    return _result(t, a, b, missing=missing, after=b.missing_blobs())


def test_blob_recovery_for_entry_without_payload():
    p, r = T.run(_blob_recovery)
    _check(p, r, "missing", "after")
    assert p["missing"] and not p["after"]
    _converged(*p["nodes"])


def _compressed(pkg, keep_quantized=False, shape=(16, 16), frame=None):
    rng = np.random.default_rng(8 if not keep_quantized else 21)
    kw = {} if frame is None else {"max_frame_bytes": frame}
    a = pkg.SyncNode("a", compress_blobs=True, **kw)
    b = pkg.SyncNode("b", compress_blobs=True,
                     keep_quantized=keep_quantized, **kw)
    a.contribute(T.payload(pkg, rng, shape))
    t = T.sync(pkg, a, b)
    if frame is not None:
        T.sync(pkg, b, a, t)
    eid = next(iter(a.state.visible()))
    expect = pkg.decompress_tree(pkg.compress_tree(a.state.store[eid]))
    got = b.state.store[eid]
    dense = pkg.decompress_tree(got) if isinstance(
        got, pkg.CompressedTree) else got
    return _result(t, a, b, expect=T.tree_bytes(expect),
                   got=T.tree_bytes(dense),
                   kept=isinstance(got, pkg.CompressedTree), eid=eid)


def test_compressed_blob_sync_deterministic():
    p, r = T.run(_compressed)
    _check(p, r, "expect", "got", "kept")
    assert p["got"] == p["expect"] and not p["kept"]


@pytest.mark.parametrize("shape,frame", [((16, 16), None),
                                         ((64, 64), 2048)])
def test_keep_quantized_stores_int8_payloads(shape, frame):
    """Small blobs (BlobResp) and the chunk path (_finish_blob) alike
    keep the CompressedTree, its q and scale on the node's device."""
    p, r = T.run(_compressed, keep_quantized=True, shape=shape,
                 frame=frame)
    _check(p, r, "expect", "got", "kept")
    assert p["kept"] and p["got"] == p["expect"]
    b = p["nodes"][1]
    ct = b.state.store[p["eid"]]
    assert isinstance(ct, CompressedTree)
    for leaf in ct.leaves:
        assert leaf.q.dtype == torch.int8 and leaf.q.device == b.device
        assert leaf.scale.device == b.device


# ------------------------------------------------------------ multi-node


def _mesh(pkg):
    rng = np.random.default_rng(9)
    nodes = {f"n{i}": pkg.SyncNode(f"n{i}") for i in range(6)}
    for node in nodes.values():
        node.contribute(T.payload(pkg, rng))
    t = T.traced(pkg, pkg.InMemoryTransport())
    for nid in nodes:
        t.register(nid)
    ids = sorted(nodes)
    roots = []
    for _ in range(3):
        for i, nid in enumerate(ids):
            peer = ids[(i + 1) % len(ids)]
            t.send(nid, peer, nodes[nid].begin_sync(peer))
            pkg.pump(nodes, t)
            roots.append([nodes[n].root() for n in ids])
    return _result(t, *[nodes[n] for n in ids], per_session=roots)


def test_mesh_of_nodes_converges_via_pairwise_sessions():
    p, r = T.run(_mesh)
    _check(p, r, "per_session")
    assert len(set(p["roots"])) == 1
    assert all(not n.missing_blobs() for n in p["nodes"])


def _invalid_bits(pkg):
    b = pkg.SyncNode("b")
    b.contribute(T.payload(pkg, np.random.default_rng(20)))
    before = b.state
    replies = b.handle(pkg.wire.SyncReq("a", 1, b"\x00" * 32, 20,
                                        before.vv))
    return _result(None, b, replies=replies, same=b.state is before)


def test_invalid_bits_dropped_not_crashed():
    p, r = T.run(_invalid_bits)
    _check(p, r, "replies", "same")
    assert p["replies"] == [] and p["same"]
    assert p["stats"][0]["protocol_error_bits"] == 1


def test_resolve_cache_distinguishes_cfg_and_base():
    rng = np.random.default_rng(21)
    arrs = [rng.standard_normal((4, 4)).astype(np.float32) for _ in range(3)]
    out = {}
    for pkg in (PORT, REF):
        s = pkg.CRDTMergeState()
        for a in arrs:
            s = s.add(pkg.tensor(a), node="a")
        pkg.clear_cache()
        lo = pkg.MergeSpec("slerp", {"t": 0.1})
        hi = pkg.MergeSpec("slerp", {"t": 0.9})
        r_lo, r_hi = pkg.resolve(s, lo), pkg.resolve(s, hi)
        assert T.nbytes(r_lo) != T.nbytes(r_hi)
        assert pkg.resolve(s, lo) is r_lo and pkg.resolve(s, hi) is r_hi
        out[pkg.name] = (r_lo, r_hi)
    for g, w in zip(out["port"], out["ref"]):
        _close(g, w, "slerp")


def _plain_push(pkg):
    rng = np.random.default_rng(10)
    a, b = pkg.SyncNode("a"), pkg.SyncNode("b")
    a.contribute(T.payload(pkg, rng))
    b.handle(pkg.wire.state_to_msg(a.state, "a"))
    return _result(None, a, b)


def test_interop_with_plain_state_push():
    p, r = T.run(_plain_push)
    _check(p, r)
    assert p["roots"][0] == p["roots"][1]


def _random_divergence(pkg, seed):
    rng = np.random.default_rng(seed)
    a, b = pkg.SyncNode("a"), pkg.SyncNode("b")
    for _ in range(int(rng.integers(1, 5))):
        a.contribute(T.payload(pkg, rng, (2, 2)))
    for _ in range(int(rng.integers(0, 4))):
        b.contribute(T.payload(pkg, rng, (2, 2)))
    if rng.random() < 0.5 and a.state.visible():
        a.retract(sorted(a.state.visible())[0])
    t = T.sync(pkg, a, b)
    return _result(t, a, b)


@settings(max_examples=10, deadline=None, database=None)
@given(st.integers(0, 10_000))
def test_sync_property_random_divergence(seed):
    """Equal roots and every visible payload on both sides. A retracted
    element's blob stays in its contributor's store and is never
    fetched, so the stores' key sets may differ by it (the reference's
    version of this property compares them and fails on such seeds)."""
    p, r = T.run(_random_divergence, seed)
    _check(p, r)
    a, b = p["nodes"]
    _converged(a, b, stores=False)
    assert not a.missing_blobs() and not b.missing_blobs()
    vis = a.state.visible()
    assert set(a.state.store) & vis == set(b.state.store) & vis == vis


# ----------------------------------------------------------- mixed fleet


def _mixed_pump(sides, max_steps=5000):
    """Pump a fleet whose nodes sit on different transports: a frame
    one transport sends lands in another's listener, so quiescence is
    the sum of both sides' in-flight counts."""
    import time
    for _ in range(max_steps):
        progressed = False
        for t, nid, node in sides:
            for _src, msg in t.recv_ready(nid):
                progressed = True
                for dst, reply in node.handle(msg):
                    t.send(nid, dst, reply)
        if not progressed:
            if sum(t._in_flight for t, _, _ in sides) == 0:
                return
            time.sleep(0.001)
    raise RuntimeError("mixed fleet did not quiesce")


@pytest.mark.parametrize("initiator", ["port", "ref"])
def test_mixed_fleet_over_loopback_tcp(initiator):
    rng = np.random.default_rng(30)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((8, 8), (3,), (16, 4))]
    tn, jn = PORT.SyncNode("torch-node"), REF.SyncNode("jax-node")
    tn.contribute({"w": PORT.tensor(arrs[0])})
    tn.contribute({"w": PORT.tensor(arrs[1])})
    jn.contribute({"w": REF.tensor(arrs[2])})
    tt = PORT.LoopbackSocketTransport()
    jt = REF.LoopbackSocketTransport()
    try:
        tt.register(tn.node_id)
        jt.register(jn.node_id)
        tt._ports[jn.node_id] = jt._ports[jn.node_id]
        jt._ports[tn.node_id] = tt._ports[tn.node_id]
        if initiator == "port":
            tt.send(tn.node_id, jn.node_id, tn.begin_sync(jn.node_id))
        else:
            jt.send(jn.node_id, tn.node_id, jn.begin_sync(tn.node_id))
        _mixed_pump([(tt, tn.node_id, tn), (jt, jn.node_id, jn)])
    finally:
        tt.close()
        jt.close()
    assert tn.root() == jn.root()
    assert set(tn.state.store) == set(jn.state.store) and \
        len(tn.state.store) == 3
    for eid in tn.state.store:
        assert T.tree_bytes(tn.state.store[eid]) == \
            T.tree_bytes(jn.state.store[eid])
        assert tn.state.store[eid]["w"].device.type == "cpu"
    assert not tn.missing_blobs() and not jn.missing_blobs()


# ------------------------------------------- Replica.attach, spec gossip


def _attach_fetch(pkg):
    rng = np.random.default_rng(44)
    arrs = [rng.standard_normal((6, 5)).astype(np.float32)
            for _ in range(4)]
    s = pkg.CRDTMergeState()
    for a in arrs[:3]:
        s = s.add({"w": pkg.tensor(a)}, node="n")
    full = dict(s.store)
    node = pkg.SyncNode("store-node", state=pkg.CRDTMergeState(
        s.adds, s.removes, s.vv, {}))
    node.fetch_hook = lambda _n, eids: {e: full[e] for e in eids}
    if pkg is PORT:
        rep = Replica("edge", device="cpu").attach(node)
    else:
        from repro.api import Replica as JReplica
        rep = JReplica("edge").attach(node)
    visible = rep.state.visible() == s.visible()
    out = rep.resolve(pkg.MergeSpec("ties"))
    pulls = node.stats["resolve_blob_pulls"]
    want = pkg.resolve_spec(s, pkg.MergeSpec("ties"), use_cache=False)
    eid = rep.contribute({"w": pkg.tensor(arrs[3])})
    in_node = eid in node.state.store
    rep.detach()
    return {"visible": visible, "pulls": pulls, "out": out, "want": want,
            "in_node": in_node, "eid": eid, "rep": rep,
            "after": rep.state.visible() == s.visible() | {eid}}


def test_replica_attach_syncnode_fetch_and_delegation():
    p, r = T.run(_attach_fetch)
    T.same(p, r, "visible", "pulls", "in_node", "eid", "after")
    assert p["visible"] and p["pulls"] == 3 and p["in_node"] and p["after"]
    assert T.nbytes(p["out"]["w"]) == T.nbytes(p["want"]["w"])
    _close(p["out"]["w"], r["out"]["w"], "ties")
    rep = p["rep"]
    assert rep.node is None
    with pytest.raises(RuntimeError):
        rep.detach()
    node = SyncNode("n2", device="cpu")
    rep.attach(node)
    with pytest.raises(RuntimeError, match="already attached"):
        rep.attach(node)
    assert rep.node is node and "via 'n2'" in repr(rep)
    node.begin_sync("p")
    assert rep.metrics()["sync_events_total{event=sessions_started}"] == 1


def _spec_gossip(pkg):
    rng = np.random.default_rng(46)
    a, b = pkg.SyncNode("a"), pkg.SyncNode("b")
    for _ in range(3):
        a.contribute(T.payload(pkg, rng, (5, 3)))
    t = T.sync(pkg, a, b)
    spec = pkg.MergeSpec("ties", {"trim": 0.3}, reduction="tree")
    for peer, msg in a.propose_spec(spec, ["b"]):
        t.send("a", peer, msg)
    pkg.pump({"a": a, "b": b}, t)
    seen = b.specs_seen["a"] == spec
    ra = a.resolve_spec(spec, use_cache=False)
    rb = b.resolve_spec(b.specs_seen["a"], use_cache=False)
    b.handle(pkg.wire.ResolveSpecMsg("a", 1,
                                      pkg.MergeSpec("weight_average")))
    with pytest.raises(pkg.wire.WireError):
        pkg.wire.encode_message(pkg.wire.ResolveSpecMsg(
            "a", 9, pkg.MergeSpec.lenient("ties", {"trm": 0.3})))
    return _result(t, a, b, seen=seen, ra=ra, rb=rb,
                   kept=b.specs_seen["a"] == spec)


def test_sync_nodes_gossip_resolve_specs():
    p, r = T.run(_spec_gossip)
    _check(p, r, "seen", "kept")
    assert p["seen"] and p["kept"]
    assert p["stats"][1]["specs_stale"] == 1
    assert T.nbytes(p["ra"]["w"]) == T.nbytes(p["rb"]["w"])
    _close(p["ra"]["w"], r["ra"]["w"], "ties")


def test_syncnode_without_a_device_needs_cuda():
    """SyncNode and the three transports run on CUDA unless the caller
    names the CPU; without CUDA they raise rather than fall back."""
    from repro_torch.net import (
        InMemoryTransport, LoopbackSocketTransport,
        PersistentLoopbackTransport)
    for make in (lambda: SyncNode("x"), InMemoryTransport,
                 LoopbackSocketTransport, PersistentLoopbackTransport):
        if torch.cuda.is_available():
            obj = make()
            assert obj.device.type == "cuda"
            getattr(obj, "close", lambda: None)()
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                make()
