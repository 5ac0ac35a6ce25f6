"""The port's durable tier (`repro_torch.core.journal`, `Replica(path=)`)
against the reference (`repro.core.journal`, `repro.api.Replica`).

Bitwise throughout (bytes on disk, Merkle roots, payload bytes):
  * the crash points are the reference's, declared in the same order;
    a crash at every registered point (and on the n-th hit) recovers a
    clean prefix of the acknowledged operations, byte-identical blobs
    included, whose root is one the reference computes for that prefix;
  * torn tails, flipped bytes and latent corruption under an open
    index behave as the reference's tests require (CRC scan on open,
    SHA-256 on read);
  * the same op sequence writes byte-equal `blobs.log`, `journal.log`
    and `snapshot.bin` in both packages, and a directory written by
    either package's `DurableStore` (JAX arrays on the reference side,
    torch tensors, bf16 and int8 payloads on the port's) is recovered by
    the other with equal roots and equal payload bytes;
  * `Replica(path=)`: close and reopen, idempotent close, the context
    manager, writes refused after a store is closed; six durable
    replicas gossiping by merges, three closed and reopened mid-way, a
    retraction inside a partition, converge to one root equal to 20
    shuffled merge orders of the op set, and resolve byte-identical
    trees;
  * the SyncNode cases of tests/test_durability.py on both packages: a
    warm restart re-fetching zero blob bytes, `Replica.attach` handing
    the storage to the node and `detach` taking it back, `close`
    through an attached node, `repair_membership` restoring the
    replication factor, budgeted shedding (largest backup first, never
    a primary or a pin) and an idempotent `SyncNode.close`;
  * C3: int8 contributions through `Replica.contribute(...,
    element_id=)` give the reference's roots and its weight_average
    resolve, bit for bit; without `element_id` the port raises
    `TypeError`.
"""
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.api import Replica as JReplica  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import journal as J  # noqa: E402
from repro.core.hashing import leaf_paths_of as jpaths  # noqa: E402
from repro.core.hashing import pytree_digest as jdigest  # noqa: E402
from repro.core.state import CRDTMergeState as JState  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import journal as P  # noqa: E402
from repro_torch.core.hashing import leaf_paths_of  # noqa: E402
from repro_torch.core.hashing import pytree_digest  # noqa: E402
from repro_torch.core.resolve import resolve_spec  # noqa: E402
from repro_torch.core.state import CRDTMergeState  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _disarm_crash_points():
    yield
    P.CrashPoint.disarm_all()
    J.CrashPoint.disarm_all()


def _np_payload(i: int):
    return {"emb": np.full((4, 3), float(i), np.float32),
            "ln": np.arange(6, dtype=np.float32) + i}


def _payload(i: int):
    return convert.from_numpy_tree(_np_payload(i), "cpu")


def _bytes(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return convert._to_numpy(x).tobytes()
    return np.asarray(x).tobytes()


def _bytes_equal(a, b) -> bool:
    la, lb = pytree.leaves(a), pytree.leaves(b)
    return len(la) == len(lb) and all(
        _bytes(x) == _bytes(y) for x, y in zip(la, lb))


def _states_equal(a: CRDTMergeState, b: CRDTMergeState) -> bool:
    if a != b or a.merkle_root() != b.merkle_root():
        return False
    if set(a.store) != set(b.store):
        return False
    return all(_bytes_equal(a.store[k], b.store[k]) for k in a.store)


def _scripted(pkg: str):
    """The reference's scripted op sequence (three adds, one sparse, a
    remove, a non-monotone tombstone GC), in either package: with
    compact_every=3 it reaches every registered crash point."""
    if pkg == "port":
        s, pay, paths = [CRDTMergeState()], _payload, leaf_paths_of
        sparse = convert.from_numpy_tree(
            {"emb": np.full((4, 3), 7.0, np.float32)}, "cpu")
        eid0 = pytree_digest(_payload(0)).hex()
    else:
        s, pay, paths = [JState()], _np_payload, jpaths
        sparse = {"emb": np.full((4, 3), 7.0, np.float32)}
        eid0 = jdigest(_np_payload(0)).hex()
    s.append(s[-1].add(pay(0), "n0"))
    s.append(s[-1].add(sparse, "n1", leaf_paths=paths(sparse)))
    s.append(s[-1].add(pay(2), "n2"))
    s.append(s[-1].remove(eid0, "n0"))
    s.append(s[-1].gc_tombstones(s[-1].removes))
    return s


def _run_ops(dirname: str, states, **kw):
    """Drive the transitions; returns (acked, crashed). The store is not
    closed on a crash: the files stay as the power cut left them."""
    store = P.DurableStore(dirname, device="cpu", **kw)
    acked = 0
    try:
        for old, new in zip(states, states[1:]):
            store.record_transition(old, new)
            acked += 1
    except P.SimulatedCrash:
        return acked, True
    store.close()
    return acked, False


def _load(dirname: str) -> CRDTMergeState:
    with P.DurableStore(dirname, device="cpu") as store:
        return store.load()


def _assert_clean_prefix(dirname: str, states, acked: int, point: str):
    rec = _load(dirname)
    assert any(_states_equal(rec, s) for s in states[acked:acked + 2]), (
        f"crash at {point}: not a clean prefix (acked={acked})")
    assert _states_equal(rec, _load(dirname)), \
        f"crash at {point}: a second open diverged"
    return rec


# ---------------------------------------------------------- crash points


def test_crash_points_are_the_reference_s():
    assert list(P.CrashPoint._declared) == list(J.CrashPoint._declared)
    assert P.CrashPoint.registered() == J.CrashPoint.registered()
    for p in P.CrashPoint.registered():
        assert P.CrashPoint.describe(p) == J.CrashPoint.describe(p)
    assert P.RECORD_TYPES == J.RECORD_TYPES
    assert issubclass(P.SimulatedCrash, BaseException)
    assert not issubclass(P.SimulatedCrash, Exception)
    with pytest.raises(KeyError):
        P.CrashPoint.arm("no.such.point")


@pytest.mark.parametrize("point", J.CrashPoint.registered())
def test_crash_at_every_registered_point(tmp_path, point):
    """Recovery yields a clean prefix whose root the reference computes
    for the same ops, and replaying the rest lands on the final
    state."""
    states = _scripted("port")
    ref_roots = [s.merkle_root() for s in _scripted("ref")]
    assert [s.merkle_root() for s in states] == ref_roots
    d = str(tmp_path / "node")
    P.CrashPoint.arm(point)
    acked, crashed = _run_ops(d, states, compact_every=3)
    assert crashed, f"scripted sequence never reached {point}"
    rec = _assert_clean_prefix(d, states, acked, point)
    assert rec.merkle_root() in ref_roots
    k = acked if _states_equal(rec, states[acked]) else acked + 1
    with P.DurableStore(d, compact_every=3, device="cpu") as store:
        for old, new in zip(states[k:], states[k + 1:]):
            store.record_transition(old, new)
    assert _states_equal(_load(d), states[-1])


@pytest.mark.parametrize("nth", [2, 3])
def test_crash_on_nth_hit(tmp_path, nth):
    states = _scripted("port")
    d = str(tmp_path / "node")
    P.CrashPoint.arm("journal.pre_ack", at=nth)
    acked, crashed = _run_ops(d, states, compact_every=100)
    assert crashed and acked == nth - 1
    _assert_clean_prefix(d, states, acked, f"journal.pre_ack@{nth}")


def test_crash_points_do_not_leak_into_the_reference_registry(tmp_path):
    """The two registries are separate module state: arming one
    package's point leaves the other's writes alone."""
    P.CrashPoint.arm("blob.pre_append")
    with J.DurableStore(str(tmp_path / "ref")) as store:
        store.record_transition(JState(), JState().add(_np_payload(0),
                                                        "n"))
    assert _run_ops(str(tmp_path / "port"),
                    _scripted("port")[:2]) == (0, True)


# -------------------------------------------------- torn tails, flipped


def test_blob_log_roundtrip_and_index_rebuild(tmp_path):
    path = str(tmp_path / "blobs.log")
    log = P.BlobLog(path)
    blobs = {f"e{i:02d}": os.urandom(64 + i) for i in range(8)}
    for eid, b in blobs.items():
        log.put(eid, b)
    size = log.size
    log.put("e00", blobs["e00"])
    assert log.size == size
    log.close()
    log2 = P.BlobLog(path)
    assert log2.eids() == set(blobs)
    for eid, b in blobs.items():
        assert bytes(log2.get(eid)) == b
    log2.close()
    ref = J.BlobLog(path)                  # the reference reads it too
    assert all(ref.get(e) == b for e, b in blobs.items())
    ref.close()


@pytest.mark.parametrize("chop", [1, 4, 37])
def test_torn_tail_truncation_recovers_prefix(tmp_path, chop):
    path = str(tmp_path / "blobs.log")
    log = P.BlobLog(path)
    for i in range(4):
        log.put(f"e{i}", bytes([i]) * 100)
    log.close()
    records, clean_end = P.scan_records(open(path, "rb").read())
    assert len(records) == 4 and clean_end == os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(clean_end - chop)
    for _ in range(2):                     # repaired once, then stable
        log2 = P.BlobLog(path)
        assert log2.eids() == {"e0", "e1", "e2"}
        assert os.path.getsize(path) == records[3][0]
        log2.close()


def test_flipped_byte_in_tail_record_is_discarded(tmp_path):
    path = str(tmp_path / "blobs.log")
    log = P.BlobLog(path)
    for i in range(3):
        log.put(f"e{i}", bytes([i]) * 80)
    log.close()
    records, _ = P.scan_records(open(path, "rb").read())
    with open(path, "r+b") as f:
        f.seek(records[2][0] + 20)
        b = f.read(1)
        f.seek(records[2][0] + 20)
        f.write(bytes([b[0] ^ 0xFF]))
    log2 = P.BlobLog(path)
    assert log2.eids() == {"e0", "e1"}
    log2.close()


def test_flipped_byte_mid_log_truncates_to_clean_prefix(tmp_path):
    path = str(tmp_path / "blobs.log")
    log = P.BlobLog(path)
    for i in range(5):
        log.put(f"e{i}", bytes([i]) * 50)
    log.close()
    records, _ = P.scan_records(open(path, "rb").read())
    with open(path, "r+b") as f:
        f.seek(records[1][0] + 10)
        f.write(b"\xde\xad")
    log2 = P.BlobLog(path)
    assert log2.eids() == {"e0"}
    log2.close()


def test_blob_get_verifies_sha256_on_read(tmp_path):
    path = str(tmp_path / "blobs.log")
    log = P.BlobLog(path)
    log.put("only", b"x" * 200)
    records, _ = P.scan_records(open(path, "rb").read())
    with open(path, "r+b") as f:
        f.seek(records[0][0] + 60)
        f.write(b"\x00\x01\x02")
    with pytest.raises(P.JournalError):
        log.get("only")
    log.close()


def test_scan_of_a_large_record_streams(tmp_path, monkeypatch):
    """The scan on open reads in bounded pieces (lowered to 64 bytes
    here) and finds the records `scan_records` finds in memory; a blob
    record keeps only its payload's first bytes."""
    monkeypatch.setattr(P, "_SCAN_READ", 64)
    monkeypatch.setattr(P, "_BLOB_SCAN_KEEP", 40)
    path = str(tmp_path / "blobs.log")
    log = P.BlobLog(path)
    for i in range(3):
        log.put(f"e{i}", bytes(range(256)) * (i + 1))
    log.close()
    raw = open(path, "rb").read()
    want, end = P.scan_records(raw)
    got, end2 = P._scan_file(path, None)
    assert got == want and end2 == end == len(raw)
    kept, _ = P._scan_file(path, 40)
    assert [(o, t, p[:40]) for o, t, p in want] == kept
    log2 = P.BlobLog(path)
    assert [bytes(log2.get(f"e{i}")) for i in range(3)] == [
        bytes(range(256)) * (i + 1) for i in range(3)]
    log2.close()


@pytest.mark.parametrize("sizes", [(0, 5), (3, 0), (100, 1000),
                                   (7, 70000), (1, 1 << 20)])
def test_crc32_combine_equals_crc_of_the_concatenation(sizes):
    """Exact: a blob record's CRC-32 is its head's combined with the
    blob's (computed beside the SHA-256), as one pass would give."""
    import zlib
    rng = np.random.default_rng(sum(sizes))
    a, b = (rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in sizes)
    assert P._crc32_combine(zlib.crc32(a), zlib.crc32(b), len(b)) == \
        zlib.crc32(a + b)


def test_journal_torn_tail_loses_only_unacked_op(tmp_path):
    d = str(tmp_path / "node")
    states = _scripted("port")
    store = P.DurableStore(d, compact_every=100, device="cpu")
    for old, new in zip(states[:4], states[1:4]):
        store.record_transition(old, new)
    store.close()
    jpath = os.path.join(d, "journal.log")
    with open(jpath, "r+b") as f:
        f.truncate(os.path.getsize(jpath) - 3)
    assert _states_equal(_load(d), states[2])


def test_durable_store_rejects_writes_after_close(tmp_path):
    store = P.DurableStore(str(tmp_path / "x"), device="cpu")
    store.close()
    store.close()
    with pytest.raises(P.JournalError):
        store.record_transition(CRDTMergeState(),
                                CRDTMergeState().add(_payload(0), "n"))


# ------------------------------------------------ byte-equal directories


@pytest.mark.parametrize("compact_every", [3, 100])
def test_log_files_byte_equal_to_the_reference_s(tmp_path, compact_every):
    """The scripted ops (snapshots and a blob-log compaction at
    compact_every=3) write the reference's files byte for byte."""
    dp, dj = str(tmp_path / "port"), str(tmp_path / "ref")
    _run_ops(dp, _scripted("port"), compact_every=compact_every)
    ref = _scripted("ref")
    with J.DurableStore(dj, compact_every=compact_every) as store:
        for old, new in zip(ref, ref[1:]):
            store.record_transition(old, new)
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dp))
    assert {"blobs.log", "journal.log"} <= set(names)
    for name in names:
        with open(os.path.join(dp, name), "rb") as fp, \
                open(os.path.join(dj, name), "rb") as fj:
            assert fp.read() == fj.read(), name


def _mixed_np(i: int):
    rng = np.random.default_rng(40 + i)
    return {"w": rng.standard_normal((8, 4)).astype(np.float32),
            "h": [rng.standard_normal(6).astype(ml_dtypes.bfloat16),
                  np.asarray(rng.integers(-5, 5, (3,)), np.int32)]}


def test_reference_directory_loads_on_the_port(tmp_path):
    """A directory the reference wrote from JAX arrays, an int8 payload
    among them: the port recovers its root and every payload's bytes."""
    d = str(tmp_path / "ref")
    ct = jcomp.compress_tree(_mixed_np(2))
    eid_q = jdigest(jcomp.decompress_tree(ct)).hex()
    with J.DurableStore(d) as store:
        s = JState()
        for i in range(2):
            nxt = s.add({k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                             else [jnp.asarray(x) for x in v])
                         for k, v in _mixed_np(i).items()}, f"n{i}")
            store.record_transition(s, nxt)
            s = nxt
        nxt = s.add(ct, "nq", element_id=eid_q)
        store.record_transition(s, nxt)
        s = nxt
    rec = _load(d)
    assert rec.merkle_root() == s.merkle_root()
    assert rec.visible() == s.visible() and rec.vv.to_dict() == \
        s.vv.to_dict()
    assert set(rec.store) == set(s.store)
    for eid in s.store:
        if eid == eid_q:
            got = rec.store[eid]
            assert isinstance(got, tcomp.CompressedTree)
            for a, b in zip(got.leaves, ct.leaves):
                assert _bytes(a.q) == np.asarray(b.q).tobytes()
                assert _bytes(a.scale) == np.float32(b.scale).tobytes()
        else:
            assert _bytes_equal(rec.store[eid], s.store[eid])


def test_port_directory_loads_on_the_reference(tmp_path):
    """The reverse: a directory the port wrote from torch tensors (bf16,
    int32 and an int8 payload) recovers on the reference."""
    d = str(tmp_path / "port")
    rep = Replica("p", path=d, device="cpu")
    for i in range(2):
        rep.contribute(convert.from_numpy_tree(_mixed_np(i), "cpu"))
    ct = tcomp.compress_tree(convert.from_numpy_tree(_mixed_np(2), "cpu"))
    eid_q = pytree_digest(tcomp.decompress_tree(ct)).hex()
    rep.contribute(ct, element_id=eid_q)
    rep.retract(sorted(rep.visible())[0])
    root, state = rep.merkle_root(), rep.state
    rep.close()
    with J.DurableStore(d) as store:
        rec = store.load()
    assert rec.merkle_root() == root
    for eid, p in state.store.items():
        if eid == eid_q:
            for a, b in zip(rec.store[eid].leaves, p.leaves):
                assert np.asarray(a.q).tobytes() == _bytes(b.q)
                assert np.float32(a.scale).tobytes() == _bytes(b.scale)
        else:
            assert _bytes_equal(rec.store[eid], p)
    back = JReplica("p", path=d)
    assert back.merkle_root() == root
    back.close()


# --------------------------------------------------------- Replica(path)


def test_replica_close_idempotent_and_context_manager(tmp_path):
    d = str(tmp_path / "rep")
    with Replica("a", path=d, device="cpu") as rep:
        eid = rep.contribute(_payload(1))
        root = rep.merkle_root()
    assert rep.closed
    rep.close()
    rep2 = Replica("a", path=d, device="cpu")
    assert rep2.merkle_root() == root and eid in rep2.state.store
    assert _bytes_equal(rep2.state.store[eid], _payload(1))
    rep2.close()
    rep2.close()
    assert rep2.node is None


def test_replica_state_setter_writes_through(tmp_path):
    """`rep.state = ...` is recorded like any other state change, and a
    state handed to the constructor joins the recovered one."""
    d = str(tmp_path / "rep")
    with Replica("a", path=d, device="cpu") as rep:
        rep.state = rep.state.add(_payload(2), "x")
        root = rep.merkle_root()
    extra = CRDTMergeState().add(_payload(3), "y")
    with Replica("a", path=d, device="cpu", state=extra) as rep:
        joined = rep.merkle_root()
        assert joined == rep.state.merge(extra).merkle_root()
    with Replica("a", path=d, device="cpu") as rep:
        assert rep.merkle_root() == joined != root
        assert len(rep.visible()) == 2


def test_restart_interleaved_20_ordering_convergence(tmp_path):
    """Six durable replicas gossip by pairwise merges; three are closed
    and reopened mid-way (warm: exact root, blobs back); a partition
    holds a retraction; after healing every replica has one root, equal
    to the reference's for the same op set and to 20 shuffled merge
    orders, and resolves byte-identical trees; a cold restart of all
    six recovers that root."""
    base = _payload(9)
    spec = MergeSpec("weight_average")
    ids = [f"node{i:03d}" for i in range(6)]
    reps = {n: Replica(n, path=str(tmp_path / n), device="cpu")
            for n in ids}
    payloads = [_payload(i) for i in range(6)]
    for n, p in zip(ids, payloads):
        reps[n].contribute(p)
    rng = random.Random(42)

    def gossip_round(groups):
        for g in groups:
            for a in g:
                b = rng.choice([x for x in g if x != a])
                reps[a].merge(reps[b])

    gossip_round([ids])
    victims = rng.sample(ids, 3)
    pre = {v: (reps[v].merkle_root(), set(reps[v].state.store))
           for v in victims}
    for v in victims:
        reps[v].close()
    gossip_round([[n for n in ids if n not in victims]])
    for v in victims:
        reps[v] = Replica(v, path=str(tmp_path / v), device="cpu")
        assert reps[v].merkle_root() == pre[v][0]
        assert set(reps[v].state.store) == pre[v][1]
    eid0 = pytree_digest(payloads[0]).hex()
    halves = [ids[:3], ids[3:]]
    reps[ids[0]].retract(eid0)
    for _ in range(2):
        gossip_round(halves)
    for _ in range(3):
        for a in ids:
            for b in ids:
                reps[a].merge(reps[b])
    roots = {r.merkle_root() for r in reps.values()}
    assert len(roots) == 1
    outs = [resolve_spec(r.state, spec, base=base, use_cache=False)
            for r in reps.values()]
    assert all(_bytes_equal(outs[0], o) for o in outs[1:])

    deltas = [CRDTMergeState().add(payloads[i], ids[i]) for i in range(6)]
    deltas[0] = deltas[0].remove(eid0, ids[0])
    jd = [JState().add(_np_payload(i), ids[i]) for i in range(6)]
    jd[0] = jd[0].remove(jdigest(_np_payload(0)).hex(), ids[0])
    ref_root = roots.pop()
    jacc = JState()
    for x in jd:
        jacc = jacc.merge(x)
    assert jacc.merkle_root() == ref_root
    for _ in range(20):
        order = rng.sample(range(len(deltas)), len(deltas))
        acc = CRDTMergeState()
        for i in order:
            acc = acc.merge(deltas[i])
        assert acc.merkle_root() == ref_root
        out = resolve_spec(acc, spec, base=base, use_cache=False)
        assert _bytes_equal(out, outs[0])
    for r in reps.values():
        r.close()
    for n in ids:
        with Replica(n, path=str(tmp_path / n), device="cpu") as r:
            assert r.merkle_root() == ref_root


# ------------------------------------------------------------------- C3


def _int8_pair(seed: int):
    rng = np.random.default_rng(seed)
    tree = {"a": rng.standard_normal((8, 8)).astype(np.float32),
            "b": [rng.standard_normal(16).astype(np.float32)]}
    ct_j = jcomp.compress_tree(tree)
    ct_t = tcomp.compress_tree(convert.from_numpy_tree(tree, "cpu"))
    return ct_t, ct_j


@pytest.mark.parametrize("durable", [False, True])
def test_c3_int8_contributions_match_the_reference(tmp_path, durable):
    """Bitwise: roots, and the weight_average resolve over four int8
    contributions added with element_id, in memory and through a
    durable replica reopened from disk."""
    pairs = [_int8_pair(50 + i) for i in range(4)]
    eids = [jdigest(jcomp.decompress_tree(j)).hex() for _, j in pairs]
    assert eids == [pytree_digest(tcomp.decompress_tree(t)).hex()
                    for t, _ in pairs]
    kw = {"path": str(tmp_path / "q")} if durable else {}
    rep = Replica("q", device="cpu", **kw)
    jrep = JReplica("q")
    for (t, j), e in zip(pairs, eids):
        assert rep.contribute(t, element_id=e) == e
        jrep.contribute(j, element_id=e)
    if durable:
        rep.close()
        rep = Replica("q", device="cpu", **kw)
        assert all(isinstance(rep.state.store[e], tcomp.CompressedTree)
                   for e in eids)
    assert rep.merkle_root() == jrep.merkle_root()
    out = rep.resolve(MergeSpec("weight_average"), use_cache=False)
    want = jrep.resolve(JSpec("weight_average"), use_cache=False)
    assert _bytes_equal(out, want)
    rep.close()


def test_c3_int8_without_element_id_raises():
    ct_t, _ = _int8_pair(60)
    rep = Replica("q", device="cpu")
    with pytest.raises(TypeError, match="element_id"):
        rep.contribute(ct_t)
    with pytest.raises(TypeError, match="element_id"):
        rep.add({"x": ct_t.leaves[0]})
    assert not rep.visible()


# ------------------------------------------------------------ SyncNode


def _sim(pkg: str, n: int, seed: int, **kw):
    if pkg == "port":
        from repro_torch.net import SimGossipNetwork
        return SimGossipNetwork(n, seed=seed, mode="antientropy",
                                device="cpu", **kw), _payload
    from repro.net.simulator import SimGossipNetwork as JSim
    return JSim(n, seed=seed, mode="antientropy", **kw), _np_payload


def _warm_restart(pkg: str, tmp: str):
    g, pay = _sim(pkg, 4, 3)
    g.contribute_all(lambda i: pay(i))
    g.attach_storage(tmp)
    g.run_epidemic(fanout=3, require_blobs=True)

    def blob_bytes():
        c = g.net.obs.counter("net_bytes_total")
        return sum(c.value(type=t) for t in
                   ("BlobResp", "ChunkData", "BlobManifest"))

    pre = g.by_id["node001"].state.merkle_root()
    before = blob_bytes()
    g.crash_node("node001")
    node = g.restart_node("node001")
    out = [node.state.merkle_root() == pre, node.missing_blobs()]
    g.run_epidemic(fanout=3, require_blobs=True)
    return out + [blob_bytes() - before, node.stats["blobs_received"],
                  g.converged(require_blobs=True), g.bytes_sent,
                  node.state.merkle_root()]


def test_warm_restart_fetches_zero_network_bytes(tmp_path):
    got = _warm_restart("port", str(tmp_path / "p"))
    assert got == _warm_restart("ref", str(tmp_path / "r"))
    assert got[:5] == [True, (), 0, 0, True]


def test_replica_attach_hands_storage_to_node_and_detach_reclaims(
        tmp_path):
    from repro_torch.net import SyncNode
    d = str(tmp_path / "rep")
    rep = Replica("b", path=d, device="cpu")
    node = SyncNode("b", device="cpu")
    rep.attach(node)
    assert node.storage is not None and rep._storage is None
    eid = rep.contribute(_payload(3))          # write-through via the node
    root = rep.merkle_root()
    rep.detach()
    assert rep._storage is not None and node.storage is None
    rep.close()
    with Replica("b", path=d, device="cpu") as rep2:
        assert rep2.merkle_root() == root and eid in rep2.state.store
    # a directory the port wrote through a node recovers on the reference
    with JReplica("b", path=d) as jrep:
        assert jrep.merkle_root() == root
        assert _bytes(jrep.state.store[eid]["emb"]) == \
            _bytes(_payload(3)["emb"])


def test_replica_attach_hands_over_without_a_second_replay(tmp_path):
    """The node adopts the replica's recovered payloads as they are:
    the store is not decoded a second time."""
    from repro_torch.net import SyncNode
    d = str(tmp_path / "rep")
    with Replica("b", path=d, device="cpu") as rep:
        rep.contribute(_payload(1))
    rep = Replica("b", path=d, device="cpu")
    held = dict(rep.state.store)
    node = SyncNode("b", device="cpu")
    rep.attach(node)
    assert all(node.state.store[e] is p for e, p in held.items())
    rep.close()


def test_replica_close_through_attached_node(tmp_path):
    from repro_torch.net import SyncNode
    d = str(tmp_path / "rep")
    rep = Replica("c", path=d, device="cpu")
    node = SyncNode("c", device="cpu")
    rep.attach(node)
    rep.contribute(_payload(5))
    root = rep.merkle_root()
    rep.close()
    assert rep.closed and node.storage is None and rep.node is None
    with Replica("c", path=d, device="cpu") as rep2:
        assert rep2.merkle_root() == root


def _repair(pkg: str):
    g, pay = _sim(pkg, 5, 11, replication=2)
    g.contribute_all(lambda i: pay(i))
    g.run_epidemic(fanout=3, require_blobs=True)
    for x in g.nodes:
        x.shed_blobs()
    dead = "node004"
    g.crash_node(dead)
    frames = []
    for x in g.nodes:
        frames.extend((x.node_id, peer, msg)
                      for peer, msg in x.repair_membership(dead))
    sent = [(s, d, type(m).__name__) for s, d, m in frames]
    for src, peer, msg in frames:
        g.net.send(src, peer, msg)
    g.net.run()
    pl = g.nodes[0].placement
    placed = all(eid in g.by_id[h].state.store
                 for eid in g.nodes[0].state.visible()
                 for h in pl.holders(eid))
    again = g.nodes[0].repair_membership(dead)
    return (sent, placed, again, pl.nodes, g.bytes_sent,
            [sorted(x.state.store) for x in g.nodes],
            [x.obs.counter("repair_events_total").value(
                event="replaced_eid") for x in g.nodes])


def test_repair_membership_restores_replication():
    got = _repair("port")
    assert got == _repair("ref")
    assert got[0] and got[1] and got[2] == []
    assert got[3] == tuple(f"node{i:03d}" for i in range(4))


def _budget(pkg: str):
    if pkg == "port":
        from repro_torch.net import Placement, SyncNode
        from repro_torch.net.store import payload_nbytes
        mk = lambda n: {"w": torch.zeros(n)}  # noqa: E731
        node_of = lambda i, st, pl: SyncNode(  # noqa: E731
            i, state=st, placement=pl, device="cpu")
        state = CRDTMergeState()
    else:
        from repro.net.antientropy import SyncNode as JNode
        from repro.net.store import payload_nbytes, Placement
        mk = lambda n: {"w": np.zeros(n, np.float32)}  # noqa: E731
        node_of = lambda i, st, pl: JNode(  # noqa: E731
            i, state=st, placement=pl)
        state = JState()
    payloads = {f"e{i}": mk(2 ** (8 + i)) for i in range(4)}
    for eid, p in payloads.items():
        state = state.add(p, "origin", element_id=eid)
    pl = Placement(["a", "b"], r=2)
    a = node_of("a", state, pl)
    out = [a.shed_blobs()]
    sizes = {e: payload_nbytes(p) for e, p in payloads.items()}
    primaries = {e for e in payloads if pl.holders(e)[0] == "a"}
    backups = sorted(set(payloads) - primaries, key=lambda e: -sizes[e])
    budget = sum(sizes.values()) - sizes[backups[0]]
    out.append(a.shed_blobs(budget_bytes=budget))
    out.append(backups[0])
    out.append(primaries <= set(a.state.store))
    b = node_of("b", state, pl)
    out.append(b.shed_blobs(budget_bytes=0))
    out.append(sorted(b.state.store))
    out.append(a.obs.counter("repair_events_total").value(
        event="budget_shed"))
    c = node_of("a", state.add(mk(1024), "o", element_id="pinned"), pl)
    c.want_blobs(["pinned"])
    c.shed_blobs(budget_bytes=0)
    out.append("pinned" in c.state.store)
    return out


def test_shed_blobs_budget_drops_largest_backups_first():
    got = _budget("port")
    assert got == _budget("ref")
    assert got[0] == () and got[1] == (got[2],) and got[3]
    assert got[7]                               # a pin is never shed


def test_syncnode_close_idempotent(tmp_path):
    from repro_torch.net import SyncNode
    node = SyncNode("z", device="cpu")
    store = P.DurableStore(str(tmp_path / "z"), device="cpu")
    node.attach_storage(store)
    node.contribute(_payload(4))
    root = node.state.merkle_root()
    node.close()
    node.close()
    assert node.storage is None
    with P.DurableStore(str(tmp_path / "z"), device="cpu") as reopened:
        assert reopened.load().merkle_root() == root
    with J.DurableStore(str(tmp_path / "z")) as jreopened:
        assert jreopened.load().merkle_root() == root
