"""The port's wire codec (`repro_torch.net.wire`) against the reference
(`repro.net.wire`).

Bitwise throughout — frames are bytes, and every comparison is byte or
field equality:
  * every one of the 15 message types, built from the same seeded numpy
    data in both packages, encodes to the same frame; each package
    decodes the other's frame to equal fields and re-encodes it to the
    same bytes;
  * tensors of float32, bfloat16, float16, int8, int32 and bool, 0-d
    and 3-d, and an int8 `CompressedTree`, survive the wire bit for bit
    in both directions;
  * corruption, a bad magic or version, truncation and trailing bytes
    raise `WireError`, and so does a field past the u32 length prefix;
  * the registries (tags, message classes, VERSION, the v1/v2 stamps)
    are the reference's; `leaf_refs`, `sparse_manifest_entry`,
    `chunk_digests` and `encode_layer1` give equal values, sparse
    coverage included; `msg_to_state(keep_quantized=)` in both modes;
  * a blob streamed as BlobManifest + ChunkData frames at a small chunk
    budget reassembles to the reference's blob bytes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api.spec import MergeSpec as JSpec  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core.delta import delta_since as jdelta_since  # noqa: E402
from repro.core.hashing import leaf_paths_of as jpaths  # noqa: E402
from repro.core.state import CRDTMergeState as JState  # noqa: E402
from repro.core.version_vector import VersionVector as JVV  # noqa: E402
from repro.net import wire as W  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.api.spec import MergeSpec  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core.delta import delta_since  # noqa: E402
from repro_torch.core.hashing import leaf_paths_of  # noqa: E402
from repro_torch.core.state import CRDTMergeState  # noqa: E402
from repro_torch.core.version_vector import VersionVector  # noqa: E402
from repro_torch.net import wire as P  # noqa: E402

torch.set_num_threads(1)


# ---------------------------------------------------------------- helpers


def _tree(seed: int):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 4)).astype(np.float32),
            "b": [rng.standard_normal(3).astype(np.float32),
                  {"s": rng.standard_normal(2).astype(ml_dtypes.bfloat16)}]}


def _t(tree):
    return convert.from_numpy_tree(tree, "cpu")


def _states(seed: int = 0, sparse: bool = True):
    """The same op sequence on both packages: three dense adds, a
    sparse add, a retraction."""
    s, j = CRDTMergeState(), JState()
    for i in range(3):
        tree = _tree(seed + i)
        s = s.add(_t(tree), f"n{i % 2}")
        j = j.add(tree, f"n{i % 2}")
    if sparse:
        part = {"w": np.full((4, 4), 0.5, np.float32)}
        s = s.add(_t(part), "n2", leaf_paths=leaf_paths_of(_t(part)))
        j = j.add(part, "n2", leaf_paths=jpaths(part))
    eid = sorted(s.visible())[0]
    return s.remove(eid, "n0"), j.remove(eid, "n0")


def _norm(v):
    """A package-neutral value for field comparison: tensors become
    (dtype name, shape, bytes), containers and dataclasses tuples."""
    if isinstance(v, (tcomp.CompressedTree, jcomp.CompressedTree)):
        mod = tcomp if isinstance(v, tcomp.CompressedTree) else jcomp
        return ("ctree", _norm(mod.compressed_tree_to_structure(v)))
    if isinstance(v, tcomp.CompressedLeaf):
        return ("qleaf", P._dtype_str(v.dtype), tuple(v.shape),
                bytes(P._host_bytes(v.scale)), bytes(P._host_bytes(v.q)))
    if isinstance(v, jcomp.CompressedLeaf):
        return ("qleaf", str(v.dtype), tuple(v.shape),
                np.float32(v.scale).tobytes(),
                np.ascontiguousarray(v.q).tobytes())
    if isinstance(v, (MergeSpec, JSpec)):
        return ("spec", v.encode())
    if isinstance(v, (VersionVector, JVV)):
        return ("vv", tuple(sorted((k, c) for k, c in v.to_dict().items()
                                   if c)))
    if isinstance(v, torch.Tensor):
        return ("tensor", P._dtype_str(v.dtype), tuple(v.shape),
                bytes(P._host_bytes(v)))
    if isinstance(v, np.ndarray) or type(v).__module__.startswith(
            ("jax", "jaxlib")):
        a = np.asarray(v)
        return ("tensor", str(a.dtype), a.shape, a.tobytes())
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__,) + tuple(
            (f.name, _norm(getattr(v, f.name)))
            for f in dataclasses.fields(v))
    if isinstance(v, (set, frozenset)):
        return ("set", tuple(sorted((_norm(x) for x in v), key=repr)))
    if isinstance(v, dict):
        return ("dict", tuple((k, _norm(v[k])) for k in sorted(v)))
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_norm(x) for x in v))
    return v


def _pair(name: str):
    """(port message, reference message) of type `name`, built from the
    same seeded data."""
    s, j = _states()
    vv_t, vv_j = VersionVector({"a": 3, "b": 1}), JVV({"a": 3, "b": 1})
    blob = bytes(range(256)) * 20
    digests = W.chunk_digests(blob, 1024)
    if name == "StateMsg":
        return P.state_to_msg(s, "node000"), W.state_to_msg(j, "node000")
    if name == "DeltaMsg":
        d = delta_since(s, VersionVector(), compress=True)
        jd = jdelta_since(j, JVV(), compress=True)
        return P.delta_to_msg(d, "node001"), W.delta_to_msg(jd, "node001")
    if name == "SyncReq":
        return (P.SyncReq("a", 7, b"\x01" * 32, 5, vv_t),
                W.SyncReq("a", 7, b"\x01" * 32, 5, vv_j))
    if name == "BucketsMsg":
        dg = {0: b"\x02" * 32, 9: b"\x03" * 32}
        return P.BucketsMsg("b", 7, 5, dg), W.BucketsMsg("b", 7, 5, dg)
    if name == "BucketItemsMsg":
        return (P.BucketItemsMsg("a", 7, 5, s.adds, s.removes, vv_t,
                                 want=(9, 1, 5)),
                W.BucketItemsMsg("a", 7, 5, j.adds, j.removes, vv_j,
                                 want=(9, 1, 5)))
    if name == "BlobReq":
        return P.BlobReq("b", 7, ("e2", "e1")), W.BlobReq("b", 7,
                                                          ("e2", "e1"))
    if name == "BlobResp":
        tree = _tree(11)
        return (P.BlobResp("a", 7, {"e1": _t(tree), "e0": (1, 2.5, "x",
                                                           None, True)}),
                W.BlobResp("a", 7, {"e1": tree, "e0": (1, 2.5, "x", None,
                                                       True)}))
    if name == "SyncDone":
        return P.SyncDone("b", 7, vv_t), W.SyncDone("b", 7, vv_j)
    if name == "BlobManifest":
        return (P.BlobManifest("a", 7, (P.ManifestEntry(
                    "f" * 64, 1024, len(blob), digests),
                    P.ManifestEntry("e" * 64, 512, 10, (b"\x05" * 32,)))),
                W.BlobManifest("a", 7, (W.ManifestEntry(
                    "f" * 64, 1024, len(blob), digests),
                    W.ManifestEntry("e" * 64, 512, 10, (b"\x05" * 32,)))))
    if name == "ChunkReq":
        return (P.ChunkReq("b", 7, "e" * 64, 1024, (4, 0, 3)),
                W.ChunkReq("b", 7, "e" * 64, 1024, (4, 0, 3)))
    if name == "ChunkData":
        return (P.ChunkData("a", 7, "e" * 64, 3, blob[3072:4096]),
                W.ChunkData("a", 7, "e" * 64, 3, blob[3072:4096]))
    if name == "HaveReq":
        return (P.HaveReq("a", 9, ("e2", "e1", "e2")),
                W.HaveReq("a", 9, ("e2", "e1", "e2")))
    if name == "HaveMap":
        return (P.HaveMap("b", 9, (P.HaveEntry("e2", 10, b"\x0f\x03"),
                                   P.HaveEntry("e1", 0))),
                W.HaveMap("b", 9, (W.HaveEntry("e2", 10, b"\x0f\x03"),
                                   W.HaveEntry("e1", 0))))
    if name == "ResolveSpecMsg":
        kw = dict(base_ref="ab" * 32, trust_threshold=0.5)
        return (P.ResolveSpecMsg("a", 3, MergeSpec("ties", {"trim": 0.3},
                                                   **kw)),
                W.ResolveSpecMsg("a", 3, JSpec("ties", {"trim": 0.3},
                                               **kw)))
    if name == "SparseManifest":
        tree = _tree(12)
        ct_t = tcomp.compress_tree(_t(_tree(13)))
        ct_j = jcomp.compress_tree(_tree(13))
        ents_t = (P.sparse_manifest_entry("e1", _t(tree),
                                          P.encode_blob(_t(tree)), 256),
                  P.sparse_manifest_entry("e0", ct_t, P.encode_blob(ct_t),
                                          100))
        ents_j = (W.sparse_manifest_entry("e1", tree, W.encode_blob(tree),
                                          256),
                  W.sparse_manifest_entry("e0", ct_j, W.encode_blob(ct_j),
                                          100))
        return (P.SparseManifest("a", 4, ents_t),
                W.SparseManifest("a", 4, ents_j))
    raise KeyError(name)


NAMES = [cls.__name__ for _, cls in sorted(W.MESSAGE_TYPES.items())]


# -------------------------------------------------------------- frames


@pytest.mark.parametrize("name", NAMES)
def test_frame_byte_equal_both_directions(name):
    """Bitwise: equal frames, each decoded by the other package to equal
    fields and re-encoded to the same bytes."""
    mt, mj = _pair(name)
    assert type(mt).__name__ == type(mj).__name__ == name
    ft, fj = P.encode_message(mt), W.encode_message(mj)
    assert ft == fj
    on_port = P.decode_message(fj, device="cpu")
    on_ref = W.decode_message(ft)
    assert P.encode_message(on_port) == ft
    assert W.encode_message(on_ref) == fj
    assert _norm(on_port) == _norm(on_ref) == _norm(
        P.decode_message(ft, device="cpu"))


def test_every_message_type_is_covered():
    assert len(NAMES) == 15 and set(NAMES) == {
        cls.__name__ for cls in P.MESSAGE_TYPES.values()}


def test_registries_equal():
    """Bitwise: tags, classes, versions, stamps, sizes and value tags."""
    assert {t: c.__name__ for t, c in P.MESSAGE_TYPES.items()} == \
        {t: c.__name__ for t, c in W.MESSAGE_TYPES.items()}
    for t, c in P.MESSAGE_TYPES.items():
        assert c.type == t
        assert P.frame_version(t) == W.frame_version(t)
    names = [k for k in vars(W) if k.startswith(("MSG_", "_T_"))]
    assert len(names) == 15 + 11
    for k in names:
        assert getattr(P, k) == getattr(W, k), k
    for k in ("MAGIC", "VERSION", "ACCEPTED_VERSIONS", "FRAME_OVERHEAD",
              "DEFAULT_MAX_FRAME", "CHUNK_ENVELOPE", "DIGEST_LEN"):
        assert getattr(P, k) == getattr(W, k), k
    assert P.HEADER.format == W.HEADER.format
    assert P.TRAILER.format == W.TRAILER.format


def test_multiple_frames_in_one_buffer():
    m1 = P.SyncDone("a", 1, VersionVector({"a": 2}))
    m2 = P.BlobReq("b", 2, ("e1", "e2"))
    buf = P.encode_message(m1) + P.encode_message(m2)
    out1, pos = P.decode_frame(buf)
    out2, end = P.decode_frame(buf, pos)
    assert out1 == m1 and out2 == m2 and end == len(buf)


def test_large_fields_byte_equal():
    """Bitwise: a chunk and a tensor past the 64 KiB mark, which the
    encoder keeps as parts of their own."""
    data = np.random.default_rng(9).integers(0, 256, 70000,
                                             dtype=np.uint8).tobytes()
    ft = P.encode_message(P.ChunkData("a", 1, "e", 2, memoryview(data)))
    assert ft == W.encode_message(W.ChunkData("a", 1, "e", 2, data))
    assert P.decode_message(ft).data == data
    a = np.random.default_rng(8).standard_normal((300, 100)).astype(
        np.float32)
    fj = W.encode_message(W.BlobResp("a", 1, {"e": a}))
    assert P.encode_message(P.BlobResp("a", 1, {"e": torch.from_numpy(
        a)})) == fj
    assert _norm(P.decode_message(fj, device="cpu").payloads["e"]) == \
        _norm(a)


# --------------------------------------------------------------- tensors


DTYPES = ["float32", "bfloat16", "float16", "int8", "int32", "bool"]


def _array(dtype: str, shape, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * 3
    if dtype == "bool":
        return np.asarray(x > 0)
    if dtype in ("int8", "int32"):
        return np.asarray(np.round(x)).astype(dtype)
    return np.asarray(x).astype(ml_dtypes.bfloat16 if dtype == "bfloat16"
                                else dtype)


@pytest.mark.parametrize("shape", [(), (2, 3, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tensor_dtypes_survive_both_directions(dtype, shape):
    """Bitwise: the dtype name, shape and bytes of each tensor."""
    a = _array(dtype, shape, seed=len(shape) + DTYPES.index(dtype))
    t = convert._to_tensor(a, "cpu")
    ft = P.encode_message(P.BlobResp("a", 1, {"e": {"x": t}}))
    fj = W.encode_message(W.BlobResp("a", 1, {"e": {"x": jnp.asarray(a)}}))
    assert ft == fj
    got = P.decode_message(fj, device="cpu").payloads["e"]["x"]
    assert got.dtype == t.dtype and tuple(got.shape) == shape
    assert _norm(got) == _norm(t)
    back = np.asarray(W.decode_message(ft).payloads["e"]["x"])
    assert back.dtype == a.dtype and back.tobytes() == a.tobytes()


def test_compressed_tree_bit_identical_across_the_wire():
    """Bitwise: the reference's int8 payload decodes on the port to the
    same q and scale, and decompresses to the reference's bytes; the
    port's compresses to the reference's blob."""
    rng = np.random.default_rng(2)
    tree = {"a": (rng.standard_normal((16, 16)) * 3).astype(np.float32),
            "b": [rng.standard_normal(5).astype(ml_dtypes.bfloat16)]}
    ct_j = jcomp.compress_tree(tree)
    ct_t = tcomp.compress_tree(_t(tree))
    assert P.encode_blob(ct_t) == W.encode_blob(ct_j)
    got = P.decode_blob(W.encode_blob(ct_j), device="cpu")
    assert isinstance(got, tcomp.CompressedTree)
    assert _norm(got) == _norm(ct_j)
    local = jcomp.decompress_tree(ct_j)
    remote = tcomp.decompress_tree(got)
    for x, y in zip((local["a"], local["b"][0]),
                    (remote["a"], remote["b"][0])):
        assert _norm(y) == _norm(x)
    assert all(leaf.scale.dtype == torch.float32 and leaf.scale.dim() == 0
               for leaf in got.leaves)


@pytest.mark.parametrize("keep", [False, True])
def test_msg_to_state_keep_quantized(keep):
    """Bitwise: a compressed delta's payloads after msg_to_state —
    kept int8 (q and scale) or decompressed on arrival."""
    s, j = _states(5, sparse=False)
    ct_t = tcomp.compress_tree(s.store[sorted(s.store)[0]])
    ct_j = jcomp.compress_tree(j.store[sorted(j.store)[0]])
    eid = sorted(s.store)[0]
    mt = P.StateMsg("x", s.adds, s.removes, s.vv, {eid: ct_t})
    mj = W.StateMsg("x", j.adds, j.removes, j.vv, {eid: ct_j})
    frame = P.encode_message(mt)
    assert frame == W.encode_message(mj)
    st = P.msg_to_state(P.decode_message(frame, device="cpu"),
                        keep_quantized=keep, device="cpu")
    sj = W.msg_to_state(W.decode_message(frame), keep_quantized=keep)
    assert st.merkle_root() == sj.merkle_root()
    got, want = st.store[eid], sj.store[eid]
    assert isinstance(got, tcomp.CompressedTree) == keep
    assert _norm(got) == _norm(want)


def test_delta_roundtrip_compressed_both_packages():
    s, j = _states(1)
    for compress in (False, True):
        mt = P.delta_to_msg(delta_since(s, VersionVector(),
                                        compress=compress), "n")
        mj = W.delta_to_msg(jdelta_since(j, JVV(), compress=compress), "n")
        frame = P.encode_message(mt)
        assert frame == W.encode_message(mj)
        d = P.msg_to_delta(P.decode_message(frame, device="cpu"))
        assert d.compressed == compress and d.adds == s.adds


# ------------------------------------------------------------ corruption


def test_frame_rejects_corruption():
    msg = P.SyncReq("a", 1, b"\x00" * 32, 4, VersionVector({"a": 1}))
    frame = bytearray(P.encode_message(msg))
    frame[len(frame) // 2] ^= 0xFF
    with pytest.raises(P.WireError):
        P.decode_message(bytes(frame))


def test_frame_rejects_bad_magic_version_truncation_trailing():
    frame = P.encode_message(P.SyncDone("a", 1, VersionVector()))
    for bad in (b"XX" + frame[2:], frame[:1], frame[:-2],
                frame[:2] + b"\x7f" + frame[3:], frame + b"\x00",
                frame[:3] + b"\x7e" + frame[4:]):
        with pytest.raises(P.WireError):
            P.decode_message(bad)


def test_blob_and_layer1_reject_trailing_and_truncated_bytes():
    tree = _t(_tree(3))
    blob = P.encode_blob(tree)
    s, _ = _states()
    raw = P.encode_layer1(s.adds, s.removes, s.vv)
    for fn, good in ((lambda b: P.decode_blob(b, device="cpu"), blob),
                     (P.decode_layer1, raw)):
        with pytest.raises(P.WireError):
            fn(good + b"\x00")
        with pytest.raises(P.WireError):
            fn(good[:-3])


def test_tensor_bytes_must_match_header():
    """A tensor whose byte count disagrees with its dtype and shape is
    a malformed frame (the reference raises numpy's ValueError)."""
    blob = bytearray(P.encode_blob(torch.ones(4)))
    # the u32 byte count sits right before the 16 data bytes
    blob[-20:-16] = (12).to_bytes(4, "big")
    with pytest.raises(P.WireError):
        P.decode_blob(bytes(blob[:-4]), device="cpu")


def test_field_past_u32_length_raises(monkeypatch):
    """A field too long for its u32 length prefix raises at encode
    time (shown with the limit lowered to 100 bytes)."""
    monkeypatch.setattr(P, "_U32_MAX", 100)
    P.encode_blob(torch.zeros(25))                     # 100 bytes: fits
    with pytest.raises(P.WireError):
        P.encode_blob(torch.zeros(26))
    with pytest.raises(P.WireError):
        P.encode_message(P.ChunkData("a", 1, "e", 0, b"x" * 120))


def test_unsupported_values_raise():
    with pytest.raises(P.WireError):
        P.encode_blob({1: torch.ones(2)})
    with pytest.raises(P.WireError):
        P.encode_blob(object())
    with pytest.raises(P.WireError):
        P.encode_message(P.ResolveSpecMsg("a", 1, "ties"))


# ------------------------------------------------- refs, layer 1, chunks


def test_leaf_refs_and_sparse_manifest_equal():
    """Bitwise: paths, digests, dtype names, shapes and scales, for a
    dense, a partial and an int8 payload."""
    trees = [_tree(20), {"w": np.ones((2, 2), np.float32)}]
    for tree in trees:
        assert _norm(P.leaf_refs(_t(tree))) == _norm(W.leaf_refs(tree))
    ct_t = tcomp.compress_tree(_t(_tree(21)))
    ct_j = jcomp.compress_tree(_tree(21))
    refs = P.leaf_refs(ct_t)
    assert _norm(refs) == _norm(W.leaf_refs(ct_j))
    assert all(r.scale is not None for r in refs)
    assert [r.path for r in refs] == sorted(r.path for r in refs)
    e_t = P.sparse_manifest_entry("e", ct_t, P.encode_blob(ct_t), 64)
    e_j = W.sparse_manifest_entry("e", ct_j, W.encode_blob(ct_j), 64)
    assert _norm(e_t) == _norm(e_j)
    assert e_t.coverage == e_j.coverage


def test_encode_layer1_equal_with_sparse_entries():
    s, j = _states(7)
    assert any(e.leaf_paths is not None for e in s.adds)
    raw = P.encode_layer1(s.adds, s.removes, s.vv)
    assert raw == W.encode_layer1(j.adds, j.removes, j.vv)
    adds, removes, vv = P.decode_layer1(raw)
    assert adds == s.adds and removes == s.removes and vv == s.vv
    dense, _ = _states(7, sparse=False)
    raw = P.encode_layer1(dense.adds, dense.removes, dense.vv)
    assert raw == W.encode_layer1(*W.decode_layer1(raw))
    assert not raw[0] & 0x80                 # the legacy 3-string form


@pytest.mark.parametrize("size", [300, 4000])
def test_chunk_digests_equal_threaded_or_not(size):
    """Bitwise: 5 and 63 chunks of 64 bytes (a blob of many chunks is
    hashed on threads)."""
    blob = np.random.default_rng(size).integers(
        0, 256, size, dtype=np.uint8).tobytes()
    assert P.chunk_digests(blob, 64) == W.chunk_digests(blob, 64)
    assert _norm(P.manifest_entry("e", blob, 64)) == _norm(
        W.manifest_entry("e", blob, 64))
    with pytest.raises(P.WireError):
        P.chunk_digests(blob, 0)


def test_blob_streams_in_chunk_frames():
    """A payload's blob as BlobManifest + ChunkData frames at a small
    frame budget: every frame byte-equal to the reference's, CRCs
    checked on decode, the reassembled blob checked against the
    manifest's digests and decoded bitwise."""
    tree = _tree(30)
    ct_j = jcomp.compress_tree(tree)
    blob = P.encode_blob(tcomp.compress_tree(_t(tree)))
    assert blob == W.encode_blob(ct_j)
    budget = 128 - P.FRAME_OVERHEAD
    man = P.BlobManifest("a", 1, (P.manifest_entry("e", blob, budget),))
    fm = P.encode_message(man)
    assert fm == W.encode_message(W.BlobManifest(
        "a", 1, (W.manifest_entry("e", blob, budget),)))
    entry = P.decode_message(fm).entries[0]
    parts = []
    for i in range(entry.n_chunks):
        chunk = blob[i * budget:(i + 1) * budget]
        frame = P.encode_message(P.ChunkData("a", 1, "e", i, chunk))
        assert frame == W.encode_message(W.ChunkData("a", 1, "e", i, chunk))
        got = P.decode_message(frame)
        assert P.chunk_digests(got.data, budget)[0] == entry.digests[i]
        parts.append(got.data)
    whole = b"".join(parts)
    assert len(whole) == entry.total_size and whole == blob
    assert _norm(P.decode_blob(whole, device="cpu")) == _norm(ct_j)


def test_new_modules_import_neither_jax_nor_the_reference():
    """The byte formats and the exporter exist and import neither JAX,
    the reference nor ml_dtypes (the GPU machine has none of them)."""
    import ast
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    for rel in ("src/repro_torch/net/wire.py",
                "src/repro_torch/net/__init__.py",
                "src/repro_torch/core/journal.py",
                "src/repro_torch/obs/export.py",
                "src/repro_torch/api/replica.py", "chip_smoke.py"):
        tree = ast.parse((root / rel).read_text(encoding="utf-8"))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in (
                    "jax", "jaxlib", "repro", "ml_dtypes"), f"{rel}: {mod}"
