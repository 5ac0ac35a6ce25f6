"""Layer 1's rest on the PyTorch port against the JAX reference: deltas,
dotted version vectors and the order-independent fingerprint.

Bitwise (byte or integer equality) throughout:
  * `delta_since`, `delta_for_entries` and `apply_delta`: add entries,
    tombstones, version vectors, `approx_bytes` and payload bytes, int8
    payloads (`q` and scale) included; `apply_delta(S, delta_since(S',
    seen)) == S.merge(S')` over seeded random states;
  * `DottedVersionVector`: the semilattice laws, compaction, and the
    reference's `context`, `dots`, `metadata_size` and `repr` after the
    same op sequences;
  * `fingerprint2x32` on fp32, bf16, int32 and uint32 inputs, and its
    split invariance; `tree_fingerprint` for trees of one and two
    leaves. The reference's raises from the third leaf on (its leaf
    weight overflows `jnp.uint32`); the port reduces it mod 2^32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import hashing as jhash  # noqa: E402
from repro.core.delta import apply_delta as japply  # noqa: E402
from repro.core.delta import delta_for_entries as jdelta_for  # noqa: E402
from repro.core.delta import delta_since as jdelta_since  # noqa: E402
from repro.core.dotted_vv import DottedVersionVector as JDVV  # noqa: E402
from repro.core.state import CRDTMergeState as JState  # noqa: E402
from repro.core.version_vector import VersionVector as JVV  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.core import DottedVersionVector  # noqa: E402
from repro_torch.core.compression import CompressedTree  # noqa: E402
from repro_torch.core.delta import (  # noqa: E402
    apply_delta, delta_for_entries, delta_since)
from repro_torch.core.hashing import (  # noqa: E402
    _MIX_A, _mul32, _words_u32, fingerprint2x32, tree_fingerprint)
from repro_torch.core.state import CRDTMergeState  # noqa: E402
from repro_torch.core.version_vector import VersionVector  # noqa: E402

torch.set_num_threads(1)


def _tree(rng, names=("a", "b", "c")):
    return {n: rng.standard_normal((3, 4)).astype(np.float32)
            for n in names}


def _both(ops):
    """The same adds and removes on both packages. ops: ('add', node,
    seed, leaf names or None) | ('rm', node, index of an earlier add)."""
    s, j = CRDTMergeState(), JState()
    for op in ops:
        if op[0] == "add":
            _, node, seed, names = op
            tree = _tree(np.random.default_rng(seed), names or ("a", "b",
                                                                "c"))
            cover = [f"['{n}']" for n in names] if names else None
            s = s.add(convert.from_numpy_tree(tree, "cpu"), node,
                      leaf_paths=cover)
            j = j.add({k: jnp.asarray(v) for k, v in tree.items()}, node,
                      leaf_paths=cover)
        else:
            eid = sorted(s.visible())[op[2] % len(s.visible())]
            s, j = s.remove(eid, op[1]), j.remove(eid, op[1])
    return s, j


def _entries(adds):
    return sorted((e.element_id, e.tag, e.node, e.leaf_paths) for e in adds)


def _payload_bytes(p):
    if isinstance(p, CompressedTree):
        return [(leaf.q.numpy().tobytes(),
                 np.float32(leaf.scale.item()).tobytes(), leaf.shape)
                for leaf in p.leaves]
    return [np.asarray(x).tobytes() for x in
            pytree.leaves(convert.to_numpy_tree(p))]


def _jpayload_bytes(p):
    from repro.core.compression import CompressedTree as JCT
    import jax
    if isinstance(p, JCT):
        return [(np.asarray(leaf.q).tobytes(),
                 np.float32(leaf.scale).tobytes(), tuple(leaf.shape))
                for leaf in p.leaves]
    return [np.asarray(x).tobytes() for x in jax.tree_util.tree_leaves(p)]


def _same_delta(d, jd):
    assert _entries(d.adds) == _entries(jd.adds)
    assert d.removes == jd.removes
    assert d.vv.to_dict() == jd.vv.to_dict()
    assert d.compressed == jd.compressed
    assert d.approx_bytes() == jd.approx_bytes()
    assert sorted(d.payloads) == sorted(jd.payloads)
    for eid in d.payloads:
        assert _payload_bytes(d.payloads[eid]) == \
            _jpayload_bytes(jd.payloads[eid])


OPS = [("add", "a", 1, None), ("add", "b", 2, ("a",)),
       ("add", "a", 3, ("b", "c")), ("rm", "b", 0), ("add", "c", 4, None)]


@pytest.mark.parametrize("compress", [False, True])
@pytest.mark.parametrize("seen", [{}, {"a": 1}, {"a": 2, "b": 1},
                                  {"a": 2, "b": 2, "c": 1}])
def test_delta_since_matches_reference(seen, compress):
    s, j = _both(OPS)
    d = delta_since(s, VersionVector(seen), compress=compress)
    jd = jdelta_since(j, JVV(seen), compress=compress)
    _same_delta(d, jd)
    # applied to an empty state, each gives the reference's state
    got, want = apply_delta(CRDTMergeState(), d), \
        japply(JState(), jd)
    assert _entries(got.adds) == _entries(want.adds)
    assert got.removes == want.removes
    assert got.merkle_root() == want.merkle_root()
    for eid in got.store:
        assert _payload_bytes(got.store[eid]) == \
            _jpayload_bytes(want.store[eid])


@pytest.mark.parametrize("include", [False, True])
def test_delta_for_entries_matches_reference(include):
    s, j = _both(OPS)
    pick = sorted(s.adds)[1:3]
    jpick = [e for e in j.adds
             if (e.element_id, e.tag) in {(p.element_id, p.tag)
                                          for p in pick}]
    rm = frozenset(sorted(s.removes)[:1])
    d = delta_for_entries(s, frozenset(pick), rm, include_payloads=include,
                          compress=include)
    jd = jdelta_for(j, frozenset(jpick), rm, include_payloads=include,
                    compress=include)
    _same_delta(d, jd)


def test_apply_delta_shares_payloads():
    """The receiver's store holds the sender's tensors, not copies."""
    s, _ = _both(OPS[:2])
    got = apply_delta(CRDTMergeState(), delta_since(s, VersionVector()))
    for eid, p in got.store.items():
        for x, y in zip(pytree.leaves(p), pytree.leaves(s.store[eid])):
            assert x is y


def _random_ops(seed, node):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(int(rng.integers(1, 4))):
        names = [None, ("a",), ("b", "c")][int(rng.integers(3))]
        ops.append(("add", node, int(rng.integers(1 << 20)), names))
    if rng.random() < 0.5:
        ops.append(("rm", node, int(rng.integers(4))))
    return ops


@pytest.mark.parametrize("seed", range(8))
def test_apply_delta_since_equals_merge(seed):
    s1, j1 = _both(_random_ops(seed, "a"))
    s2, j2 = _both(_random_ops(seed + 100, "b"))
    for seen in ({}, s1.vv.to_dict(), s2.vv.to_dict()):
        got = apply_delta(s1, delta_since(s2, VersionVector(seen)))
        if seen != s2.vv.to_dict():
            assert got == s1.merge(s2)
        want = japply(j1, jdelta_since(j2, JVV(seen)))
        assert got.merkle_root() == want.merkle_root()
        assert _entries(got.adds) == _entries(want.adds)


def test_approx_bytes_counts_coverage_and_payload_sizes():
    dense, _ = _both([("add", "n", 0, None)])
    sparse, _ = _both([("add", "n", 0, ("b",))])
    dd = delta_since(dense, VersionVector())
    ds = delta_since(sparse, VersionVector())
    e = next(iter(ds.adds))
    overhead = sum(len(p) for p in e.leaf_paths) + len(e.leaf_paths)
    assert dd.approx_bytes() == 96 + 3 * 12 * 4
    assert ds.approx_bytes() == 96 + overhead + 12 * 4


# --------------------------------------------------------------- DVV ---


def _dvv_ops(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(int(rng.integers(0, 10))):
        node = "abcd"[int(rng.integers(4))]
        ops.append(("inc", node) if rng.random() < 0.7 else
                   ("dot", node, int(rng.integers(1, 8))))
    return ops


def _build(ops, cls):
    d = cls()
    for op in ops:
        d = d.increment(op[1]) if op[0] == "inc" else d.add_dot(op[1:])
    return d


def _same_dvv(d, jd):
    assert d.context == jd.context and d.dots == jd.dots
    assert d.metadata_size() == jd.metadata_size()
    assert repr(d) == repr(jd)


@pytest.mark.parametrize("seed", range(10))
def test_dvv_laws_and_reference_state(seed):
    o1, o2, o3 = (_dvv_ops(seed * 3 + n) for n in range(3))
    a, b, c = (_build(o, DottedVersionVector) for o in (o1, o2, o3))
    ja, jb, jc = (_build(o, JDVV) for o in (o1, o2, o3))
    assert a.merge(b) == b.merge(a)
    assert a.merge(b).merge(c) == a.merge(b.merge(c))
    assert a.merge(a) == a and a <= a.increment("z")
    for d, jd in ((a, ja), (a.merge(b), ja.merge(jb)),
                  (a.merge(b).merge(c), ja.merge(jb).merge(jc))):
        _same_dvv(d, jd)
        for node in "abcdz":
            assert d.next_dot(node) == jd.next_dot(node)
            assert d.get(node) == jd.get(node)
            for n in range(1, 9):
                assert d.contains((node, n)) == jd.contains((node, n))
    assert (a <= b) == (ja <= jb)
    assert hash(a) == hash(_build(o1, DottedVersionVector))


def test_dvv_compaction():
    d = DottedVersionVector()
    for _ in range(5):
        d = d.increment("a")
    assert d.context == {"a": 5} and not d.dots
    gap = d.add_dot(("a", 7))
    assert gap.dots == frozenset({("a", 7)})
    full = gap.add_dot(("a", 6))
    assert full.context == {"a": 7} and not full.dots
    _same_dvv(full, JDVV().increment("a").add_dot(("a", 2)).add_dot(
        ("a", 3)).add_dot(("a", 4)).add_dot(("a", 5)).add_dot(
        ("a", 7)).add_dot(("a", 6)))


# ------------------------------------------------------- fingerprint ---


def _pair(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "float32":
        a = rng.standard_normal(n).astype(np.float32)
        return torch.from_numpy(a), jnp.asarray(a)
    if kind == "bfloat16":
        a = rng.standard_normal(n).astype(ml_dtypes.bfloat16)
        return convert.from_numpy_tree(a, "cpu"), jnp.asarray(a)
    if kind == "int32":
        a = rng.integers(-2 ** 31, 2 ** 31, n).astype(np.int32)
        return torch.from_numpy(a), jnp.asarray(a)
    a = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.astype(np.int64)).to(torch.uint32), \
        jnp.asarray(a)


@pytest.mark.parametrize("n", [1, 129, 4097])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int32",
                                  "uint32"])
def test_fingerprint_matches_reference(kind, n):
    x, jx = _pair(kind, n, seed=n)
    got = fingerprint2x32(x)
    assert got.dtype == torch.uint32
    assert got.tolist() == [int(v) for v in jhash.fingerprint2x32(jx)]


@pytest.mark.parametrize("seed", range(6))
def test_fingerprint_split_invariance(seed):
    """Partial fingerprints over a contiguous split, each with its global
    indices, add up (mod 2^32) to the whole."""
    n = 1 + seed * 97
    x, _ = _pair("float32", n, seed)
    whole = fingerprint2x32(x).tolist()
    w = _words_u32(x)
    i = torch.arange(n, dtype=torch.int64)
    k1 = ((_mul32(i, _MIX_A) + 0x9E3779B9) & 0xFFFFFFFF) ^ (i >> 7)
    k2 = ((_mul32(i, 0x85EBCA6B) + 0xC2B2AE35) ^ (i << 3)) & 0xFFFFFFFF
    cut = n // 2
    lanes = [0, 0]
    for sl in (slice(0, cut), slice(cut, n)):
        lanes[0] += int(_mul32(w[sl], k1[sl]).sum())
        lanes[1] += int(_mul32(w[sl] ^ k2[sl], _MIX_A).sum())
    assert [v & 0xFFFFFFFF for v in lanes] == whole


@pytest.mark.parametrize("names", [("x",), ("x", "y")])
def test_tree_fingerprint_matches_reference(names):
    rng = np.random.default_rng(len(names))
    tree = {n: rng.standard_normal((5,)).astype(np.float32) for n in names}
    got = tree_fingerprint(convert.from_numpy_tree(tree, "cpu"))
    want = jhash.tree_fingerprint({k: jnp.asarray(v)
                                   for k, v in tree.items()})
    assert got.tolist() == [int(v) for v in want]


def test_tree_fingerprint_past_two_leaves():
    """The reference raises from the third leaf on; the port takes the
    leaf weight mod 2^32 and stays structure-sensitive."""
    tree = {n: np.full(4, i, np.float32) for i, n in enumerate("xyz")}
    with pytest.raises(OverflowError):
        jhash.tree_fingerprint({k: jnp.asarray(v) for k, v in tree.items()})
    t = convert.from_numpy_tree(tree, "cpu")
    got = tree_fingerprint(t).tolist()
    want = [0, 0]
    for idx, n in enumerate("xyz"):
        rot = (idx * 0x9E3779B9 + 1) & 0xFFFFFFFF
        fp = fingerprint2x32(t[n]).tolist()
        want = [(a + f * rot) & 0xFFFFFFFF for a, f in zip(want, fp)]
    assert got == want
    swapped = tree_fingerprint({"x": t["y"], "y": t["x"], "z": t["z"]})
    assert swapped.tolist() != got
