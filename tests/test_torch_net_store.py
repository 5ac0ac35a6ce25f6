"""The port's sharded-store records (`repro_torch.net.store`) against
the reference (`repro.net.store`).

Bitwise throughout: rendezvous holders and `Placement` (holders,
`without`, validation) for 1,000 eids over n in {1, 3, 8} nodes and
r in {1, 2, 3}; HaveMap bitmaps byte for byte; `BlobSource`.

`payload_nbytes` equals the reference's on dense trees. On an int8
payload (`CompressedTree`) the port counts the `q` and `scale` bytes,
where the reference's flatten takes the tree for one opaque leaf and
reads 8 bytes: a departure, pinned here. The port sizes a payload from
tensor metadata alone: `device="meta"` tensors, which hold no data and
raise on any read, size like real ones.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import compression as jcomp  # noqa: E402
from repro.net import store as R  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.net import store as P  # noqa: E402

torch.set_num_threads(1)

EIDS = [f"{i * 2654435761 % (1 << 64):064x}" for i in range(1000)]


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("r", [1, 2, 3])
def test_placement_equals_the_reference_s(n, r):
    nodes = [f"node{i:03d}" for i in range(n)]
    if r > n:
        for mod in (P, R):
            with pytest.raises(ValueError):
                mod.Placement(nodes, r)
        assert P.rendezvous_holders(EIDS[0], nodes, r) == \
            R.rendezvous_holders(EIDS[0], nodes, r)
        return
    p, q = P.Placement(reversed(nodes), r), R.Placement(nodes, r)
    assert p.nodes == q.nodes and p.r == q.r
    for eid in EIDS:
        assert p.holders(eid) == q.holders(eid) \
            == P.rendezvous_holders(eid, nodes, r)
        assert p.is_holder(nodes[0], eid) == q.is_holder(nodes[0], eid)
    if n > 1:
        pw, qw = p.without(nodes[-1]), q.without(nodes[-1])
        assert (pw.nodes, pw.r) == (qw.nodes, qw.r)
        assert [pw.holders(e) for e in EIDS[:200]] == \
            [qw.holders(e) for e in EIDS[:200]]
    assert repr(p) == repr(q)


def test_placement_validation_matches():
    for mod in (P, R):
        with pytest.raises(ValueError):
            mod.Placement([], r=1)
        with pytest.raises(ValueError):
            mod.Placement(["a", "b"], r=0)
        with pytest.raises(ValueError):
            mod.rendezvous_holders("e" * 64, ["a"], 0)


def test_bitmaps_byte_equal():
    rng = np.random.default_rng(0)
    for n in (1, 5, 8, 9, 64, 333):
        for _ in range(10):
            idx = sorted(set(rng.integers(0, n, size=int(rng.integers(
                0, n + 1))).tolist()))
            bm = P.chunk_bitmap(idx, n)
            assert bm == R.chunk_bitmap(idx, n)
            assert P.bitmap_indices(bm, n) == R.bitmap_indices(bm, n) \
                == tuple(idx)
    assert P.bitmap_indices(b"\xff", 3) == R.bitmap_indices(b"\xff", 3)
    for mod in (P, R):
        with pytest.raises(ValueError):
            mod.chunk_bitmap([5], 5)
        with pytest.raises(ValueError):
            mod.chunk_bitmap([], 0)


def test_blob_source_matches():
    for args in ((1,), (1, frozenset({2, 3})), (4, frozenset(), 7)):
        p, q = P.BlobSource(*args), R.BlobSource(*args)
        assert [p.can_serve(i) for i in range(6)] == \
            [q.can_serve(i) for i in range(6)]
        assert (p.sid, p.indices, p.gen) == (q.sid, q.indices, q.gen)


def _tree(rng):
    return {"a": rng.standard_normal((4, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal(7).astype(np.float16),
                  "d": np.arange(6, dtype=np.int32)},
            "e": [rng.standard_normal((3, 3)).astype(np.float32)]}


def test_payload_nbytes_dense_equals_the_reference_s():
    rng = np.random.default_rng(1)
    tree = _tree(rng)
    jtree = {"a": jnp.asarray(tree["a"]),
             "b": {"c": jnp.asarray(tree["b"]["c"]),
                   "d": jnp.asarray(tree["b"]["d"])},
             "e": [jnp.asarray(tree["e"][0])]}
    got = P.payload_nbytes(convert.from_numpy_tree(tree, "cpu"))
    assert got == R.payload_nbytes(jtree) == R.payload_nbytes(tree) \
        == 4 * 20 + 2 * 7 + 4 * 6 + 4 * 9
    assert P.payload_nbytes({}) == R.payload_nbytes({}) == 0


def test_payload_nbytes_int8_counts_q_and_scale():
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((64, 65)).astype(np.float32),
            "v": rng.standard_normal(10).astype(np.float32)}
    ct = tcomp.compress_tree(convert.from_numpy_tree(tree, "cpu"))
    true = 64 * 65 + 4 + 10 + 4
    assert P.payload_nbytes(ct) == true
    assert P.payload_nbytes({"x": ct}) == true
    assert sorted(P.payload_nbytes(leaf) for leaf in ct.leaves) == \
        [10 + 4, 64 * 65 + 4]
    # the reference's flatten takes the CompressedTree for one leaf and
    # reads the 8 bytes of an object array (ROADMAP C: a hazard of its
    # budgeted shedding, not copied)
    jct = jcomp.compress_tree(tree)
    assert R.payload_nbytes(jct) == 8 != P.payload_nbytes(ct)


def test_payload_nbytes_reads_no_tensor_data():
    meta = {"a": torch.empty((1024, 4096), dtype=torch.bfloat16,
                             device="meta"),
            "b": [torch.empty(3, dtype=torch.float32, device="meta")]}
    with pytest.raises(NotImplementedError):
        meta["a"].tolist()                    # a meta tensor has no data
    assert P.payload_nbytes(meta) == 1024 * 4096 * 2 + 12
    leaf = tcomp.CompressedLeaf(
        torch.empty((2048, 8), dtype=torch.int8, device="meta"),
        torch.empty((), dtype=torch.float32, device="meta"),
        (2048, 8), torch.bfloat16)
    from repro_torch import pytree
    _, treedef = pytree.flatten({"q": 0})
    ct = tcomp.CompressedTree([leaf], treedef)
    assert P.payload_nbytes(ct) == 2048 * 8 + 4
    assert P.payload_nbytes({"m": ct, "n": meta}) == \
        2048 * 8 + 4 + 1024 * 4096 * 2 + 12
