"""Layer 1 of the PyTorch port against the JAX reference.

Every comparison here is bitwise: element ids, OR-Set tags, Merkle roots
and seeds are SHA-256 values over canonical bytes, and flatten order and
`keystr` paths are strings. Inputs are numpy arrays made from a seed and
handed to both packages (the port through `convert.from_numpy_tree`).
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core import hashing as jhash  # noqa: E402
from repro.core.resolve import seed_from_root as jseed  # noqa: E402
from repro.core.state import CRDTMergeState as JState  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.core import hashing as thash  # noqa: E402
from repro_torch.core.resolve import seed_from_root as tseed  # noqa: E402
from repro_torch.core.state import CRDTMergeState as TState  # noqa: E402

torch.set_num_threads(1)


def _grid_f64():
    """The tier-1 grid: nine 4x4 float64 tensors (controlled_tensors)."""
    rng = np.random.default_rng(42)
    return [rng.standard_normal((4, 4)) for _ in range(9)]


def _mixed(seed):
    """A mixed fp32 / bf16 / int8 pytree with unsorted dict keys, nested
    sequences, a 0-dim leaf and a None subtree."""
    rng = np.random.default_rng(seed)
    return {
        "zeta": rng.standard_normal((3, 5)).astype(np.float32),
        "alpha": {"w": rng.standard_normal(7).astype(ml_dtypes.bfloat16),
                  "b": rng.integers(-128, 127, (2, 3), dtype=np.int8)},
        "mid": [rng.standard_normal(()).astype(np.float32),
                (rng.standard_normal((1, 2)).astype(np.float32), None)],
    }


CASES = {
    "grid_f64": lambda: [{"w": a} for a in _grid_f64()],
    "mixed": lambda: [_mixed(s) for s in range(4)],
}


def _jax_tree(tree):
    with jax.enable_x64(True):
        return jax.tree_util.tree_map(jnp.asarray, tree)


def _states(contribs, ops):
    """Replay (kind, node, index) ops on both packages' states."""
    js, ts = JState(), TState()
    jc = [_jax_tree(c) for c in contribs]
    tc = [convert.from_numpy_tree(c, "cpu") for c in contribs]
    for kind, node, i in ops:
        if kind == "add":
            js = js.add(jc[i], node)
            ts = ts.add(tc[i], node)
        else:
            eid = jhash.pytree_digest(jc[i]).hex()
            js = js.remove(eid, node)
            ts = ts.remove(eid, node)
    return js, ts


@pytest.mark.parametrize("case", sorted(CASES))
def test_element_ids_match_reference(case):
    with jax.enable_x64(True):
        for c in CASES[case]():
            want = jhash.pytree_digest(_jax_tree(c))
            got = thash.pytree_digest(convert.from_numpy_tree(c, "cpu"))
            assert got == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_tags_roots_seeds_match_reference(case):
    contribs = CASES[case]()
    ops = [("add", "n1", 0), ("add", "n2", 1), ("add", "n1", 2),
           ("add", "n2", 0), ("remove", "n1", 1), ("add", "n3", 3)]
    js, ts = _states(contribs, ops)
    assert sorted((e.element_id, e.tag, e.node) for e in ts.adds) == \
        sorted((e.element_id, e.tag, e.node) for e in js.adds)
    assert ts.removes == js.removes
    assert ts.visible() == js.visible()
    assert ts.merkle_root() == js.merkle_root()
    assert tseed(ts.merkle_root()) == jseed(js.merkle_root())


def test_sparse_add_tag_matches_reference():
    c = _mixed(7)
    part = {"alpha": c["alpha"]}
    js = JState().add(_jax_tree(part), "n", leaf_paths=jhash.leaf_paths_of(
        _jax_tree(part)))
    tp = convert.from_numpy_tree(part, "cpu")
    ts = TState().add(tp, "n", leaf_paths=thash.leaf_paths_of(tp))
    assert [(e.tag, e.leaf_paths) for e in ts.adds] == \
        [(e.tag, e.leaf_paths) for e in js.adds]
    assert ts.merkle_root() == js.merkle_root()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flatten_order_and_keystr_match_jax(case):
    for c in CASES[case]():
        jflat, _ = jax.tree_util.tree_flatten_with_path(c)
        tflat, td = pytree.flatten_with_path(c)
        assert [pytree.keystr(p) for p, _ in tflat] == \
            [jax.tree_util.keystr(p) for p, _ in jflat]
        assert all(a is b for (_, a), (_, b) in zip(tflat, jflat))
        assert td.num_leaves == len(jflat)
        assert pytree.leaf_paths(td) == [pytree.keystr(p) for p, _ in tflat]
        back = td.unflatten([x for _, x in tflat])
        assert jax.tree_util.tree_structure(back) == \
            jax.tree_util.tree_structure(c)


@pytest.mark.parametrize("dtype", ["float64", "float32", "bfloat16",
                                   "int8", "int32", "bool"])
@pytest.mark.parametrize("shape", [(), (3,), (2, 3)])
def test_tensor_digest_matches_reference(dtype, shape):
    rng = np.random.default_rng(3)
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    a = (rng.standard_normal(shape) * 50).astype(dt)
    t = convert.from_numpy_tree(a, "cpu")
    assert thash.tensor_digest(t) == jhash.tensor_digest(a)


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_tensor_digests_prepared_leaves_in_order(monkeypatch, threads):
    """Exact: `tensor_digests(prepare=)` gives, in order and on any number
    of hashing threads, the reference's digest of each prepared leaf (an
    int8 payload's dequantization, as the planner takes it), and without
    `prepare` the digests of the leaves themselves."""
    from repro_torch.core.compression import compress_leaf, dequantize_leaf
    monkeypatch.setattr(thash, "_PREPARED_THREADS", threads)
    rng = np.random.default_rng(4)
    arrays = [rng.standard_normal(n).astype(np.float32)
              for n in (7, 300, 1, 64, 33)]
    leaves = [compress_leaf(convert.from_numpy_tree(a, "cpu"))
              for a in arrays]
    dense = [dequantize_leaf(leaf) for leaf in leaves]
    want = [jhash.tensor_digest(d.numpy()) for d in dense]
    assert thash.tensor_digests(leaves, prepare=dequantize_leaf) == want
    assert thash.tensor_digests(dense) == want


def _random_state(seed, contribs):
    rng = np.random.default_rng(seed)
    s = TState()
    for _ in range(5):
        i = int(rng.integers(len(contribs)))
        node = f"n{int(rng.integers(3))}"
        if rng.random() < 0.7 or not s.visible():
            s = s.add(contribs[i], node)
        else:
            s = s.remove(sorted(s.visible())[0], node)
    return s


@pytest.mark.parametrize("seed", range(4))
def test_or_set_laws_on_the_port(seed):
    contribs = [convert.from_numpy_tree(c, "cpu") for c in CASES["mixed"]()]
    a, b, c = (_random_state(seed * 3 + j, contribs) for j in range(3))
    assert a.merge(b) == b.merge(a)
    assert a.merge(b).merkle_root() == b.merge(a).merkle_root()
    assert a.merge(b).merge(c) == a.merge(b.merge(c))
    assert a.merge(a) == a and a.merge(a).merkle_root() == a.merkle_root()
    roots = {x.merge(y).merge(z).merkle_root()
             for x, y, z in itertools.permutations((a, b, c))}
    assert len(roots) == 1
