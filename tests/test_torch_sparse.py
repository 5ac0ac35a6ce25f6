"""Sparse contributions on the PyTorch port against the JAX reference.

Bitwise:
  * plans: every task's sub-root, contributor subset, digests, base
    fragment and stacked bytes, and the inherit-base leaves, for
    dense-only, mixed, all-sparse and int8-sparse contribution sets;
  * the sparse resolve of all 26 strategies x {fold, tree} against the
    port's own `sparse_reference_apply` (the engine-free definition), on
    the plain, trust-gated and hierarchical paths;
  * an uncovered leaf's bytes against the base's;
  * the O(changed) re-resolve's accounting (executor stats, fold
    resumptions, the skipped-leaf gauge, `plan_needed_ids`) against the
    reference's on the same scenario;
  * roots, coverages and merged bytes over 20 delivery orders;
  * `IncrementalMean` and the deprecated `resolve` shim.

Within tolerance: each resolve against the reference's `resolve_spec`
on the same state, within `TOL` of the output's magnitude or bitwise for
the linear family (the rule of tests/test_torch_trust_hier.py); the
kernel routes (their plain versions here) at k_i in {4, 5} in one plan
against the reference's `pallas=True` route, within the kernel tests'
limits (1e-6; 1e-5 absolute for int8, see tests/test_torch_quant_dare.py).
"""
import random
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.api import Replica as JReplica  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
import importlib  # noqa: E402
from repro.core.state import CRDTMergeState as JState  # noqa: E402
from repro.core.trust import TrustState as JTrust  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.engine import EngineCache  # noqa: E402
from repro_torch.core.hashing import pytree_digest  # noqa: E402
from repro_torch.core.merkle import merkle_root  # noqa: E402
from repro_torch.core.resolve import (  # noqa: E402
    canonical_order, IncrementalMean, reference_apply, resolve,
    resolve_spec, seed_from_root, sparse_reference_apply)
from repro_torch.core.state import CRDTMergeState  # noqa: E402
from repro_torch.core.trust import TrustState, gated_visible  # noqa: E402
from repro_torch.dtypes import dtype_name  # noqa: E402
from repro_torch.strategies import list_strategies  # noqa: E402

torch.set_num_threads(1)

# `repro.core` exports the function `resolve` under the module's name
jres = importlib.import_module("repro.core.resolve")

TOL = 2e-5
BITWISE = ("weight_average", "linear", "task_arithmetic", "negative_merge")
STRATEGIES = sorted(list_strategies())

P_W, P_EMB, P_LN = "['blk']['w']", "['emb']", "['ln']"
NAME_PATH = {"w": P_W, "emb": P_EMB, "ln": P_LN}


@pytest.fixture(autouse=True)
def _clear_caches():
    yield
    jeng.clear_cache()
    engine.clear_cache()


def _full(seed, dim=4):
    """Three leaves, one nested; one shape, so the reference compiles
    each of its ops once per stack height."""
    rng = np.random.default_rng(seed)
    return {"blk": {"w": rng.standard_normal((dim, dim)).astype(np.float32)},
            "emb": rng.standard_normal((dim, dim)).astype(np.float32),
            "ln": rng.standard_normal((dim, dim)).astype(np.float32)}


def _sub(tree, *names):
    out = {}
    for n in names:
        if n == "w":
            out.setdefault("blk", {})["w"] = tree["blk"]["w"]
        else:
            out[n] = tree[n]
    return out


def _t(tree):
    return convert.from_numpy_tree(tree, "cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _payload(seed, names):
    return _full(seed) if not names else _sub(_full(seed), *names)


def _paths(names):
    return [NAME_PATH[n] for n in names] if names else None


def _states(ops, eids=None):
    """The same adds on both packages: (seed, node, leaf names or ())."""
    s, j = CRDTMergeState(), JState()
    for n, (seed, node, names) in enumerate(ops):
        tree = _payload(seed, names)
        eid = eids[n] if eids else None
        s = s.add(_t(tree), node, element_id=eid, leaf_paths=_paths(names))
        j = j.add(_j(tree), node, element_id=eid, leaf_paths=_paths(names))
    assert s.merkle_root() == j.merkle_root()
    assert s.coverage() == j.coverage()
    return s, j


MIXED = [(0, "n0", ()), (1, "n1", ("emb",)), (2, "n2", ("ln", "w")),
         (3, "n3", ())]


@pytest.fixture(scope="module")
def mixed():
    s, j = _states(MIXED)
    base = _full(9)
    return s, j, _t(base), _j(base)


def _np_leaves(tree):
    return [np.asarray(a) for a in
            pytree.leaves(convert.to_numpy_tree(tree))]


def _jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _bytes_equal(a, b):
    la, lb = _np_leaves(a), _np_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape
        and x.tobytes() == y.tobytes() for x, y in zip(la, lb))


def _close(name, got, want):
    """Per leaf: bitwise for the linear family, else within TOL of the
    output's magnitude."""
    gl, wl = _np_leaves(got), _jleaves(want)
    assert len(gl) == len(wl), name
    for g, w in zip(gl, wl):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in BITWISE:
            assert g.tobytes() == w.tobytes(), name
            continue
        scale = max(1.0, float(np.max(np.abs(w))))
        err = float(np.max(np.abs(g.astype(np.float64) - w)))
        assert err <= TOL * scale, (name, err)


def _ordered(s):
    ids = canonical_order(s)
    cov = s.coverage()
    return ids, [s.store[i] for i in ids], [cov[i] for i in ids]


# ----------------------------------------------------------- plans ---


def _plan_case(case):
    """(port metas, reference metas, coverages, port base, ref base)."""
    base = _full(9)
    if case == "int8":
        trees = [_full(0), _sub(_full(1), "emb"), _sub(_full(2), "ln", "w")]
        jct = [jcomp.compress_tree(_j(t)) for t in trees]
        tct = [convert.from_numpy_compressed(c, "cpu") for c in jct]
        covs = [None, (P_EMB,), (P_W, P_LN)]
        return ([engine.contrib_meta(c) for c in tct],
                [jeng.contrib_meta(c) for c in jct], covs, _t(base),
                _j(base))
    ops = {"dense": [(0, "a", ()), (1, "b", ()), (2, "c", ())],
           "mixed": MIXED,
           "all_sparse": [(0, "a", ("emb",)), (1, "b", ("emb",)),
                          (2, "c", ("ln",))]}[case]
    s, j = _states(ops)
    ids, payloads, covs = _ordered(s)
    return ([engine.contrib_meta(p, eid=i) for p, i in zip(payloads, ids)],
            [jeng.contrib_meta(j.store[i], eid=i) for i in ids], covs,
            _t(base), _j(base))


@pytest.mark.parametrize("name", ["weight_average", "dare", "slerp"])
@pytest.mark.parametrize("case", ["dense", "mixed", "all_sparse", "int8"])
def test_plan_matches_reference_bytewise(case, name):
    metas, jmetas, covs, base, jbase = _plan_case(case)
    plan = engine.plan_merge(metas, name, base=base, seed=77,
                             coverages=covs)
    want = jeng.plan_merge(jmetas, name, base=jbase, seed=77,
                           coverages=covs)
    assert plan.k == want.k and plan.frag == want.frag
    assert plan.base_only == want.base_only
    assert plan.coverages == want.coverages
    assert len(plan.tasks) == len(want.tasks)
    for t, w in zip(plan.tasks, want.tasks):
        assert (t.index, t.path, t.sub_root, t.shape, t.contributors,
                t.digests, t.base_frag, t.stacked_nbytes) == \
            (w.index, w.path, w.sub_root, w.shape, w.contributors,
             w.digests, w.base_frag, w.stacked_nbytes)
        assert dtype_name(t.dtype) == str(w.dtype)
    if case == "all_sparse":
        assert plan.base_only == (0,)           # ['blk']['w'] uncovered


def test_plan_refusals_match_reference():
    """Every contribution sparse and no base; a coverage descriptor
    that is not the payload's paths; a leaf the model does not have."""
    s, j = _states([(0, "a", ("emb",)), (1, "b", ())])
    ids, payloads, covs = _ordered(s)
    sp, dn = covs.index((P_EMB,)), covs.index(None)
    m = [engine.contrib_meta(p, eid=i) for p, i in zip(payloads, ids)]
    jm = [jeng.contrib_meta(j.store[i], eid=i) for i in ids]
    odd = {"zz": np.ones(3, np.float32)}
    cases = [
        ("every contribution is sparse", [m[sp]], [jm[sp]], [(P_EMB,)]),
        ("does not match", m, jm,
         [(P_LN,) if c is not None else None for c in covs]),
        ("does not have", [engine.contrib_meta(_t(odd)), m[dn]],
         [jeng.contrib_meta(_j(odd)), jm[dn]], [("['zz']",), None]),
    ]
    for match, metas, jmetas, cv in cases:
        with pytest.raises(ValueError, match=match):
            engine.plan_merge(metas, "weight_average", coverages=cv)
        with pytest.raises(ValueError, match=match):
            jeng.plan_merge(jmetas, "weight_average", coverages=cv)


# -------------------------------------------------------- resolves ---


@pytest.mark.parametrize("reduction", ["fold", "tree"])
@pytest.mark.parametrize("name", STRATEGIES)
def test_sparse_resolve_all_strategies(name, reduction, mixed):
    s, j, base, jbase = mixed
    ids, payloads, covs = _ordered(s)
    seed = seed_from_root(s.merkle_root())
    want_self = sparse_reference_apply(name, payloads, covs, base=base,
                                       seed=seed, reduction=reduction)
    got = resolve_spec(s, MergeSpec(name, reduction=reduction), base=base,
                       use_cache=False)
    assert _bytes_equal(got, want_self), name
    want = jres.resolve_spec(j, JSpec(name, reduction=reduction),
                             base=jbase, use_cache=False)
    _close(name, got, want)


@pytest.mark.parametrize("reduction", ["fold", "tree"])
def test_sparse_gated_all_strategies(reduction, mixed):
    s, j, base, jbase = mixed
    bad = sorted(s.visible())[2]
    t = TrustState().report(bad, "equivocation", "n0")
    jt = JTrust().report(bad, "equivocation", "n0")
    ids = sorted(gated_visible(s, t, 0.5))
    assert bad not in ids and len(ids) == 3
    cov = s.coverage()
    seed = seed_from_root(merkle_root([bytes.fromhex(i) for i in ids]))
    for name in STRATEGIES:
        spec = MergeSpec(name, reduction=reduction, trust_threshold=0.5)
        got = resolve_spec(s, spec, base=base, trust=t, use_cache=False)
        want_self = sparse_reference_apply(
            name, [s.store[i] for i in ids], [cov[i] for i in ids],
            base=base, seed=seed, reduction=reduction)
        assert _bytes_equal(got, want_self), name
        want = jres.resolve_spec(
            j, JSpec(name, reduction=reduction, trust_threshold=0.5),
            base=jbase, trust=jt, use_cache=False)
        _close(name, got, want)


@pytest.mark.parametrize("reduction", ["fold", "tree"])
def test_sparse_hierarchical_all_strategies(reduction, mixed):
    """Groups of two over the canonical order resolve sparse first; the
    dense group outputs merge with seed + 1."""
    s, j, base, jbase = mixed
    ids, payloads, covs = _ordered(s)
    seed = seed_from_root(s.merkle_root())
    for name in STRATEGIES:
        if name == "slerp":
            # a leaf covered once in a group meets slerp at k = 1, which
            # both packages refuse (the reference with an assert)
            with pytest.raises(ValueError, match="binary"):
                resolve_spec(s, MergeSpec(name, group_size=2), base=base,
                             use_cache=False)
            with pytest.raises(AssertionError, match="binary"):
                jres.resolve_spec(j, JSpec(name, group_size=2),
                                  base=jbase, use_cache=False)
            continue
        got = resolve_spec(s, MergeSpec(name, reduction=reduction,
                                        group_size=2),
                           base=base, use_cache=False)
        firsts = [sparse_reference_apply(
            name, payloads[g:g + 2], covs[g:g + 2], base=base, seed=seed,
            reduction=reduction) for g in range(0, len(ids), 2)]
        want_self = reference_apply(name, firsts, base=base, seed=seed + 1,
                                    reduction=reduction)
        assert _bytes_equal(got, want_self), name
        want = jres.resolve_spec(
            j, JSpec(name, reduction=reduction, group_size=2), base=jbase,
            use_cache=False)
        _close(name, got, want)


def test_uncovered_leaf_inherits_base_bytes():
    s, j = _states([(0, "a", ("emb",)), (1, "b", ("emb",))])
    base = _full(9)
    got = resolve_spec(s, MergeSpec("ties"), base=_t(base), use_cache=False)
    want = jres.resolve_spec(j, JSpec("ties"), base=_j(base),
                             use_cache=False)
    assert _np_leaves(got)[0].tobytes() == base["blk"]["w"].tobytes()
    assert _np_leaves(got)[2].tobytes() == base["ln"].tobytes()
    assert _np_leaves(got)[1].tobytes() != base["emb"].tobytes()
    _close("ties", got, want)
    with pytest.raises(ValueError, match="base"):
        resolve_spec(s, MergeSpec("weight_average"), use_cache=False)
    with pytest.raises(ValueError, match="base"):
        resolve_spec(s, MergeSpec("star"), use_cache=False)


def test_untouched_leaves_keep_the_dense_merge():
    base = _t(_full(9))
    s, _ = _states([(0, "n0", ()), (1, "n1", ())])
    dense = resolve_spec(s, MergeSpec("weight_average"), base=base,
                         use_cache=False)
    s2, _ = _states([(0, "n0", ()), (1, "n1", ()), (2, "n2", ("emb",))])
    mixed_out = resolve_spec(s2, MergeSpec("weight_average"), base=base,
                             use_cache=False)
    assert torch.equal(dense["ln"], mixed_out["ln"])
    assert torch.equal(dense["blk"]["w"], mixed_out["blk"]["w"])
    assert not torch.equal(dense["emb"], mixed_out["emb"])


# ------------------------------------------------ O(changed) re-resolve ---


def _ctrl_eid(prefix):
    import hashlib
    return prefix + hashlib.sha256(prefix.encode()).hexdigest()[:62]


def _warm(strategy):
    """Three dense contributions resolved warm on both packages, then a
    sparse one (emb only) whose eid appends to the canonical order."""
    ops = [(0, "n0", ()), (1, "n1", ()), (2, "n2", ())]
    eids = [_ctrl_eid(p) for p in ("aa", "bb", "cc")]
    s, j = _states(ops, eids)
    base = _full(9)
    cache, jcache = EngineCache(), jeng.EngineCache()
    resolve_spec(s, MergeSpec(strategy), base=_t(base), cache=cache)
    jres.resolve_spec(j, JSpec(strategy), base=_j(base), cache=jcache)
    sub = _sub(_full(7), "emb")
    s2 = s.add(_t(sub), "n3", element_id=_ctrl_eid("ff"),
               leaf_paths=[P_EMB])
    j2 = j.add(_j(sub), "n3", element_id=_ctrl_eid("ff"),
               leaf_paths=[P_EMB])
    return s2, j2, base, cache, jcache


@pytest.mark.parametrize("strategy", ["weight_average", "ties"])
def test_sparse_append_re_resolves_o_changed(strategy):
    s2, j2, base, cache, jcache = _warm(strategy)
    cache.reset_exec_stats()
    jcache.reset_exec_stats()
    got = resolve_spec(s2, MergeSpec(strategy), base=_t(base), cache=cache)
    want = jres.resolve_spec(j2, JSpec(strategy), base=_j(base),
                             cache=jcache)
    stats, jstats = cache.exec_stats(), jcache.exec_stats()
    assert stats == jstats
    assert stats["hits"] == 2 and stats["misses"] == 1
    assert stats.get("fold_resumes", 0) == (strategy == "weight_average")
    for c in (cache, jcache):
        assert c.obs.gauge("engine_sparse_leaves_skipped").value() == 2.0
    assert cache.obs.counter("resolve_fold_updates_total").value() == \
        jcache.obs.counter("resolve_fold_updates_total").value()
    ids, payloads, covs = _ordered(s2)
    assert _bytes_equal(got, sparse_reference_apply(
        strategy, payloads, covs, base=_t(base),
        seed=seed_from_root(s2.merkle_root())))
    _close(strategy, got, want)


def test_plan_needed_ids_narrows_as_the_reference():
    s2, j2, base, cache, jcache = _warm("weight_average")
    ids, payloads, covs = _ordered(s2)
    seed = seed_from_root(s2.merkle_root())
    plan = engine.plan_merge(
        [engine.contrib_meta(p, eid=i) for p, i in zip(payloads, ids)],
        base=_t(base), seed=seed, spec=MergeSpec("weight_average"),
        coverages=covs)
    jplan = jeng.plan_merge(
        [jeng.contrib_meta(j2.store[i], eid=i) for i in ids],
        base=_j(base), seed=seed, spec=JSpec("weight_average"),
        coverages=covs)
    assert engine.plan_needed_ids(plan, cache) == \
        jeng.plan_needed_ids(jplan, jcache) == (3,)
    assert engine.plan_needed_ids(plan, cache, use_cache=False) == \
        jeng.plan_needed_ids(jplan, jcache, use_cache=False) == (0, 1, 2, 3)


# ------------------------------------------------- delivery orders ---


def test_convergence_20_orderings_mixed_dense_sparse():
    base = _full(9)
    specs = [(1, "n1", ()), (2, "n2", ("emb",)), (3, "n3", ("ln", "w")),
             (4, "n4", ("emb",))]
    deltas, jdeltas = [], []
    d_add = CRDTMergeState().add(_t(_full(0)), "n0")
    jd_add = JState().add(_j(_full(0)), "n0")
    removed = next(iter(d_add.visible()))
    deltas.append(d_add.remove(removed, "n0"))
    jdeltas.append(jd_add.remove(removed, "n0"))
    for op in specs:
        s, j = _states([op])
        deltas.append(s)
        jdeltas.append(j)
    rng = random.Random(42)
    first = None
    for _ in range(20):
        order = rng.sample(range(len(deltas)), len(deltas))
        acc, jacc = CRDTMergeState(), JState()
        for i in order:
            acc, jacc = acc.merge(deltas[i]), jacc.merge(jdeltas[i])
        out = resolve_spec(acc, MergeSpec("ties"), base=_t(base),
                           use_cache=False)
        assert acc.merkle_root() == jacc.merkle_root()
        assert acc.coverage() == jacc.coverage()
        if first is None:
            first = (acc, out)
            assert removed not in acc.visible()
            _close("ties", out, jres.resolve_spec(
                jacc, JSpec("ties"), base=_j(base), use_cache=False))
        assert acc.merkle_root() == first[0].merkle_root()
        assert acc.visible_per_leaf() == first[0].visible_per_leaf()
        assert acc.coverage() == first[0].coverage()
        assert _bytes_equal(out, first[1])


# ---------------------------------------------------- kernel routes ---


def _kernel_model(seed):
    """One big leaf (alone in its dispatch group: the exact path) and
    four small ones that fuse in pairs."""
    rng = np.random.default_rng(seed)
    return {"big": rng.standard_normal(1024).astype(np.float32),
            "s1": rng.standard_normal(256).astype(np.float32),
            "s2": rng.standard_normal(200).astype(np.float32),
            "d1": rng.standard_normal(256).astype(np.float32),
            "d2": rng.standard_normal(300).astype(np.float32)}


def _kernel_case(quantized):
    """Four dense contributions and one sparse update of s1, s2 (k_i = 5
    there, 4 elsewhere), canonical order, on both packages."""
    base = _kernel_model(50)
    trees = [jax.tree_util.tree_map(lambda b, d: b + 0.1 * d, base,
                                    _kernel_model(51 + n)) for n in range(4)]
    upd = _kernel_model(60)
    trees.append({"s1": base["s1"] + 0.1 * upd["s1"],
                  "s2": base["s2"] + 0.1 * upd["s2"]})
    covs = [None] * 4 + [("['s1']", "['s2']")]
    ids = [pytree_digest(_t(t)).hex() for t in trees]
    order = sorted(range(5), key=lambda n: ids[n])
    trees = [trees[n] for n in order]
    covs = [covs[n] for n in order]
    ids = [ids[n] for n in order]
    if quantized:
        jp = [jcomp.compress_tree(_j(t)) for t in trees]
        tp = [convert.from_numpy_compressed(c, "cpu") for c in jp]
        ids = ["int8:" + i for i in ids]
    else:
        jp, tp = [_j(t) for t in trees], [_t(t) for t in trees]
    return tp, jp, covs, ids, base


KERNEL_CASES = {
    "weight_average": ("nary_accum", {}, False, False),
    "task_arithmetic": ("nary_accum", {"lam": 1.0}, True, False),
    "ties": ("ties_hist", {"trim": 0.2, "trim_method": "histogram"}, True,
             False),
    "int8 weight_average": ("quant_nary", {}, False, True),
    "int8 task_arithmetic": ("quant_nary", {"lam": 1.0}, True, True),
}


@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_kernel_routes_at_mixed_k(case):
    kernel, cfg, uses_base, quantized = KERNEL_CASES[case]
    name = case.split()[-1]
    tp, jp, covs, ids, base = _kernel_case(quantized)
    cache, jcache = EngineCache(), jeng.EngineCache()
    got = engine.merge(tp, spec=MergeSpec(name, cfg), contrib_ids=ids,
                       base=_t(base) if uses_base else None, seed=3,
                       kernels=True, use_cache=False, coverages=covs,
                       cache=cache)
    want = jeng.merge(jp, spec=JSpec(name, cfg), contrib_ids=ids,
                      base=_j(base) if uses_base else None, seed=3,
                      pallas=True, use_cache=False, coverages=covs,
                      cache=jcache)
    # a k = 5 group (s1, s2) and a k = 4 group (d1, d2) per merge
    for c in (cache, jcache):
        assert c.obs.counter("kernel_dispatch_total").value(
            kernel=kernel) == 2
    atol = 1e-5 if quantized else 1e-6
    for g, w in zip(_np_leaves(got), _jleaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=atol)
    if quantized:
        assert cache.obs.counter(
            "engine_quant_leaves_merged_total").value() == 4


# ------------------------------------------------- IncrementalMean ---


def test_incremental_mean_matches_reference():
    trees = [_full(n) for n in range(5)]
    s, j = CRDTMergeState(), JState()
    for n, t in enumerate(trees):
        s = s.add(_t(t), f"n{n}")
        j = j.add(_j(t), f"n{n}")
    ids = canonical_order(s)
    im, jim = IncrementalMean(), jres.IncrementalMean()
    # out-of-order arrivals, then a sync to canonical order
    for eid in ids[::-1][:3]:
        im.add(eid, s.store[eid])
        jim.add(eid, j.store[eid])
    assert _bytes_equal(im.value(), _t(jax.tree_util.tree_map(
        np.asarray, jim.value())))
    assert im.sync(s) and jim.sync(j)
    assert not im.sync(s) and im.count() == jim.count() == 5
    assert _bytes_equal(im.value(), _t(jax.tree_util.tree_map(
        np.asarray, jim.value())))
    assert _bytes_equal(im.value(), resolve_spec(
        s, MergeSpec("weight_average"), use_cache=False))
    # a retraction drops the id on the next sync
    s2, j2 = s.remove(ids[1], "n0"), j.remove(ids[1], "n0")
    assert im.sync(s2) and jim.sync(j2) and im.count() == 4
    assert _bytes_equal(im.value(), _t(jax.tree_util.tree_map(
        np.asarray, jim.value())))
    bare = CRDTMergeState(s2.adds, s2.removes, s2.vv, {})
    with pytest.raises(KeyError, match="lacks payloads"):
        im.sync(bare)
    with pytest.raises(ValueError, match="no contributions"):
        IncrementalMean().value()


# ------------------------------------------------------------ shim ---


def test_resolve_shim_warns_and_equals_resolve_spec(mixed):
    s, j, base, jbase = mixed
    with pytest.warns(DeprecationWarning, match="deprecated"):
        got = resolve(s, "ties", base, trim=0.3, use_cache=False)
    want = resolve_spec(s, MergeSpec("ties", {"trim": 0.3}), base=base,
                        use_cache=False)
    assert _bytes_equal(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = resolve(s, MergeSpec("ties", {"trim": 0.3}), base,
                        use_cache=False)
    assert _bytes_equal(again, want)
    with pytest.warns(DeprecationWarning):
        jwant = jres.resolve(j, "ties", jbase, trim=0.3, use_cache=False)
    _close("ties", got, jwant)


# --------------------------------------------------------- Replica ---


def test_replica_sparse_adds_across_replicas():
    base = _full(9)
    a, b = Replica("a", device="cpu"), Replica("b", device="cpu")
    ja, jb = JReplica("a"), JReplica("b")
    ref = a.register_base(_t(base))
    assert ref == ja.register_base(_j(base))
    b.register_base(_t(base))
    jb.register_base(_j(base))
    a.contribute(_t(_full(0)))
    ja.contribute(_j(_full(0)))
    sub = _sub(_full(1), "emb")
    eid = a.add(_t(sub), leaves=[P_EMB])
    assert eid == ja.add(_j(sub), leaves=[P_EMB])
    assert a.state.coverage()[eid] == (P_EMB,)
    lw = _sub(_full(2), "ln", "w")
    b.contribute(_t(lw), leaves=[P_LN, P_W])
    jb.contribute(_j(lw), leaves=[P_LN, P_W])
    a.merge(b)
    b.merge(a)
    ja.merge(jb)
    assert a.merkle_root() == b.merkle_root() == ja.merkle_root()
    spec = MergeSpec("weight_average", base_ref=ref)
    out_a, out_b = a.resolve(spec), b.resolve(spec)
    assert _bytes_equal(out_a, out_b)
    ids, payloads, covs = _ordered(a.state)
    assert _bytes_equal(out_a, sparse_reference_apply(
        "weight_average", payloads, covs, base=_t(base),
        seed=seed_from_root(a.merkle_root())))
    _close("weight_average", out_a,
           ja.resolve(JSpec("weight_average", base_ref=ref)))
