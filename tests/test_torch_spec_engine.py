"""MergeSpec and the merge engine of the PyTorch port.

Bitwise against the JAX reference: spec encodings, digests and cache
fragments, and the planner's per-leaf sub-roots (all SHA-256 over
canonical bytes). Bitwise within the port: the engine against the
port's own whole-tree `reference_apply`, and across contribution
orders. Against the reference's engine output, each case states
whether it is bitwise or held to a tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api.spec import MergeSpec as JSpec  # noqa: E402
from repro.api.spec import SpecError as JSpecError  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.kernels.config import kernel_env as jkernel_env  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.api import MergeSpec, Replica, SpecError  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.resolve import reference_apply  # noqa: E402
from repro_torch.strategies import get_strategy  # noqa: E402

torch.set_num_threads(1)

# the five ported strategies with non-default cfgs (ties twice: both
# trims)
SPECS = {
    "weight_average": {},
    "linear": {"t": 0.3},
    "task_arithmetic": {"lam": 0.7},
    "negative_merge": {"lam": 0.25},
    "ties": {"trim": 0.3},
    "ties_hist": {"trim": 0.3, "trim_method": "histogram"},
}


def _strategy(key):
    return "ties" if key.startswith("ties") else key


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jkernel_env.reset()
    jeng.clear_cache()
    jeng.reset_exec_stats()
    engine.clear_cache()


def _contribs(k=4, seed=0, dtype=np.float32):
    """k contributions (base + small delta) and the base, numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"emb": (37, 8), "blk": {"w": (8, 16), "b": (16,)},
              "norm": (5,)}
    base = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda x: isinstance(x, tuple))
    cs = [jax.tree_util.tree_map(
        lambda b: (b + 0.05 * rng.standard_normal(b.shape)).astype(
            np.float32), base) for _ in range(k)]
    cast = lambda t: jax.tree_util.tree_map(lambda a: a.astype(dtype), t)
    return [cast(c) for c in cs], cast(base)


@pytest.mark.parametrize("reduction", ["fold", "tree"])
@pytest.mark.parametrize("key", sorted(SPECS))
def test_spec_bytes_match_reference(key, reduction):
    ref = "ab" * 32
    t = MergeSpec(_strategy(key), SPECS[key], reduction=reduction,
                  base_ref=ref)
    j = JSpec(_strategy(key), SPECS[key], reduction=reduction, base_ref=ref)
    assert t.encode() == j.encode()
    assert t.digest() == j.digest()
    for wr in (True, False):
        assert t.cache_fragment(wr) == j.cache_fragment(wr)
    assert MergeSpec.decode(j.encode()) == t


def test_spec_validation_matches_reference():
    for bad in ({"tirm": 0.2}, {"trim": "x"}):
        with pytest.raises(JSpecError):
            JSpec("ties", bad)
        with pytest.raises(SpecError):
            MergeSpec("ties", bad)
    # the whole-model strategies validate as the reference's do
    for bad in ({"keep_frac": "x"}, {"pop": 1.5}):
        name = "star" if "keep_frac" in bad else "evolutionary_merge"
        with pytest.raises(JSpecError):
            JSpec(name, bad)
        with pytest.raises(SpecError):
            MergeSpec(name, bad)


@pytest.mark.parametrize("with_base", [False, True])
@pytest.mark.parametrize("key", sorted(SPECS))
def test_plan_subroots_match_reference(key, with_base):
    cs, base = _contribs()
    spec_t = MergeSpec(_strategy(key), SPECS[key])
    spec_j = JSpec(_strategy(key), SPECS[key])
    tb = convert.from_numpy_tree(base, "cpu") if with_base else None
    jb = jax.tree_util.tree_map(jnp.asarray, base) if with_base else None
    tplan = engine.plan_for([convert.from_numpy_tree(c, "cpu") for c in cs],
                            spec=spec_t, base=tb, seed=12345)
    jplan = jeng.plan_for([jax.tree_util.tree_map(jnp.asarray, c)
                           for c in cs], spec=spec_j, base=jb, seed=12345)
    assert [(t.index, t.path, t.sub_root) for t in tplan.tasks] == \
        [(t.index, t.path, t.sub_root) for t in jplan.tasks]


def _leaves_np(tree):
    return [np.asarray(a) for a in pytree.leaves(convert.to_numpy_tree(tree))]


@pytest.mark.parametrize("reduction", ["fold", "tree"])
@pytest.mark.parametrize("key", sorted(SPECS))
def test_engine_equals_reference_apply(key, reduction):
    """Bitwise, within the port: the engine's batched, planned execution
    against the whole-tree definition."""
    cs, base = _contribs(seed=1)
    tc = [convert.from_numpy_tree(c, "cpu") for c in cs]
    tb = convert.from_numpy_tree(base, "cpu")
    spec = MergeSpec(_strategy(key), SPECS[key], reduction=reduction)
    want = reference_apply(spec.strategy, tc, base=tb, seed=9,
                           reduction=reduction, **spec.cfg_dict())
    for use_cache in (False, True, True):       # cold, fill, warm hit
        got = engine.merge(tc, spec=spec, base=tb, seed=9,
                           use_cache=use_cache, cache=engine.EngineCache())
        for a, b in zip(pytree.leaves(got), pytree.leaves(want)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("key", sorted(SPECS))
def test_engine_matches_reference_engine(key, dtype):
    """Against `repro.core.engine.merge`. Exact path: bitwise — every
    ported strategy repeats JAX's op order (index-ordered k sums, JAX's
    dtype for scalars, true divisions). Kernel path (`kernels=True`
    against `pallas=True`, the port's plain versions on the CPU against
    Pallas in interpret mode): bitwise, except task_arithmetic within
    one fp32 ulp of accumulation, because XLA contracts its Pallas tile's
    w * (x - base) + acc into an FMA where the port rounds twice."""
    dt = ml_dtypes.bfloat16 if dtype == "bfloat16" else np.float32
    cs, base = _contribs(seed=2, dtype=dt)
    spec_t = MergeSpec(_strategy(key), SPECS[key])
    spec_j = JSpec(_strategy(key), SPECS[key])
    tc = [convert.from_numpy_tree(c, "cpu") for c in cs]
    tb = convert.from_numpy_tree(base, "cpu")
    jc = [jax.tree_util.tree_map(jnp.asarray, c) for c in cs]
    jb = jax.tree_util.tree_map(jnp.asarray, base)
    for flag in (False, True):
        got = _leaves_np(engine.merge(tc, spec=spec_t, base=tb, seed=5,
                                      kernels=flag, use_cache=False))
        want = [np.asarray(a) for a in jax.tree_util.tree_leaves(
            jeng.merge(jc, spec=spec_j, base=jb, seed=5, pallas=flag,
                       use_cache=False))]
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            if flag and key == "task_arithmetic":
                tol = 1e-6 if dtype == "float32" else 2.0 ** -7
                np.testing.assert_allclose(a.astype(np.float32),
                                           b.astype(np.float32),
                                           rtol=tol, atol=1e-6)
            else:
                assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("key", sorted(SPECS))
def test_contribution_order_gives_identical_bytes(key):
    """Three delivery orders, one converged state: identical bytes."""
    cs, base = _contribs(seed=3)
    outs = []
    for perm in ([0, 1, 2, 3], [3, 1, 0, 2], [2, 3, 1, 0]):
        rep = Replica("r", device="cpu")
        for i in perm:
            rep.contribute(convert.from_numpy_tree(cs[i], "cpu"))
        ref = rep.register_base(convert.from_numpy_tree(base, "cpu"))
        outs.append(rep.resolve(MergeSpec(_strategy(key), SPECS[key],
                                          base_ref=ref)))
    for other in outs[1:]:
        for a, b in zip(pytree.leaves(outs[0]), pytree.leaves(other)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("key", ["weight_average", "task_arithmetic",
                                 "negative_merge", "linear"])
def test_fold_resumption_is_bitwise(key):
    """A warm cache resumes the fold from the cached prefix, bit-equal to
    the cold recompute (linear resumes only from k >= 3)."""
    cs, base = _contribs(k=5, seed=4)
    tc = [convert.from_numpy_tree(c, "cpu") for c in cs]
    tb = convert.from_numpy_tree(base, "cpu")
    spec = MergeSpec(key, SPECS[key])
    cache = engine.EngineCache()
    engine.merge(tc[:4], spec=spec, base=tb, cache=cache)
    warm = engine.merge(tc, spec=spec, base=tb, cache=cache)
    cold = engine.merge(tc, spec=spec, base=tb, use_cache=False)
    assert cache.stats["fold_resumes"] == len(pytree.leaves(warm))
    for a, b in zip(pytree.leaves(warm), pytree.leaves(cold)):
        assert torch.equal(a, b)


def test_kernel_outputs_never_enter_the_cache():
    cs, base = _contribs(seed=5)
    tc = [convert.from_numpy_tree(c, "cpu") for c in cs]
    cache = engine.EngineCache()
    engine.merge(tc, spec=MergeSpec("weight_average"), kernels=True,
                 cache=cache)
    assert cache.info().entries == 1          # the exact-path singleton
    assert cache.obs.counter("kernel_dispatch_total").value(
        kernel="nary_accum") == 1


def test_unported_paths_raise():
    """What still raises: an absent payload (fetch-on-resolve, A6).
    Sparse contributions (A4) resolve since slice 8, on the plain, gated
    and hierarchical paths alike: bitwise equal to the port's
    `sparse_reference_apply` (the gated one over the gated ids with
    their seed)."""
    from repro_torch.core.merkle import merkle_root
    from repro_torch.core.resolve import (
        canonical_order, seed_from_root, sparse_reference_apply)
    cs, base = _contribs(seed=6)
    tc = [convert.from_numpy_tree(c, "cpu") for c in cs]
    assert get_strategy("svd_knot_tying").whole_model
    rep = Replica("r", device="cpu")
    for c in tc:
        rep.contribute(c)
    stored = dict(rep.state.store)
    rep.state.store.pop(sorted(stored)[0])
    with pytest.raises(KeyError, match="A6"):
        rep.resolve(MergeSpec("svd_knot_tying"))
    rep.state.store.update(stored)
    ref = rep.register_base(convert.from_numpy_tree(base, "cpu"))
    sub = {"emb": tc[0]["emb"] + 1.0}
    eid = rep.add(sub, leaves=["['emb']"])
    cov = rep.state.coverage()
    ids = canonical_order(rep.state)
    kept = [i for i in ids if i != eid]
    for spec, sel in ((MergeSpec("ties", base_ref=ref), ids),
                      (MergeSpec("weight_average", base_ref=ref), ids),
                      (MergeSpec("ties", base_ref=ref, trust_threshold=0.5),
                       kept)):
        if spec.trust_threshold is not None:
            rep.report(eid, "equivocation")
            seed = seed_from_root(merkle_root(
                [bytes.fromhex(i) for i in sel]))
        else:
            seed = seed_from_root(rep.merkle_root())
        want = sparse_reference_apply(
            spec.strategy, [rep.state.store[i] for i in sel],
            [cov[i] for i in sel], base=rep._bases[ref], seed=seed)
        got = rep.resolve(spec, use_cache=False)
        for g, w in zip(pytree.leaves(got), pytree.leaves(want)):
            assert torch.equal(g, w), spec
    grouped = rep.resolve(MergeSpec("ties", base_ref=ref, group_size=2),
                          use_cache=False)
    assert [tuple(t.shape) for t in pytree.leaves(grouped)] == \
        [tuple(t.shape) for t in pytree.leaves(tc[0])]
