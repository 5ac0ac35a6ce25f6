"""The engine's module-level cache API (A4's rest) against the JAX
reference, on the CPU: `default_cache`, `set_cache_limit`, `cache_info`,
`reset_cache_limits`, `cached`, `cache_lookup`, `plan_cached_split`,
`exec_stats` / `reset_exec_stats`, `EngineCache.lookup` (a hit counted,
never a miss) and `EngineCache.split` (membership only), and the int8
scales the planner threads (`ContribMeta.scale_of`,
`LeafTask.quantized`).

`benchmarks/bench_merge_engine.py`'s scenario (lines 88-131) runs on
both packages at a small size: every `exec_stats` counter after the
bounded-memory merge and after the warm re-resolve equals the
reference's, and the outputs equal the port's legacy path bitwise. The
values are not compared across the packages (ties' quantile and sums
are held to tolerances elsewhere); counters, limits and scales are
compared exactly.
"""
import hashlib
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.state import CRDTMergeState as JState  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch.api import MergeSpec  # noqa: E402
from repro_torch.core import compression, engine  # noqa: E402
from repro_torch.core.state import CRDTMergeState  # noqa: E402

# the modules (each package's `core` exports a `resolve` function too)
jres = importlib.import_module("repro.core.resolve")
res = importlib.import_module("repro_torch.core.resolve")

torch.set_num_threads(1)

LEAVES, DIM, K, CHANGED = 12, 16, 4, 3


def _eid(prefix: str) -> str:
    return prefix + hashlib.sha256(prefix.encode()).hexdigest()[:62]


def _arrays(seed, bump=()):
    r = np.random.default_rng(seed)
    t = {f"l{i:03d}": r.standard_normal((DIM, DIM)).astype(np.float32)
         for i in range(LEAVES)}
    for i in bump:
        t[f"l{i:03d}"] = t[f"l{i:03d}"] + np.float32(0.5)
    return t


def _jmodel(seed, bump=()):
    return {k: jnp.asarray(v) for k, v in _arrays(seed, bump).items()}


def _tmodel(seed, bump=()):
    return {k: torch.from_numpy(v) for k, v in _arrays(seed, bump).items()}


def _states(cls, model, seed0=0):
    s = cls()
    for j in range(K):
        s = s.add(model(seed0 + j), node=f"n{j}",
                  element_id=_eid(f"{j:02x}"))
    return s


def _scenario(eng, resmod, spec_cls, state_cls, model, strategy):
    """bench_merge_engine.run's steps; returns (counters after the
    bounded-memory merge, counters after the warm re-resolve, cold and
    warm outputs, the updated state)."""
    eng.reset_exec_stats()
    eng.clear_cache()
    eng.merge([model(100 + j) for j in range(K)], "weight_average",
              use_cache=False)
    first = eng.exec_stats()
    s = _states(state_cls, model)
    eng.clear_cache()
    resmod.resolve(_states(state_cls, model, seed0=500), spec_cls(strategy),
                   use_cache=False)
    eng.clear_cache()
    cold = resmod.resolve(s, spec_cls(strategy))
    last = f"{K - 1:02x}"
    s2 = s.remove(_eid(last), f"n{K - 1}").add(
        model(K - 1, bump=tuple(range(CHANGED))), node=f"n{K - 1}",
        element_id=_eid(last[:1] + "f"))
    eng.reset_exec_stats()
    warm = resmod.resolve(s2, spec_cls(strategy))
    second = eng.exec_stats()
    return first, second, cold, warm, s2


@pytest.mark.parametrize("strategy", ["ties", "weight_average"])
def test_bench_merge_engine_scenario_counters(strategy):
    jfirst, jsecond, *_ = _scenario(jeng, jres, JSpec, JState, _jmodel,
                                    strategy)
    first, second, cold, warm, s2 = _scenario(
        engine, res, MergeSpec, CRDTMergeState, _tmodel, strategy)
    try:
        assert first == jfirst
        assert second == jsecond
        assert second["leaf_tasks"] == CHANGED
        assert first["peak_stacked_bytes"] <= 2 * K * DIM * DIM * 4
        ids = res.canonical_order(s2)
        legacy = res.reference_apply(
            strategy, [s2.store[i] for i in ids],
            seed=res.seed_from_root(s2.merkle_root()))
        assert all(torch.equal(a, b) for a, b in
                   zip(pytree.leaves(warm), pytree.leaves(legacy)))
    finally:
        engine.clear_cache()
        jeng.clear_cache()


def test_default_cache_limits_and_info():
    for eng in (engine, jeng):
        assert eng.default_cache() is eng.default_cache()
        eng.set_cache_limit(entries=8, bytes=1 << 20)
        info = eng.cache_info()
        assert (info.entry_limit, info.byte_limit) == (8, 1 << 20)
        eng.set_cache_limit(bytes=1 << 10)       # entries unchanged
        assert eng.cache_info().entry_limit == 8
        with pytest.raises(ValueError):
            eng.set_cache_limit(entries=0)
        eng.reset_cache_limits()
    assert tuple(engine.cache_info())[2:4] == tuple(jeng.cache_info())[2:4]


def test_lookup_and_split_semantics():
    """`lookup` counts a hit and no miss; `split` and `cached` read
    membership only: no counter moves and no entry's recency."""
    c = engine.EngineCache(entries=2)
    assert c.lookup(b"a") is None
    assert c.exec_stats().get("misses", 0) == 0
    c.put(b"a", 1, 4)
    c.put(b"b", 2, 4)
    assert c.lookup(b"a") == 1 and c.exec_stats()["hits"] == 1
    contribs = [_tmodel(j) for j in range(2)]
    plan = engine.plan_for(contribs, "weight_average")
    engine.clear_cache()
    engine.reset_exec_stats()
    hits, misses = engine.plan_cached_split(plan)
    assert hits == [] and len(misses) == LEAVES
    engine.merge(contribs, "weight_average")
    engine.reset_exec_stats()
    hits, misses = engine.plan_cached_split(plan)
    assert len(hits) == LEAVES and misses == []
    assert all(engine.cached(t.sub_root) for t in hits)
    assert engine.exec_stats() == {"peak_stacked_bytes": 0}
    # a split does not bump recency: the first task is still evicted first
    cache = engine.default_cache()
    order = list(cache._data)
    engine.plan_cached_split(plan)
    assert list(cache._data) == order
    engine.clear_cache()


def test_scales_and_quantized_tasks_match_reference():
    """int8 contributions: each meta's per-leaf scales equal the
    reference's floats; a plan over two int8 and one dense contribution
    threads per-contributor scales into its tasks, `quantized` only
    where every contributor is int8."""
    arrays = [_arrays(j) for j in range(3)]
    jc = [jcomp.compress_tree({k: jnp.asarray(v) for k, v in a.items()})
          for a in arrays[:2]]
    tc = [compression.compress_tree(pytree.tree_map(torch.from_numpy, a))
          for a in arrays[:2]]
    jm = [jeng.contrib_meta(c) for c in jc]
    tm = [engine.contrib_meta(c) for c in tc]
    for a, b in zip(jm, tm):
        assert a.scales == b.scales and len(b.scales) == LEAVES
        assert all(b.scale_of(i) == a.scale_of(i) for i in range(LEAVES))
    dense = pytree.tree_map(torch.from_numpy, arrays[2])
    assert engine.contrib_meta(dense).scales is None
    assert engine.contrib_meta(dense).scale_of(0) is None
    for contribs, jcontribs, want in (
            (tc, jc, True),
            (tc + [dense], jc + [{k: jnp.asarray(v)
                                  for k, v in arrays[2].items()}], False)):
        plan = engine.plan_for(contribs, "weight_average")
        jplan = jeng.plan_for(jcontribs, "weight_average")
        for t, jt in zip(plan.tasks, jplan.tasks):
            assert t.scales == jt.scales and t.quantized == jt.quantized
            assert t.quantized is want
            assert t.stacked_nbytes == jt.stacked_nbytes
    engine.clear_cache()
    jeng.clear_cache()
    # a manifest-announced int8 leaf keeps its scale
    meta = engine.note_meta("ab" * 32, ["['w']"], [b"\0" * 32], [(2, 2)],
                            ["float32"], scales=[0.5])
    assert meta.scale_of(0) == 0.5
    engine.clear_meta_memo()
