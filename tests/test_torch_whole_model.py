"""The whole-model slice of the PyTorch port against the JAX reference.

Bitwise: `random.split`, ranged `uniform`, `normal` (fp32, bf16, and
float64 under `jax.enable_x64(True)`), the port's `erf_inv` / `log1p`
against `jax.lax.erf_inv` / `jnp.log1p`, the medians against
`jnp.median` (ties, +-0, NaN, subnormals), `linspace` against
`jnp.linspace`, `engine.model_key` against the reference's, and the
port's engine against its own `reference_apply` for all 26 strategies
under both reductions.

Within a tolerance: the five whole-model strategies against the
reference (`TOL`, relative to the output's magnitude): the SVD runs in
another LAPACK, and sums over columns run in torch's order. A search
strategy may pick another candidate than JAX where two fitness values
lie within rounding of each other: such a case must show a top-2
fitness margin below `MARGIN` (relative) in the reference's own search,
and is counted in the test's output, never dropped.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api.spec import MergeSpec as JSpec  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core.properties import controlled_tensors  # noqa: E402
from repro.core.resolve import reference_apply as jref  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.resolve import reference_apply  # noqa: E402
from repro_torch.kernels.quantile import median_axis0, median_flat  # noqa
from repro_torch.strategies import get_strategy, list_strategies  # noqa
from repro_torch.strategies.catalog import _linspace  # noqa: E402

torch.set_num_threads(1)

WHOLE = ("star", "svd_knot_tying", "adarank", "evolutionary_merge",
         "genetic_merge")
SEARCH = ("evolutionary_merge", "genetic_merge")
TOL = {"float64": 1e-12, "float32": 2e-6, "bfloat16": 2.0 ** -7}
MARGIN = {"float64": 1e-10, "float32": 1e-4, "bfloat16": 2.0 ** -6}
SHAPES = [(7,), (6, 5), (3, 4, 5)]
NP = {"float64": np.float64, "float32": np.float32,
      "bfloat16": ml_dtypes.bfloat16}
TD = {"float64": torch.float64, "float32": torch.float32,
      "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _clear_caches():
    yield
    jeng.clear_cache()
    engine.clear_cache()


def _key(seed, data):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), data)
    return jk, prng.fold_in(prng.PRNGKey(seed), data)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view({2: np.uint16, 4: np.uint32, 8: np.uint64}[a.itemsize])


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a).astype(np.float64)).to(TD[dtype])


def _n(t):
    return t.double().numpy()


# ------------------------------------------------------------ random ---


@pytest.mark.parametrize("seed", [0, 7, 0x7FFFFFFF])
def test_split_bitwise(seed):
    jk, tk = _key(seed, 3)
    for num in (2, 3, 5):
        want = np.asarray(jax.random.split(jk, num))
        assert [tuple(r) for r in want.tolist()] == \
            list(prng.split(tk, num))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("bounds", [(-1.0, 1.0), (0.25, 3.5),
                                    (-7.3, -0.001), (-1e-3, 2e4)])
def test_ranged_uniform_bitwise(dtype, bounds):
    with jax.enable_x64(dtype == "float64"):
        for seed in range(4):
            jk, tk = _key(seed, 1)
            want = np.asarray(jax.random.uniform(
                jk, (5, 301), jnp.dtype(NP[dtype]), *bounds))
            got = prng.uniform(tk, (5, 301), TD[dtype], device="cpu",
                               minval=bounds[0], maxval=bounds[1])
            assert np.array_equal(_bits(want), _bits(
                got.view(torch.int16).numpy() if dtype == "bfloat16"
                else got.numpy()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_normal_bitwise(dtype):
    with jax.enable_x64(dtype == "float64"):
        for seed in range(40):
            jk, tk = _key(seed, 5)
            shape = (16, 4) if seed % 2 else (3, 57)
            want = np.asarray(jax.random.normal(jk, shape,
                                                jnp.dtype(NP[dtype])))
            got = prng.normal(tk, shape, TD[dtype], device="cpu")
            assert got.dtype == TD[dtype] and tuple(got.shape) == shape
            g = got.view(torch.int16).numpy() if dtype == "bfloat16" \
                else got.numpy()
            assert np.array_equal(_bits(want), _bits(g)), seed


def test_erf_inv_and_log1p_bitwise():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 60000),
                        1 - rng.uniform(0, 2e-2, 20000),
                        -(1 - rng.uniform(0, 1e-5, 2000)),
                        [0.0, -0.0, 1.0, -1.0]])
    x32 = x.astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x32)))
    got = prng.erf_inv(torch.from_numpy(x32)).numpy()
    assert np.array_equal(_bits(want), _bits(got))
    m = x32 * -x32
    assert np.array_equal(_bits(np.asarray(jnp.log1p(jnp.asarray(m)))),
                          _bits(prng._log1p(torch.from_numpy(m)).numpy()))
    with jax.enable_x64(True):
        x64 = x[::8].copy()
        want = np.asarray(jax.lax.erf_inv(jnp.asarray(x64)))
        got = prng.erf_inv(torch.from_numpy(x64)).numpy()
        assert np.array_equal(_bits(want), _bits(got))


def test_fma_emulation_is_exact():
    """fp32 FMA against the exact rational result, rounded once."""
    from fractions import Fraction
    from repro_torch.kernels.quantile import _round_to
    rng = np.random.default_rng(3)
    a, b = (rng.standard_normal(3000).astype(np.float32) for _ in range(2))
    c = (rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 3, 3000)
         ).astype(np.float32)
    got = prng.fma(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = [_round_to(Fraction(float(x)) * Fraction(float(y))
                      + Fraction(float(z)), np.float32)
            for x, y, z in zip(a, b, c)]
    assert np.array_equal(got, np.array(want, np.float32))


# ------------------------------------------------------------ median ---


def _median_cases(k, n, rng):
    a = rng.standard_normal((k, n))
    a[:, :40] = np.round(a[:, :40])                 # ties
    a[:, 40:80] = 0.0
    a[rng.random((k, n)) < 0.15] = -0.0             # +-0 mixed
    a[:, 120:140] = rng.standard_normal((k, 20)) * 1e-39  # subnormal
    a[:, 140:150] = rng.standard_normal((k, 10)) * 3e38   # overflowing
    a[rng.integers(k), 200] = np.nan
    return a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 8])
def test_median_axis0_bitwise(dtype, k):
    rng = np.random.default_rng(k)
    a = _median_cases(k, 600, rng)
    with jax.enable_x64(dtype == "float64"):
        ja = jnp.asarray(a, jnp.dtype(NP[dtype]))
        want = np.asarray(jnp.median(ja, axis=0)).astype(np.float64)
        got = _n(median_axis0(_t(ja, dtype)))
    nan = np.isnan(want)
    assert np.array_equal(nan, np.isnan(got))
    assert np.array_equal(_bits(want[~nan]), _bits(got[~nan]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
@pytest.mark.parametrize("n", [1, 2, 7, 600, 601])
def test_median_flat_bitwise(dtype, n):
    rng = np.random.default_rng(n)
    x = np.abs(rng.standard_normal(n))
    x[: n // 3] = 0.0
    x[n // 3: n // 2] = np.round(x[n // 3: n // 2])
    with jax.enable_x64(dtype == "float64"):
        jx = jnp.asarray(x, jnp.dtype(NP[dtype]))
        want = np.float64(np.asarray(jnp.median(jx)))
        got = _n(median_flat(_t(jx, dtype)))
        assert _bits(np.array([want])) == _bits(np.array([got]))
        jx = jx.at[n // 2].set(jnp.nan)
        assert np.isnan(np.asarray(jnp.median(jx)))
        assert np.isnan(_n(median_flat(_t(jx, dtype))))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("num", [2, 3, 11, 17])
def test_linspace_bitwise(dtype, num):
    rng = np.random.default_rng(num)
    with jax.enable_x64(dtype == "float64"):
        for _ in range(50):
            lo = NP[dtype](rng.uniform(0.3, 1.2))
            hi = NP[dtype](lo + rng.uniform(0.01, 1.0))
            want = np.asarray(jnp.linspace(jnp.asarray(lo), jnp.asarray(hi),
                                           num))
            got = _linspace(torch.tensor(lo), torch.tensor(hi), num)
            assert np.array_equal(_bits(want), _bits(got.numpy()))


# -------------------------------------------------------- strategies ---


def _search_margin(name, s, b, seed, leaf_index):
    """The smallest relative top-2 fitness margin over the generations of
    the reference's own search on one leaf (its code, replayed)."""
    tau = (s - b).reshape(s.shape[0], -1)
    med = jnp.median(tau, axis=0)
    margins = []
    if name == "evolutionary_merge":
        key = jax.random.fold_in(jax.random.PRNGKey(seed & 0x7FFFFFFF),
                                 leaf_index)
        best_w = jnp.full((tau.shape[0],), 1.0 / tau.shape[0])
        for g in range(3):
            key, sub = jax.random.split(key)
            cands = best_w[None, :] + 0.3 * (0.5 ** g) * jax.random.normal(
                sub, (16, tau.shape[0]), dtype=tau.dtype)
            fits = np.asarray(jax.vmap(
                lambda w: -jnp.sum((w @ tau - med) ** 2))(cands),
                np.float64)
            top = np.sort(fits)[-2:]
            margins.append((top[1] - top[0]) / max(abs(top[1]), 1e-30))
            best_w = cands[jnp.argmax(fits)]
    else:
        mu = jnp.mean(tau, axis=0)
        lo, hi = 0.5, 1.5
        for g in range(3):
            cands = jnp.linspace(lo, hi, 11)
            fits = np.asarray(jax.vmap(lambda a: -(
                jnp.sum((a * mu - med) ** 2)
                + 0.05 * (a - 1.0) ** 2 * jnp.sum(mu ** 2)))(cands),
                np.float64)
            top = np.sort(fits)[-2:]
            margins.append((top[1] - top[0]) / max(abs(top[1]), 1e-30))
            alpha = cands[jnp.argmax(fits)]
            span = (hi - lo) / 4.0
            lo, hi = alpha - span, alpha + span
    return min(margins)


def _whole_case(name, dtype, shape, seed):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal(shape)
    cs = [base + 0.1 * rng.standard_normal(shape) for _ in range(4)]
    dt = jnp.dtype(NP[dtype])
    jb, jc = jnp.asarray(base, dt), [jnp.asarray(c, dt) for c in cs]
    want = np.asarray(jref(name, jc, base=jb, seed=seed)).astype(np.float64)
    got = reference_apply(name, [_t(c, dtype) for c in jc],
                          base=_t(jb, dtype), seed=seed)
    assert str(got.dtype).split(".")[-1] == str(np.asarray(
        jref(name, jc, base=jb, seed=seed)).dtype)
    err = float(np.max(np.abs(_n(got) - want)))
    scale = max(1.0, float(np.max(np.abs(want))))
    if err <= TOL[dtype] * scale:
        return 0
    assert name in SEARCH, (name, dtype, shape, err)
    stack = jnp.stack(jc)
    margin = _search_margin(name, stack, jb, seed, 0)
    assert margin < MARGIN[dtype], (name, dtype, shape, err, margin)
    return 1


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", WHOLE)
def test_whole_model_strategies_float64(name, shape):
    with jax.enable_x64(True):
        ties = sum(_whole_case(name, "float64", shape, seed)
                   for seed in (0, 11, 12345))
    print(f"{name} float64 {shape}: near-tie cases {ties} of 3")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", WHOLE)
def test_whole_model_strategies_float32(name, shape):
    ties = sum(_whole_case(name, "float32", shape, seed)
               for seed in (1, 22, 333))
    print(f"{name} float32 {shape}: near-tie cases {ties} of 3")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("name", SEARCH)
def test_search_strategies_bfloat16(name, shape):
    """bf16 leaves: evolutionary_merge stays in bf16 (its weakly typed
    weights take the data's dtype), genetic_merge comes out fp32 (its
    linspace grid is fp32), as in the reference."""
    ties = sum(_whole_case(name, "bfloat16", shape, seed)
               for seed in (2, 44, 555))
    print(f"{name} bfloat16 {shape}: near-tie cases {ties} of 3")


@pytest.mark.parametrize("name", ("star", "svd_knot_tying", "adarank"))
def test_svd_strategies_refuse_bfloat16_as_the_reference(name):
    rng = np.random.default_rng(0)
    cs = [rng.standard_normal((4, 6)) for _ in range(3)]
    with pytest.raises(NotImplementedError):
        jref(name, [jnp.asarray(c, jnp.bfloat16) for c in cs])
    with pytest.raises(NotImplementedError):
        reference_apply(name, [torch.tensor(c).bfloat16() for c in cs])


def test_registry_matches_reference():
    from repro.strategies import get_strategy as jget
    from repro.strategies import list_strategies as jlist
    assert list_strategies() == jlist()
    for name in list_strategies():
        s, j = get_strategy(name), jget(name)
        assert s.whole_model == j.whole_model
        assert s.cfg_schema == j.cfg_schema
        assert s.needs_key == j.needs_key


# ------------------------------------------------------------ engine ---


@pytest.mark.parametrize("name", WHOLE)
def test_model_key_matches_reference(name):
    rng = np.random.default_rng(5)
    base = rng.standard_normal((4, 3)).astype(np.float32)
    digs = [bytes(rng.integers(0, 256, 32, dtype=np.uint8))
            for _ in range(3)]
    knob = next(iter(get_strategy(name).cfg_schema))
    cfg = {knob: 2 if knob in ("pop", "gens", "grid") else 0.4}
    for spec_t, spec_j in ((MergeSpec(name), JSpec(name)),
                           (MergeSpec(name, cfg), JSpec(name, cfg))):
        for b in (None, base):
            for seed in (0, 99):
                want = jeng.model_key(
                    None, digs, spec=spec_j, seed=seed,
                    base=None if b is None else {"w": jnp.asarray(b)})
                got = engine.model_key(
                    None, digs, spec=spec_t, seed=seed,
                    base=None if b is None else {"w": torch.from_numpy(b)})
                assert got == want
    # a registered base's ref stands in for its digest
    tb = {"w": torch.from_numpy(base)}
    from repro_torch.core.hashing import pytree_digest
    assert engine.model_key(None, digs, spec=MergeSpec(name), base=tb) == \
        engine.model_key(None, digs, spec=MergeSpec(name),
                         base_digest=pytree_digest(tb))


@pytest.mark.parametrize("reduction", ["fold", "tree"])
@pytest.mark.parametrize("name", sorted(list_strategies()))
def test_engine_matches_reference_apply_on_tier1_grid(name, reduction):
    """`engine.merge` == the port's `reference_apply`, bitwise, for all 26
    strategies (the whole-model ones one leaf stack at a time), as
    `tests/test_engine.py` holds the reference's engine."""
    with jax.enable_x64(True):
        grid = [torch.from_numpy(np.array(t))
                for t in controlled_tensors(4, dtype=jnp.float64)]
    want = reference_apply(name, grid, seed=123, reduction=reduction)
    got = engine.merge(grid, name, seed=123, reduction=reduction,
                       use_cache=False)
    assert got.dtype == want.dtype and torch.equal(
        got.view(torch.int64), want.view(torch.int64))


def _tree(rng):
    return {"emb": torch.tensor(rng.standard_normal((6, 4)),
                                dtype=torch.float32),
            "ln": torch.tensor(rng.standard_normal(4), dtype=torch.float32),
            "blk": {"w": torch.tensor(rng.standard_normal((3, 4, 4)),
                                      dtype=torch.float32)}}


@pytest.mark.parametrize("name", WHOLE)
def test_whole_model_route_on_pytrees_with_base(name):
    """Mixed-shape pytree + base: bitwise equal to `reference_apply`
    (keys at the global leaf index), one cache entry, one dispatch; a
    second merge is a hit that dispatches nothing new."""
    rng = np.random.default_rng(8)
    contribs, base = [_tree(rng) for _ in range(3)], _tree(rng)
    want = reference_apply(name, contribs, base=base, seed=77)
    cache = engine.EngineCache(bytes=1 << 30)
    got = engine.merge(contribs, name, base=base, seed=77, cache=cache)
    for a, b in zip(got.values(), want.values()):
        a, b = (a, b) if isinstance(a, torch.Tensor) else (a["w"], b["w"])
        assert torch.equal(a, b)
    assert cache.stats["whole_model_dispatches"] == 1
    assert cache.info().entries == 1 and cache.stats["misses"] == 1
    again = engine.merge(contribs, name, base=base, seed=77, cache=cache)
    assert again is got and cache.stats["hits"] == 1
    with pytest.raises(ValueError, match="whole-model"):
        engine.plan_for(contribs, name, base=base)


def test_whole_model_resolve_probes_the_cache_before_payloads():
    """A warm whole-model resolve touches no payload: it succeeds on a
    replica whose store lost them, where a cold one without a fetch
    hook raises."""
    rng = np.random.default_rng(9)
    rep = Replica("w", device="cpu")
    for _ in range(3):
        rep.contribute(_tree(rng))
    ref = rep.register_base(_tree(rng))
    spec = MergeSpec("genetic_merge", base_ref=ref)
    rep.set_cache_limit(bytes=1 << 30)
    first = rep.resolve(spec)
    dispatches = rep.cache.stats["whole_model_dispatches"]
    stored = dict(rep.state.store)
    rep.state.store.clear()
    assert rep.resolve(spec) is first
    assert rep.cache.stats["whole_model_dispatches"] == dispatches
    rep.clear_cache()
    with pytest.raises(KeyError, match="fetch hook"):
        rep.resolve(spec)
    rep.state.store.update(stored)
