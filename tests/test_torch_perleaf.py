"""Slice 3 of the port against the JAX reference: the per-leaf kernel API
(`repro_torch.kernels`: weighted_merge, weight_average_merge,
task_arithmetic_merge, ties_merge, slerp_merge, dare_merge) with the
plain versions of B7 (`ties_leaf`) and B8 (`slerp_reduce`,
`slerp_combine`) standing in for CUDA, the 13 per-leaf strategies this
slice adds, and the binary-only folds of the engine and
`reference_apply`. The reference's kernels run in interpret mode.

  entry points  against `repro.kernels.ops` over `tests/test_kernels.py`'s
                shapes, fp32 and bf16, k = 4, and on a pytree:
                  ties_merge (both trims), dare_merge: bitwise (k = 4:
                  XLA sums the rows in index order, 1/k is exact);
                  weighted, weight_average, task_arithmetic: within 1e-6
                  (fp32; XLA contracts its tile into FMAs) or one bf16
                  ulp (rtol 2^-7) after the cast back;
                  slerp_merge: within rtol 2e-6 / atol 1e-6 (fp32; the
                  reference sums each tile in XLA's order) or one bf16
                  ulp.
  thresholds    `quantile.quantile_threshold` bitwise against
                `jnp.quantile`, including a row of 2^24 + 3 elements,
                ties, zeros, inf and NaN; `quantile.quantile_rows` (the
                catalog's quantile) bitwise against `jnp.quantile(axis=1)`
                on signed rows with ties, +-0, inf and a NaN row.
  B7, B8        plain versions bitwise against their oracles
                (`ties_tile`, the kernel's pinned sum order).
  strategies    against `repro.strategies` on the tier-1 4x4 float64
                grid (under `jax.enable_x64`) and on a mixed fp32/bf16
                tree: bitwise for fisher_merge and model_breadcrumbs;
                the rest within rtol 1e-12 (float64), 1e-5 (fp32) or
                2^-7 (bf16), because their whole-leaf sums, norms, dots
                and variances run in torch's order, not XLA's.
  folds         `pairwise_fold`'s pairs and seeds equal to the
                reference's `_seq_fold` / `_tree_fold`, k = 1..7.
  engine        bitwise against the port's own `reference_apply`, every
                new strategy x {fold, tree}, and slerp at k in {3, 4}
                through the binary folds; slerp through `Replica.resolve`
                against the JAX `Replica` within one ulp per fold step
                (each step rounds to the leaf dtype and feeds the next).
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.api import Replica as JReplica  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.config import kernel_env as jkernel_env  # noqa: E402
from repro.strategies import get_strategy as jget  # noqa: E402
from repro_torch import convert, kernels, pytree  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.resolve import reference_apply  # noqa: E402
from repro_torch.kernels import quantile, ref, slerp, ties  # noqa: E402
from repro_torch.strategies import get_strategy  # noqa: E402
from repro_torch.strategies import list_strategies  # noqa: E402
from repro_torch.strategies.base import pairwise_fold  # noqa: E402

# `repro.core.resolve` is also a function of `repro.core`
jresolve = importlib.import_module("repro.core.resolve")

torch.set_num_threads(1)

BLOCK = 2048
SHAPES = [(8,), (33,), (128, 128), (257, 63), (16, 8, 9)]
DTYPES = ["float32", "bfloat16"]
ENTRIES = ["weighted", "weight_average", "task_arithmetic", "ties_hist",
           "ties_quantile", "slerp", "dare"]
# the 13 strategies of this slice, with non-default cfgs where they
# have knobs
NEW = {
    "fisher_merge": {"eps": 1e-7},
    "dam": {},
    "ada_merging": {"eps": 1e-7},
    "regression_mean": {"eps": 1e-7},
    "model_breadcrumbs": {"beta": 0.15, "gamma": 0.05},
    "emr": {"trim": 0.2},
    "safe_merge": {"k_sigma": 1.5},
    "split_unlearn_merge": {},
    "slerp": {"t": 0.3},
    "dual_projection": {"gamma": 0.4},
    "representation_surgery": {"eps": 1e-7},
    "weight_scope_alignment": {},
    "led_merge": {"beta": 4.0, "gamma": 0.6},
}
BITWISE = ("fisher_merge", "model_breadcrumbs")
RTOL = {np.dtype(np.float64): 1e-12, np.dtype(np.float32): 1e-5,
        np.dtype(ml_dtypes.bfloat16): 2.0 ** -7}
WHOLE_MODEL = ("adarank", "evolutionary_merge", "genetic_merge", "star",
               "svd_knot_tying")


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jkernel_env.reset()
    jeng.clear_cache()
    jeng.reset_exec_stats()
    engine.clear_cache()


def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _contribs(k, shape, dtype, seed=0):
    """k numpy contributions and a base, as `tests/test_kernels.py`."""
    rng = np.random.default_rng(seed)
    dt = _np_dtype(dtype)
    return [rng.standard_normal(shape).astype(dt) for _ in range(k)], \
        (rng.standard_normal(shape) * 0.1).astype(dt)


def _t(tree):
    return convert.from_numpy_tree(tree, "cpu")


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _np(tree):
    return [np.asarray(a) for a in pytree.leaves(convert.to_numpy_tree(tree))]


def _jnp(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _same_bytes(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _close(got, want, rtol, atol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64), rtol=rtol,
                                   atol=atol)


def _entry(name, cs, base, *, port):
    """One per-leaf entry point on the port's tensors (port=True) or the
    reference's arrays, the same arguments for both."""
    k = len(cs)
    if port:
        mod, w = kernels, [0.2 + 0.1 * i for i in range(k)]
        extra = {}
    else:
        mod, w = jops, jnp.asarray([0.2 + 0.1 * i for i in range(k)])
        extra = {"interpret": True}
    if name == "weighted":
        return mod.weighted_merge(cs, w, base, **extra)
    if name == "weight_average":
        return mod.weight_average_merge(cs, **extra)
    if name == "task_arithmetic":
        return mod.task_arithmetic_merge(cs, base, lam=0.7, **extra)
    if name == "ties_hist":
        return mod.ties_merge(cs, base, 0.3, trim_method="histogram",
                              **extra)
    if name == "ties_quantile":
        return mod.ties_merge(cs, base, 0.3, trim_method="quantile", **extra)
    if name == "slerp":
        return mod.slerp_merge(cs[0], cs[1], t=0.35, **extra)
    return mod.dare_merge(cs, base, seed=17, p=0.4, **extra)


def _check_entry(name, got, want, dtype):
    if name in ("ties_hist", "ties_quantile", "dare"):
        _same_bytes(got, want)
    elif dtype == "bfloat16":
        _close(got, want, 2.0 ** -7, 1e-6)
    elif name == "slerp":
        _close(got, want, 2e-6, 1e-6)
    else:
        _close(got, want, 1e-6, 1e-6)


# ------------------------------------------------------------ entry points


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", ENTRIES)
def test_entry_point_matches_reference(name, shape, dtype):
    cs, base = _contribs(4, shape, dtype, seed=len(shape))
    got = _np(_entry(name, [_t(c) for c in cs], _t(base), port=True))
    want = _jnp(_entry(name, [_j(c) for c in cs], _j(base), port=False))
    _check_entry(name, got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ENTRIES)
def test_entry_point_on_a_pytree(name, dtype):
    rng = np.random.default_rng(10)
    dt = _np_dtype(dtype)

    def tree():
        return {"w": rng.standard_normal((17, 5)).astype(dt),
                "blk": {"b": rng.standard_normal(11).astype(dt),
                        "big": rng.standard_normal((3, 2100)).astype(dt)}}

    cs, base = [tree() for _ in range(4)], tree()
    kernels.reset_launch_counts()
    out = _entry(name, [_t(c) for c in cs], _t(base), port=True)
    assert kernels.launch_counts() == dict.fromkeys(kernels.WRAPPERS, 0)
    assert out["w"].shape == (17, 5) and out["blk"]["b"].shape == (11,)
    want = _jnp(_entry(name, [_j(c) for c in cs], _j(base), port=False))
    _check_entry(name, _np(out), want, dtype)


def test_slerp_merge_of_identical_inputs():
    """u == v: the `so < 1e-6` branch, weights (1 - t, t): within one
    fp32 ulp of u, as the reference's own test."""
    u = torch.from_numpy(np.random.default_rng(6).standard_normal(
        1000).astype(np.float32))
    out = kernels.slerp_merge(u, u.clone(), t=0.3)
    np.testing.assert_allclose(out.numpy(), u.numpy(), rtol=2e-7, atol=0)


def test_slerp_merge_matches_the_formula():
    """Against `ref.slerp_ref` (whole-row sums): within 2e-6."""
    rng = np.random.default_rng(7)
    u, v = (torch.from_numpy(rng.standard_normal(70_000).astype(
        np.float32)) for _ in range(2))
    np.testing.assert_allclose(kernels.slerp_merge(u, v, t=0.4).numpy(),
                               ref.slerp_ref(u, v, 0.4).numpy(),
                               rtol=2e-6, atol=1e-6)


def test_entry_points_refuse_integer_leaves_and_unknown_trims():
    cs = [{"w": torch.ones(4), "n": torch.arange(4)} for _ in range(2)]
    for call in (lambda: kernels.weighted_merge(cs, [0.5, 0.5]),
                 lambda: kernels.ties_merge(cs, trim_method="quantile"),
                 lambda: kernels.slerp_merge(cs[0], cs[1]),
                 lambda: kernels.dare_merge(cs)):
        with pytest.raises(TypeError, match="fp32"):
            call()
    fl = [{"w": torch.ones(4)} for _ in range(2)]
    with pytest.raises(ValueError, match="trim_method"):
        kernels.ties_merge(fl, trim_method="median")


# ------------------------------------------------------------ thresholds


def _jnp_threshold(x, b, q):
    return np.asarray(jnp.quantile(jnp.abs(jnp.asarray(x, jnp.float32)
                                           - jnp.asarray(b, jnp.float32)),
                                   q))


@pytest.mark.parametrize("q", [0.0, 0.2, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("n", [1, 2, 7, 2048, 5000])
def test_quantile_threshold_bitwise(n, q):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32)
    x[: n // 3] = np.round(x[: n // 3], 1)          # ties and zeros
    b = np.zeros(n, np.float32)
    b[: n // 5] = x[: n // 5]
    got = quantile.quantile_threshold(torch.from_numpy(x),
                                      torch.from_numpy(b), q)
    assert got.dtype == torch.float32 and got.dim() == 0
    assert np.array_equal(got.numpy(), _jnp_threshold(x, b, q))


def test_quantile_threshold_inf_and_nan():
    x = np.array([1.0, np.inf, 3.0, 0.5], np.float32)
    b = np.zeros(4, np.float32)
    for q in (0.2, 1.0):
        got = quantile.quantile_threshold(torch.from_numpy(x),
                                          torch.from_numpy(b), q)
        assert np.array_equal(got.numpy(), _jnp_threshold(x, b, q),
                              equal_nan=True)
    x[2] = np.nan
    got = quantile.quantile_threshold(torch.from_numpy(x),
                                      torch.from_numpy(b), 0.2)
    assert np.isnan(got.numpy()) and np.isnan(_jnp_threshold(x, b, 0.2))


def test_quantile_threshold_above_2_pow_24():
    """A bf16 row of 2^24 + 3 elements: JAX's fp32 index 0.2 (n - 1)
    rounds there; the threshold stays bitwise."""
    n = 2 ** 24 + 3
    rng = np.random.default_rng(24)
    x = rng.standard_normal(n).astype(ml_dtypes.bfloat16)
    b = (rng.standard_normal(n) * 0.1).astype(np.float32)
    got = quantile.quantile_threshold(
        torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16),
        torch.from_numpy(b), 0.2)
    assert np.array_equal(got.numpy(), _jnp_threshold(x, b, 0.2))


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("dtype", DTYPES + ["float64"])
def test_quantile_rows_bitwise(dtype, q):
    """Bitwise against `jnp.quantile(a, q, axis=1, keepdims=True)` on
    signed rows: ties, -0 and +0, inf, and a row holding a NaN (float64
    under x64, through the sort)."""
    rng = np.random.default_rng(int(q * 10))
    a = rng.standard_normal((4, 3001))
    a[:, :900] = np.round(a[:, :900], 1)
    a[0, :50] = -0.0
    a[1, 7] = np.inf
    a[2, 11] = -np.inf
    a[3, 100] = np.nan
    a = a.astype(_np_dtype(dtype))
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jnp.quantile(jnp.asarray(a), q, axis=1,
                                       keepdims=True))
    got = quantile.quantile_rows(convert.from_numpy_tree(a, "cpu"), q)
    assert got.dtype == convert.from_numpy_tree(a, "cpu").dtype
    got = np.asarray(convert.to_numpy_tree(got))
    assert got.shape == want.shape == (4, 1)
    nan = np.isnan(want.astype(np.float64))
    assert nan[3].all() and np.array_equal(np.isnan(got.astype(
        np.float64)), nan)                  # NaN payloads are not compared
    assert np.array_equal(got[~nan].view(np.uint8), want[~nan].view(np.uint8))


EDGE_ROWS = {
    "one": [2.5],
    "equal": [0.75] * 7,
    "signed zeros": [0.0, -0.0, 0.0, -0.0, -0.0],
    "below zeros": [-1.0, -0.0, 0.0, 2.0, -0.0, -3.0],
    "two values": [1.0, 4.0, 1.0, 4.0, 4.0, 1.0, 1.0, 4.0],
    "inf": [np.inf, 1.0, -np.inf, np.inf, 0.0],
}


@pytest.mark.parametrize("q", [0.0, 0.25, 1 / 3, 0.5, 0.7, 1.0])
@pytest.mark.parametrize("row", sorted(EDGE_ROWS))
def test_quantile_rows_edge_rows(row, q):
    """Bitwise, the sign of zero included, against `jnp.quantile` on
    rows where the two order statistics share a group of equal values,
    straddle two groups, or are zeros of either sign (JAX's sort is
    stable and holds -0 equal to +0)."""
    a = np.array([EDGE_ROWS[row]], np.float32)
    want = np.asarray(jnp.quantile(jnp.asarray(a), q, axis=1,
                                   keepdims=True))
    got = quantile.quantile_rows(torch.from_numpy(a), q).numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)) or \
        (np.isnan(got).all() and np.isnan(want).all())


# ------------------------------------------------------------ folds


class _Pairing:
    """A stand-in binary strategy that records what it merged: the pair
    and the step's seed."""

    def __call__(self, contribs, base=None, seed=0, **cfg):
        assert len(contribs) == 2
        return (contribs[0], contribs[1], seed)


@pytest.mark.parametrize("reduction", ["fold", "tree"])
@pytest.mark.parametrize("k", range(1, 8))
def test_pairwise_fold_matches_reference_folds(k, reduction):
    """The pairs, their order and the per-step seeds equal the
    reference's `_seq_fold` / `_tree_fold`, exactly."""
    items = list(range(k))
    fold = jresolve._tree_fold if reduction == "tree" \
        else jresolve._seq_fold
    want = fold(_Pairing(), items, None, 40, {}) if k > 1 else items[0]
    got = pairwise_fold(items, lambda x, y, sd: (x, y, sd), 40, reduction)
    assert got == want


# ------------------------------------------------------------ B7, B8


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 2, 4, 16])
def test_ties_leaf_plain_is_ties_tile(k, dtype):
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((k, 4096)).astype(
        np.float32)).to(getattr(torch, dtype))
    base = torch.from_numpy(rng.standard_normal(4096).astype(np.float32))
    thr = torch.from_numpy((rng.random(k) * 1.2).astype(np.float32))
    got = ties.ties_leaf(x, base, thr, BLOCK)
    assert torch.equal(got, ref.ties_ref(x, base, thr.reshape(-1, 1)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_slerp_reduce_plain_order(dtype):
    """Plain partials bitwise equal to the kernel's documented order,
    written out per tile: 8 in index order, then x[:h] + x[h:]."""
    rng = np.random.default_rng(3)
    u, v = (torch.from_numpy(rng.standard_normal(3 * BLOCK).astype(
        np.float32)).to(getattr(torch, dtype)) for _ in range(2))
    got = slerp.slerp_reduce(u, v, BLOCK)
    assert got.shape == (3, 3)
    for tile in range(3):
        sl = slice(tile * BLOCK, (tile + 1) * BLOCK)
        a, b = u[sl].float(), v[sl].float()
        for col, p in enumerate((a * b, a * a, b * b)):
            s = [p[8 * t] for t in range(BLOCK // 8)]
            for j in range(1, 8):
                s = [s[t] + p[8 * t + j] for t in range(BLOCK // 8)]
            while len(s) > 1:
                h = len(s) // 2
                s = [s[t] + s[t + h] for t in range(h)]
            assert torch.equal(got[tile, col], s[0])


def test_slerp_tile_sum_is_pinned():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (5, 3)).astype(np.float32))
    want = ((x[0] + x[4]) + (x[2] + 0.0)) + ((x[1] + 0.0) + (x[3] + 0.0))
    assert torch.equal(slerp.tile_sum(x), want)


def test_slerp_wrappers_refuse_bad_operands():
    u = torch.zeros(BLOCK)
    with pytest.raises(ValueError, match="power of two"):
        slerp.slerp_reduce(u, u, 24)
    with pytest.raises(ValueError, match="multiple"):
        slerp.slerp_reduce(u[:100], u[:100], BLOCK)
    with pytest.raises(TypeError, match="both fp32 or both bf16"):
        slerp.slerp_combine(u, u.to(torch.bfloat16), torch.zeros(2), BLOCK)
    with pytest.raises(ValueError, match="thr"):
        ties.ties_leaf(torch.zeros((2, BLOCK)), u, torch.zeros(3), BLOCK)


# ------------------------------------------------------------ strategies


def test_registry_covers_the_per_leaf_catalog():
    assert len(list_strategies()) == 21
    assert set(NEW) <= set(list_strategies())
    for name in WHOLE_MODEL:
        with pytest.raises(KeyError, match="ROADMAP A3.6"):
            get_strategy(name)
    assert get_strategy("slerp").binary_only
    assert get_strategy("fisher_merge").batchable
    for name in NEW:
        assert get_strategy(name).cfg_schema == jget(name).cfg_schema


def _check_strategy(name, got, want, atol, steps=1):
    """Bitwise for BITWISE, else within RTOL of the dtype per binary
    fold step."""
    if name in BITWISE:
        _same_bytes(got, want)
        return
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(a.astype(np.float64),
                                   b.astype(np.float64),
                                   rtol=steps * RTOL[a.dtype], atol=atol)


@pytest.mark.parametrize("name", sorted(NEW))
def test_strategy_on_the_float64_grid(name):
    """Nine 4x4 float64 tensors (two for slerp) under x64."""
    rng = np.random.default_rng(42)
    grid = [{"w": rng.standard_normal((4, 4))} for _ in range(9)]
    grid = grid[:2] if name == "slerp" else grid
    with jax.enable_x64(True):
        want = _jnp(jget(name)([_j(g) for g in grid], seed=7, **NEW[name]))
    got = _np(get_strategy(name)([_t(g) for g in grid], seed=7,
                                 **NEW[name]))
    _check_strategy(name, got, want, 1e-14)


def _mixed(rng, k):
    """k contributions (base + small delta) over a mixed fp32/bf16 tree
    of 1-, 2- and 3-D leaves, and the base."""
    bf = ml_dtypes.bfloat16
    base = {"emb": rng.standard_normal((37, 8)).astype(np.float32),
            "blk": {"w": rng.standard_normal((8, 16)).astype(bf),
                    "b": rng.standard_normal(16).astype(np.float32),
                    "qkv": rng.standard_normal((3, 8, 5)).astype(bf)},
            "norm": rng.standard_normal(5).astype(bf)}
    cs = [jax.tree_util.tree_map(
        lambda b: (b.astype(np.float32) + 0.05 * rng.standard_normal(
            b.shape)).astype(b.dtype), base) for _ in range(k)]
    return cs, base


@pytest.mark.parametrize("name", sorted(NEW))
def test_strategy_on_a_mixed_tree(name):
    cs, base = _mixed(np.random.default_rng(3), 2 if name == "slerp" else 4)
    want = _jnp(jget(name)([_j(c) for c in cs], base=_j(base), seed=3,
                           **NEW[name]))
    got = _np(get_strategy(name)([_t(c) for c in cs], base=_t(base), seed=3,
                                 **NEW[name]))
    _check_strategy(name, got, want, 1e-6)


@pytest.mark.parametrize("name", sorted(NEW))
def test_spec_bytes_match_reference(name):
    spec, jspec = MergeSpec(name, NEW[name]), JSpec(name, NEW[name])
    assert spec.encode() == jspec.encode()
    assert spec.digest() == jspec.digest()
    for wr in (True, False):
        assert spec.cache_fragment(wr) == jspec.cache_fragment(wr)


# ------------------------------------------------------------ engine


@pytest.mark.parametrize("reduction", ["fold", "tree"])
@pytest.mark.parametrize("name", sorted(NEW))
def test_engine_equals_reference_apply(name, reduction):
    """Bitwise within the port; slerp at k = 4 runs the binary folds."""
    cs, base = _mixed(np.random.default_rng(5), 4)
    tc, tb = [_t(c) for c in cs], _t(base)
    spec = MergeSpec(name, NEW[name], reduction=reduction)
    want = reference_apply(name, tc, base=tb, seed=2 ** 62 + 9,
                           reduction=reduction, **NEW[name])
    for use_cache in (False, True, True):       # cold, fill, warm hit
        got = engine.merge(tc, spec=spec, base=tb, seed=2 ** 62 + 9,
                           use_cache=use_cache, cache=engine.EngineCache())
        _same_bytes(_np(got), _np(want))


@pytest.mark.parametrize("reduction", ["fold", "tree"])
@pytest.mark.parametrize("k", [3, 4])
def test_slerp_binary_folds(k, reduction):
    """The engine's per-leaf folds equal `reference_apply`'s whole-tree
    folds bitwise, and the reference's engine within one ulp (bf16 2^-7,
    fp32 1e-5) per fold step; the sub-roots carry the reduction."""
    cs, base = _mixed(np.random.default_rng(k), k)
    tc = [_t(c) for c in cs]
    spec = MergeSpec("slerp", {"t": 0.3}, reduction=reduction)
    got = engine.merge(tc, spec=spec, seed=11, use_cache=False)
    _same_bytes(_np(got), _np(reference_apply(
        "slerp", tc, seed=11, reduction=reduction, t=0.3)))
    want = _jnp(jeng.merge([_j(c) for c in cs], spec=JSpec(
        "slerp", {"t": 0.3}, reduction=reduction), seed=11,
        use_cache=False))
    _check_strategy("slerp", _np(got), want, 1e-6, steps=k - 1)
    tplan = engine.plan_for(tc, spec=spec, seed=11)
    jplan = jeng.plan_for([_j(c) for c in cs], spec=JSpec(
        "slerp", {"t": 0.3}, reduction=reduction), seed=11)
    assert [t.sub_root for t in tplan.tasks] == \
        [t.sub_root for t in jplan.tasks]
    other = "tree" if reduction == "fold" else "fold"
    assert tplan.tasks[0].sub_root != engine.plan_for(
        tc, spec=MergeSpec("slerp", {"t": 0.3}, reduction=other),
        seed=11).tasks[0].sub_root


@pytest.mark.parametrize("k,reduction", [(2, "fold"), (4, "fold"),
                                         (4, "tree")])
def test_slerp_through_replica_matches_reference(k, reduction):
    """`Replica.resolve` end to end (Merkle seed, canonical order, binary
    folds) against the JAX `Replica`: equal roots, outputs within one
    ulp (bf16 2^-7, fp32 1e-5) per fold step."""
    cs, _ = _mixed(np.random.default_rng(20 + k), k)
    jrep = JReplica("ref")
    rep = Replica("port", device="cpu")
    for c in cs:
        jrep.contribute(_j(c))
        rep.contribute(_t(c))
    assert rep.merkle_root() == jrep.merkle_root()
    want = _jnp(jrep.resolve(JSpec("slerp", {"t": 0.4},
                                   reduction=reduction)))
    got = _np(rep.resolve(MergeSpec("slerp", {"t": 0.4},
                                    reduction=reduction)))
    _check_strategy("slerp", got, want, 1e-6, steps=k - 1)
