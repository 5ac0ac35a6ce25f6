"""Slice 2 of the port against the JAX reference: the DARE family over
the threefry port, int8 compression, the B2 (`quant_nary`) and B6
(`dare_block`) kernels' plain versions, and the engine's int8 and DARE
kernel routes.

  strategies   dare, dare_ties, della: bitwise against `repro` in fp32,
               bf16 and float64 (under `jax.enable_x64`), per leaf and
               whole-tree; the engine bitwise against the port's
               `reference_apply`; MergeSpec bytes and sub-roots equal.
  compression  `q` and `scale` bytes equal, dequantized bytes equal,
               digests taken on the dequantized tensors.
  quant_nary   within 1e-5 absolute of `quant_nary_pallas`, a few fp32
               ulps of partial sums reaching ~20 here (XLA contracts the
               tile's `w * (x - base)` sum into FMAs and does not pin
               its k order); bitwise against the port's
               dequantize-then-merge oracle.
  dare_block   masks bitwise against `dare_block_pallas`; merged values
               bitwise for k in {1, 4}, within 1e-6 at k = 16 (XLA
               reassociates the 16-row sum); the flat batch bitwise
               equal to per-leaf launches and to `ref.dare_ref`.
  engine       the routes' counters and cache hygiene; outputs within
               1e-5 of the exact route (fp32) or within one bf16 ulp of
               the reference's kernel route.

The CUDA kernels run only on a GPU: `tests/test_torch_cuda.py` holds
them against these plain versions there.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.api import MergeSpec as JSpec  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.config import kernel_env as jkernel_env  # noqa: E402
from repro.kernels.dare import dare_block_pallas  # noqa: E402
from repro.kernels.quant import quant_nary_pallas  # noqa: E402
from repro.strategies import get_strategy as jget  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.api import MergeSpec  # noqa: E402
from repro_torch.core import compression, engine  # noqa: E402
from repro_torch.core.resolve import reference_apply  # noqa: E402
from repro_torch.dtypes import dtype_name  # noqa: E402
from repro_torch.kernels import dare, ops, quant, ref  # noqa: E402
from repro_torch.kernels.common import M32, padded_len  # noqa: E402
from repro_torch.kernels.config import kernel_env  # noqa: E402
from repro_torch.kernels.histogram import batch_layout  # noqa: E402
from repro_torch.strategies import get_strategy  # noqa: E402

torch.set_num_threads(1)

BLOCK = 2048
FAMILY = {"dare": {"p": 0.3}, "dare_ties": {"p": 0.6},
          "della": {"p_min": 0.1, "p_max": 0.7}}
LENGTHS = {"1": [1], "2047": [2047], "2048+2049": [2048, 2049],
           "leaves": [1, 2047, 2048, 2049, 700]}
KS = [1, 2, 4, 16]
BF16_ULP = dict(rtol=2.0 ** -7, atol=1e-6)


@pytest.fixture(autouse=True)
def _restore_state():
    yield
    jkernel_env.reset()
    jeng.clear_cache()
    jeng.reset_exec_stats()
    kernel_env.dare_kernel_rng = False
    engine.clear_cache()


def _np_dtype(name):
    return ml_dtypes.bfloat16 if name == "bfloat16" else np.dtype(name)


def _tree(rng, dtype, k, base_scale=0.5):
    """k contributions and a base over a small mixed-shape tree
    (numpy)."""
    shapes = {"emb": (37, 8), "blk": {"w": (8, 16), "b": (16,)},
              "norm": (5,)}
    base = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s) * base_scale).astype(dtype),
        shapes, is_leaf=lambda x: isinstance(x, tuple))
    cs = [jax.tree_util.tree_map(
        lambda b: (b.astype(np.float32) + 0.3 * rng.standard_normal(
            b.shape)).astype(dtype), base) for _ in range(k)]
    return cs, base


def _np(tree):
    return [np.asarray(a) for a in
            pytree.leaves(convert.to_numpy_tree(tree))]


def _jleaves(tree):
    return [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]


def _same_bytes(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def _torch_tree(tree):
    return convert.from_numpy_tree(tree, "cpu")


# ------------------------------------------------------------ strategies


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FAMILY))
def test_dare_family_apply_leaf_bitwise(name, dtype, k):
    """One leaf, a 63-bit seed (masked to 31 bits by the key rule)."""
    rng = np.random.default_rng(k)
    dt = _np_dtype(dtype)
    s = rng.standard_normal((k, 37, 29)).astype(dt)
    b = (rng.standard_normal((37, 29)) * 0.5).astype(dt)
    kw = dict(leaf_index=5, seed=2 ** 40 + 77, **FAMILY[name])
    want = np.asarray(jget(name).apply_leaf(jnp.asarray(s), jnp.asarray(b),
                                            **kw))
    got = get_strategy(name).apply_leaf(convert._to_tensor(s, "cpu"),
                                        convert._to_tensor(b, "cpu"), **kw)
    _same_bytes([convert._to_numpy(got)], [want])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FAMILY))
def test_dare_family_whole_tree_bitwise(name, dtype):
    """`leafwise`: leaf i keyed with fold_in(PRNGKey(seed), i)."""
    cs, base = _tree(np.random.default_rng(3), _np_dtype(dtype), 4)
    jt = [jax.tree_util.tree_map(jnp.asarray, c) for c in cs]
    want = jget(name)(jt, base=jax.tree_util.tree_map(jnp.asarray, base),
                      seed=1234, **FAMILY[name])
    got = get_strategy(name)([_torch_tree(c) for c in cs],
                             base=_torch_tree(base), seed=1234,
                             **FAMILY[name])
    _same_bytes(_np(got), _jleaves(want))


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_dare_family_on_the_float64_grid(name):
    """The tier-1 grid (nine 4x4 float64 tensors) under x64, where a
    Python-float p is float64 and JAX draws 64-bit uniforms."""
    rng = np.random.default_rng(42)
    grid = [{"w": rng.standard_normal((4, 4))} for _ in range(9)]
    with jax.enable_x64(True):
        want = jget(name)([jax.tree_util.tree_map(jnp.asarray, g)
                           for g in grid], seed=7)
        want = _jleaves(want)
    got = get_strategy(name)([_torch_tree(g) for g in grid], seed=7)
    _same_bytes(_np(got), want)


@pytest.mark.parametrize("reduction", ["fold", "tree"])
@pytest.mark.parametrize("name", sorted(FAMILY))
def test_engine_equals_reference_apply(name, reduction):
    cs, base = _tree(np.random.default_rng(5), np.float32, 4)
    tc = [_torch_tree(c) for c in cs]
    tb = _torch_tree(base)
    spec = MergeSpec(name, FAMILY[name], reduction=reduction)
    got = engine.merge(tc, spec=spec, base=tb, seed=2 ** 62 + 9,
                       use_cache=False)
    want = reference_apply(name, tc, base=tb, seed=2 ** 62 + 9,
                           reduction=reduction, **FAMILY[name])
    _same_bytes(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FAMILY))
def test_engine_matches_reference_engine_bitwise(name, dtype):
    """The exact path of both engines (no kernel route)."""
    cs, base = _tree(np.random.default_rng(6), _np_dtype(dtype), 3)
    spec_kw = dict(seed=99, base=None)
    want = jeng.merge([jax.tree_util.tree_map(jnp.asarray, c) for c in cs],
                      spec=JSpec(name, FAMILY[name]), use_cache=False,
                      **spec_kw)
    got = engine.merge([_torch_tree(c) for c in cs],
                       spec=MergeSpec(name, FAMILY[name]), use_cache=False,
                       **spec_kw)
    _same_bytes(_np(got), _jleaves(want))


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_dare_spec_and_subroots_match_reference(name):
    cfg = FAMILY[name]
    spec, jspec = MergeSpec(name, cfg), JSpec(name, cfg)
    assert spec.encode() == jspec.encode()
    assert spec.digest() == jspec.digest()
    assert spec.cache_fragment() == jspec.cache_fragment()
    assert MergeSpec(name).encode() == JSpec(name).encode()
    strat, jstrat = get_strategy(name), jget(name)
    assert (strat.needs_key, strat.cfg_schema) == (jstrat.needs_key,
                                                   jstrat.cfg_schema)
    cs, base = _tree(np.random.default_rng(8), np.float32, 3)
    plan = engine.plan_merge([engine.contrib_meta(_torch_tree(c))
                              for c in cs], spec=spec, seed=2 ** 62 + 1)
    jplan = jeng.plan_merge([jeng.contrib_meta(
        jax.tree_util.tree_map(jnp.asarray, c)) for c in cs], spec=jspec,
        seed=2 ** 62 + 1)
    assert [t.sub_root for t in plan.tasks] == \
        [t.sub_root for t in jplan.tasks]


# ------------------------------------------------------------ compression


def _compress_inputs(dtype):
    """A tree with an all-zero leaf and a leaf whose scale is exactly
    0.125 (max |a| = 15.875), so a / scale hits exact .5 ties."""
    rng = np.random.default_rng(0)
    dt = _np_dtype(dtype)
    ties = np.array([15.875, 0.0625, 0.1875, 0.3125, -0.0625, -0.1875,
                     -15.875, 0.4375, 1.0625], np.float32)
    return {"a": rng.standard_normal((37, 41)).astype(dt),
            "zero": np.zeros(17, dt), "ties": ties.astype(dt),
            "s": np.asarray(rng.standard_normal(), dt)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_compress_tree_bytes_match_reference(dtype):
    tree = _compress_inputs(dtype)
    jct = jcomp.compress_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    ct = compression.compress_tree(_torch_tree(tree))
    assert len(ct.leaves) == len(jct.leaves)
    for leaf, jl in zip(ct.leaves, jct.leaves):
        assert leaf.q.dtype == torch.int8 and leaf.shape == tuple(jl.shape)
        assert np.array_equal(leaf.q.numpy(), jl.q)
        assert leaf.scale.numpy().tobytes() == np.float32(jl.scale).tobytes()
        assert dtype_name(leaf.dtype) == jl.dtype
    ties = ct.leaves[[i for i, p in enumerate(
        pytree.leaf_paths(ct.treedef)) if "ties" in p][0]]
    assert float(ties.scale) == 0.125
    assert ties.q.tolist()[:6] == [127, 0, 2, 2, 0, -2]
    _same_bytes(_np(compression.decompress_tree(ct)),
                _jleaves(jcomp.decompress_tree(jct)))
    assert ct.nbytes() == jct.nbytes()


def test_from_numpy_compressed_carries_reference_bytes():
    tree = _compress_inputs("bfloat16")
    jct = jcomp.compress_tree(jax.tree_util.tree_map(jnp.asarray, tree))
    ct = convert.from_numpy_compressed(jct, "cpu")
    mine = compression.compress_tree(_torch_tree(tree))
    for a, b in zip(ct.leaves, mine.leaves):
        assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
        assert a.shape == b.shape and a.dtype == b.dtype
    assert ct.treedef == mine.treedef
    assert compression.compressed_tree_from_structure(
        compression.compressed_tree_to_structure(ct)).treedef == ct.treedef


def test_contrib_meta_of_compressed_tree():
    """Digests describe the dequantized tensors (equal to the dense
    copy's and to the reference's); int8 slices are priced at one byte
    per element."""
    cs, _ = _tree(np.random.default_rng(9), ml_dtypes.bfloat16, 3)
    jcts = [jcomp.compress_tree(jax.tree_util.tree_map(jnp.asarray, c))
            for c in cs]
    cts = [convert.from_numpy_compressed(j, "cpu") for j in jcts]
    meta = engine.contrib_meta(cts[0])
    dense = engine.contrib_meta(compression.decompress_tree(cts[0]))
    assert meta.digests == dense.digests
    assert meta.digests == jeng.contrib_meta(jcts[0]).digests
    assert meta.itemsizes == (1,) * meta.leaf_count
    assert dense.itemsizes == (2,) * meta.leaf_count
    assert meta.dtypes == dense.dtypes
    plan = engine.plan_merge([engine.contrib_meta(c) for c in cts],
                             "weight_average")
    jplan = jeng.plan_merge([jeng.contrib_meta(j) for j in jcts],
                            "weight_average")
    for t, jt in zip(plan.tasks, jplan.tasks):
        assert t.stacked_nbytes == jt.stacked_nbytes == \
            3 * math.prod(t.shape)
    mixed = engine.plan_merge(
        [engine.contrib_meta(cts[0]),
         engine.contrib_meta(compression.decompress_tree(cts[1]))],
        "weight_average")
    jmixed = jeng.plan_merge(
        [jeng.contrib_meta(jcts[0]),
         jeng.contrib_meta(jcomp.decompress_tree(jcts[1]))],
        "weight_average")
    for t, jt in zip(mixed.tasks, jmixed.tasks):
        assert t.stacked_nbytes == jt.stacked_nbytes == \
            math.prod(t.shape) * 3
        assert t.sub_root == jt.sub_root


# ---------------------------------------------------------------- kernels


def _q_batch(k, lengths, seed=0):
    """(q [k, Np] int8, base [Np] fp32, scale_meta [nb, k], per-leaf
    scales [L, k], weights [k]) as torch; zero in the padding."""
    leaf_id, _, npad = batch_layout(lengths, BLOCK)
    rng = np.random.default_rng(seed)
    q = np.zeros((k, npad), np.int8)
    base = np.zeros(npad, np.float32)
    off = 0
    for n in lengths:
        q[:, off:off + n] = rng.integers(-127, 128, (k, n))
        base[off:off + n] = rng.standard_normal(n) * 0.5
        off += padded_len(n, BLOCK)
    scales = (rng.random((len(lengths), k)) * 0.02 + 1e-3).astype(np.float32)
    w = rng.standard_normal(k).astype(np.float32)
    return (torch.from_numpy(q), torch.from_numpy(base),
            torch.from_numpy(scales[leaf_id]), torch.from_numpy(scales),
            torch.from_numpy(w))


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_quant_nary_plain_vs_pallas(lengths, k):
    q, b, smeta, _, w = _q_batch(k, LENGTHS[lengths])
    got = quant.quant_nary(q, b, smeta, w, BLOCK).numpy()
    want = np.asarray(quant_nary_pallas(
        jnp.asarray(q.numpy()), jnp.asarray(b.numpy())[None, :],
        jnp.asarray(smeta.numpy()), jnp.asarray(w.numpy())[:, None],
        block=BLOCK, interpret=True))[0]
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("k", [1, 4, 16])
def test_quant_batch_merge_vs_oracles(k):
    """Per leaf bitwise against the port's dequantize-then-merge
    oracle; against the reference's flat batch within 1e-6."""
    lengths = LENGTHS["leaves"]
    rng = np.random.default_rng(k)
    qs = [torch.from_numpy(rng.integers(-127, 128, (k, n)).astype(np.int8))
          for n in lengths]
    scales = [torch.from_numpy((rng.random(k) * 0.02 + 1e-3).astype(
        np.float32)) for _ in lengths]
    bases = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             for n in lengths]
    w = rng.standard_normal(k).astype(np.float32).tolist()
    outs = ops.quant_batch_merge(qs, scales, bases, w, block=BLOCK)
    jouts = jops.quant_batch_merge(
        [jnp.asarray(x.numpy()) for x in qs],
        [jnp.asarray(s.numpy()) for s in scales],
        [jnp.asarray(b.numpy()) for b in bases], w, block=BLOCK,
        interpret=True)
    for x, s, b, o, jo in zip(qs, scales, bases, outs, jouts):
        assert torch.equal(o, ref.quant_nary_ref(x, s, b, torch.tensor(w)))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=1e-6,
                                   atol=1e-5)


def _dare_batch(k, lengths, dtype, seeds, seed=0):
    leaf_id, _, npad = batch_layout(lengths, BLOCK)
    rng = np.random.default_rng(seed)
    x = np.zeros((k, npad), np.float32)
    base = np.zeros(npad, np.float32)
    off = 0
    for n in lengths:
        x[:, off:off + n] = rng.standard_normal((k, n))
        base[off:off + n] = rng.standard_normal(n) * 0.5
        off += padded_len(n, BLOCK)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16).astype(np.float32)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        tx = torch.from_numpy(x)
    meta = torch.cat([dare.leaf_meta(s, padded_len(n, BLOCK), BLOCK,
                                     device="cpu")
                      for s, n in zip(seeds, lengths)])
    return tx, torch.from_numpy(base), x, base, meta


SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 32 - 1, 123456789]


def _assert_dare_equal(got, want, k):
    """Bitwise where XLA sums the tile's k rows in index order and the
    reciprocal of k is exact (k in {1, 2, 4}), else within 1e-6."""
    if k in (1, 2, 4):
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
def test_dare_block_plain_vs_pallas(lengths, dtype, k):
    ls = LENGTHS[lengths]
    tx, tb, x, b, meta = _dare_batch(k, ls, dtype, SEEDS[:len(ls)])
    got = dare.dare_block(tx, tb, meta, 0.3, BLOCK).numpy()
    want = np.asarray(dare_block_pallas(
        jnp.asarray(x), jnp.asarray(b)[None, :],
        jnp.asarray(meta.numpy().astype(np.uint32)), p=0.3, block=BLOCK,
        interpret=True))[0]
    _assert_dare_equal(got, want, k)


@pytest.mark.parametrize("k", [1, 3])
def test_dare_block_masks_bitwise(k):
    """Row i alone carries tau = 1, so out != base exactly where row i
    kept its element: the masks of the two kernels, compared bitwise."""
    ls = LENGTHS["leaves"]
    _, _, _, _, meta = _dare_batch(k, ls, "float32", SEEDS)
    npad = meta.shape[0] * BLOCK
    jmeta = jnp.asarray(meta.numpy().astype(np.uint32))
    for i in range(k):
        x = np.zeros((k, npad), np.float32)
        x[i] = 1.0
        got = dare.dare_block(torch.from_numpy(x), torch.zeros(npad), meta,
                              0.45, BLOCK).numpy() != 0
        want = np.asarray(dare_block_pallas(
            jnp.asarray(x), jnp.zeros((1, npad), jnp.float32), jmeta,
            p=0.45, block=BLOCK, interpret=True))[0] != 0
        assert np.array_equal(got, want)
        assert abs(got.mean() - (1 - 0.45)) < 0.02


@pytest.mark.parametrize("k", [1, 4, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dare_batch_merge_is_per_leaf(dtype, k):
    """The flat batch equals one launch per leaf and `ref.dare_ref` on
    the padded leaf, bitwise; the reference's flat batch within 1e-6."""
    lengths = LENGTHS["leaves"]
    rng = np.random.default_rng(10 + k)
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    rows = [torch.from_numpy(rng.standard_normal((k, n)).astype(
        np.float32)).to(tdt) for n in lengths]
    bases = [torch.from_numpy(rng.standard_normal(n).astype(np.float32))
             for n in lengths]
    seeds = SEEDS[:len(lengths)]
    outs = ops.dare_batch_merge(rows, bases, seeds, 0.4, block=BLOCK)
    jouts = jops.dare_batch_merge(
        [jnp.asarray(r.to(torch.float32).numpy()) for r in rows],
        [jnp.asarray(b.numpy()) for b in bases], seeds, 0.4, block=BLOCK,
        interpret=True)
    for r, b, s, o, jo in zip(rows, bases, seeds, outs, jouts):
        n = b.shape[0]
        solo, = ops.dare_batch_merge([r], [b], [s], 0.4, block=BLOCK)
        assert torch.equal(o, solo)
        npad = padded_len(n, BLOCK)
        rp = torch.zeros((k, npad), dtype=tdt)
        rp[:, :n] = r
        bp = torch.zeros(npad)
        bp[:n] = b
        assert torch.equal(o, ref.dare_ref(rp, bp, s, 0.4)[:n])
        _assert_dare_equal(o.numpy(), np.asarray(jo), k)


def test_dare_merge_per_leaf_entry():
    cs, base = _tree(np.random.default_rng(12), np.float32, 4)
    tc = [_torch_tree(c) for c in cs]
    got = ops.dare_merge(tc, _torch_tree(base), seed=31, p=0.5)
    want = jops.dare_merge([jax.tree_util.tree_map(jnp.asarray, c)
                            for c in cs],
                           jax.tree_util.tree_map(jnp.asarray, base),
                           seed=31, p=0.5, interpret=True)
    for g, w in zip(_np(got), _jleaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    with pytest.raises(TypeError, match="integer"):
        ops.dare_merge([{"a": torch.ones(3, dtype=torch.int32)}] * 2)


def test_kernel_wrappers_refuse_bad_operands():
    q, b, smeta, _, w = _q_batch(2, [100])
    with pytest.raises(TypeError, match="int8"):
        quant.quant_nary(q.to(torch.int16), b, smeta, w, BLOCK)
    with pytest.raises(ValueError, match="shape"):
        quant.quant_nary(q, b, smeta[:, :1], w, BLOCK)
    tx, tb, _, _, meta = _dare_batch(2, [100], "float32", [1])
    with pytest.raises(ValueError, match="p must"):
        dare.dare_block(tx, tb, meta, 1.0, BLOCK)
    with pytest.raises(TypeError, match="int64"):
        dare.dare_block(tx, tb, meta.to(torch.int32), 0.5, BLOCK)
    meta_dev = torch.empty((1, 3), dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="several devices"):
        dare.dare_block(tx, tb, meta_dev, 0.5, BLOCK)


# ----------------------------------------------------------------- engine


def _quantized(seed, k=3, dtype=np.float32):
    cs, base = _tree(np.random.default_rng(seed), dtype, k)
    jcts = [jcomp.compress_tree(jax.tree_util.tree_map(jnp.asarray, c))
            for c in cs]
    return jcts, [convert.from_numpy_compressed(j, "cpu") for j in jcts], \
        base


def test_engine_quant_route_zero_dequant():
    """A linear-family merge of int8 contributions: every multi-leaf
    group goes through quant_nary without densifying a slice; single
    leaves take the exact path, densified (k counts each)."""
    _, cts, _ = _quantized(12)
    cache = engine.EngineCache()
    plan = engine.plan_merge([engine.contrib_meta(c) for c in cts],
                             "weight_average")
    got = engine.execute_plan(plan, cts, use_cache=False, kernels=True,
                              max_batch_bytes=1 << 20, cache=cache)
    assert cache.stats["dequant_leaves"] == 0
    assert cache.obs.counter("engine_quant_leaves_merged_total").value() \
        == len(plan.tasks)
    assert cache.obs.counter("kernel_dispatch_total").value(
        kernel="quant_nary") == 1
    dense = [compression.decompress_tree(c) for c in cts]
    want = engine.merge(dense, "weight_average", use_cache=False)
    for g, w in zip(_np(got), _np(want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    # the default cap: one leaf's stack, so each leaf is its own group
    cache2 = engine.EngineCache()
    engine.execute_plan(plan, cts, use_cache=False, kernels=True,
                        cache=cache2)
    groups = engine._dispatch_groups(
        get_strategy("weight_average"), list(plan.tasks),
        max(t.stacked_nbytes for t in plan.tasks))
    singles = sum(1 for g in groups if len(g) == 1)
    assert cache2.stats["dequant_leaves"] == 3 * singles
    assert cache2.obs.counter("engine_quant_leaves_merged_total").value() \
        == len(plan.tasks) - singles


def test_engine_quant_route_mixed_group_dequantizes():
    """One dense contribution among int8 ones: the group is not all
    int8, so its int8 slices are densified, then merged by nary_accum;
    within fp32 reassociation (rtol 1e-5) of the exact route."""
    _, cts, _ = _quantized(13)
    cts[1] = compression.decompress_tree(cts[1])
    cache = engine.EngineCache()
    plan = engine.plan_merge([engine.contrib_meta(c) for c in cts],
                             "weight_average")
    got = engine.execute_plan(plan, cts, use_cache=False, kernels=True,
                              max_batch_bytes=1 << 20, cache=cache)
    assert cache.stats["dequant_leaves"] == 2 * len(plan.tasks)
    assert cache.obs.counter("kernel_dispatch_total").value(
        kernel="quant_nary") == 0
    assert cache.obs.counter("kernel_dispatch_total").value(
        kernel="nary_accum") == 1
    dense = [c if j == 1 else compression.decompress_tree(c)
             for j, c in enumerate(cts)]
    want = engine.merge(dense, "weight_average", use_cache=False)
    for g, w in zip(_np(got), _np(want)):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["weight_average", "task_arithmetic"])
def test_engine_quant_route_matches_reference_engine(name):
    """The same int8 payloads through both engines' kernel routes."""
    jcts, cts, base = _quantized(14, k=4)
    kw = dict(base=None) if name == "weight_average" else {}
    want = jeng.merge(jcts, spec=JSpec(name), pallas=True, use_cache=False,
                      max_batch_bytes=1 << 20,
                      **(kw or dict(base=jax.tree_util.tree_map(
                          jnp.asarray, base))))
    got = engine.merge(cts, spec=MergeSpec(name), kernels=True,
                       use_cache=False, max_batch_bytes=1 << 20,
                       **(kw or dict(base=_torch_tree(base))))
    for g, w in zip(_np(got), _jleaves(want)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def _dare_plan(seed=5, k=3):
    cs, base = _tree(np.random.default_rng(15), np.float32, k)
    tc = [_torch_tree(c) for c in cs]
    tb = pytree.tree_map(torch.zeros_like, tc[0])
    plan = engine.plan_merge([engine.contrib_meta(c) for c in tc], "dare",
                             base=tb, seed=seed)
    return cs, tc, tb, plan


def test_engine_dare_route_opt_in():
    """Off by default; on, deterministic, and bitwise the ops-level flat
    batch with the plan's per-task seeds (plan.seed + leaf index)."""
    cs, tc, tb, plan = _dare_plan()
    cache = engine.EngineCache()
    engine.execute_plan(plan, tc, base=tb, use_cache=False, kernels=True,
                        max_batch_bytes=1 << 20, cache=cache)
    assert cache.obs.counter("kernel_dispatch_total").value(
        kernel="dare") == 0
    kernel_env.dare_kernel_rng = True
    cache2 = engine.EngineCache()
    got = engine.execute_plan(plan, tc, base=tb, use_cache=False,
                              kernels=True, max_batch_bytes=1 << 20,
                              cache=cache2)
    assert cache2.obs.counter("kernel_dispatch_total").value(
        kernel="dare") == 1
    again = engine.execute_plan(plan, tc, base=tb, use_cache=False,
                                kernels=True, max_batch_bytes=1 << 20,
                                cache=engine.EngineCache())
    _same_bytes(_np(got), _np(again))
    flat = [pytree.leaves(c) for c in tc]
    want = ops.dare_batch_merge(
        [[f[t.index].reshape(-1) for f in flat] for t in plan.tasks],
        [torch.zeros(math.prod(t.shape)) for t in plan.tasks],
        [plan.seed + t.index for t in plan.tasks], 0.5)
    leaves = pytree.leaves(got)
    for t, w in zip(plan.tasks, want):
        assert torch.equal(leaves[t.index].reshape(-1), w)
    # the reference's route agrees within 1e-6 on a seed below 2^32
    jkernel_env.dare_kernel_rng = True
    jt = [jax.tree_util.tree_map(jnp.asarray, c) for c in cs]
    jgot = jeng.merge(jt, "dare", base=jax.tree_util.tree_map(
        jnp.zeros_like, jt[0]), seed=5, pallas=True, use_cache=False,
        max_batch_bytes=1 << 20)
    for g, w in zip(_np(got), _jleaves(jgot)):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_engine_dare_route_masks_a_63bit_seed():
    """A Merkle seed has 63 bits; the reference's jnp.uint32 refuses it,
    the port keeps the low 32 bits of plan.seed + leaf index."""
    seed = 2 ** 62 + 5
    with pytest.raises(OverflowError):
        jnp.uint32(seed)
    kernel_env.dare_kernel_rng = True
    _, tc, tb, plan = _dare_plan(seed=seed)
    got = pytree.leaves(engine.execute_plan(
        plan, tc, base=tb, use_cache=False, kernels=True,
        max_batch_bytes=1 << 20, cache=engine.EngineCache()))
    flat = [pytree.leaves(c) for c in tc]
    want = ops.dare_batch_merge(
        [[f[t.index].reshape(-1) for f in flat] for t in plan.tasks],
        [torch.zeros(math.prod(t.shape)) for t in plan.tasks],
        [(seed + t.index) & M32 for t in plan.tasks], 0.5)
    for t, w in zip(plan.tasks, want):
        assert torch.equal(got[t.index].reshape(-1), w)


def test_kernel_routes_never_enter_the_cache():
    kernel_env.dare_kernel_rng = True
    _, tc, tb, plan = _dare_plan()
    cache = engine.EngineCache()
    engine.execute_plan(plan, tc, base=tb, kernels=True,
                        max_batch_bytes=1 << 20, cache=cache)
    assert cache.info().entries == 0
    _, cts, _ = _quantized(16)
    cache = engine.EngineCache()
    engine.merge(cts, "weight_average", kernels=True,
                 max_batch_bytes=1 << 20, cache=cache)
    assert cache.info().entries == 0
    assert cache.obs.counter("kernel_dispatch_total").value(
        kernel="quant_nary") == 1


# ------------------------------------------------------------------ slice


def _phi3_narrow():
    """Numpy bf16 base + 4 contributions in the Phi-3-mini smoke layout
    at 2 layers."""
    from repro_torch.configs import smoke_config
    from repro_torch.models.model import Model
    from repro_torch.models.schema import schema_leaves
    cfg = smoke_config("phi3-mini-3.8b").replace(n_layers=2)
    rng = np.random.default_rng(21)

    def tree(fn):
        out = {}
        for path, pdef in schema_leaves(Model(cfg).schema()):
            node = out
            keys = [k.strip("'") for k in path[1:-1].split("][")]
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = fn(pdef.shape)
        return out

    base = tree(lambda s: (rng.standard_normal(s) * 0.02).astype(
        ml_dtypes.bfloat16))
    contribs = [jax.tree_util.tree_map(
        lambda b: (b.astype(np.float32) + 0.002 * rng.standard_normal(
            b.shape)).astype(ml_dtypes.bfloat16), base) for _ in range(4)]
    return base, contribs


@pytest.mark.parametrize("name", ["weight_average", "task_arithmetic",
                                  "dare"])
def test_slice_matches_reference(name):
    """The slice end to end at a narrow Phi-3-mini shape, default batch
    cap: int8 contributions for the linear family, bf16 ones for DARE
    with the kernel RNG on; `engine.merge(kernels=True)` against the
    reference's `merge(pallas=True)` (interpret mode) within one bf16
    ulp, and leaves alone in their group (the exact path) bitwise."""
    base, contribs = _phi3_narrow()
    jbase = jax.tree_util.tree_map(jnp.asarray, base)
    tbase = _torch_tree(base)
    uses_base = name != "weight_average"
    if name == "dare":
        kernel_env.dare_kernel_rng = jkernel_env.dare_kernel_rng = True
        jin = [jax.tree_util.tree_map(jnp.asarray, c) for c in contribs]
        tin = [_torch_tree(c) for c in contribs]
        kind = "dare"
    else:
        jin = [jcomp.compress_tree(jax.tree_util.tree_map(jnp.asarray, c))
               for c in contribs]
        tin = [convert.from_numpy_compressed(j, "cpu") for j in jin]
        kind = "quant_nary"
    want = _jleaves(jeng.merge(jin, spec=JSpec(name), seed=321,
                               base=jbase if uses_base else None,
                               pallas=True, use_cache=False))
    cache = engine.EngineCache()
    got = _np(engine.merge(tin, spec=MergeSpec(name), seed=321,
                           base=tbase if uses_base else None, kernels=True,
                           use_cache=False, cache=cache))
    assert cache.obs.counter("kernel_dispatch_total").value(kernel=kind) > 0
    plan = engine.plan_for(tin, spec=MergeSpec(name), seed=321,
                           base=tbase if uses_base else None)
    groups = engine._dispatch_groups(
        get_strategy(name), list(plan.tasks),
        max(t.stacked_nbytes for t in plan.tasks), fuse=True)
    alone = {g[0].index for g in groups if len(g) == 1}
    assert alone and len(alone) < len(plan.tasks)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if i in alone:
            assert g.tobytes() == w.tobytes()
        else:
            np.testing.assert_allclose(g.astype(np.float32),
                                       w.astype(np.float32), **BF16_ULP)
