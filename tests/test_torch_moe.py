"""Qwen3-MoE on the port against the JAX reference, on the CPU: the
config and parameter counts at full size, `Model.init`, the router, the
capacity and its drops, both dispatch backends, prefill / decode /
`greedy_decode`, merge -> serve through `Replica`, `Model.loss` with the
routers' aux term and its gradients, a Branch-Train-Merge round, the
serving CLI, and the families the port still refuses.

Inputs are made from a seed with numpy and handed to both packages
(`convert.from_numpy_tree`); the reference runs as its own tests run it
on the CPU. Each assertion says whether it is bitwise or within a
tolerance, and which; tolerances are at least twice the largest reading
on an x86 CPU.

Routing is exact where the reference defines integers: the top-k
indices, each assignment's position within its expert, `keep`, the
[G, E, C] dispatch table and its used-slot mask. The router's fp32
logits are sums in another order, so a token whose reference k-th and
(k+1)-th probabilities lie within 4 fp32 ulps may take the other
expert; the router test counts such tokens and excludes only them. In
the model-path tests the router is drawn at 1.0 (the rest at 0.02, the
norms near 1), so its top-k gaps are far wider than the compute dtype's
differences between the two packages' inputs to it (in bf16 the port's
attention keeps p . v in fp32 where the reference rounds p first).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import MergeSpec as JSpec  # noqa: E402
from repro import Replica as JReplica  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.params import count_params as jcount  # noqa: E402
from repro.models.params import (  # noqa: E402
    non_embedding_params as jnon_embedding)
from repro.train.btm import BranchTrainMerge as JBTM  # noqa: E402
from repro.train.serve import greedy_decode as jgreedy  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.model import Model, period_layout  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params, non_embedding_params)
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train.btm import BranchTrainMerge  # noqa: E402
from repro_torch.train.serve import greedy_decode  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "qwen3-moe-30b-a3b"
# prefill / decode against JAX by compute dtype: (logits atol, cache
# atol). fp32 read 1.9e-6 and 2.4e-7; bf16 read 0.0625 and 0.0039: one
# bf16 ulp of logits near 8 and of keys near 1
LIMITS = {"float32": (2e-5, 1e-5), "bfloat16": (0.25, 2.0 ** -6)}
# the MoE block's output in bf16, no element beyond this many bf16 ulps
# (2^-7) of the block's largest magnitude: against the reference's
# block (its elementwise steps, silu's sigmoid among them, round to
# bf16 one op at a time; read 1.26 ulps over 32 cases), and between the
# port's two backends (the gather rounds each gated row to bf16 before
# the sum over k, the einsum sums in fp32; read 0.96)
BF16_BLOCK_ULPS = {"reference": 3, "port": 2}


def _bf16_close(got, want, ulps) -> bool:
    return bool((np.abs(got - want)
                 <= ulps * 2.0 ** -7 * np.abs(want).max()).all())


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jeng.clear_cache()
    engine.clear_cache()


def _moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _configs(cd: str = "float32", **kw):
    cfg = smoke_config(ARCH).replace(compute_dtype=cd, **kw)
    jcfg = jsmoke(ARCH).replace(compute_dtype=cd, **kw)
    return cfg, jcfg


def _np_params(cfg, seed, router: float = 1.0):
    """Numpy fp32 weights in the port's layout: norms near 1, the router
    at `router`, the output head at 0.3 (logits of a few units, so the
    greedy tests' top-2 margins exceed the bf16 limit), embeddings 0.4,
    everything else 0.02."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, pdef in schema_leaves(Model(cfg).schema()):
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        if pdef.init == "ones":
            a = 1 + 0.1 * rng.standard_normal(pdef.shape)
        else:
            scale = {"embed": 0.4, "lm_head": 0.3,
                     "router": router}.get(keys[-1], 0.02)
            a = scale * rng.standard_normal(pdef.shape)
        node[keys[-1]] = a.astype(np.float32)
    return out


def _both(pn):
    return (jax.tree_util.tree_map(jnp.asarray, pn),
            convert.from_numpy_tree(pn, "cpu"))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(a, b) -> float:
    """max |a - b| over max |a| (a the reference)."""
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _tokens(jcfg, seq, batch):
    return jmake_batch(jcfg, JShape("s", seq, batch, "prefill"))["tokens"]


def _block_params(rng, d, e, f, router):
    """One MoE block's weights: the router at `router`, experts 0.1."""
    pn = {"router": (router * rng.standard_normal((d, e))).astype(
        np.float32),
          "experts": {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
                      for k, s in (("w_gate", (e, d, f)),
                                   ("w_up", (e, d, f)),
                                   ("w_down", (e, f, d)))}}
    return _both(pn)


def _ref_dispatch(idx, m, c):
    """The reference's integers of `moe_gather` (`models/moe.py:114-131`,
    the same jax ops): pos, keep, table, slot_used."""
    gdim, s, _ = idx.shape
    onehot_e = jax.nn.one_hot(idx, m.num_experts, dtype=jnp.int32)
    flat = onehot_e.reshape(gdim, s * m.top_k, m.num_experts)
    pos = jnp.cumsum(flat, axis=1) - flat
    pos = jnp.sum(pos * flat, axis=-1).reshape(gdim, s, m.top_k)
    keep = pos < c
    token_id = jnp.broadcast_to(jnp.arange(s)[None, :, None],
                                (gdim, s, m.top_k))

    def scatter_group(eidx, posg, tidg, keepg):
        tbl = jnp.zeros((m.num_experts, c), jnp.int32)
        iidx = jnp.stack([eidx.reshape(-1),
                          jnp.where(keepg, posg, c).reshape(-1)], -1)
        return tbl.at[iidx[:, 0], iidx[:, 1]].set(
            tidg.reshape(-1), mode="drop")

    table = jax.vmap(scatter_group)(idx, pos, token_id, keep)
    used = jax.vmap(scatter_group)(idx, pos, jnp.ones_like(token_id),
                                   keep).astype(bool)
    return [np.asarray(a) for a in (pos, keep, table, used)]


# ------------------------------------------------- config, counts, init


def test_config_equals_reference():
    """Exact: the port's qwen3-moe-30b-a3b is the reference's, field for
    field (its MoEConfig too), and so is its smoke reduction; one attn +
    moe sub-layer a period, 48 periods."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == \
        dataclasses.asdict(jsmoke(ARCH))
    layout, n = period_layout(get_config(ARCH))
    assert n == 48 and [(sl.mixer, sl.ffn) for sl in layout] == \
        [("attn", "moe")]


def test_count_params_equal_reference():
    """Exact: `count_params` and `non_embedding_params` at full size give
    the reference's (total, active), the experts at top_k / E active:
    30,532,110,336 parameters, 3,353,020,416 active."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert count_params(cfg) == jcount(jcfg) == \
        (30_532_110_336, 3_353_020_416)
    assert cfg.param_counts() == jcount(jcfg)
    assert non_embedding_params(cfg) == jnon_embedding(jcfg)
    sizes = dict(schema_leaves(Model(cfg).schema()))
    assert sizes["['blocks']['sub0']['ffn']['experts']['w_gate']"].shape \
        == (48, 128, 2048, 768)


def test_init_bitwise_and_schema_paths():
    """Bitwise: `Model.init(key)` at smoke size (4 experts, top-2,
    d_ff_expert 64, capacity factor 8) draws the reference's parameters,
    leaf for leaf by path, the router and the stacked experts
    included."""
    cfg, jcfg = _configs()
    got = Model(cfg).init(prng.PRNGKey(3), device="cpu")
    want = JModel(jcfg).init(jax.random.PRNGKey(3))
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    flat = pytree.flatten_with_path(got)[0]
    assert [pytree.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    assert "['blocks']['sub0']['ffn']['router']" in \
        [pytree.keystr(p) for p, _ in flat]
    for (_, a), (_, b) in zip(flat, jflat):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------ the router


@pytest.mark.parametrize("e,k", [(4, 2), (16, 4)])
@pytest.mark.parametrize("seed", range(8))
def test_router_matches_reference(e, k, seed):
    """gates within 1e-6 and aux within 1e-6 (fp32; read 4.2e-7 and
    2.4e-7); idx exactly equal, except on tokens whose reference k-th and
    (k+1)-th probabilities lie within 4 fp32 ulps, which are counted
    (and none of these seeds has one)."""
    m = dataclasses.replace(smoke_config(ARCH).moe, num_experts=e,
                            top_k=k)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 17, 64)).astype(np.float32)
    jp, tp = _block_params(rng, 64, e, 8, 0.3)
    jg, ji, ja = JM._router(jp, jnp.asarray(x), m)
    tg, ti, ta = TM._router(tp, torch.from_numpy(x), m)
    assert ti.dtype == torch.int32 and tuple(ti.shape) == (3, 17, k)
    probs = np.sort(np.asarray(jax.nn.softmax(
        jnp.asarray(x) @ jp["router"], axis=-1)), axis=-1)[..., ::-1]
    near = np.abs(probs[..., k - 1] - probs[..., k]) <= \
        4 * np.spacing(probs[..., k - 1])
    same = (np.asarray(ji) == ti.numpy()).all(-1)
    assert (same | near).all()
    assert int(near.sum()) == 0
    np.testing.assert_allclose(tg.numpy()[same], np.asarray(jg)[same],
                               rtol=0, atol=1e-6)
    assert abs(float(ta) - float(ja)) <= 1e-6


def test_router_ties_lower_index_first():
    """Exact: experts whose router columns are equal tie on every token;
    the port's top-k takes the lower index first, as `jax.lax.top_k`
    does, and gates and aux equal the reference's within 1e-6."""
    m = dataclasses.replace(smoke_config(ARCH).moe, num_experts=6,
                            top_k=3)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    router = (0.1 * rng.standard_normal((64, 6))).astype(np.float32)
    router[:, 4] = router[:, 1]
    router[:, 5] = router[:, 1]
    router[:, 3] = router[:, 0]
    jp = {"router": jnp.asarray(router)}
    tp = {"router": torch.from_numpy(router)}
    jg, ji, ja = JM._router(jp, jnp.asarray(x), m)
    tg, ti, ta = TM._router(tp, torch.from_numpy(x), m)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    for row in ti.reshape(-1, 3).tolist():
        for a, b in zip(row, row[1:]):
            if {a, b} <= {1, 4, 5} or {a, b} <= {0, 3}:
                assert a < b
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)
    assert abs(float(ta) - float(ja)) <= 1e-6


# ------------------------------------------------ capacity, drops, blocks


@pytest.mark.parametrize("cf", [0.5, 8.0])
@pytest.mark.parametrize("seed", range(3))
def test_dispatch_integers_exact(cf, seed):
    """Exact: `_capacity`, and `pos`, `keep`, the [G, E, C] table and
    `slot_used` equal the reference's integers on the same router
    indices; at capacity factor 0.5 tokens are dropped (counted > 0), at
    8 none."""
    m = dataclasses.replace(smoke_config(ARCH).moe, capacity_factor=cf)
    for s in (1, 3, 40):
        assert TM._capacity(m, s) == JM._capacity(m, s)
    c = TM._capacity(m, 40)
    rng = np.random.default_rng(seed)
    idx = np.stack([np.stack([rng.permutation(m.num_experts)[:m.top_k]
                              for _ in range(40)]) for _ in range(3)]
                   ).astype(np.int32)
    want = _ref_dispatch(jnp.asarray(idx), m, c)
    got = TM._dispatch(torch.from_numpy(idx), m.num_experts, c)
    for w, g in zip(want, got):
        assert g.shape == w.shape
        assert np.array_equal(g.numpy(), w)
    dropped = int((~want[1]).sum())
    assert (dropped > 0) if cf < 1 else (dropped == 0)


def _block_case(seed, cf, e=4, k=2):
    cfg, jcfg = _configs()
    cfg = _moe(cfg, capacity_factor=cf, num_experts=e, top_k=k)
    jcfg = _moe(jcfg, capacity_factor=cf, num_experts=e, top_k=k)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 20, 64)).astype(np.float32)
    jp, tp = _block_params(rng, 64, e, 64, 0.5)
    return cfg, jcfg, x, jp, tp


@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("cf", [0.5, 8.0])
@pytest.mark.parametrize("seed", range(3))
def test_moe_block_matches_reference(impl, cf, seed):
    """The port's `moe_gather` / `moe_einsum` against the reference's,
    with drops (capacity factor 0.5) and without: fp32 within 1e-5
    (read 8.6e-7); bf16 within BF16_BLOCK_ULPS["reference"]. aux within
    1e-6."""
    cfg, jcfg, x, jp, tp = _block_case(seed, cf)
    jfn = JM.moe_gather if impl == "gather" else JM.moe_einsum
    tfn = TM.moe_gather if impl == "gather" else TM.moe_einsum
    for cd, jcd in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        jy, ja = jfn(jp, jnp.asarray(x), jcfg, jcd)
        ty, ta = tfn(tp, torch.from_numpy(x), cfg, cd)
        assert ty.dtype == cd and tuple(ty.shape) == (3, 20, 64)
        want, got = _f32(jy), _f32(ty)
        if cd == torch.float32:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        else:
            assert _bf16_close(got, want, BF16_BLOCK_ULPS["reference"])
        assert abs(float(ta) - float(ja)) <= 1e-6


@pytest.mark.parametrize("cf", [0.5, 8.0])
def test_gather_matches_einsum_in_the_port(cf):
    """The port's two backends agree: fp32 within 1e-6 (read 6e-8); bf16
    within BF16_BLOCK_ULPS["port"]; aux bitwise (the same router)."""
    cfg, _, x, _, tp = _block_case(7, cf)
    for cd in (torch.float32, torch.bfloat16):
        gy, ga = TM.moe_gather(tp, torch.from_numpy(x), cfg, cd)
        ey, ea = TM.moe_einsum(tp, torch.from_numpy(x), cfg, cd)
        if cd == torch.float32:
            np.testing.assert_allclose(_f32(gy), _f32(ey), rtol=0,
                                       atol=1e-6)
        else:
            assert _bf16_close(_f32(gy), _f32(ey), BF16_BLOCK_ULPS["port"])
        assert torch.equal(ga, ea)


def test_moe_block_shared_expert():
    """A shared expert (DeepSeek-V2's `num_shared_experts`) is defined and
    added as the reference's: the schema's `shared` leaves, and the
    block's output within 1e-5 in fp32."""
    cfg, jcfg = _configs()
    cfg = _moe(cfg, num_shared_experts=1, d_ff_shared=32)
    jcfg = _moe(jcfg, num_shared_experts=1, d_ff_shared=32)
    assert sorted(TM.moe_def(cfg)) == sorted(JM.moe_def(jcfg)) == \
        ["experts", "router", "shared"]
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    pn = {"router": (0.5 * rng.standard_normal((64, 4))).astype(np.float32),
          "experts": {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
                      for k, s in (("w_gate", (4, 64, 64)),
                                   ("w_up", (4, 64, 64)),
                                   ("w_down", (4, 64, 64)))},
          "shared": {k: (0.1 * rng.standard_normal(s)).astype(np.float32)
                     for k, s in (("w_gate", (64, 32)), ("w_up", (64, 32)),
                                  ("w_down", (32, 64)))}}
    jp, tp = _both(pn)
    jy, _ = JM.moe_block(jp, jnp.asarray(x), jcfg, jnp.float32)
    ty, _ = TM.moe_block(tp, torch.from_numpy(x), cfg, torch.float32)
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=0, atol=1e-5)


# ------------------------------------------------------- prefill / decode


def _close_caches(tc, jc, lim):
    jleaves = jax.tree_util.tree_leaves(jc)
    tleaves = pytree.leaves(tc)
    assert [tuple(t.shape) for t in tleaves] == [a.shape for a in jleaves]
    for t, a in zip(tleaves, jleaves):
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_allclose(_f32(t), _f32(a), rtol=0, atol=lim)


@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,max_len", [(13, 16), (40, 44)])
def test_prefill_matches_reference(impl, cd, s, max_len):
    """Last logits and every cache leaf within LIMITS[cd], both dispatch
    backends (the reference's `moe_impl` the same), prompts of 13 and
    40 (past the 32-query chunk, so the reference scans)."""
    cfg, jcfg = _configs(cd)
    toks = _tokens(jcfg, s, 3)
    jp, tp = _both(_np_params(cfg, 3))
    jl, jc = JModel(jcfg, moe_impl=impl).prefill(
        jp, {"tokens": jnp.asarray(toks)}, max_len=max_len)
    tl, tc = Model(cfg, moe_impl=impl).prefill(
        tp, {"tokens": torch.from_numpy(toks)}, max_len=max_len)
    assert tl.dtype == torch.float32 and tl.shape == (3, cfg.vocab_size)
    lim_logits, lim_cache = LIMITS[cd]
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=lim_logits)
    _close_caches(tc, jc, lim_cache)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_matches_reference(cd):
    """A prompt of 8, then 9 decode steps (one token a group: capacity 8,
    no drops), each fed the reference's next token: every step's logits
    within LIMITS[cd], and every cache leaf after the last step within
    its cache limit."""
    cfg, jcfg = _configs(cd)
    toks = _tokens(jcfg, 17, 2)
    jp, tp = _both(_np_params(cfg, 4))
    jm, tm = JModel(jcfg), Model(cfg)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :8])},
                        max_len=20)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :8])},
                        max_len=20)
    lim_logits, lim_cache = LIMITS[cd]
    for pos in range(8, 17):
        tok = toks[:, pos:pos + 1]
        jl, jc = jm.decode_step(jp, jc, jnp.asarray(tok),
                                jnp.asarray(pos, jnp.int32))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=lim_logits)
    _close_caches(tc, jc, lim_cache)


def _jax_greedy_logits(jm, jp, toks, steps):
    """The reference's greedy loop, keeping each step's logits."""
    pos = toks.shape[1]
    logits, caches = jm.prefill(jp, {"tokens": jnp.asarray(toks)},
                                max_len=pos + steps)
    out, every = [], [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(steps):
        out.append(np.asarray(tok))
        logits, caches = jm.decode_step(jp, caches, tok,
                                        jnp.asarray(pos + i, jnp.int32))
        every.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return np.concatenate(out, axis=1), every


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_greedy_decode_matches_reference(cd):
    """fp32: tokens equal to the reference's `greedy_decode` over 8
    steps past a 7-token prompt, every step's logits within LIMITS.
    bf16: per row, tokens equal at every step up to the first whose
    reference top-2 margin is within the logits limit."""
    cfg, jcfg = _configs(cd)
    jp, tp = _both(_np_params(cfg, 5))
    toks = _tokens(jcfg, 7, 3)
    steps = 8
    got, logits = greedy_decode(Model(cfg), tp,
                                {"tokens": torch.from_numpy(toks)}, steps,
                                return_logits=True)
    want, every = _jax_greedy_logits(JModel(jcfg), jp, toks, steps)
    assert np.array_equal(np.asarray(jgreedy(JModel(jcfg), jp, {
        "tokens": jnp.asarray(toks)}, steps)), want)
    assert got.dtype == torch.int32 and got.shape == (3, steps)
    lim = LIMITS[cd][0]
    if cd == "float32":
        assert np.array_equal(got.numpy(), want)
        for got_l, want_l in zip(logits, every):
            np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0,
                                       atol=lim)
        return
    compared = 0
    for r in range(want.shape[0]):
        for i in range(steps):
            top2 = np.sort(every[i][r])[-2:]
            if top2[1] - top2[0] <= lim:
                break
            assert got[r, i].item() == want[r, i], (r, i)
            compared += 1
    assert compared >= 3           # the check is not vacuous


def test_decode_parity_with_full_forward():
    """Within 2e-5, fp32, no drops (capacity factor 8): prefill(T) +
    decode steps to T + 6 give the last logits of prefill(T + 6), as
    tests/test_models_smoke.py checks for the reference."""
    cfg, jcfg = _configs()
    _, tp = _both(_np_params(cfg, 9))
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(jcfg, 13, 2))
    full, _ = model.prefill(tp, {"tokens": toks})
    _, caches = model.prefill(tp, {"tokens": toks[:, :7]}, max_len=13)
    for pos in range(7, 13):
        inc, _ = model.decode_step(tp, caches, toks[:, pos:pos + 1], pos)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=0, atol=2e-5)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_merge_then_serve_matches_reference(cd):
    """A base and two contributions (base + 0.01 x a seeded delta)
    through `Replica` and TIES, as `examples/serve_merged.py` does: the
    port's merged tree bitwise the reference's (fp32 weights; exact
    path), replicas fed in opposite orders byte-equal, and
    `greedy_decode` of 6 tokens served from both byte-equal (tokens and
    logits); fp32 compute gives the reference's tokens, bf16 its tokens
    up to the first step whose top-2 margin is within the logits
    limit."""
    cfg, jcfg = _configs(cd)
    base = _np_params(cfg, 21)
    rng = np.random.default_rng(22)
    contribs = [jax.tree_util.tree_map(
        lambda b: (b + 0.01 * rng.standard_normal(b.shape)).astype(
            np.float32), base) for _ in range(2)]
    jrep = JReplica("ref")
    for c in contribs:
        jrep.contribute(jax.tree_util.tree_map(jnp.asarray, c))
    jref = jrep.register_base(jax.tree_util.tree_map(jnp.asarray, base))
    jmerged = jrep.resolve(JSpec("ties", base_ref=jref))
    toks = _tokens(jcfg, 6, 2)
    want, every = _jax_greedy_logits(JModel(jcfg), jmerged, toks, 6)
    outs = []
    for order in ([0, 1], [1, 0]):
        rep = Replica(f"port-{order[0]}", device="cpu")
        for i in order:
            rep.contribute(convert.from_numpy_tree(contribs[i], "cpu"))
        ref = rep.register_base(convert.from_numpy_tree(base, "cpu"))
        assert rep.merkle_root() == jrep.merkle_root()
        merged = rep.resolve(MergeSpec("ties", base_ref=ref))
        for a, b in zip(pytree.leaves(merged),
                        jax.tree_util.tree_leaves(jmerged)):
            assert np.array_equal(a.numpy(), np.asarray(b))
        outs.append(greedy_decode(Model(cfg), merged,
                                  {"tokens": torch.from_numpy(toks)}, 6,
                                  return_logits=True))
    (t0, l0), (t1, l1) = outs
    assert torch.equal(t0, t1)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(l0, l1))
    lim = LIMITS[cd][0]
    compared = 0
    for r in range(2):
        for i in range(6):
            top2 = np.sort(every[i][r])[-2:]
            if cd != "float32" and top2[1] - top2[0] <= lim:
                break
            assert t0[r, i].item() == want[r, i], (r, i)
            compared += 1
    assert compared >= 3


# ------------------------------------------------------- loss, gradients


GRAD_LEAVES = ("['blocks']['sub0']['ffn']['router']",
               "['blocks']['sub0']['ffn']['experts']['w_gate']",
               "['blocks']['sub0']['ffn']['experts']['w_up']",
               "['blocks']['sub0']['ffn']['experts']['w_down']",
               "['blocks']['sub0']['attn']['wq']")


@pytest.mark.parametrize("cd,remat,impl", [("float32", "none", "gather"),
                                           ("float32", "full", "gather"),
                                           ("float32", "none", "einsum"),
                                           ("bfloat16", "none", "gather")])
def test_loss_and_grads_match_reference(cd, remat, impl):
    """`Model.loss` (ce, aux and the total ce + 0.001 aux) and the
    gradients of the router, the three expert leaves and one attention
    leaf (every other leaf too) against `jax.value_and_grad(model.loss)`
    over 2 layers of routed experts with drops (capacity factor 0.5):
    fp32 ce and total within 1e-6 relative, aux within 1e-6, gradients
    within 2e-5 of each leaf's largest magnitude (read ~1e-6); bf16
    within 2e-4, 1e-2 and 5e-2 (aux read 3.2e-3: the router at 1.0 on
    inputs a bf16 ulp apart moves its probabilities by ~1e-3)."""
    cfg, jcfg = _configs(cd, remat=remat, n_layers=2)
    cfg, jcfg = _moe(cfg, capacity_factor=0.5), _moe(jcfg,
                                                      capacity_factor=0.5)
    pn = _np_params(cfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        convert.from_numpy_tree(pn, "cpu"))
    toks = np.random.default_rng(7).integers(0, 503, (2, 24)).astype(
        np.int32)
    (jl, jmets), jg = jax.value_and_grad(
        JModel(jcfg, moe_impl=impl).loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    loss, mets = Model(cfg, moe_impl=impl).loss(p, {"tokens": toks})
    loss.backward()
    lt, at, gt = (1e-6, 1e-6, 2e-5) if cd == "float32" else \
        (2e-4, 1e-2, 5e-2)
    assert abs(float(loss.detach()) - float(jl)) <= lt * abs(float(jl))
    assert abs(float(mets["ce"].detach()) - float(jmets["ce"])) <= \
        lt * abs(float(jmets["ce"]))
    assert abs(float(mets["aux"].detach()) - float(jmets["aux"])) <= at
    assert float(jmets["aux"]) > 1.0       # 2 layers of a term near 1
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    flat, _ = pytree.flatten_with_path(p)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [pytree.keystr(k) for k, _ in flat]
    seen = set()
    for (path, a), (_, t) in zip(jflat, flat):
        assert _rel(a, t.grad) <= gt, jax.tree_util.keystr(path)
        seen.add(jax.tree_util.keystr(path))
    assert set(GRAD_LEAVES) <= seen


def test_router_aux_gradient_matches_reference():
    """The aux term's own gradient with respect to the router (through
    the mean probabilities; the density is piecewise constant), fp32,
    within 4e-6 of its largest magnitude (read 1.45e-6)."""
    m = smoke_config(ARCH).moe
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    router = (0.3 * rng.standard_normal((64, 4))).astype(np.float32)
    jgrad = jax.grad(lambda r: JM._router({"router": r}, jnp.asarray(x),
                                          m)[2])(jnp.asarray(router))
    tr = torch.from_numpy(router).requires_grad_()
    TM._router({"router": tr}, torch.from_numpy(x), m)[2].backward()
    assert _rel(jgrad, tr.grad) <= 4e-6


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """One `make_train_step` (fp32 compute and moments, grad_accum 1 and
    2, capacity factor 0.5 so tokens drop) through the per-layer
    gradient views (`_grad_views`) and remat, against
    `jax.jit(make_train_step)`: loss (ce), aux and grad norm within 1e-4
    relative, parameters and moments within 2e-4 of each leaf's largest
    magnitude (the aux term's gradient reaches the router through the
    views)."""
    from repro.optim.adamw import init_opt_state as jinit_opt
    from repro.train.step import make_train_step as jmake_step
    from repro_torch.train.step import init_train_state, make_train_step
    cfg, jcfg = _configs(remat="full", n_layers=2)
    cfg, jcfg = _moe(cfg, capacity_factor=0.5), _moe(jcfg,
                                                      capacity_factor=0.5)
    pn = _np_params(cfg, 6)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    jopt = jinit_opt(jp, jcfg.opt_state_dtype)
    jstate = {"params": jp, "m": jopt["m"], "v": jopt["v"],
              "step": jnp.zeros((), jnp.int32)}
    state = init_train_state(Model(cfg), params=convert.from_numpy_tree(
        pn, "cpu"), device="cpu")
    toks = np.random.default_rng(8).integers(0, 503, (4, 24)).astype(
        np.int32)
    jstate, jmets = jax.jit(jmake_step(JModel(jcfg), total_steps=10,
                                       grad_accum=accum))(
        jstate, {"tokens": jnp.asarray(toks)})
    state, mets = make_train_step(Model(cfg), total_steps=10,
                                  grad_accum=accum)(state, {"tokens": toks})
    for key in ("loss", "aux", "grad_norm"):
        assert abs(float(mets[key]) - float(jmets[key])) <= \
            1e-4 * abs(float(jmets[key])), key
    for part in ("params", "m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[part]),
                        pytree.leaves(state[part])):
            assert _rel(a, b) <= 2e-4


# -------------------------------------------------------------- BTM, CLI


def test_btm_round_through_replica():
    """One Branch-Train-Merge round (2 branches, weight_average, a merge
    every 2 steps) on the MoE smoke model in both packages from the
    reference's init: each branch's losses within 2e-4 relative of the
    reference's (bf16 compute), both branches byte-identical after the
    merge, and that model bitwise the port's `Replica` resolving
    weight_average over the two branches' contributions."""
    cfg, jcfg = _configs(grad_accum=1)
    kw = dict(n_branches=2, strategy="weight_average", merge_every=2,
              batch_size=4, seq_len=16)
    jb, tb = JBTM(jcfg, **kw), BranchTrainMerge(cfg, device="cpu", **kw)
    contributed = []
    net = tb.net
    real = [node.contribute for node in net.nodes]
    for node, fn in zip(net.nodes, real):
        def spy(c, *a, _fn=fn, **k):
            contributed.append(pytree.tree_map(lambda t: t.clone(), c))
            return _fn(c, *a, **k)
        node.contribute = spy
    rj, rt = jb.train_round(), tb.train_round()
    assert sorted(rj["losses"]) == sorted(rt["losses"]) == [0, 1]
    for i, loss in rj["losses"].items():
        assert abs(rt["losses"][i] - loss) <= 2e-4 * abs(loss)
    a, b = (pytree.leaves(br.state["params"]) for br in tb.branches)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert len(contributed) == 2
    rep = Replica("btm-check", device="cpu")
    for c in contributed:
        rep.contribute(c)
    merged = rep.resolve(MergeSpec("weight_average"))
    assert all(torch.equal(x, y.to(x.dtype))
               for x, y in zip(a, pytree.leaves(merged)))


def test_serve_cli_on_the_cpu():
    """The CLI serves Qwen3-MoE's smoke config on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu"], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("generated (4, 8) tokens in ")
    assert "sample: [" in proc.stdout


# ------------------------------------------------------------- refusals


def _port_config(name):
    """The reference's config as the port's dataclasses (the port
    registers only the families it runs)."""
    j = jget_config(name)
    kw = dataclasses.asdict(j)
    for field, cls in (("moe", tbase.MoEConfig), ("mla", tbase.MLAConfig),
                       ("mamba", tbase.MambaConfig)):
        if kw[field] is not None:
            kw[field] = cls(**kw[field])
    return tbase.ModelConfig(**kw)


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "mamba2-780m",
                                  "jamba-1.5-large-398b", "whisper-tiny",
                                  "llama-3.2-vision-90b"])
def test_other_families_still_refused(name):
    """Exact: MLA (DeepSeek-V2, family moe), ssm, hybrid, encdec and vlm
    raise `NotImplementedError` naming ROADMAP A7."""
    cfg = _port_config(name)
    with pytest.raises(NotImplementedError, match="ROADMAP A7"):
        Model(cfg)


# ----------------------------------------------- int8 over expert leaves


def test_int8_weight_average_of_expert_leaves_on_arrival():
    """The chip smoke's int8 route over the stacked expert leaves, at
    smoke size on the CPU (the kernels' plain versions): two int8
    payloads through a `Replica` with the base registered, weight_average
    with a batch cap of two expert leaves, so every group holds more
    than one leaf: every leaf merged on arrival
    (engine_quant_leaves_merged_total), no slice densified, one
    `quant_batch_merge` without a base row; each expert leaf bitwise
    `quant_nary_ref` on the payloads' own rows, and within a bf16 ulp
    (2^-7) of the slices' mean magnitude plus one of the result's of the
    exact path's, which rounds each dequantized slice to bf16 first
    (where the slices cancel, that rounding is large beside the
    result)."""
    from repro_torch.core.compression import compress_tree, decompress_tree
    from repro_torch.core.resolve import canonical_order, seed_from_root
    from repro_torch.kernels.ref import quant_nary_ref
    cfg, _ = _configs(n_layers=3)
    base = convert.from_numpy_tree(_np_params(cfg, 31), "cpu")
    base = pytree.tree_map(lambda t: t.to(torch.bfloat16), base)
    rng = np.random.default_rng(32)
    cts = [compress_tree(pytree.tree_map(
        lambda b: b + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(b.shape)).astype(np.float32)).to(torch.bfloat16), base))
        for _ in range(2)]
    rep = Replica("int8-experts", device="cpu")
    for j, ct in enumerate(cts):
        rep.contribute(ct, f"{j:064x}")
    rep.register_base(base)
    order = canonical_order(rep.state)
    payloads = [rep.state.store[e] for e in order]
    paths = pytree.leaf_paths(pytree.flatten(base)[1])
    expert = [p for p in paths if "['experts']" in p]
    big = max(t.numel() for t in pytree.leaves(base))
    got = engine.merge(payloads, spec=MergeSpec("weight_average"),
                       contrib_ids=order,
                       seed=seed_from_root(rep.merkle_root()),
                       kernels=True, use_cache=False,
                       max_batch_bytes=2 * 2 * big, cache=rep.cache)
    n = len(paths)
    assert rep.cache.obs.counter(
        "engine_quant_leaves_merged_total").value() == n
    assert rep.cache.stats["dequant_leaves"] == 0
    flat = dict(zip(paths, pytree.leaves(got)))
    exact = dict(zip(paths, pytree.leaves(engine.merge(
        [decompress_tree(p) for p in payloads], "weight_average",
        use_cache=False))))
    w = torch.full((2,), 0.5)
    for path in expert:
        rows = [dict(zip(pytree.leaf_paths(p.treedef), p.leaves))[path]
                for p in payloads]
        want = quant_nary_ref(torch.stack([r.q.reshape(-1) for r in rows]),
                              torch.stack([r.scale for r in rows]),
                              torch.zeros(rows[0].q.numel()), w)
        assert torch.equal(flat[path].reshape(-1),
                           want.to(torch.bfloat16))
        # the exact path rounds each dequantized slice to bf16 before
        # averaging: within a bf16 ulp of the slices' mean magnitude
        # and of the result's
        e = exact[path].float().reshape(-1)
        mag = sum((r.q.reshape(-1).float() * r.scale).abs()
                  for r in rows) / len(rows)
        assert bool(((flat[path].float().reshape(-1) - e).abs()
                     <= 2.0 ** -7 * (mag + e.abs())).all())


def test_quant_nary_without_a_base_row():
    """Bitwise: B2's plain version without a base row equals it over a
    zero base row."""
    from repro_torch.kernels import quant
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.integers(-127, 128, (3, 4096)).astype(np.int8))
    smeta = torch.from_numpy(rng.random((2, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(3).astype(np.float32))
    assert torch.equal(quant.quant_nary(q, None, smeta, w, 2048),
                       quant.quant_nary(q, torch.zeros(4096), smeta, w,
                                        2048))
