"""Jamba-1.5-Large (the hybrid family) on the port against the JAX
reference, on the CPU: the config, `period_layout` and `count_params` at
full size and at the chip smoke's cuts, `Model.init`, `prefill` with
every cache leaf, decode steps, `greedy_decode` (fp32 and bf16, both
MoE dispatch backends), decode against the full forward, `Model.loss`
with the routers' aux term and its gradients, the train step with the
config's bf16 moments, a Branch-Train-Merge round through `Replica`,
the sparse merge whose fine-tunes leave the experts to the base, and
the serve, train and merge CLIs.

Smoke size: the reference's `smoke_config` wiring, one period of 4
sub-layers (attention + dense FFN, Mamba + MoE, Mamba + dense FFN,
Mamba + MoE), d_model 64, 4 heads of 16 over 4 KV heads, 8 SSD heads of
16, d_state 16, chunk 16, 4 experts top-2. Inputs are made from a seed
with numpy and handed to both packages (`convert.from_numpy_tree`); the
reference's prefill, decode and loss run under `jax.jit`. Each
assertion says whether it is bitwise or within a tolerance; every
tolerance is at least twice the largest reading on an x86 CPU.

The weights are drawn so that every part matters: norms and D near 1,
the router at 1.0 (its top-2 gaps far wider than the two packages'
differences), the output head at 0.3, the embedding at 0.4, the Mamba
mixer as `tests/test_torch_mamba.py` draws it, the rest at 0.02.
"""
import dataclasses
import functools

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
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import period_layout as jperiod  # noqa: E402
from repro.models.params import count_params as jcount  # noqa: E402
from repro.models.params import (  # noqa: E402
    non_embedding_params as jnon_embedding)
from repro.optim.adamw import init_opt_state as jinit_opt  # noqa: E402
from repro.train.btm import BranchTrainMerge as JBTM  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.resolve import canonical_order, seed_from_root  # noqa: E402,E501
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.models.model import Model, period_layout  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params, non_embedding_params)
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train.btm import BranchTrainMerge  # noqa: E402
from repro_torch.train.serve import greedy_decode  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    init_train_state, make_train_step, train_state_shapes)

torch.set_num_threads(1)

ARCH = "jamba-1.5-large-398b"
# the model against the reference by compute dtype: (logits atol, KV
# cache atol, SSM state atol, conv cache atol), logits up to ~9. fp32
# read 6.0e-6, 2.4e-7, 2.6e-6 and 1.5e-6; bf16 read 0.17, 0 (the
# attention sub-layer comes first: its inputs are the embeddings), 0.066
# and 0.042 (the port rounds each bf16 step of the reference's program,
# where XLA's fusions keep fp32 across some: a few bf16 ulps)
LIMITS = {"float32": (5e-5, 1e-5, 1e-5, 1e-5),
          "bfloat16": (0.75, 2.0 ** -5, 0.25, 0.125)}
SCALES = {"embed": 0.4, "lm_head": 0.3, "router": 1.0, "w_in": 0.1,
          "w_out": 0.1, "conv_w": 0.3, "conv_b": 0.1, "a_log": 0.3,
          "dt_bias": 0.3}
EXPERTS = "['experts']"


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jeng.clear_cache()
    engine.clear_cache()


@functools.cache
def _jref(jcfg, impl="gather"):
    """The reference model's prefill, decode step and loss gradient,
    each under `jax.jit` (compiled once a shape)."""
    jm = JModel(jcfg, moe_impl=impl)
    return (jax.jit(jm.prefill, static_argnums=2), jax.jit(jm.decode_step),
            jax.jit(jax.value_and_grad(jm.loss, has_aux=True)))


def _moe(cfg, **kw):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **kw))


def _configs(cd: str = "float32", **kw):
    return (smoke_config(ARCH).replace(compute_dtype=cd, **kw),
            jsmoke(ARCH).replace(compute_dtype=cd, **kw))


def _np_params(cfg, seed):
    """Numpy fp32 weights in the port's layout (module docstring)."""
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
            a = SCALES.get(keys[-1], 0.02) * rng.standard_normal(pdef.shape)
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


def _close_caches(got, want, cd):
    """Every cache leaf: the attention sub-layer's keys and values, each
    Mamba sub-layer's SSM state (fp32) and conv cache."""
    _, lim_kv, lim_ssm, lim_conv = LIMITS[cd]
    layout, _ = period_layout(smoke_config(ARCH))
    assert sorted(got["blocks"]) == sorted(want["blocks"])
    for j, sl in enumerate(layout):
        (ta, tb), (ja, jb) = got["blocks"][f"sub{j}"], \
            want["blocks"][f"sub{j}"]
        assert tuple(ta.shape) == ja.shape and tuple(tb.shape) == jb.shape
        if sl.mixer == "attn":
            assert ta.dtype == tb.dtype == getattr(torch, cd)
            lims = (lim_kv, lim_kv)
        else:
            assert ta.dtype == torch.float32 and tb.dtype == getattr(torch,
                                                                     cd)
            lims = (lim_ssm, lim_conv)
        for t, a, lim in zip((ta, tb), (ja, jb), lims):
            np.testing.assert_allclose(_f32(t), _f32(a), rtol=0, atol=lim)


# ------------------------------------------- config, layout, counts, init


def test_config_equals_reference():
    """Exact: the port's jamba-1.5-large-398b is the reference's, field
    for field (its MambaConfig and MoEConfig too), and so is its smoke
    reduction; RoPE on (the reference's default rope_theta)."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == \
        dataclasses.asdict(jsmoke(ARCH))
    assert get_config(ARCH).rope_theta > 0
    assert TM.mamba_dims(get_config(ARCH)) == (16384, 128, 16640)


@pytest.mark.parametrize("which", ["full", "smoke", "period-4 cut",
                                   "period-2 cut"])
def test_period_layout_equals_reference(which):
    """Exact: the sub-layers (mixer, FFN, window) and the number of
    periods. Full: period 8, attention at 4, MoE at 1, 3, 5 and 7, 9
    periods. Smoke and the chip smoke's period-4 cut: attention at 0,
    MoE at 1 and 3. The period-2 cut: attention + dense, Mamba + MoE."""
    cut = {"full": {}, "smoke": None,
           "period-4 cut": dict(n_layers=4, hybrid_period=4,
                                hybrid_attn_index=0),
           "period-2 cut": dict(n_layers=2, hybrid_period=2,
                                hybrid_attn_index=0)}[which]
    if cut is None:
        cfg, jcfg = smoke_config(ARCH), jsmoke(ARCH)
    else:
        cfg = get_config(ARCH).replace(**cut)
        jcfg = jget_config(ARCH).replace(**cut)
    layout, n = period_layout(cfg)
    jlayout, jn = jperiod(jcfg)
    assert n == jn
    assert [(s.mixer, s.ffn, s.window) for s in layout] == \
        [(s.mixer, s.ffn, s.window) for s in jlayout]
    want = {"full": (9, ["mamba/dense", "mamba/moe", "mamba/dense",
                         "mamba/moe", "attn/dense", "mamba/moe",
                         "mamba/dense", "mamba/moe"]),
            "smoke": (1, ["attn/dense", "mamba/moe", "mamba/dense",
                          "mamba/moe"]),
            "period-4 cut": (1, ["attn/dense", "mamba/moe", "mamba/dense",
                                 "mamba/moe"]),
            "period-2 cut": (1, ["attn/dense", "mamba/moe"])}[which]
    assert (n, [f"{s.mixer}/{s.ffn}" for s in layout]) == want


@pytest.mark.parametrize("which,want", [
    ("full", (397_645_855_104, 93_240_048_000)),
    ("period-4 cut", (22_978_081_664, 6_066_647_936)),
    ("period-2 cut", (11_898_463_872, 3_442_747_008))])
def test_count_params_equal_reference(which, want):
    """Exact, at full width without allocating: `count_params` (total,
    active: routed experts at top_k / E) and `non_embedding_params` the
    reference's, at full depth and at the chip smoke's two cuts; an
    expert leaf holds 16 x 8192 x 24576 = 3,221,225,472 elements a
    period, past 2^31."""
    cut = {"full": {}, "period-4 cut": dict(
        n_layers=4, hybrid_period=4, hybrid_attn_index=0),
        "period-2 cut": dict(n_layers=2, hybrid_period=2,
                             hybrid_attn_index=0)}[which]
    cfg, jcfg = get_config(ARCH).replace(**cut), \
        jget_config(ARCH).replace(**cut)
    assert count_params(cfg) == jcount(jcfg) == want
    assert non_embedding_params(cfg) == jnon_embedding(jcfg)
    sizes = dict(schema_leaves(Model(cfg).schema()))
    w = sizes["['blocks']['sub1']['ffn']['experts']['w_gate']"].shape
    assert w[1:] == (16, 8192, 24576) and int(np.prod(w[1:])) > 2 ** 31


def test_init_bitwise_and_schema_paths():
    """Bitwise: `Model.init(key)` at smoke size draws the reference's
    parameters, leaf for leaf by path: `attn` and a dense `ffn` on sub0,
    `mixer` on the others, routed experts on sub1 and sub3."""
    cfg, jcfg = _configs()
    got = Model(cfg).init(prng.PRNGKey(3), device="cpu")
    want = JModel(jcfg).init(jax.random.PRNGKey(3))
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    flat = pytree.flatten_with_path(got)[0]
    assert [pytree.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    blocks = got["blocks"]
    assert set(blocks["sub0"]) == {"pre_norm", "attn", "ffn_norm", "ffn"}
    assert set(blocks["sub2"]) == {"pre_norm", "mixer", "ffn_norm", "ffn"}
    assert "experts" in blocks["sub1"]["ffn"] and \
        "experts" in blocks["sub3"]["ffn"]
    assert "experts" not in blocks["sub2"]["ffn"]
    for (_, a), (_, b) in zip(flat, jflat):
        assert np.array_equal(a.numpy(), np.asarray(b))


# --------------------------------------------------- prefill and decode


@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_matches_reference(cd, impl):
    """Last logits and every cache leaf within LIMITS[cd], both dispatch
    backends: a 48-token prompt (three chunks of 16, past the 32-query
    chunk of the reference's attention) into a 52-slot cache."""
    cfg, jcfg = _configs(cd)
    toks = _tokens(jcfg, 48, 3)
    jp, tp = _both(_np_params(cfg, 3))
    jl, jc = _jref(jcfg, impl)[0](jp, {"tokens": jnp.asarray(toks)}, 52)
    tl, tc = Model(cfg, moe_impl=impl).prefill(
        tp, {"tokens": torch.from_numpy(toks)}, max_len=52)
    assert tl.dtype == torch.float32 and tl.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LIMITS[cd][0])
    _close_caches(tc, jc, cd)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_matches_reference(cd):
    """A prompt of 16, then 9 decode steps, each fed the reference's next
    token: every step's logits within LIMITS[cd], the caches written in
    place (the same tensors come back), and every cache leaf after the
    last step within its limit; a step of 2 tokens raises ValueError
    (the Mamba sub-layers' recurrent update takes one)."""
    cfg, jcfg = _configs(cd)
    toks = _tokens(jcfg, 25, 2)
    jp, tp = _both(_np_params(cfg, 4))
    (jprefill, jdecode, _), tm = _jref(jcfg), Model(cfg)
    _, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :16])}, 32)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])},
                       max_len=32)
    for pos in range(16, 25):
        tok = toks[:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok),
                         jnp.asarray(pos, jnp.int32))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LIMITS[cd][0])
    _close_caches(tc, jc, cd)
    with pytest.raises(ValueError, match="SSM cache"):
        tm.decode_step(tp, tc, torch.from_numpy(toks[:, :2]), 25)


def _jax_greedy_logits(jcfg, jp, toks, steps, impl):
    """The reference's greedy loop (`repro.train.serve.greedy_decode`),
    keeping each step's logits."""
    jprefill, jdecode, _ = _jref(jcfg, impl)
    pos = toks.shape[1]
    logits, caches = jprefill(jp, {"tokens": jnp.asarray(toks)},
                              pos + steps)
    out, every = [], [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(steps):
        out.append(np.asarray(tok))
        logits, caches = jdecode(jp, caches, tok,
                                 jnp.asarray(pos + i, jnp.int32))
        every.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return np.concatenate(out, axis=1), every


@pytest.mark.parametrize("impl", ["gather", "einsum"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_greedy_decode_matches_reference(cd, impl):
    """`greedy_decode` of 8 tokens past a 16-token prompt, both dispatch
    backends: fp32 tokens equal to the reference's greedy loop and every
    step's logits within LIMITS; bf16 tokens equal at every step up to
    each row's first whose reference top-2 margin is within the logits
    limit (at least 3 compared)."""
    cfg, jcfg = _configs(cd)
    jp, tp = _both(_np_params(cfg, 5))
    toks = _tokens(jcfg, 16, 3)
    steps = 8
    got, logits = greedy_decode(Model(cfg, moe_impl=impl), tp,
                                {"tokens": torch.from_numpy(toks)}, steps,
                                return_logits=True)
    want, every = _jax_greedy_logits(jcfg, jp, toks, steps, impl)
    assert got.dtype == torch.int32 and got.shape == (3, steps)
    lim = LIMITS[cd][0]
    if cd == "float32":
        assert np.array_equal(got.numpy(), want)
        for got_l, want_l in zip(logits, every):
            np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0,
                                       atol=lim)
    compared = 0
    for r in range(want.shape[0]):
        for i in range(steps):
            top2 = np.sort(every[i][r])[-2:]
            if cd != "float32" and top2[1] - top2[0] <= lim:
                break
            assert int(got[r, i]) == want[r, i], (r, i)
            compared += 1
    assert compared >= 3


def test_decode_parity_with_full_forward():
    """Within 2e-5, fp32 (no drops: capacity factor 8): prefill(32) + 16
    decode steps give the last logits of prefill(48), the attention
    sub-layer's keys within 1e-6 and the Mamba sub-layers' SSM states
    within 2e-6 and conv caches within 4e-6 (chunked against recurrent
    sums)."""
    cfg, jcfg = _configs()
    _, tp = _both(_np_params(cfg, 9))
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(jcfg, 48, 2))
    full, fc = model.prefill(tp, {"tokens": toks})
    _, caches = model.prefill(tp, {"tokens": toks[:, :32]}, max_len=48)
    for pos in range(32, 48):
        inc, _ = model.decode_step(tp, caches, toks[:, pos:pos + 1], pos)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(caches["blocks"]["sub0"][0].numpy(),
                               fc["blocks"]["sub0"][0].numpy(), rtol=0,
                               atol=1e-6)
    for j in ("sub1", "sub2", "sub3"):
        for i, lim in ((0, 2e-6), (1, 4e-6)):
            np.testing.assert_allclose(caches["blocks"][j][i].numpy(),
                                       fc["blocks"][j][i].numpy(), rtol=0,
                                       atol=lim)


# ------------------------------------------------------- loss, training


@pytest.mark.parametrize("remat,impl", [("none", "gather"),
                                        ("full", "gather"),
                                        ("none", "einsum")])
def test_loss_and_grads_match_reference(remat, impl):
    """`Model.loss` (ce, aux summed over the two MoE sub-layers, the
    total ce + 0.001 aux) and every leaf's gradient against
    `jax.value_and_grad(model.loss)` over one period with drops
    (capacity factor 0.5), 32 tokens (two chunks), fp32: ce and total
    within 1e-6 relative, aux within 1e-6, gradients within 2e-5 of each
    leaf's largest magnitude. Not in bf16: there the two packages'
    router inputs lie a few bf16 ulps apart after a Mamba mixer, a token
    whose top 2 flips takes a whole expert's output (and, with drops,
    moves which tokens drop), and one such token moved a norm's
    gradient by 0.65 of its magnitude on an x86 CPU; each mixer's bf16
    gradients are held in tests/test_torch_moe.py and
    tests/test_torch_mamba.py."""
    cfg, jcfg = _configs(remat=remat)
    cfg, jcfg = _moe(cfg, capacity_factor=0.5), _moe(jcfg,
                                                      capacity_factor=0.5)
    pn = _np_params(cfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        convert.from_numpy_tree(pn, "cpu"))
    toks = np.random.default_rng(7).integers(0, 503, (2, 32)).astype(
        np.int32)
    # the reference without remat (jax.checkpoint changes no value)
    (jl, jmets), jg = _jref(jcfg.replace(remat="none"), impl)[2](
        jp, {"tokens": jnp.asarray(toks)})
    loss, mets = Model(cfg, moe_impl=impl).loss(p, {"tokens": toks})
    loss.backward()
    lt, at, gt = 1e-6, 1e-6, 2e-5
    assert abs(float(loss.detach()) - float(jl)) <= lt * abs(float(jl))
    assert abs(float(mets["ce"].detach()) - float(jmets["ce"])) <= \
        lt * abs(float(jmets["ce"]))
    assert abs(float(mets["aux"].detach()) - float(jmets["aux"])) <= at
    assert float(jmets["aux"]) > 1.0       # two MoE sub-layers' terms
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    flat, _ = pytree.flatten_with_path(p)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [pytree.keystr(k) for k, _ in flat]
    for (path, a), (_, t) in zip(jflat, flat):
        assert torch.isfinite(t.grad).all()
        assert _rel(a, t.grad) <= gt, jax.tree_util.keystr(path)


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(accum):
    """One `make_train_step` with the config's bf16 moments (and so a
    bf16 gradient sum across microbatches), fp32 parameters and compute,
    remat, capacity factor 0.5, grad_accum 1 and 2, against
    `jax.jit(make_train_step)`: the moments are bf16 in both; loss, aux
    and grad norm within 1e-4 relative, parameters within 2e-4 and the
    bf16 moments within 2^-6 of each leaf's largest magnitude (two bf16
    ulps: a gradient a rounding apart rounds to the neighbouring
    bf16)."""
    cfg, jcfg = _configs(remat="full")
    cfg, jcfg = _moe(cfg, capacity_factor=0.5), _moe(jcfg,
                                                      capacity_factor=0.5)
    assert cfg.opt_state_dtype == "bfloat16"
    pn = _np_params(cfg, 6)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    jopt = jinit_opt(jp, jcfg.opt_state_dtype)
    jstate = {"params": jp, "m": jopt["m"], "v": jopt["v"],
              "step": jnp.zeros((), jnp.int32)}
    state = init_train_state(Model(cfg), params=convert.from_numpy_tree(
        pn, "cpu"), device="cpu")
    assert all(t.dtype == torch.bfloat16 for t in pytree.leaves(state["m"]))
    toks = np.random.default_rng(8).integers(0, 503, (4, 32)).astype(
        np.int32)
    jstate, jmets = jax.jit(jmake_step(JModel(jcfg), total_steps=10,
                                       grad_accum=accum))(
        jstate, {"tokens": jnp.asarray(toks)})
    state, mets = make_train_step(Model(cfg), total_steps=10,
                                  grad_accum=accum)(state, {"tokens": toks})
    for key in ("loss", "aux", "grad_norm"):
        assert abs(float(mets[key]) - float(jmets[key])) <= \
            1e-4 * abs(float(jmets[key])), key
    for part, lim in (("params", 2e-4), ("m", 2.0 ** -6), ("v", 2.0 ** -6)):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[part]),
                        pytree.leaves(state[part])):
            assert str(b.dtype).split(".")[-1] == str(a.dtype)
            assert _rel(a, b) <= lim, part


def test_btm_round_through_replica():
    """One Branch-Train-Merge round (2 branches, weight_average, a merge
    every 2 steps, 16-token sequences) on the hybrid smoke model in both
    packages from the reference's init: each branch's losses within
    2e-4 relative of the reference's, both branches byte-identical after
    the merge, and that model bitwise the port's `Replica` resolving
    weight_average over the two branches' contributions."""
    cfg, jcfg = _configs("bfloat16", grad_accum=1)
    kw = dict(n_branches=2, strategy="weight_average", merge_every=2,
              batch_size=4, seq_len=16)
    jb, tb = JBTM(jcfg, **kw), BranchTrainMerge(cfg, device="cpu", **kw)
    contributed = []
    for node in tb.net.nodes:
        def spy(c, *a, _fn=node.contribute, **k):
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


# ------------------------------------------- the merge, experts inherited


def _sparse_fine_tunes(base, seeds):
    """Fine-tunes that touch every leaf but the routed experts' (base +
    0.01 x a seeded delta), as numpy trees of those leaves, and their
    coverage (canonical keystr paths)."""
    flat = [(p, a) for p, a in pytree.flatten_with_path(
        convert.from_numpy_tree(base, "cpu"))[0]]
    paths = sorted(pytree.keystr(p) for p, _ in flat
                   if EXPERTS not in pytree.keystr(p))
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        tree: dict = {}
        for path, a in flat:
            name = pytree.keystr(path)
            if EXPERTS in name:
                continue
            keys = [k.strip("'") for k in name[1:-1].split("][")]
            node = tree
            for key in keys[:-1]:
                node = node.setdefault(key, {})
            node[keys[-1]] = (a.numpy() + 0.01 * rng.standard_normal(
                tuple(a.shape))).astype(np.float32)
        out.append(tree)
    return out, paths


@pytest.mark.parametrize("name", ["ties", "weight_average"])
def test_sparse_merge_inherits_experts_like_the_reference(name):
    """Two fine-tunes that leave the routed experts to the base, on two
    port replicas in opposite orders and one reference replica, the base
    registered: the port's resolve (exact path, fp32) bitwise the
    reference's, the two replicas byte-equal, every expert leaf the
    base's own tensor (inherited, not copied); then the kernel route the
    chip smoke takes (`engine.merge(..., kernels=True, coverages=...)`,
    the kernels' plain versions on the CPU) on bf16 copies: the expert
    leaves the base's tensors again, every other leaf within one bf16
    ulp of the exact route's (weight_average) or with at most 1e-2 of a
    leaf's elements beyond it (TIES: the exact path trims in bf16, the
    route in fp32)."""
    cfg, _ = _configs()
    base = _np_params(cfg, 11)
    tunes, cov = _sparse_fine_tunes(base, (12, 13))
    jrep = JReplica("ref")
    for t in tunes:
        jrep.contribute(jax.tree_util.tree_map(jnp.asarray, t), leaves=cov)
    jref = jrep.register_base(jax.tree_util.tree_map(jnp.asarray, base))
    spec = dict(trim=0.2) if name == "ties" else {}
    want = jrep.resolve(JSpec(name, spec, base_ref=jref))
    tbase = convert.from_numpy_tree(base, "cpu")
    got = []
    for order in ([0, 1], [1, 0]):
        rep = Replica(f"port-{order[0]}", device="cpu")
        for i in order:
            rep.contribute(convert.from_numpy_tree(tunes[i], "cpu"),
                           leaves=cov)
        ref = rep.register_base(tbase)
        assert rep.merkle_root() == jrep.merkle_root() and ref == jref
        got.append(rep.resolve(MergeSpec(name, spec, base_ref=ref)))
    paths = [pytree.keystr(p) for p, _ in
             pytree.flatten_with_path(tbase)[0]]
    for path, a, b, w, bl in zip(paths, pytree.leaves(got[0]),
                                 pytree.leaves(got[1]),
                                 jax.tree_util.tree_leaves(want),
                                 pytree.leaves(tbase)):
        assert np.array_equal(a.numpy(), np.asarray(w)), path
        assert torch.equal(a, b), path
        if EXPERTS in path:
            assert a is bl, path
    # the kernel route over bf16 copies, as the chip smoke merges
    b16 = pytree.tree_map(lambda t: t.to(torch.bfloat16), tbase)
    rep = Replica("port-bf16", device="cpu")
    for t in tunes:
        rep.contribute(pytree.tree_map(
            lambda x: x.to(torch.bfloat16),
            convert.from_numpy_tree(t, "cpu")), leaves=cov)
    ref = rep.register_base(b16)
    order = canonical_order(rep.state)
    covs = rep.state.coverage()
    kern = engine.merge([rep.state.store[e] for e in order],
                        spec=MergeSpec(name, spec), contrib_ids=order,
                        base=b16, seed=seed_from_root(rep.merkle_root()),
                        kernels=True, use_cache=False,
                        coverages=[covs.get(e) for e in order],
                        cache=rep.cache)
    exact = rep.resolve(MergeSpec(name, spec, base_ref=ref),
                        use_cache=False)
    for path, k, e, bl in zip(paths, pytree.leaves(kern),
                              pytree.leaves(exact), pytree.leaves(b16)):
        if EXPERTS in path:
            assert k is bl and e is bl, path
            continue
        e32, k32 = e.float(), k.float()
        beyond = int(((e32 - k32).abs()
                      > 1e-5 + 2.0 ** -7 * e32.abs()).sum())
        limit = 0 if name == "weight_average" else \
            int(np.ceil(1e-2 * e.numel()))
        assert beyond <= limit, (path, beyond)


# ------------------------------------------------------------------ CLIs


def test_serve_train_and_merge_clis(tmp_path, capsys):
    """`--arch jamba-1.5-large-398b --smoke --device cpu` through the
    three CLIs, in-process: serve prints its tokens; train writes a
    checkpoint (bf16 moments) and resumes from it; merge (TIES with a
    base) writes a checkpoint whose parameters are bitwise an in-process
    `Replica` resolve over the same checkpoints, and zero moments."""
    from repro_torch.launch import merge, serve, train
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("generated (4, 8) tokens in ")
    common = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
              "--log-every", "1", "--device", "cpu"]
    for task, steps, extra in ((1, 2, []), (1, 3, ["--resume"]),
                               (2, 1, []), (0, 0, [])):
        train.main(common + ["--steps", str(steps), "--task", str(task),
                             "--ckpt-dir", str(tmp_path / f"t{task}")]
                   + extra)
    out = capsys.readouterr().out
    assert "resumed from" in out and out.count("done") == 4
    losses = [float(x.split()[3]) for x in out.splitlines()
              if x.startswith("step")]
    assert len(losses) == 2 + 1 + 1 and all(np.isfinite(losses))
    inputs = [str(tmp_path / "t1/step_00000003"),
              str(tmp_path / "t2/step_00000001")]
    base = str(tmp_path / "t0/step_00000000")
    merge.main(["--arch", ARCH, "--smoke", "--strategy", "ties", "--base",
                base, "--inputs", *inputs, "--out", str(tmp_path / "m"),
                "--device", "cpu", "--quiet"])
    like = train_state_shapes(Model(smoke_config(ARCH)))
    assert all(t.dtype == torch.bfloat16 for t in pytree.leaves(like["m"]))
    rep = Replica("in-process", device="cpu")
    for path in inputs:
        rep.contribute(ckpt.restore_checkpoint(path, like,
                                               device="cpu")[0]["params"])
    want = rep.resolve(MergeSpec("ties"), base=ckpt.restore_checkpoint(
        base, like, device="cpu")[0]["params"])
    got, meta = ckpt.restore_checkpoint(
        str(tmp_path / "m/step_00000000"), like, device="cpu")
    assert meta["strategy"] == "ties"
    assert all(torch.equal(a, b) for a, b in
               zip(pytree.leaves(got["params"]), pytree.leaves(want)))
    assert all(float(t.float().abs().max()) == 0 for t in
               pytree.leaves(got["m"]) + pytree.leaves(got["v"]))


def test_registered_base_digests_spare_the_planner(monkeypatch):
    """Exact: a replica keeps its registered base's leaf digests (taken
    in `register_base`'s one pass: `tensor_digest` of each leaf in
    flatten order, and the ref their path-ordered combination, as
    `pytree_digest`); a plan given them (`base_digests=`) has the same
    leaf tasks and sub-roots as one that hashes the base; a resolve
    through the replica, and `engine.merge(..., base_digests=...)`,
    hash no base leaf, and give the same bytes."""
    from repro_torch.core import hashing
    cfg, _ = _configs()
    base = convert.from_numpy_tree(_np_params(cfg, 11), "cpu")
    tunes, cov = _sparse_fine_tunes(_np_params(cfg, 11), (12, 13))
    rep = Replica("digests", device="cpu")
    for t in tunes:
        rep.contribute(convert.from_numpy_tree(t, "cpu"), leaves=cov)
    ref = rep.register_base(base)
    leaves = pytree.leaves(base)
    assert list(rep.base_digests(ref)) == \
        [hashing.tensor_digest(t) for t in leaves]
    assert ref == hashing.pytree_digest(base).hex()
    order = canonical_order(rep.state)
    payloads = [rep.state.store[e] for e in order]
    covs = [rep.state.coverage().get(e) for e in order]
    kw = dict(contrib_ids=order, base=base, seed=5, coverages=covs,
              spec=MergeSpec("ties", {"trim": 0.2}))
    a = engine.plan_for(payloads, **kw)
    b = engine.plan_for(payloads, base_digests=rep.base_digests(ref), **kw)
    assert a == b and a.base_only == b.base_only and len(a.base_only) == 6
    want = rep.resolve(MergeSpec("ties", {"trim": 0.2}, base_ref=ref),
                       use_cache=False)
    hashed = []
    real = engine.tensor_digests

    def counting(ts):
        hashed.extend(ts)
        return real(ts)

    monkeypatch.setattr(engine, "tensor_digests", counting)
    got = rep.resolve(MergeSpec("ties", {"trim": 0.2}, base_ref=ref),
                      use_cache=False)
    merged = engine.merge(payloads, use_cache=False,
                          base_digests=rep.base_digests(ref), **kw)
    assert not any(t is leaf for t in hashed for leaf in leaves)
    for x, y, z in zip(pytree.leaves(want), pytree.leaves(got),
                       pytree.leaves(merged)):
        assert torch.equal(x, y) and torch.equal(x, z)
    with pytest.raises(ValueError, match="base digests"):
        engine.plan_for(payloads, base_digests=rep.base_digests(ref)[:3],
                        **kw)
