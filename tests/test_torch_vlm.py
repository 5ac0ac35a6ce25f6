"""Llama-3.2-Vision-90B (the VLM family: gated cross-attention over
patch embeddings) on the port against the JAX reference, on the CPU: the
config, `period_layout` and `count_params` at full size and at the chip
smoke's cuts, `Model.init`, B9's plain version non-causal at the
patches' ragged Sk (1601) with Sq != Sk against `chunked_attention`,
`prefill` with every cache leaf (the cross sub-layers' static caches of
`num_patches` slots), decode steps, `greedy_decode`, `Model.loss` and its
gradients with remat on and off, the train step with patches in 2
microbatches, merges through `Replica` with the gate leaves bitwise the
reference's, then served, the serve CLI, and the `ValueError` of the
train CLI and Branch-Train-Merge (whose batches carry no patches).

Smoke size: the reference's `smoke_config` (4 layers in 2 periods of a
self-attention and a cross-attention sub-layer, d_model 64, 4 heads of
16 over 4 KV heads, 12 patches, vocabulary 503, RoPE theta 500000 on the
self-attention). The gates start at 0 in both packages (`init`), and
tanh(0) = 0 multiplies the cross sub-layer's whole output away, so every
parity test here sets them to tanh-visible values: `gate_attn` 0.5 and
`gate_ffn` -0.7 (`_np_params`), and `test_zero_gates_hide_the_cross_path`
shows what a test at init would miss. Inputs are made from a seed with
numpy and handed to both packages; patches come from `make_batch`. The
reference's prefill, decode and loss run under `jax.jit`. Each assertion
says whether it is bitwise or within a tolerance; every tolerance is at
least twice the largest reading on an x86 CPU.
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
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import period_layout as jperiod  # noqa: E402
from repro.models.params import count_params as jcount  # noqa: E402
from repro.models.params import (  # noqa: E402
    non_embedding_params as jnon_embedding)
from repro.optim.adamw import init_opt_state as jinit_opt  # noqa: E402
from repro.train.btm import BranchTrainMerge as JBTM  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.resolve import canonical_order, seed_from_root  # noqa: E402,E501
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_grad_plain)
from repro_torch.models.model import Model, period_layout  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params, non_embedding_params)
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train.btm import BranchTrainMerge  # noqa: E402
from repro_torch.train.serve import greedy_decode  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402,E501

torch.set_num_threads(1)

ARCH = "llama-3.2-vision-90b"
GATES = {"gate_attn": 0.5, "gate_ffn": -0.7}
CROSS = "['blocks']['sub1']"        # the smoke period's cross sub-layer
# the model against the reference by compute dtype: (logits atol, cache
# atol), logits up to 8.9. fp32 read 2.9e-6 and 9.7e-7; bf16 read 6.3e-2
# and 7.8e-3 (B9 keeps p . v in fp32 where `chunked_attention` rounds p
# to bf16)
LIMITS = {"float32": (1e-5, 2e-6), "bfloat16": (0.25, 2.5e-2)}


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jeng.clear_cache()
    engine.clear_cache()


@functools.cache
def _jref(jcfg):
    """The reference model's prefill, decode step and loss gradient,
    each under `jax.jit`."""
    jm = JModel(jcfg)
    return (jax.jit(jm.prefill, static_argnums=2), jax.jit(jm.decode_step),
            jax.jit(jax.value_and_grad(jm.loss, has_aux=True)))


def _configs(cd: str = "float32", **kw):
    return (smoke_config(ARCH).replace(compute_dtype=cd, **kw),
            jsmoke(ARCH).replace(compute_dtype=cd, **kw))


def _np_params(cfg, seed, gates=True):
    """Numpy fp32 weights in the port's layout: norms near 1, the
    embedding at 0.4, the output head at 0.3, the rest at 0.05; the
    gates at GATES (at 0, their init, with `gates=False`)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, pdef in schema_leaves(Model(cfg).schema()):
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        if keys[-1] in GATES:
            a = np.full(pdef.shape, GATES[keys[-1]] if gates else 0.0)
        elif pdef.init == "ones":
            a = 1 + 0.1 * rng.standard_normal(pdef.shape)
        else:
            scale = {"embed": 0.4, "lm_head": 0.3}.get(keys[-1], 0.05)
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


def _batch(jcfg, seq, batch, step=0):
    """make_batch's tokens and patches (numpy), for both packages."""
    return jmake_batch(jcfg, JShape("s", seq, batch, "prefill"), step)


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close_caches(got, want, lim):
    """Every cache leaf: {"blocks": {"sub0": (k, v) of [n_periods, B,
    slots, HK, D], "sub1": the cross sub-layer's (k, v) of [n_periods, B,
    num_patches, HK, D]}}."""
    assert sorted(got["blocks"]) == sorted(want["blocks"]) == ["sub0",
                                                               "sub1"]
    for j in ("sub0", "sub1"):
        for t, a in zip(got["blocks"][j], want["blocks"][j]):
            assert tuple(t.shape) == a.shape
            np.testing.assert_allclose(_f32(t), _f32(a), rtol=0, atol=lim)


# ------------------------------------------- config, layout, counts, init


def test_config_equals_reference():
    """Exact: the port's llama-3.2-vision-90b is the reference's, field
    for field, and so is its smoke reduction."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == \
        dataclasses.asdict(jsmoke(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.cross_attn_interval, cfg.num_patches,
            cfg.opt_state_dtype) == ("vlm", 5, 1601, "bfloat16")


@pytest.mark.parametrize("which", ["full", "smoke", "6 periods"])
def test_period_layout_equals_reference(which):
    """Exact: the sub-layers (mixer, FFN, window) and the number of
    periods: 4 self-attention + dense sub-layers, then a cross-attention
    + dense one, 20 periods at full depth (6 in the chip smoke's served
    cut); the smoke config's period of 2, 2 periods."""
    if which == "smoke":
        cfg, jcfg = smoke_config(ARCH), jsmoke(ARCH)
    else:
        n = {"full": 100, "6 periods": 30}[which]
        cfg = get_config(ARCH).replace(n_layers=n)
        jcfg = jget_config(ARCH).replace(n_layers=n)
    layout, n = period_layout(cfg)
    jlayout, jn = jperiod(jcfg)
    assert n == jn
    assert [(s.mixer, s.ffn, s.window) for s in layout] == \
        [(s.mixer, s.ffn, s.window) for s in jlayout]
    want = {"full": (20, ["attn"] * 4 + ["cross"]),
            "6 periods": (6, ["attn"] * 4 + ["cross"]),
            "smoke": (2, ["attn", "cross"])}[which]
    assert (n, [s.mixer for s in layout]) == want
    assert all(s.ffn == "dense" for s in layout)


@pytest.mark.parametrize("periods,want", [
    (20, 87_666_794_536), (6, 27_770_986_508), (7, 32_049_258_510),
    (1, 6_379_626_498)])
def test_count_params_equal_reference(periods, want):
    """Exact, at full width without allocating: `count_params` and
    `non_embedding_params` the reference's at full depth and at the chip
    smoke's cuts (6 periods served, 1 merged; 7 would be 64.10 GB in
    bf16). A period of 4 self-attention + dense sub-layers and a cross +
    dense one holds 4,278,272,002 parameters (the cross sub-layer
    855,654,402 with its two gates), the embedding, head and final norm
    2,101,354,496."""
    cfg = get_config(ARCH).replace(n_layers=5 * periods)
    jcfg = jget_config(ARCH).replace(n_layers=5 * periods)
    assert count_params(cfg) == jcount(jcfg) == (want, want)
    assert non_embedding_params(cfg) == jnon_embedding(jcfg)
    sizes = dict(schema_leaves(Model(cfg).schema()))
    cross = sum(int(np.prod(p.shape[1:])) for k, p in sizes.items()
                if "['sub4']" in k)
    assert cross == 855_654_402
    assert want == 2_101_354_496 + periods * 4_278_272_002
    assert sizes["['blocks']['sub4']['gate_attn']"].shape == (periods,)
    assert sizes["['blocks']['sub4']['attn']['wk']"].shape == \
        (periods, 8192, 1024)


def test_init_bitwise_and_schema_paths():
    """Bitwise: `Model.init(key)` draws the reference's parameters, leaf
    for leaf by path; the cross sub-layer holds `attn` (its keys and
    values projected from d_model-wide patches) and the gates, zeros of
    one element a period."""
    cfg, jcfg = _configs()
    got = Model(cfg).init(prng.PRNGKey(3), device="cpu")
    want = JModel(jcfg).init(jax.random.PRNGKey(3))
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    flat = pytree.flatten_with_path(got)[0]
    assert [pytree.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    sub1 = got["blocks"]["sub1"]
    assert set(sub1) == {"pre_norm", "attn", "gate_attn", "gate_ffn",
                         "ffn_norm", "ffn"}
    assert sub1["gate_attn"].shape == (2,) and \
        not bool(sub1["gate_attn"].any())
    for (_, a), (_, b) in zip(flat, jflat):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------------------- B9, gates


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [4064, 20, 1])
def test_flash_plain_noncausal_patches_vs_chunked(sq, dtype):
    """B9's plain version, non-causal, against `chunked_attention` at the
    VLM's shape: 64 query heads over 8 KV heads of 128 cut to 8 over 1
    (H / HK = 8), 1601 patches (1601 % 64 = 1), Sq = 4064 (the chip
    smoke's prompt), 20 and 1 (a decode step). fp32 within 2e-6 (the CPU
    read 3.3e-7); bf16 within one bf16 ulp of |out| + 4e-3 (read 4.4e-4
    beyond the ulp: the reference rounds p to bf16 before p . v, B9 keeps
    it in fp32)."""
    rng = np.random.default_rng(sq)
    q = rng.standard_normal((1, sq, 8, 128)).astype(np.float32)
    k, v = (rng.standard_normal((1, 1601, 1, 128)).astype(np.float32)
            for _ in range(2))
    if dtype == "float32":
        got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=False)
        want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=False,
                                    q_chunk=512, compute_dtype=jnp.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)
        return
    got = flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                            for a in (q, k, v)), causal=False)
    want = _f32(JL.chunked_attention(*(jnp.asarray(a, jnp.bfloat16)
                                       for a in (q, k, v)), causal=False,
                                     q_chunk=512))
    np.testing.assert_array_less(np.abs(_f32(got) - want),
                                 2.0 ** -7 * np.abs(want) + 4e-3)


def test_flash_plain_noncausal_gradient_vs_jax_grad():
    """Within 2e-5 of each gradient's largest magnitude, fp32: B9's plain
    forward and backward, non-causal, 37 queries over 201 patches at
    H / HK = 8, against `jax.grad` of `chunked_attention`."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 37, 8, 128)).astype(np.float32)
    k, v = (rng.standard_normal((2, 201, 1, 128)).astype(np.float32)
            for _ in range(2))
    g = rng.standard_normal(q.shape).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    got = torch.autograd.grad(flash_attention_grad_plain(*t, causal=False),
                              t, torch.from_numpy(g))

    def f(q, k, v):
        out = JL.chunked_attention(q, k, v, causal=False, q_chunk=32,
                                   compute_dtype=jnp.float32)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                            for a in (q, k, v)))
    for a, b in zip(want, got):
        assert _rel(a, b) <= 2e-5


def test_zero_gates_hide_the_cross_path():
    """Exact: at the gates' init (0, in both packages) tanh(0) = 0
    multiplies the cross sub-layer's output away, so two batches that
    differ only in their patches give the same logits bit for bit (a
    parity test at init checks nothing of the cross path); with the
    gates at GATES they differ."""
    cfg, jcfg = _configs()
    b = _batch(jcfg, 8, 2)
    other = dict(b, patches=b["patches"] * 3.0)
    for gates, same in ((False, True), (True, False)):
        _, tp = _both(_np_params(cfg, 1, gates=gates))
        a, _ = Model(cfg).prefill(tp, _tb(b))
        c, _ = Model(cfg).prefill(tp, _tb(other))
        assert torch.equal(a, c) == same


# --------------------------------------------------- prefill and decode


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_matches_reference(cd):
    """Last logits and every cache leaf within LIMITS[cd], gates at
    GATES: a 40-token prompt into a 48-slot self cache; the cross caches
    hold the 12 patches' keys and values."""
    cfg, jcfg = _configs(cd)
    b = _batch(jcfg, 40, 3)
    jp, tp = _both(_np_params(cfg, 3))
    jl, jc = _jref(jcfg)[0](jp, _jb(b), 48)
    tl, tc = Model(cfg).prefill(tp, _tb(b), max_len=48)
    assert tl.dtype == torch.float32 and tl.shape == (3, cfg.vocab_size)
    assert tc["blocks"]["sub0"][0].shape == (2, 3, 48, 4, 16)
    assert tc["blocks"]["sub1"][0].shape == (2, 3, 12, 4, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LIMITS[cd][0])
    _close_caches(tc, jc, LIMITS[cd][1])


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_matches_reference(cd):
    """A prompt of 16, then 9 decode steps fed the reference's next
    token (`decode_step` keeps its signature: the cross sub-layers read
    their caches, not the patches): every step's logits within
    LIMITS[cd], the caches written in place, every cache leaf after the
    last step within its limit, the cross caches untouched."""
    cfg, jcfg = _configs(cd)
    b = _batch(jcfg, 25, 2)
    jp, tp = _both(_np_params(cfg, 4))
    (jprefill, jdecode, _), tm = _jref(jcfg), Model(cfg)
    head = {"tokens": b["tokens"][:, :16], "patches": b["patches"]}
    _, jc = jprefill(jp, _jb(head), 25)
    _, tc = tm.prefill(tp, _tb(head), max_len=25)
    cross = [t.clone() for t in tc["blocks"]["sub1"]]
    for pos in range(16, 25):
        tok = b["tokens"][:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok),
                         jnp.asarray(pos, jnp.int32))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LIMITS[cd][0])
    _close_caches(tc, jc, LIMITS[cd][1])
    assert all(torch.equal(a, c) for a, c in zip(cross,
                                                 tc["blocks"]["sub1"]))


def test_decode_parity_with_full_forward():
    """Within 2e-5, fp32: prefill(16) + 8 decode steps give the last
    logits of prefill(24) on the same patches; the self-attention caches
    within 1e-6, the cross caches bitwise."""
    cfg, jcfg = _configs()
    _, tp = _both(_np_params(cfg, 9))
    model = Model(cfg)
    b = _tb(_batch(jcfg, 24, 2))
    full, fc = model.prefill(tp, b)
    _, caches = model.prefill(tp, {"tokens": b["tokens"][:, :16],
                                   "patches": b["patches"]}, max_len=24)
    for pos in range(16, 24):
        inc, _ = model.decode_step(tp, caches, b["tokens"][:, pos:pos + 1],
                                   pos)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=0, atol=2e-5)
    for i in (0, 1):
        np.testing.assert_allclose(caches["blocks"]["sub0"][i].numpy(),
                                   fc["blocks"]["sub0"][i].numpy(), rtol=0,
                                   atol=1e-6)
        assert torch.equal(caches["blocks"]["sub1"][i],
                           fc["blocks"]["sub1"][i])


def _jax_greedy_logits(jcfg, jp, b, steps):
    """The reference's greedy loop, keeping each step's logits."""
    jprefill, jdecode, _ = _jref(jcfg)
    pos = b["tokens"].shape[1]
    logits, caches = jprefill(jp, _jb(b), pos + steps)
    out, every = [], [np.asarray(logits)]
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(steps):
        out.append(np.asarray(tok))
        logits, caches = jdecode(jp, caches, tok,
                                 jnp.asarray(pos + i, jnp.int32))
        every.append(np.asarray(logits))
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    return np.concatenate(out, axis=1), every


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_greedy_decode_matches_reference(cd):
    """`greedy_decode` of 8 tokens past a 16-token prompt: fp32 tokens
    equal to the reference's greedy loop and every step's logits within
    LIMITS; bf16 tokens equal at every step up to each row's first whose
    reference top-2 margin is within the logits limit (at least 3
    compared)."""
    cfg, jcfg = _configs(cd)
    jp, tp = _both(_np_params(cfg, 5))
    b = _batch(jcfg, 16, 3)
    steps = 8
    got, logits = greedy_decode(Model(cfg), tp, _tb(b), steps,
                                return_logits=True)
    want, every = _jax_greedy_logits(jcfg, jp, b, steps)
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


# ------------------------------------------------------- loss, training


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(remat, cd):
    """`Model.loss` and every leaf's gradient, the gates' included,
    against `jax.value_and_grad(model.loss)` over 40 tokens and 12
    patches, remat on and off: fp32 loss within 1e-6 relative and
    gradients within 2e-5 of each leaf's largest magnitude (the CPU read
    1.0e-7 and 1.8e-6); bf16 within 2e-3 and 5e-2 (read 3.0e-4 and
    1.4e-2: bf16 roundings of B9's outputs and of p), but the gates'
    within 0.15 (read 4.9e-2: each gate's gradient is one sum over every
    position and feature of its output times the output's gradient, whose
    terms cancel, so the roundings upstream stay relative to the terms,
    not to the sum)."""
    cfg, jcfg = _configs(cd, remat=remat)
    pn = _np_params(cfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        convert.from_numpy_tree(pn, "cpu"))
    b = _batch(jcfg, 40, 2, step=7)
    (jl, _), jg = _jref(jcfg.replace(remat="none"))[2](jp, _jb(b))
    loss, _ = Model(cfg).loss(p, _tb(b))
    loss.backward()
    lt, gt = (1e-6, 2e-5) if cd == "float32" else (2e-3, 5e-2)
    assert abs(float(loss.detach()) - float(jl)) <= lt * abs(float(jl))
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    flat, _ = pytree.flatten_with_path(p)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [pytree.keystr(k) for k, _ in flat]
    for (path, a), (_, t) in zip(jflat, flat):
        name = jax.tree_util.keystr(path)
        assert torch.isfinite(t.grad).all()
        lim = 0.15 if cd == "bfloat16" and "['gate_" in name else gt
        assert _rel(a, t.grad) <= lim, name
    assert float(p["blocks"]["sub1"]["gate_attn"].grad.abs().min()) > 0


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_carries_patches_into_microbatches(accum):
    """One `make_train_step` on a patches batch (4 rows of 32 tokens and
    12 patches) with the config's bf16 moments, fp32 parameters and
    compute, remat, grad_accum 1 and 2, against
    `jax.jit(make_train_step)`: loss and grad norm within 1e-4 relative,
    parameters within 2e-4 and the bf16 moments within 2^-6 of each
    leaf's largest magnitude (two bf16 ulps; the CPU read 1.4e-6, 6.6e-6
    and 2.6e-3)."""
    cfg, jcfg = _configs(remat="full")
    assert cfg.opt_state_dtype == "bfloat16"
    pn = _np_params(cfg, 6)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    jopt = jinit_opt(jp, jcfg.opt_state_dtype)
    jstate = {"params": jp, "m": jopt["m"], "v": jopt["v"],
              "step": jnp.zeros((), jnp.int32)}
    state = init_train_state(Model(cfg), params=convert.from_numpy_tree(
        pn, "cpu"), device="cpu")
    b = _batch(jcfg, 32, 4, step=8)
    jstate, jmets = jax.jit(jmake_step(JModel(jcfg), total_steps=10,
                                       grad_accum=accum))(jstate, _jb(b))
    state, mets = make_train_step(Model(cfg), total_steps=10,
                                  grad_accum=accum)(state, b)
    for key in ("loss", "grad_norm"):
        assert abs(float(mets[key]) - float(jmets[key])) <= \
            1e-4 * abs(float(jmets[key])), key
    for part, lim in (("params", 2e-4), ("m", 2.0 ** -6), ("v", 2.0 ** -6)):
        for a, t in zip(jax.tree_util.tree_leaves(jstate[part]),
                        pytree.leaves(state[part])):
            assert _rel(a, t) <= lim, part


# ------------------------------------------------- merge, serve, CLIs


def _cross_tunes(base, seeds):
    """Fine-tunes of the cross sub-layer alone (its leaves + 0.05 x a
    seeded delta, the gates included), as numpy trees of those leaves,
    and their coverage (keystr paths)."""
    paths = [p for p, _ in schema_leaves(Model(smoke_config(ARCH)).schema())
             if p.startswith(CROSS)]
    out = []
    for seed in seeds:
        rng = np.random.default_rng(seed)
        tree = {"blocks": {"sub1": {}}}
        for path in paths:
            keys = [k.strip("'") for k in path[1:-1].split("][")]
            node, src = tree, base
            for key in keys[:-1]:
                node = node.setdefault(key, {})
                src = src[key]
            a = src[keys[-1]]
            node[keys[-1]] = (a + 0.05 * rng.standard_normal(a.shape)) \
                .astype(np.float32)
        out.append(tree)
    return out, sorted(paths)


@pytest.mark.parametrize("name", ["ties", "weight_average"])
def test_cross_layer_merge_matches_reference_then_serves(name):
    """The chip smoke's VLM merge at smoke size: two fine-tunes of the
    cross sub-layer alone (its gates moved too) land, with the base
    registered, on two port replicas in opposite orders and on one
    reference replica; the port's resolve (exact path, fp32) is bitwise
    the reference's, every gate leaf included, the replicas byte-equal,
    every leaf outside the cross sub-layer the base's own tensor; the
    merged tree serves 6 tokens equal to the reference's greedy loop on
    its merged tree."""
    cfg, jcfg = _configs()
    base = _np_params(cfg, 11)
    tunes, cov = _cross_tunes(base, (12, 13))
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
    gates = 0
    for path, a, c, w, bl in zip(paths, pytree.leaves(got[0]),
                                 pytree.leaves(got[1]),
                                 jax.tree_util.tree_leaves(want),
                                 pytree.leaves(tbase)):
        assert np.array_equal(a.numpy(), np.asarray(w)), path
        assert torch.equal(a, c), path
        if not path.startswith(CROSS):
            assert a is bl, path
        elif "['gate_" in path:
            gates += 1
            assert not torch.equal(a, bl), path
    assert gates == 2
    b = _batch(jcfg, 8, 2)
    jtoks, _ = _jax_greedy_logits(jcfg, want, b, 6)
    toks = greedy_decode(Model(cfg), got[0], _tb(b), 6)
    assert np.array_equal(toks.numpy(), jtoks)


@pytest.mark.parametrize("name", ["ties", "weight_average"])
def test_gate_leaves_on_the_kernel_route(name):
    """The chip smoke's kernel route (`engine.merge(..., kernels=True,
    coverages=...)`, the kernels' plain versions on the CPU) over bf16
    copies of the cross-layer fine-tunes: the gate leaves, [n_periods]
    bf16 (one element a period), are bitwise the exact route's
    (`Replica.resolve`), and bitwise the reference's exact route over
    the same bf16 trees; every other cross leaf within one bf16 ulp of
    the exact route's (weight_average) or with at most 1e-2 of its
    elements beyond it (TIES: the exact path trims in bf16, the route in
    fp32); the leaves outside the cross sub-layer the base's own
    tensors."""
    cfg, _ = _configs()
    base = _np_params(cfg, 11)
    tunes, cov = _cross_tunes(base, (12, 13))

    def b16(tree):
        return pytree.tree_map(lambda x: x.to(torch.bfloat16),
                               convert.from_numpy_tree(tree, "cpu"))

    spec = dict(trim=0.2) if name == "ties" else {}
    tbase = b16(base)
    rep = Replica("port-bf16", device="cpu")
    for t in tunes:
        rep.contribute(b16(t), leaves=cov)
    ref = rep.register_base(tbase)
    order = canonical_order(rep.state)
    covs = rep.state.coverage()
    kern = engine.merge([rep.state.store[e] for e in order],
                        spec=MergeSpec(name, spec), contrib_ids=order,
                        base=tbase, seed=seed_from_root(rep.merkle_root()),
                        kernels=True, use_cache=False,
                        coverages=[covs.get(e) for e in order],
                        cache=rep.cache, base_digests=rep.base_digests(ref))
    exact = rep.resolve(MergeSpec(name, spec, base_ref=ref),
                        use_cache=False)
    jrep = JReplica("ref-bf16")
    for t in tunes:
        jrep.contribute(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.bfloat16), t), leaves=cov)
    jref = jrep.register_base(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), base))
    want = jrep.resolve(JSpec(name, spec, base_ref=jref))
    paths = [pytree.keystr(p) for p, _ in pytree.flatten_with_path(tbase)[0]]
    for path, k, e, w, bl in zip(paths, pytree.leaves(kern),
                                 pytree.leaves(exact),
                                 jax.tree_util.tree_leaves(want),
                                 pytree.leaves(tbase)):
        if not path.startswith(CROSS):
            assert k is bl and e is bl, path
            continue
        if "['gate_" in path:
            assert k.shape == (2,) and k.dtype == torch.bfloat16
            assert torch.equal(k.view(torch.int16), e.view(torch.int16))
            assert np.array_equal(_f32(k), _f32(w)), path
            continue
        e32, k32 = e.float(), k.float()
        beyond = int(((e32 - k32).abs()
                      > 1e-5 + 2.0 ** -7 * e32.abs()).sum())
        limit = 0 if name == "weight_average" else \
            int(np.ceil(1e-2 * e.numel()))
        assert beyond <= limit, (path, beyond)


def test_serve_cli(capsys):
    """`--arch llama-3.2-vision-90b --smoke --device cpu` in-process: 8
    tokens for each of 4 rows, every one in the vocabulary."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("generated (4, 8) tokens in ")
    sample = out.split("sample: [")[1].split("]")[0].split()
    assert len(sample) == 8 and all(0 <= int(t) < 503 for t in sample)


def test_train_cli_and_btm_raise_value_error(monkeypatch):
    """The train CLI and Branch-Train-Merge feed tokens alone, so the
    port's `Model.loss` raises `ValueError` naming the missing patches,
    where the reference's raises `KeyError('patches')` (ROADMAP C,
    reference-side hazards)."""
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="'patches'"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--batch",
                    "2", "--seq", "8", "--device", "cpu"])
    cfg, jcfg = _configs(grad_accum=1)
    kw = dict(n_branches=2, merge_every=1, batch_size=2, seq_len=8)
    with pytest.raises(ValueError, match="'patches'"):
        BranchTrainMerge(cfg, device="cpu", **kw).train_round()
    with pytest.raises(KeyError, match="patches"):
        JBTM(jcfg, **kw).train_round()
    import repro.launch.train as jtrain
    monkeypatch.setattr("sys.argv", ["train", "--arch", ARCH, "--smoke",
                                     "--steps", "1", "--batch", "2",
                                     "--seq", "8"])
    with pytest.raises(KeyError, match="patches"):
        jtrain.main()
