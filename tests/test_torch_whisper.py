"""Whisper-tiny (the encoder-decoder family) on the port against the JAX
reference, on the CPU: the config, `period_layout`, `count_params` at
full size, `Model.init`, B9's plain version non-causal at a ragged Sk
(Sq != Sk) against `chunked_attention` and its gradient against
`jax.grad`, sinusoidal positions, `prefill` with every cache leaf (the
self cache at `max_len` slots, the cross cache at the encoder's),
decode steps, `greedy_decode`, `Model.loss` and its gradients with remat
on and off, the train step with frames in 2 microbatches, a merge
through `Replica` then served, the serve CLI, and the `ValueError` of
the train CLI and Branch-Train-Merge (whose batches carry no frames).

Smoke size: the reference's `smoke_config` (4 decoder and 2 encoder
layers, d_model 64, 4 heads of 16 over 4 KV heads, 24 encoder frames,
vocabulary 503, gelu MLP, no RoPE). Inputs are made from a seed with
numpy and handed to both packages; frames come from `make_batch`. The
reference's prefill, decode and loss run under `jax.jit`. Each
assertion says whether it is bitwise or within a tolerance; every
tolerance is at least twice the largest reading on an x86 CPU.
Positions: XLA's fp32 exp and sin differ from torch's by an ulp on some
inputs, so the two packages' sinusoids differ by up to an ulp of the
angle (6e-8 over the smoke config's 24 positions, 1.2e-4 at Whisper's
1500; values of order 1).
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
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash)
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.model import _sinusoidal_at as j_sin_at  # noqa: E402
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
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_grad_plain)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model, period_layout  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params, non_embedding_params)
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.btm import BranchTrainMerge  # noqa: E402
from repro_torch.train.serve import greedy_decode  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402,E501

torch.set_num_threads(1)

ARCH = "whisper-tiny"
# the model against the reference by compute dtype: (logits atol, cache
# atol), logits up to 12.7. fp32 read 4.8e-6 and 6.0e-7; bf16 read 0.125
# and 9.8e-3 (B9 keeps p . v in fp32 where `chunked_attention` rounds p
# to bf16; the self cache's keys move with the residual stream)
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


def _np_params(cfg, seed):
    """Numpy fp32 weights in the port's layout: norms near 1, the
    embedding (the tied head) at 0.4, the rest at 0.05."""
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
            scale = 0.4 if keys[-1] == "embed" else 0.05
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
    """make_batch's tokens and frames (numpy), for both packages."""
    return jmake_batch(jcfg, JShape("s", seq, batch, "prefill"), step)


def _jb(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tb(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _close_caches(got, want, lim):
    """Every cache leaf: {"cross": (k, v), "self": (k, v)} of [n_layers,
    B, slots, HK, D]."""
    assert sorted(got) == sorted(want) == ["cross", "self"]
    for part in ("self", "cross"):
        for t, a in zip(got[part], want[part]):
            assert tuple(t.shape) == a.shape
            np.testing.assert_allclose(_f32(t), _f32(a), rtol=0, atol=lim)


# ------------------------------------------- config, layout, counts, init


def test_config_equals_reference():
    """Exact: the port's whisper-tiny is the reference's, field for
    field, and so is its smoke reduction; no RoPE."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == \
        dataclasses.asdict(jsmoke(ARCH))
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.rope_theta, cfg.encoder_seq,
            cfg.n_encoder_layers) == ("encdec", 0.0, 1500, 4)


def test_period_layout_equals_reference():
    """Exact: `period_layout` of the enc-dec config is the reference's
    (the plain dense layout, which neither package's model uses: the
    enc-dec family has no period stack)."""
    for cfg, jcfg in ((get_config(ARCH), jget_config(ARCH)),
                      (smoke_config(ARCH), jsmoke(ARCH))):
        layout, n = period_layout(cfg)
        jlayout, jn = jperiod(jcfg)
        assert n == jn == cfg.n_layers
        assert [(s.mixer, s.ffn, s.window) for s in layout] == \
            [(s.mixer, s.ffn, s.window) for s in jlayout]
        m = Model(cfg)
        assert m.encdec and m.layout == [] and "blocks" not in m.schema()


def test_count_params_equal_reference():
    """Exact: `count_params` and `non_embedding_params` at full size, the
    reference's: 36,439,680 parameters (the tied 51,865 x 384
    embedding, 4 encoder and 4 decoder layers)."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert count_params(cfg) == jcount(jcfg) == (36_439_680, 36_439_680)
    assert non_embedding_params(cfg) == jnon_embedding(jcfg)
    sizes = dict(schema_leaves(Model(cfg).schema()))
    assert sizes["['enc_blocks']['attn']['wq']"].shape == (4, 384, 384)
    assert sizes["['dec_blocks']['cross']['wk']"].shape == (4, 384, 384)


def test_init_bitwise_and_schema_paths():
    """Bitwise: `Model.init(key)` draws the reference's parameters, leaf
    for leaf by path: `enc_blocks`, `enc_final_norm`, and `dec_blocks`
    with `cross_norm` and `cross`."""
    cfg, jcfg = _configs()
    got = Model(cfg).init(prng.PRNGKey(3), device="cpu")
    want = JModel(jcfg).init(jax.random.PRNGKey(3))
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    flat = pytree.flatten_with_path(got)[0]
    assert [pytree.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    assert set(got) == {"embed", "final_norm", "enc_blocks",
                        "enc_final_norm", "dec_blocks"}
    assert set(got["dec_blocks"]) == {"pre_norm", "attn", "cross_norm",
                                      "cross", "ffn_norm", "ffn"}
    for (_, a), (_, b) in zip(flat, jflat):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ----------------------------------------------------- B9, positions


def _qkv(rng, b, sq, sk, h, hk, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32))


@pytest.mark.parametrize("sq,sk", [(40, 1500), (1500, 1500), (4, 1500),
                                   (448, 1500), (33, 93)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_noncausal_ragged_vs_chunked(sq, sk, dtype):
    """B9's plain version (what the wrapper runs on CPU tensors),
    non-causal, against `chunked_attention` at Whisper's head dim 64 and
    Sk = 1500 (1500 % 64 = 28: the keys past Sk masked, as
    `chunked_attention`, which pads only queries, never sees them): the
    encoder's Sq = Sk, the cross prefill's 4 and 448 queries, and a
    short ragged case. fp32 within 2e-6 (the CPU read 4.8e-7); bf16
    within one bf16 ulp of |out| + 4e-3 (the reference rounds p to bf16
    before p . v, B9 keeps it in fp32; the CPU read 9.5e-4 beyond the
    ulp)."""
    rng = np.random.default_rng(sq + sk)
    q, k, v = _qkv(rng, 1, sq, sk, 2, 2, 64)
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
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_less(np.abs(_f32(got) - want),
                                 2.0 ** -7 * np.abs(want) + 4e-3)


def test_flash_plain_noncausal_vs_pallas_at_a_multiple_of_128():
    """Within 2e-6, fp32: B9's plain version, non-causal with Sq != Sk,
    against the reference's Pallas kernel in interpret mode at Sk = 256
    (a multiple of 128, where the reference kernel pads no key)."""
    q, k, v = _qkv(np.random.default_rng(1), 2, 40, 256, 6, 6, 64)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=False, block_q=64, block_k=128, interpret=True)
    got = flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                          causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("sq,sk", [(37, 150), (150, 150)])
def test_flash_plain_noncausal_gradient_vs_jax_grad(sq, sk):
    """Within 2e-5 of each gradient's largest magnitude, fp32: B9's plain
    forward and backward (the autograd function on CPU tensors),
    non-causal at a ragged Sk, cross (Sq != Sk) and self (Sq = Sk),
    against `jax.grad` of `chunked_attention` (q_chunk 32, so the
    reference pads its queries)."""
    rng = np.random.default_rng(sq)
    q, k, v = _qkv(rng, 2, sq, sk, 4, 2, 64)
    g = rng.standard_normal((2, sq, 4, 64)).astype(np.float32)
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


def test_sinusoidal_positions_match_reference():
    """Within 2.5e-4 at Whisper's 1500 positions and 384 dims (an fp32
    ulp of the angle: XLA's exp and sin against torch's; the CPU read
    1.2e-4), 4e-6 over the smoke config's 24 (read 6e-8); bitwise within the port: `sinusoidal_at(p)` is row
    p of `sinusoidal_positions` (a decode step's position is the
    prefill's), and the reference's `_sinusoidal_at` equals its own
    row."""
    for seq, d, lim in ((1500, 384, 2.5e-4), (24, 64, 4e-6)):
        got = L.sinusoidal_positions(seq, d)
        want = np.asarray(JL.sinusoidal_positions(seq, d))
        assert got.dtype == torch.float32 and got.shape == (seq, d)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=lim)
        for p in (0, 1, seq - 1):
            assert torch.equal(L.sinusoidal_at(p, d)[0, 0], got[p])
            assert np.array_equal(
                np.asarray(j_sin_at(jnp.asarray(p, jnp.int32), d))[0, 0],
                want[p])


# --------------------------------------------------- prefill and decode


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_matches_reference(cd):
    """Last logits and every cache leaf within LIMITS[cd]: a 40-token
    prompt (past the 32-query chunk of the reference's attention) into a
    48-slot self cache; the cross caches hold the 24 encoder frames'
    keys and values."""
    cfg, jcfg = _configs(cd)
    b = _batch(jcfg, 40, 3)
    jp, tp = _both(_np_params(cfg, 3))
    jl, jc = _jref(jcfg)[0](jp, _jb(b), 48)
    tl, tc = Model(cfg).prefill(tp, _tb(b), max_len=48)
    assert tl.dtype == torch.float32 and tl.shape == (3, cfg.vocab_size)
    assert tc["self"][0].shape == (4, 3, 48, 4, 16)
    assert tc["cross"][0].shape == (4, 3, 24, 4, 16)
    assert tc["self"][0].dtype == getattr(torch, cd)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LIMITS[cd][0])
    _close_caches(tc, jc, LIMITS[cd][1])


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_matches_reference(cd):
    """A prompt of 16, then 9 decode steps (sinusoidal positions 16-24),
    each fed the reference's next token: every step's logits within
    LIMITS[cd], the caches written in place (the same tensors come
    back), every cache leaf after the last step within its limit; a step
    past the self cache raises ValueError."""
    cfg, jcfg = _configs(cd)
    b = _batch(jcfg, 25, 2)
    jp, tp = _both(_np_params(cfg, 4))
    (jprefill, jdecode, _), tm = _jref(jcfg), Model(cfg)
    head = {"tokens": b["tokens"][:, :16], "frames": b["frames"]}
    _, jc = jprefill(jp, _jb(head), 25)
    _, tc = tm.prefill(tp, _tb(head), max_len=25)
    for pos in range(16, 25):
        tok = b["tokens"][:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok),
                         jnp.asarray(pos, jnp.int32))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LIMITS[cd][0])
    _close_caches(tc, jc, LIMITS[cd][1])
    with pytest.raises(ValueError, match="25-slot"):
        tm.decode_step(tp, tc, torch.from_numpy(b["tokens"][:, :1]), 25)


def test_decode_parity_with_full_forward():
    """Within 2e-5, fp32: prefill(16) + 8 decode steps give the last
    logits of prefill(24) on the same frames, and the self caches' keys
    and values within 1e-6; the cross caches bitwise (written once from
    the same encoder output)."""
    cfg, jcfg = _configs()
    _, tp = _both(_np_params(cfg, 9))
    model = Model(cfg)
    b = _tb(_batch(jcfg, 24, 2))
    full, fc = model.prefill(tp, b)
    _, caches = model.prefill(tp, {"tokens": b["tokens"][:, :16],
                                   "frames": b["frames"]}, max_len=24)
    for pos in range(16, 24):
        inc, _ = model.decode_step(tp, caches, b["tokens"][:, pos:pos + 1],
                                   pos)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=0, atol=2e-5)
    for i in (0, 1):
        np.testing.assert_allclose(caches["self"][i].numpy(),
                                   fc["self"][i].numpy(), rtol=0, atol=1e-6)
        assert torch.equal(caches["cross"][i], fc["cross"][i])


def _jax_greedy_logits(jcfg, jp, b, steps):
    """The reference's greedy loop (`repro.train.serve.greedy_decode`),
    keeping each step's logits."""
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
    """`greedy_decode` of 8 tokens past a 4-token prompt (the chip
    smoke's prompt length): fp32 tokens equal to the reference's greedy
    loop and every step's logits within LIMITS; bf16 tokens equal at
    every step up to each row's first whose reference top-2 margin is
    within the logits limit (at least 3 compared)."""
    cfg, jcfg = _configs(cd)
    jp, tp = _both(_np_params(cfg, 5))
    b = _batch(jcfg, 4, 3)
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
    """`Model.loss` and every leaf's gradient (the encoder's and the
    decoder's, through the cross-attention) against
    `jax.value_and_grad(model.loss)` over 40 tokens and 24 frames, remat
    on the decoder layers and off: fp32 loss within 1e-6 relative and
    gradients within 2e-5 of each leaf's largest magnitude; bf16 loss
    within 2e-3 relative and gradients within 5e-2 (the CPU read 5.4e-5
    and 1.6e-2; fp32 0 and 1.5e-6: bf16 roundings of B9's outputs and of
    p, as tests/test_torch_train.py states)."""
    cfg, jcfg = _configs(cd, remat=remat)
    pn = _np_params(cfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        convert.from_numpy_tree(pn, "cpu"))
    b = _batch(jcfg, 40, 2, step=7)
    (jl, jmets), jg = _jref(jcfg.replace(remat="none"))[2](jp, _jb(b))
    loss, mets = Model(cfg).loss(p, _tb(b))
    loss.backward()
    lt, gt = (1e-6, 2e-5) if cd == "float32" else (2e-3, 5e-2)
    assert abs(float(loss.detach()) - float(jl)) <= lt * abs(float(jl))
    assert float(mets["aux"]) == 0.0 == float(jmets["aux"])
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    flat, _ = pytree.flatten_with_path(p)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [pytree.keystr(k) for k, _ in flat]
    for (path, a), (_, t) in zip(jflat, flat):
        assert torch.isfinite(t.grad).all()
        assert _rel(a, t.grad) <= gt, jax.tree_util.keystr(path)


def test_grad_views_per_layer():
    """Exact: the train step's autograd leaves (`_grad_views`) for the
    enc-dec stacks are per-layer lists of views of the stacked leaves
    (2 encoder and 4 decoder layers), each .grad a view of its slice of
    the stacked gradient; the other leaves are views of their own."""
    cfg, _ = _configs()
    params = convert.from_numpy_tree(_np_params(cfg, 2), "cpu")
    grads = pytree.tree_map(torch.zeros_like, params)
    live = tstep._grad_views(params, grads, 0)
    assert len(live["enc_blocks"]) == 2 and len(live["dec_blocks"]) == 4
    for name, n in (("enc_blocks", 2), ("dec_blocks", 4)):
        for i in range(n):
            for t, p, g in zip(pytree.leaves(live[name][i]),
                               pytree.leaves(params[name]),
                               pytree.leaves(grads[name])):
                assert t.requires_grad and t.is_leaf
                assert t.data_ptr() == p[i].data_ptr()
                assert t.grad.data_ptr() == g[i].data_ptr()
    assert live["embed"].grad.data_ptr() == grads["embed"].data_ptr()


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_carries_frames_into_microbatches(accum):
    """One `make_train_step` on a frames batch (4 rows of 32 tokens and
    24 frames), fp32, remat, grad_accum 1 and 2, against
    `jax.jit(make_train_step)`: each microbatch takes its rows of the
    tokens and of the frames, as the reference's reshape; loss and grad
    norm within 1e-5 relative, parameters and moments within 1e-4 of
    each leaf's largest magnitude (the CPU read 2.9e-7 and 1.4e-5)."""
    cfg, jcfg = _configs(remat="full")
    pn = _np_params(cfg, 6)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    jopt = jinit_opt(jp, jcfg.opt_state_dtype)
    jstate = {"params": jp, "m": jopt["m"], "v": jopt["v"],
              "step": jnp.zeros((), jnp.int32)}
    state = init_train_state(Model(cfg), params=convert.from_numpy_tree(
        pn, "cpu"), device="cpu")
    b = _batch(jcfg, 32, 4, step=8)
    assert b["frames"].shape == (4, 24, 64)
    jstate, jmets = jax.jit(jmake_step(JModel(jcfg), total_steps=10,
                                       grad_accum=accum))(jstate, _jb(b))
    state, mets = make_train_step(Model(cfg), total_steps=10,
                                  grad_accum=accum)(state, b)
    for key in ("loss", "grad_norm"):
        assert abs(float(mets[key]) - float(jmets[key])) <= \
            1e-5 * abs(float(jmets[key])), key
    for part in ("params", "m", "v"):
        for a, t in zip(jax.tree_util.tree_leaves(jstate[part]),
                        pytree.leaves(state[part])):
            assert _rel(a, t) <= 1e-4, part


# ------------------------------------------------- merge, serve, CLIs


@pytest.mark.parametrize("name", ["ties", "weight_average"])
def test_merge_through_replica_then_serve(name):
    """The slice end to end, fp32: two contributions (base + 0.05 x a
    seeded delta) and the base through `Replica` on both packages and
    two port replicas in opposite orders: the port's merged tree bitwise
    the reference's and the two replicas' byte-equal; then
    `greedy_decode` of 6 tokens past a 4-token prompt serves it: the
    tokens equal the reference's greedy loop on its merged tree, the
    replicas' tokens and last logits byte-equal."""
    cfg, jcfg = _configs()
    base = _np_params(cfg, 21)
    rng = np.random.default_rng(22)
    tunes = [jax.tree_util.tree_map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), base) for _ in range(2)]
    spec = dict(trim=0.2) if name == "ties" else {}
    jrep = JReplica("ref")
    for t in tunes:
        jrep.contribute(jax.tree_util.tree_map(jnp.asarray, t))
    jref = jrep.register_base(jax.tree_util.tree_map(jnp.asarray, base))
    jmerged = jrep.resolve(JSpec(name, spec, base_ref=jref))
    b = _batch(jcfg, 4, 2)
    want, _ = _jax_greedy_logits(jcfg, jmerged, b, 6)
    outs = []
    for order in ([0, 1], [1, 0]):
        rep = Replica(f"port-{order[0]}", device="cpu")
        for i in order:
            rep.contribute(convert.from_numpy_tree(tunes[i], "cpu"))
        ref = rep.register_base(convert.from_numpy_tree(base, "cpu"))
        assert rep.merkle_root() == jrep.merkle_root() and ref == jref
        merged = rep.resolve(MergeSpec(name, spec, base_ref=ref))
        for a, w in zip(pytree.leaves(merged),
                        jax.tree_util.tree_leaves(jmerged)):
            assert np.array_equal(a.numpy(), np.asarray(w))
        outs.append((merged, *greedy_decode(Model(cfg), merged, _tb(b), 6,
                                            return_logits=True)))
    assert np.array_equal(outs[0][1].numpy(), want)
    (m0, t0, l0), (m1, t1, l1) = outs
    for a, c in zip(pytree.leaves(m0), pytree.leaves(m1)):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    assert torch.equal(t0, t1)
    assert torch.equal(l0[-1].view(torch.int32), l1[-1].view(torch.int32))


def test_serve_cli(capsys):
    """`--arch whisper-tiny --smoke --device cpu` (the reference's own
    usage example, `repro/launch/serve.py:3-4`) in-process: 8 tokens for
    each of 4 rows, every one in the vocabulary."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("generated (4, 8) tokens in ")
    sample = out.split("sample: [")[1].split("]")[0].split()
    assert len(sample) == 8 and all(0 <= int(t) < 503 for t in sample)


def test_train_cli_and_btm_raise_value_error(tmp_path, monkeypatch):
    """The train CLI and Branch-Train-Merge feed tokens alone, so the
    port's `Model.loss` raises `ValueError` naming the missing frames,
    where the reference's raises `KeyError('frames')` (ROADMAP C,
    reference-side hazards)."""
    from repro_torch.launch import train
    with pytest.raises(ValueError, match="'frames'"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "1", "--batch",
                    "2", "--seq", "8", "--device", "cpu"])
    cfg, jcfg = _configs(grad_accum=1)
    kw = dict(n_branches=2, merge_every=1, batch_size=2, seq_len=8)
    with pytest.raises(ValueError, match="'frames'"):
        BranchTrainMerge(cfg, device="cpu", **kw).train_round()
    with pytest.raises(KeyError, match="frames"):
        JBTM(jcfg, **kw).train_round()
    import repro.launch.train as jtrain
    monkeypatch.setattr("sys.argv", ["train", "--arch", ARCH, "--smoke",
                                     "--steps", "1", "--batch", "2",
                                     "--seq", "8"])
    with pytest.raises(KeyError, match="frames"):
        jtrain.main()
