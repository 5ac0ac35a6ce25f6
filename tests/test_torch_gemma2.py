"""Gemma-2 on the port against the JAX reference, on the CPU: the
config, parameter counts, `Model.init`, B9's softcap and sliding window
(its plain version, what `flash_attention` runs on CPU tensors), the
local/global period layout with sandwich norms, prefill into ring
caches, decode across a ring's wrap, `greedy_decode`, merge -> serve
through `Replica`, and the serving CLI.

gemma2's smoke config keeps the full config's window (4096) and
softcap (50), which never bind at smoke sizes: every test sets
`sliding_window` to 5 and `attn_softcap` to 2.0 on both sides, and
draws the query and key projections at 0.3 (not 0.02) so the scaled
logits reach the softcap's bend. Inputs are made from a seed with numpy
and handed to both packages (`convert.from_numpy_tree`). Each assertion
says whether it is bitwise or within a tolerance, and which. In fp32
compute the limits are a few times the CPU's readings. In bf16 the
port's attention keeps p . v in fp32 where `chunked_attention` rounds p
to bf16 first, so logits and cache leaves are held to a few bf16 ulps
of their magnitude, and greedy tokens are compared at every step whose
top-2 logit margin exceeds the logits limit.
"""
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
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.models.params import count_params as jcount  # noqa: E402
from repro.models.params import (  # noqa: E402
    non_embedding_params as jnon_embedding)
from repro.train.serve import greedy_decode as jgreedy  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, visible_keys)
from repro_torch.models.model import Model, period_layout  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params, non_embedding_params)
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train.serve import greedy_decode  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "gemma2-27b"
WINDOW, SOFTCAP = 5, 2.0
ARCHS = ("gemma2-27b", "phi3-mini-3.8b", "minicpm-2b", "minitron-8b")
# B9's plain version against `chunked_attention` with a window and a
# softcap, fp32: the CPU read at most 4.5e-6 (inputs of scale 2, outputs
# up to ~3)
FLASH_ATOL = 1e-5
# prefill / decode against JAX, by compute dtype: (logits atol, cache
# atol). fp32 read 5.7e-6 (logits of up to 21 under the final softcap
# of 30) and 3.8e-6 (cache); bf16 read 6.1e-2 and 6.25e-2: one bf16 ulp
# of logits near 16 and of keys near 8 (the 0.3 projections make them
# large)
LIMITS = {"float32": (2e-5, 1e-5), "bfloat16": (0.25, 0.125)}


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jeng.clear_cache()
    engine.clear_cache()


def _configs(cd: str = "float32", **kw):
    kw = dict(sliding_window=WINDOW, attn_softcap=SOFTCAP, compute_dtype=cd,
              **kw)
    return smoke_config(ARCH).replace(**kw), jsmoke(ARCH).replace(**kw)


def _np_params(cfg, jcfg, seed):
    """Numpy fp32 weights in the port's layout, checked to be the
    reference's: norms near 1, embeddings 0.4, the query and key
    projections 0.3 (softcapped logits), the rest 0.02."""
    leaves = schema_leaves(Model(cfg).schema())
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        JModel(jcfg).schema(), is_leaf=lambda x: hasattr(x, "init"))
    assert [p for p, _ in leaves] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    assert [d.shape for _, d in leaves] == [d.shape for _, d in jflat]
    rng = np.random.default_rng(seed)
    out = {}
    for path, pdef in leaves:
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        if pdef.init == "ones":
            a = 1 + 0.1 * rng.standard_normal(pdef.shape)
        else:
            scale = {"embed": 0.4, "wq": 0.3, "wk": 0.3}.get(
                keys[0] if keys[0] == "embed" else keys[-1], 0.02)
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


def _qkv(rng, b, sq, sk, h, hk, d, scale=1.0):
    return tuple((scale * rng.standard_normal(shape)).astype(np.float32)
                 for shape in ((b, sq, h, d), (b, sk, hk, d), (b, sk, hk, d)))


def _tokens(jcfg, seq, batch):
    return jmake_batch(jcfg, JShape("s", seq, batch, "prefill"))["tokens"]


# ------------------------------------------------- config, counts, init


def test_config_equals_reference():
    """Exact: the port's gemma2-27b is the reference's, field for field,
    and so is its smoke reduction."""
    assert vars(get_config(ARCH)) == vars(jget_config(ARCH))
    assert vars(smoke_config(ARCH)) == vars(jsmoke(ARCH))
    layout, n = period_layout(get_config(ARCH))
    assert n == 23 and [sl.window for sl in layout] == [4096, 0]


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equal_reference(arch):
    """Exact: `count_params` and `non_embedding_params` over the port's
    schema give the reference's (total, active) at full size; gemma2-27b
    has 27,227,128,320 parameters."""
    assert count_params(get_config(arch)) == jcount(jget_config(arch))
    assert get_config(arch).param_counts() == jcount(jget_config(arch))
    assert non_embedding_params(get_config(arch)) == \
        jnon_embedding(jget_config(arch))
    if arch == ARCH:
        assert count_params(get_config(arch)) == (27_227_128_320,) * 2


def test_init_bitwise_and_schema_paths():
    """Bitwise: `Model.init(key)` draws the reference's parameters, leaf
    for leaf by path, sandwich norms included."""
    cfg, jcfg = _configs()
    got = Model(cfg).init(prng.PRNGKey(2), device="cpu")
    want = JModel(jcfg).init(jax.random.PRNGKey(2))
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    flat = pytree.flatten_with_path(got)[0]
    assert [pytree.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    assert "['blocks']['sub1']['post_ffn_norm']" in \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    for (_, a), (_, b) in zip(flat, jflat):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------------ B9


@pytest.mark.parametrize("window", [1, 5, 64])
@pytest.mark.parametrize("softcap", [0.0, 2.0, 50.0])
@pytest.mark.parametrize("q_offset", [0, 9])
def test_flash_plain_window_softcap_matches_chunked_attention(
        window, softcap, q_offset):
    """Within FLASH_ATOL, fp32: B9's plain version with a window (1, 5,
    and 64 >= Sk: never binding) and a softcap (off, binding, nearly
    linear) against `chunked_attention` (the reference model's
    `_attn_core` mask), prefill at q_offset 0 and a chunk of queries at
    q_offset 9 (q_chunk 8: the reference scans)."""
    rng = np.random.default_rng(window * 7 + q_offset)
    q, k, v = _qkv(rng, 2, 21, 21 + q_offset, 4, 2, 16, scale=2.0)
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_offset=q_offset,
                                window=window, softcap=softcap, q_chunk=8,
                                compute_dtype=jnp.float32)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), q_offset=q_offset,
                          window=window, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FLASH_ATOL)


def test_flash_ring_decode_matches_chunked_attention():
    """Within FLASH_ATOL, fp32: one decode query over a ring of W slots
    at several positions (before, at and past the wrap), B9 at
    q_offset = min(pos, W - 1) without a window against the reference's
    `_attn_with_cache` mask (`kv_positions = pos - (pos - i) mod W`)."""
    w = WINDOW
    rng = np.random.default_rng(11)
    for pos in (2, w - 1, w, 2 * w + 3):
        q, k, v = _qkv(rng, 2, 1, w, 4, 2, 16, scale=2.0)
        idx = jnp.arange(w)
        kv_pos = pos - jnp.mod(pos - idx, w)
        want = JL.chunked_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), q_offset=pos,
            kv_positions=kv_pos, kv_valid=kv_pos >= 0, window=w,
            softcap=SOFTCAP, q_chunk=8, compute_dtype=jnp.float32)
        got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), q_offset=min(pos, w - 1),
                              softcap=SOFTCAP)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=FLASH_ATOL)


def test_flash_window_options():
    """Exact: a window needs causal attention (`ValueError`, under
    autograd too); a window of 0 or less is off, as in the reference;
    `visible_keys` gives the key range the decode design splits; under
    autograd a window or a softcap runs B9's gradient, whose forward
    gives the served forward's bits."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(
        np.random.default_rng(5), 1, 3, 9, 2, 1, 16))
    with pytest.raises(ValueError, match="causal"):
        flash_attention(q, k, v, causal=False, window=4)
    assert torch.equal(flash_attention(q, k, v, window=-3),
                       flash_attention(q, k, v))
    assert visible_keys(1, 100, True, 60, 16) == (45, 61)
    assert visible_keys(1, 100, True, 60, 0) == (0, 61)
    assert visible_keys(1, 100, True, 10, 16) == (0, 11)
    assert visible_keys(3, 9, False, 0, 0) == (0, 9)
    qg = q.clone().requires_grad_()
    with pytest.raises(ValueError, match="causal"):
        flash_attention(qg, k, v, causal=False, window=4)
    for kw in (dict(window=4), dict(softcap=30.0)):
        out = flash_attention(qg, k, v, **kw)
        assert out.requires_grad
        assert torch.equal(out.detach(), flash_attention(q, k, v, **kw))


# ------------------------------------------------------- prefill / decode


def _prefill_both(cfg, jcfg, pn, toks, max_len):
    jp, tp = _both(pn)
    jl, jc = JModel(jcfg).prefill(jp, {"tokens": jnp.asarray(toks)},
                                  max_len=max_len)
    tl, tc = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                max_len=max_len)
    return (jl, jc), (tl, tc)


def _close_caches(tc, jc, lim):
    jleaves = jax.tree_util.tree_leaves(jc)
    tleaves = pytree.leaves(tc)
    assert [tuple(t.shape) for t in tleaves] == [a.shape for a in jleaves]
    for t, a in zip(tleaves, jleaves):
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_allclose(_f32(t), _f32(a), rtol=0, atol=lim)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,max_len", [(13, 16), (10, 12), (3, 8),
                                       (40, 44)])
def test_prefill_matches_reference(cd, s, max_len):
    """Last logits and every cache leaf within LIMITS[cd]: prompts of 13
    (a rolled ring, 13 % 5 = 3), 10 (13 % 5 = 0), 3 (shorter than the
    window: zero-padded) and 40 (past the 32-query chunk, so the
    reference scans); the local sub-layer's cache has min(W, max_len)
    slots, the global one max_len."""
    cfg, jcfg = _configs(cd)
    toks = _tokens(jcfg, s, 3)
    (jl, jc), (tl, tc) = _prefill_both(cfg, jcfg, _np_params(cfg, jcfg, 3),
                                       toks, max_len)
    lim_logits, lim_cache = LIMITS[cd]
    assert tl.dtype == torch.float32 and tl.shape == (3, cfg.vocab_size)
    assert tuple(tc["blocks"]["sub0"][0].shape)[2] == min(WINDOW, max_len)
    assert tuple(tc["blocks"]["sub1"][0].shape)[2] == max_len
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=lim_logits)
    _close_caches(tc, jc, lim_cache)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_across_the_ring_wrap_matches_reference(cd):
    """A prompt of 8 (ring slot 3 next), then 9 decode steps at
    positions 8-16, across the ring's wraps at 10 and 15, each fed the
    reference's next token: every step's logits within LIMITS[cd], and
    every cache leaf after the last step within its cache limit."""
    cfg, jcfg = _configs(cd)
    toks = _tokens(jcfg, 17, 2)
    (jl, jc), (tl, tc) = _prefill_both(cfg, jcfg, _np_params(cfg, jcfg, 4),
                                       toks[:, :8], 20)
    jp, tp = _both(_np_params(cfg, jcfg, 4))
    jm, tm = JModel(jcfg), Model(cfg)
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


def test_decode_parity_with_full_forward():
    """Within 2e-5 (logits of up to ~20 under the final softcap), fp32:
    prefill(T) + decode steps to T + 7 give the last logits of
    prefill(T + 7), across the ring's wrap, as tests/test_models_smoke.py
    checks for JAX."""
    cfg, jcfg = _configs()
    _, tp = _both(_np_params(cfg, jcfg, 9))
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(jcfg, 14, 2))
    full, _ = model.prefill(tp, {"tokens": toks})
    _, caches = model.prefill(tp, {"tokens": toks[:, :7]}, max_len=14)
    for pos in range(7, 14):
        inc, _ = model.decode_step(tp, caches, toks[:, pos:pos + 1], pos)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=0, atol=2e-5)


def test_decode_refusals():
    """Exact: a step of two tokens on a ring cache and a step past the
    global cache raise `ValueError`; the bound reads the global cache
    (12 slots), not the local ring (5)."""
    cfg, jcfg = _configs()
    _, tp = _both(_np_params(cfg, jcfg, 1))
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(jcfg, 12, 1))
    _, caches = model.prefill(tp, {"tokens": toks[:, :6]}, max_len=12)
    model.decode_step(tp, caches, toks[:, 6:7], 6)
    with pytest.raises(ValueError, match="ring"):
        model.decode_step(tp, caches, toks[:, 7:9], 7)
    model.decode_step(tp, caches, toks[:, 7:8], 11)
    with pytest.raises(ValueError, match="12-slot"):
        model.decode_step(tp, caches, toks[:, 7:8], 12)


# ------------------------------------------------------ greedy, merge, CLI


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
    """fp32: tokens equal to the reference's `greedy_decode` over 9
    steps past a 7-token prompt (the ring wraps), every step's logits
    within LIMITS. bf16: per row, tokens equal at every step up to the
    first whose reference top-2 margin is within the logits limit."""
    cfg, jcfg = _configs(cd)
    jp, tp = _both(_np_params(cfg, jcfg, 5))
    toks = _tokens(jcfg, 7, 3)
    steps = 9
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


def test_merge_then_serve_matches_reference():
    """fp32 compute: a base and two contributions (base + 0.01 x a
    seeded delta) through `Replica` and TIES, as
    `examples/serve_merged.py` does: the port's merged tree bitwise the
    reference's, replicas fed in opposite orders byte-equal, and
    `greedy_decode` of 6 tokens past a 6-token prompt (the ring wraps)
    equal to the reference's tokens on both, logits byte-equal."""
    cfg, jcfg = _configs()
    base = _np_params(cfg, jcfg, 21)
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
    want = np.asarray(jgreedy(JModel(jcfg), jmerged,
                              {"tokens": jnp.asarray(toks)}, 6))
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
    assert np.array_equal(t0.numpy(), want)
    assert torch.equal(t0, t1)
    assert all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(l0, l1))


def test_serve_cli_on_the_cpu():
    """The CLI serves gemma2's smoke config (its own window and softcap)
    on the CPU."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu"], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("generated (4, 8) tokens in ")
    assert "sample: [" in proc.stdout
