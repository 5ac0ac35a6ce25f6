"""The port's serving path against the JAX reference, on the CPU:
B9's plain version, the dense layers, prefill with its KV cache,
decode, `greedy_decode`, `make_batch`, the merge -> serve slice end to
end, and the serving CLI.

Inputs are made from a seed with numpy and handed to both packages (JAX
weights carried across with `convert.from_numpy_tree(..., "cpu")`).
Each assertion says whether it is bitwise or within a tolerance, and
which. In fp32 compute the limits are a few times the readings and the
greedy tokens are equal. In bf16 the port's attention keeps p . v in
fp32 where `chunked_attention` rounds p to bf16 first, so the limits
are about five times the bf16 readings (one bf16 ulp of the values
compared), and greedy tokens are compared at every step whose top-2
logit margin exceeds that limit.
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
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import SHAPES as JSHAPES  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.kernels.flash_attention import (  # noqa: E402
    flash_attention as jflash)
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train.serve import greedy_decode as jgreedy  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.data.synthetic import make_batch  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_plain)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train.serve import greedy_decode  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "phi3-mini-3.8b"
# B9's plain version against the reference kernel in fp32: the CPU read
# at most 4.8e-7 over the five specs (values of order 1)
FLASH_ATOL = 2e-6
# prefill / decode against JAX, by compute dtype: (logits atol, cache
# atol). fp32 read 1.2e-7 (logits) and 2.5e-7 (cache); bf16 read 1.95e-3
# and 3.9e-3, one bf16 ulp of logits near 0.5 and of keys near 1
LIMITS = {"float32": (1e-6, 1e-6), "bfloat16": (1e-2, 2e-2)}


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jeng.clear_cache()
    engine.clear_cache()


def _np_params(cfg, seed):
    """Numpy fp32 weights in the dense layout (checked to be the
    reference's layout too): norms near 1, embeddings of order 0.4 so
    the logits spread, projections 0.02."""
    leaves = schema_leaves(Model(cfg).schema())
    jflat, _ = jax.tree_util.tree_flatten_with_path(
        JModel(jsmoke(ARCH)).schema(), is_leaf=lambda x: hasattr(x, "init"))
    assert [p for p, _ in leaves] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
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
            scale = 0.4 if keys[0] == "embed" else 0.02
            a = scale * rng.standard_normal(pdef.shape)
        node[keys[-1]] = a.astype(np.float32)
    return out


def _configs(kv: int, cd: str):
    return (smoke_config(ARCH).replace(n_kv_heads=kv, compute_dtype=cd),
            jsmoke(ARCH).replace(n_kv_heads=kv, compute_dtype=cd))


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _qkv(rng, b, sq, sk, h, hk, d):
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32),
            rng.standard_normal((b, sk, hk, d)).astype(np.float32))


# ------------------------------------------------------------ configs, data


def test_shape_specs_equal_reference():
    assert {n: vars(s) for n, s in SHAPES.items()} == \
        {n: vars(s) for n, s in JSHAPES.items()}


@pytest.mark.parametrize("seq,batch,step,task", [
    (16, 4, 0, 0), (33, 3, 5, 2), (4064, 4, 0, 0)])
def test_make_batch_bitwise(seq, batch, step, task):
    """Bitwise: the port's copy of the numpy pipeline."""
    got = make_batch(smoke_config(ARCH), ShapeSpec("s", seq, batch,
                                                   "prefill"), step, task)
    want = jmake_batch(jsmoke(ARCH), JShape("s", seq, batch, "prefill"),
                       step, task)
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k])


# ------------------------------------------------------------------ B9


@pytest.mark.parametrize("spec", [
    (2, 128, 128, 4, 2, 32, True),     # GQA causal
    (1, 200, 200, 4, 4, 16, True),     # ragged (padding path)
    (2, 64, 256, 8, 2, 32, False),     # cross-attention-like
    (1, 256, 256, 2, 1, 64, True),     # MQA
    (1, 150, 150, 4, 2, 96, True),     # Phi-3-mini's head dim, ragged
])
def test_flash_plain_matches_reference_kernel(spec):
    """Within FLASH_ATOL: B9's plain version (what `flash_attention`
    runs on CPU tensors) against `repro.kernels.flash_attention` in
    interpret mode, fp32, at the specs of tests/test_kernels.py."""
    b, sq, sk, h, hk, d, causal = spec
    q, k, v = _qkv(np.random.default_rng(0), b, sq, sk, h, hk, d)
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                  causal=causal, block_q=64, block_k=64, interpret=True)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    assert got.dtype == torch.float32 and got.shape == (b, sq, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("case", ["decode", "q_offset_chunk",
                                  "noncausal_ragged", "gqa_decode"])
def test_flash_plain_matches_chunked_attention(case):
    """Within JAX's own 2e-4 (tests/test_kernels.py): the masks the
    serving path needs, against `chunked_attention`. decode: one query
    at q_offset = pos over a cache whose keys past pos are masked by
    `kv_valid` (`Model._attn_with_cache`); q_offset_chunk: several
    queries past an offset; noncausal_ragged: Sk not a multiple of any
    block, where the reference kernel leaves its zero-padded keys in the
    softmax and B9 masks them."""
    rng = np.random.default_rng(3)
    kw = {}
    if case in ("decode", "gqa_decode"):
        hk = 2 if case == "gqa_decode" else 4
        q, k, v = _qkv(rng, 2, 1, 50, 4, hk, 16)
        pos, causal = 33, True
        kw = dict(kv_positions=jnp.arange(50), kv_valid=jnp.arange(50) <= pos)
    elif case == "q_offset_chunk":
        q, k, v = _qkv(rng, 2, 7, 40, 4, 2, 32)
        pos, causal = 33, True
    else:
        q, k, v = _qkv(rng, 2, 37, 100, 4, 2, 32)
        pos, causal = 0, False
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), q_offset=pos, causal=causal,
                                q_chunk=512, compute_dtype=jnp.float32, **kw)
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal, q_offset=pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    if case == "noncausal_ragged":
        # the reference kernel's unmasked padding is a real difference
        ref = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=False, block_q=64, block_k=64, interpret=True)
        assert np.abs(np.asarray(ref) - got.numpy()).max() > 1e-2


def test_flash_plain_bf16_matches_chunked_attention():
    """Within one bf16 ulp of |out| + 4e-3: bf16 q, k, v; the reference
    rounds p to bf16 before p . v (2^-9 of each p |v|, against sums of
    |v| of order 1, whatever the output's size), B9 keeps it in fp32.
    The CPU read at most 1.6e-3 beyond one ulp."""
    q, k, v = _qkv(np.random.default_rng(4), 2, 70, 70, 4, 2, 32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    got = flash_attention(tq, tk, tv)
    want = JL.chunked_attention(jq, jk, jv, q_chunk=512)
    assert got.dtype == torch.bfloat16
    w = _f32(want)
    np.testing.assert_array_less(np.abs(_f32(got) - w),
                                 2.0 ** -7 * np.abs(w) + 4e-3)


def test_flash_edges_and_refusals():
    """Exact: a head that sees no key gives zeros; the plain version is
    what the wrapper runs on the CPU. Within FLASH_ATOL, fp32: gemma2's
    window and softcap against `chunked_attention`.
    Raise: a window without `causal`, mixed dtypes, bad head counts and
    negative offsets."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(
        np.random.default_rng(5), 1, 3, 5, 2, 1, 16))
    assert torch.equal(flash_attention(q, k, v, q_offset=2),
                       flash_attention_plain(q, k, v, q_offset=2))
    empty = flash_attention(q, k[:, :0], v[:, :0], causal=False)
    assert torch.equal(empty, torch.zeros_like(q))
    for kw in (dict(window=2), dict(softcap=0.5)):
        want = JL.chunked_attention(*(jnp.asarray(t.numpy())
                                      for t in (q, k, v)), q_offset=2,
                                    q_chunk=512, compute_dtype=jnp.float32,
                                    **kw)
        np.testing.assert_allclose(
            flash_attention(q, k, v, q_offset=2, **kw).numpy(),
            np.asarray(want), rtol=0, atol=FLASH_ATOL)
    for kw in (dict(q_offset=-1), dict(causal=False, window=4)):
        with pytest.raises(ValueError):
            flash_attention(q, k, v, **kw)
    with pytest.raises(TypeError):
        flash_attention(q.to(torch.bfloat16), k, v)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :, :1].repeat(1, 1, 3, 1), k.repeat(1, 1, 2, 1),
                        v.repeat(1, 1, 2, 1))


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_and_rope_match_reference(dtype):
    """fp32: within 1e-6; bf16: within one bf16 ulp of |x| (both compute
    in fp32 and round once)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 9, 4, 16)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x, dtype)
    pos = np.arange(5, 14)
    for got, want in (
            (L.rmsnorm(torch.from_numpy(w), tx, 1e-6),
             JL.rmsnorm(jnp.asarray(w), jx, 1e-6)),
            (L.apply_rope(tx, torch.from_numpy(pos), 10000.0),
             JL.apply_rope(jx, jnp.asarray(pos), 10000.0))):
        assert str(got.dtype).split(".")[-1] == dtype
        if dtype == "float32":
            np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-6,
                                       atol=1e-6)
        else:
            np.testing.assert_allclose(_f32(got), _f32(want),
                                       rtol=2.0 ** -7, atol=1e-6)
    np.testing.assert_allclose(L.rope_freqs(16, 10000.0).numpy(),
                               np.asarray(JL.rope_freqs(16, 10000.0)),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "relu2", "gelu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(variant, dtype):
    """fp32: within 1e-5. bf16: relative error (Frobenius) within 2^-6:
    the two libraries round the bf16 intermediates (activation, product)
    differently, and the output sums those roundings over d_ff; the CPU
    read at most 5.0e-3, the same size as either package's distance
    from the fp32 result."""
    rng = np.random.default_rng(7)
    p = {k: (0.2 * rng.standard_normal(d.shape)).astype(np.float32)
         for k, d in L.mlp_def(32, 48, variant, 0.02).items()}
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    got = L.mlp(convert.from_numpy_tree(p, "cpu"), torch.from_numpy(x),
                variant, getattr(torch, dtype))
    want = JL.mlp(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                  variant, jnp.dtype(dtype))
    if dtype == "float32":
        np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5,
                                   atol=1e-5)
    else:
        w = _f32(want)
        assert np.linalg.norm(_f32(got) - w) <= 2.0 ** -6 * np.linalg.norm(w)


def test_gqa_attention_matches_reference():
    """Within 1e-5, fp32: the attention sub-layer (projections, RoPE,
    B9's plain version, output projection), against the reference's
    query-chunked one."""
    rng = np.random.default_rng(8)
    p = {k: (0.2 * rng.standard_normal(d.shape)).astype(np.float32)
         for k, d in L.attn_def(32, 4, 2, 16, 0.02).items()}
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    kw = dict(n_heads=4, n_kv=2, head_dim=16, rope_theta=10000.0)
    got = L.gqa_attention(convert.from_numpy_tree(p, "cpu"),
                          torch.from_numpy(x), compute_dtype=torch.float32,
                          **kw)
    want = JL.gqa_attention(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(x), compute_dtype=jnp.float32,
                            q_chunk=4, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- prefill / decode


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(kv, cd):
    """Prefill of a 40-token prompt (past the smoke config's 32-query
    chunk, so the reference scans) into a cache of 44: last logits and
    every cache leaf within LIMITS[cd]; then one decode step's logits
    within the same logits limit. kv=2 is the GQA variant."""
    cfg, jcfg = _configs(kv, cd)
    pn = _np_params(cfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    tp = convert.from_numpy_tree(pn, "cpu")
    toks = jmake_batch(jcfg, JShape("s", 41, 3, "prefill"))["tokens"]
    jm, tm = JModel(jcfg), Model(cfg)
    jl, jc = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :40])},
                        max_len=44)
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :40])},
                        max_len=44)
    lim_logits, lim_cache = LIMITS[cd]
    assert tl.dtype == torch.float32 and tl.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=lim_logits)
    jleaves = jax.tree_util.tree_leaves(jc)
    tleaves = pytree.leaves(tc)
    assert [tuple(t.shape) for t in tleaves] == [a.shape for a in jleaves]
    for t, a in zip(tleaves, jleaves):
        assert str(t.dtype).split(".")[-1] == str(a.dtype)
        np.testing.assert_allclose(_f32(t), _f32(a), rtol=0,
                                   atol=lim_cache)
    jd, _ = jm.decode_step(jp, jc, jnp.asarray(toks[:, 40:41]),
                           jnp.asarray(40, jnp.int32))
    td, tc2 = tm.decode_step(tp, tc, torch.from_numpy(toks[:, 40:41]), 40)
    assert tc2 is tc
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                               atol=lim_logits)


def test_decode_parity_with_full_forward():
    """Within 1e-6 (the CPU read 6e-8; the reference's own test allows
    2e-3), fp32: prefill(T) + decode(T) logits equal prefill(T + 1)'s
    last logits, as tests/test_models_smoke.py checks for JAX."""
    cfg, _ = _configs(2, "float32")
    tp = convert.from_numpy_tree(_np_params(cfg, 9), "cpu")
    model = Model(cfg)
    t = 13
    toks = torch.from_numpy(make_batch(
        cfg, ShapeSpec("p", t + 1, 2, "prefill"))["tokens"])
    full, _ = model.prefill(tp, {"tokens": toks})
    _, caches = model.prefill(tp, {"tokens": toks[:, :t]}, max_len=t + 4)
    inc, _ = model.decode_step(tp, caches, toks[:, t:t + 1], t)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=0,
                               atol=1e-6)


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
    """fp32: tokens equal to the reference's `greedy_decode`, and every
    step's logits within LIMITS. bf16: per row, the tokens are equal at
    every step up to the first whose reference top-2 margin is within
    the logits limit (after that the two rows may follow different
    prefixes)."""
    cfg, jcfg = _configs(2, cd)
    pn = _np_params(cfg, 5)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    tp = convert.from_numpy_tree(pn, "cpu")
    toks = jmake_batch(jcfg, JShape("s", 12, 3, "prefill"))["tokens"]
    steps = 6
    got, logits = greedy_decode(Model(cfg), tp,
                                {"tokens": torch.from_numpy(toks)}, steps,
                                return_logits=True)
    want, every = _jax_greedy_logits(JModel(jcfg), jp, toks, steps)
    assert len(logits) == steps + 1
    assert got.dtype == torch.int32 and got.shape == (3, steps)
    assert np.array_equal(np.asarray(jgreedy(JModel(jcfg), jp, {
        "tokens": jnp.asarray(toks)}, steps)), want)
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
    assert compared >= steps       # the check is not vacuous


# ------------------------------------------------------- the slice, CLI


def _contribs(cfg, seed):
    base = _np_params(cfg, seed)
    rng = np.random.default_rng(seed + 1)
    return base, [jax.tree_util.tree_map(
        lambda b: (b + 0.01 * rng.standard_normal(b.shape)).astype(
            np.float32), base) for _ in range(3)]


def test_merge_then_serve_matches_reference():
    """The slice end to end, fp32 compute: three contributions and a base
    through `Replica` and TIES (the strategy `examples/serve_merged.py`
    serves), then `greedy_decode` of 4 tokens. The port's merged tree is
    bitwise the reference's, and its tokens equal the reference's;
    replicas fed in opposite orders give byte-equal trees, tokens and
    last logits."""
    cfg, jcfg = _configs(4, "float32")
    base, contribs = _contribs(cfg, 21)
    jrep = JReplica("ref")
    for c in contribs:
        jrep.contribute(jax.tree_util.tree_map(jnp.asarray, c))
    jref = jrep.register_base(jax.tree_util.tree_map(jnp.asarray, base))
    jmerged = jrep.resolve(JSpec("ties", base_ref=jref))
    toks = jmake_batch(jcfg, JShape("s", 10, 2, "prefill"))["tokens"]
    want = np.asarray(jgreedy(JModel(jcfg), jmerged,
                              {"tokens": jnp.asarray(toks)}, 4))
    outs = []
    for order in ([0, 1, 2], [2, 1, 0]):
        rep = Replica(f"port-{order[0]}", device="cpu")
        for i in order:
            rep.contribute(convert.from_numpy_tree(contribs[i], "cpu"))
        ref = rep.register_base(convert.from_numpy_tree(base, "cpu"))
        assert rep.merkle_root() == jrep.merkle_root()
        merged = rep.resolve(MergeSpec("ties", base_ref=ref))
        for a, b in zip(pytree.leaves(merged),
                        jax.tree_util.tree_leaves(jmerged)):
            assert np.array_equal(a.numpy(), np.asarray(b))
        outs.append((merged, *greedy_decode(
            Model(cfg), merged, {"tokens": torch.from_numpy(toks)}, 4,
            return_logits=True)))
    assert np.array_equal(outs[0][1].numpy(), want)
    (m0, t0, l0), (m1, t1, l1) = outs
    for a, b in zip(pytree.leaves(m0), pytree.leaves(m1)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert torch.equal(t0, t1)
    assert torch.equal(l0[-1].view(torch.int32), l1[-1].view(torch.int32))


def test_serve_cli_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--smoke", "--device", "cpu"], capture_output=True, text=True,
        timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("generated (4, 8) tokens in ")
    assert "sample: [" in proc.stdout


def test_serve_cli_defaults_to_cuda():
    from repro_torch.launch import serve
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--smoke"])


def test_model_scope():
    """Every family of the reference is ported (MLA in
    tests/test_torch_mla.py; MoE without MLA in tests/test_torch_moe.py,
    which holds the other families' builds; the SSM family,
    tests/test_torch_mamba.py; the enc-dec and VLM families,
    tests/test_torch_whisper.py and tests/test_torch_vlm.py): an MLA
    config builds, and a family the reference does not have raises
    `NotImplementedError`. Sandwich norms (gemma2's) on this
    config: `Model.init` bitwise the reference's, prefill logits within
    LIMITS in fp32 (tests/test_torch_gemma2.py holds
    gemma2's whole layout). The cache has the reference's structure and
    shapes."""
    assert Model(smoke_config("deepseek-v2-236b")).layout[0].mixer == "mla"
    with pytest.raises(NotImplementedError, match="family 'rnn'"):
        Model(smoke_config(ARCH).replace(family="rnn"))
    cfg, jcfg = _configs(2, "bfloat16")
    scfg, sjcfg = (c.replace(sandwich_norms=True, compute_dtype="float32")
                   for c in (cfg, jcfg))
    sp = Model(scfg).init(prng.PRNGKey(4), device="cpu")
    jsp = JModel(sjcfg).init(jax.random.PRNGKey(4))
    for a, b in zip(pytree.leaves(sp), jax.tree_util.tree_leaves(jsp)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    toks = jmake_batch(sjcfg, JShape("s", 9, 2, "prefill"))["tokens"]
    got, _ = Model(scfg).prefill(sp, {"tokens": torch.from_numpy(toks)})
    want, _ = JModel(sjcfg).prefill(jsp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LIMITS["float32"][0])
    got = Model(cfg).init_cache(3, 20, device="cpu")
    want = JModel(jcfg).init_cache(3, 20)
    assert jax.tree_util.tree_structure(want) == \
        jax.tree_util.tree_structure(jax.tree_util.tree_map(
            lambda t: 0, got, is_leaf=lambda x: isinstance(x, torch.Tensor)))
    assert [tuple(t.shape) for t in pytree.leaves(got)] == \
        [a.shape for a in jax.tree_util.tree_leaves(want)]
