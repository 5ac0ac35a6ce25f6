"""Mamba2 (the SSM family) on the port against the JAX reference, on the
CPU: the config and `count_params` at full size, `Model.init`,
`_split_proj`, `_conv1d`, `ssd_chunked` (and the reference's NaN
gradient at chunk 256, which the port does not have), `mamba_block`'s
prefill and decode, `Model.prefill` with every cache leaf, decode steps,
`greedy_decode`, `Model.loss` and its gradients, a train step, a
Branch-Train-Merge round through `Replica`, the `ValueError`s, and the
serve, train and merge CLIs.

Smoke size (d_model 64, 8 SSD heads of 16, d_state 16, chunk 16, 4
layers). Inputs are made from a seed with numpy and handed to both
packages (`convert.from_numpy_tree`). Each assertion says whether it is
bitwise or within a tolerance; every tolerance is at least twice the
largest reading on an x86 CPU. XLA's exp and the port's differ in the
last bit on ~10 % of fp32 inputs, so nothing downstream of an exp (the
conv's silu, softplus, the decays) can be bitwise; the fp32 sums of the
SSD's products run in another order too (`models/mamba.py`).

The weights are drawn so that every parameter matters: norms and D near
1, A's log and dt's bias at 0.3 (the init's zeros would give every head
A = -1), w_in and w_out at 0.1, the conv at 0.3, the embedding at 0.4.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import MambaConfig as JMambaConfig  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
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
from repro_torch.configs.base import MambaConfig  # noqa: E402
from repro_torch.core import engine  # noqa: E402
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

ARCH = "mamba2-780m"
# ssd_chunked against the reference: no element beyond this share of the
# output's (and final state's) largest magnitude. fp32 read 2.6e-7 at
# chunk 16 and 5.1e-6 at chunk 256, where cum reaches -180 (an fp32 ulp
# there is 1.5e-5, and exp(cum_i - cum_j) carries it as a relative
# error; against the float64 recurrence the port read 4.4e-6 and the
# reference 2.4e-6); bf16 (both round the fp32 result once) read 1.2e-8
# on y, and a flip of one rounding would be a bf16 ulp of one element
SSD_LIMIT = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
_JSSD = jax.jit(JM.ssd_chunked, static_argnums=6)
_JBLOCK = jax.jit(JM.mamba_block, static_argnums=(2, 3),
                  static_argnames=("decode_pos",))
# the model against the reference by compute dtype: (logits atol, SSM
# state atol, conv cache atol), over 4 layers with logits up to 15. fp32
# read 1.3e-5, 2.3e-6 and 3.0e-6; bf16 read 0.36, 0.043 and 0.047 (6
# bf16 ulps of the largest logits): the port rounds every bf16 step of
# the reference's program (the conv's products and sums, sigmoid before
# silu's product), where XLA's fusions in the compiled reference keep
# fp32 across them, and one bf16 ulp of x or dt moves the fp32 state
LIMITS = {"float32": (5e-5, 1e-5, 1e-5), "bfloat16": (0.75, 0.125, 0.125)}


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jeng.clear_cache()
    engine.clear_cache()


@functools.cache
def _jref(jcfg):
    """The reference model's prefill, decode step and loss gradient,
    each under `jax.jit` (compiled once a shape: op by op, JAX compiles
    every primitive of the eager calls)."""
    jm = JModel(jcfg)
    return (jax.jit(jm.prefill, static_argnums=2), jax.jit(jm.decode_step),
            jax.jit(jax.value_and_grad(jm.loss, has_aux=True)))


def _configs(cd: str = "float32", **kw):
    return (smoke_config(ARCH).replace(compute_dtype=cd, **kw),
            jsmoke(ARCH).replace(compute_dtype=cd, **kw))


SCALES = {"embed": 0.4, "w_in": 0.1, "w_out": 0.1, "conv_w": 0.3,
          "conv_b": 0.1, "a_log": 0.3, "dt_bias": 0.3}


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
            a = SCALES[keys[-1]] * rng.standard_normal(pdef.shape)
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
    """Every cache leaf: the SSM states and conv caches, per layer."""
    _, lim_ssm, lim_conv = LIMITS[cd]
    for j in got["blocks"]:
        (ts, tc), (js, jc) = got["blocks"][j], want["blocks"][j]
        assert ts.dtype == torch.float32 and tc.dtype == getattr(torch, cd)
        assert tuple(ts.shape) == js.shape and tuple(tc.shape) == jc.shape
        np.testing.assert_allclose(_f32(ts), _f32(js), rtol=0, atol=lim_ssm)
        np.testing.assert_allclose(_f32(tc), _f32(jc), rtol=0,
                                   atol=lim_conv)


# ------------------------------------------------- config, counts, init


def test_config_equals_reference():
    """Exact: the port's mamba2-780m is the reference's, field for field
    (its MambaConfig too), and so is its smoke reduction; one mamba
    sub-layer with no FFN a period, 48 periods."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == \
        dataclasses.asdict(jsmoke(ARCH))
    layout, n = period_layout(get_config(ARCH))
    assert n == 48 and [(sl.mixer, sl.ffn) for sl in layout] == \
        [("mamba", "none")]
    assert TM.mamba_dims(get_config(ARCH)) == (3072, 48, 3328)


def test_count_params_equal_reference():
    """Exact, at full size without allocating: 780,148,992 parameters
    (all active), and `non_embedding_params` the reference's; w_in is
    [48, 1536, 6448] (z, x, B, C, dt)."""
    cfg, jcfg = get_config(ARCH), jget_config(ARCH)
    assert count_params(cfg) == jcount(jcfg) == (780_148_992, 780_148_992)
    assert non_embedding_params(cfg) == jnon_embedding(jcfg)
    sizes = dict(schema_leaves(Model(cfg).schema()))
    assert sizes["['blocks']['sub0']['mixer']['w_in']"].shape == \
        (48, 1536, 6448)
    assert "['blocks']['sub0']['ffn']" not in "".join(sizes)


def test_init_bitwise_and_schema_paths():
    """Bitwise: `Model.init(key)` at smoke size draws the reference's
    parameters, leaf for leaf by path (zeros for a_log, dt_bias and the
    conv's bias, ones for D and the norms)."""
    cfg, jcfg = _configs()
    got = Model(cfg).init(prng.PRNGKey(3), device="cpu")
    want = JModel(jcfg).init(jax.random.PRNGKey(3))
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    flat = pytree.flatten_with_path(got)[0]
    assert [pytree.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    assert set(got["blocks"]["sub0"]) == {"pre_norm", "mixer"}
    for (_, a), (_, b) in zip(flat, jflat):
        assert np.array_equal(a.numpy(), np.asarray(b))


# -------------------------------------------------- the block's pieces


def test_split_proj_bitwise():
    """Bitwise (slices): z, x, B, C, dt of a [2, 5, 2 d_inner + 2 G N + H]
    projection, in fp32 and bf16."""
    cfg, jcfg = _configs()
    d_inner, h, conv_dim = TM.mamba_dims(cfg)
    width = d_inner + conv_dim + h
    a = np.random.default_rng(0).standard_normal((2, 5, width)).astype(
        np.float32)
    for dt in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(a).to(dt)
        ja = jnp.asarray(_f32(t)).astype(jnp.bfloat16 if dt == torch.bfloat16
                                         else jnp.float32)
        for x, y in zip(TM._split_proj(t, cfg), JM._split_proj(ja, jcfg)):
            assert tuple(x.shape) == y.shape
            assert np.array_equal(_f32(x), _f32(y))


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("s", [1, 7])
def test_conv1d_matches_reference(cached, s, monkeypatch):
    """fp32, with and without a cache: the new cache bitwise; the conv's
    sum of shifted products plus the bias bitwise (silu set to the
    identity in both packages); with silu, within 2 x 2^-23 of each
    element's magnitude (XLA's exp; read 0.92). bf16: the sum bitwise,
    the output within 4 x 2^-7 (read 1.59: the port rounds sigmoid to
    bf16 before the product, as the reference's program says; XLA's
    fusion keeps it in fp32)."""
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, 24)).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 24))).astype(np.float32)
    b = (0.1 * rng.standard_normal(24)).astype(np.float32)
    cache = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if cached else None

    def run(dtype, jdtype):
        t = [torch.from_numpy(a).to(dtype) if a is not None else None
             for a in (x, w, b, cache)]
        j = [jnp.asarray(a).astype(jdtype) if a is not None else None
             for a in (x, w, b, cache)]
        return TM._conv1d(*t), JM._conv1d(*j)

    for dtype, jdtype, ulps in ((torch.float32, jnp.float32, 2),
                                (torch.bfloat16, jnp.bfloat16, 4)):
        (out, new), (jout, jnew) = run(dtype, jdtype)
        assert np.array_equal(_f32(new), _f32(jnew))
        assert new.shape == (2, 3, 24)
        eps = 2.0 ** -23 if dtype == torch.float32 else 2.0 ** -7
        np.testing.assert_allclose(_f32(out), _f32(jout), rtol=ulps * eps,
                                   atol=1e-30)
        with monkeypatch.context() as mp:
            mp.setattr(TM, "_silu", lambda v: v)
            mp.setattr(jax.nn, "silu", lambda v: v)
            (out, _), (jout, _) = run(dtype, jdtype)
        assert np.array_equal(_f32(out), _f32(jout))


def _ssd_inputs(seed, b, s, h, p, g, n, dt_range=(0.05, 1.0)):
    rng = np.random.default_rng(seed)
    lo, hi = dt_range
    return dict(
        xh=rng.standard_normal((b, s, h, p)).astype(np.float32),
        dt=(lo + (hi - lo) * rng.random((b, s, h))).astype(np.float32),
        a_log=(0.3 * rng.standard_normal(h)).astype(np.float32),
        bmat=rng.standard_normal((b, s, g, n)).astype(np.float32),
        cmat=rng.standard_normal((b, s, g, n)).astype(np.float32),
        d_skip=(1 + 0.1 * rng.standard_normal(h)).astype(np.float32),
        state=rng.standard_normal((b, h, p, n)).astype(np.float32))


def _ssd_both(inp, cs, dtype, init):
    """(port, reference) ssd_chunked on the same inputs; x, B and C in
    `dtype` (the block's compute dtype), dt, A, D and the state fp32."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    low = ("xh", "bmat", "cmat")
    t = {k: torch.from_numpy(v).to(td) if k in low else torch.from_numpy(v)
         for k, v in inp.items()}
    j = {k: jnp.asarray(v).astype(jd) if k in low else jnp.asarray(v)
         for k, v in inp.items()}
    args = ("xh", "dt", "a_log", "bmat", "cmat", "d_skip")
    got = TM.ssd_chunked(*(t[k] for k in args), MambaConfig(chunk_size=cs),
                         init_state=t["state"] if init else None)
    want = _JSSD(*(j[k] for k in args), JMambaConfig(chunk_size=cs),
                 init_state=j["state"] if init else None)
    return got, want


@pytest.mark.parametrize("dtype,s,init,g", [
    ("float32", 16, False, 1), ("float32", 48, True, 1),
    ("float32", 8, False, 1), ("float32", 48, False, 2),
    ("float32", 8, True, 2), ("bfloat16", 16, True, 1),
    ("bfloat16", 48, False, 1), ("bfloat16", 8, True, 1),
    ("bfloat16", 48, True, 2)])
def test_ssd_chunked_matches_reference(dtype, s, init, g):
    """y and the final state within SSD_LIMIT[dtype] of their largest
    magnitudes, at chunk 16: s = 16 (one chunk), 48 (three), 8 (below
    the chunk: one chunk of 8), with and without an initial state, one
    group and two (heads sharing their group's B and C)."""
    inp = _ssd_inputs(s + 10 * g, 2, s, 8, 16, g, 16)
    (y, hs), (jy, jhs) = _ssd_both(inp, 16, dtype, init)
    assert y.dtype == getattr(torch, dtype) and hs.dtype == torch.float32
    assert tuple(y.shape) == jy.shape and tuple(hs.shape) == jhs.shape
    lim = SSD_LIMIT[dtype]
    assert _rel(jy, y) <= lim
    # the final state stays fp32 (bf16 read 1.8e-7)
    assert _rel(jhs, hs) <= (lim if dtype == "float32" else 1e-6)


def _recurrence64(xh, dt, a_log, bmat, cmat, d_skip):
    """The SSM token by token in float64: h_t = exp(dt_t A) h_{t-1} +
    dt_t x_t (x) B_t, y_t = C_t . h_t + D x_t."""
    b, s, h, p = xh.shape
    rep = h // bmat.shape[2]
    a = -torch.exp(a_log)
    hs = torch.zeros((b, h, p, bmat.shape[3]), dtype=torch.float64)
    ys = []
    for t in range(s):
        bh = bmat[:, t].repeat_interleave(rep, dim=1)          # [B,H,N]
        ch = cmat[:, t].repeat_interleave(rep, dim=1)
        hs = torch.exp(dt[:, t] * a)[..., None, None] * hs \
            + (dt[:, t, :, None] * xh[:, t])[..., None] * bh[:, :, None]
        ys.append((hs * ch[:, :, None]).sum(-1)
                  + d_skip[:, None] * xh[:, t])
    return torch.stack(ys, 1)


def test_hazard_nan_gradient_at_chunk_256():
    """The reference's intra-chunk decay where(mask, exp(li), 0) at chunk
    256 with dt near 0.7 (A = -1 at a_log 0, the reference's init): li
    above the diagonal passes 88, exp overflows, and `jax.grad` is NaN
    (0 x inf). The port's gradient (every input) is finite and within
    5e-5 of each input's largest gradient magnitude of the float64
    autograd of the token-by-token recurrence (read 1.2e-5, A's log,
    which sums over every token; 5.5e-6 the rest); its forward
    within SSD_LIMIT of the reference's."""
    inp = _ssd_inputs(7, 1, 256, 2, 4, 1, 4, dt_range=(0.65, 0.75))
    inp["a_log"][:] = 0.0
    w = np.random.default_rng(8).standard_normal((1, 256, 2, 4)).astype(
        np.float32)
    args = ("xh", "dt", "a_log", "bmat", "cmat", "d_skip")
    jin = [jnp.asarray(inp[k]) for k in args]
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(JM.ssd_chunked(
        *a, JMambaConfig(chunk_size=256))[0] * w), argnums=range(6)))(*jin)
    assert np.isnan(np.asarray(jgrads[1])).all()           # every dt
    tin = [torch.from_numpy(inp[k]).requires_grad_() for k in args]
    y, _ = TM.ssd_chunked(*tin, MambaConfig(chunk_size=256))
    (y * torch.from_numpy(w)).sum().backward()
    want_in = [torch.from_numpy(inp[k]).double().requires_grad_()
               for k in args]
    (_recurrence64(*want_in) * torch.from_numpy(w).double()).sum() \
        .backward()
    for name, t, r in zip(args, tin, want_in):
        assert torch.isfinite(t.grad).all(), name
        assert _rel(r.grad, t.grad) <= 5e-5, name
    (got, _), (want, _) = _ssd_both(inp, 256, "float32", False)
    assert _rel(want, got) <= SSD_LIMIT["float32"]


# -------------------------------------------------------- mamba_block


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_mamba_block_prefill_and_decode(cd):
    """`mamba_block` on one layer's weights: a 32-token prefill (two
    chunks), then one recurrent step from its caches; outputs, SSM
    states and conv caches within LIMITS[cd] (the logits limit for the
    block's output; fp32 read 1.7e-6, 4.8e-7 and 1.2e-6, bf16 0.031,
    0.018 and 4.9e-4)."""
    cfg, jcfg = _configs(cd)
    pn = _np_params(cfg, 11)["blocks"]["sub0"]["mixer"]
    layer = {k: v[0] for k, v in pn.items()}
    jp, tp = _both(layer)
    x = np.random.default_rng(12).standard_normal((2, 33, 64)).astype(
        np.float32)
    jcd = jnp.dtype(cd)
    tcd = getattr(torch, cd)
    lim_out, lim_ssm, lim_conv = LIMITS[cd]
    jy, (jh, jc) = _JBLOCK(jp, jnp.asarray(x[:, :32]), jcfg, jcd)
    ty, (th, tc) = TM.mamba_block(tp, torch.from_numpy(x[:, :32]), cfg, tcd)
    assert ty.dtype == tcd and tc.dtype == tcd and th.dtype == torch.float32
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=0, atol=lim_out)
    np.testing.assert_allclose(_f32(th), _f32(jh), rtol=0, atol=lim_ssm)
    np.testing.assert_allclose(_f32(tc), _f32(jc), rtol=0, atol=lim_conv)
    jy, (jh, jc) = _JBLOCK(jp, jnp.asarray(x[:, 32:]), jcfg, jcd,
                           ssm_state=jh, conv_cache=jc, decode_pos=32)
    ty, (th, tc) = TM.mamba_block(tp, torch.from_numpy(x[:, 32:]), cfg, tcd,
                                  ssm_state=th, conv_cache=tc,
                                  decode_pos=32)
    np.testing.assert_allclose(_f32(ty), _f32(jy), rtol=0, atol=lim_out)
    np.testing.assert_allclose(_f32(th), _f32(jh), rtol=0, atol=lim_ssm)
    np.testing.assert_allclose(_f32(tc), _f32(jc), rtol=0, atol=lim_conv)


# --------------------------------------------------- prefill and decode


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,max_len", [(48, 52), (8, None)])
def test_prefill_matches_reference(cd, s, max_len):
    """Last logits and every cache leaf (each layer's SSM state and conv
    cache) within LIMITS[cd]: a 48-token prompt (three chunks of 16) and
    an 8-token one (below the chunk)."""
    cfg, jcfg = _configs(cd)
    toks = _tokens(jcfg, s, 3)
    jp, tp = _both(_np_params(cfg, 3))
    jl, jc = _jref(jcfg)[0](jp, {"tokens": jnp.asarray(toks)}, max_len)
    tl, tc = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                max_len=max_len)
    assert tl.dtype == torch.float32 and tl.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LIMITS[cd][0])
    _close_caches(tc, jc, cd)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_decode_matches_reference(cd):
    """A prompt of 16, then 9 decode steps, each fed the reference's next
    token: every step's logits within LIMITS[cd], the caches written in
    place (the same tensors come back), and every cache leaf after the
    last step within its limit."""
    cfg, jcfg = _configs(cd)
    toks = _tokens(jcfg, 25, 2)
    jp, tp = _both(_np_params(cfg, 4))
    (jprefill, jdecode, _), tm = _jref(jcfg), Model(cfg)
    _, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :16])}, None)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])})
    for pos in range(16, 25):
        tok = toks[:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok),
                         jnp.asarray(pos, jnp.int32))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        assert tc2 is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LIMITS[cd][0])
    _close_caches(tc, jc, cd)


def _jax_greedy_logits(jcfg, jp, toks, steps):
    """The reference's greedy loop (`repro.train.serve.greedy_decode`),
    keeping each step's logits."""
    jprefill, jdecode, _ = _jref(jcfg)
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


def _same_greedy(got, every, want, cd, steps):
    """fp32: tokens equal at every step. bf16: per row, equal up to the
    first step whose reference top-2 margin is within the logits
    limit. Returns how many tokens were compared."""
    lim = LIMITS[cd][0]
    compared = 0
    for r in range(want.shape[0]):
        for i in range(steps):
            top2 = np.sort(every[i][r])[-2:]
            if cd != "float32" and top2[1] - top2[0] <= lim:
                break
            assert int(got[r, i]) == want[r, i], (r, i)
            compared += 1
    return compared


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_greedy_decode_matches_reference(cd):
    """`greedy_decode` of 8 tokens past a 16-token prompt: fp32 tokens
    equal to the reference's greedy loop, every step's logits within
    LIMITS; bf16 tokens equal up to each row's first near tie."""
    cfg, jcfg = _configs(cd)
    jp, tp = _both(_np_params(cfg, 5))
    toks = _tokens(jcfg, 16, 3)
    steps = 8
    got, logits = greedy_decode(Model(cfg), tp,
                                {"tokens": torch.from_numpy(toks)}, steps,
                                return_logits=True)
    want, every = _jax_greedy_logits(jcfg, jp, toks, steps)
    assert got.dtype == torch.int32 and got.shape == (3, steps)
    if cd == "float32":
        assert np.array_equal(got.numpy(), want)
        for got_l, want_l in zip(logits, every):
            np.testing.assert_allclose(got_l.numpy(), want_l, rtol=0,
                                       atol=LIMITS[cd][0])
    assert _same_greedy(got, every, want, cd, steps) >= 3


def test_decode_parity_with_full_forward():
    """Within 2e-5, fp32 (read 5.7e-6): prefill(32) + 16 decode steps
    give the last logits of prefill(48) (chunked against recurrent: the
    state-space duality), the final SSM states within 2e-6 (read 7.2e-7)
    and conv caches within 4e-6 (read 1.3e-6; the first layer's bitwise:
    its inputs are the embeddings)."""
    cfg, jcfg = _configs()
    _, tp = _both(_np_params(cfg, 9))
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(jcfg, 48, 2))
    full, fc = model.prefill(tp, {"tokens": toks})
    _, caches = model.prefill(tp, {"tokens": toks[:, :32]})
    for pos in range(32, 48):
        inc, _ = model.decode_step(tp, caches, toks[:, pos:pos + 1], pos)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=0, atol=2e-5)
    np.testing.assert_allclose(caches["blocks"]["sub0"][0].numpy(),
                               fc["blocks"]["sub0"][0].numpy(), rtol=0,
                               atol=2e-6)
    np.testing.assert_allclose(caches["blocks"]["sub0"][1].numpy(),
                               fc["blocks"]["sub0"][1].numpy(), rtol=0,
                               atol=4e-6)
    assert torch.equal(caches["blocks"]["sub0"][1][0],
                       fc["blocks"]["sub0"][1][0])


def test_value_errors():
    """A prompt that is not a multiple of the chunk (past one chunk)
    raises `ValueError` naming the chunk size, where the reference
    asserts; a decode step of 2 tokens on the SSM cache raises, where
    the reference's reshape fails."""
    cfg, jcfg = _configs()
    _, tp = _both(_np_params(cfg, 1))
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(jcfg, 24, 2))
    with pytest.raises(ValueError, match="chunk_size 16"):
        model.prefill(tp, {"tokens": toks})
    with pytest.raises(AssertionError):
        JModel(jcfg).prefill(jax.tree_util.tree_map(
            lambda t: jnp.asarray(t.numpy()), tp),
            {"tokens": jnp.asarray(toks.numpy())})
    _, caches = model.prefill(tp, {"tokens": toks[:, :16]})
    with pytest.raises(ValueError, match="SSM cache"):
        model.decode_step(tp, caches, toks[:, 16:18], 16)
    with pytest.raises(ValueError, match="one token"):
        TM.mamba_block({k: v[0] for k, v in
                        tp["blocks"]["sub0"]["mixer"].items()},
                       torch.zeros(2, 2, 64), cfg, torch.float32,
                       ssm_state=caches["blocks"]["sub0"][0][0],
                       conv_cache=caches["blocks"]["sub0"][1][0],
                       decode_pos=16)


# ------------------------------------------------------- loss, training


@pytest.mark.parametrize("cd,remat", [("float32", "none"),
                                      ("float32", "full"),
                                      ("bfloat16", "none")])
def test_loss_and_grads_match_reference(cd, remat):
    """`Model.loss` and every leaf's gradient against
    `jax.value_and_grad(model.loss)` over 2 layers, 32 tokens (two
    chunks): fp32 loss within 1e-6 relative (read 2.7e-7), gradients
    within 2e-5 of each leaf's largest magnitude (read 2.3e-6); bf16
    within 5e-4 (read 1.1e-4) and 0.1 (read 3.2e-2)."""
    cfg, jcfg = _configs(cd, remat=remat, n_layers=2)
    pn = _np_params(cfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        convert.from_numpy_tree(pn, "cpu"))
    toks = np.random.default_rng(7).integers(0, 503, (2, 32)).astype(
        np.int32)
    # the reference without remat (jax.checkpoint changes no value)
    (jl, jmets), jg = _jref(jcfg.replace(remat="none"))[2](
        jp, {"tokens": jnp.asarray(toks)})
    loss, mets = Model(cfg).loss(p, {"tokens": toks})
    loss.backward()
    lt, gt = (1e-6, 2e-5) if cd == "float32" else (5e-4, 0.1)
    assert abs(float(loss.detach()) - float(jl)) <= lt * abs(float(jl))
    assert float(mets["aux"]) == float(jmets["aux"]) == 0.0
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    flat, _ = pytree.flatten_with_path(p)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [pytree.keystr(k) for k, _ in flat]
    for (path, a), (_, t) in zip(jflat, flat):
        assert torch.isfinite(t.grad).all()
        assert _rel(a, t.grad) <= gt, jax.tree_util.keystr(path)


@pytest.mark.parametrize("accum", [2])
def test_train_step_matches_reference(accum):
    """One `make_train_step` (fp32 compute and moments, remat, grad_accum
    2) through the per-layer gradient views against
    `jax.jit(make_train_step)`: loss and grad norm within 1e-4 relative
    (read 1.7e-7), parameters and moments within 2e-4 of each leaf's
    largest magnitude (read 2.6e-6)."""
    cfg, jcfg = _configs(remat="full", n_layers=2)
    pn = _np_params(cfg, 6)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    jopt = jinit_opt(jp, jcfg.opt_state_dtype)
    jstate = {"params": jp, "m": jopt["m"], "v": jopt["v"],
              "step": jnp.zeros((), jnp.int32)}
    state = init_train_state(Model(cfg), params=convert.from_numpy_tree(
        pn, "cpu"), device="cpu")
    toks = np.random.default_rng(8).integers(0, 503, (4, 32)).astype(
        np.int32)
    jstate, jmets = jax.jit(jmake_step(JModel(jcfg), total_steps=10,
                                       grad_accum=accum))(
        jstate, {"tokens": jnp.asarray(toks)})
    state, mets = make_train_step(Model(cfg), total_steps=10,
                                  grad_accum=accum)(state, {"tokens": toks})
    for key in ("loss", "grad_norm"):
        assert abs(float(mets[key]) - float(jmets[key])) <= \
            1e-4 * abs(float(jmets[key])), key
    for part in ("params", "m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[part]),
                        pytree.leaves(state[part])):
            assert _rel(a, b) <= 2e-4


def test_btm_round_through_replica():
    """One Branch-Train-Merge round (2 branches, weight_average, a merge
    every 2 steps, 16-token sequences) on the Mamba smoke model in both
    packages from the reference's init: each branch's losses within
    2e-4 relative of the reference's (bf16 compute; read 3.4e-5), both
    branches byte-identical after the merge, and that model bitwise the
    port's `Replica` resolving weight_average over the two branches'
    contributions."""
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


# ------------------------------------------------------------------ CLIs


def test_serve_train_and_merge_clis(tmp_path, capsys):
    """`--arch mamba2-780m --smoke --device cpu` through the three CLIs,
    in-process: serve prints its tokens; train writes a checkpoint and
    resumes from it; merge (TIES with a base) writes a checkpoint whose
    parameters are bitwise an in-process `Replica` resolve over the same
    checkpoints, and zero moments."""
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
    assert all(int(t.abs().max()) == 0 for t in
               pytree.leaves(got["m"]) + pytree.leaves(got["v"]))
