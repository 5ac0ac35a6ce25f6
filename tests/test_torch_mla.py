"""DeepSeek-V2's multi-head latent attention (MLA) on the port against the
JAX reference, on the CPU: the config and `count_params` at full size
and at the chip smoke's cuts, `Model.init`, `mla_latent`,
`mla_attention` (the non-absorbed, query-chunked prefill path) and
`mla_decode` (the absorbed path), with and without the query's
`q_lora_rank` bottleneck; the model's prefill with every latent cache
leaf (layer 0's `first` and the stack's), decode steps, `greedy_decode`,
decode against the full forward, `Model.loss` with its gradients, a
train step, a Branch-Train-Merge round through `Replica`, a merge
through two replicas, the serve CLI; and the `ValueError`s where the
reference asserts (a prompt that the query chunks do not tile) or
cannot go (a decode step of two tokens).

Smoke size: the reference's `smoke_config` (4 layers: the dense layer 0
and 3 MLA + MoE layers; d_model 64, 4 heads, kv_lora 32, nope 16, rope
8, v 16; 4 experts top-2 and one shared expert; 32-query chunks), with
`q_lora_rank` 0 as the reduction leaves it and, as a second config, 24
(`_configs(q_lora=24)`), so that the `w_dq` / `q_norm` path of the full
config runs too. Inputs are made from a seed with numpy and handed to
both packages. The weights are drawn so that the attention is not
uniform: the query, latent and key projections at 0.2, the value
projection at 0.1, the router at 1.0, the head at 0.3, the embedding at
0.4, norms near 1, the rest at 0.02. Each assertion says whether it is
bitwise or within a tolerance; every tolerance is at least twice the
largest reading on an x86 CPU.
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
from repro.models import mla as JMLA  # noqa: E402
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
from repro_torch.models import mla as TMLA  # noqa: E402
from repro_torch.models.model import Model, period_layout  # noqa: E402
from repro_torch.models.params import (  # noqa: E402
    count_params, non_embedding_params)
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train.btm import BranchTrainMerge  # noqa: E402
from repro_torch.train.serve import greedy_decode  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    init_train_state, make_train_step)

torch.set_num_threads(1)

ARCH = "deepseek-v2-236b"
# the model against the reference by compute dtype: (logits atol, latent
# cache atol), logits up to 8.5, latents up to 6.6. fp32 read 2.9e-6 and
# 2.4e-6; bf16 read 0.0625 and 0.03125 (one bf16 ulp at the latents'
# magnitude: the port rounds each bf16 step of the reference's program,
# where XLA's fusions keep fp32 across some)
LIMITS = {"float32": (2e-5, 1e-5), "bfloat16": (0.3, 2.0 ** -4)}
# the MLA functions alone against the reference, relative to the output's
# largest magnitude: fp32 read 5.8e-7, bf16 1.02e-3
FN_LIMITS = {"float32": 2e-6, "bfloat16": 4e-3}
SCALES = {"embed": 0.4, "lm_head": 0.3, "router": 1.0, "w_q": 0.2,
          "w_dq": 0.2, "w_dkv": 0.2, "w_uk": 0.2, "w_uv": 0.1}
DT = {"float32": (torch.float32, jnp.float32),
      "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(autouse=True)
def _restore_reference_state():
    yield
    jeng.clear_cache()
    engine.clear_cache()


@functools.cache
def _jref(jcfg):
    """The reference model's prefill, decode step and loss gradient,
    each under `jax.jit` (compiled once a shape)."""
    jm = JModel(jcfg)
    return (jax.jit(jm.prefill, static_argnums=2), jax.jit(jm.decode_step),
            jax.jit(jax.value_and_grad(jm.loss, has_aux=True)))


def _configs(cd: str = "float32", q_lora: int = 0, **kw):
    out = []
    for c in (smoke_config(ARCH), jsmoke(ARCH)):
        c = c.replace(compute_dtype=cd, **kw)
        out.append(c.replace(mla=dataclasses.replace(c.mla,
                                                     q_lora_rank=q_lora)))
    return tuple(out)


def _np_tree(schema_pairs, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for path, pdef in schema_pairs:
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


def _np_params(cfg, seed):
    """Numpy fp32 weights in the port's layout (module docstring)."""
    return _np_tree(schema_leaves(Model(cfg).schema()), seed)


def _np_mla(cfg, seed):
    """Numpy fp32 weights of one MLA mixer (`mla_def`)."""
    return _np_tree(schema_leaves(TMLA.mla_def(cfg)), seed)


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
    """Every latent cache leaf: layer 0's (c, k_rope) under "first" and
    the stack's under blocks/sub0, shapes, dtypes and values."""
    lim = LIMITS[cd][1]
    assert sorted(got) == sorted(want) == ["blocks", "first"]
    pairs = [(got["first"], want["first"]),
             (got["blocks"]["sub0"], want["blocks"]["sub0"])]
    for (ta, tb), (ja, jb) in pairs:
        for t, a in ((ta, ja), (tb, jb)):
            assert tuple(t.shape) == a.shape and t.dtype == DT[cd][0]
            np.testing.assert_allclose(_f32(t), _f32(a), rtol=0, atol=lim)


# ------------------------------------------- config, layout, counts, init


def test_config_equals_reference():
    """Exact: the port's deepseek-v2-236b is the reference's, field for
    field (its MLAConfig and MoEConfig too), and so is its smoke
    reduction (`q_lora_rank` 0 there, 1536 at full size)."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(jget_config(ARCH))
    assert dataclasses.asdict(smoke_config(ARCH)) == \
        dataclasses.asdict(jsmoke(ARCH))
    assert get_config(ARCH).mla.q_lora_rank == 1536
    assert smoke_config(ARCH).mla.q_lora_rank == 0


@pytest.mark.parametrize("which", ["full", "smoke"])
def test_period_layout_equals_reference(which):
    """Exact: one MLA + MoE sub-layer a period, n_layers - 1 periods
    (layer 0, dense, is `first`, outside the stack)."""
    cfg, jcfg = ((get_config(ARCH), jget_config(ARCH)) if which == "full"
                 else (smoke_config(ARCH), jsmoke(ARCH)))
    layout, n = period_layout(cfg)
    jlayout, jn = jperiod(jcfg)
    assert n == jn == cfg.n_layers - 1
    assert [(s.mixer, s.ffn, s.window) for s in layout] == \
        [(s.mixer, s.ffn, s.window) for s in jlayout] == [("mla", "moe", 0)]


@pytest.mark.parametrize("layers,want", [
    (60, (235_741_434_880, 21_375_800_320)),
    (1, (1_386_562_560, 1_386_562_560)),
    (2, (5_358_679_040, 1_725_363_200)),
    (4, (13_302_912_000, 2_402_964_480)),
    (8, (29_191_377_920, 3_758_167_040))])
def test_count_params_equal_reference(layers, want):
    """Exact, at full width without allocating: `count_params` (total,
    active: routed experts at top_k / E) and `non_embedding_params` the
    reference's, at full depth and at 1, 2, 4 and 8 layers (the chip
    smoke serves 8 and merges 2)."""
    cfg = get_config(ARCH).replace(n_layers=layers)
    jcfg = jget_config(ARCH).replace(n_layers=layers)
    assert count_params(cfg) == jcount(jcfg) == want
    assert non_embedding_params(cfg) == jnon_embedding(jcfg)


@pytest.mark.parametrize("q_lora", [0, 24])
def test_init_bitwise_and_schema_paths(q_lora):
    """Bitwise: `Model.init(key)` at smoke size draws the reference's
    parameters, leaf for leaf by path: `first` (MLA + a dense FFN of
    d_ff) and the stack's MLA + MoE sub-layer (routed and shared
    experts), with `w_dq` / `q_norm` only when `q_lora_rank` > 0."""
    cfg, jcfg = _configs(q_lora=q_lora)
    got = Model(cfg).init(prng.PRNGKey(3), device="cpu")
    want = JModel(jcfg).init(jax.random.PRNGKey(3))
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    flat = pytree.flatten_with_path(got)[0]
    assert [pytree.keystr(p) for p, _ in flat] == \
        [jax.tree_util.keystr(p) for p, _ in jflat]
    assert set(got["first"]) == {"pre_norm", "attn", "ffn_norm", "ffn"}
    assert set(got["first"]["ffn"]) == {"w_gate", "w_up", "w_down"}
    assert {"experts", "shared"} <= set(got["blocks"]["sub0"]["ffn"])
    attn = set(got["blocks"]["sub0"]["attn"])
    assert ({"w_dq", "q_norm"} <= attn) == bool(q_lora)
    for (_, a), (_, b) in zip(flat, jflat):
        assert np.array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------ the MLA functions


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_latent_matches_reference(q_lora, cd):
    """`mla_latent`: the normalized latent and the rope key (rotated as
    one shared head) within FN_LIMITS[cd] of their largest magnitude, at
    positions 5 .. 5 + 19."""
    cfg, jcfg = _configs(cd, q_lora)
    tdt, jdt = DT[cd]
    jp, tp = _both(_np_mla(cfg, 1))
    x = np.random.default_rng(2).standard_normal((2, 19, 64)).astype(
        np.float32)
    jc, jk = JMLA.mla_latent(jp, jnp.asarray(x, jdt), jcfg,
                             5 + jnp.arange(19), jdt)
    tc, tk = TMLA.mla_latent(tp, torch.from_numpy(x).to(tdt), cfg,
                             5 + torch.arange(19), tdt)
    assert tc.dtype == tk.dtype == tdt
    assert tuple(tc.shape) == jc.shape == (2, 19, 32)
    assert tuple(tk.shape) == jk.shape == (2, 19, 8)
    assert _rel(jc, tc) <= FN_LIMITS[cd] and _rel(jk, tk) <= FN_LIMITS[cd]


@pytest.mark.parametrize("s", [20, 64, 99])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_attention_matches_reference(q_lora, cd, s):
    """`mla_attention` with 32-query chunks, within FN_LIMITS[cd] of the
    output's largest magnitude: s = 20 (one chunk), 64 (two of 32) and
    99 (three of 33: the reference's chunk is s // (s // q_chunk)), the
    port skipping the keys past each chunk's last query where the
    reference masks them; with `latent=True` the latent and rope key
    it returns are `mla_latent`'s, bitwise."""
    cfg, jcfg = _configs(cd, q_lora)
    tdt, jdt = DT[cd]
    jp, tp = _both(_np_mla(cfg, 3))
    x = np.random.default_rng(4).standard_normal((2, s, 64)).astype(
        np.float32)
    want = jax.jit(functools.partial(
        JMLA.mla_attention, cfg=jcfg, q_chunk=32, compute_dtype=jdt))(
        jp, jnp.asarray(x))
    got, (c, kr) = TMLA.mla_attention(tp, torch.from_numpy(x), cfg,
                                      q_chunk=32, compute_dtype=tdt,
                                      latent=True)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert _rel(want, got) <= FN_LIMITS[cd]
    c2, kr2 = TMLA.mla_latent(tp, torch.from_numpy(x).to(tdt), cfg,
                              torch.arange(s), tdt)
    assert torch.equal(c, c2) and torch.equal(kr, kr2)


@pytest.mark.parametrize("s,ok", [(65, False), (4064, False), (4096, True),
                                  (96, True)])
def test_prompt_the_chunks_do_not_tile_raises(s, ok):
    """Exact: the reference asserts s % nq == 0 with nq = s // q_chunk
    (`mla.py:83-84`); the port's `q_chunks` raises `ValueError` naming
    the chunk at the same lengths: 65 at the smoke's 32 (2 chunks), 4064
    at DeepSeek-V2's 512 (7 chunks); 4096 (8 of 512) and 96 (3 of 32)
    tile. At smoke size the reference's `mla_attention` raises
    `AssertionError` and the port's `mla_attention` and `Model.prefill`
    raise `ValueError` for 65 tokens."""
    q_chunk = 512 if s >= 4064 else 32
    if ok:
        assert TMLA.q_chunks(s, q_chunk) == (s // q_chunk, q_chunk)
        return
    with pytest.raises(ValueError, match=f"chunks of {q_chunk}"):
        TMLA.q_chunks(s, q_chunk)
    if s != 65:
        return
    cfg, jcfg = _configs()
    jp, tp = _both(_np_mla(cfg, 3))
    x = np.zeros((1, s, 64), np.float32)
    with pytest.raises(AssertionError):
        JMLA.mla_attention(jp, jnp.asarray(x), jcfg, q_chunk=32,
                           compute_dtype=jnp.float32)
    with pytest.raises(ValueError, match="chunks of 32"):
        TMLA.mla_attention(tp, torch.from_numpy(x), cfg, q_chunk=32,
                           compute_dtype=torch.float32)
    _, tpm = _both(_np_params(cfg, 3))
    with pytest.raises(ValueError, match="chunks of 32"):
        Model(cfg).prefill(tpm, {"tokens": torch.zeros((1, s),
                                                       dtype=torch.int32)})


@pytest.mark.parametrize("pos", [0, 9, 15])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [0, 24])
def test_mla_decode_matches_reference(q_lora, cd, pos):
    """`mla_decode` (absorbed) at positions 0, 9 and 15 of a 16-slot
    latent cache filled with seeded values: the output within
    FN_LIMITS[cd] of its largest magnitude, the cache written in place
    at slot `pos` (bitwise the reference's updated slot, every other
    slot unchanged), the port attending over the filled slots where the
    reference masks the rest; a step of two tokens raises."""
    cfg, jcfg = _configs(cd, q_lora)
    tdt, jdt = DT[cd]
    jp, tp = _both(_np_mla(cfg, 5))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 1, 64)).astype(np.float32)
    cc = rng.standard_normal((3, 16, 32)).astype(np.float32)
    ck = rng.standard_normal((3, 16, 8)).astype(np.float32)
    want, jc, jk = jax.jit(functools.partial(
        JMLA.mla_decode, cfg=jcfg, compute_dtype=jdt))(
        jp, jnp.asarray(x), jnp.asarray(cc, jdt), jnp.asarray(ck, jdt),
        jnp.asarray(pos, jnp.int32))
    tc, tk = torch.from_numpy(cc).to(tdt), torch.from_numpy(ck).to(tdt)
    got = TMLA.mla_decode(tp, torch.from_numpy(x), tc, tk, pos, cfg, tdt)
    assert got.dtype == tdt and tuple(got.shape) == want.shape
    assert _rel(want, got) <= FN_LIMITS[cd]
    for t, a, orig in ((tc, jc, cc), (tk, jk, ck)):
        assert _rel(a, t) <= FN_LIMITS[cd]
        keep = [i for i in range(16) if i != pos]
        assert np.array_equal(_f32(t)[:, keep], _f32(
            torch.from_numpy(orig).to(tdt))[:, keep])
    with pytest.raises(ValueError, match="one token at a time"):
        TMLA.mla_decode(tp, torch.zeros((3, 2, 64)), tc, tk, pos, cfg, tdt)


# --------------------------------------------------- prefill and decode


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [0, 24])
def test_prefill_matches_reference(q_lora, cd):
    """Last logits and every latent cache leaf within LIMITS[cd]: a
    64-token prompt (two query chunks of 32) into a 70-slot cache, the
    slots past the prompt zero in both."""
    cfg, jcfg = _configs(cd, q_lora)
    toks = _tokens(jcfg, 64, 3)
    jp, tp = _both(_np_params(cfg, 3))
    jl, jc = _jref(jcfg)[0](jp, {"tokens": jnp.asarray(toks)}, 70)
    tl, tc = Model(cfg).prefill(tp, {"tokens": torch.from_numpy(toks)},
                                max_len=70)
    assert tl.dtype == torch.float32 and tl.shape == (3, cfg.vocab_size)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=LIMITS[cd][0])
    _close_caches(tc, jc, cd)
    assert float(tc["first"][0][:, 64:].abs().max()) == 0


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("q_lora", [0, 24])
def test_decode_matches_reference(q_lora, cd):
    """A prompt of 16, then 9 decode steps, each fed the reference's next
    token: every step's logits within LIMITS[cd], the caches written in
    place (the same tensors come back), every cache leaf after the last
    step within its limit; a step of 2 tokens raises ValueError, and so
    does a step past the 32-slot cache."""
    cfg, jcfg = _configs(cd, q_lora)
    toks = _tokens(jcfg, 25, 2)
    jp, tp = _both(_np_params(cfg, 4))
    (jprefill, jdecode, _), tm = _jref(jcfg), Model(cfg)
    _, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :16])}, 32)
    _, tc = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :16])},
                       max_len=32)
    first = tc["first"][0]
    for pos in range(16, 25):
        tok = toks[:, pos:pos + 1]
        jl, jc = jdecode(jp, jc, jnp.asarray(tok),
                         jnp.asarray(pos, jnp.int32))
        tl, tc2 = tm.decode_step(tp, tc, torch.from_numpy(tok), pos)
        assert tc2 is tc and tc["first"][0] is first
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=LIMITS[cd][0])
    _close_caches(tc, jc, cd)
    with pytest.raises(ValueError, match="MLA latent cache"):
        tm.decode_step(tp, tc, torch.from_numpy(toks[:, :2]), 25)
    with pytest.raises(ValueError, match="32-slot"):
        tm.decode_step(tp, tc, torch.from_numpy(toks[:, :1]), 32)


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


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_greedy_decode_matches_reference(cd):
    """`greedy_decode` of 8 tokens past a 32-token prompt, `q_lora_rank`
    24: fp32 tokens equal to the reference's greedy loop and every
    step's logits within LIMITS; bf16 tokens equal at every step up to
    each row's first whose reference top-2 margin is within the logits
    limit (at least 3 compared)."""
    cfg, jcfg = _configs(cd, 24)
    jp, tp = _both(_np_params(cfg, 5))
    toks = _tokens(jcfg, 32, 3)
    steps = 8
    got, logits = greedy_decode(Model(cfg), tp,
                                {"tokens": torch.from_numpy(toks)}, steps,
                                return_logits=True)
    want, every = _jax_greedy_logits(jcfg, jp, toks, steps)
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
    """Within 2e-5, fp32, `q_lora_rank` 24 (no drops: capacity factor
    8): prefill(32) + 16 absorbed decode steps give the last logits of a
    48-token prefill (the non-absorbed path), and the latent caches of
    both layers within 1e-6 of the prefill's."""
    cfg, jcfg = _configs(q_lora=24)
    _, tp = _both(_np_params(cfg, 9))
    model = Model(cfg)
    toks = torch.from_numpy(_tokens(jcfg, 48, 2))
    full, fc = model.prefill(tp, {"tokens": toks})
    _, caches = model.prefill(tp, {"tokens": toks[:, :32]}, max_len=48)
    for pos in range(32, 48):
        inc, _ = model.decode_step(tp, caches, toks[:, pos:pos + 1], pos)
    np.testing.assert_allclose(inc.numpy(), full.numpy(), rtol=0, atol=2e-5)
    for got, want in ((caches["first"], fc["first"]),
                      (caches["blocks"]["sub0"], fc["blocks"]["sub0"])):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=1e-6)


# ------------------------------------------------------- loss, training


@pytest.mark.parametrize("remat,q_lora", [("none", 0), ("full", 0),
                                          ("none", 24)])
def test_loss_and_grads_match_reference(remat, q_lora):
    """`Model.loss` (ce, aux summed over the three MoE layers, the total
    ce + 0.001 aux) and every leaf's gradient (`first` included)
    against `jax.value_and_grad(model.loss)`, 64 tokens (two query
    chunks), fp32: ce and total within 1e-6 relative, aux within 1e-6,
    gradients within 2e-5 of each leaf's largest magnitude."""
    cfg, jcfg = _configs(q_lora=q_lora, remat=remat)
    pn = _np_params(cfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        convert.from_numpy_tree(pn, "cpu"))
    toks = np.random.default_rng(7).integers(0, 503, (2, 64)).astype(
        np.int32)
    # the reference without remat (jax.checkpoint changes no value)
    (jl, jmets), jg = _jref(jcfg.replace(remat="none"))[2](
        jp, {"tokens": jnp.asarray(toks)})
    loss, mets = Model(cfg).loss(p, {"tokens": toks})
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-6 * abs(float(jl))
    assert abs(float(mets["ce"].detach()) - float(jmets["ce"])) <= \
        1e-6 * abs(float(jmets["ce"]))
    assert abs(float(mets["aux"].detach()) - float(jmets["aux"])) <= 1e-6
    assert float(jmets["aux"]) > 1.0       # three MoE layers' terms
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    flat, _ = pytree.flatten_with_path(p)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [pytree.keystr(k) for k, _ in flat]
    for (path, a), (_, t) in zip(jflat, flat):
        assert torch.isfinite(t.grad).all()
        assert _rel(a, t.grad) <= 2e-5, jax.tree_util.keystr(path)
    assert float(p["first"]["attn"]["w_uk"].grad.abs().max()) > 0


def test_train_step_matches_reference():
    """One `make_train_step` with the config's bf16 moments, fp32
    parameters and compute, remat, 2 microbatches, `q_lora_rank` 24,
    against `jax.jit(make_train_step)`: loss, aux and grad norm within
    1e-4 relative, parameters within 2e-4 and the bf16 moments within
    2^-6 of each leaf's largest magnitude (two bf16 ulps); `first`'s
    leaves move."""
    cfg, jcfg = _configs(q_lora=24, remat="full")
    assert cfg.opt_state_dtype == "bfloat16"
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
                                       grad_accum=2))(
        jstate, {"tokens": jnp.asarray(toks)})
    state, mets = make_train_step(Model(cfg), total_steps=10,
                                  grad_accum=2)(state, {"tokens": toks})
    for key in ("loss", "aux", "grad_norm"):
        assert abs(float(mets[key]) - float(jmets[key])) <= \
            1e-4 * abs(float(jmets[key])), key
    for part, lim in (("params", 2e-4), ("m", 2.0 ** -6), ("v", 2.0 ** -6)):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[part]),
                        pytree.leaves(state[part])):
            assert str(b.dtype).split(".")[-1] == str(a.dtype)
            assert _rel(a, b) <= lim, part
    moved = state["params"]["first"]["attn"]["w_dkv"].numpy()
    assert not np.array_equal(moved, pn["first"]["attn"]["w_dkv"])


def test_btm_round_through_replica():
    """One Branch-Train-Merge round (2 branches, weight_average, a merge
    every 2 steps, 16-token sequences) on the MLA smoke model in both
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
    assert all("first" in c for c in contributed)
    rep = Replica("btm-check", device="cpu")
    for c in contributed:
        rep.contribute(c)
    merged = rep.resolve(MergeSpec("weight_average"))
    assert all(torch.equal(x, y.to(x.dtype))
               for x, y in zip(a, pytree.leaves(merged)))


@pytest.mark.parametrize("name", ["ties", "weight_average"])
def test_merge_through_replicas_then_serve(name):
    """Two fine-tunes of an MLA base (base + 0.01 x a seeded delta on
    every leaf) on two port replicas in opposite orders and one reference
    replica, the base registered: each port resolve (exact path, fp32)
    bitwise the reference's and the two byte-equal; the kernel route
    (`engine.merge(..., kernels=True)`, the kernels' plain versions on
    the CPU) against the exact route, element by element within 1e-6 +
    1e-5 |exact| (fp32 sums in another order): none beyond for
    weight_average, at most 1e-2 of a leaf for TIES (the two trim at
    thresholds computed in another order); the merged model served by
    `greedy_decode` to the same tokens from either replica."""
    cfg, _ = _configs()
    base = _np_params(cfg, 11)
    rng = np.random.default_rng(12)
    tunes = [pytree.tree_map(
        lambda a: (a + 0.01 * rng.standard_normal(a.shape)).astype(
            np.float32), base) for _ in range(2)]
    jrep = JReplica("ref")
    for t in tunes:
        jrep.contribute(jax.tree_util.tree_map(jnp.asarray, t))
    jref = jrep.register_base(jax.tree_util.tree_map(jnp.asarray, base))
    spec = dict(trim=0.2) if name == "ties" else {}
    want = jrep.resolve(JSpec(name, spec, base_ref=jref))
    tbase = convert.from_numpy_tree(base, "cpu")
    got = []
    for order in ([0, 1], [1, 0]):
        rep = Replica(f"port-{order[0]}", device="cpu")
        for i in order:
            rep.contribute(convert.from_numpy_tree(tunes[i], "cpu"))
        ref = rep.register_base(tbase)
        assert rep.merkle_root() == jrep.merkle_root() and ref == jref
        got.append(rep.resolve(MergeSpec(name, spec, base_ref=ref)))
        if order == [0, 1]:
            kern = engine.merge(
                [rep.state.store[e] for e in canonical_order(rep.state)],
                spec=MergeSpec(name, spec), base=tbase,
                seed=seed_from_root(rep.merkle_root()), kernels=True,
                use_cache=False)
    for a, b, w in zip(pytree.leaves(got[0]), pytree.leaves(got[1]),
                       jax.tree_util.tree_leaves(want)):
        assert np.array_equal(a.numpy(), np.asarray(w))
        assert torch.equal(a, b)
    for k, e in zip(pytree.leaves(kern), pytree.leaves(got[0])):
        beyond = int(((e - k).abs() > 1e-6 + 1e-5 * e.abs()).sum())
        limit = 0 if name == "weight_average" else \
            int(np.ceil(1e-2 * e.numel()))
        assert beyond <= limit
    toks = {"tokens": torch.from_numpy(_tokens(jsmoke(ARCH), 16, 2))}
    ta = greedy_decode(Model(cfg), got[0], toks, 4)
    tb = greedy_decode(Model(cfg), got[1], toks, 4)
    assert torch.equal(ta, tb)


def test_serve_cli(capsys):
    """`--arch deepseek-v2-236b --smoke --device cpu` through the serve
    CLI, in-process (a 16-token prompt, 8 tokens): it prints its tokens;
    the reference's serve usage, on the port."""
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    assert out.startswith("generated (4, 8) tokens in ")
