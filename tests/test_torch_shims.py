"""The reference's three deprecated shims in the port, and the train step
with bf16 parameters (the dry run's `parambf16` variant) on the VLM and
MLA smoke models, against the JAX reference on the CPU.

Shims: `resolve.apply_strategy` (`reference_apply` under its old name),
the string form of `resolve.hierarchical_resolve` and
`trust.gated_resolve`. Each warns `DeprecationWarning` once with the
reference's message, gives the bytes of the MergeSpec path it names in
the port, and the reference shim's bytes on the same seeded numpy
contributions for the linear family (its fp32 folds run in the same
order in both packages; the other strategies are held to a tolerance
against the reference in `tests/test_torch_trust_hier.py`).

Train steps: one `make_train_step` of the smoke VLM (12 patches a row,
gates at 0.5 and -0.7, 2 microbatches) and of the smoke DeepSeek-V2
(`q_lora_rank` 24, 2 microbatches) with `apply_variant(cfg,
"parambf16")`: bf16 parameters, gradients and moments, fp32 or bf16
compute, remat, against `jax.jit(make_train_step)` of the same variant.
The learning rate is 5e-3 from the first step (warmup 1), as the chip
smoke trains bf16 parameters: the config's schedule gives 6e-5 at step 0,
under half a bf16 ulp of nearly every weight, which would leave the
parameters where they were. Each assertion states its tolerance; every
tolerance is at least twice the largest reading on an x86 CPU, but one
(`LIMITS`).
"""
import dataclasses
import functools
import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import trust as jtrust  # noqa: E402
from repro.core.state import CRDTMergeState as JState  # noqa: E402
from repro.data.synthetic import make_batch as jmake_batch  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim.adamw import init_opt_state as jinit_opt  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.api import MergeSpec  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core import engine  # noqa: E402
from repro_torch.core import resolve, trust  # noqa: E402
from repro_torch.core.state import CRDTMergeState  # noqa: E402
from repro_torch.launch.dryrun import apply_variant  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train.step import init_train_state, make_train_step  # noqa: E402,E501

torch.set_num_threads(1)

# the module: `repro.core` exports its `resolve` function under that name
jresolve = importlib.import_module("repro.core.resolve")


@functools.cache
def _japply_variant():
    """The reference's `apply_variant`: `repro.launch.dryrun` sets
    XLA_FLAGS to 512 host devices when imported, so it is imported here
    with the variable put back before any JAX backend starts, and the
    other tests in the process keep one device."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import apply_variant as japply_variant
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return japply_variant

# the linear family: the same fp32 left fold in both packages
BITWISE = ("weight_average", "linear", "task_arithmetic", "negative_merge")
# strategies whose shim is held to the port's own MergeSpec path (bitwise:
# the same code under a warning), one of each kind
OWN_PATH = ("weight_average", "ties", "dare", "slerp", "star")
# the bf16-parameter train steps' learning rate, from the first step
LR = 5e-3


@pytest.fixture(autouse=True)
def _clear_caches():
    yield
    jeng.clear_cache()
    engine.clear_cache()


def _contribs(n, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((8, 8)).astype(np.float32)
            for _ in range(n)]


def _states(cs):
    s, j = CRDTMergeState(), JState()
    for i, c in enumerate(cs):
        s = s.add(torch.from_numpy(c.copy()), node=f"n{i}")
        j = j.add(jnp.asarray(c), node=f"n{i}")
    assert s.visible() == j.visible()
    return s, j


def _bytes(t) -> bytes:
    if isinstance(t, torch.Tensor):
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


def _one_warning(call):
    """(result, message) of `call()`, which must warn DeprecationWarning
    exactly once."""
    with pytest.warns(DeprecationWarning) as rec:
        out = call()
    deps = [w for w in rec if issubclass(w.category, DeprecationWarning)]
    assert len(deps) == 1, [str(w.message) for w in deps]
    return out, str(deps[0].message)


def _trust(ids, t):
    """Evidence against the second and fourth ids (scores 0.4 and 0.5)."""
    return t.report(ids[1], "divergent_root", "n0") \
        .report(ids[3], "statistical_outlier", "n2", 2.0)


# ----------------------------------------------------------- the shims


@pytest.mark.parametrize("reduction", ["fold", "tree"])
@pytest.mark.parametrize("name", BITWISE)
def test_apply_strategy_equals_reference_shim(name, reduction):
    """Bitwise the reference's `apply_strategy` over 5 seeded
    contributions with a base, one warning each with the same message."""
    cs = _contribs(6, seed=11)
    base, cs = cs[0], cs[1:]
    got, msg = _one_warning(lambda: resolve.apply_strategy(
        name, [torch.from_numpy(c) for c in cs],
        base=torch.from_numpy(base), seed=5, reduction=reduction))
    want, jmsg = _one_warning(lambda: jresolve.apply_strategy(
        name, [jnp.asarray(c) for c in cs], base=jnp.asarray(base), seed=5,
        reduction=reduction))
    assert msg == jmsg
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("name", OWN_PATH)
def test_apply_strategy_is_reference_apply(name):
    """Bitwise the port's `reference_apply` with the same arguments."""
    cs = [torch.from_numpy(c) for c in _contribs(4, seed=12)]
    got, _ = _one_warning(lambda: resolve.apply_strategy(
        name, cs[1:], base=cs[0], seed=9))
    want = resolve.reference_apply(name, cs[1:], base=cs[0], seed=9)
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("name", BITWISE)
def test_hierarchical_string_form_equals_reference_shim(name):
    """The string form over two states (their join: 7 contributions) in
    groups of 3: bitwise the reference's string form, one warning each
    with the same message."""
    cs = _contribs(7, seed=13)
    (s0, j0), (s1, j1) = _states(cs[:4]), _states(cs[4:])
    got, msg = _one_warning(lambda: resolve.hierarchical_resolve(
        [s0, s1], name, group_size=3, use_cache=False))
    want, jmsg = _one_warning(lambda: jresolve.hierarchical_resolve(
        [j0, j1], name, group_size=3, use_cache=False))
    assert msg == jmsg
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("name", OWN_PATH)
def test_hierarchical_string_form_is_the_spec_form(name):
    """Over 8 contributions in groups of 3, 3 and 2 (a group of one is
    refused by slerp in both packages): bitwise `resolve_spec` of the
    joined state with a lenient spec of
    the same cfg and `group_size` (a strict spec where the cfg is
    valid: the same bytes)."""
    cs = _contribs(8, seed=14)
    (s0, _), (s1, _) = _states(cs[:4]), _states(cs[4:])
    got, _ = _one_warning(lambda: resolve.hierarchical_resolve(
        [s0, s1], name, group_size=3, reduction="tree", use_cache=False))
    want = resolve.resolve_spec(
        s0.merge(s1), MergeSpec(name, reduction="tree", group_size=3),
        use_cache=False)
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("threshold", [0.3, 0.5, 0.9])
@pytest.mark.parametrize("name", BITWISE)
def test_gated_resolve_equals_reference_shim(name, threshold):
    """Bitwise the reference's `gated_resolve` over 5 contributions, two
    of them reported (the gate drops 0, 1 or 2 by the threshold), with
    `reduction` passed through cfg; one warning each, the same
    message."""
    cs = _contribs(5, seed=15)
    s, j = _states(cs)
    ids = sorted(s.visible())
    t = _trust(ids, trust.TrustState())
    jt = _trust(ids, jtrust.TrustState())
    got, msg = _one_warning(lambda: trust.gated_resolve(
        s, t, name, threshold=threshold, reduction="tree"))
    want, jmsg = _one_warning(lambda: jtrust.gated_resolve(
        j, jt, name, threshold=threshold, reduction="tree"))
    assert msg == jmsg
    assert _bytes(got) == _bytes(want)


@pytest.mark.parametrize("name", OWN_PATH)
def test_gated_resolve_is_the_spec_path(name):
    """Bitwise `resolve_spec(state, MergeSpec(..., trust_threshold=...),
    trust=...)`; a `fetch` hook in cfg is taken out of it and pulls the
    payloads a store without them lacks."""
    cs = _contribs(5, seed=16)
    s, _ = _states(cs)
    ids = sorted(s.visible())
    t = _trust(ids, trust.TrustState())
    want = resolve.resolve_spec(s, MergeSpec(name, trust_threshold=0.5),
                                trust=t, use_cache=False)
    got, _ = _one_warning(lambda: trust.gated_resolve(s, t, name))
    assert _bytes(got) == _bytes(want)
    engine.clear_cache()
    full = dict(s.store)
    bare = s.merge(CRDTMergeState())
    bare.store.clear()
    pulled = []

    def fetch(wanted):
        pulled.extend(wanted)
        return {i: full[i] for i in wanted}

    got, _ = _one_warning(lambda: trust.gated_resolve(bare, t, name,
                                                      fetch=fetch))
    assert _bytes(got) == _bytes(want) and pulled


# ------------------------------------- train steps with bf16 parameters


def _np_params(cfg, seed, scales, fixed=None):
    """Numpy fp32 weights in the port's layout: `fixed` leaves at their
    value, norms near 1, the rest at `scales[name]` (0.02 by default)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, pdef in schema_leaves(Model(cfg).schema()):
        keys = [k.strip("'") for k in path[1:-1].split("][")]
        node = out
        for key in keys[:-1]:
            node = node.setdefault(key, {})
        if fixed and keys[-1] in fixed:
            a = np.full(pdef.shape, fixed[keys[-1]])
        elif pdef.init == "ones":
            a = 1 + 0.1 * rng.standard_normal(pdef.shape)
        else:
            a = scales.get(keys[-1], 0.02) * rng.standard_normal(pdef.shape)
        node[keys[-1]] = a.astype(np.float32)
    return out


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(a, jnp.float32))


def _rel(a, b) -> float:
    """max |a - b| over max |a| (a the reference)."""
    a, b = _f32(a), _f32(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _bf16_step(arch, cd, prepare, fixed, scales, batch):
    """One train step of the smoke `arch` under `parambf16` in both
    packages from the same numpy weights; returns the two (state,
    metrics) pairs and the numpy start."""
    cfg = apply_variant(smoke_config(arch), "parambf16")
    jcfg = _japply_variant()(jsmoke(arch), "parambf16")
    kw = dict(compute_dtype=cd, remat="full", learning_rate=LR,
              warmup_steps=1)
    cfg, jcfg = prepare(cfg.replace(**kw)), prepare(jcfg.replace(**kw))
    assert cfg.param_dtype == jcfg.param_dtype == "bfloat16"
    assert cfg.opt_state_dtype == "bfloat16"
    pn = _np_params(cfg, 6, scales, fixed)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), pn)
    jopt = jinit_opt(jp, jcfg.opt_state_dtype)
    jstate = {"params": jp, "m": jopt["m"], "v": jopt["v"],
              "step": jnp.zeros((), jnp.int32)}
    state = init_train_state(Model(cfg), params=convert.from_numpy_tree(
        pn, "cpu"), device="cpu")
    for a, t in zip(jax.tree_util.tree_leaves(jp),
                    pytree.leaves(state["params"])):
        assert t.dtype == torch.bfloat16
        assert _f32(a).tobytes() == _f32(t).tobytes()
    jstate, jmets = jax.jit(jmake_step(JModel(jcfg), total_steps=10,
                                       grad_accum=2))(
        jstate, {k: jnp.asarray(v) for k, v in batch(jcfg).items()})
    state, mets = make_train_step(Model(cfg), total_steps=10,
                                  grad_accum=2)(
        state, {k: torch.from_numpy(np.asarray(v))
                for k, v in batch(jcfg).items()})
    return (state, mets), (jstate, jmets), pn


def _held(run, limits, moved_share):
    """Loss (and aux) and grad norm within limits["metrics"] relative;
    the bf16 moments within limits["m"] / limits["v"] of each leaf's
    largest magnitude; the bf16 parameters no element beyond
    limits["lrs"] learning rates plus one bf16 ulp (2^-7 of its
    magnitude at most) of the reference's, and at most limits["share"]
    of them beyond one bf16 ulp (Adam's first step is +-lr by the
    gradient's sign, so an element whose gradient is near zero can move
    the other way: 2 lr apart, then rounded); every parameter leaf
    moved, and at least `moved_share` of all parameter elements."""
    (state, mets), (jstate, jmets), pn = run
    for key in ("loss", "aux", "grad_norm"):
        assert abs(float(mets[key]) - float(jmets[key])) <= \
            limits["metrics"] * max(abs(float(jmets[key])), 1e-30), key
    for part in ("params", "m", "v"):
        for a, t in zip(jax.tree_util.tree_leaves(jstate[part]),
                        pytree.leaves(state[part])):
            assert t.dtype == torch.bfloat16 and str(a.dtype) == "bfloat16"
            if part != "params":
                assert _rel(a, t) <= limits[part], part
    beyond = total = moved = 0
    for a, t, start in zip(jax.tree_util.tree_leaves(jstate["params"]),
                           pytree.leaves(state["params"]),
                           pytree.leaves(pn)):
        a, b = _f32(a), _f32(t)
        d = np.abs(a - b)
        assert bool((d <= limits["lrs"] * LR + 2.0 ** -7 * np.abs(a)).all())
        beyond += int((d > 2.0 ** -8 * np.abs(a)).sum())
        n = int((t != torch.from_numpy(start).to(torch.bfloat16)).sum())
        assert n > 0
        moved, total = moved + n, total + t.numel()
    assert beyond <= limits["share"] * total
    assert moved >= moved_share * total


# by compute dtype. fp32 read (VLM, DeepSeek) metrics 4.4e-7 / 1.0e-6;
# parameters 0 / 0 lr apart beyond one ulp, 2.2e-5 / 3.6e-5 of them beyond
# one ulp; m 2.2e-3 / 1.8e-3 and v 8.9e-4 / 8.3e-4 of a leaf's largest
# magnitude. bf16 read 1.7e-4 / 1.2e-4; 2.00 / 2.00 lr (a sign flip: the
# most Adam's first step can part two elements, so 2.5 lr, as the chip
# smoke's TRAIN_PARAM_LRS, rather than twice the reading), 2.0e-2 /
# 8.6e-3; 2.0e-2 / 2.5e-2 and 3.8e-2 / 4.2e-2
LIMITS = {"float32": {"metrics": 1e-5, "lrs": 0.01, "share": 1e-4,
                      "m": 2.0 ** -7, "v": 2.0 ** -8},
          "bfloat16": {"metrics": 1e-3, "lrs": 2.5, "share": 0.1,
                       "m": 2.0 ** -4, "v": 2.0 ** -3}}


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_vlm_train_step_bf16_params(cd):
    """The smoke VLM (2 periods of a self- and a gated cross-attention
    sub-layer) on 4 rows of 32 tokens and 12 patches, gates at 0.5 and
    -0.7: within LIMITS[cd] of the reference; the gates move."""
    run = _bf16_step(
        "llama-3.2-vision-90b", cd, lambda c: c,
        {"gate_attn": 0.5, "gate_ffn": -0.7},
        {"embed": 0.4, "lm_head": 0.3},
        lambda jcfg: jmake_batch(jcfg, JShape("s", 32, 4, "train"), 8))
    _held(run, LIMITS[cd], 0.5)
    cross = run[0][0]["params"]["blocks"]["sub1"]
    assert bool((cross["gate_attn"] != 0.5).all())
    assert bool((cross["gate_ffn"] != torch.tensor(-0.7).to(
        torch.bfloat16)).all())


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_deepseek_train_step_bf16_params(cd):
    """The smoke DeepSeek-V2 (the dense layer 0 and 3 MLA + MoE layers)
    with `q_lora_rank` 24 on 4 rows of 32 tokens, the attention
    projections at 0.2 and the router at 1.0: within LIMITS[cd] of the
    reference, aux included."""
    run = _bf16_step(
        "deepseek-v2-236b", cd,
        lambda c: c.replace(mla=dataclasses.replace(c.mla, q_lora_rank=24)),
        None,
        {"embed": 0.4, "lm_head": 0.3, "router": 1.0, "w_q": 0.2,
         "w_dq": 0.2, "w_dkv": 0.2, "w_uk": 0.2, "w_uv": 0.1},
        lambda jcfg: {"tokens": np.random.default_rng(8).integers(
            0, jcfg.vocab_size, (4, 32)).astype(np.int32)})
    _held(run, LIMITS[cd], 0.5)
