"""The port's training path against the JAX reference, on the CPU:
`Model.init`, `init_train_state` and `train_state_shapes`, the synthetic
data, the schedules and the int8 moment tier, B9's gradient (its plain
version, which CPU tensors run), `Model.loss` and its gradients, and
one and three train steps.

Inputs are made from a seed with numpy and handed to both packages.
Each assertion says whether it is bitwise or within a tolerance. The
tolerances, each at least twice the largest reading on an x86 CPU:
  * B9's plain backward against `jax.grad` of `chunked_attention` in
    fp32: 2e-6 of the gradients' largest magnitude (read 5.8e-7);
  * the loss in fp32 compute: 1e-6 relative (read 7.7e-8); gradients
    2e-5 of each leaf's largest magnitude (read 8.1e-7);
  * in bf16 compute (every config's default) the port's attention keeps
    p . v in fp32 where `chunked_attention` rounds p to bf16 first: the
    loss within 1e-4 relative (read 1.1e-5), gradients within 5e-2 of
    each leaf's largest magnitude (read 1.4e-2);
  * train steps in fp32 compute: loss and grad norm within 1e-4
    relative (read 2.3e-7), parameters and moments within 2e-4 of each
    leaf's largest magnitude after three steps (read 2.2e-5); in bf16
    compute within 1e-3 (read 3.5e-4) and 6e-2 (read 1.9e-2);
  * the int8 moment tier: one step (parameters within 2e-4, read
    2.2e-5; the int8 moments within one quantization step, the rows'
    scales within 1e-4 relative). Past
    step 1 the tier is chaotic in both packages: a row's small v
    entries quantize to 0, so mhat / (0 + eps) moves those parameters
    by lr * 1e8 * mhat; the reference's own loss runs 6.29 -> 12.4 in
    three smoke steps. Three int8 steps are not compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.data.synthetic import SyntheticTask as JTask  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train.step import init_train_state as jinit  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro.train.step import train_state_shapes as jshapes  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.configs import list_archs, smoke_config  # noqa: E402
from repro_torch.data.synthetic import SyntheticTask  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_backward_plain,
    flash_attention_grad_plain, flash_attention_lse)
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    init_train_state, make_train_step, train_state_shapes)

torch.set_num_threads(1)

ARCHS = ("phi3-mini-3.8b", "minicpm-2b", "minitron-8b")


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel(a, b) -> float:
    """max |a - b| over max |a| (a the reference)."""
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _tokens(seed, b=4, s=32, vocab=503):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_configs_registered_as_the_reference():
    """minicpm-2b and minitron-8b, field for field, and their smoke
    configs."""
    from repro.configs import get_config as jget
    from repro_torch.configs import get_config
    assert set(ARCHS) <= set(list_archs())
    for arch in ARCHS:
        assert get_config(arch).__dict__ == jget(arch).__dict__
        assert smoke_config(arch).__dict__ == jsmoke(arch).__dict__


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_train_state_bitwise(arch):
    """Model.init(key) and init_train_state: bit for bit, every leaf."""
    jstate = jinit(JModel(jsmoke(arch)), jax.random.PRNGKey(3))
    state = init_train_state(Model(smoke_config(arch)), prng.PRNGKey(3),
                             device="cpu")
    jflat, jtd = jax.tree_util.tree_flatten_with_path(jstate)
    flat, _ = pytree.flatten_with_path(state)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [pytree.keystr(p) for p, _ in flat]
    for (_, a), (_, b) in zip(jflat, flat):
        a = np.asarray(a)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")
        assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("opt", ["float32", "int8", "bfloat16"])
def test_train_state_shapes_match_reference(opt):
    jcfg = jsmoke("minitron-8b").replace(opt_state_dtype=opt)
    got = train_state_shapes(Model(smoke_config("minitron-8b").replace(
        opt_state_dtype=opt)))
    want = jshapes(JModel(jcfg))
    jflat, _ = jax.tree_util.tree_flatten_with_path(want)
    flat, _ = pytree.flatten_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in jflat] == \
        [pytree.keystr(p) for p, _ in flat]
    for (_, a), (_, b) in zip(jflat, flat):
        assert b.device.type == "meta"
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype) == str(b.dtype).replace("torch.", "")


@pytest.mark.parametrize("task,step,batch,host", [
    (0, 0, 4, (0, 1)), (3, 17, 8, (1, 2)), (1, 10_000, 2, (0, 1))])
def test_synthetic_task_bitwise(task, step, batch, host):
    for vocab, seq in ((503, 33), (32064, 64)):
        want = JTask(vocab, seq, task).batch(step, batch, *host)
        got = SyntheticTask(vocab, seq, task).batch(step, batch, *host)
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("schedule", ["cosine", "wsd"])
def test_lr_schedule_bitwise(schedule):
    """Every step 0..1199 of a 1000-step run (warmup, the cosine or
    WSD decay, and past the end), as the train step passes it: an int32
    device scalar. Bitwise against the reference's function run op by
    op (cos is the C library's cosf, as XLA's). Under `jax.jit` XLA
    rewrites some of these ops (a division by a constant, fusions) and
    the jitted schedule differs from its own op-by-op run by an ulp at
    a few steps (44 of 300 for cosine, 12 for WSD on an x86 CPU); the
    train steps are compared within tolerances."""
    jcfg = jsmoke("minicpm-2b").replace(schedule=schedule, warmup_steps=37)
    cfg = smoke_config("minicpm-2b").replace(schedule=schedule,
                                              warmup_steps=37)
    steps = np.arange(1200, dtype=np.int32)
    want = np.array([np.asarray(jadamw.lr_schedule(jnp.asarray(s), jcfg,
                                                   1000)) for s in steps])
    got = np.array([adamw.lr_schedule(torch.tensor(int(s),
                                                   dtype=torch.int32),
                                      cfg, 1000).numpy() for s in steps])
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_int8_rows_bitwise():
    """_q8_rows bitwise (q and the row scales), _dq8_rows bitwise, on
    rows with ties at .5, zeros and a wide range of magnitudes."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 33)) * np.logspace(-6, 3, 6)[:, None]) \
        .astype(np.float32)
    x[2] = 0.0
    x[3, :4] = [127.0, 63.5, -0.5, 1.5]
    jq, js = jadamw._q8_rows(jnp.asarray(x))
    q, s = adamw._q8_rows(torch.from_numpy(x))
    assert np.array_equal(np.asarray(jq), q.numpy())
    assert np.array_equal(np.asarray(js), s.numpy())
    assert np.array_equal(np.asarray(jadamw._dq8_rows(jq, js, x.shape)),
                          adamw._dq8_rows(q, s).numpy())


def test_global_norm_within_tolerance():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((5, 7)).astype(np.float32),
            "b": [rng.standard_normal(300).astype(np.float32)]}
    want = float(jadamw.global_norm(jax.tree_util.tree_map(jnp.asarray,
                                                           tree)))
    got = float(adamw.global_norm(pytree.tree_map(torch.from_numpy, tree)))
    assert abs(got - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# B9's gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b,s,h,hk,d", [(2, 37, 4, 2, 16), (1, 70, 4, 4, 64),
                                        (2, 65, 4, 1, 64)])
def test_b9_backward_plain_matches_jax_grad(b, s, h, hk, d):
    """dq, dk, dv of B9 under autograd on CPU tensors (the plain forward
    with its LSE and the plain backward) against `jax.grad` of the
    reference's `chunked_attention` in fp32 (GQA, causal, a query chunk
    smaller than S so its scan runs): within 2e-6 of each gradient's
    largest magnitude. The output within 2e-6 too."""
    rng = np.random.default_rng(s)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32) for shape in
                  ((b, s, h, d), (b, s, hk, d), (b, s, hk, d), (b, s, h, d)))

    def jfn(q, k, v):
        out = JL.chunked_attention(q, k, v, q_chunk=32,
                                   compute_dtype=jnp.float32)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention(tq, tk, tv)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    assert _rel(jout, out) <= 2e-6
    for a, bb in zip(jgrads, grads):
        assert _rel(a, bb) <= 2e-6


def test_b9_autograd_function_pieces():
    """The LSE forward equals the served forward bitwise and its LSE the
    rows' log-sum-exp; the backward's pieces compose (the plain
    autograd function gives the same bits as the wrapper on CPU
    tensors), also with a window, a softcap and both; a q_offset raises
    under autograd."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((2, 20, 4, 16), (2, 20, 2, 16),
                                   (2, 20, 2, 16)))
    out, lse = flash_attention_lse(q, k, v)
    assert torch.equal(out, flash_attention(q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", q,
                          k.repeat_interleave(2, dim=2)) * 16 ** -0.5
    logits = logits.masked_fill(torch.ones(20, 20).triu(1).bool(),
                                float("-inf"))
    assert float((lse - torch.logsumexp(logits, -1)).abs().max()) <= 1e-5
    g = torch.from_numpy(rng.standard_normal((2, 20, 4, 16)).astype(
        np.float32))
    a = [t.clone().requires_grad_() for t in (q, k, v)]
    b = [t.clone().requires_grad_() for t in (q, k, v)]
    ga = torch.autograd.grad(flash_attention(*a), a, g)
    gb = torch.autograd.grad(flash_attention_grad_plain(*b), b, g)
    gc = flash_attention_backward_plain(q, k, v, out, lse, g)
    for x, y, z in zip(ga, gb, gc):
        assert torch.equal(x, y) and torch.equal(x, z)
    qg = q.clone().requires_grad_()
    with pytest.raises(NotImplementedError):
        flash_attention(qg, k, v, q_offset=3)
    for kw in (dict(window=4), dict(softcap=30.0),
               dict(window=4, softcap=2.0)):
        out, lse = flash_attention_lse(q, k, v, **kw)
        assert torch.equal(out, flash_attention(q, k, v, **kw))
        a = [t.clone().requires_grad_() for t in (q, k, v)]
        b = [t.clone().requires_grad_() for t in (q, k, v)]
        ga = torch.autograd.grad(flash_attention(*a, **kw), a, g)
        gb = torch.autograd.grad(flash_attention_grad_plain(*b, **kw), b, g)
        gc = flash_attention_backward_plain(q, k, v, out, lse, g, **kw)
        for x, y, z in zip(ga, gb, gc):
            assert torch.equal(x, y) and torch.equal(x, z)


# ---------------------------------------------------------------------------
# loss, gradients, train steps
# ---------------------------------------------------------------------------


def _models(arch, **kw):
    jcfg = jsmoke(arch).replace(**kw)
    cfg = smoke_config(arch).replace(**kw)
    return JModel(jcfg), Model(cfg)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_loss_and_grads_match_reference(arch, cd):
    """`Model.loss` and its gradients (autograd through B9's function)
    against `jax.value_and_grad(model.loss)`, with GQA for minitron:
    fp32 within 1e-6 / 2e-5, bf16 within 1e-4 / 5e-2 (module
    docstring). aux is 0."""
    kw = dict(compute_dtype=cd)
    if arch == "minitron-8b":
        kw["n_kv_heads"] = 2
    jm, m = _models(arch, **kw)
    jp = jm.init(jax.random.PRNGKey(1))
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        m.init(prng.PRNGKey(1), device="cpu"))
    toks = _tokens(7, b=2, s=40)
    (jl, jmets), jg = jax.value_and_grad(jm.loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    loss, mets = m.loss(p, {"tokens": toks})
    loss.backward()
    lt, gt = (1e-6, 2e-5) if cd == "float32" else (1e-4, 5e-2)
    assert abs(float(loss.detach()) - float(jl)) <= lt * abs(float(jl))
    assert float(mets["aux"]) == float(jmets["aux"]) == 0.0
    for a, t in zip(jax.tree_util.tree_leaves(jg), pytree.leaves(p)):
        assert _rel(a, t.grad) <= gt


def test_remat_gives_the_same_bits():
    """remat="full" (each layer under torch.utils.checkpoint) and
    "none" give bitwise the same loss and gradients."""
    _, m0 = _models("phi3-mini-3.8b", remat="none")
    _, m1 = _models("phi3-mini-3.8b", remat="full")
    toks = _tokens(2)
    outs = []
    for m in (m0, m1):
        p = pytree.tree_map(lambda t: t.requires_grad_(),
                            m.init(prng.PRNGKey(0), device="cpu"))
        loss, _ = m.loss(p, {"tokens": toks})
        loss.backward()
        outs.append([loss.detach()] + [t.grad for t in pytree.leaves(p)])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def _run_steps(arch, n, accum, **kw):
    jm, m = _models(arch, **kw)
    jstate = jinit(jm, jax.random.PRNGKey(0))
    state = init_train_state(m, prng.PRNGKey(0), device="cpu")
    jstep = jax.jit(jmake_step(jm, total_steps=10, grad_accum=accum))
    step = make_train_step(m, total_steps=10, grad_accum=accum)
    for i in range(n):
        toks = _tokens(100 + i)
        jstate, jmets = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, mets = step(state, {"tokens": toks})
    return jstate, jmets, state, mets


@pytest.mark.parametrize("arch,cd,accum,n", [
    ("minitron-8b", "float32", 1, 1), ("minitron-8b", "float32", 2, 3),
    ("minicpm-2b", "float32", 2, 3), ("phi3-mini-3.8b", "bfloat16", 1, 3),
    ("minicpm-2b", "bfloat16", 2, 3)])
def test_train_steps_match_reference(arch, cd, accum, n):
    """n steps of `make_train_step` (fp32 moments; grad_accum 1 and 2;
    minicpm: WSD and tied embeddings) against `jax.jit(make_train_step)`:
    the step counter equal, loss and grad norm within 1e-4 (fp32) / 1e-3
    (bf16) relative, parameters and moments within 2e-4 / 6e-2 of each
    leaf's largest magnitude."""
    jstate, jmets, state, mets = _run_steps(arch, n, accum,
                                            compute_dtype=cd)
    assert int(state["step"]) == int(jstate["step"]) == n
    mt, pt = (1e-4, 2e-4) if cd == "float32" else (1e-3, 6e-2)
    for key in ("loss", "grad_norm"):
        assert abs(float(mets[key]) - float(jmets[key])) <= \
            mt * abs(float(jmets[key]))
    for part in ("params", "m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[part]),
                        pytree.leaves(state[part])):
            assert _rel(a, b) <= pt


@pytest.mark.parametrize("accum", [1, 2])
def test_int8_moments_one_step(accum):
    """One step with int8 moments (fp32 compute; bf16 accumulation when
    grad_accum is 2): parameters within 2e-4 of each leaf's largest
    magnitude, the moments' row scales within 1e-4 relative and their
    int8 values within one quantization step."""
    jstate, _, state, _ = _run_steps("minitron-8b", 1, accum,
                                     compute_dtype="float32",
                                     opt_state_dtype="int8")
    for a, b in zip(jax.tree_util.tree_leaves(jstate["params"]),
                    pytree.leaves(state["params"])):
        assert _rel(a, b) <= 2e-4
    for part in ("m", "v"):
        jl = jax.tree_util.tree_leaves(jstate[part])
        tl = pytree.leaves(state[part])
        for jq, js, q, s in zip(jl[0::2], jl[1::2], tl[0::2], tl[1::2]):
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            assert np.abs(np.asarray(js) - s.numpy()).max() <= \
                1e-4 * np.abs(np.asarray(js)).max()
            assert np.abs(np.asarray(jq, np.int32)
                          - q.numpy().astype(np.int32)).max() <= 1


def test_train_step_updates_in_place_and_is_deterministic():
    """The state comes back as the same tensors, updated; two runs from
    the same state give the same bits."""
    _, m = _models("minicpm-2b")
    step = make_train_step(m, total_steps=10, grad_accum=2)
    runs = []
    for _ in range(2):
        state = init_train_state(m, prng.PRNGKey(0), device="cpu")
        leaf = pytree.leaves(state["params"])[0]
        before = leaf.clone()
        for i in range(2):
            out, _ = step(state, {"tokens": _tokens(i)})
        assert out is state and pytree.leaves(out["params"])[0] is leaf
        assert not torch.equal(leaf, before)
        runs.append(pytree.leaves(out))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
