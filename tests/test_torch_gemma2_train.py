"""Gemma-2's training on the port against the JAX reference, on the CPU:
B9's gradient with the logit softcap and the sliding window (its plain
version, what CPU tensors run), `Model.loss` and every leaf's gradient
over the local/global periods with sandwich norms, one and two train
steps, the per-period gradient views, checkpoints of the stacked
`sub0` / `sub1` leaves, resume, Branch-Train-Merge and the train and
merge CLIs with `--arch gemma2-27b --smoke`.

As in `tests/test_torch_gemma2.py`, gemma2's smoke config keeps the
full config's window (4096) and softcap (50), which never bind at smoke
sizes: the tests set `sliding_window` to 5 and `attn_softcap` to 2.0 on
both sides, the sequence is longer than the window, and the query and
key projections are drawn at 0.3 so the scaled logits reach the
softcap's bend. Inputs are made from a seed with numpy and handed to
both packages. Each assertion says whether it is bitwise or within a
tolerance; every tolerance is at least twice the largest reading on an
x86 CPU:
  * B9's plain backward against `jax.grad` of `chunked_attention` in
    fp32: 2e-6 of the largest gradient magnitude of the three (dq, dk,
    dv) (read 5.8e-7). A window of 1 leaves every row one key, so dq
    and dk are 0 in exact arithmetic and in the reference; the plain
    version's float64 dP - Dd leaves up to 7e-15 there (1e-15 of that
    scale);
  * the loss in fp32 compute: 1e-6 relative (read 1.9e-7); gradients
    2e-5 of each leaf's largest magnitude (read 6.5e-7); in bf16
    compute (the port keeps p . v in fp32 where the reference rounds p
    to bf16): 2e-4 (read 9.4e-5) and 5e-2 (read 1.1e-2);
  * train steps in fp32 compute: loss and grad norm within 1e-4
    relative (read 9.2e-8), parameters and moments within 2e-4 of each
    leaf's largest magnitude (read 1.2e-5);
  * BTM round losses within 2e-4 relative (read 6.0e-5; bf16 compute).
"""
import filecmp
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jckpt  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.optim.adamw import init_opt_state as jinit_opt  # noqa: E402
from repro.train.btm import BranchTrainMerge as JBTM  # noqa: E402
from repro.train.step import make_train_step as jmake_step  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import convert, pytree  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.models.schema import schema_leaves  # noqa: E402
from repro_torch.train import step as tstep  # noqa: E402
from repro_torch.train.btm import BranchTrainMerge  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    init_train_state, make_train_step, train_state_shapes)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "gemma2-27b"
WINDOW, SOFTCAP = 5, 2.0
SEQ = 24                  # past the window: the local layers' mask binds


def _configs(**kw):
    kw = dict(sliding_window=WINDOW, attn_softcap=SOFTCAP, **kw)
    return smoke_config(ARCH).replace(**kw), jsmoke(ARCH).replace(**kw)


def _np_params(cfg, seed):
    """Numpy fp32 weights in the port's layout (the reference's, as
    tests/test_torch_gemma2.py checks): norms near 1, embeddings 0.4,
    the query and key projections 0.3 (softcapped logits), the rest
    0.02."""
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
            scale = {"embed": 0.4, "wq": 0.3, "wk": 0.3}.get(
                keys[0] if keys[0] == "embed" else keys[-1], 0.02)
            a = scale * rng.standard_normal(pdef.shape)
        node[keys[-1]] = a.astype(np.float32)
    return out


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _rel(a, b) -> float:
    """max |a - b| over max |a| (a the reference)."""
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def _tokens(seed, b=4, s=SEQ, vocab=503):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


# ------------------------------------------------------------ B9's gradient


@pytest.mark.parametrize("window", [1, 5, 64])
@pytest.mark.parametrize("softcap", [0.0, 2.0, 50.0])
def test_b9_backward_window_softcap_matches_jax_grad(window, softcap):
    """dq, dk, dv of B9 under autograd on CPU tensors (the plain forward
    with its LSE, the plain backward) with a window (1: one key a row; 5;
    64 >= S: never binding) and a softcap (off, binding, nearly linear)
    against `jax.grad` of `chunked_attention` in fp32 (GQA 4:2, inputs of
    scale 2, a query chunk below S so its scan runs): each within 2e-6 of
    the three gradients' largest magnitude; the output within 2e-6 of
    its own."""
    rng = np.random.default_rng(window * 10 + int(softcap))
    b, s, h, hk, d = 2, 37, 4, 2, 16
    q, k, v = (2 * rng.standard_normal(shape).astype(np.float32)
               for shape in ((b, s, h, d), (b, s, hk, d), (b, s, hk, d)))
    g = rng.standard_normal((b, s, h, d)).astype(np.float32)

    def jfn(q, k, v):
        out = JL.chunked_attention(q, k, v, window=window, softcap=softcap,
                                   q_chunk=16, compute_dtype=jnp.float32)
        return jnp.sum(out * g), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, window=window, softcap=softcap)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert _rel(jout, out) <= 2e-6
    top = max(float(np.abs(_np(a)).max()) for a in jgrads)
    for a, t in zip(jgrads, grads):
        assert float(np.abs(_np(a) - _np(t)).max()) <= 2e-6 * top


# ------------------------------------------------------- loss, gradients


@pytest.mark.parametrize("cd,remat", [("float32", "none"),
                                      ("float32", "full"),
                                      ("bfloat16", "none")])
def test_gemma2_loss_and_grads_match_reference(cd, remat):
    """gemma2's `Model.loss` (2 periods of a local and a global
    sub-layer, sandwich norms, the embedding scale, the final softcap)
    and every leaf's gradient, autograd through B9's function, against
    `jax.value_and_grad(model.loss)` (each sub-layer under remat or
    not): fp32 within 1e-6 / 2e-5, bf16 within 2e-4 / 5e-2 (module
    docstring). aux is 0."""
    cfg, jcfg = _configs(compute_dtype=cd, remat=remat)
    pn = _np_params(cfg, 3)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    p = pytree.tree_map(lambda t: t.requires_grad_(),
                        convert.from_numpy_tree(pn, "cpu"))
    toks = _tokens(7, b=2)
    (jl, jmets), jg = jax.value_and_grad(JModel(jcfg).loss, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)})
    loss, mets = Model(cfg).loss(p, {"tokens": toks})
    loss.backward()
    lt, gt = (1e-6, 2e-5) if cd == "float32" else (2e-4, 5e-2)
    assert abs(float(loss.detach()) - float(jl)) <= lt * abs(float(jl))
    assert float(mets["aux"]) == float(jmets["aux"]) == 0.0
    jflat, _ = jax.tree_util.tree_flatten_with_path(jg)
    flat, _ = pytree.flatten_with_path(p)
    assert [jax.tree_util.keystr(k) for k, _ in jflat] == \
        [pytree.keystr(k) for k, _ in flat]
    for (_, a), (_, t) in zip(jflat, flat):
        assert _rel(a, t.grad) <= gt


def test_gemma2_grad_views_per_period():
    """Exact: the train step's per-period autograd leaves (`_grad_views`)
    give every `blocks/sub{j}` slice its own view of the stacked
    gradient, and the loss's gradient through them equals, bit for bit,
    the gradient of the stacked leaves taken directly."""
    cfg, _ = _configs(compute_dtype="float32")
    m = Model(cfg)
    params = convert.from_numpy_tree(_np_params(cfg, 4), "cpu")
    toks = {"tokens": _tokens(8, b=2)}
    grads = pytree.tree_map(torch.zeros_like, params)
    live = tstep._grad_views(params, grads, m.n_periods)
    assert m.n_periods == 2 and sorted(live["blocks"]) == ["sub0", "sub1"]
    for name, per in live["blocks"].items():
        assert len(per) == m.n_periods
        for i, views in enumerate(per):
            for t, g in zip(pytree.leaves(views),
                            pytree.leaves(grads["blocks"][name])):
                assert t.grad.data_ptr() == g[i].data_ptr()
                assert t.grad.shape == g.shape[1:]
    m.loss(live, toks)[0].backward()
    direct = pytree.tree_map(lambda t: t.clone().requires_grad_(), params)
    m.loss(direct, toks)[0].backward()
    for g, t in zip(pytree.leaves(grads), pytree.leaves(direct)):
        assert torch.equal(g, t.grad)
        assert float(g.abs().max()) > 0


# -------------------------------------------------------------- train steps


def _states(cfg, jcfg, seed):
    pn = _np_params(cfg, seed)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    jopt = jinit_opt(jp, jcfg.opt_state_dtype)
    jstate = {"params": jp, "m": jopt["m"], "v": jopt["v"],
              "step": jnp.zeros((), jnp.int32)}
    state = init_train_state(Model(cfg), params=convert.from_numpy_tree(
        pn, "cpu"), device="cpu")
    return jstate, state


@pytest.mark.parametrize("n,accum", [(1, 1), (2, 2)])
def test_gemma2_train_steps_match_reference(n, accum):
    """n steps of `make_train_step` (fp32 compute and moments, grad_accum
    1 and 2) from the same parameters against `jax.jit(make_train_step)`:
    the step counter equal, loss and grad norm within 1e-4 relative,
    parameters and moments within 2e-4 of each leaf's largest
    magnitude."""
    cfg, jcfg = _configs(compute_dtype="float32")
    jstate, state = _states(cfg, jcfg, 5)
    jstep = jax.jit(jmake_step(JModel(jcfg), total_steps=10,
                               grad_accum=accum))
    step = make_train_step(Model(cfg), total_steps=10, grad_accum=accum)
    for i in range(n):
        toks = _tokens(100 + i)
        jstate, jmets = jstep(jstate, {"tokens": jnp.asarray(toks)})
        state, mets = step(state, {"tokens": toks})
    assert int(state["step"]) == int(jstate["step"]) == n
    for key in ("loss", "grad_norm"):
        assert abs(float(mets[key]) - float(jmets[key])) <= \
            1e-4 * abs(float(jmets[key]))
    for part in ("params", "m", "v"):
        for a, b in zip(jax.tree_util.tree_leaves(jstate[part]),
                        pytree.leaves(state[part])):
            assert _rel(a, b) <= 2e-4


# ----------------------------------------------- checkpoints, resume, BTM


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


def test_gemma2_checkpoints_byte_equal_both_ways(tmp_path):
    """Exact: the reference's state after a train step (the stacked
    `sub0` / `sub1` leaves, their moments, the step), saved by each
    package, gives byte-equal directories, and each package restores
    the other's bitwise."""
    cfg, jcfg = _configs(compute_dtype="float32")
    jstate, _ = _states(cfg, jcfg, 6)
    jstate, _ = jax.jit(jmake_step(JModel(jcfg), total_steps=10,
                                   grad_accum=1))(
        jstate, {"tokens": jnp.asarray(_tokens(9))})
    tstate = pytree.tree_map(torch.from_numpy, jax.tree_util.tree_map(
        np.array, jstate))
    meta = {"data_step": 1, "arch": cfg.name}
    pj = jckpt.save_checkpoint(str(tmp_path / "j"), jstate, 1, metadata=meta)
    pt = ckpt.save_checkpoint(str(tmp_path / "t"), tstate, 1, metadata=meta)
    _same_dirs(pj, pt)
    with open(os.path.join(pt, "manifest.json")) as f:
        names = f.read()
    assert "sub0" in names and "sub1" in names
    got, m = ckpt.restore_checkpoint(pj, train_state_shapes(Model(cfg)),
                                     device="cpu")
    assert m == meta
    back, _ = jckpt.restore_checkpoint(pt, jstate)
    for a, b, c in zip(jax.tree_util.tree_leaves(jstate),
                       pytree.leaves(got), jax.tree_util.tree_leaves(back)):
        assert np.array_equal(np.asarray(a), b.numpy())
        assert np.array_equal(np.asarray(a), np.asarray(c))


def test_gemma2_resume_matches_uninterrupted(tmp_path):
    """Exact: 4 steps straight against 2 + checkpoint + restore + 2 in
    the port (grad_accum 2): parameters, moments and the step counter
    bitwise."""
    cfg, _ = _configs(compute_dtype="float32")
    m = Model(cfg)
    step = make_train_step(m, total_steps=4)
    pn = _np_params(cfg, 7)

    def fresh():
        return init_train_state(m, params=convert.from_numpy_tree(pn, "cpu"),
                                device="cpu")

    a = fresh()
    for i in range(4):
        a, _ = step(a, {"tokens": _tokens(i)})
    b = fresh()
    for i in range(2):
        b, _ = step(b, {"tokens": _tokens(i)})
    p = ckpt.save_checkpoint(str(tmp_path), b, 2, metadata={"data_step": 2})
    b, meta = ckpt.restore_checkpoint(p, train_state_shapes(m), device="cpu")
    for i in range(int(meta["data_step"]), 4):
        b, _ = step(b, {"tokens": _tokens(i)})
    assert int(b["step"]) == 4
    assert all(torch.equal(x, y) for x, y in
               zip(pytree.leaves(a), pytree.leaves(b)))


def test_gemma2_btm_branches_byte_identical():
    """The reference's BTM (3 branches, weight_average, all-pairs gossip,
    a merge every 2 steps) on gemma2 with the window and softcap binding,
    in both packages from the reference's init: after each of two rounds
    the alive branches are byte-identical and gossip has converged, and
    each round's losses are within 2e-4 relative of the reference's; a
    branch killed before round 2 does not train."""
    cfg, jcfg = _configs(grad_accum=1)
    kw = dict(n_branches=3, strategy="weight_average", merge_every=2,
              batch_size=4, seq_len=SEQ)
    jb, tb = JBTM(jcfg, **kw), BranchTrainMerge(cfg, device="cpu", **kw)
    for rnd in range(2):
        if rnd:
            jb.kill_branch(2)
            tb.kill_branch(2)
        rj, rt = jb.train_round(), tb.train_round()
        assert sorted(rj["losses"]) == sorted(rt["losses"]) == \
            ([0, 1, 2] if rnd == 0 else [0, 1])
        for i, loss in rj["losses"].items():
            assert abs(rt["losses"][i] - loss) <= 2e-4 * abs(loss)
        alive = [b for b in tb.branches if b.alive]
        first = pytree.leaves(alive[0].state["params"])
        for b in alive[1:]:
            assert all(torch.equal(x, y) for x, y in
                       zip(first, pytree.leaves(b.state["params"])))
        assert tb.net.converged()


# ----------------------------------------------------------------- CLIs


def _cli(module, *args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def _losses(out):
    return [float(line.split()[3]) for line in out.splitlines()
            if line.startswith("step")]


def test_gemma2_train_and_merge_clis(tmp_path):
    """`--arch gemma2-27b --smoke` through both CLIs on the CPU: the
    port's train CLI, its resume, and its first losses within 1e-3 of
    the reference CLI's (they print 4 decimals); then the port's and
    the reference's merge CLIs (TIES over a port checkpoint and a
    reference one, with a base) write byte-equal directories and print
    the same lines."""
    common = ["--arch", ARCH, "--smoke", "--batch", "2", "--seq", "16",
              "--log-every", "1"]
    out = _cli("repro_torch.launch.train", *common, "--steps", "2",
               "--ckpt-dir", "a", "--task", "1", "--device", "cpu",
               cwd=tmp_path)
    ref = _cli("repro.launch.train", *common, "--steps", "2", "--ckpt-dir",
               "jb", "--task", "1", cwd=tmp_path)
    assert out.splitlines()[-1] == "done"
    for x, y in zip(_losses(out), _losses(ref), strict=True):
        assert abs(x - y) <= 1e-3
    out = _cli("repro_torch.launch.train", *common, "--steps", "3",
               "--ckpt-dir", "a", "--task", "1", "--device", "cpu",
               "--resume", cwd=tmp_path)
    assert "resumed from a/step_00000002 at data step 2" in out
    _cli("repro_torch.launch.train", *common, "--steps", "0", "--ckpt-dir",
         "base", "--device", "cpu", cwd=tmp_path)
    args = ["--arch", ARCH, "--smoke", "--strategy", "ties", "--base",
            str(tmp_path / "base/step_00000000"), "--inputs",
            str(tmp_path / "a/step_00000003"),
            str(tmp_path / "jb/step_00000002"), "--out", "m"]
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    out = _cli("repro_torch.launch.merge", *args, "--device", "cpu",
               cwd=tmp_path / "p")
    ref = _cli("repro.launch.merge", *args, cwd=tmp_path / "j")
    assert out == ref
    _same_dirs(tmp_path / "p" / "m" / "step_00000000",
               tmp_path / "j" / "m" / "step_00000000")
