"""The port's checkpoints, Branch-Train-Merge and the train / merge CLIs
against the JAX reference, on the CPU.

  * checkpoint directories: the port's and the reference's are byte-equal
    file for file (fp32, int8 and bf16 states), and each package
    restores the other's, bitwise; except that the reference cannot
    restore a bf16 leaf, its own or the port's (np.load gives void
    values; ROADMAP C, reference-side hazards), which is pinned here;
  * retention, atomicity, `latest_checkpoint`, the async writer;
  * CRDT state: round trips in each package and across them, bitwise;
  * resume: 4 steps straight against 2 + save + restore + 2, bitwise in
    the port (the reference holds its own to 1e-6);
  * the reference's four BTM scenarios on the port, with the branches
    byte-identical after every merge and each round's losses within
    1e-4 relative of the reference's (read 3.1e-5: bf16 compute, the
    port's attention keeps p . v in fp32);
  * both CLIs with --device cpu: the train CLI's logged losses within
    1e-3 of the reference CLI's (they print 4 decimals), its resume;
    the merge CLI's output directory byte-equal to the reference CLI's
    over the same checkpoints, and to an in-process
    `Replica.resolve(MergeSpec("ties"), base=...)`.
"""
import filecmp
import json
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
from repro.core.state import CRDTMergeState as JState  # noqa: E402
from repro.models.model import Model as JModel  # noqa: E402
from repro.train.btm import BranchTrainMerge as JBTM  # noqa: E402
from repro.train.step import init_train_state as jinit  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import pytree  # noqa: E402
from repro_torch import random as prng  # noqa: E402
from repro_torch.api import MergeSpec, Replica  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.state import CRDTMergeState  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.train.btm import BranchTrainMerge  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    init_train_state, make_train_step, train_state_shapes)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ARCH = "minitron-8b"


def _same_dirs(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        assert filecmp.cmp(os.path.join(a, n), os.path.join(b, n),
                           shallow=False), n


def _states(**kw):
    js = jinit(JModel(jsmoke(ARCH).replace(**kw)), jax.random.PRNGKey(0))
    ts = init_train_state(Model(smoke_config(ARCH).replace(**kw)),
                          prng.PRNGKey(0), device="cpu")
    return js, ts


def _equal(jtree, ttree):
    jl = jax.tree_util.tree_leaves(jtree)
    tl = pytree.leaves(ttree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        if b.dtype == torch.bfloat16:
            assert np.array_equal(a.view(np.uint16),
                                  b.view(torch.int16).numpy().view(np.uint16))
        else:
            assert str(a.dtype) == str(b.dtype).replace("torch.", "")
            assert np.array_equal(a, b.numpy())


@pytest.mark.parametrize("kw", [
    {}, dict(opt_state_dtype="int8"),
    dict(param_dtype="bfloat16", opt_state_dtype="bfloat16")])
def test_checkpoint_dirs_byte_equal_and_cross_restore(tmp_path, kw):
    js, ts = _states(**kw)
    meta = {"data_step": 3, "arch": "x"}
    pj = jckpt.save_checkpoint(str(tmp_path / "j"), js, 3, metadata=meta)
    pt = ckpt.save_checkpoint(str(tmp_path / "t"), ts, 3, metadata=meta)
    assert os.path.basename(pj) == os.path.basename(pt) == "step_00000003"
    _same_dirs(pj, pt)
    # the port restores the reference's directory (and its own), bitwise
    for p in (pj, pt):
        got, m = ckpt.restore_checkpoint(p, train_state_shapes(
            Model(smoke_config(ARCH).replace(**kw))), device="cpu")
        assert m == meta
        _equal(js, got)
    if "param_dtype" in kw:
        # reference-side hazard: np.load gives '|V2' values for bf16
        with pytest.raises(TypeError):
            jckpt.restore_checkpoint(pt, js)
        return
    got, m = jckpt.restore_checkpoint(pt, js)
    assert m == meta
    _equal(got, ts)


def test_checkpoint_retention_latest_and_async(tmp_path):
    _, ts = _states()
    for s in (1, 2, 3):
        ckpt.save_checkpoint(str(tmp_path), ts, s, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]
    assert ckpt.latest_checkpoint(str(tmp_path)) == \
        str(tmp_path / "step_00000003")
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    # the async writer snapshots now: a later in-place change is not saved
    before = pytree.tree_map(lambda t: t.clone(), ts)
    fut = ckpt.save_checkpoint_async(str(tmp_path / "a"), ts, 7,
                                     metadata={"data_step": 7})
    pytree.leaves(ts["params"])[0].add_(1.0)
    path = fut.result(timeout=120)
    got, meta = ckpt.restore_checkpoint(path, ts, device="cpu")
    assert meta == {"data_step": 7}
    assert all(torch.equal(a, b) for a, b in
               zip(pytree.leaves(got), pytree.leaves(before)))


def test_crdt_state_round_trip_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [{"w": rng.standard_normal((4, 4)).astype(np.float32),
               "b": rng.standard_normal(3).astype(np.float32)}
              for _ in range(3)]
    s, js = CRDTMergeState(), JState()
    for i, a in enumerate(arrays):
        s = s.add(pytree.tree_map(torch.from_numpy, a), node=f"n{i}")
        js = js.add(jax.tree_util.tree_map(jnp.asarray, a), node=f"n{i}")
    drop = sorted(s.visible())[0]
    s, js = s.remove(drop, "n0"), js.remove(drop, "n0")
    assert s.merkle_root() == js.merkle_root()
    pt = ckpt.save_crdt_state(str(tmp_path / "t"), s, "n0")
    pj = jckpt.save_crdt_state(str(tmp_path / "j"), js, "n0")
    _same_dirs(pt, pj)
    like = pytree.tree_map(torch.from_numpy, arrays[0])
    for p in (pt, pj):
        r = ckpt.restore_crdt_state(p, like, device="cpu")
        assert r == s and r.visible() == s.visible()
        assert r.merkle_root() == s.merkle_root()
        for eid in s.store:
            assert all(torch.equal(a, b) for a, b in zip(
                pytree.leaves(r.store[eid]), pytree.leaves(s.store[eid])))
    jr = jckpt.restore_crdt_state(pt, jax.tree_util.tree_map(jnp.asarray,
                                                             arrays[0]))
    assert jr == js and jr.merkle_root() == s.merkle_root()


def test_resume_matches_uninterrupted(tmp_path):
    """4 steps straight vs 2 + checkpoint + restore + 2: parameters,
    moments and the step counter bitwise."""
    cfg = smoke_config(ARCH).replace(grad_accum=1)
    m = Model(cfg)
    step = make_train_step(m, total_steps=4)

    def batch(i):
        return {"tokens": np.random.default_rng(i).integers(
            0, cfg.vocab_size, (4, 32)).astype(np.int32)}

    a = init_train_state(m, prng.PRNGKey(0), device="cpu")
    for i in range(4):
        a, _ = step(a, batch(i))
    b = init_train_state(m, prng.PRNGKey(0), device="cpu")
    for i in range(2):
        b, _ = step(b, batch(i))
    p = ckpt.save_checkpoint(str(tmp_path), b, 2, metadata={"data_step": 2})
    b, meta = ckpt.restore_checkpoint(p, train_state_shapes(m), device="cpu")
    for i in range(int(meta["data_step"]), 4):
        b, _ = step(b, batch(i))
    assert all(torch.equal(x, y) for x, y in
               zip(pytree.leaves(a), pytree.leaves(b)))


# ---------------------------------------------------------------------------
# BTM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def btms():
    kw = dict(n_branches=3, strategy="weight_average", merge_every=3,
              batch_size=4, seq_len=32)
    jb = JBTM(jsmoke(ARCH).replace(grad_accum=1), **kw)
    tb = BranchTrainMerge(smoke_config(ARCH).replace(grad_accum=1),
                          device="cpu", **kw)
    return jb, tb, [_round(jb, tb)]


def _round(jb, tb):
    rj, rt = jb.train_round(), tb.train_round()
    assert rj["round"] == rt["round"]
    assert sorted(rj["losses"]) == sorted(rt["losses"])
    for i, loss in rj["losses"].items():
        assert abs(rt["losses"][i] - loss) <= 1e-4 * abs(loss)
    alive = [b for b in tb.branches if b.alive]
    first = pytree.leaves(alive[0].state["params"])
    for b in alive[1:]:
        assert all(torch.equal(x, y) for x, y in
                   zip(first, pytree.leaves(b.state["params"])))
    assert tb.net.converged()
    assert len(tb.net.nodes[0].state.visible()) == \
        len(jb.net.nodes[0].state.visible())
    return rt


def test_btm_branches_bitwise_identical_after_merge(btms):
    _, tb, recs = btms
    assert recs[0]["round"] == 1 and sorted(recs[0]["losses"]) == [0, 1, 2]
    p0 = tb.branches[0].state["params"]
    p1 = tb.branches[1].state["params"]
    assert all(torch.equal(a, b) for a, b in
               zip(pytree.leaves(p0), pytree.leaves(p1)))
    # the base stays the base: no branch aliases it
    assert not torch.equal(pytree.leaves(tb.base_params)[0],
                           pytree.leaves(p0)[0])


def test_btm_survives_branch_death(btms):
    jb, tb, _ = btms
    jb.kill_branch(2)
    tb.kill_branch(2)
    rec = _round(jb, tb)
    assert 2 not in rec["losses"]


def test_btm_straggler_included_next_round(btms):
    jb, tb, _ = btms
    jb.mark_straggler(1, rounds=1)
    tb.mark_straggler(1, rounds=1)
    _round(jb, tb)
    n_before = len(tb.net.nodes[0].state.visible())
    _round(jb, tb)                       # the straggler's add lands
    assert len(tb.net.nodes[0].state.visible()) > n_before


def test_btm_elastic_join(btms):
    jb, tb, _ = btms
    assert jb.add_branch() == tb.add_branch() == 3
    rec = _round(jb, tb)
    assert 3 in rec["losses"]
    assert tb.net.nodes[3].state.visible() == \
        tb.net.nodes[0].state.visible()
    jl = jb.eval_loss(jb.branches[0].state["params"], 1)
    tl = tb.eval_loss(tb.branches[0].state["params"], 1)
    assert abs(tl - jl) <= 1e-4 * abs(jl)


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------


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


def test_train_and_merge_clis_on_the_cpu(tmp_path):
    """The train CLI (and its resume) on the port, the reference's train
    CLI beside it; then both merge CLIs over a port checkpoint and a
    reference one, each writing `m` in a directory of its own."""
    common = ["--arch", ARCH, "--smoke", "--batch", "4", "--seq", "32",
              "--log-every", "1"]
    out = _cli("repro_torch.launch.train", *common, "--steps", "3",
               "--ckpt-dir", "a", "--task", "1", "--device", "cpu",
               cwd=tmp_path)
    ref = _cli("repro.launch.train", *common, "--steps", "2", "--ckpt-dir",
               "jb", "--task", "2", cwd=tmp_path)
    assert out.splitlines()[-1] == "done"
    out = _cli("repro_torch.launch.train", *common, "--steps", "4",
               "--ckpt-dir", "a", "--task", "1", "--device", "cpu",
               "--resume", cwd=tmp_path)
    assert "resumed from a/step_00000003 at data step 3" in out
    _cli("repro_torch.launch.train", *common, "--steps", "0", "--ckpt-dir",
         "base", "--device", "cpu", cwd=tmp_path)
    # the reference's CLI run as the port's: the same first losses
    out = _cli("repro_torch.launch.train", *common, "--steps", "2",
               "--task", "2", "--device", "cpu", cwd=tmp_path)
    for x, y in zip(_losses(out), _losses(ref)):
        assert abs(x - y) <= 1e-3
    inputs = [str(tmp_path / "a/step_00000004"),
              str(tmp_path / "jb/step_00000002")]
    args = ["--arch", ARCH, "--smoke", "--strategy", "ties", "--base",
            str(tmp_path / "base/step_00000000"), "--inputs", *inputs,
            "--out", "m", "--events-out", "ev.jsonl"]
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    out = _cli("repro_torch.launch.merge", *args, "--device", "cpu",
               cwd=tmp_path / "p")
    ref = _cli("repro.launch.merge", *args, cwd=tmp_path / "j")
    assert out == ref
    merged = tmp_path / "p" / "m" / "step_00000000"
    _same_dirs(merged, tmp_path / "j" / "m" / "step_00000000")
    ev = [json.loads(x) for x in open(tmp_path / "p" / "ev.jsonl")]
    jev = [json.loads(x) for x in open(tmp_path / "j" / "ev.jsonl")]
    assert ev == jev and [e["event"] for e in ev] == [
        "contribution_added", "contribution_added", "resolved",
        "checkpoint_written"]
    # the in-process resolve over the same checkpoints
    like = train_state_shapes(Model(smoke_config(ARCH)))
    r = Replica("in-process", device="cpu")
    for p in inputs:
        r.contribute(ckpt.restore_checkpoint(p, like,
                                             device="cpu")[0]["params"])
    base = ckpt.restore_checkpoint(str(tmp_path / "base/step_00000000"),
                                   like, device="cpu")[0]["params"]
    want = r.resolve(MergeSpec("ties"), base=base)
    got, meta = ckpt.restore_checkpoint(str(merged), like, device="cpu")
    assert meta["strategy"] == "ties" and meta["merged_from"] == inputs
    assert all(torch.equal(a, b) for a, b in
               zip(pytree.leaves(got["params"]), pytree.leaves(want)))
    assert all(int(t.abs().max()) == 0 for t in
               pytree.leaves(got["m"]) + pytree.leaves(got["v"]))


def test_clis_default_to_cuda_and_refuse_meshes():
    from repro_torch.launch import merge, train
    with pytest.raises(SystemExit):
        train.main(["--arch", ARCH, "--smoke", "--mesh", "2x1",
                    "--device", "cpu"])
    if torch.cuda.is_available():
        pytest.skip("the default-device checks are for a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", ARCH, "--smoke", "--steps", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        merge.main(["--arch", ARCH, "--smoke", "--inputs", "x", "--out",
                    "y"])
