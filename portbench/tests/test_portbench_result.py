"""A run's result line on tiny cells (the CPU, the kernels' plain
versions): its keys, its metrics by name, its checks last; and a run
with the timed path broken underneath comes out not correct, once for
each fault the cell can have."""
import contextlib
import time

import pytest
import torch

import tiny
from portbench import run

CPU = torch.device("cpu")
MERGE = dict(sample_width=64, sample_blocks=2, trace_requests=2)
TRAIN = dict(seq_len=64)


def _run(workload, trace=False, seconds=1.0, **traffic):
    cell = tiny.cell(workload, **traffic)
    return cell, run.run_cell(cell, seed=2 ** 31 + 17, seconds=seconds,
                              trace=trace, device=CPU,
                              t_start=time.perf_counter())


@pytest.mark.parametrize("workload,traffic", [
    ("phi3-merge-sweep", MERGE), ("mamba2-finetune", TRAIN),
    ("phi3-finetune", TRAIN)])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(workload, traffic, trace):
    cell, res = _run(workload, trace, **traffic)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"}
    want = {m["name"] for m in (cell.per_layer if trace
                                else cell.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    else:
        assert {"busy_s", "window_s"} <= set(res["device"])


@contextlib.contextmanager
def patched(module, attr, make):
    import importlib
    mod = importlib.import_module(module)
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


def _merge_unchanged(orig):
    def merge(contribs, *a, base=None, **kw):
        orig(contribs, *a, base=base, **kw)
        return base
    return merge


def _merge_half(orig):
    def merge(contribs, *a, contrib_ids=None, **kw):
        h = len(contribs) // 2
        return orig(contribs[:h], *a, contrib_ids=contrib_ids[:h], **kw)
    return merge


def _merge_altered(orig):
    def merge(*a, **kw):
        out = orig(*a, **kw)
        w = out["blocks"]["sub0"]["attn"]["wo"]
        out["blocks"]["sub0"]["attn"]["wo"] = torch.zeros_like(w)
        return out
    return merge


@pytest.mark.parametrize("fault", [_merge_unchanged, _merge_half,
                                   _merge_altered])
def test_merge_faults_are_not_correct(fault):
    with patched("repro_torch.core.engine", "merge", fault):
        _, res = _run("phi3-merge-sweep", **MERGE)
    assert res["correct"] is False


def _step_unchanged(orig):
    def make(model, **kw):
        step = orig(model, **kw)

        def train_step(state, batch):
            keep = {k: [t.clone() for t in _leaves(state[k])]
                    for k in ("params", "m", "v")}
            state, mets = step(state, batch)
            for k, saved in keep.items():
                for t, s in zip(_leaves(state[k]), saved):
                    t.copy_(s)
            return state, mets
        return train_step
    return make


def _step_half(orig):
    def make(model, **kw):
        step = orig(model, **kw)

        def train_step(state, batch):
            t = batch["tokens"]
            return step(state, {"tokens": t[:t.shape[0] // 2]})
        return train_step
    return make


def _step_altered(orig):
    """One leaf's update undone where the step produces it."""
    def make(model, **kw):
        step = orig(model, **kw)

        def train_step(state, batch):
            w = state["params"]["final_norm"]
            keep = w.clone()
            state, mets = step(state, batch)
            w.copy_(keep)
            return state, mets
        return train_step
    return make


def _step_reversed(orig):
    """Every update applied with the wrong sign: each leaf's change keeps
    its norm, so only the sampled elements can see it."""
    def make(model, **kw):
        step = orig(model, **kw)

        def train_step(state, batch):
            before = [t.clone() for t in _leaves(state["params"])]
            state, mets = step(state, batch)
            for t, b in zip(_leaves(state["params"]), before):
                t.copy_(2 * b - t)
            return state, mets
        return train_step
    return make


def _leaves(tree):
    from repro_torch import pytree
    return pytree.leaves(tree)


@pytest.mark.parametrize("workload", ["mamba2-finetune", "phi3-finetune"])
@pytest.mark.parametrize("fault", [_step_unchanged, _step_half,
                                   _step_altered, _step_reversed])
def test_training_faults_are_not_correct(workload, fault):
    with patched("repro_torch.train.step", "make_train_step", fault):
        _, res = _run(workload, **TRAIN)
    assert res["correct"] is False, res["checks"]
