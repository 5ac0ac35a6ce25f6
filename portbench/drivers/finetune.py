"""Fine-tune steps in a closed loop: the train step a contributing
organisation runs before it contributes (`train/step.py:make_train_step`
over `models/model.py:Model`, AdamW from `optim/adamw.py`).

Set-up builds one train step and one state from the seed's weights
(made by the benchmark), and drives it through the check's first steps
with the window's own call and feed: after step 1 each leaf's first
clipped gradient is read from Adam's first moment (m_1 = (1 - beta1) g),
and after the last each leaf's change from the seed's weights, its norm
and its values at flat indices drawn from the seed. The
window then runs steps on that same object, each on a new batch drawn
from the seed, until `seconds` have passed and a step has ended;
`train_tokens_per_s` is the tokens of every step completed over the
time from the window's start to the last step's end. Once the window has
closed and the program's state is freed, the plain reference follows
the first steps from the same weights and batches.

Traffic keys: batch, seq_len, microbatches, check_steps, total_steps,
sample_blocks and sample_width (each leaf's sampled elements of its
change), trace_steps and trace_after (the share of the window after
which the traced run profiles `trace_steps` steps).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List

import torch

from portbench import checks, common, gen, peaks
from portbench.devtrace import Spans, stretch, Trace
from portbench.reference import layout as L
from portbench.reference import merge as refmerge
from portbench.reference import train as reftrain


def _opt(config: Dict, traffic: Dict) -> Dict:
    return dict(config["optimizer"], learning_rate=config["learning_rate"],
                warmup_steps=config["warmup_steps"],
                total_steps=traffic["total_steps"])


def sample(lay, seed: int, traffic: Dict) -> Dict[str, torch.Tensor]:
    """Each leaf's flat indices at which both sides' change is compared:
    its first and last `sample_width` elements and `sample_blocks`
    seeded blocks."""
    g = torch.Generator().manual_seed(gen.sub_seed(seed, "update sample"))
    return {leaf.key: refmerge.sample_columns(
        leaf.numel, traffic["sample_blocks"], traffic["sample_width"], g)
        for leaf in lay}


def facts_of(config: Dict, traffic: Dict) -> Dict:
    """Shapes and useful flops of one step (for the per-layer readers)."""
    b, s = traffic["batch"], traffic["seq_len"]
    attn = config["family"] == "dense"
    return {
        "step_flops": peaks.train_step_flops(
            L.non_embedding_params(config), b * s,
            config["n_layers"] if attn else 0, config.get("n_heads", 0),
            config.get("head_dim", 0), b, s),
        "b9_shape": ((b // traffic["microbatches"], s, config["n_heads"],
                      config["head_dim"]) if attn else None),
    }


def run(cell, *, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict:
    from repro_torch.models.model import Model
    from repro_torch.optim.adamw import B1
    from repro_torch.train.step import init_train_state, make_train_step
    config, traffic = cell.config, cell.traffic
    b, s = traffic["batch"], traffic["seq_len"]
    vocab = config["vocab_size"]
    stamp = common.Stamps(t_start)
    lay = L.layout(config)
    model = Model(common.port_config(config))
    common.check_layout(model, lay)
    spans = Spans()
    stamp("imports and model")

    def batch(step: int) -> Dict:
        return {"tokens": gen.tokens(seed, step, b, s, vocab, device)}

    params = L.nest(gen.params(lay, seed, device))
    state = init_train_state(model, params=params, device=device)
    del params
    common.sync(device)
    stamp("weights and state")
    train_step = make_train_step(model, total_steps=traffic["total_steps"],
                                 grad_accum=traffic["microbatches"])
    prog: Dict = {"loss": [], "grad_norm": [], "grad1": {}, "change": {},
                  "change_sample": {}}
    idx = sample(lay, seed, traffic)
    for step in range(1, traffic["check_steps"] + 1):
        state, mets = train_step(state, batch(step))
        prog["loss"].append(float(mets["loss"]))
        prog["grad_norm"].append(float(mets["grad_norm"]))
        stamp(f"check step {step}")
        if step == 1:
            for leaf in lay:
                m = L.at(state["m"], leaf.path)
                prog["grad1"][leaf.key] = math.sqrt(common.sq_norm(m)) \
                    / (1.0 - B1)
    for leaf in lay:
        d = gen.leaf_f32(leaf, seed, "init", device).sub_(
            L.at(state["params"], leaf.path))
        prog["change"][leaf.key] = math.sqrt(common.sq_norm(d))
        prog["change_sample"][leaf.key] = d.reshape(-1)[
            idx[leaf.key].to(d.device)].cpu()
        del d
    common.sync(device)
    stamp("change norms")
    stamp.report()
    setup_s = time.perf_counter() - t_start

    traces: List[Trace] = []
    step = traffic["check_steps"]
    common.reset_peak(device)
    t0 = time.perf_counter()
    traced = not trace
    while True:
        if not traced and time.perf_counter() - t0 \
                >= traffic["trace_after"] * seconds:
            traced = True
            with stretch(spans, {}, traces, device):
                for _ in range(traffic["trace_steps"]):
                    step += 1
                    with spans.span("step"):
                        with spans.span("feed"):
                            bt = batch(step)
                        with spans.span("train_step"):
                            state, _ = train_step(state, bt)
                        with spans.span("sync"):
                            common.sync(device)
        else:
            step += 1
            state, _ = train_step(state, batch(step))
            common.sync(device)
        done = time.perf_counter()
        if done - t0 >= seconds:
            break
    steps = step - traffic["check_steps"]
    window_s = done - t0
    peak = common.memory_peak(device)
    del state, train_step, model
    common.free()

    t_ref = time.perf_counter()
    ref = reftrain.run(config, lay, seed,
                       [gen.tokens(seed, i, b, s, vocab, device)
                        for i in range(1, traffic["check_steps"] + 1)],
                       _opt(config, traffic), device, idx)
    _report(prog, ref, time.perf_counter() - t_ref)
    facts = facts_of(config, traffic)
    return {
        "setup_s": setup_s,
        "e2e": {"train_tokens_per_s": steps * b * s / window_s},
        "attempted": steps, "failed": 0,
        "checks": checks.with_limits(checks.training(prog, ref),
                                     cell.limits),
        "memory_peak_bytes": peak,
        "view": common.View(cell, traces[0] if traces else None, facts),
    }


def _report(prog: Dict, ref: Dict, seconds: float) -> None:
    """Each step's readings and the three farthest leaves of each norm,
    on standard error (ahead of the checks)."""
    import statistics
    import sys
    print(f"reference: {seconds:.1f} s", file=sys.stderr)
    print(f"steps: loss {prog['loss']} / reference {ref['loss']}; grad "
          f"norm {prog['grad_norm']} / {ref['grad_norm']}", file=sys.stderr)
    for name in ("grad1", "change"):
        med = statistics.median(ref[name].values())
        gaps = sorted(((abs(prog[name][k] - ref[name][k])
                        / max(ref[name][k], med), k) for k in ref[name]),
                      reverse=True)[:3]
        print(f"{name}: " + "; ".join(
            f"{k} {g:.3e} ({prog[name][k]:.6e} / {ref[name][k]:.6e})"
            for g, k in gaps), file=sys.stderr)
