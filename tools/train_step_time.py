"""Phi-3-mini's train step of a checkout, timed and traced on one CUDA
card as `chip_smoke.py`'s [train] phase runs it, with the loss's tail
timed on its own.

    python3 tools/train_step_time.py [--root DIR] [--layers N]

Needs one CUDA card and `nvcc`. Prints the card's name and power limit
first, then one `[step]` line per reading and, last, one JSON object of
the readings.

  step   DIR's `src/repro_torch` (default: this checkout; its kernels
         build under DIR/build/): Phi-3-mini at full width and N of its
         32 layers (default 32), fp32 parameters and moments, bf16
         compute, remat, from `init_from_schema(seed 0)`; `make_train_step`
         at `chip_smoke.py`'s TRAIN_BATCH x TRAIN_SEQ in TRAIN_ACCUM
         microbatches on `SyntheticTask` batches, TRAIN_STEPS steps, the
         last traced by `chip_smoke.trace_device` (device busy time by
         kernel group, idle share). Per step: seconds, peak device memory.
  tail   `Model.loss` of one microbatch with the layer stack taken out
         (the embedding, the final norm, the output head and the
         cross-entropy, as DIR's model computes them), forward and
         backward to the embedding, final norm and head in the compute
         dtype, timed by `chip_smoke.cuda_ms`, with its peak memory over
         what it was given.

Point DIR at an unpacked older commit to time its step by the same
clock; run two checkouts in turns (parent, change, change, parent) to
compare them.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))
# first: it sets the allocator's and cuBLAS's environment before torch
import chip_smoke  # noqa: E402  (the constants, tracer and clock)
import torch  # noqa: E402


def step_readings(cfg, out: dict) -> None:
    from repro_torch import pytree
    from repro_torch.data.synthetic import SyntheticTask
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    from repro_torch.train.step import init_train_state, make_train_step
    model = Model(cfg)
    state = init_train_state(model, params=init_from_schema(
        model.schema(), seed=chip_smoke.SEED, device="cuda"), device="cuda")
    n = sum(t.numel() for t in pytree.leaves(state["params"]))
    step_fn = make_train_step(model, total_steps=chip_smoke.TRAIN_STEPS,
                              grad_accum=chip_smoke.TRAIN_ACCUM)
    task = SyntheticTask(cfg.vocab_size, chip_smoke.TRAIN_SEQ, task_id=0)
    tokens = chip_smoke.TRAIN_BATCH * chip_smoke.TRAIN_SEQ
    steps = []
    for i in range(chip_smoke.TRAIN_STEPS):
        batch = {"tokens": torch.as_tensor(
            task.batch(i, chip_smoke.TRAIN_BATCH), device="cuda")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

        def step(batch=batch):
            step_fn(state, batch)
            torch.cuda.synchronize()

        last = i == chip_smoke.TRAIN_STEPS - 1
        t0 = time.perf_counter()
        if last:
            out["trace"] = chip_smoke.trace_device(
                f"train step {i + 1}", step, tag="step", host=False)
        else:
            step()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        steps.append({"s": dt, "peak_gb": peak, "traced": last})
        print(f"[step] {cfg.n_layers} layers, {n:,} parameters: step "
              f"{i + 1} {dt:.3f} s{' (traced)' if last else ''}, "
              f"{tokens / dt:.0f} tokens/s, peak {peak:.2f} GB", flush=True)
    out["steps"] = steps
    del state
    gc.collect()
    torch.cuda.empty_cache()


def tail_readings(cfg, out: dict, device: str = "cuda") -> None:
    from repro_torch import pytree
    from repro_torch.models.model import Model
    from repro_torch.models.schema import init_from_schema
    model = Model(cfg)
    model._run_stack = lambda params, x, **kw: (x, None)   # the tail alone
    cd = model.compute_dtype
    schema = {k: v for k, v in model.schema().items() if k != "blocks"}
    params = init_from_schema(schema, seed=chip_smoke.SEED, device=device,
                              dtype=cd)
    leaves = pytree.leaves(params)
    for t in leaves:
        t.requires_grad_()
    d, v = cfg.d_model, cfg.vocab_size
    g = torch.Generator(device=device).manual_seed(0)
    mb = chip_smoke.TRAIN_BATCH // chip_smoke.TRAIN_ACCUM
    batch = {"tokens": torch.randint(0, v, (mb, chip_smoke.TRAIN_SEQ),
                                     generator=g, device=device)}

    def tail():
        return torch.autograd.grad(model.loss(params, batch)[0], leaves)

    if device != "cuda":                # a check of the set-up alone
        out["tail"] = [tuple(t.shape) for t in tail()]
        return
    tail()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = chip_smoke.cuda_ms(tail, 10)
    extra = (torch.cuda.max_memory_allocated() - held) / 1e9
    out["tail"] = {"ms": ms, "peak_over_inputs_gb": extra}
    print(f"[step] the loss's tail (embedding, final norm, head [{d}, {v}], "
          f"cross-entropy; forward and backward) at [{mb}, "
          f"{chip_smoke.TRAIN_SEQ}]: {ms:.3f} ms, peak {extra:.2f} GB over "
          f"its inputs", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=HERE)
    ap.add_argument("--layers", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("train_step_time: CUDA is not available", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    for name in [m for m in sys.modules if m.startswith("repro_torch")]:
        del sys.modules[name]
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[2] != root:
        raise RuntimeError(f"imported {repro_torch.__file__}, not {root}")
    from repro_torch.configs import get_config
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("phi3-mini-3.8b").replace(n_layers=args.layers)
    out: dict = {"root": str(root), "layers": args.layers}
    tail_readings(cfg, out)
    step_readings(cfg, out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
