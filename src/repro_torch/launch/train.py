"""Training CLI (`repro.launch.train`): a single-branch trainer with
checkpoint / restart and deterministic data cursors. For the
decentralised multi-branch flow see `repro_torch.train.btm`.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \
      --smoke --steps 20 --ckpt-dir /tmp/ckpt --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-8b \
      --smoke --steps 40 --ckpt-dir /tmp/ckpt --resume --device cpu

The reference's flags, plus `--device` (CUDA unless another is named;
without CUDA the default raises). The parameters are the reference's bit
for bit (`Model.init`, whose threefry draws on the host: minutes at a
full-size model). `--mesh` takes 1x1 only: the port runs on one card,
and meshes beyond it are out of scope (ROADMAP, "Out of scope").
The state is updated in place, step by step (the reference donates
it).
"""
from __future__ import annotations

import argparse
import os
import time

import torch

from repro_torch import random as prng
from repro_torch.api.replica import resolve_device
from repro_torch.checkpoint import (latest_checkpoint, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.synthetic import SyntheticTask
from repro_torch.models.model import Model
from repro_torch.train.step import init_train_state, make_train_step


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1",
                    help="data x model; only 1x1 (one card)")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--task", type=int, default=0,
                    help="synthetic task id (branch divergence for merging)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise SystemExit(f"--mesh {args.mesh}: the port runs 1x1 only, on "
                         "one card; meshes beyond 1x1 are out of scope "
                         "(ROADMAP, \"Out of scope\")")
    # torch's deterministic mode (the train step's, on CUDA) asks for it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(grad_accum=max(1, min(cfg.grad_accum, args.batch)))
    model = Model(cfg)
    state = init_train_state(model, prng.PRNGKey(0), device=device)
    start_step = 0
    if args.resume and args.ckpt_dir:
        path = latest_checkpoint(args.ckpt_dir)
        if path:
            state, meta = restore_checkpoint(path, state, device=device)
            start_step = int(meta["data_step"])
            print(f"resumed from {path} at data step {start_step}")

    step_fn = make_train_step(model, total_steps=args.steps)
    task = SyntheticTask(cfg.vocab_size, args.seq, task_id=args.task)
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = {"tokens": torch.as_tensor(task.batch(step, args.batch),
                                           device=device)}
        state, mets = step_fn(state, batch)
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {float(mets['loss']):.4f} "
                  f"gnorm {float(mets['grad_norm']):.3f} "
                  f"({dt:.1f}s)", flush=True)
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, state, step + 1,
                            metadata={"data_step": step + 1,
                                      "arch": cfg.name})
    if args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, state, args.steps,
                        metadata={"data_step": args.steps,
                                  "arch": cfg.name})
    print("done")


if __name__ == "__main__":
    main()
