"""Serve a CRDT-merged model on the PyTorch port (the port of
`examples/serve_merged.py`): merge two fine-tunes, batch-decode
requests.

  PYTHONPATH=src python examples/torch_serve_merged.py --arch phi3-mini-3.8b
  PYTHONPATH=src python examples/torch_serve_merged.py \
      --arch qwen3-moe-30b-a3b --device cpu

Runs on CUDA unless `--device` names another device. The models are the
arch's smoke configurations; the base is `Model.init(PRNGKey(0))`, the
JAX package's parameters bit for bit, and every attention call goes to
B9 (on CPU tensors its plain version).
"""
import argparse
import time

import torch

from repro_torch import pytree
from repro_torch import random as prng
from repro_torch.api import MergeSpec, Replica
from repro_torch.api.replica import resolve_device
from repro_torch.configs import ShapeSpec, smoke_config
from repro_torch.data.synthetic import make_batch, SyntheticTask
from repro_torch.models.model import Model
from repro_torch.train.serve import greedy_decode
from repro_torch.train.step import init_train_state, make_train_step


def quick_finetune(model, state, task_id, steps=10):
    """`steps` train steps on a synthetic task; the state is updated in
    place (pass a copy)."""
    step = make_train_step(model, total_steps=steps)
    task = SyntheticTask(model.cfg.vocab_size, 64, task_id=task_id)
    device = state["step"].device
    for i in range(steps):
        state, _ = step(state, {"tokens": torch.as_tensor(
            task.batch(i, 8), device=device)})
    return state


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi3-mini-3.8b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = smoke_config(args.arch).replace(grad_accum=1)
    model = Model(cfg)
    base_state = init_train_state(model, prng.PRNGKey(0), device=device)
    base = base_state["params"]

    def copy(state):
        return pytree.tree_map(lambda t: t.clone(), state)

    print("fine-tuning two branches…")
    ft1 = quick_finetune(model, copy(base_state), 1)
    ft2 = quick_finetune(model, copy(base_state), 2)

    rep = Replica("serve", device=device)
    rep.contribute(ft1["params"])
    rep.contribute(ft2["params"])
    base_ref = rep.register_base(base)
    merged = rep.resolve(MergeSpec("ties", base_ref=base_ref))
    print(f"merged 2 contributions via TIES "
          f"(root {rep.merkle_root().hex()[:12]}…)")

    batch = {k: torch.as_tensor(v, device=device) for k, v in make_batch(
        cfg, ShapeSpec("serve", 16, args.batch, "prefill")).items()}
    t0 = time.time()
    out = greedy_decode(model, merged, batch, steps=args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    print(f"served {args.batch} requests x {args.gen} tokens in {dt:.2f}s "
          f"({args.batch*args.gen/dt:.1f} tok/s)")
    print("sample continuation:", out[0].cpu().numpy())


if __name__ == "__main__":
    main()
