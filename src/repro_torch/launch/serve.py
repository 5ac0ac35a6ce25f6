"""Batched serving CLI: prefill a prompt batch, decode greedily
(`repro.launch.serve`).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
      --batch 4 --prompt-len 4064 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch phi3-mini-3.8b \
      --smoke --device cpu

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch qwen3-moe-30b-a3b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --arch whisper-tiny \
      --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch llama-3.2-vision-90b --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-v2-236b --smoke --device cpu

Runs on CUDA unless `--device` names another device; without CUDA the
default raises. `make_batch` gives the enc-dec family its frames and the
VLM its patches beside the prompt. Weights come from `init_from_schema(seed=0)`, one seeded
`torch.Generator` per leaf, in the config's parameter dtype (fp32, as
the reference's); the prompt batch from `make_batch`. At full size that
bounds what fits one card: gemma2-27b's 27,227,128,320 fp32 parameters
take 108.9 GB, past an H100's 80 GB, so on one card the CLI serves it
at smoke size only (`chip_smoke.py` serves the full model from bf16
weights, `init_from_schema(..., dtype=torch.bfloat16)`, 54.45 GB), and
so is qwen3-moe-30b-a3b (30,532,110,336 parameters: 122.1 GB in fp32,
61.06 GB in bf16) and deepseek-v2-236b (235,741,434,880 parameters;
`chip_smoke.py` serves 8 of its 60 layers in bf16, 58.38 GB).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.api.replica import resolve_device
from repro_torch.configs import get_config, ShapeSpec, smoke_config
from repro_torch.data.synthetic import make_batch
from repro_torch.models.model import Model
from repro_torch.models.schema import init_from_schema
from repro_torch.train.serve import greedy_decode


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg)
    params = init_from_schema(model.schema(), seed=0, device=device)
    shape = ShapeSpec("serve", args.prompt_len, args.batch, "prefill")
    batch = {k: torch.as_tensor(v, device=device)
             for k, v in make_batch(cfg, shape).items()}
    t0 = time.time()
    out = greedy_decode(model, params, batch, steps=args.gen)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    toks = args.batch * args.gen
    print(f"generated {tuple(out.shape)} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. compile)")
    print("sample:", out[0].cpu().numpy())


if __name__ == "__main__":
    main()
