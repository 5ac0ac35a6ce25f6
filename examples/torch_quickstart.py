"""Quickstart on the PyTorch port: CRDT-compliant model merging in ~60
lines (the port of `examples/quickstart.py`).

Three 'institutions' fine-tune the same tiny model, contribute their
weights into Replica objects, gossip in arbitrary order, and all
resolve the IDENTICAL merged model — for any of the 26 strategies,
including stochastic ones (DARE) and order-dependent folds (SLERP). The
replicas' Merkle roots and derived seeds are the JAX package's, byte
for byte.

  PYTHONPATH=src python examples/torch_quickstart.py
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Runs on CUDA unless `--device` names another device.
"""
import argparse

import numpy as np
import torch

from repro_torch.api import MergeSpec, Replica
from repro_torch.api.replica import resolve_device
from repro_torch.core.resolve import seed_from_root
from repro_torch.strategies import list_strategies


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    base = torch.from_numpy((rng.standard_normal((64, 64)) * 0.02)
                            .astype(np.float32)).to(device)
    fine_tunes = [base + torch.from_numpy(
        (rng.standard_normal((64, 64)) * 0.01).astype(np.float32)).to(device)
        for _ in range(3)]

    # each institution has its own replica and contributes independently
    replicas = [Replica(f"inst{i}", device=device) for i in range(3)]
    for rep, ft in zip(replicas, fine_tunes):
        rep.contribute(ft)

    # deliver in two different orders (network reordering)
    a = Replica("obs-a", device=device).merge(replicas[0]) \
        .merge(replicas[1]).merge(replicas[2])
    b = Replica("obs-b", device=device).merge(replicas[2]) \
        .merge(Replica("tmp", device=device).merge(replicas[0])
               .merge(replicas[1]))
    assert a.merkle_root() == b.merkle_root()
    print(f"converged state: {a}")
    print(f"merkle root:     {a.merkle_root().hex()[:16]}…")
    print(f"derived seed:    {seed_from_root(a.merkle_root())}")

    # a MergeSpec validates its cfg against the strategy's schema:
    # MergeSpec("ties", {"tirm": 0.3}) raises with a did-you-mean.
    print(f"\n{'strategy':26s} identical-on-both-replicas")
    for strat in ("weight_average", "ties", "dare", "slerp",
                  "task_arithmetic", "evolutionary_merge"):
        spec = MergeSpec(strat)
        ra = a.resolve(spec, base=base, use_cache=False)
        rb = b.resolve(spec, base=base, use_cache=False)
        print(f"{strat:26s} {torch.equal(ra, rb)}")

    # retraction: OR-Set remove
    victim = sorted(a.visible())[0]
    before = len(a.visible())
    a.retract(victim)
    print(f"\nafter retraction: |visible| {before} -> {len(a.visible())}")
    print(f"all {len(list_strategies())} strategies available: "
          f"{', '.join(list_strategies()[:6])}, …")


if __name__ == "__main__":
    main()
