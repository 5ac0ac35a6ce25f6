"""Consortium simulation on the PyTorch port (the port of
`examples/decentralized_consortium.py`): 10 institutions, network
partitions, a Byzantine contribution, delta-state gossip.

Trust gating rides the typed API: evidence lands on a Replica via
report(), and the trust threshold is part of the MergeSpec — so the
gated resolve runs through the same planner/executor engine as every
other resolve, and every honest replica derives the identical gated
model. The contributions' element ids and the gossip's byte counts are
the JAX package's.

  PYTHONPATH=src python examples/torch_decentralized_consortium.py
  PYTHONPATH=src python examples/torch_decentralized_consortium.py \
      --device cpu

Runs on CUDA unless `--device` names another device.
"""
import argparse

import numpy as np
import torch

from repro_torch.api import MergeSpec, Replica
from repro_torch.api.replica import resolve_device
from repro_torch.core.gossip import GossipNetwork


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    n = 10
    net = GossipNetwork(n, seed=0, use_deltas=True, device=device)
    base = rng.standard_normal((128, 128)).astype(np.float32) * 0.02

    # 9 honest fine-tunes + 1 poisoned contribution
    for i, node in enumerate(net.nodes):
        tau = rng.standard_normal((128, 128)).astype(np.float32) * 0.01
        if i == 7:
            tau = tau * 400.0           # poisoned: absurd task vector
        node.contribute(torch.from_numpy(base + tau).to(device))

    # the consortium splits into two data centers (partition)
    net.partition([range(0, 5), range(5, 10)])
    net.all_pairs_round()
    print("during partition: distinct roots =", len(set(net.roots())))

    # healing
    net.heal()
    net.all_pairs_round()
    assert net.converged()
    print(f"healed: all {n} nodes converged "
          f"(delta gossip sent {net.bytes_sent/1e6:.2f} MB)")

    # Byzantine detection: honest nodes report the outlier; trust
    # evidence is itself a (grow-only) CRDT, so gating decisions
    # converge too. A Replica carries the evidence; the threshold
    # travels in the MergeSpec.
    rep = Replica("auditor", device=device).merge(net.nodes[0].state)
    scores = {eid: float(rep.state.store[eid].abs().max())
              for eid in rep.visible()}
    outlier = max(scores, key=scores.get)
    for reporter in ("node000", "node001", "node002"):
        rep.report(outlier, "statistical_outlier", reporter)
    print(f"flagged contribution {outlier[:12]}… "
          f"(|max|={scores[outlier]:.1f}, "
          f"trust={rep.trust.score(outlier):.2f})")

    base_t = torch.from_numpy(base).to(device)
    gated = MergeSpec("ties", trust_threshold=0.5)
    clean = rep.resolve(gated, base=base_t)
    dirty = rep.resolve(MergeSpec("ties"), base=base_t)
    clean_max = float(clean.abs().max())
    print(f"resolve with trust gate: |max|={clean_max:.3f}"
          f"  vs ungated: |max|={float(dirty.abs().max()):.3f}")
    print("gated merge excludes the poisoned model deterministically on "
          "every honest node.")


if __name__ == "__main__":
    main()
