"""Seeded inputs: weights, contributions, token batches and the merge
request stream. The same seed gives the same inputs, on the device, in
one large call a leaf. Copied in spirit from `chip_smoke.py:make_models`
(a seeded base and contributions base + 0.1 x delta), made here by the
benchmark itself so that the program and the reference are handed the
same tensors.
"""
from __future__ import annotations

import hashlib
import random
from typing import Dict, Iterator, List, Tuple

import torch

from portbench.reference.layout import Leaf


def sub_seed(seed: int, *salt) -> int:
    """A 63-bit seed for one stream: SHA-256 of the run's seed and a
    salt (any size of seed, any salt)."""
    text = ":".join(str(x) for x in (seed,) + salt)
    return int.from_bytes(hashlib.sha256(text.encode()).digest()[:8],
                          "big") & (2 ** 63 - 1)


def generator(device, seed: int, *salt) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, *salt))
    return g


def leaf_f32(leaf: Leaf, seed: int, salt: str, device) -> torch.Tensor:
    """One leaf in fp32 by its initial law; a "normal" leaf is one draw
    of its whole shape."""
    if leaf.init == "ones":
        return torch.ones(leaf.shape, dtype=torch.float32, device=device)
    if leaf.init == "zeros":
        return torch.zeros(leaf.shape, dtype=torch.float32, device=device)
    g = generator(device, seed, salt, leaf.key)
    return torch.randn(leaf.shape, generator=g, dtype=torch.float32,
                       device=device).mul_(leaf.scale)


def delta_f32(leaf: Leaf, seed: int, j: int, device) -> torch.Tensor:
    """Contribution j's fine-tune direction on one leaf: N(0, s^2) on
    every leaf (norms and biases too), s the leaf's scale or 0.02."""
    g = generator(device, seed, "delta", j, leaf.key)
    return torch.randn(leaf.shape, generator=g, dtype=torch.float32,
                       device=device).mul_(leaf.scale or 0.02)


def params(layout: List[Leaf], seed: int, device
           ) -> Dict[Tuple[str, ...], torch.Tensor]:
    """{path: tensor}: a model's initial parameters in fp32."""
    return {leaf.path: leaf_f32(leaf, seed, "init", device)
            for leaf in layout}


def merge_inputs(layout: List[Leaf], seed: int, k: int, scale: float,
                 dtype: torch.dtype, device
                 ) -> Tuple[Dict, List[Dict]]:
    """(base, [k contributions]) as {path: tensor} in `dtype`:
    contribution j = base + scale x delta_j, summed in fp32 and rounded
    once."""
    base: Dict = {}
    contribs: List[Dict] = [{} for _ in range(k)]
    for leaf in layout:
        b = leaf_f32(leaf, seed, "init", device)
        base[leaf.path] = b.to(dtype)
        for j in range(k):
            d = delta_f32(leaf, seed, j, device)
            contribs[j][leaf.path] = d.mul_(scale).add_(b).to(dtype)
            del d
        del b
    return base, contribs


def tokens(seed: int, step: int, batch: int, seq_len: int, vocab: int,
           device) -> torch.Tensor:
    """[batch, seq_len] int64 token ids of training step `step`
    (1-based), uniform over the vocabulary: every step's rows differ."""
    g = generator(device, seed, "tokens", step)
    return torch.randint(0, vocab, (batch, seq_len), generator=g,
                         dtype=torch.int64, device=device)


def merge_requests(seed: int, mix: List[Dict]) -> Iterator[Dict]:
    """Endless merge requests in rounds: each round holds one request of
    every entry of `mix`, in a seeded order, so every seed gives the same
    work in another order. A request is {"strategy", "cfg"}: the entry's
    fixed cfg plus each `draw` key drawn uniformly from its [lo, hi]."""
    rng = random.Random(sub_seed(seed, "requests"))
    while True:
        order = list(range(len(mix)))
        rng.shuffle(order)
        for i in order:
            entry = mix[i]
            cfg = dict(entry.get("cfg", {}))
            for name, (lo, hi) in sorted(entry.get("draw", {}).items()):
                cfg[name] = rng.uniform(lo, hi)
            yield {"strategy": entry["strategy"], "cfg": cfg}
