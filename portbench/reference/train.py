"""Plain reference of the first training steps: the model's loss
(`dense` or `ssm`, by the configuration's `reference`), its gradient by
autograd, a row of the batch at a time, and AdamW (Loshchilov and
Hutter) with global-norm clipping and a warmed-up cosine schedule, with
the hyper-parameters the configuration file states. In fp32 with TF32
off; `precision="fp8"` rounds every product's operands to float8 e4m3
(scaled per tensor), the control one step below the configuration's
bf16 products.

Returns what the comparison reads: each step's loss and global
gradient norm (before clipping), each leaf's norm of the first clipped
gradient, and each leaf's norm of the change of its parameters over
the steps, with that change at the leaf's sampled flat indices.
Faults for the control's checks: "half" leaves the second half of
every batch out (the mean over the rest), "frozen" leaves one leaf's
update out.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import torch

from portbench import gen
from portbench.reference.layout import Leaf

E4M3_MAX = 448.0


def mm_fp32(a, b):
    return a @ b


def _fp8(x):
    """x with its values rounded to e4m3 at a per-tensor scale; the
    gradient passes straight through."""
    s = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(x.dtype) * s
    return x + (q - x).detach()


def mm_fp8(a, b):
    return _fp8(a) @ _fp8(b)


def lr_at(step: int, opt: Dict) -> float:
    """The learning rate of the step counted from 0: linear warm-up,
    then cosine over `total_steps`."""
    warm = min(1.0, (step + 1) / max(opt["warmup_steps"], 1))
    prog = min(max(step / max(opt["total_steps"], 1), 0.0), 1.0)
    return opt["learning_rate"] * warm * 0.5 * (1.0 + math.cos(math.pi
                                                               * prog))


def _sq(t: torch.Tensor) -> float:
    return float(torch.sum(t.double() ** 2)) if t.numel() < (1 << 24) \
        else sum(float(torch.sum(p.double() ** 2))
                 for p in t.reshape(-1).split(1 << 24))


def _live(p: Dict, grads: Dict) -> Dict:
    """The parameters as autograd leaves whose gradients land in
    `grads`: a stacked leaf of layers as one view a layer, so that a
    layer's gradient fills its slice and no full-size gradient is made
    for each layer."""
    def leaf(t, g):
        t = t.detach().requires_grad_(True)
        t.grad = g
        return t
    return {k: ([leaf(t[i], grads[k][i]) for i in range(t.shape[0])]
                if k[0] == "blocks" else leaf(t, grads[k]))
            for k, t in p.items()}


def run(cfg: Dict, layout: List[Leaf], seed: int, batches: Sequence,
        opt: Dict, device, sample: Dict[str, torch.Tensor],
        precision: str = "fp32", fault: str = "") -> Dict:
    """`batches`: the steps' token batches [B, S], in order; `sample`:
    each leaf's flat indices at which the change is returned."""
    from portbench import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mm: Callable = {"fp32": mm_fp32, "fp8": mm_fp8}[precision]
    row_loss = registry.reference(cfg["reference"]).row_loss
    p = gen.params(layout, seed, device)
    grads = {k: torch.zeros_like(t) for k, t in p.items()}
    m = {k: torch.zeros_like(t) for k, t in p.items()}
    v = {k: torch.zeros_like(t) for k, t in p.items()}
    live = _live(p, grads)
    frozen = layout[len(layout) // 2].path if fault == "frozen" else None
    losses, gnorms = [], []
    grad1: Dict[str, float] = {}
    for step, toks in enumerate(batches, start=1):
        rows = toks.shape[0] // 2 if fault == "half" else toks.shape[0]
        total = 0.0
        for r in range(rows):
            loss = row_loss(cfg, live, toks[r], mm) / rows
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        gn = math.sqrt(sum(_sq(t) for t in grads.values()))
        gnorms.append(gn)
        clip = min(1.0, opt["clip_norm"] / (gn + 1e-12))
        lr = lr_at(step - 1, opt)
        c1 = 1.0 - opt["beta1"] ** step
        c2 = 1.0 - opt["beta2"] ** step
        with torch.no_grad():
            for leaf in layout:
                k = leaf.path
                g = grads[k].mul_(clip)
                if step == 1:
                    grad1[leaf.key] = math.sqrt(_sq(g))
                m[k].mul_(opt["beta1"]).add_(g, alpha=1 - opt["beta1"])
                v[k].mul_(opt["beta2"]).addcmul_(g, g,
                                                 value=1 - opt["beta2"])
                if k != frozen:
                    for pc, mc, vc in zip(*(t.view(-1).split(1 << 26)
                                            for t in (p[k], m[k], v[k]))):
                        upd = (mc / c1).div_((vc / c2).sqrt_()
                                             .add_(opt["eps"]))
                        upd.add_(pc, alpha=opt["weight_decay"])
                        pc.sub_(upd, alpha=lr)
                        del upd
                g.zero_()
    change: Dict[str, float] = {}
    change_sample: Dict[str, torch.Tensor] = {}
    with torch.no_grad():
        for leaf in layout:
            d = gen.leaf_f32(leaf, seed, "init", device).sub_(p[leaf.path])
            change[leaf.key] = math.sqrt(_sq(d))
            change_sample[leaf.key] = d.reshape(-1)[
                sample[leaf.key].to(d.device)].cpu()
            del d
    return {"loss": losses, "grad_norm": gnorms, "grad1": grad1,
            "change": change, "change_sample": change_sample}
