"""Train-step factory: microbatched gradient accumulation + AdamW
(`repro.train.step`).

The step is a function over a plain-dict TrainState {'params', 'm', 'v',
'step'}. Microbatch i is rows [i B / accum, (i + 1) B / accum) of the
batch, as the reference's reshape takes them; gradients are summed in
microbatch order from zero and divided by `accum` once, with the sum in
fp32 (bf16 when the moments are not fp32), as the reference's scan.

Departures, all for memory at full width, none in the arithmetic:
  * the state is updated IN PLACE and returned (the reference returns a
    new state): parameters, moments and the step counter. A caller that
    keeps a reference to a tree it passes in (a contribution, a cached
    merge) clones it first;
  * gradients accumulate straight into `.grad` buffers, views of one
    stacked gradient tree: each layer's parameters enter the model as
    views of the stacked leaves that are autograd leaves of their own,
    so a layer's gradient lands in its slice with no full-size
    temporary (when the sum's dtype is the parameters', which is every
    config's default; otherwise each microbatch's gradient is added to
    a separate accumulator in that dtype, as the reference does);
  * on CUDA the forward and backward run under
    `torch.use_deterministic_algorithms` (the embedding's and the
    cross-entropy's gathers scatter their gradients without atomics
    there), so a run and its resumption give the same bits; cuBLAS is
    deterministic on one stream, and torch's mode asks for
    `CUBLAS_WORKSPACE_CONFIG`, which the step sets when the caller did
    not.
"""
from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import pytree
from repro_torch.dtypes import BY_NAME
from repro_torch.models.model import Model
from repro_torch.models.schema import meta_from_schema
from repro_torch.optim.adamw import adamw_update, init_opt_state


def init_train_state(model: Model, key=None, *, params: Any = None,
                     device: Any = "cuda") -> Dict:
    """The reference's `init_train_state(model, key)`: parameters from
    `model.init(key)` (bitwise the reference's), or the `params` given
    (the chip smoke's seeded full-size models), cast to the config's
    param dtype; zero moments; step 0."""
    cfg = model.cfg
    if params is None:
        params = model.init(key, device=device)
    if cfg.param_dtype != "float32":
        dt = BY_NAME[cfg.param_dtype]
        params = pytree.tree_map(lambda p: p.to(dt), params)
    opt = init_opt_state(params, cfg.opt_state_dtype)
    dev = pytree.leaves(params)[0].device
    return {"params": params, "m": opt["m"], "v": opt["v"],
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_state_shapes(model: Model) -> Dict:
    """The TrainState's shapes and dtypes as meta tensors (no
    allocation)."""
    cfg = model.cfg
    params = meta_from_schema(model.schema(), BY_NAME[cfg.param_dtype])
    opt = init_opt_state(params, cfg.opt_state_dtype)
    return {"params": params, "m": opt["m"], "v": opt["v"],
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def _leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A view of p that is an autograd leaf accumulating into g."""
    t = p.detach().requires_grad_(True)
    t.grad = g
    return t


def _grad_views(params: Dict, grads: Dict, n_periods: int) -> Dict:
    """The model's params as autograd leaves whose .grad are views of
    `grads`; the stacked blocks become a list of per-layer dicts."""
    out = {}
    for name, sub in params.items():
        if name == "blocks":
            out[name] = {
                s: [pytree.tree_map(lambda p, g, i=i: _leaf(p[i], g[i]),
                                    sub[s], grads[name][s])
                    for i in range(n_periods)]
                for s in sub}
        else:
            out[name] = pytree.tree_map(_leaf, sub, grads[name])
    return out


@contextlib.contextmanager
def _deterministic(device: torch.device):
    if device.type != "cuda":
        yield
        return
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    det = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    fill = torch.utils.deterministic.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(det, warn_only=warn)
        torch.utils.deterministic.fill_uninitialized_memory = fill


def make_train_step(model: Model, total_steps: int = 10000,
                    grad_accum: int = 0):
    cfg = model.cfg
    accum = grad_accum or cfg.grad_accum
    cd = model.compute_dtype

    def loss_fn(params, mb):
        if cfg.cast_params_for_loss:
            params = pytree.tree_map(
                lambda p: p.to(cd) if p.dtype == torch.float32 else p,
                params)
        return model.loss(params, mb)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        device = state["step"].device
        tokens = torch.as_tensor(batch["tokens"], device=device)
        acc_dtype = (torch.float32 if cfg.opt_state_dtype == "float32"
                     else torch.bfloat16)
        n = max(accum, 1)
        if tokens.shape[0] % n:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"{n} microbatches")
        per = tokens.shape[0] // n
        direct = n == 1 or all(p.dtype == acc_dtype
                               for p in pytree.leaves(params))
        grads = pytree.tree_map(torch.zeros_like, params)
        acc: Optional[Any] = None if direct else pytree.tree_map(
            lambda p: torch.zeros(p.shape, dtype=acc_dtype, device=p.device),
            params)
        ce_sum = torch.zeros((), dtype=torch.float32, device=device)
        aux_sum = torch.zeros((), dtype=torch.float32, device=device)
        with _deterministic(device):
            for i in range(n):
                if not direct and i:
                    for g in pytree.leaves(grads):
                        g.zero_()
                live = _grad_views(params, grads, model.n_periods)
                loss, mets = loss_fn(live, {"tokens":
                                            tokens[i * per:(i + 1) * per]})
                loss.backward()
                del live, loss
                if n == 1:
                    ce_sum = mets["ce"].detach()
                    aux_sum = mets["aux"].detach()
                else:
                    ce_sum = ce_sum + mets["ce"].detach()
                    aux_sum = aux_sum + mets["aux"].detach()
                if not direct:
                    for a, g in zip(pytree.leaves(acc), pytree.leaves(grads)):
                        a.add_(g.to(acc_dtype))
        if not direct:
            grads = acc
        if n > 1:
            for g in pytree.leaves(grads):
                g.div_(n)
            ce_sum, aux_sum = ce_sum / n, aux_sum / n
        _, _, gnorm = adamw_update(params, {"m": state["m"], "v": state["v"]},
                                   grads, state["step"], cfg, total_steps)
        del grads, acc
        state["step"] += 1
        return state, {"loss": ce_sum, "aux": aux_sum, "grad_norm": gnorm}

    return train_step
