"""AdamW with configurable moment storage and WSD / cosine schedules
(`repro.optim.adamw`).

Moment storage tiers (opt_state_dtype): float32 (the default), bfloat16,
and int8 (per-row absmax scales over the trailing dim, m and v stored
as int8 with fp32 scales). Updates always compute in fp32.

The arithmetic is the reference's, op for op: the schedule, the bias
corrections 1 - B^t and the clip scale are fp32 scalars on the
parameters' device (no Python float64), and each element's update runs
the reference's expression in its order. The cosine schedule's cos is
the C library's `cosf`, as XLA's CPU code calls it (torch's CPU cos and
CUDA's each differ from it in the last bit at some steps): its argument
makes one trip to the host, once a step. Two
departures, both for memory at full width: `adamw_update` writes the
parameters and moments IN PLACE and returns the same tensors, and it
works through each leaf in slices of whole rows, so its fp32
temporaries are a few slices' worth and never the size of the largest
leaf. `global_norm` sums each leaf's squares slice by slice, in a fixed
order (reduction order differs from XLA's: held to a tolerance).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import math
from typing import Any, Tuple

import torch

from repro_torch import pytree
from repro_torch.configs.base import ModelConfig
from repro_torch.dtypes import BY_NAME

B1, B2, EPS = 0.9, 0.95, 1e-8
WEIGHT_DECAY = 0.1
CLIP_NORM = 1.0
# elements per slice of the in-place update and of the norm's sums
SLICE = 1 << 24

_F32 = torch.float32


def _q8_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantization, block = trailing dim:
    (q int8 of x's shape, fp32 scale of x.shape[:-1])."""
    scale = torch.amax(torch.abs(x), dim=-1, keepdim=True) / 127.0 + 1e-20
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(_F32)[..., 0]


def _dq8_rows(q: torch.Tensor, scale: torch.Tensor, shape=None
              ) -> torch.Tensor:
    return q.to(_F32) * scale[..., None]


def init_opt_state(params: Any, dtype: str = "float32") -> dict:
    if dtype == "int8":
        def zq(p):
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "s": torch.zeros(p.shape[:-1], dtype=_F32,
                                     device=p.device)}
        return {"m": pytree.tree_map(zq, params),
                "v": pytree.tree_map(zq, params)}
    dt = BY_NAME[dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)

    return {"m": pytree.tree_map(zeros, params),
            "v": pytree.tree_map(zeros, params)}


_LIBM = None


def _cosf(x: torch.Tensor) -> torch.Tensor:
    """The C library's cosf of an fp32 scalar tensor, on its device."""
    global _LIBM
    if _LIBM is None:
        lib = ctypes.CDLL(ctypes.util.find_library("m"))
        lib.cosf.restype = ctypes.c_float
        lib.cosf.argtypes = [ctypes.c_float]
        _LIBM = lib
    return _f32(_LIBM.cosf(float(x)), x.device)


def _f32(v: float, device) -> torch.Tensor:
    return torch.tensor(v, dtype=_F32, device=device)


def lr_schedule(step, cfg: ModelConfig, total_steps: int,
                device: Any = None) -> torch.Tensor:
    """The learning rate at `step` (an integer tensor, or a Python int
    taken as an fp32 scalar on `device`), an fp32 0-dim tensor."""
    if torch.is_tensor(step):
        s = step.to(_F32)
    else:
        s = _f32(float(step), device or "cpu")
    one, zero = _f32(1.0, s.device), _f32(0.0, s.device)
    peak = cfg.learning_rate
    warm = torch.minimum(one, (s + 1.0) / max(cfg.warmup_steps, 1))
    if cfg.schedule == "wsd":
        # warmup -> stable -> linear decay over the last 10% of steps
        decay_start = 0.9 * total_steps
        den = _f32(max(total_steps - decay_start, 1.0), s.device)
        frac = torch.clamp((s - decay_start) / den, zero, one)
        return peak * warm * (1.0 - 0.9 * frac)
    prog = torch.clamp(s / max(total_steps, 1), zero, one)
    return peak * warm * 0.5 * (1.0 + _cosf(math.pi * prog))


def _plan(p: torch.Tensor) -> Tuple[int, int]:
    """(width, rows per slice) of p viewed as [rows, trailing dim]:
    slices of about SLICE elements."""
    width = p.shape[-1] if p.dim() else 1
    return width, max(1, SLICE // max(1, width))


def _slices(x: torch.Tensor, width: int, step: int):
    rows = x.reshape(-1, width)
    return [rows[r:r + step] for r in range(0, rows.shape[0], step)]


def _sq_sum(x: torch.Tensor) -> torch.Tensor:
    total = None
    for part in _slices(x, *_plan(x)):
        s = torch.sum(part.to(_F32) ** 2)
        total = s if total is None else total + s
    return total


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for leaf in pytree.leaves(tree):
        total = total + _sq_sum(leaf)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params: Any, opt_state: dict, grads: Any, step,
                 cfg: ModelConfig, total_steps: int
                 ) -> Tuple[Any, dict, torch.Tensor]:
    """Returns (params, opt_state, grad_norm): the same tensors, updated
    in place."""
    gnorm = global_norm(grads)
    dev = gnorm.device
    scale = torch.minimum(_f32(1.0, dev), CLIP_NORM / (gnorm + 1e-12))
    lr = lr_schedule(step, cfg, total_steps, device=dev)
    t = (step.to(_F32) if torch.is_tensor(step)
         else _f32(float(step), dev)) + 1.0
    c1 = 1.0 - torch.pow(_f32(B1, dev), t)
    c2 = 1.0 - torch.pow(_f32(B2, dev), t)
    int8_mode = cfg.opt_state_dtype == "int8"

    flat_p, treedef = pytree.flatten(params)
    flat_m = treedef.flatten_up_to(opt_state["m"])
    flat_v = treedef.flatten_up_to(opt_state["v"])
    flat_g = treedef.flatten_up_to(grads)
    for p, m, v, g in zip(flat_p, flat_m, flat_v, flat_g):
        width, step = _plan(p)
        if int8_mode:
            parts = zip(_slices(p, width, step), _slices(g, width, step),
                        _slices(m["q"], width, step),
                        _slices(m["s"], 1, step),
                        _slices(v["q"], width, step),
                        _slices(v["s"], 1, step))
            for ps, gs, mq, ms, vq, vs in parts:
                m_f = _dq8_rows(mq, ms[:, 0])
                v_f = _dq8_rows(vq, vs[:, 0])
                m32, v32, p_new = _update(ps, m_f, v_f, gs, scale, lr, c1,
                                          c2)
                q, s = _q8_rows(m32)
                mq.copy_(q)
                ms.copy_(s[:, None])
                q, s = _q8_rows(v32)
                vq.copy_(q)
                vs.copy_(s[:, None])
                ps.copy_(p_new.to(ps.dtype))
            continue
        for ps, gs, ms, vs in zip(*(_slices(x, width, step)
                                    for x in (p, g, m, v))):
            m32, v32, p_new = _update(ps, ms.to(_F32), vs.to(_F32), gs,
                                      scale, lr, c1, c2)
            ms.copy_(m32.to(ms.dtype))
            vs.copy_(v32.to(vs.dtype))
            ps.copy_(p_new.to(ps.dtype))
    return params, opt_state, gnorm


def _update(p, m_f, v_f, g, scale, lr, c1, c2):
    """One slice of the reference's update: (m32, v32, p_new) in fp32."""
    g = g.to(_F32) * scale
    m32 = B1 * m_f + (1 - B1) * g
    v32 = B2 * v_f + (1 - B2) * g * g
    mhat = m32 / c1
    vhat = v32 / c2
    p32 = p.to(_F32)
    step_vec = mhat / (torch.sqrt(vhat) + EPS) + WEIGHT_DECAY * p32
    return m32, v32, p32 - lr * step_vec
