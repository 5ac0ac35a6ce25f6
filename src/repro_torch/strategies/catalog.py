"""The ported strategies of `repro.strategies.catalog`, in PyTorch.

Five of the reference's 26: the linear family (weight_average, linear,
task_arithmetic, negative_merge) with their LeafFolds, and ties with
both trims (the exact quantile and the 512-bucket histogram). The rest
wait for ROADMAP A3; `get_strategy` names it.

Conventions: `s` is the stacked contributions [k, ...]; `b` the base
parameters (zeros for raw tensor audits); tau = s - b.

Arithmetic follows JAX's op by op, so that the port's exact path can
be held bitwise against the reference where the op order is pinned:
  * a Python scalar meets a tensor in the tensor's dtype (`_const`), as
    a weakly typed JAX scalar does — torch would otherwise compute a
    bf16 op with the scalar in fp32;
  * a division by a Python scalar divides by a tensor (`_const`): torch
    on CUDA turns `x / 3.0` into `x * (1/3.0)`, which rounds
    differently;
  * sums over the k axis run in index order from zero (`_ksum`), with
    fp32 accumulation for bf16/fp16 as `jnp.sum` upcasts them;
  * histogram counts are exact integers (`torch.bincount`); the
    reference counts in fp32, which agrees below 2^24 per bucket.
"""
from __future__ import annotations

import torch

from repro_torch.strategies.base import LeafFold, leafwise, register, \
    run_fold, Strategy


def _const(v: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor of `like`'s dtype and device: JAX's weak-typed
    scalar."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def _ksum(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum over axis 0 in index order: ((0 + x_0) + x_1) + ..., in fp32
    for half-precision inputs (cast back at the end, as `jnp.sum`)."""
    acc_dt = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) \
        else x.dtype
    acc = torch.zeros(x.shape[1:], dtype=acc_dt, device=x.device)
    for i in range(x.shape[0]):
        acc = acc + x[i].to(acc_dt)
    acc = acc.to(x.dtype)
    return acc.unsqueeze(0) if keepdim else acc


def _fl(x):
    """Flatten all but the leading (k) axis."""
    return x.reshape(x.shape[0], -1)


# ---------------------------------------------------------------- linear ---


def _cast(out, dtype):
    """Accumulation is float32; cast back for floating inputs."""
    return out.to(dtype) if dtype.is_floating_point else out


def _f32(b):
    return b.to(torch.float32)


def _sum_init(x0, b, **kw):
    return x0


def _sum_step(acc, x, b, **kw):
    return acc + x


def _mean_fin(acc, k, b, dtype, **kw):
    return _cast(acc / _const(float(k), acc), dtype)


def _tau_init(x0, b, **kw):
    return x0 - _f32(b)


def _tau_step(acc, x, b, **kw):
    return acc + (x - _f32(b))


def _ta_fin(acc, k, b, dtype, lam=1.0, **kw):
    return _cast(_f32(b) + _const(lam, acc) * acc, dtype)


def _neg_fin(acc, k, b, dtype, lam=0.5, **kw):
    return _cast(_f32(b) - _const(lam, acc) * (acc / _const(float(k), acc)),
                 dtype)


MEAN_FOLD = LeafFold(_sum_init, _sum_step, _mean_fin)
# linear interpolates at k == 2 (a different formula), so its fold is
# only the canonical computation from k == 3 up
LINEAR_FOLD = LeafFold(_sum_init, _sum_step, _mean_fin, min_k=3)
TASK_ARITH_FOLD = LeafFold(_tau_init, _tau_step, _ta_fin)
NEGATIVE_FOLD = LeafFold(_tau_init, _tau_step, _neg_fin)


def _weight_average(s, b, **kw):
    return run_fold(MEAN_FOLD, s, b, **kw)[0]


def _linear(s, b, t=0.5, **kw):
    if s.shape[0] == 2:
        return _const(1.0 - t, s) * s[0] + _const(t, s) * s[1]
    return run_fold(LINEAR_FOLD, s, b, t=t, **kw)[0]


def _task_arithmetic(s, b, lam=1.0, **kw):
    return run_fold(TASK_ARITH_FOLD, s, b, lam=lam, **kw)[0]


def _negative_merge(s, b, lam=0.5, **kw):
    return run_fold(NEGATIVE_FOLD, s, b, lam=lam, **kw)[0]


# ---------------------------------------------------------------- sparse ---


def _quantile_rows(a, q):
    """`jnp.quantile(a, q, axis=1, keepdims=True)`, linear method, with
    JAX's fp32 interpolation weights. Sort-based: `torch.quantile`
    refuses inputs above 2^24 elements."""
    a = torch.where(torch.isnan(a).any(dim=1, keepdim=True),
                    torch.full_like(a, float("nan")), a)
    srt = torch.sort(a, dim=1).values
    n = a.shape[1]
    f32 = dict(dtype=torch.float32, device=a.device)
    nf = torch.tensor(float(n), **f32)
    qq = torch.tensor(q, **f32) * (nf - torch.tensor(1.0, **f32))
    low, high = torch.floor(qq), torch.ceil(qq)
    hw = qq - low
    lw = torch.tensor(1.0, **f32) - hw
    lo = int(torch.clamp(low, 0, n - 1))
    hi = int(torch.clamp(high, 0, n - 1))
    res = srt[:, lo:lo + 1].to(torch.float32) * lw \
        + srt[:, hi:hi + 1].to(torch.float32) * hw
    return res.to(a.dtype)


def _hist_counts(a_row, amax, bins):
    """Exact bucket counts of `clip(int(a / amax * bins))` over one
    contribution's |tau| (the catalog binning, verbatim)."""
    idx = (a_row / amax * bins).to(torch.int32).clamp_(0, bins - 1)
    return torch.bincount(idx.reshape(-1), minlength=bins)


def _hist_bucket(counts, n, trim, dtype):
    """First cdf crossing of `trim` per row: cumsum of exact counts,
    rounded once to fp32, divided by fp32(n)."""
    cdf = counts.cumsum(dim=1).to(torch.float32)
    cdf = cdf / _const(float(n), cdf)
    return (cdf >= _const(trim, cdf)).to(torch.uint8).argmax(dim=1).to(dtype)


def _trim_mask(tau_flat, trim):
    """Keep entries with |tau| >= per-contribution trim quantile."""
    a = tau_flat.abs()
    return (a >= _quantile_rows(a, trim)).to(tau_flat.dtype)


def _elect_mean(trimmed):
    """Sign election over k, then the mean of the agreeing entries:
    `sum(trimmed * agree) / max(sum(agree), 1)` with `_ksum`'s order and
    precision, built one contribution at a time so no [k, ...] mask is
    ever live."""
    elected = torch.sign(_ksum(trimmed))
    acc_dt = torch.float32 if trimmed.dtype in (torch.bfloat16,
                                                torch.float16) \
        else trimmed.dtype
    cnt = torch.zeros(trimmed.shape[1:], dtype=acc_dt, device=trimmed.device)
    acc = torch.zeros_like(cnt)
    for tr in trimmed:
        agree = ((torch.sign(tr) == elected) & (tr != 0)).to(tr.dtype)
        cnt = cnt + agree.to(acc_dt)
        acc = acc + (tr * agree).to(acc_dt)
    cnt = torch.clamp_min(cnt.to(trimmed.dtype), 1.0)
    return acc.to(trimmed.dtype) / cnt


def _ties(s, b, trim=0.2, trim_method="quantile", **kw):
    if trim_method == "histogram":
        return _ties_nd_histogram(s, b, trim)
    tau = _fl(s - b)
    if trim_method != "quantile":
        raise ValueError(f"unknown trim_method {trim_method!r}")
    trimmed = tau * _trim_mask(tau, trim)
    return b + _elect_mean(trimmed).reshape(s.shape[1:])


def _ties_nd_histogram(s, b, trim, bins=512):
    """TIES with the histogram trim and no flatten: the N-D form of the
    reference. Counts go one contribution at a time, so the int32 bin
    indices of a whole [k, ...] stack are never live at once."""
    tau = s - b
    k = tau.shape[0]
    a = tau.abs()
    amax = a.reshape(k, -1).amax(dim=1) + _const(1e-12, a)        # [k]
    counts = torch.stack([_hist_counts(a[j], amax[j], bins)
                          for j in range(k)])                     # [k, bins]
    bucket = _hist_bucket(counts, a[0].numel(), trim, tau.dtype)
    thr = (bucket / _const(float(bins), a)) * amax
    trimmed = torch.empty_like(tau)
    for j in range(k):
        trimmed[j] = tau[j] * (a[j] >= thr[j]).to(tau.dtype)
    del a, tau
    return b + _elect_mean(trimmed)


# ------------------------------------------------------------------ registry


def _reg(name, leaf_fn, *, schema, elementwise=False, fold=None,
         **defaults):
    register(Strategy(name=name, fn=leafwise(leaf_fn),
                      defaults=defaults, leaf_fn=leaf_fn,
                      elementwise=elementwise, cfg_schema=dict(schema),
                      fold=fold))


# `schema` mirrors the reference's declaration exactly — names, types
# AND defaults — because MergeSpec canonicalizes declared defaults into
# the spec encoding and cache keys.
_reg("weight_average", _weight_average, elementwise=True, schema={},
     fold=MEAN_FOLD)
_reg("linear", _linear, elementwise=True,
     schema={"t": (float, 0.5)}, fold=LINEAR_FOLD)
_reg("task_arithmetic", _task_arithmetic, elementwise=True,
     schema={"lam": (float, 1.0)}, fold=TASK_ARITH_FOLD)
_reg("negative_merge", _negative_merge, elementwise=True,
     schema={"lam": (float, 0.5)}, fold=NEGATIVE_FOLD)
_reg("ties", _ties,
     schema={"trim": (float, 0.2), "trim_method": (str, "quantile")})
