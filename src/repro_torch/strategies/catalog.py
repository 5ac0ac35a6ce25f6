"""The ported strategies of `repro.strategies.catalog`, in PyTorch.

Eight of the reference's 26: the linear family (weight_average, linear,
task_arithmetic, negative_merge) with their LeafFolds, ties with both
trims (the exact quantile and the 512-bucket histogram), and the DARE
family (dare, dare_ties, della), whose masks come from
`repro_torch.random`'s threefry, bit-equal to `jax.random`. The rest
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
    reference counts in fp32, which agrees below 2^24 per bucket;
  * a mean over k is `_ksum`'s sum times the reciprocal of k, then the
    cast (`jnp.mean` upcasts half precision the same way; see
    `_kmean_fin`);
  * random masks are drawn one contribution (row) at a time, in slices
    of the flat index, so a [k, 805M] leaf never holds its 64-bit
    counters at once; element i of a draw depends only on the key and
    i, so the slices equal the whole draw.
"""
from __future__ import annotations

import math

import torch

from repro_torch import random as prng
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


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _kmean_fin(acc: torch.Tensor, k: int, dtype: torch.dtype
               ) -> torch.Tensor:
    """The end of a mean over k from its `_ksum`-order accumulator.
    `jnp.mean` is jitted, and XLA turns its division by k into a
    multiply by the reciprocal 1/k rounded in the accumulator's dtype
    (probed: not bitwise `sum / k` for k = 3, 5, 9), so the port
    multiplies too."""
    recip = _const(1.0, acc) / _const(float(k), acc)
    return (acc * recip).to(dtype)


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


def _bernoulli_row(key, p: float, shape, j: int, like: torch.Tensor
                   ) -> torch.Tensor:
    """Row j (flat indices [j * n, (j + 1) * n)) of `jax.random.bernoulli(
    key, p, shape)`, as 0/1 in `like`'s dtype and shape[1:]."""
    n = math.prod(shape[1:])
    pdt = prng.p_dtype(like.dtype)
    out = torch.empty(n, dtype=like.dtype, device=like.device)
    for s in range(0, n, prng.CHUNK):
        c = min(prng.CHUNK, n - s)
        out[s:s + c] = prng.bernoulli(key, p, shape, dtype=pdt,
                                      start=j * n + s, count=c,
                                      device=like.device)
    return out.reshape(tuple(shape[1:]))


def _dare(s, b, key, p=0.5, **kw):
    """b + mean_k(tau * mask / (1 - p)), mask ~ Bernoulli(1 - p), one
    contribution at a time."""
    k = s.shape[0]
    acc = None
    for j in range(k):
        tau = s[j] - b
        kept = tau.mul_(_bernoulli_row(key, 1.0 - p, s.shape, j, tau)) \
            .div_(_const(1.0 - p, tau))
        if acc is None:
            acc = torch.zeros(tau.shape, dtype=_acc_dtype(tau.dtype),
                              device=tau.device)
        acc.add_(kept)
        del tau, kept
    return b + _kmean_fin(acc, k, torch.result_type(s, b))


def _dare_ties(s, b, key, p=0.5, **kw):
    tau = _fl(s - b)
    c = _const(1.0 - p, tau)
    for j in range(tau.shape[0]):
        tau[j].mul_(_bernoulli_row(key, 1.0 - p, tau.shape, j, tau)).div_(c)
    return b + _elect_mean(tau).reshape(s.shape[1:])


def _della(s, b, key, p_min=0.2, p_max=0.8, **kw):
    """Magnitude-based sampling: low-|tau| entries drop more often."""
    tau = _fl(s - b)
    k, n = tau.shape
    r = torch.argsort(torch.argsort(tau.abs(), dim=1, stable=True), dim=1,
                      stable=True).to(tau.dtype)
    r = r / _const(float(max(n - 1, 1)), r)
    p_drop = _const(p_max, r) - _const(p_max - p_min, r) * r
    del r
    u = prng.uniform(key, tau.shape, tau.dtype, device=tau.device)
    keep = (u >= p_drop).to(tau.dtype)
    del u
    kept = tau * keep / torch.maximum(_const(1.0, p_drop) - p_drop,
                                      _const(1e-3, p_drop))
    acc = torch.zeros(n, dtype=_acc_dtype(tau.dtype), device=tau.device)
    for j in range(k):
        acc = acc + kept[j].to(acc.dtype)
    return b + _kmean_fin(acc, k, tau.dtype).reshape(s.shape[1:])


# ------------------------------------------------------------------ registry


def _reg(name, leaf_fn, *, schema, needs_key=False, elementwise=False,
         fold=None, **defaults):
    register(Strategy(name=name, fn=leafwise(leaf_fn, needs_key=needs_key),
                      defaults=defaults, leaf_fn=leaf_fn,
                      needs_key=needs_key, elementwise=elementwise,
                      cfg_schema=dict(schema), fold=fold))


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
_reg("dare", _dare, needs_key=True, schema={"p": (float, 0.5)})
_reg("dare_ties", _dare_ties, needs_key=True, schema={"p": (float, 0.5)})
_reg("della", _della, needs_key=True,
     schema={"p_min": (float, 0.2), "p_max": (float, 0.8)})
