"""The ported strategies of `repro.strategies.catalog`, in PyTorch.

The 21 per-leaf strategies of the reference's 26: the linear family
(weight_average, linear, task_arithmetic, negative_merge) with their
LeafFolds; fisher_merge, dam, ada_merging, regression_mean; ties with
both trims (the exact quantile and the 512-bucket histogram); the DARE
family (dare, dare_ties, della), whose masks come from
`repro_torch.random`'s threefry, bit-equal to `jax.random`;
model_breadcrumbs, emr, safe_merge, split_unlearn_merge; and the
geometry strategies slerp (binary-only: the engine folds k > 2),
dual_projection, representation_surgery, weight_scope_alignment and
led_merge. The five whole-model strategies wait for ROADMAP A3.6;
`get_strategy` names it.

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
    `_kmean_fin`); other means (`_mean`) and `jnp.var` (`_var`: ddof 0,
    where torch's default is 1) do the same over torch's own sums, whose
    order XLA's does not match, so those strategies are held to the
    reference within a tolerance;
  * `jnp.quantile` is `kernels.quantile.quantile_rows` (an exact
    select with JAX's fp32 interpolation index), never `torch.quantile`;
  * random masks are drawn one contribution (row) at a time, in slices
    of the flat index, so a [k, 805M] leaf never holds its 64-bit
    counters at once; element i of a draw depends only on the key and
    i, so the slices equal the whole draw.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import random as prng
from repro_torch.kernels.quantile import quantile_rows, weak_float
from repro_torch.strategies.base import LeafFold, leafwise, register, \
    run_fold, Strategy

EPS = 1e-12


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


def _sum(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """`jnp.sum`: fp32 accumulation for half precision, cast back; the
    order is torch's (XLA does not pin its own beyond the k axis)."""
    dims = tuple(range(x.dim())) if dim is None else dim
    return x.sum(dim=dims, keepdim=keepdim,
                 dtype=_acc_dtype(x.dtype)).to(x.dtype)


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False
          ) -> torch.Tensor:
    """`jnp.mean`: the sum times the reciprocal of the count, both in
    the accumulation dtype (XLA's rewrite of the jitted division, see
    `_kmean_fin`), then the cast."""
    dims = tuple(range(x.dim())) if dim is None else \
        ((dim,) if isinstance(dim, int) else tuple(dim))
    n = math.prod(x.shape[d] for d in dims)
    acc = x.sum(dim=dims, keepdim=keepdim, dtype=_acc_dtype(x.dtype))
    return _kmean_fin(acc, n, x.dtype)


def _var(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.var(x, axis=dim)`: ddof 0 (torch's default would be 1), in
    fp32 for half precision: mean, centre, square, mean again."""
    acc_dt = _acc_dtype(x.dtype)
    xa = x.to(acc_dt)
    c = xa - _mean(xa, dim, keepdim=True)
    return _mean(c * c, dim).to(x.dtype)


def _norm(x: torch.Tensor) -> torch.Tensor:
    """`jnp.linalg.norm(x)` over every element: sqrt(sum(x * x))."""
    return torch.sqrt(_sum(x * x))


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`jnp.dot` / `@` (matrix-vector or vector-vector): products and
    sums in fp32 for half precision, one rounding at the end."""
    acc = _acc_dtype(x.dtype)
    return (x.to(acc) @ y.to(acc)).to(x.dtype)


def _norms(t: torch.Tensor) -> torch.Tensor:
    """Per-contribution L2 norms of [k, ...], + EPS."""
    f = _fl(t)
    return torch.sqrt(_sum(f * f, 1)) + _const(EPS, f)


def _kmean(x: torch.Tensor) -> torch.Tensor:
    """`jnp.mean(x, axis=0)` with `_ksum`'s order."""
    acc = torch.zeros(x.shape[1:], dtype=_acc_dtype(x.dtype),
                      device=x.device)
    for i in range(x.shape[0]):
        acc = acc + x[i].to(acc.dtype)
    return _kmean_fin(acc, x.shape[0], x.dtype)


def _bcast(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """[k] -> [k, 1, ..., 1] against `like` [k, ...]."""
    return w.reshape((-1,) + (1,) * (like.dim() - 1))


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


def _fisher_merge(s, b, eps=1e-8, **kw):
    f = s * s + _const(eps, s)
    return _ksum(f * s) / _ksum(f)


def _dam(s, b, **kw):
    tau = s - b
    w = _norms(tau)
    w = w / _sum(w)
    return b + _ksum(_bcast(w, tau) * tau)


def _ada_merging(s, b, eps=1e-8, **kw):
    tau = s - b
    var = _var(_fl(tau), 1) + _const(eps, tau)
    inv = _const(1.0, var) / var
    w = inv / _sum(inv)
    return b + _ksum(_bcast(w, tau) * tau)


def _regression_mean(s, b, eps=1e-8, **kw):
    if s.dim() == 1:
        return _kmean(s)
    k = s.shape[0]
    flat = s.reshape(k, s.shape[1], -1)
    w = _mean(flat * flat, 2) + _const(eps, flat)           # [k, rows]
    w = w / _sum(w, 0, keepdim=True)
    return _ksum(w[:, :, None] * flat).reshape(s.shape[1:])


# ---------------------------------------------------------------- sparse ---


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
    """Keep entries with |tau| >= per-contribution trim quantile: 0/1 in
    tau's dtype, written over |tau| in place (no bool stack beside it)."""
    a = tau_flat.abs()
    return a.ge_(quantile_rows(a, trim))


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
    # in place: a full-width FFN leaf's [k, ...] stack is 6.4 GB in bf16
    trimmed = tau.mul_(_trim_mask(tau, trim))
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


def _model_breadcrumbs(s, b, beta=0.1, gamma=0.1, **kw):
    tau = _fl(s - b)
    a = tau.abs()
    qlo = quantile_rows(a, beta)
    qhi = quantile_rows(a, 1.0 - gamma)
    mask = ((a >= qlo) & (a <= qhi)).to(tau.dtype)
    return b + _kmean(tau * mask).reshape(s.shape[1:])


def _elect_agree_mean(tau):
    """sum(tau * agree) / max(sum(agree), 1) over k, agree = sign(tau)
    equal to the elected sign (zeros included, unlike `_elect_mean`)."""
    elected = torch.sign(_ksum(tau, keepdim=True))
    agree = (torch.sign(tau) == elected).to(tau.dtype)
    return _ksum(tau * agree) / torch.clamp_min(_ksum(agree), 1.0)


def _emr(s, b, trim=0.1, **kw):
    tau = _fl(s - b)
    m = _elect_agree_mean(tau)
    am = m.abs()
    q = quantile_rows(am.reshape(1, -1), trim).reshape(())
    m = m * (am >= q).to(m.dtype)
    rho = _mean(_norms(s - b)) / (_norm(m) + _const(EPS, m))
    return b + (rho * m).reshape(s.shape[1:])


def _safe_merge(s, b, k_sigma=6.0, **kw):
    tau = s - b
    mu = _mean(tau)
    sd = torch.sqrt(_var(tau.reshape(1, -1), 1)[0]) + _const(EPS, tau)
    ks = _const(k_sigma, tau)
    clipped = torch.minimum(torch.maximum(tau, mu - ks * sd), mu + ks * sd)
    return b + _kmean(clipped)


def _split_unlearn_merge(s, b, **kw):
    tau = _fl(s - b)
    k = tau.shape[0]
    kept = _elect_agree_mean(tau)
    # variance-compensation rescale: sqrt(k) in the type of a weakly
    # typed JAX float, then in the data's dtype
    root_k = _const(float(np.sqrt(weak_float(tau.dtype)(k))), tau)
    target = root_k * _mean(_norms(s - b))
    merged = kept * target / (_norm(kept) + _const(EPS, kept))
    return b + merged.reshape(s.shape[1:])


# -------------------------------------------------------------- geometry ---


def _slerp(s, b, t=0.5, **kw):
    if s.shape[0] != 2:
        raise ValueError(f"slerp is binary, got k={s.shape[0]}")
    u, v = _fl(s)[0], _fl(s)[1]
    nu, nv = _norm(u) + _const(EPS, u), _norm(v) + _const(EPS, v)
    uh, vh = u / nu, v / nv
    cos = torch.clamp(_dot(uh, vh), -1.0, 1.0)
    omega = torch.arccos(cos)
    so = torch.sin(omega)
    one_t, tt = _const(1.0 - t, so), _const(t, so)
    small = so < _const(1e-6, so)
    w1 = torch.where(small, one_t, torch.sin(one_t * omega) / so)
    w2 = torch.where(small, tt, torch.sin(tt * omega) / so)
    direction = w1 * uh + w2 * vh
    mag = one_t * nu + tt * nv
    return (direction * mag).reshape(s.shape[1:])


def _dual_projection(s, b, gamma=0.5, eps=1e-12, **kw):
    tau = _fl(s - b)
    mu = _kmean(tau)
    denom = _dot(mu, mu) + _const(eps, mu)
    proj = _dot(tau, mu)[:, None] / denom * mu[None, :]
    resid = tau - proj
    merged = _kmean(proj + _const(gamma, resid) * resid)
    return b + merged.reshape(s.shape[1:])


def _representation_surgery(s, b, eps=1e-8, **kw):
    if s.dim() < 3:
        n = _norms(s)
        target = _mean(n)
        return _kmean(s * _bcast(target / n, s))
    flat = s.reshape(s.shape[0], s.shape[1], -1)
    n = torch.sqrt(_sum(flat * flat, 1)) + _const(eps, flat)   # [k, cols]
    target = _mean(n, 0, keepdim=True)
    aligned = flat * (target / n)[:, None, :]
    return _kmean(aligned).reshape(s.shape[1:])


def _weight_scope_alignment(s, b, **kw):
    n = _norms(s)
    gm = torch.exp(_mean(torch.log(n)))
    dirs = s / _bcast(n, s)
    mean_dir = _kmean(dirs)
    mean_dir = mean_dir / (_norm(mean_dir) + _const(EPS, mean_dir))
    return gm * mean_dir


def _led_merge(s, b, beta=5.0, gamma=0.7, **kw):
    tau = s - b
    at = tau.abs()
    scale = _mean(at) + _const(EPS, at)
    x = _const(beta, at) * at / scale
    # jax.nn.softmax over k: exp(x - max_k x) / sum_k
    e = torch.exp(x - x.amax(dim=0, keepdim=True))
    w = e / _ksum(e, keepdim=True)
    dom = _ksum(w * tau)
    return b + _const(gamma, dom) * dom \
        + _const(1.0 - gamma, dom) * _kmean(tau)


# ------------------------------------------------------------------ registry


def _reg(name, leaf_fn, *, schema, needs_key=False, binary_only=False,
         elementwise=False, fold=None, **defaults):
    register(Strategy(name=name, fn=leafwise(leaf_fn, needs_key=needs_key),
                      binary_only=binary_only, defaults=defaults,
                      leaf_fn=leaf_fn, needs_key=needs_key,
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
_reg("fisher_merge", _fisher_merge, elementwise=True,
     schema={"eps": (float, 1e-8)})
_reg("dam", _dam, schema={})
_reg("ada_merging", _ada_merging, schema={"eps": (float, 1e-8)})
_reg("regression_mean", _regression_mean, schema={"eps": (float, 1e-8)})

_reg("ties", _ties,
     schema={"trim": (float, 0.2), "trim_method": (str, "quantile")})
_reg("dare", _dare, needs_key=True, schema={"p": (float, 0.5)})
_reg("dare_ties", _dare_ties, needs_key=True, schema={"p": (float, 0.5)})
_reg("della", _della, needs_key=True,
     schema={"p_min": (float, 0.2), "p_max": (float, 0.8)})
_reg("model_breadcrumbs", _model_breadcrumbs,
     schema={"beta": (float, 0.1), "gamma": (float, 0.1)})
_reg("emr", _emr, schema={"trim": (float, 0.1)})
_reg("safe_merge", _safe_merge, schema={"k_sigma": (float, 6.0)})
_reg("split_unlearn_merge", _split_unlearn_merge, schema={})

_reg("slerp", _slerp, binary_only=True, schema={"t": (float, 0.5)})
_reg("dual_projection", _dual_projection,
     schema={"gamma": (float, 0.5), "eps": (float, 1e-12)})
_reg("representation_surgery", _representation_surgery,
     schema={"eps": (float, 1e-8)})
_reg("weight_scope_alignment", _weight_scope_alignment, schema={})
_reg("led_merge", _led_merge, schema={"beta": (float, 5.0),
                                      "gamma": (float, 0.7)})
